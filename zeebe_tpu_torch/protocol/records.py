"""Typed record values.

Reference parity: every broker record type extends ``UnpackedObject``
(``msgpack-value/src/main/java/io/zeebe/msgpack/UnpackedObject.java``); the
concrete value classes live under ``broker-core/.../{workflow,job,incident,
subscription}/data/``. Property names below match the reference msgpack
document keys exactly so value documents are wire-comparable.

Host-side values are plain dataclasses serialized to msgpack documents; the
device engine uses columnarized forms (``zeebe_tpu.engine.state``) and the
host materializes these classes only at the log/client boundary.
"""

from __future__ import annotations

import copy as copy_module
import dataclasses
from typing import Any, ClassVar, Dict, List, Optional

from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.protocol.enums import ErrorType, ValueType
from zeebe_tpu_torch.protocol.metadata import RecordMetadata

EMPTY_PAYLOAD: Dict[str, Any] = {}


class RecordValue:
    """Base for typed record values; subclasses are dataclasses whose field
    metadata carries the reference msgpack key."""

    VALUE_TYPE: ClassVar[ValueType]

    @classmethod
    def _doc_spec(cls):
        """(attr name, document key, maybe-nested, packed key bytes)
        tuples, computed ONCE per class — ``to_document``/``encode`` sit
        on the log-append hot path (every value encode) and must not
        re-walk ``dataclasses.fields`` metadata (or re-encode the fixed
        document keys) per record. Only fields declaring a nested value
        class (``cls`` in the field metadata) pay the nested-document
        checks."""
        spec = cls.__dict__.get("_DOC_SPEC")
        if spec is None:
            spec = tuple(
                (
                    f.name,
                    f.metadata.get("key", f.name),
                    "cls" in f.metadata,
                    msgpack.pack(f.metadata.get("key", f.name)),
                )
                for f in dataclasses.fields(cls)
            )
            # encode() emits a one-byte fixmap header; every record value
            # class is well under the 16-field bound
            assert len(spec) < 16, cls
            cls._DOC_SPEC = spec
        return spec

    def to_document(self) -> Dict[str, Any]:
        values = self.__dict__
        doc = {}
        for name, key, nested, _pkey in self._doc_spec():
            v = values[name]
            if nested:
                if isinstance(v, RecordValue):
                    v = v.to_document()
                elif type(v) is list:
                    v = [
                        x.to_document() if isinstance(x, RecordValue) else x
                        for x in v
                    ]
            doc[key] = v
        return doc

    @classmethod
    def _from_doc_spec(cls):
        """(attr name, document key, nested value class) triples, computed
        ONCE per class — decode sits on both wire edges (client response
        unmarshalling, broker inbound commands)."""
        spec = cls.__dict__.get("_FROM_DOC_SPEC")
        if spec is None:
            spec = tuple(
                (f.name, f.metadata.get("key", f.name), f.metadata.get("cls"))
                for f in dataclasses.fields(cls)
            )
            cls._FROM_DOC_SPEC = spec
        return spec

    @classmethod
    def from_document(cls, doc: Dict[str, Any]) -> "RecordValue":
        kwargs = {}
        for name, key, sub in cls._from_doc_spec():
            if key in doc:
                v = doc[key]
                if sub is not None:
                    if isinstance(v, dict):
                        v = sub.from_document(v)
                    elif isinstance(v, list):
                        v = [
                            sub.from_document(x) if isinstance(x, dict) else x
                            for x in v
                        ]
                kwargs[name] = v
        return cls(**kwargs)

    def encode(self) -> bytes:
        """Msgpack document bytes, FUSED: fields pack straight into one
        buffer with precomputed key bytes — no intermediate dict, no
        per-record key encode. Byte-identical to
        ``msgpack.pack(self.to_document())`` (field order IS document
        order both ways)."""
        out = bytearray()
        self._encode_into(out)
        return bytes(out)

    def _encode_into(self, out: bytearray) -> None:
        pack_into = msgpack._pack_into
        spec = self._doc_spec()
        out.append(0x80 | len(spec))  # fixmap header (len asserted < 16)
        values = self.__dict__
        for name, _key, nested, pkey in spec:
            out += pkey
            v = values[name]
            tv = type(v)
            if tv is str:
                data = v.encode("utf-8")
                n = len(data)
                if n < 32:
                    out.append(0xA0 | n)
                    out += data
                else:
                    pack_into(out, v)
            elif tv is int:
                if -32 <= v < 128:
                    out.append(v & 0xFF)
                else:
                    pack_into(out, v)
            elif v is None:
                out.append(0xC0)
            elif v is True:
                out.append(0xC3)
            elif v is False:
                out.append(0xC2)
            elif nested and isinstance(v, RecordValue):
                v._encode_into(out)
            elif nested and tv is list:
                n = len(v)
                if n < 16:
                    out.append(0x90 | n)
                elif n < 65536:
                    out += msgpack._BH.pack(0xDC, n)
                else:
                    out += msgpack._BI.pack(0xDD, n)
                for item in v:
                    if isinstance(item, RecordValue):
                        item._encode_into(out)
                    else:
                        pack_into(out, item)
            else:
                pack_into(out, v)

    @classmethod
    def decode(cls, data: bytes) -> "RecordValue":
        return cls.from_document(msgpack.unpack(data))

    def copy(self):
        """Deep copy, hand-rolled: record values are dataclasses of
        scalars, json-shaped dicts/lists and nested ``RecordValue``s —
        ``copy.deepcopy``'s generic memo/reductor machinery was a visible
        slice of the serving drain (handlers copy values on every
        follow-up write)."""
        cls = self.__class__
        new = cls.__new__(cls)
        d = new.__dict__
        for name, v in self.__dict__.items():
            tv = type(v)
            if tv is dict:
                d[name] = _copy_doc(v)
            elif tv is list:
                d[name] = [
                    x.copy() if isinstance(x, RecordValue) else _copy_item(x)
                    for x in v
                ]
            elif tv in (str, int, float, bool, bytes, type(None)):
                d[name] = v  # immutable — share
            elif isinstance(v, RecordValue):
                d[name] = v.copy()
            else:
                d[name] = copy_module.deepcopy(v)
        return new


def _copy_item(v):
    tv = type(v)
    if tv is dict:
        return _copy_doc(v)
    if tv is list:
        return [_copy_item(x) for x in v]
    if tv in (str, int, float, bool, bytes, type(None)):
        return v
    return copy_module.deepcopy(v)  # exotic container: stay correct


_SCALARS = (str, int, float, bool, bytes, type(None))


def _copy_doc(doc: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in doc.items():
        tv = type(v)
        if tv is dict:
            v = _copy_doc(v)
        elif tv is list:
            v = [_copy_item(x) for x in v]
        elif tv not in _SCALARS:
            v = copy_module.deepcopy(v)  # exotic value: stay correct
        out[k] = v
    return out


def _f(key: str, default=None, **kw):
    return dataclasses.field(default=default, metadata={"key": key, **kw})


@dataclasses.dataclass
class WorkflowInstanceRecord(RecordValue):
    # Reference: broker-core/.../workflow/data/WorkflowInstanceRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.WORKFLOW_INSTANCE

    bpmn_process_id: str = _f("bpmnProcessId", "")
    version: int = _f("version", -1)
    workflow_key: int = _f("workflowKey", -1)
    workflow_instance_key: int = _f("workflowInstanceKey", -1)
    activity_id: str = _f("activityId", "")
    payload: Dict[str, Any] = dataclasses.field(
        default_factory=dict, metadata={"key": "payload"}
    )
    scope_instance_key: int = _f("scopeInstanceKey", -1)


@dataclasses.dataclass
class JobHeaders(RecordValue):
    # Reference: broker-core/.../job/data/JobHeaders.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.NOOP

    workflow_instance_key: int = _f("workflowInstanceKey", -1)
    bpmn_process_id: str = _f("bpmnProcessId", "")
    workflow_definition_version: int = _f("workflowDefinitionVersion", -1)
    workflow_key: int = _f("workflowKey", -1)
    activity_id: str = _f("activityId", "")
    activity_instance_key: int = _f("activityInstanceKey", -1)


@dataclasses.dataclass
class JobRecord(RecordValue):
    # Reference: broker-core/.../job/data/JobRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.JOB

    deadline: int = _f("deadline", -1)
    worker: str = _f("worker", "")
    retries: int = _f("retries", -1)
    type: str = _f("type", "")
    headers: JobHeaders = dataclasses.field(
        default_factory=JobHeaders, metadata={"key": "headers", "cls": JobHeaders}
    )
    custom_headers: Dict[str, Any] = dataclasses.field(
        default_factory=dict, metadata={"key": "customHeaders"}
    )
    payload: Dict[str, Any] = dataclasses.field(
        default_factory=dict, metadata={"key": "payload"}
    )


@dataclasses.dataclass
class IncidentRecord(RecordValue):
    # Reference: broker-core/.../incident/data/IncidentRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.INCIDENT

    error_type: int = _f("errorType", int(ErrorType.UNKNOWN))
    error_message: str = _f("errorMessage", "")
    failure_event_position: int = _f("failureEventPosition", -1)
    bpmn_process_id: str = _f("bpmnProcessId", "")
    workflow_instance_key: int = _f("workflowInstanceKey", -1)
    activity_id: str = _f("activityId", "")
    activity_instance_key: int = _f("activityInstanceKey", -1)
    job_key: int = _f("jobKey", -1)
    payload: Dict[str, Any] = dataclasses.field(
        default_factory=dict, metadata={"key": "payload"}
    )


@dataclasses.dataclass
class MessageRecord(RecordValue):
    # Reference: broker-core/.../subscription/message/data/MessageRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.MESSAGE

    name: str = _f("name", "")
    correlation_key: str = _f("correlationKey", "")
    time_to_live: int = _f("timeToLive", -1)
    payload: Dict[str, Any] = dataclasses.field(
        default_factory=dict, metadata={"key": "payload"}
    )
    message_id: str = _f("messageId", "")


@dataclasses.dataclass
class MessageSubscriptionRecord(RecordValue):
    # Reference: broker-core/.../subscription/message/data/MessageSubscriptionRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.MESSAGE_SUBSCRIPTION

    workflow_instance_partition_id: int = _f("workflowInstancePartitionId", -1)
    workflow_instance_key: int = _f("workflowInstanceKey", -1)
    activity_instance_key: int = _f("activityInstanceKey", -1)
    message_name: str = _f("messageName", "")
    correlation_key: str = _f("correlationKey", "")


@dataclasses.dataclass
class WorkflowInstanceSubscriptionRecord(RecordValue):
    # Reference: broker-core/.../subscription/message/data/WorkflowInstanceSubscriptionRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION

    workflow_instance_key: int = _f("workflowInstanceKey", -1)
    activity_instance_key: int = _f("activityInstanceKey", -1)
    message_name: str = _f("messageName", "")
    payload: Dict[str, Any] = dataclasses.field(
        default_factory=dict, metadata={"key": "payload"}
    )
    # TPU-native: the partition holding the message subscription, so the
    # workflow partition can route the post-correlation CLOSE (the reference
    # leaks subscriptions after correlation in this version)
    message_partition_id: int = _f("messagePartitionId", -1)
    # TPU-native: the subscription's correlation key, echoed so the CLOSE
    # can address the store by its composite (name, correlation) key — the
    # device store is hashmap-addressed, not scanned
    correlation_key: str = _f("correlationKey", "")


@dataclasses.dataclass
class DeploymentResource(RecordValue):
    # Reference: broker-core/.../system/workflow/repository/data/DeploymentResource.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.NOOP

    resource: bytes = _f("resource", b"")
    resource_type: str = _f("resourceType", "BPMN_XML")  # BPMN_XML | YAML_WORKFLOW
    resource_name: str = _f("resourceName", "resource")


@dataclasses.dataclass
class DeployedWorkflowMeta(RecordValue):
    # Reference: broker-core/.../system/workflow/repository/data/DeployedWorkflow.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.NOOP

    bpmn_process_id: str = _f("bpmnProcessId", "")
    version: int = _f("version", -1)
    key: int = _f("workflowKey", -1)
    resource_name: str = _f("resourceName", "")


@dataclasses.dataclass
class DeploymentRecord(RecordValue):
    # Reference: broker-core/.../system/workflow/repository/data/DeploymentRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.DEPLOYMENT

    topic_name: str = _f("topicName", "")
    resources: List[DeploymentResource] = dataclasses.field(
        default_factory=list,
        metadata={"key": "resources", "cls": DeploymentResource},
    )
    deployed_workflows: List[DeployedWorkflowMeta] = dataclasses.field(
        default_factory=list,
        metadata={"key": "deployedWorkflows", "cls": DeployedWorkflowMeta},
    )


@dataclasses.dataclass
class TopicRecord(RecordValue):
    # Reference: broker-core/.../clustering/orchestration/topic/TopicRecord.java
    VALUE_TYPE: ClassVar[ValueType] = ValueType.TOPIC

    name: str = _f("name", "")
    partitions: int = _f("partitions", 1)
    replication_factor: int = _f("replicationFactor", 1)
    partition_ids: List[int] = dataclasses.field(
        default_factory=list, metadata={"key": "partitionIds"}
    )


@dataclasses.dataclass
class TimerRecord(RecordValue):
    """TPU-native: explicit timer record (due-date driven element triggers)."""

    VALUE_TYPE: ClassVar[ValueType] = ValueType.TIMER

    workflow_instance_key: int = _f("workflowInstanceKey", -1)
    activity_instance_key: int = _f("activityInstanceKey", -1)
    due_date: int = _f("dueDate", -1)
    handler_element_id: str = _f("handlerElementId", "")


@dataclasses.dataclass
class TopicSubscriberRecord(RecordValue):
    """Topic subscription lifecycle (reference
    broker-core/.../event/TopicSubscriberEvent.java): SUBSCRIBE command
    opens a per-subscriber push stream from ``start_position``."""

    VALUE_TYPE: ClassVar[ValueType] = ValueType.SUBSCRIBER

    name: str = _f("name", "")
    start_position: int = _f("startPosition", -1)
    buffer_size: int = _f("bufferSize", 32)
    force_start: bool = _f("forceStart", False)


@dataclasses.dataclass
class TopicSubscriptionRecord(RecordValue):
    """Topic subscription ack state (reference
    broker-core/.../event/TopicSubscriptionEvent.java): ACKNOWLEDGE commands
    persist the consumer's progress in the log itself."""

    VALUE_TYPE: ClassVar[ValueType] = ValueType.SUBSCRIPTION

    name: str = _f("name", "")
    ack_position: int = _f("ackPosition", -1)


@dataclasses.dataclass
class ExporterPositionRecord(RecordValue):
    """Exporter export-progress ack (reference: the broker persists each
    exporter's position and bounds segment deletion by their minimum —
    ExporterDirectorService; here the ack is a replicated log record so a
    new raft leader resumes from it without gaps)."""

    VALUE_TYPE: ClassVar[ValueType] = ValueType.EXPORTER

    exporter_id: str = _f("exporterId", "")
    position: int = _f("position", -1)


@dataclasses.dataclass
class NoopRecord(RecordValue):
    """Empty value — raft initial/no-op entries (reference
    LeaderCommitInitialEvent appends a NOOP record on leader election)."""

    VALUE_TYPE: ClassVar[ValueType] = ValueType.NOOP


@dataclasses.dataclass
class RaftConfigurationRecord(RecordValue):
    """Membership-change entry on the replicated log (reference
    ``raft/.../event/RaftConfigurationEvent.java``; single-step change —
    the new configuration takes effect as soon as the entry is APPENDED,
    raft dissertation §4.1)."""

    VALUE_TYPE: ClassVar[ValueType] = ValueType.RAFT

    # member id → [host, port]
    members: Dict[str, Any] = dataclasses.field(
        default_factory=dict, metadata={"key": "members"}
    )


VALUE_CLASS_BY_TYPE = {
    ValueType.NOOP: NoopRecord,
    ValueType.RAFT: RaftConfigurationRecord,
    ValueType.WORKFLOW_INSTANCE: WorkflowInstanceRecord,
    ValueType.JOB: JobRecord,
    ValueType.INCIDENT: IncidentRecord,
    ValueType.MESSAGE: MessageRecord,
    ValueType.MESSAGE_SUBSCRIPTION: MessageSubscriptionRecord,
    ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION: WorkflowInstanceSubscriptionRecord,
    ValueType.DEPLOYMENT: DeploymentRecord,
    ValueType.TOPIC: TopicRecord,
    ValueType.TIMER: TimerRecord,
    ValueType.SUBSCRIBER: TopicSubscriberRecord,
    ValueType.SUBSCRIPTION: TopicSubscriptionRecord,
    ValueType.EXPORTER: ExporterPositionRecord,
}


@dataclasses.dataclass
class Record:
    """A full log record: framing fields + metadata + typed value.

    Reference: logstreams ``LoggedEvent`` + ``RecordMetadata`` + value.
    """

    position: int = -1
    source_record_position: int = -1
    key: int = -1
    timestamp: int = -1
    producer_id: int = -1
    raft_term: int = 0
    metadata: RecordMetadata = dataclasses.field(default_factory=RecordMetadata)
    value: Optional[RecordValue] = None

    @property
    def record_type(self):
        return self.metadata.record_type

    @property
    def value_type(self):
        return self.metadata.value_type

    @property
    def intent(self) -> int:
        return self.metadata.intent

    def copy(self) -> "Record":
        return Record(
            position=self.position,
            source_record_position=self.source_record_position,
            key=self.key,
            timestamp=self.timestamp,
            producer_id=self.producer_id,
            raft_term=self.raft_term,
            metadata=self.metadata.copy(),
            value=self.value.copy() if self.value is not None else None,
        )


def stamp_source_positions(records: List["Record"], source_position: int) -> None:
    """Fill in the source position on follow-up records that don't carry one.
    Recovery's replay boundary is ``max(source_record_position)`` over the
    log (reference lastSourceEventPosition) — every written follow-up must
    link back to the record whose processing produced it.

    Lazy columnar refs (``(batch, idx)`` tuples from the device emission
    path) are skipped without materializing: the engine stamped their
    source column at emit — emission rows always carry a real source."""
    for record in records:
        if type(record) is tuple:
            continue
        if record.source_record_position < 0:
            record.source_record_position = source_position
