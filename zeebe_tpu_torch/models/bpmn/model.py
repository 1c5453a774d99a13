"""BPMN 2.0 meta-model (typed instance API).

Reference parity: ``bpmn-model/src/main/java/io/zeebe/model/bpmn/instance/``
(~180 element types; this implements the executable subset the engine runs:
process, start/end event, service task, exclusive & parallel gateway,
sequence flow with conditions, intermediate message catch event, sub-process,
receive task, plus the Zeebe extension elements
``ZeebeTaskDefinition``/``ZeebeTaskHeaders``/``ZeebeIoMapping``/
``ZeebeInput``/``ZeebeOutput``/``ZeebeSubscription``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional


class ElementType(enum.IntEnum):
    """Flow element kinds. Stable ints: these are the ``element_type`` column
    of the compiled element table on device."""

    PROCESS = 0
    START_EVENT = 1
    END_EVENT = 2
    SERVICE_TASK = 3
    EXCLUSIVE_GATEWAY = 4
    PARALLEL_GATEWAY = 5
    SEQUENCE_FLOW = 6
    INTERMEDIATE_CATCH_EVENT = 7
    SUB_PROCESS = 8
    RECEIVE_TASK = 9
    BOUNDARY_EVENT = 10


@dataclasses.dataclass
class Mapping:
    """A payload input/output mapping (reference: json-path ``Mapping``;
    Zeebe extension <zeebe:input source target>)."""

    source: str  # JSONPath, e.g. "$.totalPrice"
    target: str  # e.g. "$.price"


class OutputBehavior(enum.IntEnum):
    """Reference: ZeebeOutputBehavior (merge | overwrite | none)."""

    MERGE = 0
    OVERWRITE = 1
    NONE = 2


@dataclasses.dataclass
class TaskDefinition:
    """Reference: ZeebeTaskDefinition extension (type + retries)."""

    type: str = ""
    retries: int = 3


@dataclasses.dataclass
class MessageDefinition:
    """A BPMN <message> with the Zeebe subscription extension
    (reference: bpmn-model Message + ZeebeSubscription)."""

    name: str = ""
    correlation_key: str = ""  # JSONPath query into the payload


@dataclasses.dataclass
class FlowElement:
    id: str
    element_type: ElementType = ElementType.PROCESS
    name: str = ""


@dataclasses.dataclass
class FlowNode(FlowElement):
    incoming: List["SequenceFlow"] = dataclasses.field(default_factory=list)
    outgoing: List["SequenceFlow"] = dataclasses.field(default_factory=list)
    # payload io mappings (activities and catch events)
    input_mappings: List[Mapping] = dataclasses.field(default_factory=list)
    output_mappings: List[Mapping] = dataclasses.field(default_factory=list)
    output_behavior: OutputBehavior = OutputBehavior.MERGE
    # containing scope: a Process or SubProcess id ("" = top level process)
    scope_id: str = ""


@dataclasses.dataclass
class StartEvent(FlowNode):
    def __post_init__(self):
        self.element_type = ElementType.START_EVENT


@dataclasses.dataclass
class EndEvent(FlowNode):
    def __post_init__(self):
        self.element_type = ElementType.END_EVENT


@dataclasses.dataclass
class ServiceTask(FlowNode):
    task_definition: TaskDefinition = dataclasses.field(default_factory=TaskDefinition)
    task_headers: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.element_type = ElementType.SERVICE_TASK


@dataclasses.dataclass
class ExclusiveGateway(FlowNode):
    default_flow_id: Optional[str] = None

    def __post_init__(self):
        self.element_type = ElementType.EXCLUSIVE_GATEWAY


@dataclasses.dataclass
class ParallelGateway(FlowNode):
    def __post_init__(self):
        self.element_type = ElementType.PARALLEL_GATEWAY


@dataclasses.dataclass
class IntermediateCatchEvent(FlowNode):
    message: Optional[MessageDefinition] = None
    # timer catch event: duration in millis (TPU-native; reference version
    # has message catch only, timers arrive in later reference versions)
    timer_duration_ms: Optional[int] = None

    def __post_init__(self):
        self.element_type = ElementType.INTERMEDIATE_CATCH_EVENT


@dataclasses.dataclass
class ReceiveTask(FlowNode):
    message: Optional[MessageDefinition] = None

    def __post_init__(self):
        self.element_type = ElementType.RECEIVE_TASK


@dataclasses.dataclass
class BoundaryEvent(FlowNode):
    """An event attached to an activity's boundary (reference model:
    ``bpmn-model/.../instance/BoundaryEvent.java`` + cancelActivity
    attribute). Timer or message triggered; interrupting
    (``cancel_activity=True``) terminates the host activity before the
    token continues on the boundary flow."""

    attached_to_id: str = ""
    cancel_activity: bool = True  # interrupting by default (BPMN spec)
    message: Optional[MessageDefinition] = None
    timer_duration_ms: Optional[int] = None

    def __post_init__(self):
        self.element_type = ElementType.BOUNDARY_EVENT


@dataclasses.dataclass
class MultiInstanceLoopCharacteristics:
    """Reference model:
    ``bpmn-model/.../instance/MultiInstanceLoopCharacteristics.java``.
    Parallel multi-instance: the activity body runs once per item of the
    input collection (JSONPath into the payload) or ``cardinality`` times;
    ``input_element`` names the per-iteration variable."""

    input_collection: str = ""  # JSONPath to an array in the payload
    input_element: str = "item"  # variable holding collection[i]
    cardinality: Optional[int] = None  # fixed N (used when no collection)
    output_collection: str = ""  # variable collecting per-iteration results
    # JSONPath into each finished iteration's payload whose value is
    # appended (in loopCounter order) to output_collection; defaults to
    # the input element variable
    output_element: str = ""


@dataclasses.dataclass
class SubProcess(FlowNode):
    multi_instance: Optional[MultiInstanceLoopCharacteristics] = None

    def __post_init__(self):
        self.element_type = ElementType.SUB_PROCESS


@dataclasses.dataclass
class SequenceFlow(FlowElement):
    source_id: str = ""
    target_id: str = ""
    condition_expression: Optional[str] = None  # json-el condition text
    scope_id: str = ""

    def __post_init__(self):
        self.element_type = ElementType.SEQUENCE_FLOW


@dataclasses.dataclass
class Process(FlowElement):
    executable: bool = True

    def __post_init__(self):
        self.element_type = ElementType.PROCESS


NODE_TYPES = (
    StartEvent,
    EndEvent,
    ServiceTask,
    ExclusiveGateway,
    ParallelGateway,
    IntermediateCatchEvent,
    ReceiveTask,
    SubProcess,
    BoundaryEvent,
)


class BpmnModel:
    """A parsed BPMN model instance: processes + flow elements + messages.

    Reference: ``BpmnModelInstance`` (bpmn-model/.../Bpmn.java:272).
    """

    def __init__(self):
        self.processes: List[Process] = []
        self.elements: Dict[str, FlowElement] = {}
        self.messages: Dict[str, MessageDefinition] = {}

    def add(self, element: FlowElement) -> FlowElement:
        if element.id in self.elements:
            raise ValueError(f"duplicate element id: {element.id}")
        self.elements[element.id] = element
        if isinstance(element, Process):
            self.processes.append(element)
        return element

    def element(self, element_id: str) -> FlowElement:
        return self.elements[element_id]

    def nodes_in_scope(self, scope_id: str) -> List[FlowNode]:
        return [
            e
            for e in self.elements.values()
            if isinstance(e, FlowNode) and e.scope_id == scope_id
        ]

    def flows_in_scope(self, scope_id: str) -> List[SequenceFlow]:
        return [
            e
            for e in self.elements.values()
            if isinstance(e, SequenceFlow) and e.scope_id == scope_id
        ]

    def connect(self, flow: SequenceFlow) -> None:
        source = self.elements[flow.source_id]
        target = self.elements[flow.target_id]
        if not isinstance(source, FlowNode) or not isinstance(target, FlowNode):
            raise ValueError(f"sequence flow {flow.id} must connect flow nodes")
        source.outgoing.append(flow)
        target.incoming.append(flow)
