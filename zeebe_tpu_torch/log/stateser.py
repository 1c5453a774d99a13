"""Data-only snapshot codec for engine state (no pickle, ever).

Snapshot payloads are fetched from cluster peers over the snapshot
replication protocol (``runtime/cluster_broker.py``), so they must be
treated as untrusted input. The reference replicates opaque RocksDB files
and never deserializes executable objects from peers
(``broker-core/.../clustering/base/snapshots/SnapshotReplicationService.java``);
this module is the equivalent stance for the host engine: every state
family is explicitly encoded to plain msgpack data
(``zeebe_tpu.protocol.msgpack``) and explicitly reconstructed — decoding
can only ever produce the fixed set of state types below.

Workflows are snapshotted as their deployed source resource (BPMN XML /
YAML) plus (key, version) and re-transformed on restore — the transform is
deterministic, so this both avoids serializing the executable graph and
keeps the snapshot wire format independent of transformer internals.

Numpy arrays (device-engine state) are supported via a tagged
``{dtype, shape, raw bytes}`` envelope, mirroring how the reference treats
RocksDB checkpoints as raw byte streams.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from zeebe_tpu_torch.engine import interpreter as eng
from zeebe_tpu_torch.engine.keyspace import KeyGenerator
from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
from zeebe_tpu_torch.protocol.records import (
    IncidentRecord,
    JobRecord,
    TimerRecord,
    WorkflowInstanceRecord,
)

# compressed-envelope magic: snapshots are mostly sparse fixed-capacity
# tables (device SoA state) — zlib turns multi-MB payloads into ~KBs,
# which matters on the chunked snapshot-replication wire
_ZMAGIC = b"ZBZ1"

FORMAT_HOST_V1 = "zbtpu-host-state-v1"
FORMAT_DEVICE_V1 = "zbtpu-device-state-v1"
FORMAT_RAW_V1 = "zbtpu-raw-state-v1"

# snapshots cross the wire during replication; refuse absurd payloads
# before decoding (the follower also caps what it buffers per transfer)
MAX_SNAPSHOT_BYTES = 1 << 31


class SnapshotFormatError(ValueError):
    """Payload is not a valid snapshot in a known format."""


# ---------------------------------------------------------------------------
# ndarray envelope (device state / bulk columns)
# ---------------------------------------------------------------------------

_ALLOWED_DTYPES = {
    "bool", "int8", "uint8", "int16", "int32", "int64",
    "uint32", "uint64", "float32", "float64",
}


def pack_ndarray(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    if a.dtype.name not in _ALLOWED_DTYPES:
        raise SnapshotFormatError(f"unsupported dtype {a.dtype.name}")
    return {"__nd": a.dtype.name, "sh": list(a.shape), "b": a.tobytes()}


def unpack_ndarray(d: dict) -> np.ndarray:
    name = d.get("__nd")
    if name not in _ALLOWED_DTYPES:
        raise SnapshotFormatError(f"unsupported dtype {name!r}")
    shape = tuple(int(x) for x in d.get("sh", []))
    raw = d.get("b", b"")
    if not isinstance(raw, (bytes, bytearray)):
        raise SnapshotFormatError("ndarray payload is not bytes")
    a = np.frombuffer(raw, dtype=np.dtype(name))
    expected = int(np.prod(shape)) if shape else 1
    if a.size != expected:
        raise SnapshotFormatError("ndarray size mismatch")
    return a.reshape(shape).copy()


# ---------------------------------------------------------------------------
# host-engine state
# ---------------------------------------------------------------------------


def _enc_keygen(kg: KeyGenerator) -> dict:
    return {"n": kg.peek, "s": kg._step}


def _dec_keygen(d: dict) -> KeyGenerator:
    kg = KeyGenerator(int(d["n"]), int(d["s"]))
    return kg


def _enc_instances(index: eng.ElementInstanceIndex) -> List[dict]:
    # dict preserves insertion order, and a parent is always created before
    # its children, so a flat parent-key list round-trips the scope tree
    # (including children order).
    out = []
    for inst in index.instances.values():
        out.append({
            "k": inst.key,
            "p": inst.parent.key if inst.parent is not None else None,
            "s": int(inst.state) if inst.state is not None else None,
            "v": inst.value.to_document() if inst.value is not None else None,
            "j": inst.job_key,
            "t": inst.active_tokens,
            "a": inst.join_arrivals,
            "mo": inst.mi_outputs,
        })
    return out


def _dec_instances(items: List[Any]) -> eng.ElementInstanceIndex:
    index = eng.ElementInstanceIndex()
    for d in items:
        if not isinstance(d, dict):
            raise SnapshotFormatError("bad element instance entry")
        if d.get("p") is not None:
            parent = index.get(int(d["p"]))
            if parent is None:
                # a child without its parent means the payload is
                # internally inconsistent — fail the restore so
                # SnapshotController.recover falls back to an older
                # snapshot instead of silently promoting it to a root
                raise SnapshotFormatError(
                    f"element instance {d['k']} references missing parent {d['p']}"
                )
        else:
            parent = None
        inst = eng.ElementInstance(int(d["k"]), parent)
        inst.state = WI(int(d["s"])) if d.get("s") is not None else None
        inst.value = (
            WorkflowInstanceRecord.from_document(d["v"])
            if d.get("v") is not None else None
        )
        inst.job_key = int(d.get("j", -1))
        inst.active_tokens = int(d.get("t", 0))
        arrivals = d.get("a") or {}
        inst.join_arrivals = {
            int(gw): {int(fl): dict(payload) for fl, payload in flows.items()}
            for gw, flows in arrivals.items()
        }
        inst.mi_outputs = {int(c): v for c, v in (d.get("mo") or {}).items()}
        index.instances[inst.key] = inst
    return index


def _enc_workflows(workflows) -> List[dict]:
    out = []
    for wf in workflows:
        src = wf.source_resource
        if isinstance(src, str):
            src = src.encode("utf-8")
        out.append({
            "id": wf.id, "k": wf.key, "ver": wf.version,
            "src": src, "st": wf.source_type,
        })
    return out


def _dec_workflows(items: List[Any]):
    from zeebe_tpu_torch.models.bpmn.xml import read_model
    from zeebe_tpu_torch.models.bpmn.yaml_front import read_yaml_workflow
    from zeebe_tpu_torch.models.transform.transformer import transform_model

    out = []
    for d in items:
        if not isinstance(d, dict):
            raise SnapshotFormatError("bad workflow entry")
        data = d.get("src", b"")
        if isinstance(data, str):
            data = data.encode("utf-8")
        if d.get("st") == "YAML_WORKFLOW":
            model = read_yaml_workflow(data.decode("utf-8"))
        else:
            model = read_model(data, strict=False)  # already accepted at deploy
        matched = False
        for wf in transform_model(model):
            if wf.id != d.get("id"):
                continue
            wf.key = int(d["k"])
            wf.version = int(d["ver"])
            wf.source_resource = data
            wf.source_type = d.get("st", "BPMN_XML")
            out.append(wf)
            matched = True
        if not matched:
            # the recorded id must come back out of the re-transform;
            # dropping the workflow silently would restore partial state
            raise SnapshotFormatError(
                f"workflow id {d.get('id')!r} not produced by re-transform"
            )
    return out


# Per-key encoders: each top-level key of the host snapshot doc has one
# explicit encoder so a DELTA take can encode a single state family
# without walking the clean ones (the family split below groups keys the
# engine dirties together).
_HOST_KEY_ENCODERS: Dict[str, Any] = {
    "wf_keys": lambda s: _enc_keygen(s["wf_keys"]),
    "job_keys": lambda s: _enc_keygen(s["job_keys"]),
    "incident_keys": lambda s: _enc_keygen(s["incident_keys"]),
    "deployment_keys": lambda s: _enc_keygen(s["deployment_keys"]),
    "element_instances": lambda s: _enc_instances(s["element_instances"]),
    "jobs": lambda s: {
        k: {"s": js.state, "d": js.deadline, "r": js.record.to_document()}
        for k, js in s["jobs"].items()
    },
    "incidents": lambda s: {
        k: {"s": i.state, "ie": i.incident_event_position,
            "fe": i.failure_event_position}
        for k, i in s["incidents"].items()
    },
    "incident_by_activity": lambda s: dict(s["incident_by_activity"]),
    "incident_by_failed_job": lambda s: dict(s["incident_by_failed_job"]),
    "resolving_events": lambda s: dict(s["resolving_events"]),
    "incident_records": lambda s: {
        k: r.to_document() for k, r in s["incident_records"].items()
    },
    "messages": lambda s: {
        k: {"k": m.key, "n": m.name, "c": m.correlation_key,
            "ttl": m.time_to_live, "p": m.payload, "id": m.message_id,
            "dl": m.deadline}
        for k, m in s["messages"].items()
    },
    "message_subscriptions": lambda s: [
        {"n": sub.message_name, "c": sub.correlation_key,
         "pp": sub.workflow_instance_partition_id,
         "wk": sub.workflow_instance_key, "ak": sub.activity_instance_key}
        for sub in s["message_subscriptions"]
    ],
    "timers": lambda s: {
        k: {"d": t.due_date, "a": t.activity_instance_key,
            "r": t.record.to_document()}
        for k, t in s["timers"].items()
    },
    "pending_boundary": lambda s: {
        k: [bid, dict(payload)]
        for k, (bid, payload) in s.get("pending_boundary", {}).items()
    },
    # jobs that became activatable during a credit drought (the
    # engine's _awaiting_jobs backlog index, Dict[type, ordered key
    # set]); dropping it strands drought-backlogged jobs on a
    # snapshot-restored leader — backlog_activations would never
    # revisit them
    "awaiting_jobs": lambda s: {
        job_type: list(keys)
        for job_type, keys in s.get("awaiting_jobs", {}).items()
    },
    "topic_sub_acks": lambda s: dict(s["topic_sub_acks"]),
    # per-exporter acked positions; absent in pre-exporter snapshots
    "exporter_positions": lambda s: dict(s.get("exporter_positions", {})),
    "topics": lambda s: {k: dict(v) for k, v in s["topics"].items()},
    "next_partition_id": lambda s: s["next_partition_id"],
    "last_processed_position": lambda s: s["last_processed_position"],
    "workflows": lambda s: _enc_workflows(s["workflows"]),
}

# Host state families: the unit of dirty tracking and of per-part delta
# encoding. Each family becomes its own snapshot part ("h/<family>"), so a
# take re-encodes and re-hashes only families the engine marked dirty.
# "control" is small and includes last_processed_position, so it is dirty
# on effectively every take; the bulk families (instances, jobs, messages)
# only pay when their state actually changed.
HOST_FAMILIES: Dict[str, Tuple[str, ...]] = {
    "workflows": ("workflows",),
    "instances": ("element_instances", "pending_boundary"),
    "jobs": ("jobs", "awaiting_jobs"),
    "incidents": ("incidents", "incident_by_activity",
                  "incident_by_failed_job", "resolving_events",
                  "incident_records"),
    "messages": ("messages", "message_subscriptions"),
    "timers": ("timers",),
    "control": ("wf_keys", "job_keys", "incident_keys", "deployment_keys",
                "topic_sub_acks", "exporter_positions", "topics",
                "next_partition_id", "last_processed_position"),
}

# Device SoA arrays group into dtype/table families (the wave staging
# transfer unit); clean families skip the device→host readback entirely.
_DEVICE_FAMILY_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("free_ei", "ei"), ("free_job", "job"), ("ei", "ei"), ("job", "job"),
    ("join", "join"), ("timer", "timer"), ("msub", "msub"), ("msg", "msg"),
    ("sub", "sub"), ("next", "keys"),
)

DEVICE_ARRAY_FAMILIES = tuple(sorted({f for _, f in _DEVICE_FAMILY_PREFIXES}))


def device_array_family(field: str) -> str:
    """Dirty-tracking family of a device state field (or hashtable
    ``<field>.keys``/``.vals`` part name)."""
    base = field.split(".", 1)[0]
    for prefix, family in _DEVICE_FAMILY_PREFIXES:
        if base == prefix or base.startswith(prefix + "_"):
            return family
    return "other"


def part_family(name: str) -> Optional[str]:
    """Dirty-tracking family of a snapshot part name, or None for parts
    that are re-encoded on every take (the small ``_root``, legacy
    single-blob ``state``)."""
    if name.startswith("h/"):
        return name
    if name.startswith("a/"):
        return "d/" + device_array_family(name[2:])
    return None


def _enc_host_family(state: Dict[str, Any], family: str) -> bytes:
    doc: Dict[str, Any] = {}
    if family == "control":
        # the fmt marker rides in the always-dirty control family so the
        # merged doc of a family-split snapshot still self-identifies
        doc["fmt"] = FORMAT_HOST_V1
    for key in HOST_FAMILIES[family]:
        doc[key] = _HOST_KEY_ENCODERS[key](state)
    return msgpack.pack(doc)


def encode_host_state(state: Dict[str, Any]) -> bytes:
    """Encode ``PartitionEngine.snapshot_state()`` output to safe bytes."""
    doc: Dict[str, Any] = {"fmt": FORMAT_HOST_V1}
    for key, enc in _HOST_KEY_ENCODERS.items():
        doc[key] = enc(state)
    return msgpack.pack(doc)


def decode_host_state(payload: bytes) -> Dict[str, Any]:
    """Decode untrusted snapshot bytes back into the restore_state() dict.

    Raises SnapshotFormatError on anything that is not a well-formed v1
    host snapshot; never constructs anything beyond the fixed state types.
    """
    return _decode_host_doc(_unpack_checked(payload, FORMAT_HOST_V1))


def _unpack_checked(payload: bytes, expect_fmt: str) -> dict:
    if len(payload) > MAX_SNAPSHOT_BYTES:
        raise SnapshotFormatError("snapshot payload too large")
    try:
        doc = msgpack.unpack(payload)
    except Exception as e:
        raise SnapshotFormatError(f"undecodable snapshot: {e}") from None
    if not isinstance(doc, dict) or doc.get("fmt") != expect_fmt:
        raise SnapshotFormatError("unknown snapshot format")
    return doc


def _decode_host_doc(doc: dict) -> Dict[str, Any]:
    try:
        return {
            "wf_keys": _dec_keygen(doc["wf_keys"]),
            "job_keys": _dec_keygen(doc["job_keys"]),
            "incident_keys": _dec_keygen(doc["incident_keys"]),
            "deployment_keys": _dec_keygen(doc["deployment_keys"]),
            "element_instances": _dec_instances(doc["element_instances"]),
            "jobs": {
                int(k): eng.JobState(
                    state=int(v["s"]),
                    record=JobRecord.from_document(v["r"]),
                    deadline=int(v["d"]),
                )
                for k, v in doc["jobs"].items()
            },
            "incidents": {
                int(k): eng.IncidentState(
                    state=int(v["s"]),
                    incident_event_position=int(v["ie"]),
                    failure_event_position=int(v["fe"]),
                )
                for k, v in doc["incidents"].items()
            },
            "incident_by_activity": {
                int(k): int(v) for k, v in doc["incident_by_activity"].items()
            },
            "incident_by_failed_job": {
                int(k): int(v) for k, v in doc["incident_by_failed_job"].items()
            },
            "resolving_events": {
                int(k): int(v) for k, v in doc["resolving_events"].items()
            },
            "incident_records": {
                int(k): IncidentRecord.from_document(v)
                for k, v in doc["incident_records"].items()
            },
            "messages": {
                int(k): eng.StoredMessage(
                    key=int(v["k"]), name=str(v["n"]),
                    correlation_key=str(v["c"]), time_to_live=int(v["ttl"]),
                    payload=dict(v["p"]), message_id=str(v["id"]),
                    deadline=int(v["dl"]),
                )
                for k, v in doc["messages"].items()
            },
            "message_subscriptions": [
                eng.StoredSubscription(
                    message_name=str(s["n"]), correlation_key=str(s["c"]),
                    workflow_instance_partition_id=int(s["pp"]),
                    workflow_instance_key=int(s["wk"]),
                    activity_instance_key=int(s["ak"]),
                )
                for s in doc["message_subscriptions"]
            ],
            "timers": {
                int(k): eng.TimerState(
                    due_date=int(v["d"]),
                    activity_instance_key=int(v["a"]),
                    record=TimerRecord.from_document(v["r"]),
                )
                for k, v in doc["timers"].items()
            },
            "pending_boundary": {
                int(k): (str(v[0]), dict(v[1]))
                for k, v in doc.get("pending_boundary", {}).items()
            },
            # ordered key set per type (insertion-ordered dict of key ->
            # None, matching the engine's in-memory form); absent in
            # pre-round-6 snapshots
            "awaiting_jobs": {
                str(job_type): {int(k): None for k in keys}
                for job_type, keys in doc.get("awaiting_jobs", {}).items()
            },
            "topic_sub_acks": {
                str(k): int(v) for k, v in doc["topic_sub_acks"].items()
            },
            "exporter_positions": {
                str(k): int(v)
                for k, v in doc.get("exporter_positions", {}).items()
            },
            "topics": {str(k): dict(v) for k, v in doc["topics"].items()},
            "next_partition_id": int(doc["next_partition_id"]),
            "last_processed_position": int(doc["last_processed_position"]),
            "workflows": _dec_workflows(doc["workflows"]),
        }
    except SnapshotFormatError:
        raise
    except Exception as e:
        # includes parser errors from workflow-source re-transform (XML
        # ParseError, YAML errors): a snapshot that cannot be restored must
        # be SKIPPED by recovery (next older one is tried), never crash it
        raise SnapshotFormatError(f"malformed snapshot: {e}") from None


# ---------------------------------------------------------------------------
# generic entry points used by SnapshotController
# ---------------------------------------------------------------------------


def encode_state(state: Any) -> bytes:
    """Engine-state → bytes (zlib-compressed envelope). Dispatches on
    shape: a device-state envelope (dict with 'fmt' already set by the
    device engine) passes through its own encoder; a dict carrying
    KeyGenerators is host-engine state; any other plain-data value is
    wrapped raw (msgpack.pack rejects non-data objects, so nothing
    executable can sneak through this path either)."""
    if isinstance(state, dict) and state.get("fmt") == FORMAT_DEVICE_V1:
        raw = encode_device_state(state)
    elif isinstance(state, dict) and isinstance(state.get("wf_keys"), KeyGenerator):
        raw = encode_host_state(state)
    else:
        raw = msgpack.pack({"fmt": FORMAT_RAW_V1, "data": state})
    return _ZMAGIC + zlib.compress(raw, level=1)


def decode_state(payload: bytes) -> Any:
    if len(payload) > MAX_SNAPSHOT_BYTES:
        raise SnapshotFormatError("snapshot payload too large")
    if payload[:4] == _ZMAGIC:
        try:
            d = zlib.decompressobj()
            payload = d.decompress(payload[4:], MAX_SNAPSHOT_BYTES)
            if d.unconsumed_tail:
                raise SnapshotFormatError("snapshot decompresses too large")
        except zlib.error as e:
            raise SnapshotFormatError(f"corrupt snapshot: {e}") from None
    try:
        doc = msgpack.unpack(payload)
    except Exception as e:
        raise SnapshotFormatError(f"undecodable snapshot: {e}") from None
    if not isinstance(doc, dict):
        raise SnapshotFormatError("unknown snapshot format")
    fmt = doc.get("fmt")
    if fmt == FORMAT_HOST_V1:
        return _decode_host_doc(doc)
    if fmt == FORMAT_DEVICE_V1:
        return _decode_device_doc(doc)
    if fmt == FORMAT_RAW_V1:
        return doc.get("data")
    raise SnapshotFormatError(f"unknown snapshot format {fmt!r}")


# ---------------------------------------------------------------------------
# device-engine state (SoA tables + intern/varspace sidecars)
# ---------------------------------------------------------------------------


def encode_state_parts(state: Any) -> List[tuple]:
    """Engine-state → named parts for content-addressed checkpointing.

    The snapshot storage hashes each part and only writes segments it has
    not seen in a previous checkpoint (the TPU-native analogue of RocksDB
    checkpoints hard-linking unchanged SST files —
    ``logstreams/.../state/StateSnapshotController.java``). The split is
    chosen so the stable bulk dedupes:
    - device state: one part per SoA table array (fixed-capacity tables
      that did not change between checkpoints hash identically), plus the
      embedded host-oracle state and a small root part;
    - host state: one part per state family (``HOST_FAMILIES``) so the
      stable bulk — deployed workflow resources, quiescent instance or
      message tables — dedupes across checkpoints;
    - anything else: a single legacy-encoded part.

    Returns ``[(name, bytes), ...]``; decode with ``decode_state_parts``.
    """
    return encode_state_parts_delta(state, None)[0]


def encode_state_parts_delta(
    state: Any, dirty: Optional[Iterable[str]]
) -> Tuple[List[tuple], List[str]]:
    """Delta variant of :func:`encode_state_parts`: with ``dirty`` a set of
    family names (``"h/<family>"`` / ``"d/<family>"``), only parts of dirty
    families are encoded; parts of clean families come back by NAME in the
    second element, for the caller to resolve against the previous take's
    manifest. ``dirty=None`` encodes everything (full take). The tiny
    ``_root`` part is always re-encoded.

    For the device engine, a clean family's array values may be ``None``
    in ``state["arrays"]`` (readback skipped); only names are required.
    """
    dirty_set = None if dirty is None else set(dirty)
    if isinstance(state, dict) and state.get("fmt") == FORMAT_DEVICE_V1:
        names = sorted(state.get("arrays", {}).keys())
        parts = [
            (
                "_root",
                msgpack.pack(
                    {
                        "fmt": FORMAT_DEVICE_V1,
                        "meta": state.get("meta", {}),
                        "arrays": names,
                    }
                ),
            )
        ]
        clean: List[str] = []
        for name in names:
            family = "d/" + device_array_family(name)
            if dirty_set is not None and family not in dirty_set:
                clean.append("a/" + name)
                continue
            value = state["arrays"][name]
            if value is None:
                raise SnapshotFormatError(
                    f"array {name!r} of dirty family {family!r} was not "
                    "materialized by the engine"
                )
            parts.append(
                ("a/" + name, msgpack.pack(pack_ndarray(np.asarray(value))))
            )
        if state.get("host") is not None:
            hp, hc = _host_state_parts(state["host"], dirty_set)
            parts.extend(("h/" + n, b) for n, b in hp)
            clean.extend("h/" + n for n in hc)
        return parts, clean
    if isinstance(state, dict) and isinstance(state.get("wf_keys"), KeyGenerator):
        hp, hc = _host_state_parts(state, dirty_set)
        return (
            [("_root", msgpack.pack({"fmt": FORMAT_HOST_V1}))]
            + [("h/" + n, b) for n, b in hp],
            ["h/" + n for n in hc],
        )
    # legacy raw states have no family structure: always a full take
    return [("state", encode_state(state))], []


def _host_state_parts(
    state: Dict[str, Any], dirty: Optional[set] = None
) -> Tuple[List[tuple], List[str]]:
    """Host engine state as one part per family (``HOST_FAMILIES``); with
    ``dirty``, clean families are skipped and returned by name."""
    parts: List[tuple] = []
    clean: List[str] = []
    for family in HOST_FAMILIES:
        if dirty is not None and ("h/" + family) not in dirty:
            clean.append(family)
            continue
        parts.append((family, _enc_host_family(state, family)))
    return parts, clean


def decode_state_parts(parts: Dict[str, bytes]) -> Any:
    """Reassemble ``encode_state_parts`` output (untrusted bytes)."""
    if sum(len(b) for b in parts.values()) > MAX_SNAPSHOT_BYTES:
        raise SnapshotFormatError("snapshot parts too large")
    if set(parts) == {"state"}:
        return decode_state(parts["state"])
    if "_root" not in parts:
        raise SnapshotFormatError("snapshot root part missing")
    return decode_state_parts_stream(
        [("_root", parts["_root"])]
        + [(n, b) for n, b in parts.items() if n != "_root"]
    )


def decode_state_parts_stream(part_iter: Iterable[tuple]) -> Any:
    """Streaming reassembly of ``encode_state_parts`` output: consumes
    ``(name, bytes)`` pairs in manifest order (``_root`` first — the
    manifest's canonical sort guarantees it) and decodes each part as it
    arrives, so restore memory is bounded by the decoded state plus ONE
    in-flight part instead of all raw part bytes at once (the restore
    analogue of the wave pipeline's per-family columnar readback)."""
    it = iter(part_iter)
    try:
        first_name, first_data = next(it)
    except StopIteration:
        raise SnapshotFormatError("empty snapshot") from None
    if first_name == "state":
        return decode_state(first_data)
    if first_name != "_root":
        raise SnapshotFormatError(
            f"snapshot stream must start with _root, got {first_name!r}"
        )
    try:
        root = msgpack.unpack(first_data)
    except Exception as e:
        raise SnapshotFormatError(f"malformed snapshot root: {e}") from None
    if not isinstance(root, dict):
        raise SnapshotFormatError("malformed snapshot root")
    fmt = root.get("fmt")
    if fmt not in (FORMAT_HOST_V1, FORMAT_DEVICE_V1):
        raise SnapshotFormatError(f"unknown snapshot parts format {fmt!r}")

    total = len(first_data)
    arrays: Dict[str, np.ndarray] = {}
    # host family parts decode AS THEY ARRIVE into one merged doc (the
    # legacy two-part layout merges through the same path: its
    # "workflows" part has the family shape and "rest" is the remainder
    # incl. the fmt marker), so raw part bytes never accumulate
    host_doc: Dict[str, Any] = {}
    saw_host = False
    for name, data in it:
        total += len(data)
        if total > MAX_SNAPSHOT_BYTES:
            raise SnapshotFormatError("snapshot parts too large")
        if name.startswith("a/"):
            try:
                arrays[name[2:]] = unpack_ndarray(msgpack.unpack(data))
            except SnapshotFormatError:
                raise
            except Exception as e:
                raise SnapshotFormatError(
                    f"malformed snapshot part {name!r}: {e}"
                ) from None
        elif name.startswith("h/"):
            saw_host = True
            try:
                sub = msgpack.unpack(data)
            except Exception as e:
                raise SnapshotFormatError(
                    f"malformed snapshot part {name!r}: {e}"
                ) from None
            if not isinstance(sub, dict):
                raise SnapshotFormatError(
                    f"malformed snapshot part {name!r}"
                )
            host_doc.update(sub)
        else:
            raise SnapshotFormatError(f"unexpected snapshot part {name!r}")

    host = None
    if saw_host:
        if host_doc.get("fmt") != FORMAT_HOST_V1:
            raise SnapshotFormatError("malformed host snapshot parts")
        host = _decode_host_doc(host_doc)
    if fmt == FORMAT_HOST_V1:
        if host is None:
            raise SnapshotFormatError("snapshot host parts missing")
        return host
    names = [str(n) for n in root.get("arrays", [])]
    missing = [n for n in names if n not in arrays]
    if missing:
        raise SnapshotFormatError(f"snapshot part missing: 'a/{missing[0]}'")
    meta = root.get("meta", {})
    if not isinstance(meta, dict):
        raise SnapshotFormatError("malformed snapshot meta")
    return {
        "fmt": FORMAT_DEVICE_V1,
        "arrays": {n: arrays[n] for n in names},
        "meta": meta,
        "host": host,
    }


def encode_device_state(state: Dict[str, Any]) -> bytes:
    """Device snapshot envelope: {'fmt', 'arrays': {name: ndarray},
    'meta': plain-data dict, 'host': host-engine snapshot dict or None}.

    The embedded host oracle state (device engines keep one for
    device-ineligible records) rides along as its own encoded payload.
    """
    doc = {
        "fmt": FORMAT_DEVICE_V1,
        "arrays": {
            name: pack_ndarray(np.asarray(a))
            for name, a in state.get("arrays", {}).items()
        },
        "meta": state.get("meta", {}),
        "host": (
            encode_host_state(state["host"])
            if state.get("host") is not None else None
        ),
    }
    return msgpack.pack(doc)


def decode_device_state(payload: bytes) -> Dict[str, Any]:
    return _decode_device_doc(_unpack_checked(payload, FORMAT_DEVICE_V1))


def _decode_device_doc(doc: dict) -> Dict[str, Any]:
    try:
        return {
            "fmt": FORMAT_DEVICE_V1,
            "arrays": {
                str(k): unpack_ndarray(v) for k, v in doc["arrays"].items()
            },
            "meta": doc.get("meta", {}),
            "host": (
                decode_host_state(doc["host"])
                if doc.get("host") is not None else None
            ),
        }
    except SnapshotFormatError:
        raise
    except Exception as e:
        raise SnapshotFormatError(f"malformed snapshot: {e}") from None
