"""Host wrapper: a batched partition stream processor over the step kernel.

PyTorch counterpart of ``zeebe_tpu.tpu.engine``. ``CudaPartitionEngine`` is
the device-backed drop-in for the host oracle ``PartitionEngine``
(``zeebe_tpu_torch/engine/interpreter.py``): the broker feeds it committed
records (in log order) and gets back written follow-ups, responses,
cross-partition sends and worker pushes — but processing runs as SIMD
batches through ``kernel.step_kernel`` on the card.

Routing: WORKFLOW_INSTANCE / JOB / TIMER records run on the device, and
MESSAGE / MESSAGE_SUBSCRIPTION / WORKFLOW_INSTANCE_SUBSCRIPTION records
too when the deployed set has message elements; DEPLOYMENT and INCIDENT
records are delegated to an embedded host oracle engine (rare
control-plane work). Emissions are merged back in source order, which
preserves the oracle's append order.

Workflows the device cannot execute fall back per workflow: their instance
records route to the embedded host oracle, so the engine serves every
deployed workflow. What puts a workflow there is what
``graph.check_device_compatible`` refuses, as in the JAX engine;
``host_only_reasons`` names it. The message store (this partition's
message-partition role) lives on exactly one side: on the device when the
deployed set has message elements and no host-only workflow, else on the
host; a deployment that flips the side migrates it. Device timers fire
through the broker tick's host sweep (``check_timer_deadlines``), whose
TRIGGER commands come back through the step kernel.

Unlike JAX arrays, the state tables are updated IN PLACE by the step
kernel; every host read below that must outlive a later step copies.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from zeebe_tpu_torch.device import DeviceLike, resolve
from zeebe_tpu_torch.engine.interpreter import (
    JobSubscription,
    PartitionEngine,
    ProcessingResult,
    WorkflowRepository,
)
from zeebe_tpu_torch.engine.mappings import MappingError, extract, merge
from zeebe_tpu_torch.models.el.interpreter import (
    ConditionEvalError,
    evaluate_condition,
)
from zeebe_tpu_torch.protocol.enums import (
    ErrorType,
    RecordType,
    RejectionType,
    ValueType,
)
from zeebe_tpu_torch.protocol.intents import (
    JobIntent as JI,
    WorkflowInstanceIntent as WI,
)
from zeebe_tpu_torch.protocol.metadata import RecordMetadata
from zeebe_tpu_torch.protocol.records import (
    IncidentRecord,
    JobHeaders,
    JobRecord,
    Record,
    TimerRecord,
    WorkflowInstanceRecord,
)
from zeebe_tpu_torch.tpu import batch as rb
from zeebe_tpu_torch.tpu import graph as graph_mod
from zeebe_tpu_torch.tpu import kernel, ops, shard as shard_mod, state as state_mod
from zeebe_tpu_torch.tpu.batch import PayloadError, RecordBatch
from zeebe_tpu_torch.tpu.intern import InternTable

_DEVICE_VALUE_TYPES = {
    int(ValueType.WORKFLOW_INSTANCE),
    int(ValueType.JOB),
    int(ValueType.TIMER),
}

_MESSAGE_VALUE_TYPES = {
    int(ValueType.MESSAGE),
    int(ValueType.MESSAGE_SUBSCRIPTION),
    int(ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION),
}

# JOB (record type, intent) pairs that decide a job's activation: its
# ACTIVATE command and the events that enter the activation pool
_ACTIVATION_DECIDING = {
    (int(RecordType.COMMAND), int(JI.ACTIVATE)),
    (int(RecordType.EVENT), int(JI.CREATED)),
    (int(RecordType.EVENT), int(JI.TIMED_OUT)),
    (int(RecordType.EVENT), int(JI.FAILED)),
    (int(RecordType.EVENT), int(JI.RETRIES_UPDATED)),
}
_ACTIVATION_DECIDING_CODES = np.array(
    sorted(rt * 256 + intent for rt, intent in _ACTIVATION_DECIDING), np.int64
)

PROBE_DEADLINES = 1  # bit0: some job/timer/message deadline is due
PROBE_JOB_BACKLOG = 2  # bit1: assignable jobs exist AND credits are free


def _due_probe_kernel(state: state_mod.EngineState, now: int) -> torch.Tensor:
    """0-dim int32 bitmask (PROBE_*): is ANY device-side deadline due at
    ``now``, and is there job backlog a free credit could assign (jobs
    type-matched against credited subscriptions)? One plain reduction over
    the relevant columns; the predicates mirror the host sweeps below."""
    job_due = torch.any(
        (state.job_state == int(JI.ACTIVATED))
        & (state.job_deadline >= 0)
        & (state.job_deadline <= now)
    )
    timer_due = torch.any((state.timer_key >= 0) & (state.timer_due <= now))
    msg_due = torch.any((state.msg_key >= 0) & (state.msg_deadline <= now))
    assignable = (
        (state.job_state == int(JI.CREATED))
        | (state.job_state == int(JI.TIMED_OUT))
        | (state.job_state == int(JI.FAILED))
    ) & (state.job_i32[:, state_mod.JB_RETRIES] > 0)
    credited = state.sub_valid & (state.sub_credits > 0)
    backlog = torch.any(
        assignable[:, None]
        & credited[None, :]
        & (state.job_i32[:, state_mod.JB_TYPE, None] == state.sub_type[None, :])
    )
    return (
        (job_due | timer_due | msg_due).to(torch.int32) * PROBE_DEADLINES
        + backlog.to(torch.int32) * PROBE_JOB_BACKLOG
    )


class DueProbe:
    """A launched ``_due_probe_kernel`` that the broker's tick polls
    without blocking: ``is_ready()`` asks the CUDA event recorded after the
    mask's copy into pinned host memory, ``int()`` waits on it and reads
    the copy. On the CPU the mask is there at once."""

    def __init__(self, mask: torch.Tensor):
        self._event = None
        if mask.is_cuda:
            host = torch.empty((), dtype=mask.dtype, pin_memory=True)
            host.copy_(mask, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(mask.device))
            mask = host
        self._mask = mask

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def __int__(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._mask)


def _np(t: torch.Tensor) -> np.ndarray:
    """A host view of a tensor for an immediate read (shares memory with a
    CPU tensor: never keep it across a step)."""
    return t.detach().cpu().numpy()


def _np_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor that later in-place steps leave alone."""
    return t.detach().to("cpu", copy=True).numpy()


def _host_unpack_payload(pay: np.ndarray):
    """Host-side view of one packed payload row ([3V] i32 — see
    state.pack_payload): returns (vt, num, sid) for columns_to_payload."""
    v = pay.shape[-1] // 3
    vt = pay[..., :v]
    sid = pay[..., v : 2 * v]
    num = np.ascontiguousarray(pay[..., 2 * v : 3 * v]).view(np.float32)
    return vt, num, sid


def _pow2(n: int) -> int:
    p = 64
    while p < n:
        p *= 2
    return p


def _as_record(entry) -> Record:
    """Materialize a tail entry (real ``Record`` or lazy ``(batch, idx)``
    ref)."""
    if type(entry) is tuple:
        return entry[0].row(entry[1])
    return entry


_FRAME_DEFAULTS = None


def _frame_defaults():
    """Frame-field defaults of a fresh Record/metadata (producer_id,
    incident_key, rejection_type): the lazy emission batch pre-fills its
    frame columns with these."""
    global _FRAME_DEFAULTS
    if _FRAME_DEFAULTS is None:
        md = RecordMetadata()
        probe = Record(metadata=md)
        _FRAME_DEFAULTS = (
            probe.producer_id, md.incident_key, int(md.rejection_type),
        )
    return _FRAME_DEFAULTS


_staged_columnar_counter = None


def _count_staged_columnar(n: int = 1) -> None:
    global _staged_columnar_counter
    if _staged_columnar_counter is None:
        from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY

        _staged_columnar_counter = GLOBAL_REGISTRY.counter(
            "serving_rows_staged_columnar_total",
            "Device rows re-staged straight from emission-batch columns "
            "(no Record object ever materialized for them)",
        )
    _staged_columnar_counter.inc(n)


@dataclasses.dataclass
class _PendingSegment:
    """One dispatched (not yet collected) device segment of a wave."""

    results: List[ProcessingResult]
    positions: List[int]
    live: List[int]           # indices (into the segment's records) staged
    suppress: set             # segment-record indices with host-emitted
                              # job-incident follow-ups (kernel copy drops)
    rows: List[int] = dataclasses.field(default_factory=list)
    out: Optional[RecordBatch] = None   # device emission batch (unfetched)
    stats: Optional[dict] = None        # device stats (unfetched)
    route_owner: Optional[int] = None   # routed wave's owner shard
    seq: int = -1                       # dispatch order (residency ordering)
    fb_pop: bool = False                # gathered fallback under routing:
                                        # collect pops residency from emissions
    blind: bool = False                 # fallback carried rows whose instance
                                        # key the host could not prove


@dataclasses.dataclass
class PendingWave:
    """A wave in flight: dispatched to the device, results not yet
    materialized. ``records`` may be a plain list or a lazy columnar view;
    ``positions`` carries every record's log position."""

    records: List[Record]
    per_record: List[Optional[ProcessingResult]]
    segments: List[_PendingSegment] = dataclasses.field(default_factory=list)
    positions: List[int] = dataclasses.field(default_factory=list)
    partition_id: int = -1
    host_seconds: float = 0.0    # staging + host-routed records + readback
    device_seconds: float = 0.0  # blocked on device outputs at collect
    collected: Optional[List[ProcessingResult]] = None  # one-shot cache


class CudaPartitionEngine:
    """Batched device stream processor for one partition."""

    def __init__(
        self,
        partition_id: int = 0,
        num_partitions: int = 1,
        repository: Optional[WorkflowRepository] = None,
        clock: Optional[Callable[[], int]] = None,
        capacity: int = 1 << 12,
        num_vars: int = 16,
        sub_capacity: int = 16,
        device: DeviceLike = None,
        device_index: int = -1,
        state_shards: int = 1,
        shard_devices=None,
        device_indices=None,
        routing: str = "gathered",
        routed_lane_slots: int = 512,
    ):
        self.partition_id = partition_id
        self.num_partitions = num_partitions
        # the plan's index of this engine's device (scheduler/placement
        # DevicePlan), used as the per-device metrics label
        self.device_index = device_index
        # sharded state: with state_shards > 1 this partition's row tables
        # block-shard over a span of devices (tpu/shard.py). "gathered"
        # steps the gathered tables every wave; "resident" routes a wave
        # whose rows all belong to instances resident in one block to that
        # block's shard alone, and every other wave through the gathered
        # fallback. Both write the single-device engine's log
        self._state_shards = max(int(state_shards), 1)
        if routing not in ("gathered", "resident"):
            raise ValueError(f"unknown mesh routing mode: {routing!r}")
        self.routing = routing if self._state_shards > 1 else "gathered"
        self._routed_lane_slots = max(int(routed_lane_slots), 1)
        self._mesh: Optional[shard_mod.Mesh] = None
        self._shards: Optional[shard_mod.ShardedState] = None
        self._state_step = None
        self._state_step_routed = None
        self._state_step_fallback = None
        self._shard_exchange_bytes = 0
        self._fallback_exchange_bytes = 0
        self.sharded_waves = 0
        self.routed_waves = 0
        self.fallback_waves = 0
        self.routed_overflows = 0
        # per-shard staged-row counts of the last dispatched wave (the
        # owner's lane in a routed wave, the key-hash split otherwise)
        self.last_shard_fill: tuple = ()
        self._last_stage_split = None
        self._last_stage_valid = 0
        # residency map: root workflow instance key → the shard whose block
        # holds the WHOLE instance (learned from routed segments' emissions;
        # popped on fallback dispatch and collect, demotion, completion)
        self._resident: Dict[int, int] = {}
        # instance key → dispatch seq of the fallback or demotion that broke
        # its single-owner proof: a collect of an earlier-dispatched routed
        # segment must not note the key back in
        self._residency_invalid: Dict[int, int] = {}
        self._dispatch_seq = 0
        # dispatched, uncollected fallback segments that stepped rows whose
        # instance the host could not name: until their emissions name them,
        # no residency entry is trusted
        self._blind_fb_inflight = 0
        self.device_indices = list(device_indices) if device_indices is not None else []
        if self._state_shards > 1:
            if device is not None:
                raise ValueError(
                    "state_shards > 1 shards over a mesh span; a single "
                    "`device` placement cannot also be pinned"
                )
            devs = (
                list(shard_devices) if shard_devices is not None
                else [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            )
            if len(devs) < self._state_shards:
                raise ValueError(
                    f"state_shards={self._state_shards} needs that many "
                    f"devices; have {len(devs)}"
                )
            self._mesh = shard_mod.Mesh([resolve(d) for d in devs[: self._state_shards]])
            if not self.device_indices:
                self.device_indices = list(range(self._state_shards))
            # host work (staging, the gathered view, the graph) runs on the
            # span's first device
            self.device = self._mesh.devices[0]
        else:
            # the CUDA card unless the caller asks for the CPU
            self.device = resolve(device)
        self.repository = repository if repository is not None else WorkflowRepository()
        self.clock = clock or (lambda: 0)
        for dev in dict.fromkeys(self._mesh.devices if self._mesh else [self.device]):
            if dev.type == "cuda":
                # the boot self-check, once per process and card: a kernel
                # that computes wrong on a card refuses to serve there (the
                # JAX engine's place of autotune, after which its boot runs
                # pallas_ops.selfcheck)
                ops.selfcheck(dev)
        self.capacity = capacity
        self.num_vars = num_vars
        self.interns = InternTable()

        # host oracle engine for control-plane records and host-only
        # workflows; shares the repository and the workflow keyspace via
        # explicit counter sync after each batch
        self._host = PartitionEngine(
            partition_id=partition_id,
            num_partitions=num_partitions,
            repository=self.repository,
            clock=self.clock,
        )

        self.graph: Optional[graph_mod.DeviceGraph] = None
        self.meta: Optional[graph_mod.GraphMeta] = None
        self._state: Optional[state_mod.EngineState] = None
        self.state = state_mod.make_state(
            capacity=capacity, num_vars=num_vars, sub_capacity=sub_capacity,
            device=self.device,
        )
        # the device allocates from the embedded oracle's key space, which
        # carries the partition in the keys' high bits
        self._state.next_wf_key.fill_(self._host.wf_keys.peek)
        self._state.next_job_key.fill_(self._host.job_keys.peek)
        if self._mesh is not None:
            self._shard(self._state)
        # key watermark of the last rebuild_lookup_state run (see
        # _dispatch_device)
        self._keys_at_rebuild = 0
        self._compiled_count = 0
        self._host_only_keys: set = set()
        # workflow key → why its instances run on the host oracle
        self.host_only_reasons: Dict[int, str] = {}
        self.device_records_processed = 0
        self.host_records_processed = 0
        # device-table job key -> records written for it and not processed
        # yet that decide its activation: an ACTIVATE command (the kernel's
        # assignment, device_backlog_activations' or a new subscription's
        # backlog), or an event that enters the activation pool (CREATED,
        # TIMED_OUT, FAILED, RETRIES_UPDATED). Until they are processed the
        # table already says activatable, but the job is not stranded: the
        # oracle's backlog holds only jobs whose pool event found no credit,
        # so the tick's backlog scan and a new subscription leave these out.
        # A broker's replay ends with note_unprocessed, which counts the tail
        # it leaves unprocessed
        self._job_records_in_flight: Dict[int, int] = {}
        self._device_keys_dirty = False
        # message store side (see _recompile): True = the device tables
        # serve MESSAGE / MESSAGE_SUBSCRIPTION records
        self._messages_on_device = False
        self._restoring = False
        self.records_by_position: Dict[int, Record] = self._host.records_by_position
        self.last_processed_position = -1
        # delta-snapshot dirty tracking over the device table families;
        # None = cold (everything dirty)
        self._dirty_device: Optional[set] = None
        self.last_snapshot_readback: List[str] = []
        # bumped by _recompile: workflow SLOTS in older emission batches
        # are stale after a redeploy
        self._meta_epoch = 0

    # -- placement ----------------------------------------------------------
    @property
    def state(self) -> state_mod.EngineState:
        """The partition's tables. A sharded engine gathers them on its first
        device when a host reader asks; that view is what the host reads and
        writes until the next step writes it back into the blocks."""
        if self._shards is None:
            return self._state
        if self._shards.view is None:
            self._shards.view = shard_mod.gather_state(self._shards)
        return self._shards.view

    @state.setter
    def state(self, st: state_mod.EngineState) -> None:
        if self._shards is None:
            self._state = st
        else:
            self._shards.view = st

    def _shard(self, st: state_mod.EngineState) -> None:
        """Block-shard a global state over the span and build the span's
        step programs for its shapes (a restore may change them)."""
        mesh = self._mesh
        if self.routing == "resident":
            bad = shard_mod.unshardable_state_leaves(st, self._state_shards)
            if bad:
                raise ValueError(
                    "resident routing needs every shardable table "
                    "divisible by the span; replicated-fallback "
                    f"leaves: {bad} (use routing='gathered' or a "
                    "divisible capacity)"
                )
        self._shards = shard_mod.shard_state(mesh, st)
        self._state = None
        if self.routing == "resident":
            self._state_step_routed = shard_mod.build_state_step_routed(mesh, st)
            self._state_step_fallback = shard_mod.build_state_step_fallback(mesh, st)
            self._fallback_exchange_bytes = shard_mod.state_exchange_bytes(
                st, self._state_shards, include_lookup=False
            )
        else:
            self._state_step = shard_mod.build_state_step(mesh, st)
        self._shard_exchange_bytes = shard_mod.state_exchange_bytes(st, self._state_shards)

    def _replica_states(self) -> List[state_mod.EngineState]:
        """The states whose replicated leaves (key counters, worker
        subscriptions) a write must reach without a gather: the state, the
        held view, or every shard."""
        if self._shards is None:
            return [self._state]
        if self._shards.view is not None:
            return [self._shards.view]
        return list(self._shards.shards)

    def _replicas(self, name: str) -> List[torch.Tensor]:
        """The tensors of a replicated leaf a write must reach (the first
        is the one to read)."""
        return [getattr(s, name) for s in self._replica_states()]

    def _index_rows(self) -> int:
        """Rows of the global element-instance index (no gather)."""
        if self._shards is None:
            return self._state.ei_index.shape[0]
        return self._shards.global_rows("ei_index")

    def place_on(self, device, device_index: int = -1) -> None:
        """Move this engine's live tables (the message store and the key
        counters among them) and its graph onto another device: a
        DevicePlan rebalance after a device exclusion or a leadership
        change. Contents are unchanged, so snapshot dirty-tracking is left
        as it is; call between waves (the brokers do, on the broker
        actor)."""
        if self._mesh is not None:
            raise RuntimeError(
                "sharded-state engine is pinned to its mesh span; rebuild "
                "the engine (snapshot → restore) to move it"
            )
        dev = resolve(device)
        if dev.type == "cuda":
            ops.selfcheck(dev)
        self.device = dev
        self.device_index = device_index
        self._state = state_mod.state_to(self._state, dev)
        if self.graph is not None:
            self.graph = shard_mod.graph_on(self.graph, dev)

    # -- routing ----------------------------------------------------------
    def partition_for_correlation_key(self, correlation_key: str) -> int:
        return self._host.partition_for_correlation_key(correlation_key)

    @property
    def topics(self):
        return self._host.topics

    @property
    def topic_sub_acks(self):
        return self._host.topic_sub_acks

    @property
    def exporter_positions(self):
        return self._host.exporter_positions

    # -- deployment → graph recompile -------------------------------------
    def _recompile(self, extra_variables=None) -> None:
        """Split the deployed set: device-compatible workflows compile into
        the graph; the rest run their instances on the embedded host
        oracle."""
        workflows = []
        host_only = set()
        reasons: Dict[int, str] = {}
        for key in sorted(self.repository.by_key):
            wf = self.repository.by_key[key]
            reason = graph_mod.check_device_compatible(wf)
            if reason is not None:
                host_only.add(key)
                reasons[key] = reason
            else:
                workflows.append(wf)
        self._host_only_keys = host_only
        self.host_only_reasons = reasons
        self._meta_epoch += 1  # older emission batches' wf slots are stale
        if not workflows:
            self.graph = None
            self._compiled_count = 0
            self._set_message_store_side(False)
            return
        if extra_variables is not None:
            var_names = list(extra_variables)
        else:
            var_names = list(self.meta.varspace.names) if self.meta else []
        self.graph, self.meta = graph_mod.compile_graph(
            workflows, interns=self.interns, extra_variables=var_names,
            device=self.device,
        )
        if self.graph.num_vars > self.num_vars:
            raise PayloadError(
                f"workflow variables ({self.graph.num_vars}) exceed engine "
                f"num_vars={self.num_vars}; raise num_vars"
            )
        self._compiled_count = len(workflows)
        # the store lives on the device iff the deployed set compiles with
        # message elements and has no host-only workflow: a store split
        # between the sides would let a publish see only some of the
        # subscriptions. Flipping sides migrates the store
        self._set_message_store_side(self.graph.has_messages and not host_only)

    def _set_message_store_side(self, on_device: bool) -> None:
        prev = self._messages_on_device
        self._messages_on_device = on_device
        if self._restoring:
            return
        if on_device and not prev:
            self._migrate_message_store_to_device()
        elif prev and not on_device:
            self._migrate_message_store_to_host()

    def _migrate_message_store_to_device(self) -> None:
        """Host oracle message store → device tables (a deployment flipped
        the store side; a rare control-plane event, a plain host loop)."""
        from zeebe_tpu_torch.tpu.conditions import VT_NUM, VT_STR

        host = self._host
        if not host.messages and not host.message_subscriptions:
            return
        self._mark_device_dirty("msg", "msub")
        host.snapshot_mark_dirty(("h/messages",))
        s = self.state

        def corr_cols(value) -> tuple:
            # an interned string id, or the f32 bit pattern of a number
            if isinstance(value, str):
                return int(VT_STR), self.interns.intern(value)
            return int(VT_NUM), int(np.float32(float(value)).view(np.int32))

        def composite(name: str, cvt: int, cbits: int) -> int:
            nid = self.interns.intern(name)
            return (nid << 35) | (cvt << 32) | (cbits & 0xFFFFFFFF)

        msub_ckey = _np_copy(s.msub_ckey)
        msub_i32 = _np_copy(s.msub_i32)
        msub_i64 = _np_copy(s.msub_i64)
        mkeys, mslots = [], []
        free = list(np.nonzero(msub_ckey < 0)[0])
        if len(host.message_subscriptions) > len(free):
            raise RuntimeError(
                f"message-store migration needs "
                f"{len(host.message_subscriptions)} subscription slots but "
                f"the device table has {len(free)} free — raise the "
                "engine's msub capacity"
            )
        for sub in host.message_subscriptions:
            cvt, cbits = corr_cols(sub.correlation_key)
            ck = composite(sub.message_name, cvt, cbits)
            slot = int(free.pop(0))
            msub_ckey[slot] = ck
            msub_i32[slot] = (
                self.interns.intern(sub.message_name), cvt, cbits,
                sub.workflow_instance_partition_id,
            )
            msub_i64[slot] = (sub.workflow_instance_key, sub.activity_instance_key)
            mkeys.append(ck)
            mslots.append(slot)
        host.message_subscriptions = []

        msg_key = _np_copy(s.msg_key)
        msg_ckey = _np_copy(s.msg_ckey)
        msg_i32 = _np_copy(s.msg_i32)
        msg_deadline = _np_copy(s.msg_deadline)
        msg_pay = _np_copy(s.msg_pay)
        gkeys, gslots = [], []
        gfree = list(np.nonzero(msg_key < 0)[0])
        if len(host.messages) > len(gfree):
            raise RuntimeError(
                f"message-store migration needs {len(host.messages)} stored-"
                f"message slots but the device table has {len(gfree)} free "
                "— raise the engine's msg capacity"
            )
        for key, message in sorted(host.messages.items()):
            cvt, cbits = corr_cols(message.correlation_key)
            ck = composite(message.name, cvt, cbits)
            slot = int(gfree.pop(0))
            msg_key[slot] = key
            msg_ckey[slot] = ck
            msg_i32[slot] = (
                self.interns.intern(message.name), cvt, cbits,
                self.interns.intern(message.message_id)
                if message.message_id else 0,
            )
            msg_deadline[slot] = message.deadline
            vt, num, sid = rb.payload_to_columns(
                message.payload, self._var_column, self.interns, self.num_vars
            )
            msg_pay[slot] = np.concatenate(
                [vt.astype(np.int32), sid, np.ascontiguousarray(num).view(np.int32)]
            )
            gkeys.append(ck)
            gslots.append(slot)
        host.messages = {}

        dev = self.device
        for name, host_copy in (
            ("msub_ckey", msub_ckey), ("msub_i32", msub_i32), ("msub_i64", msub_i64),
            ("msg_key", msg_key), ("msg_ckey", msg_ckey), ("msg_i32", msg_i32),
            ("msg_deadline", msg_deadline), ("msg_pay", msg_pay),
        ):
            getattr(s, name).copy_(torch.from_numpy(host_copy))
        for table, keys, slots in ((s.msub_map, mkeys, mslots),
                                   (s.msg_map, gkeys, gslots)):
            if keys:
                ops.insert(
                    table, torch.tensor(keys, dtype=torch.int64, device=dev),
                    torch.tensor(slots, dtype=torch.int32, device=dev),
                    torch.ones((len(keys),), dtype=torch.bool, device=dev),
                )

    def _migrate_message_store_to_host(self) -> None:
        """Device message tables → host oracle store (a host-only workflow
        arrived; the store moves so every subscription sees every publish)."""
        from zeebe_tpu_torch.engine.interpreter import (
            StoredMessage,
            StoredSubscription,
        )
        from zeebe_tpu_torch.tpu import hashmap

        self._mark_device_dirty("msg", "msub")
        self._host.snapshot_mark_dirty(("h/messages",))
        s = self.state
        names = self.meta.varspace.names if self.meta else []
        corr_value = self._corr_string

        msub_ckey = _np(s.msub_ckey)
        msub_i32 = _np(s.msub_i32)
        msub_i64 = _np(s.msub_i64)
        for slot in np.nonzero(msub_ckey >= 0)[0]:
            slot = int(slot)
            self._host.message_subscriptions.append(
                StoredSubscription(
                    message_name=self.interns.string(int(msub_i32[slot, 0])) or "",
                    correlation_key=corr_value(
                        int(msub_i32[slot, 1]), int(msub_i32[slot, 2])
                    ),
                    workflow_instance_partition_id=int(msub_i32[slot, 3]),
                    workflow_instance_key=int(msub_i64[slot, 0]),
                    activity_instance_key=int(msub_i64[slot, 1]),
                )
            )
        msg_key = _np(s.msg_key)
        msg_i32 = _np(s.msg_i32)
        msg_deadline = _np(s.msg_deadline)
        msg_pay = _np(s.msg_pay)
        for slot in np.nonzero(msg_key >= 0)[0]:
            slot = int(slot)
            key = int(msg_key[slot])
            self._host.messages[key] = StoredMessage(
                key=key,
                name=self.interns.string(int(msg_i32[slot, 0])) or "",
                correlation_key=corr_value(
                    int(msg_i32[slot, 1]), int(msg_i32[slot, 2])
                ),
                time_to_live=0,
                payload=rb.columns_to_payload(
                    *_host_unpack_payload(msg_pay[slot]), names, self.interns
                ),
                message_id=self.interns.string(int(msg_i32[slot, 3])) or "",
                deadline=int(msg_deadline[slot]),
            )
        for name in ("msub_ckey", "msub_i64", "msg_key", "msg_ckey", "msg_deadline"):
            getattr(s, name).fill_(-1)
        s.msub_map = hashmap.make(s.msub_map.keys.shape[0], device=self.device)
        s.msg_map = hashmap.make(s.msg_map.keys.shape[0], device=self.device)

    # -- instance demotion: rare imperative ops take the host path ---------
    def _live_device_instance_slot(self, key: int) -> int:
        """Slot of a live root element instance in the device table, -1
        when absent (completed, unknown, or host-side)."""
        if key < 0:
            return -1
        keys = _np(self.state.ei_i64[:, 0])
        states = _np(self.state.ei_i32[:, state_mod.EI_STATE])
        hits = np.nonzero((keys == key) & (states != -1))[0]
        return int(hits[0]) if len(hits) else -1

    def _demote_instance(self, root_key: int) -> None:
        """Migrate a live instance's scope tree (+ its jobs, timers and
        in-flight joins) from the device tables into the embedded host
        oracle, which then runs the exact reference cascade for CANCEL /
        UPDATE_PAYLOAD."""
        self._mark_device_dirty()
        self._host.snapshot_mark_dirty(None)
        # a demoted instance leaves the device tables, so it is resident in
        # no block; the invalidation also keeps collects of segments
        # dispatched before now from noting it back in
        self._resident.pop(int(root_key), None)
        self._residency_invalid[int(root_key)] = self._dispatch_seq
        s = self.state
        ei_i32 = _np_copy(s.ei_i32)
        ei_i64 = _np_copy(s.ei_i64)
        ei_pay = _np_copy(s.ei_pay)
        states = ei_i32[:, state_mod.EI_STATE]
        live = states != -1

        root_slot = self._live_device_instance_slot(root_key)
        if root_slot < 0:
            return
        # collect the scope tree (parent-slot pointers, bounded depth)
        tree = {root_slot}
        changed = True
        while changed:
            changed = False
            for slot in np.nonzero(live)[0]:
                parent = int(ei_i32[slot, state_mod.EI_SCOPE])
                if parent in tree and int(slot) not in tree:
                    tree.add(int(slot))
                    changed = True
        slots_sorted = sorted(tree, key=lambda sl: int(ei_i64[sl, 0]))

        names = self.meta.varspace.names if self.meta else []
        by_slot: Dict[int, object] = {}
        for slot in slots_sorted:
            key = int(ei_i64[slot, 0])
            parent_slot = int(ei_i32[slot, state_mod.EI_SCOPE])
            parent = by_slot.get(parent_slot)
            wf_slot = int(ei_i32[slot, state_mod.EI_WF])
            workflow = (
                self.meta.workflows[wf_slot]
                if self.meta and 0 <= wf_slot < len(self.meta.workflows)
                else None
            )
            value = WorkflowInstanceRecord(
                bpmn_process_id=workflow.id if workflow else "",
                version=workflow.version if workflow else -1,
                workflow_key=workflow.key if workflow else -1,
                workflow_instance_key=int(ei_i64[slot, 1]),
                activity_id=(
                    self.meta.element_id(
                        wf_slot, int(ei_i32[slot, state_mod.EI_ELEM])
                    )
                    if self.meta else ""
                ),
                payload=rb.columns_to_payload(
                    *_host_unpack_payload(ei_pay[slot]), names, self.interns
                ),
                scope_instance_key=(
                    int(ei_i64[parent_slot, 0]) if parent_slot in tree else -1
                ),
            )
            inst = self._host.element_instances.new_instance(
                key, value, WI(int(states[slot])), parent=parent
            )
            inst.job_key = int(ei_i64[slot, 2])
            inst.active_tokens = int(ei_i32[slot, state_mod.EI_TOKENS])
            pending_elem = int(ei_i32[slot, state_mod.EI_PENDING_BD])
            if pending_elem >= 0 and self.meta:
                self._host._pending_boundary[key] = (
                    self.meta.element_id(wf_slot, pending_elem),
                    dict(value.payload),
                )
            by_slot[slot] = inst

        tree_keys = {int(ei_i64[sl, 0]) for sl in tree}

        # migrate this tree's jobs
        job_i64 = _np_copy(s.job_i64)
        job_i32 = _np_copy(s.job_i32)
        job_slots = [
            int(sl)
            for sl in np.nonzero(job_i32[:, state_mod.JB_STATE] != -1)[0]
            if int(job_i64[sl, state_mod.JBL_AIK]) in tree_keys
        ]
        from zeebe_tpu_torch.engine.interpreter import JobState

        for sl in job_slots:
            jkey = int(job_i64[sl, state_mod.JBL_KEY])
            self._host.jobs[jkey] = JobState(
                state=int(job_i32[sl, state_mod.JB_STATE]),
                record=self._job_value_from_slot(sl),
                deadline=int(job_i64[sl, state_mod.JBL_DEADLINE]),
            )

        # migrate this tree's timers
        from zeebe_tpu_torch.engine.interpreter import TimerState

        timer_keys = _np_copy(s.timer_key)
        timer_aik = _np_copy(s.timer_aik)
        timer_due = _np_copy(s.timer_due)
        timer_ik = _np_copy(s.timer_instance_key)
        timer_wf = _np_copy(s.timer_wf)
        timer_elem = _np_copy(s.timer_elem)
        timer_slots = [
            int(sl)
            for sl in np.nonzero(timer_keys >= 0)[0]
            if int(timer_aik[sl]) in tree_keys
        ]
        for sl in timer_slots:
            self._host.timers[int(timer_keys[sl])] = TimerState(
                due_date=int(timer_due[sl]),
                activity_instance_key=int(timer_aik[sl]),
                record=TimerRecord(
                    activity_instance_key=int(timer_aik[sl]),
                    workflow_instance_key=int(timer_ik[sl]),
                    due_date=int(timer_due[sl]),
                    handler_element_id=self.meta.element_id(
                        int(timer_wf[sl]), int(timer_elem[sl])
                    ) if self.meta else "",
                ),
            )

        # migrate in-flight parallel joins: device join rows are keyed by
        # (scope_key << 10 | gateway element), payloads merged eagerly
        join_keys = _np_copy(s.join_key)
        join_arr = _np_copy(s.join_arrived)
        join_pay_np = _np_copy(s.join_pay)
        join_slots = [
            int(sl)
            for sl in np.nonzero(join_keys >= 0)[0]
            if int(join_keys[sl]) >> 10 in tree_keys
        ]
        for sl in join_slots:
            scope_key = int(join_keys[sl]) >> 10
            gw_elem = int(join_keys[sl]) & ((1 << 10) - 1)
            scope = self._host.element_instances.get(scope_key)
            if scope is None:
                continue
            merged = rb.columns_to_payload(
                *_host_unpack_payload(join_pay_np[sl]), names, self.interns
            )
            arrivals = {
                int(pos): dict(merged)
                for pos in np.nonzero(join_arr[sl])[0]
            }
            if arrivals:
                scope.join_arrivals[gw_elem] = arrivals

        # clear the migrated rows from the device tables + hash maps
        dev = self.device

        def idx(values, dtype=torch.int64):
            return torch.as_tensor(values, dtype=dtype, device=dev)

        ei_idx = idx(sorted(tree))
        ei_del_keys = idx([int(ei_i64[sl, 0]) for sl in sorted(tree)])
        s.ei_i32[ei_idx, state_mod.EI_STATE] = -1
        s.ei_i64[ei_idx, 0] = -1
        # the four maps' deletes in one launch, after the table writes
        maps, deletes = [], []

        def delete(table, keys):
            maps.append(table)
            deletes.append(ops.DeleteOp(len(deletes), keys, torch.ones(
                keys.shape, dtype=torch.bool, device=dev)))

        delete(s.ei_map, ei_del_keys)
        if job_slots:
            j_idx = idx(job_slots)
            j_keys = idx([int(job_i64[sl, state_mod.JBL_KEY]) for sl in job_slots])
            s.job_i32[j_idx, state_mod.JB_STATE] = -1
            s.job_i64[j_idx, state_mod.JBL_KEY] = -1
            delete(s.job_map, j_keys)
        if timer_slots:
            t_idx = idx(timer_slots)
            t_keys = idx([int(timer_keys[sl]) for sl in timer_slots])
            s.timer_key[t_idx] = -1
            s.timer_due[t_idx] = -1
            delete(s.timer_map, t_keys)
        if join_slots:
            jo_idx = idx(join_slots)
            jo_keys = idx([int(join_keys[sl]) for sl in join_slots])
            s.join_key[jo_idx] = -1
            s.join_nin[jo_idx] = 0
            s.join_arrived[jo_idx] = False
            s.join_pos_stamp[jo_idx] = -1
            delete(s.join_map, jo_keys)
        ops.fused_delete(maps, deletes)
        # the host-side frees bypass the kernel's free-slot ring: re-derive
        # it (and the lookup structures) now
        self.state = state_mod.rebuild_lookup_state(s)
        self._keys_at_rebuild = 0

    def _routes_to_host(self, record: Record) -> bool:
        """True when a device-value-type record belongs to a host-only
        workflow or a host-side (possibly demoted) instance and must run on
        the oracle. Pure — no side effects."""
        vt = int(record.metadata.value_type)
        value = record.value
        if vt == int(ValueType.WORKFLOW_INSTANCE):
            wf_key = value.workflow_key
            intent = int(record.metadata.intent)
            if wf_key <= 0 and intent == int(WI.CREATE):
                wf = self._resolve_workflow(value)
                wf_key = wf.key if wf is not None else -1
            if wf_key in self._host_only_keys:
                return True
            if self._nonscalar_payload(record):
                return True
            if int(record.metadata.record_type) == int(RecordType.COMMAND) and (
                intent in (int(WI.CANCEL), int(WI.UPDATE_PAYLOAD))
            ):
                return True
            instances = self._host.element_instances.instances
            return (
                record.key in instances
                or value.workflow_instance_key in instances
            )
        if vt == int(ValueType.JOB):
            if self._nonscalar_payload(record):
                return True
            return (
                value.headers.workflow_key in self._host_only_keys
                or record.key in self._host.jobs
                or value.headers.workflow_instance_key
                in self._host.element_instances.instances
            )
        if vt == int(ValueType.TIMER):
            return (
                record.key in self._host.timers
                or value.activity_instance_key
                in self._host.element_instances.instances
            )
        if vt in (
            int(ValueType.MESSAGE), int(ValueType.MESSAGE_SUBSCRIPTION)
        ):
            return not self._messages_on_device
        if vt == int(ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION):
            return (
                value.activity_instance_key
                in self._host.element_instances.instances
            )
        return False

    def _var_column(self, name: str) -> int:
        if self.meta is None:
            raise PayloadError("no workflows deployed")
        col = self.meta.varspace.column(name)
        if col >= self.num_vars:
            raise PayloadError(f"variable space overflow at {name!r}")
        return col

    # -- worker subscriptions (host-managed device table) ------------------
    def add_job_subscription(self, sub: JobSubscription) -> List[Record]:
        """Idempotent per subscriber key. Returns ACTIVATE commands for the
        backlog of already-created matching jobs (device table and host
        oracle); the caller appends them to the partition log. A job whose
        activation is in flight is not backlog yet (see
        ``_job_records_in_flight``)."""
        self.remove_job_subscription(sub.subscriber_key)
        host_backlog = self._host_subscription_backlog(sub)
        s = self.state
        valid = _np(s.sub_valid)
        free = int(np.argmin(valid)) if not valid.all() else -1
        if free < 0 or valid[free]:
            raise RuntimeError("subscription table full")

        activatable = {int(JI.CREATED), int(JI.TIMED_OUT), int(JI.FAILED)}
        type_id = self.interns.intern(sub.job_type)
        job_i32 = _np_copy(s.job_i32)
        job_keys = _np_copy(s.job_key)
        backlog: List[Record] = []
        credits = sub.credits
        candidates = [
            (int(job_keys[slot]), slot)
            for slot in np.nonzero(
                (job_i32[:, state_mod.JB_STATE] != -1)
                & (job_i32[:, state_mod.JB_TYPE] == type_id)
                & (job_i32[:, state_mod.JB_RETRIES] > 0)
            )[0]
            if int(job_i32[slot, state_mod.JB_STATE]) in activatable
            and int(job_keys[slot]) not in self._job_records_in_flight
        ]
        for key, slot in sorted(candidates):
            if credits <= 0:
                break
            activated = self._job_value_from_slot(int(slot))
            activated.deadline = self.clock() + sub.timeout
            activated.worker = sub.worker
            backlog.append(
                Record(
                    key=key,
                    value=activated,
                    metadata=RecordMetadata(
                        record_type=RecordType.COMMAND,
                        value_type=ValueType.JOB,
                        intent=int(JI.ACTIVATE),
                        request_stream_id=sub.subscriber_key,
                    ),
                )
            )
            credits -= 1

        self._mark_device_dirty("sub")
        s.sub_key[free] = sub.subscriber_key
        s.sub_type[free] = type_id
        s.sub_worker[free] = self.interns.intern(sub.worker)
        # backlog activations consumed credits up front; the kernel
        # returns them on ACTIVATE rejection like pool assignments
        s.sub_credits[free] = credits
        s.sub_timeout[free] = sub.timeout
        s.sub_valid[free] = True
        for r in host_backlog + backlog:
            self._note_job_records(r.key, 1)
        return host_backlog + backlog

    def _host_subscription_backlog(self, sub: JobSubscription) -> List[Record]:
        """The host oracle's ``add_job_subscription``, leaving out the jobs
        of its table whose activation is in flight, as the device scan
        does: a worker that subscribes again (after a term change, or on a
        retried request) must not activate them a second time. The oracle
        registers the subscription; its backlog is drawn here, in the
        oracle's order and with its records."""
        host_sub = dataclasses.replace(sub, credits=0)
        self._host.add_job_subscription(host_sub)
        host_sub.credits = sub.credits
        activatable = (
            int(JI.CREATED), int(JI.TIMED_OUT), int(JI.FAILED),
            int(JI.RETRIES_UPDATED),
        )
        out: List[Record] = []
        for key, job in sorted(self._host.jobs.items()):
            if host_sub.credits <= 0:
                break
            if (
                job.state not in activatable
                or job.record.type != sub.job_type
                or job.record.retries <= 0
                or key in self._job_records_in_flight
            ):
                continue
            activated = job.record.copy()
            activated.deadline = self.clock() + sub.timeout
            activated.worker = sub.worker
            out.append(
                Record(
                    key=key,
                    value=activated,
                    metadata=RecordMetadata(
                        record_type=RecordType.COMMAND,
                        value_type=ValueType.JOB,
                        intent=int(JI.ACTIVATE),
                        request_stream_id=sub.subscriber_key,
                    ),
                )
            )
            host_sub.credits -= 1
        return out

    def remove_job_subscription(self, subscriber_key: int) -> None:
        self._host.remove_job_subscription(subscriber_key)
        self._mark_device_dirty("sub")
        for s in self._replica_states():
            s.sub_valid &= s.sub_key != subscriber_key

    def increase_job_credits(self, subscriber_key: int, credits: int) -> None:
        self._host.increase_job_credits(subscriber_key, credits)
        self._mark_device_dirty("sub")
        for s in self._replica_states():
            s.sub_credits += torch.where(s.sub_key == subscriber_key, credits, 0).to(
                s.sub_credits.dtype
            )

    def job_subscriptions(self) -> List[JobSubscription]:
        """The worker subscriptions the device table holds, with their
        credits left: what an engine reinstalled at the same term (a
        sharded partition moved off an excluded device) takes over."""
        s = self._replica_states()[0]
        rows = zip(*(_np(t).tolist() for t in (s.sub_valid, s.sub_key, s.sub_type,
                                                s.sub_worker, s.sub_timeout, s.sub_credits)))
        return [
            JobSubscription(subscriber_key=key, job_type=self.interns.string(jtype) or "",
                            worker=self.interns.string(worker) or "", timeout=timeout,
                            credits=credits)
            for valid, key, jtype, worker, timeout, credits in rows if valid
        ]

    # -- deadline scans (broker tick) --------------------------------------
    def deadlines_due_probe(self) -> DueProbe:
        """The bitmask (PROBE_DEADLINES | PROBE_JOB_BACKLOG) of
        ``_due_probe_kernel``, launched now and read by ``int()``: is any
        device-side deadline due, and is there unassigned job backlog a
        free credit could serve? The in-process broker reads it at once
        each tick; the cluster broker polls ``is_ready()`` and reads it on
        a later tick. Host-oracle deadlines are swept by
        ``host_deadline_commands``."""
        now = int(self.clock())
        if self._shards is None or self._shards.view is not None:
            return DueProbe(_due_probe_kernel(self.state, now))
        # sharded: each block's predicates against its replicated
        # subscription table, or-ed on the first device (no gather)
        mask = None
        for shard in self._shards.shards:
            m = _due_probe_kernel(shard, now).to(self.device)
            mask = m if mask is None else mask | m
        return DueProbe(mask)

    def backlog_activations(self) -> List[Record]:
        """Host-oracle side only; the device job backlog is served by
        ``device_backlog_activations`` behind the probe's backlog bit.
        Jobs of the oracle's awaiting index whose activation is in flight
        (a subscription's backlog activated them) stay out of it until
        their records are processed."""
        host, in_flight = self._host, self._job_records_in_flight
        if not in_flight:
            out = host.backlog_activations()
        else:
            # the oracle scans its index without those jobs; they go back in
            # their places (the index is FIFO, and snapshots keep its order)
            waiting = host._awaiting_jobs
            host._awaiting_jobs = {
                job_type: {k: None for k in keys if k not in in_flight}
                for job_type, keys in waiting.items()
            }
            try:
                out = host.backlog_activations()
            finally:
                left = host._awaiting_jobs
                host._awaiting_jobs = {
                    job_type: kept for job_type, keys in waiting.items()
                    if (kept := {k: None for k in keys
                                 if k in in_flight or k in left.get(job_type, ())})
                }
        for r in out:
            self._note_job_records(r.key, 1)
        return out

    def device_backlog_activations(self) -> List[Record]:
        """ACTIVATE commands for device-table jobs that became activatable
        while every subscription was out of credits. Credits are consumed
        up front; the kernel returns them on ACTIVATE rejection."""
        s = self.state
        valid = _np(s.sub_valid).copy()
        if not valid.any():
            return []
        sub_keys = _np_copy(s.sub_key)
        sub_types = _np_copy(s.sub_type)
        sub_credits = _np_copy(s.sub_credits)
        sub_timeouts = _np_copy(s.sub_timeout)
        sub_workers = _np_copy(s.sub_worker)
        if not (sub_credits[valid] > 0).any():
            return []
        activatable = {int(JI.CREATED), int(JI.TIMED_OUT), int(JI.FAILED)}
        job_i32 = _np_copy(s.job_i32)
        job_keys = _np_copy(s.job_key)
        candidates = [
            (int(job_keys[slot]), slot)
            for slot in np.nonzero(
                (job_i32[:, state_mod.JB_STATE] != -1)
                & (job_i32[:, state_mod.JB_RETRIES] > 0)
            )[0]
            if int(job_i32[slot, state_mod.JB_STATE]) in activatable
            and int(job_keys[slot]) not in self._job_records_in_flight
        ]
        out: List[Record] = []
        now = self.clock()
        sub_slots = [int(i) for i in np.nonzero(valid)[0]]
        # the round-robin cursor persists in state.sub_rr (host-oracle
        # parity: the oracle's cursor is global)
        rr = int(s.sub_rr) % len(sub_slots)
        for key, slot in sorted(candidates):
            type_id = int(job_i32[slot, state_mod.JB_TYPE])
            target = None
            for j in range(len(sub_slots)):
                cand = sub_slots[(rr + j) % len(sub_slots)]
                if sub_credits[cand] > 0 and int(sub_types[cand]) == type_id:
                    target = cand
                    rr = (rr + j + 1) % len(sub_slots)
                    break
            if target is None:
                continue  # no credits for this type; try other jobs' types
            sub_credits[target] -= 1
            activated = self._job_value_from_slot(int(slot))
            activated.deadline = now + int(sub_timeouts[target])
            activated.worker = self.interns.string(int(sub_workers[target])) or ""
            out.append(
                Record(
                    key=key,
                    value=activated,
                    metadata=RecordMetadata(
                        record_type=RecordType.COMMAND,
                        value_type=ValueType.JOB,
                        intent=int(JI.ACTIVATE),
                        request_stream_id=int(sub_keys[target]),
                    ),
                )
            )
        if out:  # rr only advances on an assignment, which also appends
            self._mark_device_dirty("sub")
            s.sub_credits.copy_(torch.from_numpy(sub_credits))
            s.sub_rr.fill_(rr)
            for r in out:
                self._note_job_records(r.key, 1)
        return out

    def job_records_in_flight(self) -> Dict[int, int]:
        """Job key -> records written that decide its activation and are
        not processed yet (see ``_job_records_in_flight``). Empty once the
        partition is quiet: every record written has been processed."""
        return dict(self._job_records_in_flight)

    def _note_job_records(self, key: int, delta: int) -> None:
        """Count a written (+1) or processed (-1) record that decides the
        activation of job ``key`` (see ``_job_records_in_flight``); one
        processed without being counted is ignored."""
        n = self._job_records_in_flight.get(key, 0) + delta
        if n > 0:
            self._job_records_in_flight[key] = n
        else:
            self._job_records_in_flight.pop(key, None)

    def note_unprocessed(self, records) -> None:
        """Recount ``_job_records_in_flight`` from ``records``, every record
        written and not processed yet. A broker calls it once its replay is
        done: the tail the last run appended and never processed holds
        ACTIVATE commands and pool events that no output of this engine
        counted (a snapshot covers the records that wrote them)."""
        counts: Dict[int, int] = {}
        for r in records:
            md = r.metadata
            if (int(md.value_type) == int(ValueType.JOB)
                    and (int(md.record_type), int(md.intent)) in _ACTIVATION_DECIDING):
                counts[r.key] = counts.get(r.key, 0) + 1
        self._job_records_in_flight = counts

    def host_deadline_commands(self) -> List[Record]:
        """The embedded oracle's due commands only (per-family key order)."""
        return (
            sorted(self._host.check_job_deadlines(), key=lambda r: r.key)
            + sorted(self._host.check_timer_deadlines(), key=lambda r: r.key)
            + sorted(self._host.check_message_ttls(), key=lambda r: r.key)
        )

    def device_deadline_commands(self) -> List[Record]:
        """Device-side due commands only (jobs, timers, message TTLs — each
        family key-sorted)."""
        return (
            self._device_job_deadlines()
            + self._device_timer_deadlines()
            + self._device_message_ttls()
        )

    def check_job_deadlines(self) -> List[Record]:
        return sorted(
            self._device_job_deadlines() + self._host.check_job_deadlines(),
            key=lambda r: r.key,
        )

    def _device_job_deadlines(self) -> List[Record]:
        now = self.clock()
        s = self.state
        keys = _np_copy(s.job_key)
        states = _np(s.job_state)
        deadlines = _np(s.job_deadline)
        due = (states == int(JI.ACTIVATED)) & (deadlines >= 0) & (deadlines <= now)
        out = []
        for slot in np.nonzero(due)[0][np.argsort(keys[np.nonzero(due)[0]])]:
            out.append(
                Record(
                    key=int(keys[slot]),
                    metadata=RecordMetadata(
                        record_type=RecordType.COMMAND,
                        value_type=ValueType.JOB,
                        intent=int(JI.TIME_OUT),
                    ),
                    value=self._job_value_from_slot(int(slot)),
                )
            )
        return out

    def check_timer_deadlines(self) -> List[Record]:
        return sorted(
            self._device_timer_deadlines() + self._host.check_timer_deadlines(),
            key=lambda r: r.key,
        )

    def _device_timer_deadlines(self) -> List[Record]:
        now = self.clock()
        s = self.state
        keys = _np(s.timer_key)
        due = (keys >= 0) & (_np(s.timer_due) <= now)
        slots = np.nonzero(due)[0]
        out = []
        for slot in slots[np.argsort(keys[slots])]:
            slot = int(slot)
            out.append(
                Record(
                    key=int(keys[slot]),
                    metadata=RecordMetadata(
                        record_type=RecordType.COMMAND,
                        value_type=ValueType.TIMER,
                        intent=2,  # TimerIntent.TRIGGER
                    ),
                    value=TimerRecord(
                        workflow_instance_key=int(_np(s.timer_instance_key)[slot]),
                        activity_instance_key=int(_np(s.timer_aik)[slot]),
                        due_date=int(_np(s.timer_due)[slot]),
                        handler_element_id=self.meta.element_id(
                            int(_np(s.timer_wf)[slot]),
                            int(_np(s.timer_elem)[slot]),
                        ),
                    ),
                )
            )
        return out

    def check_message_ttls(self) -> List[Record]:
        return sorted(
            self._device_message_ttls() + self._host.check_message_ttls(),
            key=lambda r: r.key,
        )

    def _device_message_ttls(self) -> List[Record]:
        from zeebe_tpu_torch.protocol.intents import MessageIntent as MI
        from zeebe_tpu_torch.protocol.records import MessageRecord

        now = self.clock()
        s = self.state
        keys = _np(s.msg_key)
        due = (keys >= 0) & (_np(s.msg_deadline) <= now)
        slots = np.nonzero(due)[0]
        names = self.meta.varspace.names if self.meta else []
        msg_i32 = _np(s.msg_i32)
        msg_pay = _np(s.msg_pay)
        out = []
        for slot in slots[np.argsort(keys[slots])]:
            slot = int(slot)
            out.append(
                Record(
                    key=int(keys[slot]),
                    metadata=RecordMetadata(
                        record_type=RecordType.COMMAND,
                        value_type=ValueType.MESSAGE,
                        intent=int(MI.DELETE),
                    ),
                    value=MessageRecord(
                        name=self.interns.string(int(msg_i32[slot, 0])) or "",
                        correlation_key=self._corr_string(
                            int(msg_i32[slot, 1]), int(msg_i32[slot, 2])
                        ),
                        payload=rb.columns_to_payload(
                            *_host_unpack_payload(msg_pay[slot]),
                            names, self.interns,
                        ),
                        message_id=(
                            self.interns.string(int(msg_i32[slot, 3])) or ""
                        ),
                    ),
                )
            )
        return out

    def compaction_floor(self) -> int:
        """Incident state lives on the embedded host oracle."""
        return min(
            self.last_processed_position + 1, self._host.compaction_floor()
        )

    # -- snapshot / restore: the tables leave the card in the data-only
    # device envelope of log/stateser.py (FORMAT_DEVICE_V1), the layout the
    # JAX engine writes and reads, so state crosses between the engines
    _ALL_DEVICE_FAMILIES = (
        "ei", "job", "join", "keys", "msg", "msub", "sub", "timer",
    )

    def _mark_device_dirty(self, *families: str) -> None:
        """Record device-table mutations for delta snapshots; no args =
        every device family."""
        if self._dirty_device is None:
            return
        self._dirty_device.update(families or self._ALL_DEVICE_FAMILIES)

    def snapshot_dirty_families(self):
        host = self._host.snapshot_dirty_families()
        if self._dirty_device is None or host is None:
            return None
        return frozenset({"d/" + f for f in self._dirty_device} | set(host))

    def snapshot_mark_clean(self) -> None:
        self._dirty_device = set()
        self._host.snapshot_mark_clean()

    def snapshot_mark_dirty(self, families=None) -> None:
        if families is None:
            self._dirty_device = None
            self._host.snapshot_mark_dirty(None)
            return
        dev = [f[2:] for f in families if f.startswith("d/")]
        if dev:  # empty would mean mark-ALL in _mark_device_dirty's varargs
            self._mark_device_dirty(*dev)
        host = [f for f in families if f.startswith("h/")]
        if host:
            self._host.snapshot_mark_dirty(host)

    def snapshot_state(self, families=None) -> dict:
        from zeebe_tpu_torch.log import stateser

        dirty_dev = None
        if families is not None:
            dirty_dev = {f[2:] for f in families if f.startswith("d/")}
        arrays: Dict[str, Optional[np.ndarray]] = {}
        read: List[str] = []

        def put(name: str, value, skip: bool) -> None:
            if skip:
                arrays[name] = None  # clean family: previous segment reused
            else:
                arrays[name] = _np_copy(value)
                read.append(name)

        for name in state_mod.STATE_FIELDS:
            skip = (
                dirty_dev is not None
                and stateser.device_array_family(name) not in dirty_dev
            )
            v = getattr(self.state, name)
            if name in state_mod.MAP_FIELDS:
                put(name + ".keys", v.keys, skip)
                put(name + ".vals", v.vals, skip)
            else:
                put(name, v, skip)
        self.last_snapshot_readback = read
        return {
            "fmt": stateser.FORMAT_DEVICE_V1,
            "arrays": arrays,
            "meta": {
                # interned strings in id order (id 0 is reserved NIL)
                "interns": [s or "" for s in self.interns._by_id[1:]],
                "variables": (
                    list(self.meta.varspace.names) if self.meta else []
                ),
                "last_processed_position": self.last_processed_position,
            },
            "host": self._host.snapshot_state(),
        }

    def restore_state(self, snap: dict) -> None:
        from zeebe_tpu_torch.log import stateser
        from zeebe_tpu_torch.tpu import hashmap

        if snap.get("fmt") != stateser.FORMAT_DEVICE_V1:
            raise ValueError("not a device-engine snapshot")
        self._dirty_device = None  # restored engine: next take is full
        self._host.restore_state(snap["host"])
        meta = snap.get("meta", {})
        self.interns = InternTable()
        for s in meta.get("interns", []):
            self.interns.intern(s)
        # recompile through the deployment path with the snapshot's
        # variable-column order forced (column ids live in the payloads)
        self.meta = None
        self.graph = None
        if self.repository.by_key:
            # no store migration during restore: the snapshot's arrays
            # already carry the message store on whichever side the gate
            # computes (the gate is a pure function of the restored repo)
            self._restoring = True
            try:
                self._recompile(extra_variables=list(meta.get("variables", [])))
            finally:
                self._restoring = False
        arrays = snap["arrays"]
        dev = self.device

        def t(a):
            return torch.from_numpy(np.array(a)).to(dev)

        kwargs = {}
        older_snapshot = False
        for name in state_mod.STATE_FIELDS:
            if name + ".keys" in arrays:
                kwargs[name] = hashmap.HashTable(
                    keys=t(arrays[name + ".keys"]), vals=t(arrays[name + ".vals"])
                )
            elif name == "ei_i32" and arrays[name].shape[1] == 5:
                # snapshot without the pending-boundary column: pad it
                a = np.asarray(arrays[name])
                kwargs[name] = t(np.concatenate(
                    [a, np.full((a.shape[0], 1), -1, np.int32)], axis=1
                ))
                older_snapshot = True
            elif name in arrays:
                kwargs[name] = t(arrays[name])
            else:
                # a family the snapshot predates (the message tables): keep
                # the fresh empty table; its live state sits on the host
                # side of the snapshot and migrates below
                kwargs[name] = getattr(self.state, name)
                older_snapshot = True
        st = state_mod.EngineState(**kwargs)
        # job-worker subscriptions are transient client-session state: a
        # restored partition starts with an empty subscription table
        st.sub_key.fill_(-1)
        st.sub_credits.zero_()
        st.sub_valid.zero_()
        # derive the lookup structures from the restored rows
        st = state_mod.rebuild_lookup_state(st)
        if self._mesh is not None:
            # the restored capacity may differ from the constructor's: the
            # blocks and the step programs follow the restored shapes
            self._shard(st)
        else:
            self.state = st
        self._keys_at_rebuild = 0
        self.capacity = st.capacity
        self.num_vars = st.num_vars
        self.last_processed_position = int(
            meta.get("last_processed_position", -1)
        )
        if older_snapshot and self._messages_on_device:
            # the older snapshot's message store lives host-side but the
            # restored deployment computes a device store: migrate, so
            # publishes see the restored subscriptions
            self._migrate_message_store_to_device()

    def _job_value_from_slot(self, slot: int) -> JobRecord:
        s = self.state
        i32 = _np(s.job_i32[slot])
        i64 = _np(s.job_i64[slot])
        wf_slot = int(i32[state_mod.JB_WF])
        elem = int(i32[state_mod.JB_ELEM])
        workflow = (
            self.meta.workflows[wf_slot]
            if self.meta and 0 <= wf_slot < len(self.meta.workflows)
            else None
        )
        return JobRecord(
            type=self.interns.string(int(i32[state_mod.JB_TYPE])) or "",
            retries=int(i32[state_mod.JB_RETRIES]),
            deadline=int(i64[state_mod.JBL_DEADLINE]),
            worker=self.interns.string(int(i32[state_mod.JB_WORKER])) or "",
            payload=rb.columns_to_payload(
                *_host_unpack_payload(_np_copy(s.job_pay[slot])),
                self.meta.varspace.names if self.meta else [],
                self.interns,
            ),
            headers=JobHeaders(
                workflow_instance_key=int(i64[state_mod.JBL_IKEY]),
                bpmn_process_id=workflow.id if workflow else "",
                workflow_definition_version=workflow.version if workflow else -1,
                workflow_key=workflow.key if workflow else -1,
                activity_id=self.meta.element_id(wf_slot, elem) if self.meta else "",
                activity_instance_key=int(i64[state_mod.JBL_AIK]),
            ),
        )

    # ------------------------------------------------------------------
    # batch processing
    # ------------------------------------------------------------------
    def process(self, record: Record) -> ProcessingResult:
        """Single-record convenience (replay and tests)."""
        return self.process_batch([record])

    def process_batch(self, records: List[Record]) -> ProcessingResult:
        """Synchronous wave: dispatch + collect, merged record-major."""
        return ProcessingResult.merged(self.process_wave(records))

    def process_wave(self, records: List[Record]) -> List[ProcessingResult]:
        """Per-record results of one wave (one device dispatch per
        contiguous device segment)."""
        return self.collect_wave(self.dispatch_wave(records))

    def dispatch_wave(self, records) -> PendingWave:
        """Stage + launch a wave WITHOUT reading device outputs back.
        Host-routed records process inline (strict log order); device
        segments dispatch through the kernel and stay pending until
        ``collect_wave``.

        ``records`` may be a plain list of ``Record`` objects or a lazy
        columnar view (``RecordsView``). A lazy entry that is a device
        EVENT of a device-resident instance stages straight from the
        emission batch's columns — no ``Record`` materializes for it."""
        t0 = time.perf_counter()
        view = records if hasattr(records, "entries") else None
        entries = list(view.entries()) if view is not None else records
        n = len(entries)
        if view is not None:
            col_vts = view.value_types()
            col_rts = view.record_types()
            col_its = view.intents()
            col_pos = view.positions()
            col_keys = view.keys()
        else:
            col_vts = None
            col_rts = col_its = col_pos = col_keys = None

        per_record: List[Optional[ProcessingResult]] = [None] * n
        wave = PendingWave(
            records=records, per_record=per_record,
            partition_id=self.partition_id,
        )
        positions = wave.positions
        # device rows batch up; a host-routed record dispatches the
        # pending device segment first, so state mutates in log order
        pending: List[int] = []
        # resident routing: the pending segment holds ONE route class —
        # ("create",) all-CREATE, ("ik", shard) proven resident, ("fb",)
        # unknown — and a record of another class flushes it first (the
        # routed step needs single-owner waves). None when routing is off
        pending_route: List = [None]
        # the two engines allocate from ONE keyspace; their counters sync
        # at segment boundaries (device→host: one read when a device
        # segment ran since the last pull; host→device: device-side max)
        host_allocated = [False]

        def push_host_keys() -> None:
            if not host_allocated[0]:
                return
            self._mark_device_dirty("keys")
            for t in self._replicas("next_wf_key"):
                t.clamp_(min=self._host.wf_keys.peek)
            for t in self._replicas("next_job_key"):
                t.clamp_(min=self._host.job_keys.peek)
            host_allocated[0] = False

        def seg_meta(i: int):
            if col_vts is not None:
                return col_vts[i], col_rts[i], col_its[i]
            md = entries[i].metadata
            return (
                int(md.value_type), int(md.record_type), int(md.intent),
            )

        def flush() -> None:
            if not pending:
                return
            push_host_keys()  # device allocations continue after the host's
            seg = self._dispatch_device(
                [entries[i] for i in pending],
                [positions[i] for i in pending],
                [seg_meta(i) for i in pending],
                route=pending_route[0],
            )
            seg.rows = list(pending)
            wave.segments.append(seg)
            self.device_records_processed += len(pending)
            pending.clear()
            self._device_keys_dirty = True

        for i in range(n):
            entry = entries[i]
            lazy = type(entry) is tuple
            if col_vts is not None:
                vt, rt, intent = col_vts[i], col_rts[i], col_its[i]
                pos, key = col_pos[i], col_keys[i]
            else:
                md = entry.metadata
                vt = int(md.value_type)
                rt = int(md.record_type)
                intent = int(md.intent)
                pos, key = entry.position, entry.key
            positions.append(pos)
            if (
                self._job_records_in_flight
                and vt == int(ValueType.JOB)
                and (rt, intent) in _ACTIVATION_DECIDING
            ):
                self._note_job_records(key, -1)
            device_vt = vt in _DEVICE_VALUE_TYPES or (
                vt in _MESSAGE_VALUE_TYPES
                and self.graph is not None
                and self.graph.has_messages
            )
            eligible = (
                device_vt and self.meta is not None and self.graph is not None
            )
            if lazy and eligible and self._lazy_device_row(
                entry, vt, rt, intent, key
            ):
                rc = self._wave_route_class(entry, True, vt, rt, intent)
                if pending and rc != pending_route[0]:
                    flush()
                pending_route[0] = rc
                pending.append(i)
                continue
            if lazy:
                record = entry[0].row(entry[1])
                entries[i] = record
            else:
                record = entry
            # records_by_position aliases the host oracle's cache
            self.records_by_position[pos] = record
            md = record.metadata
            if eligible and not self._routes_to_host(record):
                # payload numbers must be exactly representable in float32
                # (device payload columns are f32): commands violating it
                # are REJECTED at the boundary
                bad = self._inexact_payload_value(record)
                if bad is not None:
                    per_record[i] = self._reject_payload(record, bad)
                    continue
                rc = self._wave_route_class(record, False, vt, rt, intent)
                if pending and rc != pending_route[0]:
                    flush()
                pending_route[0] = rc
                pending.append(i)
            else:
                flush()  # earlier device rows execute BEFORE this record
                if self._device_keys_dirty:
                    self._pull_device_keys_into_host()
                    self._device_keys_dirty = False
                wf_peek = self._host.wf_keys.peek
                job_peek = self._host.job_keys.peek
                if (
                    vt == int(ValueType.WORKFLOW_INSTANCE)
                    and int(md.record_type) == int(RecordType.COMMAND)
                ):
                    # rare imperative ops demote their live device instance
                    if int(md.intent) == int(WI.CANCEL):
                        self._demote_instance(record.key)
                    elif int(md.intent) == int(WI.UPDATE_PAYLOAD):
                        self._demote_instance(
                            record.value.workflow_instance_key
                        )
                elif (
                    vt == int(ValueType.JOB)
                    and int(md.record_type) == int(RecordType.COMMAND)
                    and self._nonscalar_payload(record)
                ):
                    # a non-columnar job result drags the owning instance
                    # to the host path before the command applies
                    owner = record.value.headers.workflow_instance_key
                    if owner < 0 and record.key >= 0:
                        slots = np.nonzero(
                            _np(self.state.job_key) == record.key
                        )[0]
                        if len(slots):
                            owner = int(
                                _np(self.state.job_instance_key)[int(slots[0])]
                            )
                    self._demote_instance(owner)
                deployed_before = len(self.repository.by_key)
                self.host_records_processed += 1
                try:
                    per_record[i] = self._host.process(record)
                except Exception as e:  # noqa: BLE001 - poison isolation
                    self._host.processing_failures.append(
                        (record.position, repr(e)[:300])
                    )
                else:
                    for out in per_record[i].written:
                        md = out.metadata
                        if int(md.value_type) == int(ValueType.JOB) and (
                            int(md.record_type), int(md.intent)
                        ) in _ACTIVATION_DECIDING:
                            self._note_job_records(out.key, 1)
                if len(self.repository.by_key) != deployed_before:
                    self._recompile()
                if (
                    self._host.wf_keys.peek != wf_peek
                    or self._host.job_keys.peek != job_peek
                ):
                    host_allocated[0] = True
        flush()
        push_host_keys()
        if positions:
            self.last_processed_position = positions[-1]
        wave.host_seconds += time.perf_counter() - t0
        return wave

    def _lazy_device_row(self, entry, vt, rt, intent, key) -> bool:
        """True when a LAZY tail ref (``(batch, idx)``) can enter a device
        segment straight from its backing readback columns. Conservative:
        anything not provably device-resident from columns alone
        materializes and takes the per-record path."""
        if rt != int(RecordType.EVENT):
            return False
        ref = entry[0].device_ref(entry[1])
        if ref is None:
            return False
        src, j = ref
        _o, scols, epoch = src.device_source
        if epoch != self._meta_epoch or self.meta is None:
            return False
        if vt == int(ValueType.JOB):
            if intent in (
                int(JI.FAILED), int(JI.RETRIES_UPDATED), int(JI.CANCELED)
            ):
                # host-side job-incident bookkeeping reads these records
                return False
        elif vt != int(ValueType.WORKFLOW_INSTANCE):
            return False
        wf_slot = scols["wf"][j]
        workflow = (
            self.meta.workflows[wf_slot]
            if 0 <= wf_slot < len(self.meta.workflows) else None
        )
        if workflow is not None and workflow.key in self._host_only_keys:
            return False
        instances = self._host.element_instances.instances
        if scols["instance_key"][j] in instances:
            return False
        if vt == int(ValueType.JOB):
            return key not in self._host.jobs
        return key not in instances

    # -- resident routing policy -------------------------------------------
    @property
    def _resident_mode(self) -> bool:
        return self.routing == "resident" and self._mesh is not None

    def _routing_active(self) -> bool:
        """Resident routing applies per wave: a message-correlation graph
        probes subscription tables across the whole key space, which the
        single-owner contract cannot cover, so such a partition runs every
        wave through the gathered fallback."""
        return (
            self._resident_mode
            and self.graph is not None
            and not self.graph.has_messages
        )

    def _instance_key_of(self, entry, lazy: bool, vt: int):
        """The workflow instance key a device record belongs to (the root
        key every row of the instance's scope tree shares: the residency
        map's key), None when the entry does not show it."""
        if lazy:
            ref = entry[0].device_ref(entry[1])
            if ref is None:
                return None
            src, j = ref
            _o, scols, _epoch = src.device_source
            return int(scols["instance_key"][j])
        value = getattr(entry, "value", None)
        if value is None:
            return None
        if vt == int(ValueType.JOB):
            ik = getattr(getattr(value, "headers", None), "workflow_instance_key", None)
        else:
            ik = getattr(value, "workflow_instance_key", None)
        return int(ik) if ik is not None else None

    def _wave_route_class(self, entry, lazy: bool, vt, rt, intent):
        """Route class of one device record: ``("create",)`` (a WI CREATE
        command: its root key is the counter's next value, so the whole
        instance is born in one predictable block), ``("ik", shard)`` (an
        instance proven resident in a block), ``("fb",)`` (unknown: the
        gathered fallback). None when routing is off."""
        if not self._routing_active():
            return None
        if (
            vt == int(ValueType.WORKFLOW_INSTANCE)
            and rt == int(RecordType.COMMAND)
            and intent == int(WI.CREATE)
        ):
            return ("create",)
        ik = self._instance_key_of(entry, lazy, vt)
        if ik is None or ik < 0:
            return ("fb",)
        if self._blind_fb_inflight:
            # an uncollected fallback stepped rows of instances the host
            # could not name, perhaps this one, and may have put its rows
            # outside its home block: no residency entry is trusted until
            # those emissions are read (CREATEs stay routable: fresh keys)
            return ("fb",)
        owner = self._resident.get(int(ik))
        return ("ik", owner) if owner is not None else ("fb",)

    def _routed_lane_cap(self) -> int:
        """The most rows a routed wave may carry: the lane size, and the
        shard's direct-mapped index window (rows born in a wave resolve
        through the block's index until the next rebuild, which is
        collision-free only across a window of local-capacity consecutive
        keys; the safety factor 4 of ``_keys_at_rebuild``)."""
        fanout = max(1, self.graph.emit_width if self.graph is not None else 1)
        window = (self._index_rows() // self._state_shards) // (4 * fanout)
        return max(1, min(self._routed_lane_slots, window))

    def _pop_residency_fallback(self, o, seq: int) -> None:
        """Retire the residency of every instance a collected FALLBACK
        segment's emissions name: the gathered step allocates at global
        free slots, so each may now own rows outside its home block."""
        ik = np.asarray(o["instance_key"])
        valid = np.asarray(o["valid"], bool)
        for k in np.unique(ik[valid & (ik >= 0)]).tolist():
            self._resident.pop(int(k), None)
            self._residency_invalid[int(k)] = seq

    def _note_residency(self, o, owner: int, seq: int) -> None:
        """Learn residency from a collected ROUTED segment's emissions: every
        instance the wave touched has all its rows in ``owner``'s block, and
        instances whose root completed or terminated leave the map. A key
        invalidated by a later-dispatched fallback or demotion (``seq``
        order) is not noted back in."""
        ik = np.asarray(o["instance_key"])
        live = np.asarray(o["valid"], bool) & (ik >= 0)
        inv = self._residency_invalid
        for k in np.unique(ik[live]).tolist():
            if inv.get(int(k), -1) >= seq:
                continue
            self._resident[int(k)] = owner
        vt = np.asarray(o["vtype"])
        it = np.asarray(o["intent"])
        key = np.asarray(o["key"])
        done = (
            live
            & (vt == int(ValueType.WORKFLOW_INSTANCE))
            & (key == ik)
            & ((it == int(WI.ELEMENT_COMPLETED)) | (it == int(WI.ELEMENT_TERMINATED)))
        )
        for k in np.unique(ik[done]).tolist():
            self._resident.pop(int(k), None)

    def collect_wave(self, wave: PendingWave) -> List[ProcessingResult]:
        """Materialize a dispatched wave: one bulk device fetch per
        segment, columnar emission decode, per-record source stamping."""
        from zeebe_tpu_torch.protocol.records import stamp_source_positions

        if wave.collected is not None:  # collection is one-shot
            return wave.collected
        t0 = time.perf_counter()
        device_s = 0.0
        for seg in wave.segments:
            device_s += self._collect_device(seg)
            for i, res in zip(seg.rows, seg.results):
                wave.per_record[i] = res
        results: List[ProcessingResult] = []
        for pos, res in zip(wave.positions, wave.per_record):
            if res is None:  # poisoned host record: contained, no output
                res = ProcessingResult()
            stamp_source_positions(res.written, pos)
            results.append(res)
        wave.device_seconds += device_s
        wave.host_seconds += (time.perf_counter() - t0) - device_s
        self.last_wave_seconds = (wave.host_seconds, wave.device_seconds)
        wave.collected = results
        return results

    def _pull_device_keys_into_host(self) -> None:
        """Advance the embedded oracle's key generators past the device
        counters (one device→host read; only at device-segment → host-record
        boundaries)."""
        from zeebe_tpu_torch.engine import keyspace

        dev_wf, dev_job = torch.stack(
            [self._replicas("next_wf_key")[0], self._replicas("next_job_key")[0]]
        ).tolist()
        if self._host.wf_keys.peek < dev_wf or self._host.job_keys.peek < dev_job:
            self._host.snapshot_mark_dirty(("h/control",))
        if self._host.wf_keys.peek < dev_wf:
            self._host.wf_keys.set_key(dev_wf - keyspace.STEP_SIZE)
        if self._host.job_keys.peek < dev_job:
            self._host.job_keys.set_key(dev_job - keyspace.STEP_SIZE)

    @staticmethod
    def _nonscalar_payload(record: Record) -> bool:
        """True when the record payload holds values with no device column
        form (lists/nested documents) — such records take the host path."""
        payload = getattr(record.value, "payload", None)
        if not payload:
            return False
        return any(
            not isinstance(v, (type(None), bool, int, float, str))
            for v in payload.values()
        )

    def _inexact_payload_value(self, record: Record):
        """Name of the first payload entry not exactly representable in
        f32 on a COMMAND record, else None."""
        from zeebe_tpu_torch.tpu.conditions import f32_exact

        if int(record.metadata.record_type) != int(RecordType.COMMAND):
            return None
        payload = getattr(record.value, "payload", None)
        if not payload:
            return None
        for name, value in payload.items():
            if (
                isinstance(value, (int, float))
                and not isinstance(value, bool)
                and not f32_exact(value)
            ):
                return name
        return None

    def _reject_payload(self, record: Record, field: str) -> ProcessingResult:
        out = ProcessingResult()
        md = record.metadata
        rejection = Record(
            key=record.key,
            value=record.value.copy(),
            metadata=RecordMetadata(
                record_type=RecordType.COMMAND_REJECTION,
                value_type=md.value_type,
                intent=md.intent,
                rejection_type=RejectionType.BAD_VALUE,
                rejection_reason=(
                    f"payload value {field!r} is not exactly representable "
                    "in float32 (TPU partition payload contract)"
                ),
                request_id=md.request_id,
                request_stream_id=md.request_stream_id,
            ),
            source_record_position=record.position,
        )
        out.written.append(rejection)
        if md.request_id >= 0:
            out.responses.append(rejection)
        return out

    # -- host record → batch row -------------------------------------------
    # dtype families for the packed host→device transfer: one copy per
    # family (plus the three payload matrices) instead of one per column
    _I64_COLS = ("key", "instance_key", "scope_key", "req", "aux_key",
                 "aux2_key", "deadline")
    _I32_COLS = ("rtype", "vtype", "intent", "elem", "wf", "req_stream",
                 "type_id", "retries", "worker", "src", "rej")
    _BOOL_COLS = ("valid", "resp", "push")
    _COL_DEFAULTS = {
        "valid": False, "rtype": 0, "vtype": 0, "intent": 0, "key": -1,
        "elem": -1, "wf": -1, "instance_key": -1, "scope_key": -1,
        "req": -1, "req_stream": -1, "aux_key": -1, "aux2_key": -1,
        "type_id": 0, "retries": 0, "deadline": -1, "worker": 0,
        "src": -1, "resp": False, "push": False, "rej": 0,
    }

    def _stage(self, records: List[Record], lane_owner=None) -> RecordBatch:
        # pow2 buckets (at least 64 rows), as the JAX engine stages off-TPU:
        # the staged size decides nothing in the log, but keeps the shapes
        # the JAX engine steps
        size = _pow2(len(records))
        v = self.num_vars
        cols: Dict[str, object] = {
            name: [default] * size
            for name, default in self._COL_DEFAULTS.items()
        }
        cols["v_vt"] = np.zeros((size, v), np.int8)
        cols["v_num"] = np.zeros((size, v), np.float32)
        cols["v_str"] = np.zeros((size, v), np.int32)
        staged_lazy = 0
        for i, record in enumerate(records):
            if type(record) is tuple:
                src, j = record[0].device_ref(record[1])
                self._stage_from_emission(cols, i, src, j)
                staged_lazy += 1
            else:
                self._stage_row(cols, i, record)
        if staged_lazy:
            _count_staged_columnar(staged_lazy)
        return self._pack_batch(cols, size, lane_owner)

    def _stage_from_emission(self, cols, i, src, j) -> None:
        """Stage one row by COPYING the backing emission batch's columns
        (only those ``_stage_row`` would set for the value type)."""
        o, s, _epoch = src.device_source
        vt = s["vtype"][j]
        cols["valid"][i] = True
        cols["rtype"][i] = s["rtype"][j]
        cols["vtype"][i] = vt
        cols["intent"][i] = s["intent"][j]
        cols["key"][i] = s["key"][j]
        cols["req"][i] = s["req"][j]
        cols["req_stream"][i] = s["req_stream"][j]
        wf = s["wf"][j]
        if vt == int(ValueType.WORKFLOW_INSTANCE):
            cols["wf"][i] = wf
            cols["elem"][i] = s["elem"][j] if wf >= 0 else -1
            cols["instance_key"][i] = s["instance_key"][j]
            cols["scope_key"][i] = s["scope_key"][j]
        elif vt == int(ValueType.JOB):
            cols["type_id"][i] = s["type_id"][j]
            cols["retries"][i] = s["retries"][j]
            cols["deadline"][i] = s["deadline"][j]
            cols["worker"][i] = s["worker"][j]
            cols["aux_key"][i] = s["aux_key"][j]
            cols["instance_key"][i] = s["instance_key"][j]
            cols["wf"][i] = wf
            cols["elem"][i] = s["elem"][j] if wf >= 0 else -1
        # payload columns copy MASKED by the type column (unset lanes must
        # not carry junk)
        vt_row = o["v_vt"][j]
        mask = vt_row != 0
        cols["v_vt"][i] = vt_row
        cols["v_num"][i] = np.where(mask, o["v_num"][j], 0)
        cols["v_str"][i] = np.where(mask, o["v_str"][j], 0)

    def _pack_batch(self, cols: Dict[str, object], size: int, lane_owner=None) -> RecordBatch:
        """Scalar columns → one [columns, rows] matrix per dtype family →
        one host→device copy each; each batch column is a contiguous row of
        its family's matrix. A routed wave (``lane_owner``) goes to its
        owner shard's device, every other wave to the engine's device."""
        dev = self.device
        if self._mesh is not None:
            # the staged row split by owning shard (instance key in resident
            # mode, the key hash otherwise) and the valid count, which
            # _run_step records with the wave's exchange volume
            basis = cols["instance_key"] if self._resident_mode else cols["key"]
            self._last_stage_split = shard_mod.shard_row_counts_host(
                basis, cols["valid"], self._state_shards
            )
            self._last_stage_valid = int(np.count_nonzero(np.asarray(cols["valid"], bool)))
            if lane_owner is not None:
                dev = self._mesh.devices[lane_owner]
        kw: Dict[str, torch.Tensor] = {}
        for names, dtype in (
            (self._I64_COLS, np.int64),
            (self._I32_COLS, np.int32),
            (self._BOOL_COLS, bool),
        ):
            mat = np.empty((len(names), size), dtype)
            for j, name in enumerate(names):
                mat[j] = cols[name]
            on_dev = torch.from_numpy(mat).to(dev)
            for j, name in enumerate(names):
                kw[name] = on_dev[j]
        for name in ("v_vt", "v_num", "v_str"):
            kw[name] = torch.from_numpy(cols[name]).to(dev)
        return RecordBatch(**kw)

    def warm(self) -> None:
        """Step one empty wave before the partition serves, so every kernel
        library is built and launched once at install time: a first build
        inside the first served batch would hold the broker actor while
        client requests wait. A library is built once for every shape, so
        one wave of the smallest staged size does. A wave with no valid row
        changes no table. With nothing deployed the wave steps an empty
        graph."""
        if self.graph is None:
            self._recompile()
        graph = self.graph
        if graph is None:
            graph, _meta = graph_mod.compile_graph(
                [], interns=InternTable(), device=self.device
            )
        now = int(self.clock())
        self._run_step(self._stage([]), now, graph=graph)
        if self._resident_mode:
            # resident mode serves through two programs: the fallback just
            # warmed, and the routed one
            self._run_step(self._stage([], lane_owner=0), now, lane_owner=0, graph=graph)
        for dev in dict.fromkeys(self._mesh.devices if self._mesh else [self.device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _run_step(self, batch: RecordBatch, now: int, lane_owner=None, graph=None) -> tuple:
        """Launch ONE wave through the active step: the routed step
        (``lane_owner``) or the fallback in resident mode, the gathered
        step in sharded mode, ``kernel.step_kernel`` otherwise. Rebinds the
        state and returns ``(out, stats)``; every one writes the same
        log."""
        graph = self.graph if graph is None else graph
        pid = self.partition_id
        if self._resident_mode:
            if lane_owner is not None:
                self._shards, out, stats = self._state_step_routed(
                    graph, self._shards, batch, lane_owner, now, pid
                )
            else:
                self._shards, out, stats = self._state_step_fallback(
                    graph, self._shards, batch, now, pid
                )
        elif self._state_step is not None:
            self._shards, out, stats = self._state_step(graph, self._shards, batch, now, pid)
        else:
            self.state, out, stats = kernel.step_kernel(
                graph, self.state, batch, now, partition_id=pid
            )
        if self._mesh is not None:
            from zeebe_tpu_torch.runtime import metrics as metrics_mod

            n_valid = self._last_stage_valid
            # the exchange model per kind of wave, and none for a wave of no
            # records (a warm step)
            if not n_valid:
                xb = 0
            elif self._resident_mode and lane_owner is not None:
                xb = shard_mod.routed_exchange_bytes(out, self._state_shards)
            elif self._resident_mode:
                xb = self._fallback_exchange_bytes
            else:
                xb = self._shard_exchange_bytes
            split = self._last_stage_split
            single_lane = self._resident_mode and lane_owner is not None
            if single_lane:
                split = np.zeros(self._state_shards, np.int64)
                split[int(lane_owner)] = n_valid
            metrics_mod.observe_sharded_wave(split, xb, single_lane=single_lane)
            self.sharded_waves += 1
            self.last_shard_fill = tuple(int(x) for x in split)
            if self._resident_mode and n_valid:
                if lane_owner is not None:
                    self.routed_waves += 1
                else:
                    self.fallback_waves += 1
        return out, stats

    def _stage_row(self, cols, i, record: Record) -> None:
        md = record.metadata
        vt = int(md.value_type)
        cols["valid"][i] = True
        cols["rtype"][i] = int(md.record_type)
        cols["vtype"][i] = vt
        cols["intent"][i] = int(md.intent)
        cols["key"][i] = record.key
        cols["req"][i] = md.request_id
        cols["req_stream"][i] = md.request_stream_id
        value = record.value
        if vt == int(ValueType.WORKFLOW_INSTANCE):
            wf_slot = self.meta.slot(value.workflow_key)
            if (
                int(md.record_type) == int(RecordType.COMMAND)
                and int(md.intent) == int(WI.CREATE)
            ):
                workflow = self._resolve_workflow(value)
                wf_slot = self.meta.slot(workflow.key) if workflow else -1
            cols["wf"][i] = wf_slot
            if wf_slot >= 0 and value.activity_id:
                cols["elem"][i] = self.meta.elem_idx[wf_slot].get(
                    value.activity_id, -1
                )
            cols["instance_key"][i] = value.workflow_instance_key
            cols["scope_key"][i] = value.scope_instance_key
            self._stage_payload(cols, i, value.payload)
        elif vt == int(ValueType.JOB):
            cols["type_id"][i] = self.interns.intern(value.type) if value.type else 0
            cols["retries"][i] = value.retries
            cols["deadline"][i] = value.deadline
            cols["worker"][i] = (
                self.interns.intern(value.worker) if value.worker else 0
            )
            headers = value.headers
            cols["aux_key"][i] = headers.activity_instance_key
            cols["instance_key"][i] = headers.workflow_instance_key
            wf_slot = self.meta.slot(headers.workflow_key)
            cols["wf"][i] = wf_slot
            if wf_slot >= 0 and headers.activity_id:
                cols["elem"][i] = self.meta.elem_idx[wf_slot].get(
                    headers.activity_id, -1
                )
            self._stage_payload(cols, i, value.payload)
        elif vt == int(ValueType.TIMER):
            cols["aux_key"][i] = value.activity_instance_key
            cols["instance_key"][i] = value.workflow_instance_key
            cols["deadline"][i] = value.due_date
            if value.handler_element_id and self.meta is not None:
                wf_slot = self._wf_slot_of_instance(
                    value.activity_instance_key
                )
                if wf_slot >= 0:
                    cols["wf"][i] = wf_slot
                    cols["elem"][i] = self.meta.elem_idx[wf_slot].get(
                        value.handler_element_id, -1
                    )
        elif vt == int(ValueType.MESSAGE):
            self._stage_corr(cols, i, value.name, value.correlation_key)
            cols["deadline"][i] = value.time_to_live
            cols["aux2_key"][i] = (
                self.interns.intern(value.message_id) if value.message_id else 0
            )
            self._stage_payload(cols, i, value.payload)
        elif vt == int(ValueType.MESSAGE_SUBSCRIPTION):
            self._stage_corr(cols, i, value.message_name, value.correlation_key)
            cols["wf"][i] = value.workflow_instance_partition_id
            cols["instance_key"][i] = value.workflow_instance_key
            cols["aux_key"][i] = value.activity_instance_key
        elif vt == int(ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION):
            self._stage_corr(cols, i, value.message_name, value.correlation_key)
            cols["wf"][i] = value.message_partition_id
            cols["aux2_key"][i] = value.message_partition_id
            cols["instance_key"][i] = value.workflow_instance_key
            cols["aux_key"][i] = value.activity_instance_key
            self._stage_payload(cols, i, value.payload)

    def _stage_corr(self, cols, i, name: str, correlation_key) -> None:
        """Message-family correlation columns: type_id = interned name,
        retries = correlation value type, worker = correlation bits (a
        number's, a bool's, as the f32 bit pattern)."""
        from zeebe_tpu_torch.tpu.conditions import VT_NUM, VT_STR

        cols["type_id"][i] = self.interns.intern(name) if name else 0
        if isinstance(correlation_key, str) and correlation_key:
            cols["retries"][i] = int(VT_STR)
            cols["worker"][i] = self.interns.intern(correlation_key)
        elif isinstance(correlation_key, (int, float)):
            cols["retries"][i] = int(VT_NUM)
            cols["worker"][i] = int(np.float32(float(correlation_key)).view(np.int32))

    def _wf_slot_of_instance(self, key: int) -> int:
        """Workflow slot of a live device element instance (host-side scan;
        timer records are rare control records)."""
        if key < 0:
            return -1
        keys = _np(self.state.ei_i64[:, 0])
        hits = np.nonzero(keys == key)[0]
        if not len(hits):
            return -1
        return int(self.state.ei_i32[int(hits[0]), state_mod.EI_WF])

    def _stage_payload(self, cols, i, payload) -> None:
        if not payload:
            return
        try:
            vt, num, sid = rb.payload_to_columns(
                payload, self._var_column, self.interns, self.num_vars
            )
        except rb.PayloadError:
            if int(cols["rtype"][i]) == int(RecordType.COMMAND_REJECTION):
                # a rejection echoes the offending command's payload; it is
                # terminal for the kernel, so it stages with none
                return
            raise
        cols["v_vt"][i] = vt
        cols["v_num"][i] = num
        cols["v_str"][i] = sid

    def _resolve_workflow(self, value: WorkflowInstanceRecord):
        if value.workflow_key > 0:
            return self.repository.by_key.get(value.workflow_key)
        if value.version > 0:
            return self.repository.by_id_and_version(
                value.bpmn_process_id, value.version
            )
        return self.repository.latest(value.bpmn_process_id)

    # -- device round -------------------------------------------------------
    def _dispatch_device(
        self, records: List, positions: List[int], metas: List[tuple], route=None,
    ) -> _PendingSegment:
        """Host pre-work + staging + kernel launch for one device segment;
        returns the pending segment WITHOUT synchronizing on the device.
        ``records`` entries may be lazy ``(batch, idx)`` refs; ``metas``
        carries each entry's ``(value_type, record_type, intent)``."""
        results = [ProcessingResult() for _ in records]
        # job-incident bookkeeping lives in the host engine: run the
        # oracle's _incident_on_job_event for the JOB events flowing through
        # the device; for FAILED-with-no-retries the HOST emits the
        # follow-up and the kernel's own incident CREATE is suppressed
        suppress_incident_create: set = set()
        for i, (vt, rt, intent) in enumerate(metas):
            if vt != int(ValueType.JOB) or rt != int(RecordType.EVENT):
                continue
            if intent == int(JI.FAILED):
                record = _as_record(records[i])
                if record.value.retries <= 0:
                    self._host.snapshot_mark_dirty(
                        ("h/incidents", "h/control")
                    )
                    self._host._incident_on_job_event(record, results[i])
                    suppress_incident_create.add(i)
            elif intent in (int(JI.RETRIES_UPDATED), int(JI.CANCELED)):
                record = _as_record(records[i])
                self._host.snapshot_mark_dirty(("h/incidents", "h/control"))
                self._host._incident_on_job_event(record, results[i])
        # CREATE commands with unknown workflows are rejected host-side
        rejected = set()
        for i, (vt, rt, intent) in enumerate(metas):
            if (
                vt == int(ValueType.WORKFLOW_INSTANCE)
                and rt == int(RecordType.COMMAND)
                and intent == int(WI.CREATE)
            ):
                record = _as_record(records[i])
                if self._resolve_workflow(record.value) is None:
                    md = record.metadata
                    value = record.value.copy()
                    value.workflow_instance_key = self._next_wf_key_host()
                    rejection = Record(
                        key=record.key,
                        source_record_position=record.position,
                        metadata=RecordMetadata(
                            record_type=RecordType.COMMAND_REJECTION,
                            value_type=ValueType.WORKFLOW_INSTANCE,
                            intent=int(WI.CREATE),
                            rejection_type=RejectionType.BAD_VALUE,
                            rejection_reason="Workflow is not deployed",
                            request_id=md.request_id,
                            request_stream_id=md.request_stream_id,
                        ),
                        value=value,
                    )
                    results[i].written.append(rejection)
                    results[i].responses.append(rejection)
                    rejected.add(i)

        seg = _PendingSegment(
            results=results,
            positions=positions,
            live=[i for i in range(len(records)) if i not in rejected],
            suppress=suppress_incident_create,
        )
        live = seg.live
        if not live:
            return seg
        seg.seq = self._dispatch_seq
        self._dispatch_seq += 1
        lane_owner = None
        if self._routing_active():
            if route is not None and route[0] == "ik":
                lane_owner = route[1]
            elif route is not None and route[0] == "create":
                # all-CREATE segment: the first live CREATE takes the NEXT
                # counter value as its root key, and every allocation of the
                # segment lands in that key's owner block. One scalar read
                key0 = int(self._replicas("next_wf_key")[0])
                lane_owner = int(shard_mod.shard_of_key_host(key0, self._state_shards))
            if lane_owner is not None and len(live) > self._routed_lane_cap():
                lane_owner = None
                self.routed_overflows += 1
            if lane_owner is None:
                # the gathered fallback allocates at GLOBAL free slots: the
                # instances it steps are no longer proven block-resident.
                # Keys the host can name pop now; rows whose key it cannot
                # name resolve at collect, from the emissions (seg.fb_pop),
                # and routing holds off until then (seg.blind). CREATE rows
                # are exempt: their keys are fresh
                seg.fb_pop = True
                for i in live:
                    vt_i, rt_i, it_i = metas[i]
                    ik = self._instance_key_of(records[i], type(records[i]) is tuple, vt_i)
                    if ik is not None and ik >= 0:
                        self._resident.pop(int(ik), None)
                        self._residency_invalid[int(ik)] = seg.seq
                    elif not (
                        vt_i == int(ValueType.WORKFLOW_INSTANCE)
                        and rt_i == int(RecordType.COMMAND)
                        and it_i == int(WI.CREATE)
                    ):
                        seg.blind = True
                if seg.blind:
                    self._blind_fb_inflight += 1
        seg.route_owner = lane_owner
        batch = self._stage([records[i] for i in live], lane_owner=lane_owner)
        now = int(self.clock())
        # re-derive the fallback maps before the key window can wrap past
        # the direct-mapped index capacity (see rebuild_lookup_state): a
        # conservative host-side bound, so the serving path pays no sync.
        # Resident mode rebuilds them in both of its steps, every wave
        if not self._resident_mode:
            fanout = max(1, self.graph.emit_width if self.graph is not None else 1)
            self._keys_at_rebuild += 5 * fanout * len(live)
            if self._keys_at_rebuild > self._index_rows() // 4:
                self.state = state_mod.rebuild_lookup_state(self.state)
                self._keys_at_rebuild = 0
        self._mark_device_dirty()  # a kernel step may write any table
        out, stats = self._run_step(batch, now, lane_owner=lane_owner)
        seg.out = out
        seg.stats = stats
        return seg

    def _collect_device(self, seg: _PendingSegment) -> float:
        """Synchronize on one dispatched segment: the overflow flag and the
        emission count in one read, then one fetch of the emitted rows,
        then columnar decode into the segment's per-record results. Returns
        the seconds spent blocked on the device."""
        if seg.out is None:
            return 0.0
        t0 = time.perf_counter()
        overflow, count = torch.stack(
            [seg.stats["overflow"].to(torch.int64),
             seg.stats["emitted"].to(torch.int64)]
        ).tolist()
        if overflow:
            raise RuntimeError(
                "device table overflow — raise CudaPartitionEngine capacity"
            )
        o = {
            name: _np(getattr(seg.out, name)[:count]) for name in rb.FIELDS
        }
        deciding = (o["vtype"] == int(ValueType.JOB)) & np.isin(
            o["rtype"].astype(np.int64) * 256 + o["intent"], _ACTIVATION_DECIDING_CODES
        )
        for key in o["key"][deciding].tolist():
            self._note_job_records(key, 1)
        # collection is one-shot: clear the device refs BEFORE decoding
        seg.out = None
        seg.stats = None
        waited = time.perf_counter() - t0
        if seg.route_owner is not None:
            self._note_residency(o, seg.route_owner, seg.seq)
        elif seg.fb_pop:
            self._pop_residency_fallback(o, seg.seq)
            if seg.blind:
                self._blind_fb_inflight -= 1
        if self._residency_invalid:
            # collects run in dispatch order: an invalidation at or before
            # this seq can no longer hold back a later note
            self._residency_invalid = {
                k: q for k, q in self._residency_invalid.items() if q > seg.seq
            }
        self._emit_records(
            o, [seg.positions[i] for i in seg.live], seg.results, seg.live,
            seg.suppress,
        )
        return waited

    def _next_wf_key_host(self) -> int:
        """Allocate a workflow key host-side, keeping the device counter in
        sync (rejections consume a key in the oracle too)."""
        counters = self._replicas("next_wf_key")
        key = int(counters[0])
        self._mark_device_dirty("keys")
        for t in counters:
            t += 5
        return key

    # -- emission → host records -------------------------------------------
    def _emit_records(
        self,
        o: Dict[str, np.ndarray],
        src_positions: List[int],
        results: List[ProcessingResult],
        live_rows: List[int],
        suppress_incident_create: "set | None" = None,
    ) -> None:
        """Decode one emission batch (``o``: the emitted rows' columns as
        numpy arrays) into records. Scalar columns convert to Python lists
        ONCE; rows materialize lazily."""
        from zeebe_tpu_torch.protocol.columnar import ColumnarBatch
        from zeebe_tpu_torch.protocol.intents import (
            IncidentIntent,
            MessageSubscriptionIntent as MS,
            WorkflowInstanceSubscriptionIntent as WS,
        )

        count = int(o["valid"].sum())
        if not count:
            return
        cols = {
            k: v[:count].tolist() for k, v in o.items() if v.ndim == 1
        }
        # bind THIS compile's meta into the lazy closures
        meta = self.meta
        names = meta.varspace.names
        srcs = cols["src"]
        sources = [
            src_positions[s] if 0 <= s < len(src_positions) else -1
            for s in srcs
        ]
        producer_d, incident_d, rejtype_d = _frame_defaults()
        emission = ColumnarBatch(
            count,
            {
                "key": cols["key"],
                "record_type": cols["rtype"],
                "value_type": cols["vtype"],
                "intent": cols["intent"],
                "request_id": cols["req"],
                "request_stream_id": cols["req_stream"],
                "source_record_position": sources,
                "producer_id": [producer_d] * count,
                "incident_key": [incident_d] * count,
                "rejection_type": [rejtype_d] * count,
                "rejection_reason": [""] * count,
                "raft_term": [0] * count,
            },
            materializer=lambda r: self._materialize(
                o, cols, r, names, sources, meta
            ),
            value_builder=lambda r: self._materialize_value(
                o, cols, r, names, meta
            ),
        )
        emission.device_source = (o, cols, self._meta_epoch)
        rt_cmd = int(RecordType.COMMAND)
        rt_rej = int(RecordType.COMMAND_REJECTION)
        for r in range(count):
            src = srcs[r]
            res = results[live_rows[src]] if 0 <= src < len(live_rows) else results[0]
            vt = cols["vtype"][r]
            rt = cols["rtype"][r]
            intent = cols["intent"][r]
            # cross-partition subscription commands are SENDS
            if rt == rt_cmd and vt == int(
                ValueType.MESSAGE_SUBSCRIPTION
            ) and intent in (int(MS.OPEN), int(MS.CLOSE)):
                record = emission.row(r)
                target = self.partition_for_correlation_key(
                    record.value.correlation_key
                )
                record.source_record_position = -1  # sends are unstamped
                res.sends.append((target, record))
                continue
            if rt == rt_cmd and vt == int(
                ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION
            ) and intent == int(WS.CORRELATE):
                record = emission.row(r)
                record.source_record_position = -1
                res.sends.append((cols["wf"][r], record))
                continue
            if (
                rt == rt_cmd
                and vt == int(ValueType.INCIDENT)
                and intent == int(IncidentIntent.CREATE)
            ):
                if (
                    suppress_incident_create
                    and 0 <= src < len(live_rows)
                    and live_rows[src] in suppress_incident_create
                ):
                    continue  # job incidents are host-emitted
                record = emission.row(r)
                if (
                    record.value is not None
                    and record.value.failure_event_position < 0
                ):
                    # the failing event IS this emission's source record
                    record.value.failure_event_position = (
                        record.source_record_position
                    )
                res.written.append(record)
                if cols["resp"][r] and cols["req"][r] >= 0:
                    res.responses.append(record)
                if cols["push"][r]:
                    res.pushes.append((cols["req_stream"][r], record))
                continue
            resp = cols["resp"][r] and cols["req"][r] >= 0
            push = cols["push"][r]
            if not resp and not push and rt != rt_rej:
                # plain append: the row stays COLUMNS into the log tail
                res.written.append((emission, r))
                continue
            record = emission.row(r)
            res.written.append(record)
            if resp:
                res.responses.append(record)
            if push:
                res.pushes.append((cols["req_stream"][r], record))

    def _materialize(self, o, cols, r, names, sources, meta) -> Record:
        """One emission row → Record (``meta`` is the graph meta bound AT
        EMIT)."""
        vt = cols["vtype"][r]
        rt = cols["rtype"][r]
        rej = cols["rej"][r]
        value = self._materialize_value(o, cols, r, names, meta)

        md = RecordMetadata(
            record_type=RecordType(rt),
            value_type=ValueType(vt),
            intent=cols["intent"][r],
            request_id=cols["req"][r],
            request_stream_id=cols["req_stream"][r],
        )
        if rt == int(RecordType.COMMAND_REJECTION):
            md.rejection_type = (
                RejectionType.BAD_VALUE
                if rej == rb.REJ_RETRIES_NOT_POSITIVE
                else RejectionType.NOT_APPLICABLE
            )
            md.rejection_reason = rb.REJECTION_REASONS.get(rej, "")
            if vt == int(ValueType.MESSAGE) and rej == rb.REJ_MSG_DUP:
                md.rejection_type = RejectionType.BAD_VALUE
                md.rejection_reason = (
                    f"message with id '{value.message_id}' is already "
                    "published"
                )
        record = Record(key=cols["key"][r], metadata=md, value=value)
        record.source_record_position = sources[r]
        return record

    def _materialize_value(self, o, cols, r, names, meta):
        """One emission row → its typed ``RecordValue`` only."""
        vt = cols["vtype"][r]
        rej = cols["rej"][r]
        wf_slot = cols["wf"][r]
        elem = cols["elem"][r]
        payload = rb.columns_to_payload(
            o["v_vt"][r], o["v_num"][r], o["v_str"][r], names, self.interns
        )
        workflow = (
            meta.workflows[wf_slot]
            if 0 <= wf_slot < len(meta.workflows)
            else None
        )
        elem_id = meta.element_id(wf_slot, elem)
        element = (
            workflow.elements[elem] if workflow and 0 <= elem < len(workflow.elements)
            else None
        )

        if vt == int(ValueType.WORKFLOW_INSTANCE):
            value = WorkflowInstanceRecord(
                bpmn_process_id=workflow.id if workflow else "",
                version=workflow.version if workflow else -1,
                workflow_key=workflow.key if workflow else -1,
                workflow_instance_key=cols["instance_key"][r],
                activity_id=elem_id,
                payload=payload,
                scope_instance_key=cols["scope_key"][r],
            )
        elif vt == int(ValueType.JOB):
            value = JobRecord(
                type=self.interns.string(cols["type_id"][r]) or "",
                retries=cols["retries"][r],
                deadline=cols["deadline"][r],
                worker=self.interns.string(cols["worker"][r]) or "",
                payload=payload,
                custom_headers=dict(element.job_headers) if element else {},
                headers=JobHeaders(
                    workflow_instance_key=cols["instance_key"][r],
                    bpmn_process_id=workflow.id if workflow else "",
                    workflow_definition_version=workflow.version if workflow else -1,
                    workflow_key=workflow.key if workflow else -1,
                    activity_id=elem_id,
                    activity_instance_key=cols["aux_key"][r],
                ),
            )
        elif vt == int(ValueType.INCIDENT):
            error_type, message = self._incident_error(o, r, element, payload, rej)
            value = IncidentRecord(
                error_type=int(error_type),
                error_message=message,
                bpmn_process_id=workflow.id if workflow else "",
                workflow_instance_key=cols["instance_key"][r],
                activity_id=elem_id,
                activity_instance_key=cols["aux_key"][r],
                job_key=cols["aux2_key"][r],
                payload=payload,
            )
        elif vt == int(ValueType.TIMER):
            value = TimerRecord(
                workflow_instance_key=cols["instance_key"][r],
                activity_instance_key=cols["aux_key"][r],
                due_date=cols["deadline"][r],
                handler_element_id=elem_id,
            )
        elif vt == int(ValueType.MESSAGE):
            from zeebe_tpu_torch.protocol.records import MessageRecord

            value = MessageRecord(
                name=self.interns.string(cols["type_id"][r]) or "",
                correlation_key=self._corr_string(
                    cols["retries"][r], cols["worker"][r]
                ),
                time_to_live=max(cols["deadline"][r], 0),
                payload=payload,
                message_id=self.interns.string(cols["aux2_key"][r]) or "",
            )
        elif vt == int(ValueType.MESSAGE_SUBSCRIPTION):
            from zeebe_tpu_torch.protocol.records import MessageSubscriptionRecord

            value = MessageSubscriptionRecord(
                workflow_instance_partition_id=cols["wf"][r],
                workflow_instance_key=cols["instance_key"][r],
                activity_instance_key=cols["aux_key"][r],
                message_name=self.interns.string(cols["type_id"][r]) or "",
                correlation_key=self._corr_string(
                    cols["retries"][r], cols["worker"][r]
                ),
            )
        elif vt == int(ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION):
            from zeebe_tpu_torch.protocol.records import (
                WorkflowInstanceSubscriptionRecord,
            )

            value = WorkflowInstanceSubscriptionRecord(
                workflow_instance_key=cols["instance_key"][r],
                activity_instance_key=cols["aux_key"][r],
                message_name=self.interns.string(cols["type_id"][r]) or "",
                payload=payload,
                message_partition_id=cols["aux2_key"][r],
                correlation_key=self._corr_string(
                    cols["retries"][r], cols["worker"][r]
                ),
            )
        else:
            value = None
        return value

    def _corr_string(self, cvt: int, cbits: int) -> str:
        """Correlation columns → the oracle's string form."""
        from zeebe_tpu_torch.tpu.conditions import VT_BOOL, VT_STR

        if cvt == int(VT_STR):
            return self.interns.string(cbits) or ""
        if cvt == int(VT_BOOL):
            return str(bool(np.int32(cbits).view(np.float32)))
        if cvt == 0:
            return ""
        f = float(np.int32(cbits).view(np.float32))
        return str(int(f)) if f == int(f) else str(f)

    def _incident_error(self, o, r, element, payload, rej):
        """Reconstruct the oracle's exact incident error message by
        re-running the failing host evaluation (the device only ships an
        error code)."""
        if rej == rb.ERR_CONDITION_NO_FLOW:
            return (
                ErrorType.CONDITION_ERROR,
                "All conditions evaluated to false and no default flow is set.",
            )
        if rej == rb.ERR_CONDITION_EVAL and element is not None:
            try:
                for flow in element.outgoing_with_condition:
                    evaluate_condition(flow.condition, payload)
            except ConditionEvalError as e:
                return ErrorType.CONDITION_ERROR, str(e)
            return ErrorType.CONDITION_ERROR, "condition evaluation failed"
        if rej in (rb.ERR_IO_MAPPING_IN, rb.ERR_IO_MAPPING_OUT) and element is not None:
            mappings = (
                element.input_mappings
                if rej == rb.ERR_IO_MAPPING_IN
                else element.output_mappings
            )
            try:
                if rej == rb.ERR_IO_MAPPING_IN:
                    extract(payload, mappings)
                else:
                    merge(payload, {}, mappings)
            except MappingError as e:
                return ErrorType.IO_MAPPING_ERROR, str(e)
            return ErrorType.IO_MAPPING_ERROR, "io mapping failed"
        if rej == rb.ERR_JOB_NO_RETRIES:
            return ErrorType.JOB_NO_RETRIES, "No more retries left."
        if rej == rb.ERR_CORRELATION_KEY:
            path = getattr(element, "correlation_key_path", "") if element else ""
            return (
                ErrorType.IO_MAPPING_ERROR,
                f"Failed to extract the correlation-key by '{path}'",
            )
        return ErrorType.UNKNOWN, ""
