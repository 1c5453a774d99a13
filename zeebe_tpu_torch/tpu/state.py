"""Engine state: struct-of-arrays tables on the device.

PyTorch counterpart of ``zeebe_tpu.tpu.state``, with the same field names,
dtypes and shapes, so the arrays of a JAX engine's state (or of its
``snapshot_state``) map one to one onto this one (``state_from_numpy`` /
``state_to_numpy``):

- element instances: lifecycle state, element, scope linkage, token
  counts, packed payload, a direct-mapped key → slot index and a hashmap
  fallback, a free-slot ring
- jobs: the same layout for the job state machine
- parallel joins: key, fan-in, arrival flags, merged payload, flow-position
  stamps and a key → slot hashmap (the fork/join path of the kernel)
- timers (key, due date, activity instance, handler element) and the
  message partition's store (open subscriptions, stored messages), each
  with a key → slot hashmap
- job worker subscriptions and the strided key counters

Write-path note: the step kernel commits the element-instance group and
the job group through ``ops.fused_table_commit``, which updates the
tables IN PLACE. A state handed to ``kernel.step_kernel`` is therefore
consumed: keep ``state_to_numpy(state)`` first if the old values matter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from zeebe_tpu_torch.device import DeviceLike, resolve
from zeebe_tpu_torch.engine import keyspace
from zeebe_tpu_torch.tpu import hashmap, ops
from zeebe_tpu_torch.tracing import device as device_spans

# packed column layouts (same as the JAX package)
EI_ELEM, EI_STATE, EI_WF, EI_SCOPE, EI_TOKENS = 0, 1, 2, 3, 4
EI_PENDING_BD = 5
EIL_KEY, EIL_IKEY, EIL_JOB_KEY = 0, 1, 2
JB_STATE, JB_ELEM, JB_WF, JB_TYPE, JB_RETRIES, JB_WORKER = 0, 1, 2, 3, 4, 5
JBL_KEY, JBL_IKEY, JBL_AIK, JBL_DEADLINE = 0, 1, 2, 3
MS_NAME, MS_CVT, MS_CBITS, MS_PART = 0, 1, 2, 3
MSL_WIKEY, MSL_AIK = 0, 1
MG_NAME, MG_CVT, MG_CBITS, MG_MSGID = 0, 1, 2, 3


def corr_composite(name_id, corr_vt, corr_bits):
    """Injective int64 composite of (message name, correlation value) — the
    hashmap key for subscription and stored-message lookups. The value is
    an interned-string id or the f32 bit pattern, tagged by its value type
    so numeric and string keys never alias; non-negative by construction."""
    return (
        (name_id.to(torch.int64) << 35)
        | (corr_vt.to(torch.int64) << 32)
        | (corr_bits.to(torch.int64) & 0xFFFFFFFF)
    )


STATE_FIELDS = (
    "ei_i32", "ei_i64", "ei_pay", "ei_map", "ei_index",
    "free_ei", "free_ei_pop", "free_ei_push",
    "job_i32", "job_i64", "job_pay", "job_map", "job_index",
    "free_job", "free_job_pop", "free_job_push",
    "join_key", "join_nin", "join_arrived", "join_pay",
    "join_pos_stamp", "join_map",
    "timer_key", "timer_due", "timer_aik", "timer_instance_key", "timer_elem",
    "timer_wf", "timer_map",
    "msub_ckey", "msub_i32", "msub_i64", "msub_map",
    "msg_key", "msg_ckey", "msg_i32", "msg_deadline", "msg_pay", "msg_map",
    "sub_key", "sub_type", "sub_worker", "sub_credits", "sub_timeout", "sub_valid",
    "sub_rr",
    "next_wf_key", "next_job_key",
)
MAP_FIELDS = tuple(f for f in STATE_FIELDS if f.endswith("_map"))


def pack_payload(vt, sid, num):
    """[..., V] (vt int, sid int32, num float32) → [..., 3V] int32; the f32
    numbers are BITCAST (``.view``), so NaN payloads stay bit-identical."""
    return torch.cat(
        [
            vt.to(torch.int32),
            sid.to(torch.int32),
            num.to(torch.float32).contiguous().view(torch.int32),
        ],
        dim=-1,
    )


def unpack_payload(pay):
    """[..., 3V] int32 → (vt int32, sid int32, num float32), each [..., V]."""
    v = pay.shape[-1] // 3
    vt = pay[..., :v]
    sid = pay[..., v : 2 * v]
    num = pay[..., 2 * v : 3 * v].contiguous().view(torch.float32)
    return vt, sid, num


@dataclasses.dataclass
class EngineState:
    # element instances [N]: ei_i32 cols = (elem, lifecycle state[-1 free],
    # wf slot, scope slot, token count, pending boundary elem[-1 none]);
    # ei_i64 cols = (key[-1 free], workflowInstanceKey, jobKey)
    ei_i32: torch.Tensor          # [N, 6] int32
    ei_i64: torch.Tensor          # [N, 3] int64
    ei_pay: torch.Tensor          # [N, 3V] int32 packed payload
    ei_map: hashmap.HashTable     # key → slot (fallback; see ei_index)
    # direct-mapped key → slot accelerator on key // 5 (keys are stride-5)
    ei_index: torch.Tensor        # [8N] int32 slot, -1 empty
    free_ei: torch.Tensor         # [N] int32 ring of free slots
    free_ei_pop: torch.Tensor     # int64 scalar
    free_ei_push: torch.Tensor    # int64 scalar

    # jobs [M]: job_i32 cols = (state[-1 free], elem, wf, type, retries,
    # worker); job_i64 cols = (key[-1 free], instanceKey, aik, deadline)
    job_i32: torch.Tensor         # [M, 6] int32
    job_i64: torch.Tensor         # [M, 4] int64
    job_pay: torch.Tensor         # [M, 3V] int32 packed payload
    job_map: hashmap.HashTable
    job_index: torch.Tensor       # [8M] int32 slot, -1 empty
    free_job: torch.Tensor        # [M] int32
    free_job_pop: torch.Tensor    # int64
    free_job_push: torch.Tensor   # int64

    # parallel joins [J]
    join_key: torch.Tensor        # int64 composite, -1 free
    join_nin: torch.Tensor        # int32
    join_arrived: torch.Tensor    # [J, F_in] bool
    join_pay: torch.Tensor        # [J, 3V] int32
    join_pos_stamp: torch.Tensor  # [J, V] int32
    join_map: hashmap.HashTable

    # timers [TM]
    timer_key: torch.Tensor       # int64, -1 free
    timer_due: torch.Tensor       # int64
    timer_aik: torch.Tensor       # int64
    timer_instance_key: torch.Tensor  # int64
    timer_elem: torch.Tensor      # int32
    timer_wf: torch.Tensor        # int32
    timer_map: hashmap.HashTable

    # message subscriptions [MS]
    msub_ckey: torch.Tensor       # [MS] int64 corr_composite, -1 free
    msub_i32: torch.Tensor        # [MS, 4]
    msub_i64: torch.Tensor        # [MS, 2]
    msub_map: hashmap.HashTable

    # stored messages [MG]
    msg_key: torch.Tensor         # [MG] int64, -1 free
    msg_ckey: torch.Tensor        # [MG] int64
    msg_i32: torch.Tensor         # [MG, 4]
    msg_deadline: torch.Tensor    # [MG] int64
    msg_pay: torch.Tensor         # [MG, 3V]
    msg_map: hashmap.HashTable

    # job worker subscriptions [S] (host-managed)
    sub_key: torch.Tensor         # int64 subscriber key
    sub_type: torch.Tensor        # int32 interned job type
    sub_worker: torch.Tensor      # int32 interned worker name
    sub_credits: torch.Tensor     # int32
    sub_timeout: torch.Tensor     # int64
    sub_valid: torch.Tensor       # bool
    sub_rr: torch.Tensor          # int32 round-robin cursor

    # key counters (int64 scalars)
    next_wf_key: torch.Tensor
    next_job_key: torch.Tensor

    # column views (no copies)
    @property
    def ei_key(self): return self.ei_i64[:, EIL_KEY]
    @property
    def ei_instance_key(self): return self.ei_i64[:, EIL_IKEY]
    @property
    def ei_job_key(self): return self.ei_i64[:, EIL_JOB_KEY]
    @property
    def ei_elem(self): return self.ei_i32[:, EI_ELEM]
    @property
    def ei_state(self): return self.ei_i32[:, EI_STATE]
    @property
    def ei_wf(self): return self.ei_i32[:, EI_WF]
    @property
    def ei_scope_slot(self): return self.ei_i32[:, EI_SCOPE]
    @property
    def ei_tokens(self): return self.ei_i32[:, EI_TOKENS]
    @property
    def job_key(self): return self.job_i64[:, JBL_KEY]
    @property
    def job_instance_key(self): return self.job_i64[:, JBL_IKEY]
    @property
    def job_aik(self): return self.job_i64[:, JBL_AIK]
    @property
    def job_deadline(self): return self.job_i64[:, JBL_DEADLINE]
    @property
    def job_state(self): return self.job_i32[:, JB_STATE]
    @property
    def job_elem(self): return self.job_i32[:, JB_ELEM]
    @property
    def job_wf(self): return self.job_i32[:, JB_WF]
    @property
    def job_type(self): return self.job_i32[:, JB_TYPE]
    @property
    def job_retries(self): return self.job_i32[:, JB_RETRIES]
    @property
    def job_worker(self): return self.job_i32[:, JB_WORKER]

    @property
    def capacity(self) -> int:
        return self.ei_i32.shape[0]

    @property
    def num_vars(self) -> int:
        return self.ei_pay.shape[1] // 3

    @property
    def device(self) -> torch.device:
        return self.ei_i32.device


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def make_state(
    capacity: int = 1 << 12,
    num_vars: int = 8,
    job_capacity: int = 0,
    join_capacity: int = 0,
    timer_capacity: int = 0,
    sub_capacity: int = 64,
    max_join_in: int = 4,
    msub_capacity: int = 0,
    msg_capacity: int = 0,
    device: DeviceLike = None,
) -> EngineState:
    """Fresh tables on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for), sized exactly as ``zeebe_tpu.tpu.state.make_state`` sizes them."""
    dev = resolve(device)
    n = capacity
    m = job_capacity or capacity
    j = join_capacity or max(capacity // 8, 256)
    tm = timer_capacity or max(capacity // 8, 256)
    ms = msub_capacity or max(capacity // 2, 256)
    mg = msg_capacity or max(capacity // 4, 256)
    v = num_vars
    i64, i32 = torch.int64, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def scalar(value, dtype):
        return torch.tensor(value, dtype=dtype, device=dev)

    return EngineState(
        # ei_i32: elem=0, state=-1, wf=0, scope=-1, tokens=0, pending_bd=-1
        ei_i32=torch.tensor([[0, -1, 0, -1, 0, -1]], dtype=i32, device=dev)
        .repeat(n, 1),
        ei_i64=full((n, 3), -1, i64),
        ei_pay=zeros((n, 3 * v), i32),
        ei_map=hashmap.make(_pow2(8 * n), device=dev),
        ei_index=full((_pow2(8 * n),), -1, i32),
        free_ei=torch.arange(n, dtype=i32, device=dev),
        free_ei_pop=scalar(0, i64),
        free_ei_push=scalar(n, i64),
        # job_i32: state=-1, elem/wf/type/retries/worker=0
        job_i32=torch.tensor([[-1, 0, 0, 0, 0, 0]], dtype=i32, device=dev)
        .repeat(m, 1),
        job_i64=full((m, 4), -1, i64),
        job_pay=zeros((m, 3 * v), i32),
        job_map=hashmap.make(_pow2(8 * m), device=dev),
        job_index=full((_pow2(8 * m),), -1, i32),
        free_job=torch.arange(m, dtype=i32, device=dev),
        free_job_pop=scalar(0, i64),
        free_job_push=scalar(m, i64),
        join_key=full((j,), -1, i64),
        join_nin=zeros((j,), i32),
        join_arrived=zeros((j, max_join_in), torch.bool),
        join_pay=zeros((j, 3 * v), i32),
        join_pos_stamp=full((j, v), -1, i32),
        join_map=hashmap.make(_pow2(4 * j), device=dev),
        timer_key=full((tm,), -1, i64),
        timer_due=full((tm,), -1, i64),
        timer_aik=full((tm,), -1, i64),
        timer_instance_key=full((tm,), -1, i64),
        timer_elem=zeros((tm,), i32),
        timer_wf=zeros((tm,), i32),
        timer_map=hashmap.make(_pow2(4 * tm), device=dev),
        msub_ckey=full((ms,), -1, i64),
        msub_i32=zeros((ms, 4), i32),
        msub_i64=full((ms, 2), -1, i64),
        msub_map=hashmap.make(_pow2(4 * ms), device=dev),
        msg_key=full((mg,), -1, i64),
        msg_ckey=full((mg,), -1, i64),
        msg_i32=zeros((mg, 4), i32),
        msg_deadline=full((mg,), -1, i64),
        msg_pay=zeros((mg, 3 * v), i32),
        msg_map=hashmap.make(_pow2(4 * mg), device=dev),
        sub_key=full((sub_capacity,), -1, i64),
        sub_type=zeros((sub_capacity,), i32),
        sub_worker=zeros((sub_capacity,), i32),
        sub_credits=zeros((sub_capacity,), i32),
        sub_timeout=zeros((sub_capacity,), i64),
        sub_valid=zeros((sub_capacity,), torch.bool),
        sub_rr=scalar(0, i32),
        next_wf_key=scalar(keyspace.WF_OFFSET, i64),
        next_job_key=scalar(keyspace.JOB_OFFSET, i64),
    )


def _scatter_last(size: int, slots: torch.Tensor, active: torch.Tensor,
                  values: torch.Tensor, fill: int) -> torch.Tensor:
    """``full(size, fill).at[where(active, slots, size)].set(values,
    mode="drop")`` with XLA's serial last-writer-wins made explicit: among
    active rows sharing a slot, the highest row wins. ``values`` must be
    ``arange`` (the row numbers), so the winner's value IS its row and a
    scatter-max resolves it."""
    idx = torch.where(active, slots.to(torch.int64), size)
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=slots.device)
    out.scatter_reduce_(0, idx, values.to(torch.int32), reduce="amax",
                        include_self=True)
    return out[:size]


def _rebuilt_map(like: hashmap.HashTable, keys: torch.Tensor, vals: torch.Tensor,
                 live: torch.Tensor) -> hashmap.HashTable:
    """A fresh map of ``like``'s capacity holding the live entries: the
    layout of ``hashmap.rebuild_from``, through ``ops.insert`` (the insert
    kernel on CUDA tensors, with no host sync)."""
    table = hashmap.make(like.keys.shape[0], device=keys.device)
    return ops.insert(table, keys, vals, live)[0]


@device_spans.traced("rebuild")
def rebuild_lookup_state(state: EngineState) -> EngineState:
    """Recompute the key→slot indexes and fallback hashmaps from live table
    rows, and the free-slot rings. Run at wave boundaries — not per round
    (see ``zeebe_tpu.tpu.state.rebuild_lookup_state``)."""
    dev = state.device
    n = state.ei_i32.shape[0]
    m = state.job_i32.shape[0]
    icap = state.ei_index.shape[0]
    jcap = state.job_index.shape[0]
    ei_live = state.ei_state >= 0
    job_live = state.job_state >= 0
    rows_n = torch.arange(n, dtype=torch.int32, device=dev)
    rows_m = torch.arange(m, dtype=torch.int32, device=dev)
    # congruent keys collide in the index: the LAST live row wins, as in
    # the serial XLA scatter (fill -1 < every row, so amax keeps it empty)
    ei_idx = _scatter_last(
        icap, (state.ei_key // 5) & (icap - 1), ei_live, rows_n, -1
    )
    job_idx = _scatter_last(
        jcap, (state.job_key // 5) & (jcap - 1), job_live, rows_m, -1
    )
    ei_map = _rebuilt_map(state.ei_map, state.ei_key, rows_n, ei_live)
    job_map = _rebuilt_map(state.job_map, state.job_key, rows_m, job_live)
    ei_free_mask = ~ei_live
    job_free_mask = ~job_live
    ei_rank = torch.cumsum(ei_free_mask.to(torch.int32), 0, dtype=torch.int32) \
        - ei_free_mask.to(torch.int32)
    job_rank = torch.cumsum(job_free_mask.to(torch.int32), 0, dtype=torch.int32) \
        - job_free_mask.to(torch.int32)
    # free ranks are distinct, so these scatters have unique targets
    free_ei = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    free_ei[torch.where(ei_free_mask, ei_rank, n).to(torch.int64)] = rows_n
    free_job = torch.full((m + 1,), m, dtype=torch.int32, device=dev)
    free_job[torch.where(job_free_mask, job_rank, m).to(torch.int64)] = rows_m

    def _iota(a):
        return torch.arange(a.shape[0], dtype=torch.int32, device=dev)

    join_map = _rebuilt_map(state.join_map, state.join_key,
                            _iota(state.join_key), state.join_key >= 0)
    timer_map = _rebuilt_map(state.timer_map, state.timer_key,
                             _iota(state.timer_key), state.timer_key >= 0)
    msub_map = _rebuilt_map(state.msub_map, state.msub_ckey,
                            _iota(state.msub_ckey), state.msub_ckey >= 0)
    msg_map = _rebuilt_map(state.msg_map, state.msg_ckey,
                           _iota(state.msg_ckey), state.msg_key >= 0)
    return dataclasses.replace(
        state, ei_index=ei_idx, job_index=job_idx,
        ei_map=ei_map, job_map=job_map,
        join_map=join_map, timer_map=timer_map,
        msub_map=msub_map, msg_map=msg_map,
        free_ei=free_ei[:n],
        free_ei_pop=torch.zeros((), dtype=torch.int64, device=dev),
        free_ei_push=torch.sum(ei_free_mask, dtype=torch.int64),
        free_job=free_job[:m],
        free_job_pop=torch.zeros((), dtype=torch.int64, device=dev),
        free_job_push=torch.sum(job_free_mask, dtype=torch.int64),
    )


# ---------------------------------------------------------------------------
# carrying state across engines
# ---------------------------------------------------------------------------


def state_to_numpy(state: EngineState) -> Dict[str, np.ndarray]:
    """Every table as a numpy array, keyed by field name; hash tables as
    ``"<field>.keys"`` / ``"<field>.vals"`` (the layout of the JAX engine's
    ``snapshot_state`` arrays). The arrays are copies on both devices, so a
    later in-place step leaves them as they were."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", copy=True).numpy()

    out: Dict[str, np.ndarray] = {}
    for name in STATE_FIELDS:
        value = getattr(state, name)
        if isinstance(value, hashmap.HashTable):
            out[f"{name}.keys"] = host(value.keys)
            out[f"{name}.vals"] = host(value.vals)
        else:
            out[name] = host(value)
    return out


def state_from_numpy(arrays, device: DeviceLike = None) -> EngineState:
    """Inverse of ``state_to_numpy``: tensors on ``device`` with the arrays'
    own dtypes and shapes."""
    dev = resolve(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    fields = {}
    for name in STATE_FIELDS:
        if name in MAP_FIELDS:
            fields[name] = hashmap.HashTable(
                keys=t(arrays[f"{name}.keys"]), vals=t(arrays[f"{name}.vals"])
            )
        else:
            fields[name] = t(arrays[name])
    return EngineState(**fields)


def state_to(state: EngineState, device: DeviceLike) -> EngineState:
    """The state's tables copied to ``device`` (the same tensors when they
    are already there)."""
    dev = torch.device(device)
    fields = {}
    for name in STATE_FIELDS:
        value = getattr(state, name)
        if isinstance(value, hashmap.HashTable):
            fields[name] = hashmap.HashTable(keys=value.keys.to(dev), vals=value.vals.to(dev))
        else:
            fields[name] = value.to(dev)
    return EngineState(**fields)
