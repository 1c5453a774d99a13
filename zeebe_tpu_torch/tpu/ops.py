"""The step kernel's table primitives: CUDA kernels and their plain versions.

Counterpart of ``zeebe_tpu.tpu.pallas_ops`` for the primitives the step
kernel runs with every feature gate:

- ``fused_gather_rows``  ↔ ``pallas_ops.fused_gather_rows`` (csrc/gather_rows.cu)
- ``fused_table_commit`` ↔ ``pallas_ops.fused_table_commit`` (csrc/table_commit.cu)
- ``fused_lookup``, ``lookup`` ↔ ``pallas_ops.lookup``, every independent
  probe of a step in one launch (csrc/hash_lookup.cu)
- ``masked_row_update``, ``masked_lane_update``, ``masked_vec64_update``
  ↔ the ``pallas_ops`` functions of the same names: one-op table commits
  (csrc/table_commit.cu)
- ``fused_accumulate`` ↔ ``pallas_ops.masked_row_max``,
  ``masked_row_add`` and ``masked_lane_accum``, a step's commutative
  scatters in one launch; those three are its one-op case
  (csrc/scatter_accum.cu)
- ``insert`` ↔ ``pallas_ops.insert`` (csrc/hash_update.cu)
- ``fused_delete``, ``delete`` ↔ ``pallas_ops.delete``, every delete of a
  step in one launch (csrc/hash_update.cu)

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain PyTorch version beside each kernel (``*_reference``); CUDA tensors
launch the hand-written kernel, or the call raises. There is no fallback
from a CUDA tensor to the plain version. A call's tensors lie on one card
(a mix raises), and the kernel launches with that card current, on its
current stream, whichever card the caller has current. ``LAUNCHES`` counts the wrapper
calls that reach the GPU, ``DEVICE_LAUNCHES`` the kernels they enqueue
(a table commit is a pass or two per stage of ``commit_plan``; every
other call one; a CUDA graph's replay adds what its capture counted,
``credit``), and, while the device-path recorder is installed
(``tracing.device``), ``HOST_NS`` the host nanoseconds of those calls,
from the wrapper's entry to the C entry's return. The launch plans
(``gather_plan``, ``commit_plan``, ``lookup_plan``, which the delete
shares, ``insert_plan``) are built here, in Python, so the CPU tests
reach them; the accumulate's block plan is one line of its C entry.

Aliasing: unlike their JAX counterparts, every table write here updates
the caller's tensors IN PLACE on both devices and returns them.

Semantics kept from the JAX package (the XLA fallbacks its CPU tests pin):
- gathers wrap a negative slot once, then clamp into [0, T-1];
- scatters wrap a negative slot once and DROP a slot still outside
  [0, T) — the kernel parks inactive records on the sentinel slot T;
- a ``set`` is last-writer-wins in batch order, per row or, with a lane
  mask, per (row, lane); ``add``/``max`` commute.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from zeebe_tpu_torch import _build
from zeebe_tpu_torch.tpu import hashmap
from zeebe_tpu_torch.tpu.hashmap import HashTable
from zeebe_tpu_torch.tracing import device as device_spans

# kernel launches per wrapper (one per wrapper call that reaches the GPU);
# chip_smoke.py zeroes these before driving the main path and reads them
# after
LAUNCHES: Dict[str, int] = {
    "fused_gather_rows": 0, "fused_table_commit": 0, "lookup": 0,
    "masked_row_update": 0, "masked_row_max": 0, "masked_row_add": 0,
    "masked_lane_update": 0, "masked_lane_accum": 0, "masked_vec64_update": 0,
    "insert": 0, "delete": 0, "fused_accumulate": 0,
}
# device kernel launches the same calls enqueued: one a call, but for the
# table commits (a pass or two per stage of the op list: commit_plan)
DEVICE_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
# host nanoseconds of the same calls made while the device-path recorder is
# installed (the calls it counts are LAUNCHES' over that time)
HOST_NS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
# the counts are read-modify-writes, and a cluster node launches from
# several threads (one drain actor per broker)
_count_lock = threading.Lock()


def reset_launches() -> None:
    for counts in (LAUNCHES, DEVICE_LAUNCHES, HOST_NS):
        for k in counts:
            counts[k] = 0


def launch_counts() -> Dict[str, Tuple[int, int]]:
    """Each wrapper's (calls, device launches) so far."""
    with _count_lock:
        return {k: (LAUNCHES[k], DEVICE_LAUNCHES[k]) for k in LAUNCHES}


def set_launch_counts(counts: Dict[str, Tuple[int, int]]) -> None:
    """Put ``launch_counts()`` back: a CUDA graph's capture counts calls
    that launch nothing until the graph is replayed."""
    with _count_lock:
        for k, (calls, launched) in counts.items():
            LAUNCHES[k], DEVICE_LAUNCHES[k] = calls, launched


def credit(counts: Dict[str, Tuple[int, int]]) -> None:
    """Count the wrapper calls and device launches that one replay of a
    CUDA graph ran, as its capture recorded them (no host time)."""
    with _count_lock:
        for k, (calls, launched) in counts.items():
            LAUNCHES[k] += calls
            DEVICE_LAUNCHES[k] += launched


def _entered() -> int:
    """The host clock at a wrapper's entry while the device-path recorder is
    installed, else 0 (no clock read)."""
    return time.perf_counter_ns() if device_spans.TRACER is not None else 0


def _count(name: str, launched: int, entered: int = 0) -> None:
    """Count a call that reached the GPU and the ``launched`` kernels its C
    entry enqueued, and with ``entered`` (``_entered()``) its host time; a
    negative ``launched`` is minus a CUDA error."""
    if launched < 0:
        raise RuntimeError(f"{name}: CUDA error {-launched} at launch")
    spent = time.perf_counter_ns() - entered if entered else 0
    with _count_lock:
        LAUNCHES[name] += 1
        DEVICE_LAUNCHES[name] += launched
        HOST_NS[name] += spent


def _device_index(t: torch.Tensor) -> int:
    """A tensor's CUDA device index, -1 off the card (the one place the
    tests substitute a card)."""
    return t.get_device()


def _cuda_device(tensors: Sequence[torch.Tensor], what: str) -> Optional[torch.device]:
    """The one CUDA device every tensor lies on, or None when every one
    lies on the CPU. Tensors on two cards, or on the CPU and a card, raise:
    a kernel reads one card's memory, on that card's stream."""
    indices = {_device_index(t) for t in tensors}
    if len(indices) == 1:
        (index,) = indices
        if index >= 0:
            return torch.device("cuda", index)
        if all(t.is_cpu for t in tensors):
            return None
    raise ValueError(
        f"{what}: tensors on mixed or unsupported devices "
        f"{sorted(f'cuda:{i}' if i >= 0 else 'not a card' for i in indices)}"
    )


def _device_guard(device: torch.device):
    """Make ``device`` the runtime's current device for a launch: a C entry
    launches on the current device, and the insert's cluster-size attribute
    is set per current device."""
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, the one PyTorch
    launches its own kernels on there (CUDA is initialised: the caller
    holds CUDA tensors). Launching on it orders a kernel with PyTorch's ops
    on that card, and with its copies to and from other cards, which wait
    on the current streams of both ends."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def _entry(source: str, name: str, argtypes: tuple):
    """The C entry point ``name`` of ``csrc/<source>.cu`` (built on first
    use), typed: pointers and the stream as c_void_p, never a 32-bit int."""
    fn = getattr(_build.library(source), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _wrap_slots(slots: torch.Tensor, rows: int) -> torch.Tensor:
    """int64 slots with one wrap of negatives (XLA index normalization)."""
    s = slots.to(torch.int64)
    return torch.where(s < 0, s + rows, s)


_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def _slots_i32(slots: torch.Tensor) -> torch.Tensor:
    """``slots`` as the kernels read them: contiguous int32. Other dtypes
    are clamped into int32 range before the cast: a cast alone wraps
    2^32 + 5 to 5, where the gather's clamp reads the last row and a
    scatter drops the record; the clamped value gives both kernels the
    plain versions' answer."""
    if slots.dtype is not torch.int32:
        slots = slots.to(torch.int64).clamp(_I32_MIN, _I32_MAX).to(torch.int32)
    return slots if slots.is_contiguous() else slots.contiguous()


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype``, converted only if it is not."""
    if t.dtype is not dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


# ---------------------------------------------------------------------------
# fused gather
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatherOp:
    """One row (2D table) or element (1D table) read inside a fused gather."""

    table: int
    slots: torch.Tensor


def fused_gather_rows_reference(
    tables: Sequence[torch.Tensor], ops: Sequence[GatherOp]
) -> List[torch.Tensor]:
    """Plain version: ``tables[op.table][op.slots]`` per op, slots wrapped
    once and clamped as XLA's gather does."""
    out = []
    for op in ops:
        t = tables[op.table]
        idx = _wrap_slots(op.slots, t.shape[0]).clamp(0, t.shape[0] - 1)
        out.append(t.index_select(0, idx))
    return out


class _GatherDesc(ctypes.Structure):
    _fields_ = [
        ("table", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("row_stride", ctypes.c_int32),
        ("rows", ctypes.c_int32), ("n", ctypes.c_int32),
        ("vecs", ctypes.c_int32), ("vec_bytes", ctypes.c_int32),
        ("lanes", ctypes.c_int32),
    ]


_MAX_GATHER_OPS = 32
# csrc/gather_rows.cu's ZB_GATHER_THREADS and ZB_GATHER_UNROLL: a block's
# threads, and the rows each group of lanes copies at once
_GATHER_THREADS = 256
_GATHER_UNROLL = 4


# _GatherDesc's bytes, packed in one call (cheaper than nine field sets)
_GATHER_LAYOUT = struct.Struct("<3Q6i")


class _GatherArgs(ctypes.Structure):
    _fields_ = [
        ("d", _GatherDesc * _MAX_GATHER_OPS),
        ("start", ctypes.c_int32 * (_MAX_GATHER_OPS + 1)),
        ("n_ops", ctypes.c_int32),
    ]


def _copy_unit(*quantities: int) -> int:
    """The widest copy (16, 8, 4, 2 or 1 bytes) that divides every address,
    stride and width given: the lowest set bit of their OR with 16."""
    q = 16
    for x in quantities:
        q |= x
    return q & -q


def gather_plan(rows: Sequence[int], vecs: Sequence[int]):
    """The gather kernel's block plan, for ops of ``rows[j]`` rows of
    ``vecs[j]`` copy units each. Returns (lanes, starts): per op the
    threads that copy one row (a power of two, at least ``vecs[j]`` up to
    32), and its first block. Op j has ceil(rows / rows a block copies)
    blocks, none when it has no rows; ``starts`` has one entry more than
    the ops, the grid."""
    lanes, starts, block = [], [], 0
    for n, v in zip(rows, vecs):
        g = 1
        while g < v and g < 32:
            g *= 2
        lanes.append(g)
        starts.append(block)
        block += -(-n // (_GATHER_THREADS // g * _GATHER_UNROLL))
    starts.append(block)
    return lanes, starts


def _gather_args(tables, ops):
    """The kernel's argument block for ``ops``, their outputs, and the
    converted slots the block points at (keep them alive to the launch)."""
    if len(ops) > _MAX_GATHER_OPS:
        raise ValueError(f"fused_gather_rows: at most {_MAX_GATHER_OPS} ops")
    keep, outs, descs = [], [], []
    for op in ops:
        t = tables[op.table]
        dim = t.dim()
        if dim not in (1, 2) or t.shape[0] == 0:
            raise ValueError("fused_gather_rows: tables must be non-empty 1D/2D")
        if dim == 2 and t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("fused_gather_rows: 2D rows must be contiguous")
        es = t.element_size()
        stride = es * t.stride(0)
        if t.shape[0] > _I32_MAX or stride > _I32_MAX:
            raise ValueError("fused_gather_rows: at most 2^31 - 1 rows and row bytes")
        slots = _slots_i32(op.slots)
        n = slots.shape[0]
        # one output per op, by new_empty (the table's dtype and device, fewer
        # arguments to parse): one arena split into views cost more on the
        # card (chip_smoke.py phase 2, alloc_us)
        if dim == 2:
            out = t.new_empty((n, t.shape[1]))
            row_bytes = es * t.shape[1]
        else:
            out = t.new_empty((n,))
            row_bytes = es
        keep.append(slots)
        outs.append(out)
        base, dst = t.data_ptr(), out.data_ptr()
        unit = _copy_unit(base, stride, row_bytes, dst)
        descs.append((base, slots.data_ptr(), dst, stride, t.shape[0], n,
                      row_bytes // unit, unit))
    lanes, starts = gather_plan([d[5] for d in descs], [d[6] for d in descs])
    args = _GatherArgs()
    for j, (d, g) in enumerate(zip(descs, lanes)):
        _GATHER_LAYOUT.pack_into(args, j * _GATHER_LAYOUT.size, *d, g)
    args.start[: len(starts)] = starts
    args.n_ops = len(ops)
    return args, outs, keep


@functools.lru_cache(maxsize=None)
def _gather_fn():
    return _entry("gather_rows", "zb_gather_rows",
                  (ctypes.POINTER(_GatherArgs), ctypes.c_void_p))


def _gather_cuda(tables, ops, device: torch.device, entered: int = 0) -> List[torch.Tensor]:
    with _device_guard(device):
        args, outs, _keep = _gather_args(tables, ops)
        launched = _gather_fn()(ctypes.byref(args), _stream(device))
    if launched:
        _count("fused_gather_rows", launched, entered)
    return outs


def fused_gather_rows(
    tables: Sequence[torch.Tensor], ops: Sequence[GatherOp]
) -> List[torch.Tensor]:
    """``[tables[op.table][op.slots] for op in ops]`` — one kernel launch
    for all ops on CUDA tensors. Tables may be of any dtype, 1D or 2D, and
    1D tables may be strided views (a column of a wider table); results are
    bit-exact copies of the rows."""
    entered = _entered()
    ops = list(ops)
    if not ops:
        return []
    used = [tables[op.table] for op in ops] + [op.slots for op in ops]
    device = _cuda_device(used, "fused_gather_rows")
    if device is not None:
        return _gather_cuda(tables, ops, device, entered)
    return fused_gather_rows_reference(tables, ops)


# ---------------------------------------------------------------------------
# fused table commit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TableOp:
    """One masked table write inside a fused commit.

    ``table`` indexes into the commit's table list. 2D [T, K] tables take
    ``vals`` [B, K] (+ optional ``mask`` [B, K]); 1D [T] tables (free
    rings, direct-mapped indexes) take ``vals`` [B] and no mask. ``kind``:
    "set" (last writer in batch order wins), "add", "max" (commute).
    """

    table: int
    kind: str
    slots: torch.Tensor
    active: torch.Tensor
    vals: torch.Tensor
    mask: Optional[torch.Tensor] = None


def _last_active(keys: torch.Tensor, live: torch.Tensor, size: int) -> torch.Tensor:
    """[n] bool: the highest-index live entry per key in [0, size)."""
    n = keys.shape[0]
    rank = torch.arange(n, dtype=torch.int64, device=keys.device)
    best = torch.full((size + 1,), -1, dtype=torch.int64, device=keys.device)
    best.scatter_reduce_(0, torch.where(live, keys, size), torch.where(live, rank, -1),
                         reduce="amax", include_self=True)
    return live & (best[torch.where(live, keys, size)] == rank)


def _kind(tbl: torch.Tensor, kind: str) -> str:
    """An op's effective kind: the JAX chain routes a 1D table's op to a
    lane accumulate for "add" and to a lane SET for anything else."""
    if kind not in _KINDS:
        raise ValueError(f"fused_table_commit: unknown op kind {kind!r}")
    if tbl.dim() == 1 and kind != "add":
        return "set"
    return kind


def _apply_op_reference(tbl: torch.Tensor, op: TableOp) -> None:
    """One TableOp, in place, with the XLA op chain's semantics."""
    rows = tbl.shape[0]
    kind = _kind(tbl, op.kind)
    s = _wrap_slots(op.slots, rows)
    keep = op.active.to(torch.bool) & (s >= 0) & (s < rows)
    vals = op.vals.to(tbl.dtype)
    if tbl.dim() == 1:
        if kind == "add":
            tbl.index_put_((s[keep],), vals[keep], accumulate=True)
        else:
            win = _last_active(s, keep, rows)
            tbl[s[win]] = vals[win]
        return
    k = tbl.shape[1]
    if kind in ("add", "max"):
        # "max" merges whole rows: the JAX chain ignores a lane mask there
        if op.mask is not None and kind == "add":
            vals = torch.where(op.mask.to(torch.bool), vals, 0)
        if kind == "add":
            tbl.index_put_((s[keep],), vals[keep], accumulate=True)
        else:
            idx = s[keep][:, None].expand(-1, k)
            tbl.scatter_reduce_(0, idx, vals[keep], reduce="amax")
        return
    if op.mask is None:
        win = _last_active(s, keep, rows)
        tbl[s[win]] = vals[win]
        return
    # lane-masked set: last writer per (row, lane)
    lane = torch.arange(k, dtype=torch.int64, device=tbl.device)
    cell = (s[:, None] * k + lane[None, :]).reshape(-1)
    live = (keep[:, None] & op.mask.to(torch.bool)).reshape(-1)
    win = _last_active(cell, live, rows * k)
    tbl.view(-1)[cell[win]] = vals.reshape(-1)[win]


def fused_table_commit_reference(
    tables: Sequence[torch.Tensor], ops: Sequence[TableOp]
) -> List[torch.Tensor]:
    """Plain version: the ops applied in list order, in place. Duplicate
    slots are resolved explicitly (PyTorch's ``index_put_`` gives no order
    among duplicates)."""
    for op in ops:
        _apply_op_reference(tables[op.table], op)
    return list(tables)


_KINDS = {"set": 0, "add": 1, "max": 2}
# csrc/table_commit.cu's ZB_MAX_COMMIT_OPS: the ops one pass can take
_MAX_COMMIT_OPS = 32


@dataclasses.dataclass
class CommitPlan:
    """How the commit kernel runs an op list (csrc/table_commit.cu). Per op:
    its effective kind (``_kind``), whether its lane mask applies (a 1D
    table's op and a 2D "max" ignore it), its stage, and for a "set" the
    scratch offsets, in words, of its table's row and lane claim regions
    (-1 where the table has none). ``words``: the scratch the regions take."""

    kinds: List[str]
    masked: List[bool]
    stages: List[int]
    regions: List[Tuple[int, int]]
    words: int


def commit_plan(tables: Sequence[torch.Tensor], ops: Sequence[TableOp]) -> CommitPlan:
    """Split ``ops`` into stages, in list order: an op opens a new stage when
    its table already took another kind in the current one. Inside a stage
    each table takes one kind, so its ops are all sets (ordered by their
    epochs) or all commuting adds or maxes, and the ops of different tables
    are independent. A table that a set writes gets a row region (unmasked
    sets claim rows) and a lane region (lane-masked sets claim cells)."""
    kinds, masked, stages = [], [], []
    stage, size, seen = 0, 0, {}
    for op in ops:
        t = tables[op.table]
        kind = _kind(t, op.kind)
        if seen.get(op.table, kind) != kind:
            stage, size, seen = stage + 1, 0, {}
        seen[op.table] = kind
        size += 1
        if size > _MAX_COMMIT_OPS:
            raise ValueError(f"fused_table_commit: at most {_MAX_COMMIT_OPS} ops a stage")
        kinds.append(kind)
        masked.append(op.mask is not None and t.dim() == 2 and kind != "max")
        stages.append(stage)
    offsets: Dict[Tuple[int, bool], int] = {}
    words = 0
    for op, kind, m in zip(ops, kinds, masked):
        if kind == "set" and (op.table, m) not in offsets:
            offsets[(op.table, m)] = words
            words += tables[op.table].numel() if m else tables[op.table].shape[0]
    regions = [
        (offsets.get((op.table, False), -1), offsets.get((op.table, True), -1))
        if kind == "set" else (-1, -1)
        for op, kind in zip(ops, kinds)
    ]
    return CommitPlan(kinds, masked, stages, regions, words)


class _CommitDesc(ctypes.Structure):
    _fields_ = [
        ("table", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("active", ctypes.c_void_p), ("vals", ctypes.c_void_p),
        ("mask", ctypes.c_void_p), ("row_claims", ctypes.c_void_p),
        ("lane_claims", ctypes.c_void_p), ("rows", ctypes.c_int32),
        ("width", ctypes.c_int32), ("n", ctypes.c_int32),
        ("kind", ctypes.c_int32), ("epoch", ctypes.c_uint32),
        ("stage", ctypes.c_int32),
    ]


# _CommitDesc's bytes, packed in one call (cheaper than its field sets)
_COMMIT_LAYOUT = struct.Struct("<7Q4iIi")

# per-device claim scratch for "set" ops: [words] int64, and the last epoch
# handed out (see csrc/table_commit.cu); zeroed only when (re)allocated or
# when the 32-bit epoch space wraps.
#
# A writer writes only where the largest claim equals its own tag, so an
# epoch must reach the device in the order it was granted: a lower epoch
# launched after a higher one on the same words loses its writes without
# a trace. Two invariants keep that order:
# - a caller holds the device's ``_scratch_lock`` from ``_claim_scratch``
#   (and the insert's ``_worklist_scratch``) through the launch that uses
#   it, so grant order is enqueue order across threads; the lock also
#   keeps a scratch that a larger request replaces alive until the
#   launch that was given it is enqueued;
# - every launch that uses one scratch goes to one stream, so enqueue
#   order is execution order. Every launch here goes to the calling
#   thread's current stream (``_stream``) and no path of the package sets
#   a stream, so all of them share the device's default stream. A caller
#   that gives engines streams of their own needs a scratch per stream.
# A launch recorded into a CUDA graph replays the epochs of its capture,
# which the per-device scratch has long passed; it claims in a
# ``PrivateScratch`` instead (``private_scratch``).
_claims: Dict[torch.device, list] = {}
_scratch_locks: Dict[torch.device, threading.Lock] = {}


def _scratch_lock(device: torch.device) -> threading.Lock:
    lock = _scratch_locks.get(device)
    if lock is None:
        lock = _scratch_locks.setdefault(device, threading.Lock())
    return lock


class PrivateScratch:
    """The claim and worklist scratch of the launches recorded into one CUDA
    graph, installed by ``private_scratch`` while the graph is captured. Its
    claims are allocated zeroed by the graph's first claiming launch, inside
    the graph, so every replay zeroes them again and then hands out its
    capture's epochs in capture order: a replay never meets a tag of an
    earlier replay, nor of any launch outside the graph, which claims in
    the per-device scratch. The graph's memory pool keeps both buffers."""

    def __init__(self):
        self.claims: Dict[torch.device, list] = {}
        self.worklists: Dict[torch.device, torch.Tensor] = {}


_private = threading.local()


@contextlib.contextmanager
def private_scratch(scratch: PrivateScratch):
    """The calling thread's launches claim in ``scratch`` for the block."""
    outer = getattr(_private, "scratch", None)
    _private.scratch = scratch
    try:
        yield scratch
    finally:
        _private.scratch = outer


def _scratch() -> Tuple[Dict[torch.device, list], Dict[torch.device, torch.Tensor]]:
    """The claim and worklist scratch the calling thread launches with."""
    own = getattr(_private, "scratch", None)
    return (_claims, _worklists) if own is None else (own.claims, own.worklists)


def _claim_scratch(device: torch.device, words: int, epochs: int):
    claims = _scratch()[0]
    entry = claims.get(device)
    if entry is None or entry[0].numel() < words:
        entry = [torch.zeros(max(words, 1), dtype=torch.int64, device=device), 0]
        claims[device] = entry
    if entry[1] + epochs >= 2**32 - 1:
        entry[0].zero_()
        entry[1] = 0
    first = entry[1] + 1
    entry[1] += epochs
    return entry[0], first


def _check_table(t: torch.Tensor, name: str) -> None:
    if (t.dtype is not torch.int32 or not t.is_contiguous() or t.dim() not in (1, 2)
            or t.numel() > _I32_MAX):
        raise ValueError(
            f"{name}: tables must be contiguous int32 1D/2D of under 2^31 "
            "elements (int64 tables enter as .view(torch.int32) planes)"
        )


def _inputs(width: int, slots, active, vals, mask, keep: list):
    """One op's input pointers (slots, active, vals, and mask or None) and
    its record count. Inputs already of the kernel's dtype and layout are
    taken as they are; the tensors go to ``keep`` (alive until the launch
    is enqueued)."""
    n = slots.shape[0]
    slots, active, vals = _slots_i32(slots), _as(active, torch.bool), _as(vals, torch.int32)
    if mask is not None:
        mask = _as(mask, torch.bool)
    if (active.numel() != n or vals.numel() != n * width or n * width > _I32_MAX
            or (mask is not None and mask.numel() != n * width)):
        raise ValueError("fused_table_commit: slots, active, vals and mask disagree "
                         "on the batch or the table width")
    keep += (slots, active, vals, mask)
    return (slots.data_ptr(), active.data_ptr(), vals.data_ptr(),
            None if mask is None else mask.data_ptr(), n)


@functools.lru_cache(maxsize=None)
def _commit_fn():
    return _entry("table_commit", "zb_table_commit",
                  (ctypes.POINTER(_CommitDesc), ctypes.c_int, ctypes.c_void_p))


def _commit_descs(tables, ops):
    """The descriptors of ``ops`` in list order, and the converted inputs
    they point at (keep them alive to the launch)."""
    for t in tables:
        _check_table(t, "fused_table_commit")
    plan = commit_plan(tables, ops)
    epoch = base = 0
    sets = plan.kinds.count("set")
    if sets:
        scratch, epoch = _claim_scratch(tables[ops[0].table].device, plan.words, sets)
        base = scratch.data_ptr()
    descs = (_CommitDesc * len(ops))()
    keep: list = []
    for k, op in enumerate(ops):
        t, kind = tables[op.table], plan.kinds[k]
        rows, width = (t.shape[0], t.shape[1]) if t.dim() == 2 else (t.shape[0], 1)
        s, a, v, m, n = _inputs(width, op.slots, op.active, op.vals,
                                op.mask if plan.masked[k] else None, keep)
        row_claims = lane_claims = op_epoch = 0
        if kind == "set":
            row, lane = plan.regions[k]
            row_claims = base + 8 * row if row >= 0 else 0
            lane_claims = base + 8 * lane if lane >= 0 else 0
            op_epoch, epoch = epoch, epoch + 1
        _COMMIT_LAYOUT.pack_into(descs, k * _COMMIT_LAYOUT.size, t.data_ptr(), s, a, v,
                                 m or 0, row_claims, lane_claims, rows, width, n,
                                 _KINDS[kind], op_epoch, plan.stages[k])
    return descs, keep


def _commit_cuda(tables, ops, device: torch.device, entered: int = 0) -> List[torch.Tensor]:
    with _scratch_lock(device), _device_guard(device):
        descs, _keep = _commit_descs(tables, ops)
        _count("fused_table_commit", _commit_fn()(descs, len(ops), _stream(device)), entered)
    return list(tables)


def fused_table_commit(
    tables: Sequence[torch.Tensor], ops: Sequence[TableOp]
) -> List[torch.Tensor]:
    """Apply ``ops`` to ``tables`` (all int32, none overlapping another;
    int64 state enters as ``.view(torch.int32)`` planes) in list order, IN
    PLACE; returns the tables in input order. On CUDA tensors one C call
    enqueues the whole list: a pass or two per stage of ``commit_plan``."""
    entered = _entered()
    ops = list(ops)
    if not ops:
        return list(tables)
    used = (list(tables) + [op.slots for op in ops] + [op.active for op in ops]
            + [op.vals for op in ops] + [op.mask for op in ops if op.mask is not None])
    device = _cuda_device(used, "fused_table_commit")
    if device is not None:
        return _commit_cuda(tables, ops, device, entered)
    return fused_table_commit_reference(tables, ops)


# ---------------------------------------------------------------------------
# hash lookup
# ---------------------------------------------------------------------------

lookup_reference = hashmap.lookup


@dataclasses.dataclass
class LookupOp:
    """One probe inside a fused lookup: the ``valid`` keys of ``keys`` [B]
    int64 (any stride: a column of a wider table is read in place) looked
    up in ``tables[table]``."""

    table: int
    keys: torch.Tensor
    valid: torch.Tensor


def fused_lookup_reference(tables: Sequence[HashTable],
                           probes: Sequence[LookupOp]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Plain version: ``hashmap.lookup`` per probe."""
    return [lookup_reference(tables[p.table], p.keys, p.valid) for p in probes]


class _LookupDesc(ctypes.Structure):
    _fields_ = [
        ("tkeys", ctypes.c_void_p), ("tvals", ctypes.c_void_p),
        ("keys", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("found", ctypes.c_void_p), ("vals", ctypes.c_void_p),
        ("key_stride", ctypes.c_int64), ("mask", ctypes.c_uint32),
        ("n", ctypes.c_int32),
    ]


# csrc/hash_lookup.cu's ZB_MAX_LOOKUPS and ZB_LOOKUP_THREADS: the probes
# one launch takes, and a block's threads (one key each)
_MAX_LOOKUPS = 8
_LOOKUP_THREADS = 256
# _LookupDesc's bytes, packed in one call
_LOOKUP_LAYOUT = struct.Struct("<6QqIi")


class _LookupArgs(ctypes.Structure):
    _fields_ = [
        ("d", _LookupDesc * _MAX_LOOKUPS),
        ("start", ctypes.c_int32 * (_MAX_LOOKUPS + 1)),
        ("n_probes", ctypes.c_int32),
    ]


def lookup_plan(lengths: Sequence[int], threads: int = _LOOKUP_THREADS) -> List[int]:
    """The lookup kernel's block plan for probes of ``lengths[j]`` keys (and
    the delete kernel's, with its ``threads``): each probe's first block,
    and one entry more, the grid. A block's ``threads`` threads take one
    key each; a probe of no keys gets no block."""
    starts, block = [], 0
    for n in lengths:
        starts.append(block)
        block += -(-n // threads)
    starts.append(block)
    return starts


def _lookup_args(tables, probes):
    """The kernel's argument block for ``probes``, their (found, vals)
    outputs, and the converted flags the block points at (keep them alive
    to the launch)."""
    if len(probes) > _MAX_LOOKUPS:
        raise ValueError(f"fused_lookup: at most {_MAX_LOOKUPS} probes")
    keep, outs, descs = [], [], []
    for p in probes:
        tkeys, tvals, size = _table_on_cuda(tables[p.table], "lookup")
        keys = p.keys
        n = keys.shape[0]
        if keys.dim() != 1 or keys.dtype is not torch.int64:
            raise ValueError("lookup: keys must be a 1D int64 tensor")
        valid = _as(p.valid, torch.bool)
        if valid.shape != (n,) or n > _I32_MAX:
            raise ValueError("lookup: keys and valid must be [B] tensors of one "
                             "length under 2^31")
        found = keys.new_empty((n,), dtype=torch.bool)
        vals = keys.new_empty((n,), dtype=torch.int32)
        keep.append(valid)
        outs.append((found, vals))
        descs.append((tkeys.data_ptr(), tvals.data_ptr(), keys.data_ptr(),
                      valid.data_ptr(), found.data_ptr(), vals.data_ptr(),
                      keys.stride(0), size - 1, n))
    starts = lookup_plan([d[8] for d in descs])
    args = _LookupArgs()
    for j, d in enumerate(descs):
        _LOOKUP_LAYOUT.pack_into(args, j * _LOOKUP_LAYOUT.size, *d)
    args.start[: len(starts)] = starts
    args.n_probes = len(probes)
    return args, outs, keep


@functools.lru_cache(maxsize=None)
def _lookup_fn():
    return _entry("hash_lookup", "zb_hash_lookup",
                  (ctypes.POINTER(_LookupArgs), ctypes.c_void_p))


def _lookup_cuda(tables, probes, device: torch.device, entered: int = 0):
    with _device_guard(device):
        args, outs, _keep = _lookup_args(tables, probes)
        launched = _lookup_fn()(ctypes.byref(args), _stream(device))
    if launched:
        _count("lookup", launched, entered)
    return outs


def fused_lookup(tables: Sequence[HashTable],
                 probes: Sequence[LookupOp]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[hashmap.lookup(tables[p.table], p.keys, p.valid) for p in probes]``
    — (found [B] bool, vals [B] int32, -1 where not found) per probe, one
    kernel launch for all of them on CUDA tensors (at most 8 probes: the
    independent probes of one step)."""
    entered = _entered()
    probes = list(probes)
    if not probes:
        return []
    used = [t for p in probes
            for t in (tables[p.table].keys, tables[p.table].vals, p.keys, p.valid)]
    device = _cuda_device(used, "lookup")
    if device is not None:
        return _lookup_cuda(tables, probes, device, entered)
    return fused_lookup_reference(tables, probes)


def lookup(table: HashTable, keys: torch.Tensor, valid: torch.Tensor):
    """Batched probe; (found [B] bool, vals [B] int32, -1 where not found),
    identical to ``hashmap.lookup``: the one-probe ``fused_lookup``."""
    return fused_lookup([table], [LookupOp(0, keys, valid)])[0]


# ---------------------------------------------------------------------------
# masked scatters (one table, one op)
# ---------------------------------------------------------------------------


def masked_scatter_reference(table: torch.Tensor, kind: str, slots: torch.Tensor,
                             active: torch.Tensor, vals: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of every masked scatter: one ``TableOp`` applied in
    place with the XLA op chain's semantics (see ``_apply_op_reference``)."""
    _apply_op_reference(table, TableOp(0, kind, slots, active, vals, mask))
    return table


def _scatter_desc(name, table, kind, slots, active, vals, mask):
    """A one-op commit's descriptor, built directly: no stage plan, and
    claim scratch only for a "set". Returns it and the tensors it points at
    (keep them alive to the launch)."""
    _check_table(table, name)
    kind = _kind(table, kind)
    if table.dim() == 2:
        rows, width = table.shape
        if kind == "max":  # as commit_plan: a max merges whole rows
            mask = None
    else:
        rows, width, mask = table.shape[0], 1, None
    keep: list = []
    s, a, v, m, n = _inputs(width, slots, active, vals, mask, keep)
    row_claims = lane_claims = epoch = 0
    if kind == "set":
        scratch, epoch = _claim_scratch(table.device, rows if m is None else rows * width, 1)
        if m is None:
            row_claims = scratch.data_ptr()
        else:
            lane_claims = scratch.data_ptr()
    d = _CommitDesc()
    _COMMIT_LAYOUT.pack_into(d, 0, table.data_ptr(), s, a, v, m or 0, row_claims,
                             lane_claims, rows, width, n, _KINDS[kind], epoch, 0)
    return d, keep


def _scatter_cuda(name, table, kind, slots, active, vals, mask, device, entered=0) -> None:
    with _scratch_lock(device), _device_guard(device):
        d, _keep = _scatter_desc(name, table, kind, slots, active, vals, mask)
        _count(name, _commit_fn()(ctypes.byref(d), 1, _stream(device)), entered)


def _scatter(name, table, kind, slots, active, vals, mask=None) -> torch.Tensor:
    """One masked ``set`` into one int32 table, in place: a one-op table
    commit, its launches counted under ``name``."""
    entered = _entered()
    device = _cuda_device(
        [table, slots, active, vals] + ([] if mask is None else [mask]), name
    )
    if device is not None:
        _scatter_cuda(name, table, kind, slots, active, vals, mask, device, entered)
        return table
    return masked_scatter_reference(table, kind, slots, active, vals, mask)


# ---------------------------------------------------------------------------
# commutative scatters (add, max): csrc/scatter_accum.cu
# ---------------------------------------------------------------------------


class _AccumOp(ctypes.Structure):
    """csrc/scatter_accum.cu's ``AccumOp`` (the layout ``_ACCUM_LAYOUT``
    packs; the tests read a packed call back through it)."""

    _fields_ = [
        ("table", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("active", ctypes.c_void_p), ("vals", ctypes.c_void_p),
        ("mask", ctypes.c_void_p), ("rows", ctypes.c_int32),
        ("width", ctypes.c_int32), ("n", ctypes.c_int32), ("kind", ctypes.c_int32),
    ]


# csrc/scatter_accum.cu's ZB_MAX_ACCUM_OPS and ZB_ACCUM_THREADS: the ops
# one launch takes, and a block's threads (one (record, lane) each)
_MAX_ACCUM_OPS = 8
_ACCUM_THREADS = 256
# a call as the C entry reads it (``AccumCall``): the stream and the op
# count, then the ops; a call of n ops is packed by ``_ACCUM_CALLS[n]`` in
# one go
_ACCUM_HEAD = struct.Struct("<Qi4x")
_ACCUM_LAYOUT = struct.Struct("<5Q4i")
_ACCUM_CALLS = tuple(struct.Struct(_ACCUM_HEAD.format + _ACCUM_LAYOUT.format[1:] * n)
                     for n in range(_MAX_ACCUM_OPS + 1))
_ACCUM_KINDS = {"add": _KINDS["add"], "max": _KINDS["max"]}
_I32, _BOOL = torch.int32, torch.bool


def _accum_fields(name, table, kind, slots, active, vals, mask, keep):
    """One commutative op's packed fields (table, slots, active, vals,
    mask, rows, width, n, kind), checked: an "add" or a "max" into a
    contiguous int32 table (a 1D table only "add"), inputs converted only
    where their dtype or layout is not the kernel's (the copies go to
    ``keep``, alive until the launch is enqueued). A 2D "max" and a 1D
    table ignore the mask, as the JAX chain does. The host work of every
    accumulate call is here: one read of each property it checks."""
    code = _ACCUM_KINDS.get(kind)
    shape = table.shape
    if code is None or table.dtype is not _I32 or not table.is_contiguous():
        raise ValueError(f"{name}: an 'add' or 'max' into a contiguous int32 table "
                         f"(got {kind!r} into {table.dtype})")
    if len(shape) == 2:
        rows, width = shape
        if code == 2:
            mask = None
    elif len(shape) == 1 and code == 1:
        rows, width, mask = shape[0], 1, None
    else:
        raise ValueError(f"{name}: a 2D table, or a 1D table for an 'add' only (the "
                         "JAX chain sets on a 1D 'max')")
    n = slots.shape[0]
    if rows * width > _I32_MAX or n * width > _I32_MAX:
        raise ValueError(f"{name}: the table and the batch must hold under 2^31 elements")
    if slots.dtype is not _I32 or not slots.is_contiguous():
        slots = _slots_i32(slots)
        keep.append(slots)
    if active.dtype is not _BOOL or not active.is_contiguous():
        active = _as(active, _BOOL)
        keep.append(active)
    if vals.dtype is not _I32 or not vals.is_contiguous():
        vals = _as(vals, _I32)
        keep.append(vals)
    m = 0
    if mask is not None:
        if mask.dtype is not _BOOL or not mask.is_contiguous():
            mask = _as(mask, _BOOL)
            keep.append(mask)
        if mask.numel() != n * width:
            raise ValueError(f"{name}: the lane mask must be [B, K] like the values")
        m = mask.data_ptr()
    if active.numel() != n or vals.numel() != n * width:
        raise ValueError(f"{name}: slots, active and vals disagree on the batch or "
                         "the table width")
    return (table.data_ptr(), slots.data_ptr(), active.data_ptr(), vals.data_ptr(), m,
            rows, width, n, code)


@functools.lru_cache(maxsize=None)
def _accum_fn():
    return _entry("scatter_accum", "zb_scatter_accum", (ctypes.c_char_p,))


def _accum_call(name, tables, ops, stream: int, cuda: bool):
    """The packed call of ``ops`` on ``stream`` (the head, then each op's
    fields) and the converted inputs it points at (keep them alive to the
    launch). Checks that a table takes one kind (an add and a max into one
    table do not commute) and, with ``cuda``, that every tensor is on the
    card."""
    n = len(ops)
    if n > _MAX_ACCUM_OPS:
        raise ValueError(f"{name}: at most {_MAX_ACCUM_OPS} ops")
    kinds: Dict[int, str] = {}
    keep: list = []
    fields: list = []
    for op in ops:
        table, slots, active, vals, mask = tables[op.table], op.slots, op.active, op.vals, op.mask
        if cuda and not (table.is_cuda and slots.is_cuda and active.is_cuda and vals.is_cuda
                         and (mask is None or mask.is_cuda)):
            raise ValueError(f"{name}: tensors on mixed or unsupported devices")
        if kinds.setdefault(op.table, op.kind) != op.kind:
            raise ValueError(f"{name}: a table takes one kind in a call (add and max "
                             "do not commute)")
        fields += _accum_fields(name, table, op.kind, slots, active, vals, mask, keep)
    return _ACCUM_CALLS[n].pack(stream, n, *fields), keep


def fused_accumulate_reference(
    tables: Sequence[torch.Tensor], ops: Sequence[TableOp]
) -> List[torch.Tensor]:
    """Plain version: the ops applied one after another, in place (they
    commute)."""
    for op in ops:
        _apply_op_reference(tables[op.table], op)
    return list(tables)


def _accumulate(name, tables, ops) -> List[torch.Tensor]:
    """``fused_accumulate``, its launches counted under ``name``."""
    entered = _entered()
    if not ops:
        return list(tables)
    used = [tables[op.table] for op in ops] + [
        t for op in ops for t in (op.slots, op.active, op.vals, op.mask) if t is not None
    ]
    device = _cuda_device(used, name)
    if device is not None:
        with _device_guard(device):
            # the devices are checked above
            call, _keep = _accum_call(name, tables, ops, _stream(device), False)
            launched = _accum_fn()(call)
        if launched:
            _count(name, launched, entered)
        return list(tables)
    _accum_call(name, tables, ops, 0, False)  # the card's checks
    return fused_accumulate_reference(tables, ops)


def fused_accumulate(
    tables: Sequence[torch.Tensor], ops: Sequence[TableOp]
) -> List[torch.Tensor]:
    """Apply the commutative ``ops`` ("add" and "max" ``TableOp``s, at most
    8, one kind per table) to ``tables`` (contiguous int32, none
    overlapping another) IN PLACE; returns the tables. On CUDA tensors one
    C call enqueues one launch for all of them (a step's independent
    scatters: config 3's two row maxima)."""
    return _accumulate("fused_accumulate", tables, ops)


def _accumulate_one(name, table, kind, slots, active, vals, mask=None) -> torch.Tensor:
    """The one-op ``fused_accumulate`` into ``table``, counted under
    ``name``. On CUDA tensors the call is packed straight from the op's
    fields, without the ``TableOp`` and the op loop (0.7–1.4 µs less host
    work a call on the card: PERF.md §6, PR 8)."""
    entered = _entered()
    device = _cuda_device(
        [table, slots, active, vals] + ([] if mask is None else [mask]), name
    )
    if device is not None:
        keep: list = []
        with _device_guard(device):
            launched = _accum_fn()(_ACCUM_CALLS[1].pack(_stream(device), 1, *_accum_fields(
                name, table, kind, slots, active, vals, mask, keep)))
        if launched:
            _count(name, launched, entered)
        return table
    return _accumulate(name, [table], [TableOp(0, kind, slots, active, vals, mask)])[0]


def masked_row_update(table, slots, active, vals, lane_mask=None) -> torch.Tensor:
    """[T, K] ``table[slots[i]] = vals[i]`` for active records, in place;
    with ``lane_mask`` [B, K] only the masked lanes. The last active writer
    in batch order wins per row (per (row, lane) with a mask)."""
    return _scatter("masked_row_update", table, "set", slots, active, vals, lane_mask)


def masked_row_max(table, slots, active, vals) -> torch.Tensor:
    """[T, K] ``table[slots[i]] = maximum(table[slots[i]], vals[i])`` for
    active records, in place (max commutes: batch order does not matter)."""
    return _accumulate_one("masked_row_max", table, "max", slots, active, vals)


def masked_row_add(table, slots, active, vals, lane_mask=None) -> torch.Tensor:
    """[T, K] ``table[slots[i], lane] += vals[i, lane]`` for active records
    and masked lanes, in place (integer addition commutes)."""
    return _accumulate_one("masked_row_add", table, "add", slots, active, vals, lane_mask)


def masked_lane_update(table1d, slots, active, vals) -> torch.Tensor:
    """1D int32 ``table[slots[i]] = vals[i]``, last active writer wins, in place."""
    return _scatter("masked_lane_update", table1d, "set", slots, active, vals)


def masked_lane_accum(table1d, slots, active, deltas) -> torch.Tensor:
    """1D int32 ``table[slots[i]] += deltas[i]`` for active records, in place."""
    return _accumulate_one("masked_lane_accum", table1d, "add", slots, active, deltas)


def masked_vec64_update(table1d, slots, active, vals64) -> torch.Tensor:
    """1D int64 ``table[slots[i]] = vals64[i]``, last active writer wins, in
    place: a row update of the [T, 2] int32 lo/hi planes, as the JAX op
    does (rows stay whole, so the result is the int64 set's)."""
    planes = table1d.view(torch.int32).view(table1d.shape[0], 2)
    v = vals64.to(torch.int64).contiguous().view(torch.int32).view(-1, 2)
    _scatter("masked_vec64_update", planes, "set", slots, active, v)
    return table1d


# ---------------------------------------------------------------------------
# hash insert / delete
# ---------------------------------------------------------------------------

insert_reference = hashmap.insert
delete_reference = hashmap.delete


def _table_on_cuda(table: HashTable, what: str):
    tkeys, tvals = table.keys, table.vals
    size = tkeys.shape[0]
    if (tkeys.dtype != torch.int64 or tvals.dtype != torch.int32
            or not tkeys.is_contiguous() or not tvals.is_contiguous()
            or tkeys.dim() != 1 or tvals.shape != (size,)
            or size == 0 or size & (size - 1) or size > 2**32):
        raise ValueError(f"{what}: the table must be contiguous int64 keys and "
                         "int32 vals of one power-of-two size")
    return tkeys, tvals, size


# csrc/hash_update.cu's ZB_INSERT_BLOCKS: the blocks of the insert's cluster
_INSERT_BLOCKS = 16


def insert_plan(n: int) -> int:
    """The insert kernel's split of ``n`` keys: block b of the cluster owns
    keys [b * share, (b + 1) * share) (the last blocks fewer, or none), and
    keeps its pending keys in two worklists of ``share`` (rank, bucket)
    pairs each. Returns ``share``."""
    return -(-n // _INSERT_BLOCKS)


# per-device worklist scratch of the insert kernel, 2 * _INSERT_BLOCKS *
# share pairs of int32 as int64 words; grown when a call needs more. Its
# users serialise on the stream; ``_scratch_lock`` covers a growth that
# would free the buffer a granted, not yet enqueued insert writes
_worklists: Dict[torch.device, torch.Tensor] = {}


def _worklist_scratch(device: torch.device, pairs: int) -> torch.Tensor:
    worklists = _scratch()[1]
    buf = worklists.get(device)
    if buf is None or buf.numel() < pairs:
        buf = torch.empty((max(pairs, 1),), dtype=torch.int64, device=device)
        worklists[device] = buf
    return buf


class _InsertArgs(ctypes.Structure):
    _fields_ = [
        ("tkeys", ctypes.c_void_p), ("tvals", ctypes.c_void_p),
        ("keys", ctypes.c_void_p), ("vals", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("ok", ctypes.c_void_p),
        ("claims", ctypes.c_void_p), ("work", ctypes.c_void_p),
        ("key_stride", ctypes.c_int64), ("epoch", ctypes.c_uint64),
        ("mask", ctypes.c_uint32), ("n", ctypes.c_int32),
        ("share", ctypes.c_int32), ("rounds", ctypes.c_int32),
    ]


# _InsertArgs's bytes, packed in one call
_INSERT_LAYOUT = struct.Struct("<8QqQI3i")


def _insert_args(table: HashTable, keys, vals, valid, rounds: int = hashmap.MAX_PROBES):
    """The insert kernel's argument block (at most ``rounds`` rounds; the
    wrapper runs MAX_PROBES), its ``ok`` output, and the converted inputs
    the block points at (keep them alive to the launch)."""
    tkeys, tvals, size = _table_on_cuda(table, "insert")
    n = keys.shape[0]
    if keys.dim() != 1 or vals.shape != (n,) or valid.shape != (n,):
        raise ValueError("insert: keys, vals and valid must be [B] tensors of one length")
    if n >= 2**31:
        raise ValueError("insert: at most 2^31 - 1 keys per call")
    if keys.dtype is not torch.int64:
        keys = keys.to(torch.int64)  # the kernel reads any stride
    vals, valid = _as(vals, torch.int32), _as(valid, torch.bool)
    ok = keys.new_empty((n,), dtype=torch.bool)
    share = insert_plan(n)
    work = _worklist_scratch(keys.device, 2 * _INSERT_BLOCKS * share)
    # two halves: round r claims into half r % 2 (csrc/hash_update.cu)
    claims, epoch = _claim_scratch(keys.device, 2 * size, rounds)
    args = _InsertArgs()
    _INSERT_LAYOUT.pack_into(args, 0, tkeys.data_ptr(), tvals.data_ptr(), keys.data_ptr(),
                             vals.data_ptr(), valid.data_ptr(), ok.data_ptr(),
                             claims.data_ptr(), work.data_ptr(), keys.stride(0), epoch,
                             size - 1, n, share, rounds)
    return args, ok, (keys, vals, valid)


@functools.lru_cache(maxsize=None)
def _insert_fn():
    return _entry("hash_update", "zb_hash_insert",
                  (ctypes.POINTER(_InsertArgs), ctypes.c_void_p))


def _insert_cuda(table: HashTable, keys, vals, valid, device: torch.device,
                 entered: int = 0) -> torch.Tensor:
    with _scratch_lock(device), _device_guard(device):
        args, ok, _keep = _insert_args(table, keys, vals, valid)
        launched = _insert_fn()(ctypes.byref(args), _stream(device))
        if launched:
            _count("insert", launched, entered)
    return ok


def insert(table: HashTable, keys: torch.Tensor, vals: torch.Tensor,
           valid: torch.Tensor):
    """Batched insert of unique keys, IN PLACE: returns (table, ok [B]
    bool), the bucket layout of ``hashmap.insert`` (its round-synchronous
    lowest-rank claims). ``ok`` is False where a key found no free bucket
    within MAX_PROBES."""
    entered = _entered()
    device = _cuda_device([table.keys, table.vals, keys, vals, valid], "insert")
    if device is not None:
        return table, _insert_cuda(table, keys, vals, valid, device, entered)
    new, ok = insert_reference(table, keys, vals, valid)
    table.keys.copy_(new.keys)
    table.vals.copy_(new.vals)
    return table, ok


@dataclasses.dataclass
class DeleteOp:
    """One delete inside a fused delete: the ``valid`` keys of ``keys`` [B]
    int64 (any stride: a column of a wider table is read in place) deleted
    from ``tables[table]``."""

    table: int
    keys: torch.Tensor
    valid: torch.Tensor


def fused_delete_reference(tables: Sequence[HashTable], deletes: Sequence[DeleteOp]) -> None:
    """Plain version, in place: ``hashmap.delete`` applied op after op. The
    kernel runs the ops side by side; the two agree wherever the ops on one
    table hold distinct keys, which every caller guarantees (a step's
    deletes go to different maps, and an engine's keys are held at most
    once)."""
    for op in deletes:
        t = tables[op.table]
        t.keys.copy_(delete_reference(t, op.keys, op.valid).keys)


class _DeleteDesc(ctypes.Structure):
    _fields_ = [
        ("tkeys", ctypes.c_void_p), ("keys", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("key_stride", ctypes.c_int64),
        ("mask", ctypes.c_uint32), ("n", ctypes.c_int32),
    ]


# csrc/hash_update.cu's ZB_MAX_DELETES, ZB_DELETE_THREADS and
# ZB_DELETE_GROUP: the deletes one launch takes, a block's threads (one key
# each; the plan is lookup_plan's), and the lanes that walk one key together
_MAX_DELETES = 8
_DELETE_THREADS = 256
_DELETE_GROUP = 8
# _DeleteDesc's bytes, packed in one call
_DELETE_LAYOUT = struct.Struct("<3QqIi")


class _DeleteArgs(ctypes.Structure):
    _fields_ = [
        ("d", _DeleteDesc * _MAX_DELETES),
        ("start", ctypes.c_int32 * (_MAX_DELETES + 1)),
        ("n_ops", ctypes.c_int32),
    ]


def _delete_args(tables, deletes):
    """The kernel's argument block for ``deletes`` and the converted keys
    and flags it points at (keep them alive to the launch)."""
    if len(deletes) > _MAX_DELETES:
        raise ValueError(f"fused_delete: at most {_MAX_DELETES} deletes")
    keep, descs = [], []
    for op in deletes:
        tkeys, _tvals, size = _table_on_cuda(tables[op.table], "delete")
        keys = op.keys
        n = keys.shape[0]
        if keys.dim() != 1 or op.valid.shape != (n,) or n > _I32_MAX:
            raise ValueError("delete: keys and valid must be [B] tensors of one "
                             "length under 2^31")
        if keys.dtype is not torch.int64:
            keys = keys.to(torch.int64)  # the kernel reads any stride
        valid = _as(op.valid, torch.bool)
        keep.append((keys, valid))
        descs.append((tkeys.data_ptr(), keys.data_ptr(), valid.data_ptr(), keys.stride(0),
                      size - 1, n))
    starts = lookup_plan([d[5] for d in descs], _DELETE_THREADS)
    args = _DeleteArgs()
    for j, d in enumerate(descs):
        _DELETE_LAYOUT.pack_into(args, j * _DELETE_LAYOUT.size, *d)
    args.start[: len(starts)] = starts
    args.n_ops = len(deletes)
    return args, keep


@functools.lru_cache(maxsize=None)
def _delete_fn():
    return _entry("hash_update", "zb_hash_delete",
                  (ctypes.POINTER(_DeleteArgs), ctypes.c_void_p))


def _delete_cuda(tables, deletes, device: torch.device, entered: int = 0) -> None:
    with _device_guard(device):
        args, _keep = _delete_args(tables, deletes)
        launched = _delete_fn()(ctypes.byref(args), _stream(device))
    if launched:
        _count("delete", launched, entered)


def fused_delete(tables: Sequence[HashTable], deletes: Sequence[DeleteOp]) -> None:
    """``hashmap.delete(tables[op.table], op.keys, op.valid)`` for every op,
    IN PLACE: each valid key's bucket becomes a TOMBSTONE, values are
    untouched. One kernel launch for all of them on CUDA tensors (at most 8
    deletes: a step's maps), counted under ``delete``. The ops on one table
    must hold distinct keys (``fused_delete_reference``)."""
    entered = _entered()
    deletes = list(deletes)
    if not deletes:
        return
    used = [t for op in deletes
            for t in (tables[op.table].keys, tables[op.table].vals, op.keys, op.valid)]
    device = _cuda_device(used, "delete")
    if device is not None:
        _delete_cuda(tables, deletes, device, entered)
    else:
        fused_delete_reference(tables, deletes)


def delete(table: HashTable, keys: torch.Tensor, valid: torch.Tensor) -> HashTable:
    """Batched delete, IN PLACE: each valid key's bucket becomes a
    TOMBSTONE, as ``hashmap.delete`` computes; values are untouched. The
    one-op ``fused_delete``."""
    fused_delete([table], [DeleteOp(0, keys, valid)])
    return table


# ---------------------------------------------------------------------------
# boot self-check
# ---------------------------------------------------------------------------

# the CUDA devices (by index) whose self-check passed in this process
_SELFCHECKED: set = set()


def _plain_set(table: torch.Tensor, slots, active, vals) -> torch.Tensor:
    """The self-check's plain scatter: ``table[slots] = vals`` for active
    records on a copy (the self-check's slots are distinct)."""
    out = table.clone()
    out[slots[active].to(torch.int64)] = vals[active].to(out.dtype)
    return out


def _plain_add(table: torch.Tensor, slots, active, vals) -> torch.Tensor:
    out = table.clone()
    out.index_put_((slots[active].to(torch.int64),), vals[active].to(out.dtype),
                   accumulate=True)
    return out


def _selfcheck_on(device) -> None:
    """Hold the insert, lookup, delete, row-update, lane-update and
    lane-accumulate kernels against their plain versions on ``device``, bit
    for bit, at the shapes and seed of ``pallas_ops.selfcheck`` in the JAX
    package. Raises ``RuntimeError`` on any difference."""
    import numpy as np

    dev = torch.device(device)
    rng = np.random.default_rng(11)
    t, b, k = 1 << 10, 1 << 8, 16

    def on(a, dtype=None):
        out = torch.from_numpy(np.asarray(a)).to(dev)
        return out if dtype is None else out.to(dtype)

    def eq(name, a, b_):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b_ = b_.cpu().numpy() if isinstance(b_, torch.Tensor) else np.asarray(b_)
        if a.shape != b_.shape or not (a == b_).all():
            raise RuntimeError(
                f"kernel selfcheck MISMATCH [{name}]: refusing to serve "
                f"({a.ravel()[:4]} vs {b_.ravel()[:4]})"
            )

    def sorted_keys(table):
        return torch.sort(table.keys).values

    table = hashmap.make(t, device=dev)
    keys = on(rng.choice(np.arange(1, 8 * t, 3, dtype=np.int64), b, replace=False))
    vals = torch.arange(b, dtype=torch.int32, device=dev)
    valid = on(rng.random(b) < 0.8)
    t_x, ok_x = hashmap.insert(table, keys, vals, valid)
    t_p = HashTable(table.keys.clone(), table.vals.clone())
    t_p, ok_p = insert(t_p, keys, vals, valid)
    eq("insert keyset", sorted_keys(t_x), sorted_keys(t_p))
    eq("insert ok", ok_x, ok_p)
    fx, sx = hashmap.lookup(t_p, keys, valid)
    fp, sp = lookup(t_p, keys, valid)
    eq("lookup found", fx, fp)
    eq("lookup slots", torch.where(fx, sx, -1), torch.where(fp, sp, -1))
    d_x = hashmap.delete(t_x, keys, valid)
    d_p = delete(t_p, keys, valid)
    eq("delete keyset", sorted_keys(d_x), sorted_keys(d_p))

    tbl = on(rng.integers(0, 100, (t, k)), torch.int32)
    slots = on(rng.choice(t, b, replace=False), torch.int32)
    active = on(rng.random(b) < 0.7)
    rows = on(rng.integers(0, 1000, (b, k)), torch.int32)
    eq("row update", _plain_set(tbl, slots, active, rows),
       masked_row_update(tbl.clone(), slots, active, rows))

    t1 = on(rng.integers(0, 100, (t,)), torch.int32)
    lvals = on(rng.integers(0, 9, (b,)), torch.int32)
    eq("lane update", _plain_set(t1, slots, active, lvals),
       masked_lane_update(t1.clone(), slots, active, lvals))
    eq("lane accum", _plain_add(t1, slots, active, lvals),
       masked_lane_accum(t1.clone(), slots, active, lvals))


def selfcheck(device=None) -> None:
    """The boot self-check (``pallas_ops.selfcheck`` in the JAX package):
    run once per process and card before a CUDA-backed engine serves there,
    so a kernel that computes wrong on that card refuses to serve instead
    of corrupting partition state. ``device`` is the card (default: the
    current one). Nothing to check without a CUDA device: the CPU runs the
    plain versions themselves."""
    if not torch.cuda.is_available():
        return
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index in _SELFCHECKED:
        return
    _selfcheck_on(device)
    _SELFCHECKED.add(device.index)
