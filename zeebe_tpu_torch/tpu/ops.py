"""The step kernel's table primitives: CUDA kernels and their plain versions.

Counterpart of ``zeebe_tpu.tpu.pallas_ops`` for the primitives the ported
paths run (the order-process graph with every feature gate off, and the
parallel fork/join graph):

- ``fused_gather_rows``  ↔ ``pallas_ops.fused_gather_rows`` (csrc/gather_rows.cu)
- ``fused_table_commit`` ↔ ``pallas_ops.fused_table_commit`` (csrc/table_commit.cu)
- ``lookup``             ↔ ``pallas_ops.lookup`` (csrc/hash_lookup.cu)
- ``masked_row_update``, ``masked_row_max``, ``masked_row_add``,
  ``masked_lane_update``, ``masked_lane_accum``, ``masked_vec64_update``
  ↔ the ``pallas_ops`` functions of the same names: one-op table commits
  (csrc/table_commit.cu)
- ``insert``, ``delete`` ↔ ``pallas_ops.insert`` / ``delete``
  (csrc/hash_update.cu)

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain PyTorch version beside each kernel (``*_reference``); CUDA tensors
launch the hand-written kernel, or the call raises. There is no fallback
from a CUDA tensor to the plain version. ``LAUNCHES`` counts the wrapper
calls that reach the GPU, ``DEVICE_LAUNCHES`` the kernels they enqueue
(a table commit is a pass or two per stage of ``commit_plan``). The
launch plans (``gather_plan``, ``commit_plan``) are built here, in
Python, so the CPU tests reach them.

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

import ctypes
import dataclasses
import functools
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from zeebe_tpu_torch import _build
from zeebe_tpu_torch.tpu import hashmap
from zeebe_tpu_torch.tpu.hashmap import HashTable

# kernel launches per wrapper (one per wrapper call that reaches the GPU);
# chip_smoke.py zeroes these before driving the main path and reads them
# after
LAUNCHES: Dict[str, int] = {
    "fused_gather_rows": 0, "fused_table_commit": 0, "lookup": 0,
    "masked_row_update": 0, "masked_row_max": 0, "masked_row_add": 0,
    "masked_lane_update": 0, "masked_lane_accum": 0, "masked_vec64_update": 0,
    "insert": 0, "delete": 0,
}
# device kernel launches the same calls enqueued: one a call, but for the
# table commits (a pass or two per stage of the op list: commit_plan)
DEVICE_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for counts in (LAUNCHES, DEVICE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _count(name: str, launched: int) -> None:
    """Count a call that reached the GPU and the ``launched`` kernels its C
    entry enqueued; a negative ``launched`` is minus a CUDA error."""
    if launched < 0:
        raise RuntimeError(f"{name}: CUDA error {-launched} at launch")
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[name] += launched


def _on_cuda(tensors: Sequence[torch.Tensor], what: str) -> bool:
    """True when every tensor is on a CUDA device, False when every one is
    on the CPU; a mix raises."""
    cuda = [t.is_cuda for t in tensors]
    if all(cuda):
        return True
    if not any(cuda) and all(t.device.type == "cpu" for t in tensors):
        return False
    kinds = sorted({t.device.type for t in tensors})
    raise ValueError(f"{what}: tensors on mixed or unsupported devices {kinds}")


def _stream() -> int:
    """The raw handle of the current device's current stream, the one
    PyTorch launches its own kernels on (CUDA is initialised: the caller
    holds CUDA tensors)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


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


def _gather_cuda(tables, ops) -> List[torch.Tensor]:
    args, outs, _keep = _gather_args(tables, ops)
    launched = _gather_fn()(ctypes.byref(args), _stream())
    if launched:
        _count("fused_gather_rows", launched)
    return outs


def fused_gather_rows(
    tables: Sequence[torch.Tensor], ops: Sequence[GatherOp]
) -> List[torch.Tensor]:
    """``[tables[op.table][op.slots] for op in ops]`` — one kernel launch
    for all ops on CUDA tensors. Tables may be of any dtype, 1D or 2D, and
    1D tables may be strided views (a column of a wider table); results are
    bit-exact copies of the rows."""
    ops = list(ops)
    if not ops:
        return []
    used = [tables[op.table] for op in ops] + [op.slots for op in ops]
    if _on_cuda(used, "fused_gather_rows"):
        return _gather_cuda(tables, ops)
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
# when the 32-bit epoch space wraps
_claims: Dict[torch.device, list] = {}


def _claim_scratch(device: torch.device, words: int, epochs: int):
    entry = _claims.get(device)
    if entry is None or entry[0].numel() < words:
        entry = [torch.zeros(max(words, 1), dtype=torch.int64, device=device), 0]
        _claims[device] = entry
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


def _commit_cuda(tables, ops) -> List[torch.Tensor]:
    descs, _keep = _commit_descs(tables, ops)
    _count("fused_table_commit", _commit_fn()(descs, len(ops), _stream()))
    return list(tables)


def fused_table_commit(
    tables: Sequence[torch.Tensor], ops: Sequence[TableOp]
) -> List[torch.Tensor]:
    """Apply ``ops`` to ``tables`` (all int32, none overlapping another;
    int64 state enters as ``.view(torch.int32)`` planes) in list order, IN
    PLACE; returns the tables in input order. On CUDA tensors one C call
    enqueues the whole list: a pass or two per stage of ``commit_plan``."""
    ops = list(ops)
    if not ops:
        return list(tables)
    used = list(tables) + [op.slots for op in ops] + [op.vals for op in ops]
    if _on_cuda(used, "fused_table_commit"):
        return _commit_cuda(tables, ops)
    return fused_table_commit_reference(tables, ops)


# ---------------------------------------------------------------------------
# hash lookup
# ---------------------------------------------------------------------------

lookup_reference = hashmap.lookup


def _lookup_cuda(table: HashTable, keys: torch.Tensor, valid: torch.Tensor):
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = _entry("hash_lookup", "zb_hash_lookup", (p, p, i64, p, i64, p, i64, p, p, p))
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise ValueError("lookup: keys must be a 1D int64 tensor")
    tkeys = table.keys.contiguous()
    tvals = table.vals.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    n = keys.shape[0]
    found = torch.empty((n,), dtype=torch.bool, device=keys.device)
    vals = torch.empty((n,), dtype=torch.int32, device=keys.device)
    _build.check(
        fn(tkeys.data_ptr(), tvals.data_ptr(), tkeys.shape[0], keys.data_ptr(),
           keys.stride(0), valid.data_ptr(), n, found.data_ptr(),
           vals.data_ptr(), _stream()),
        "lookup",
    )
    _count("lookup", 1)
    return found, vals


def lookup(table: HashTable, keys: torch.Tensor, valid: torch.Tensor):
    """Batched probe; (found [B] bool, vals [B] int32, -1 where not found),
    identical to ``hashmap.lookup``."""
    if _on_cuda([table.keys, table.vals, keys, valid], "lookup"):
        return _lookup_cuda(table, keys, valid)
    return lookup_reference(table, keys, valid)


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


def _scatter_cuda(name, table, kind, slots, active, vals, mask) -> None:
    d, _keep = _scatter_desc(name, table, kind, slots, active, vals, mask)
    _count(name, _commit_fn()(ctypes.byref(d), 1, _stream()))


def _scatter(name, table, kind, slots, active, vals, mask=None) -> torch.Tensor:
    """One masked scatter into one int32 table, in place: a one-op table
    commit, its launches counted under ``name``."""
    if (table.is_cuda and slots.is_cuda and active.is_cuda and vals.is_cuda
            and (mask is None or mask.is_cuda)):
        _scatter_cuda(name, table, kind, slots, active, vals, mask)
        return table
    _on_cuda([table, slots, active, vals] + ([] if mask is None else [mask]), name)
    return masked_scatter_reference(table, kind, slots, active, vals, mask)


def masked_row_update(table, slots, active, vals, lane_mask=None) -> torch.Tensor:
    """[T, K] ``table[slots[i]] = vals[i]`` for active records, in place;
    with ``lane_mask`` [B, K] only the masked lanes. The last active writer
    in batch order wins per row (per (row, lane) with a mask)."""
    return _scatter("masked_row_update", table, "set", slots, active, vals, lane_mask)


def masked_row_max(table, slots, active, vals) -> torch.Tensor:
    """[T, K] ``table[slots[i]] = maximum(table[slots[i]], vals[i])`` for
    active records, in place (max commutes: batch order does not matter)."""
    return _scatter("masked_row_max", table, "max", slots, active, vals)


def masked_row_add(table, slots, active, vals, lane_mask=None) -> torch.Tensor:
    """[T, K] ``table[slots[i], lane] += vals[i, lane]`` for active records
    and masked lanes, in place (integer addition commutes)."""
    return _scatter("masked_row_add", table, "add", slots, active, vals, lane_mask)


def masked_lane_update(table1d, slots, active, vals) -> torch.Tensor:
    """1D int32 ``table[slots[i]] = vals[i]``, last active writer wins, in place."""
    return _scatter("masked_lane_update", table1d, "set", slots, active, vals)


def masked_lane_accum(table1d, slots, active, deltas) -> torch.Tensor:
    """1D int32 ``table[slots[i]] += deltas[i]`` for active records, in place."""
    return _scatter("masked_lane_accum", table1d, "add", slots, active, deltas)


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

# per-device [MAX_PROBES + 1] round counters of the insert kernel (see
# csrc/hash_update.cu: the kernel zeroes each before its use)
_insert_counters: Dict[torch.device, torch.Tensor] = {}


def _table_on_cuda(table: HashTable, what: str):
    tkeys, tvals = table.keys, table.vals
    size = tkeys.shape[0]
    if (tkeys.dtype != torch.int64 or tvals.dtype != torch.int32
            or not tkeys.is_contiguous() or not tvals.is_contiguous()
            or tvals.shape[0] != size or size & (size - 1)):
        raise ValueError(f"{what}: the table must be contiguous int64 keys and "
                         "int32 vals of one power-of-two size")
    return tkeys, tvals, size


def _insert_cuda(table: HashTable, keys, vals, valid) -> torch.Tensor:
    tkeys, tvals, size = _table_on_cuda(table, "insert")
    n = keys.shape[0]
    if keys.dim() != 1 or vals.shape != (n,) or valid.shape != (n,):
        raise ValueError("insert: keys, vals and valid must be [B] tensors of one length")
    ok = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return ok
    if n >= 2**31:
        raise ValueError("insert: at most 2^31 - 1 keys per call")
    keys = keys.to(torch.int64).contiguous()
    vals = vals.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    probe = torch.empty((n,), dtype=torch.int32, device=keys.device)
    scratch, epoch = _claim_scratch(keys.device, size, hashmap.MAX_PROBES)
    counters = _insert_counters.get(keys.device)
    if counters is None:
        counters = torch.zeros((hashmap.MAX_PROBES + 1,), dtype=torch.int32,
                               device=keys.device)
        _insert_counters[keys.device] = counters
    p = ctypes.c_void_p
    fn = _entry("hash_update", "zb_hash_insert",
                (p, p, ctypes.c_int64, p, p, p, ctypes.c_int64, p, p, p,
                 ctypes.c_uint64, p, p))
    _build.check(
        fn(tkeys.data_ptr(), tvals.data_ptr(), size, keys.data_ptr(),
           vals.data_ptr(), valid.data_ptr(), n, probe.data_ptr(), ok.data_ptr(),
           scratch.data_ptr(), epoch, counters.data_ptr(), _stream()),
        "insert",
    )
    _count("insert", 1)
    return ok


def insert(table: HashTable, keys: torch.Tensor, vals: torch.Tensor,
           valid: torch.Tensor):
    """Batched insert of unique keys, IN PLACE: returns (table, ok [B]
    bool), the bucket layout of ``hashmap.insert`` (its round-synchronous
    lowest-rank claims). ``ok`` is False where a key found no free bucket
    within MAX_PROBES."""
    if _on_cuda([table.keys, table.vals, keys, vals, valid], "insert"):
        return table, _insert_cuda(table, keys, vals, valid)
    new, ok = insert_reference(table, keys, vals, valid)
    table.keys.copy_(new.keys)
    table.vals.copy_(new.vals)
    return table, ok


def _delete_cuda(table: HashTable, keys, valid) -> None:
    tkeys, _tvals, size = _table_on_cuda(table, "delete")
    n = keys.shape[0]
    if keys.dim() != 1 or valid.shape != (n,):
        raise ValueError("delete: keys and valid must be [B] tensors of one length")
    if n == 0:
        return
    keys = keys.to(torch.int64).contiguous()
    valid = valid.to(torch.bool).contiguous()
    p = ctypes.c_void_p
    fn = _entry("hash_update", "zb_hash_delete",
                (p, ctypes.c_int64, p, p, ctypes.c_int64, p))
    _build.check(fn(tkeys.data_ptr(), size, keys.data_ptr(), valid.data_ptr(), n,
                    _stream()), "delete")
    _count("delete", 1)


def delete(table: HashTable, keys: torch.Tensor, valid: torch.Tensor) -> HashTable:
    """Batched delete, IN PLACE: each valid key's bucket becomes a
    TOMBSTONE, as ``hashmap.delete`` computes; values are untouched."""
    if _on_cuda([table.keys, table.vals, keys, valid], "delete"):
        _delete_cuda(table, keys, valid)
    else:
        table.keys.copy_(delete_reference(table, keys, valid).keys)
    return table


# ---------------------------------------------------------------------------
# boot self-check
# ---------------------------------------------------------------------------

_SELFCHECK_PASSED = False


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


def selfcheck() -> None:
    """The boot self-check (``pallas_ops.selfcheck`` in the JAX package):
    run once per process before a CUDA-backed engine serves, so a kernel
    that computes wrong on this card refuses to serve instead of corrupting
    partition state. Nothing to check without a CUDA device: the CPU runs
    the plain versions themselves."""
    global _SELFCHECK_PASSED
    if _SELFCHECK_PASSED or not torch.cuda.is_available():
        return
    _selfcheck_on(torch.device("cuda", torch.cuda.current_device()))
    _SELFCHECK_PASSED = True
