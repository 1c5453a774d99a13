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
from a CUDA tensor to the plain version. ``LAUNCHES`` counts kernel
launches per wrapper (one per wrapper call that reaches the GPU).

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
from typing import Dict, List, Optional, Sequence

import torch

from zeebe_tpu_torch import _build
from zeebe_tpu_torch.tpu import hashmap
from zeebe_tpu_torch.tpu.hashmap import HashTable

# kernel launches per wrapper; chip_smoke.py zeroes these before driving
# the main path and reads them after
LAUNCHES: Dict[str, int] = {
    "fused_gather_rows": 0, "fused_table_commit": 0, "lookup": 0,
    "masked_row_update": 0, "masked_row_max": 0, "masked_row_add": 0,
    "masked_lane_update": 0, "masked_lane_accum": 0, "masked_vec64_update": 0,
    "insert": 0, "delete": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(tensors: Sequence[torch.Tensor], what: str) -> bool:
    """True when every tensor is on a CUDA device, False when every one is
    on the CPU; a mix raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"{what}: tensors on mixed or unsupported devices {kinds}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


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
        ("table", ctypes.c_void_p), ("row_stride", ctypes.c_int64),
        ("row_bytes", ctypes.c_int64), ("rows", ctypes.c_int64),
        ("slots", ctypes.c_void_p), ("n", ctypes.c_int64),
        ("out", ctypes.c_void_p),
    ]


_MAX_GATHER_OPS = 32


def _gather_cuda(tables, ops) -> List[torch.Tensor]:
    if len(ops) > _MAX_GATHER_OPS:
        raise ValueError(f"fused_gather_rows: at most {_MAX_GATHER_OPS} ops")
    fn = _entry("gather_rows", "zb_gather_rows",
                (ctypes.POINTER(_GatherDesc), ctypes.c_int, ctypes.c_int64,
                 ctypes.c_void_p))
    descs = (_GatherDesc * len(ops))()
    keep = []
    outs = []
    max_units = 0
    for j, op in enumerate(ops):
        t = tables[op.table]
        if t.dim() not in (1, 2) or t.shape[0] == 0:
            raise ValueError("fused_gather_rows: tables must be non-empty 1D/2D")
        if t.dim() == 2 and t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("fused_gather_rows: 2D rows must be contiguous")
        slots = op.slots.to(torch.int32).contiguous()
        keep.append(slots)
        n = slots.shape[0]
        es = t.element_size()
        row_bytes = es * (t.shape[1] if t.dim() == 2 else 1)
        out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        outs.append(out)
        descs[j] = _GatherDesc(
            t.data_ptr(), es * t.stride(0), row_bytes, t.shape[0],
            slots.data_ptr(), n, out.data_ptr(),
        )
        max_units = max(max_units, n * row_bytes)
    if max_units > 0:
        _build.check(fn(descs, len(ops), max_units, _stream()),
                     "fused_gather_rows")
        LAUNCHES["fused_gather_rows"] += 1
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


def _kind(tbl: torch.Tensor, op: TableOp) -> str:
    """The op's effective kind: the JAX chain routes a 1D table's op to a
    lane accumulate for "add" and to a lane SET for anything else."""
    if op.kind not in _KINDS:
        raise ValueError(f"fused_table_commit: unknown op kind {op.kind!r}")
    if tbl.dim() == 1 and op.kind != "add":
        return "set"
    return op.kind


def _apply_op_reference(tbl: torch.Tensor, op: TableOp) -> None:
    """One TableOp, in place, with the XLA op chain's semantics."""
    rows = tbl.shape[0]
    kind = _kind(tbl, op)
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


class _CommitDesc(ctypes.Structure):
    _fields_ = [
        ("table", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("active", ctypes.c_void_p), ("vals", ctypes.c_void_p),
        ("mask", ctypes.c_void_p), ("rows", ctypes.c_int64),
        ("width", ctypes.c_int64), ("n", ctypes.c_int64),
        ("kind", ctypes.c_int64), ("epoch", ctypes.c_uint64),
    ]


_KINDS = {"set": 0, "add": 1, "max": 2}
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


def _commit_cuda(tables, ops, name: str = "fused_table_commit") -> List[torch.Tensor]:
    fn = _entry("table_commit", "zb_table_commit",
                (ctypes.POINTER(_CommitDesc), ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p))
    for t in tables:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.dim() not in (1, 2):
            raise ValueError(
                f"{name}: tables must be contiguous int32 1D/2D "
                "(int64 tables enter as .view(torch.int32) planes)"
            )
    kinds = [_kind(tables[op.table], op) for op in ops]
    sets = [op for op, kind in zip(ops, kinds) if kind == "set"]
    words = max(
        (tables[op.table].numel() if op.mask is not None else tables[op.table].shape[0]
         for op in sets), default=1,
    )
    device = tables[ops[0].table].device
    scratch, epoch = _claim_scratch(device, words, len(sets))
    descs = (_CommitDesc * len(ops))()
    keep = []
    for k, (op, kind) in enumerate(zip(ops, kinds)):
        t = tables[op.table]
        width = t.shape[1] if t.dim() == 2 else 1
        n = op.slots.shape[0]
        slots = op.slots
        if slots.dtype != torch.int32:  # out of int32 range is dropped anyway
            slots = slots.to(torch.int64).clamp(-2**31, 2**31 - 1)
        slots = slots.to(torch.int32).contiguous()
        active = op.active.to(torch.bool).contiguous()
        vals = op.vals.to(torch.int32).reshape(n, width).contiguous()
        mask = None
        if op.mask is not None and kind != "max":  # max merges whole rows
            mask = op.mask.to(torch.bool).reshape(n, width).contiguous()
        keep += [slots, active, vals, mask]
        op_epoch = 0
        if kind == "set":
            op_epoch = epoch
            epoch += 1
        descs[k] = _CommitDesc(
            t.data_ptr(), slots.data_ptr(), active.data_ptr(), vals.data_ptr(),
            None if mask is None else mask.data_ptr(), t.shape[0], width, n,
            _KINDS[kind], op_epoch,
        )
    _build.check(fn(descs, len(ops), scratch.data_ptr(), _stream()), name)
    LAUNCHES[name] += 1
    return list(tables)


def fused_table_commit(
    tables: Sequence[torch.Tensor], ops: Sequence[TableOp]
) -> List[torch.Tensor]:
    """Apply ``ops`` to ``tables`` (all int32; int64 state enters as
    ``.view(torch.int32)`` planes) in list order, IN PLACE; returns the
    tables in input order. One kernel-launch call for the whole list on
    CUDA tensors."""
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
    LAUNCHES["lookup"] += 1
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


def _scatter(name, table, kind, slots, active, vals, mask=None) -> torch.Tensor:
    """One masked scatter into one int32 table, in place: a one-op table
    commit, its launches counted under ``name``."""
    if _on_cuda([table, slots, active, vals] + ([] if mask is None else [mask]), name):
        _commit_cuda([table], [TableOp(0, kind, slots, active, vals, mask)], name)
        return table
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
    LAUNCHES["insert"] += 1
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
    LAUNCHES["delete"] += 1


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
