"""The gather kernel's host-side plan, on the CPU: what
``csrc/gather_rows.cu`` is given by ``ops._gather_cuda`` and how it walks
it, emulated in plain PyTorch.

- Slot normalisation: the wrapper's int32 slots (``ops._slots_i32``), put
  through the kernel's wrap-then-clamp in int32 arithmetic, read the rows
  that ``fused_gather_rows_reference`` reads, for int64 slots outside
  int32 range too (a bare cast would wrap 2^32 + 5 to 5), and those the
  JAX gather reads inside that range.
- The block plan (``ops.gather_plan``): every (op, row) is copied by
  exactly one thread group, no block is launched without a row, and ops of
  0 rows get no block.
- The copy unit (``ops._copy_unit``) and the whole walk: the emulated
  kernel's bytes equal the plain version's, strided columns included.

Exact comparison: the gather is data movement.
"""

import ctypes

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeebe_tpu.tpu import pallas_ops as pops
from zeebe_tpu_torch.tpu import ops

WIDE_SLOTS = [2**31, -2**31, 2**31 - 1, -2**31 - 1, 2**32 + 5, -2**32 + 3,
              2**40, -2**40, 5, -1, -11, 10, 0]


def _kernel_slot(slots_i32: torch.Tensor, rows: int) -> torch.Tensor:
    """The kernel's ``xla_slot`` in int32 arithmetic: one wrap, then clamp."""
    assert slots_i32.dtype == torch.int32
    rows32 = torch.tensor(rows, dtype=torch.int32)
    s = torch.where(slots_i32 < 0, slots_i32 + rows32, slots_i32)
    return s.clamp(0, rows - 1)


def _emulated_gather(tables, gops):
    """The kernel's walk on CPU tensors: the plan's blocks, lanes and rows,
    the wrapper's slots through the kernel's clamp, and each row copied in
    the wrapper's copy units from the table's own bytes (through its row
    stride, so strided views read in place)."""
    specs = []
    for op in gops:
        t = tables[op.table]
        es = t.element_size()
        row_bytes = es * (t.shape[1] if t.dim() == 2 else 1)
        out = torch.empty((op.slots.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype)
        unit = ops._copy_unit(t.data_ptr(), es * t.stride(0), row_bytes, out.data_ptr())
        assert row_bytes % unit == 0
        specs.append((t, ops._slots_i32(op.slots), out, row_bytes, unit))
    lanes, starts = ops.gather_plan([s[1].shape[0] for s in specs],
                                    [s[3] // s[4] for s in specs])
    rows_by_op = _walk(starts, lanes, [s[1].shape[0] for s in specs])
    outs = []
    for j, (t, slots, out, row_bytes, unit) in enumerate(specs):
        es = t.element_size()
        base = t if t._base is None else t._base
        flat = base.reshape(-1).view(torch.uint8)
        offset = (t.data_ptr() - base.data_ptr())
        raw = torch.as_strided(flat, (t.shape[0], row_bytes),
                               (es * t.stride(0), 1), offset)
        r = torch.tensor(sorted(rows_by_op[j]), dtype=torch.int64)
        src = raw[_kernel_slot(slots[r], t.shape[0]).to(torch.int64)]
        units = src.reshape(len(r), row_bytes // unit, unit)  # whole copy units
        out.view(-1).view(torch.uint8).view(-1, row_bytes)[r] = units.reshape(len(r), row_bytes)
        outs.append(out)
    return outs


def _walk(starts, lanes, n_rows):
    """Each block's rows as the kernel assigns them: the op found by a scan
    of the starts, ``threads / lanes`` groups, each copying UNROLL rows."""
    rows_by_op = [[] for _ in n_rows]
    for b in range(starts[-1]):
        k = 0
        while k + 1 < len(n_rows) and b >= starts[k + 1]:
            k += 1
        groups = ops._GATHER_THREADS // lanes[k]
        row0 = (b - starts[k]) * groups * ops._GATHER_UNROLL
        got = [row0 + u * groups + g for u in range(ops._GATHER_UNROLL)
               for g in range(groups) if row0 + u * groups + g < n_rows[k]]
        assert got, f"block {b} (op {k}) has no row"
        rows_by_op[k] += got
    return rows_by_op


@pytest.mark.parametrize("rows", [1, 10, 1 << 16])
def test_wide_slots_clamp_like_the_plain_version(rows):
    """int64 slots at and beyond the int32 range: clamped into it before
    the cast, then the kernel's wrap-then-clamp reads the plain version's
    row (2^32 + 5 reads row T-1, not row 5)."""
    slots = torch.tensor(WIDE_SLOTS, dtype=torch.int64)
    want = ops._wrap_slots(slots, rows).clamp(0, rows - 1)
    got = _kernel_slot(ops._slots_i32(slots), rows).to(torch.int64)
    assert got.tolist() == want.tolist()
    table = torch.arange(rows, dtype=torch.int32)
    (ref,) = ops.fused_gather_rows_reference([table], [ops.GatherOp(0, slots)])
    assert table[got].tolist() == ref.tolist()
    if rows == 10:
        assert got[WIDE_SLOTS.index(2**32 + 5)] == 9
        # the fault the clamp repairs: a bare cast reads another row
        bare = _kernel_slot(slots.to(torch.int32), rows)
        assert bare[WIDE_SLOTS.index(2**32 + 5)] == 5


def test_int32_range_slots_in_int64_match_the_jax_gather():
    """int64 slots at the ends of the int32 range, through the emulated
    kernel and through the JAX package's gather: the same rows. (Beyond
    that range the JAX package's CPU gather truncates the wrapped index to
    32 bits, 2^32 + 5 reading row 5, and its Pallas path casts without a
    clamp; the port follows its plain version, which the test above pins.)"""
    rng = np.random.default_rng(3)
    table = rng.integers(-2**31, 2**31 - 1, size=(10, 3), dtype=np.int64).astype(np.int32)
    slots = np.array([2**31 - 1, -2**31, -2**31 + 5, 2**31 - 10, 5, -1, -11, 10, 0],
                     dtype=np.int64)
    (want,) = pops.fused_gather_rows([jnp.asarray(table)],
                                     [pops.GatherOp(0, jnp.asarray(slots))])
    (got,) = _emulated_gather([torch.from_numpy(table)],
                              [ops.GatherOp(0, torch.from_numpy(slots))])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_block_plan_covers_every_row_once(seed):
    """Random op lists (up to 32 ops, some of 0 rows, 1-40 copy units a
    row): each (op, row) in exactly one block, no empty block, no block for
    an op without rows, lanes a power of two covering the row's units up
    to 32."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, ops._MAX_GATHER_OPS + 1))
    n_rows = [int(x) for x in rng.choice([0, 1, 7, 255, 256, 1023, 1024, 1025, 5000], k)]
    vecs = [int(x) for x in rng.integers(1, 41, k)]
    lanes, starts = ops.gather_plan(n_rows, vecs)
    assert len(starts) == k + 1 and starts[0] == 0
    for j in range(k):
        g = lanes[j]
        assert g & (g - 1) == 0 and g <= 32 and (g >= vecs[j] or g == 32)
        if n_rows[j] == 0:
            assert starts[j + 1] == starts[j]
    rows_by_op = _walk(starts, lanes, n_rows)
    for j, n in enumerate(n_rows):
        assert sorted(rows_by_op[j]) == list(range(n)), j


def test_main_path_copy_units():
    """The main path's rows move in the widest units their alignment
    allows: 96-byte payload and 32-byte job rows as 16 bytes, 24-byte rows
    and strided int64 columns as 8, int32 columns as 4, flags as 1."""
    n = 1 << 10
    ei_i64 = torch.zeros((n, 3), dtype=torch.int64)
    cases = [
        (torch.zeros((n, 24), dtype=torch.int32), 16),  # ei_pay / job_pay
        (torch.zeros((n, 4), dtype=torch.int64), 16),   # job_i64
        (torch.zeros((n, 6), dtype=torch.int32), 8),    # ei_i32 / job_i32
        (ei_i64, 8),
        (ei_i64[:, 1], 8),                              # a key column view
        (torch.zeros((n,), dtype=torch.int32), 4),
        (torch.zeros((n,), dtype=torch.bool), 1),
        (torch.zeros((n, 8), dtype=torch.int8), 8),
    ]
    for t, unit in cases:
        es = t.element_size()
        row_bytes = es * (t.shape[1] if t.dim() == 2 else 1)
        out = torch.empty((64,) + tuple(t.shape[1:]), dtype=t.dtype)
        got = ops._copy_unit(t.data_ptr(), es * t.stride(0), row_bytes, out.data_ptr())
        assert got == unit, (t.shape, t.dtype, got)


def test_emulated_kernel_equals_the_plain_version():
    """Tables of every dtype (1D, 2D, a strided column) with adversarial
    slots in int32 and int64, read through the emulated kernel: bit-equal
    to ``fused_gather_rows_reference``."""
    rng = np.random.default_rng(7)
    i64 = torch.from_numpy(rng.integers(-2**62, 2**62, size=(300, 3), dtype=np.int64))
    tables = [
        torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(300, 24)).astype(np.int32)),
        torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(300, 6)).astype(np.int32)),
        i64, i64[:, 2],
        torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(90, 5)).astype(np.int32)
                         ).view(torch.float32),
        torch.from_numpy(rng.integers(-128, 127, size=(70, 3)).astype(np.int8)),
        torch.from_numpy(rng.random(50) < 0.5),
    ]

    def slots(n, t, dtype):
        s = rng.integers(0, t, size=n)
        s[1::5] = -1
        s[2::7] = -t - 3
        s[3::11] = t + 9
        if dtype == np.int64:
            s[4::13] = 2**32 + 5
            s[5::17] = -2**32 + 3
        return torch.from_numpy(s.astype(dtype))

    gops = [ops.GatherOp(j, slots(n, tables[j].shape[0], dt))
            for j in range(len(tables)) for n, dt in ((700, np.int32), (33, np.int64))]
    gops.append(ops.GatherOp(0, torch.zeros((0,), dtype=torch.int32)))
    got = _emulated_gather(tables, gops)
    want = ops.fused_gather_rows_reference(tables, gops)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))


def test_argument_block_holds_the_plan():
    """``_gather_args`` on CPU tensors (the block is built the same way for
    the card): each descriptor's fields, packed in one call, read back
    through the ctypes layout the kernel shares — pointers, row stride,
    rows, slot count, copy units, lanes — and the starts are the plan's."""
    assert ops._GATHER_LAYOUT.size == ctypes.sizeof(ops._GatherDesc)
    i64 = torch.zeros((300, 3), dtype=torch.int64)
    tables = [torch.zeros((300, 24), dtype=torch.int32), i64, i64[:, 1],
              torch.zeros((50,), dtype=torch.bool)]
    gops = [ops.GatherOp(0, torch.arange(700, dtype=torch.int32)),
            ops.GatherOp(1, torch.arange(33, dtype=torch.int64)),
            ops.GatherOp(2, torch.zeros((0,), dtype=torch.int32)),
            ops.GatherOp(3, torch.arange(2000, dtype=torch.int32) - 1000)]
    args, outs, keep = ops._gather_args(tables, gops)
    lanes, starts = ops.gather_plan([700, 33, 0, 2000], [6, 3, 1, 1])
    assert list(args.start[: len(starts)]) == starts and args.n_ops == 4
    for j, op in enumerate(gops):
        d, t, out = args.d[j], tables[op.table], outs[j]
        assert out.dtype == t.dtype and out.shape == (op.slots.shape[0],) + t.shape[1:]
        # a null pointer (an empty tensor's) reads back as None
        assert (d.table, d.out or 0, d.slots or 0) == (t.data_ptr(), out.data_ptr(),
                                                       keep[j].data_ptr())
        assert (d.row_stride, d.rows, d.n) == (t.element_size() * t.stride(0), t.shape[0],
                                               op.slots.shape[0])
        assert d.vecs * d.vec_bytes == t.element_size() * (t.shape[1] if t.dim() == 2 else 1)
        assert d.lanes == lanes[j]
    assert keep[1].dtype == torch.int32  # the int64 slots, clamped and cast
