"""The plain PyTorch versions of the three kernels against the JAX ops.

``zeebe_tpu_torch.tpu.ops`` takes its plain version for CPU tensors; the
JAX side runs ``zeebe_tpu.tpu.pallas_ops`` as its own CPU tests run it
(the XLA fallback). Same numpy inputs, exact comparison: every function
here is integer arithmetic or data movement, f32 compared through its
int32 view.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeebe_tpu.tpu import hashmap as jhm
from zeebe_tpu.tpu import pallas_ops as pops
from zeebe_tpu_torch.tpu import hashmap as thm
from zeebe_tpu_torch.tpu import ops


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _tables(rng):
    """One table of every dtype the step kernel gathers from, 1D and 2D;
    f32 tables carry raw bit patterns (NaNs with payloads included)."""
    nan_bits = rng.integers(-2**31, 2**31 - 1, size=(40, 5), dtype=np.int64).astype(np.int32)
    nan_bits[0, :] = np.array([0x7FC00001, 0x7F800001, -0x00400001, 0x7F800000, 0], np.int32)
    return [
        rng.integers(-2**31, 2**31 - 1, size=(37, 6), dtype=np.int64).astype(np.int32),
        rng.integers(-2**62, 2**62, size=(29, 3), dtype=np.int64),
        nan_bits.view(np.float32),
        rng.integers(-128, 127, size=(23, 4), dtype=np.int64).astype(np.int8),
        rng.random((31, 3)) < 0.5,
        rng.integers(-2**31, 2**31 - 1, size=(41,), dtype=np.int64).astype(np.int32),
        rng.integers(-2**62, 2**62, size=(19,), dtype=np.int64),
        nan_bits[:, 0].view(np.float32).copy(),
        rng.integers(-128, 127, size=(17,), dtype=np.int64).astype(np.int8),
        rng.random((13,)) < 0.5,
    ]


def _slots(rng, n, t, out_of_range):
    s = rng.integers(0, t, size=n).astype(np.int32)
    s[: n // 4] = s[0]  # duplicates
    if out_of_range:
        s[1::5] = -1
        s[2::7] = -t - 3
        s[3::11] = t
        s[4::13] = t + 9
    return s


def test_gather_every_dtype_with_out_of_range_slots():
    """Each table read by its own op(s): negative slots wrap once, then
    everything clamps (XLA's gather), for every dtype, 1D and 2D, with ops
    of mixed lengths on one table."""
    rng = np.random.default_rng(0)
    tables = _tables(rng)
    op_specs = []
    for i, t in enumerate(tables):
        lengths = (48, 16) if t.ndim == 2 else (24,)
        for n in lengths:
            op_specs.append((i, _slots(rng, n, t.shape[0], True)))
    want = pops.fused_gather_rows(
        [jnp.asarray(t) for t in tables],
        [pops.GatherOp(i, jnp.asarray(s)) for i, s in op_specs],
    )
    got = ops.fused_gather_rows(
        [_t(t) for t in tables], [ops.GatherOp(i, _t(s)) for i, s in op_specs]
    )
    _assert_same(got, want)


def test_gather_one_dtype_group_of_1d_tables():
    """Several 1D tables of one dtype in one call (the JAX path fuses them
    into one concatenated gather), in-range slots, plus a strided column
    view on the port side."""
    rng = np.random.default_rng(1)
    i64 = rng.integers(-2**62, 2**62, size=(64, 3), dtype=np.int64)
    cols = [np.ascontiguousarray(i64[:, c]) for c in range(3)]
    i32 = [rng.integers(0, 1000, size=(n,), dtype=np.int64).astype(np.int32) for n in (50, 70)]
    tables = cols + i32
    op_specs = [(0, _slots(rng, 96, 64, False)), (1, _slots(rng, 32, 64, False)),
                (2, _slots(rng, 32, 64, False)), (3, _slots(rng, 32, 50, False)),
                (4, _slots(rng, 32, 70, False))]
    want = pops.fused_gather_rows(
        [jnp.asarray(t) for t in tables],
        [pops.GatherOp(i, jnp.asarray(s)) for i, s in op_specs],
    )
    full = _t(i64)
    t_tables = [full[:, 0], full[:, 1], full[:, 2]] + [_t(t) for t in i32]
    assert not t_tables[0].is_contiguous()
    got = ops.fused_gather_rows(t_tables, [ops.GatherOp(i, _t(s)) for i, s in op_specs])
    _assert_same(got, want)


def _commit_case(rng, b=64):
    tables = [
        rng.integers(-1000, 1000, size=(40, 6), dtype=np.int64).astype(np.int32),
        rng.integers(-1000, 1000, size=(40, 4), dtype=np.int64).astype(np.int32),
        rng.integers(-1000, 1000, size=(48,), dtype=np.int64).astype(np.int32),
    ]

    def slots(t):
        s = rng.integers(0, 8, size=b).astype(np.int32)  # heavy duplicates
        s[::9] = t        # the sentinel slot: dropped
        s[1::11] = -1     # wraps to the last row
        s[2::13] = -t - 4  # out of range after one wrap: dropped
        return s

    def vals(k):
        shape = (b, k) if k else (b,)
        return rng.integers(-1000, 1000, size=shape, dtype=np.int64).astype(np.int32)

    def act():
        return rng.random(b) < 0.7

    def mask(k):
        return rng.random((b, k)) < 0.5

    specs = [
        (0, "add", slots(40), act(), vals(6), mask(6)),
        (0, "set", slots(40), act(), vals(6), mask(6)),
        (1, "set", slots(40), act(), vals(4), None),
        (0, "max", slots(40), act(), vals(6), None),
        (0, "set", slots(40), act(), vals(6), None),
        (1, "add", slots(40), act(), vals(4), None),
        (2, "set", slots(48), act(), vals(0), None),
        (2, "add", slots(48), act(), vals(0), None),
        (2, "max", slots(48), act(), vals(0), None),
        (1, "set", slots(40), act(), vals(4), mask(4)),
    ]
    return tables, specs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_commit_matches_jax_chain(seed):
    """Duplicate slots (last writer per row, or per (row, lane) with a lane
    mask), add/max, 1D tables, the sentinel slot T and negative slots; the
    port updates in place, the JAX chain returns new arrays."""
    rng = np.random.default_rng(seed)
    tables, specs = _commit_case(rng)
    want = pops.fused_table_commit(
        [jnp.asarray(t) for t in tables],
        [pops.TableOp(i, k, jnp.asarray(s), jnp.asarray(a), jnp.asarray(v),
                      None if m is None else jnp.asarray(m))
         for i, k, s, a, v, m in specs],
    )
    t_tables = [_t(t) for t in tables]
    got = ops.fused_table_commit(
        t_tables,
        [ops.TableOp(i, k, _t(s), _t(a), _t(v), None if m is None else _t(m))
         for i, k, s, a, v, m in specs],
    )
    _assert_same(got, want)
    assert all(g is t for g, t in zip(got, t_tables))  # in place


def test_table_commit_on_int64_planes():
    """int64 tables enter as zero-copy int32 planes (``.view``), the same
    little-endian layout as ``pallas_ops.i64_to_planes``."""
    rng = np.random.default_rng(4)
    tab = rng.integers(-2**40, 2**40, size=(16, 3), dtype=np.int64)
    b = 24
    slots = rng.integers(0, 16, size=b).astype(np.int32)
    active = rng.random(b) < 0.8
    new = rng.integers(-2**40, 2**40, size=(b, 3), dtype=np.int64)
    mask = np.zeros((b, 6), bool)
    mask[:, 2:4] = True  # write only the middle int64 column
    want = pops.planes_to_i64(pops.fused_table_commit(
        [pops.i64_to_planes(jnp.asarray(tab))],
        [pops.TableOp(0, "set", jnp.asarray(slots), jnp.asarray(active),
                      pops.i64_to_planes(jnp.asarray(new)), jnp.asarray(mask))],
    )[0])
    t_tab = _t(tab)
    ops.fused_table_commit(
        [t_tab.view(torch.int32)],
        [ops.TableOp(0, "set", _t(slots), _t(active),
                     _t(new).view(torch.int32).reshape(b, 6), _t(mask))],
    )
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(want))


def test_lookup_misses_and_tombstones():
    rng = np.random.default_rng(6)
    keys = np.unique(rng.integers(0, 2**34, size=700, dtype=np.int64))
    vals = np.arange(keys.shape[0], dtype=np.int32)
    ones = np.ones(keys.shape, bool)
    dead = rng.random(keys.shape) < 0.3
    jt, _ = jhm.insert(jhm.make(1024), jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(ones))
    jt = jhm.delete(jt, jnp.asarray(keys), jnp.asarray(dead))
    tt = thm.HashTable(keys=_t(jt.keys), vals=_t(jt.vals))
    q = np.concatenate([keys, rng.integers(2**34, 2**40, size=200, dtype=np.int64)])
    valid = rng.random(q.shape) < 0.9
    want = pops.lookup(jt, jnp.asarray(q), jnp.asarray(valid))
    got = ops.lookup(tt, _t(q), _t(valid))
    _assert_same(list(got), list(want))


def test_wrappers_take_plain_path_for_cpu_tensors():
    """CPU tensors never reach the kernel build or the launch counters;
    a mix of devices is refused rather than guessed."""
    ops.reset_launches()
    t = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    (rows,) = ops.fused_gather_rows([t], [ops.GatherOp(0, torch.tensor([5, -1, 9], dtype=torch.int32))])
    assert rows.tolist() == [[10, 11], [10, 11], [10, 11]]
    assert ops.LAUNCHES == dict.fromkeys([
        "fused_gather_rows", "fused_table_commit", "lookup",
        "masked_row_update", "masked_row_max", "masked_row_add",
        "masked_lane_update", "masked_lane_accum", "masked_vec64_update",
        "insert", "delete", "fused_accumulate",
    ], 0)
    meta = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        ops.fused_gather_rows([t], [ops.GatherOp(0, meta)])
