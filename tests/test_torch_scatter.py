"""The plain versions of the masked-scatter and hash-update kernels against
the JAX ops.

``zeebe_tpu_torch.tpu.ops`` takes its plain version for CPU tensors and
updates the caller's table in place; the JAX side runs
``zeebe_tpu.tpu.pallas_ops`` as its own CPU tests run it (the XLA
fallback; ``insert`` and ``delete`` fall through to ``hashmap``) and
returns new arrays. Same numpy inputs, exact integer comparison.
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


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _slots(rng, b, t):
    """Heavy duplicates, the sentinel T, a wrapping -1 and slots still out
    of range after one wrap."""
    s = rng.integers(0, 8, size=b).astype(np.int32)
    s[b // 2:] = rng.integers(0, t, size=b - b // 2)
    s[::9] = t
    s[1::11] = -1
    s[2::13] = -t - 4
    s[3::17] = t + 5
    return s


def _case(seed, rows=40, width=6, b=96, dtype=np.int32):
    rng = np.random.default_rng(seed)
    lim = 2**40 if dtype == np.int64 else 1000
    shape = (rows, width) if width else (rows,)
    vshape = (b, width) if width else (b,)
    table = rng.integers(-lim, lim, size=shape, dtype=np.int64).astype(dtype)
    vals = rng.integers(-lim, lim, size=vshape, dtype=np.int64).astype(dtype)
    return (table, _slots(rng, b, rows), rng.random(b) < 0.7, vals,
            rng.random((b, width or 1)) < 0.5)


def _both(jax_fn, port_fn, table, slots, active, vals, mask=None):
    """Run both with the same inputs; the port must update in place."""
    jargs = [jnp.asarray(table), jnp.asarray(slots), jnp.asarray(active), jnp.asarray(vals)]
    targs = [_t(table), _t(slots), _t(active), _t(vals)]
    if mask is not None:
        jargs.append(jnp.asarray(mask))
        targs.append(_t(mask))
    want = jax_fn(*jargs)
    got = port_fn(*targs)
    assert got is targs[0]
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_row_update(seed, masked):
    """Last active writer per row, or per (row, lane) with a lane mask —
    the join-payload merge writes disjoint lanes of one row."""
    table, slots, active, vals, mask = _case(seed)
    _both(pops.masked_row_update, ops.masked_row_update, table, slots, active,
          vals, mask if masked else None)


@pytest.mark.parametrize("seed", [2, 3])
def test_masked_row_max(seed):
    table, slots, active, vals, _mask = _case(seed, width=4)
    _both(pops.masked_row_max, ops.masked_row_max, table, slots, active, vals)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_row_add(masked):
    table, slots, active, vals, mask = _case(4, width=8)
    _both(pops.masked_row_add, ops.masked_row_add, table, slots, active, vals,
          mask if masked else None)


@pytest.mark.parametrize("jax_fn,port_fn", [
    (pops.masked_lane_update, ops.masked_lane_update),
    (pops.masked_lane_accum, ops.masked_lane_accum),
])
def test_masked_lane_ops(jax_fn, port_fn):
    table, slots, active, vals, _mask = _case(5, rows=48, width=0)
    _both(jax_fn, port_fn, table, slots, active, vals)


def test_masked_vec64_update():
    """int64 elements beyond 32 bits, through lo/hi int32 planes on both
    sides."""
    table, slots, active, vals, _mask = _case(6, rows=56, width=0, dtype=np.int64)
    _both(pops.masked_vec64_update, ops.masked_vec64_update, table, slots, active, vals)


def _colliding_keys(rng, size, n):
    """``n`` distinct non-negative keys, most of them hashing to a handful
    of buckets of a ``size``-bucket table."""
    pool = np.unique(rng.integers(0, 2**40, size=64 * n, dtype=np.int64))
    h = np.asarray(jhm._hash(jnp.asarray(pool), size))
    hot = np.isin(h, h[:3])
    keys = np.concatenate([pool[hot][: 2 * n // 3], pool[~hot][:n]])[:n]
    rng.shuffle(keys)
    return keys


def _preloaded(rng, size, live, dead):
    """A JAX table holding ``live`` keys after ``dead`` more were inserted
    and deleted again (tombstones mixed into the chains)."""
    keys = np.unique(rng.integers(0, 2**40, size=2 * (live + dead), dtype=np.int64))
    keys = keys[: live + dead]
    rng.shuffle(keys)
    ones = np.ones(keys.shape, bool)
    table, _ = jhm.insert(jhm.make(size), jnp.asarray(keys),
                          jnp.asarray(np.arange(keys.shape[0], dtype=np.int32)),
                          jnp.asarray(ones))
    return jhm.delete(table, jnp.asarray(keys), jnp.asarray(np.arange(keys.shape[0]) >= live))


def _port_table(jt):
    return thm.HashTable(keys=_t(jt.keys), vals=_t(jt.vals))


@pytest.mark.parametrize("size,live,dead,n", [
    (256, 40, 40, 64),    # colliding keys over tombstones
    (64, 20, 24, 48),     # too full: some keys find no bucket within 32 probes
    (1024, 0, 0, 300),    # a fresh table: the rebuild shape
])
def test_insert_reproduces_the_xla_bucket_layout(size, live, dead, n):
    rng = np.random.default_rng(size + n)
    jt = _preloaded(rng, size, live, dead)
    keys = _colliding_keys(rng, size, n)
    vals = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    want_t, want_ok = pops.insert(jt, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
    tt = _port_table(jt)
    got_t, got_ok = ops.insert(tt, _t(keys), _t(vals), _t(valid))
    assert got_t is tt
    _same(got_t.keys, want_t.keys)
    _same(got_t.vals, want_t.vals)
    _same(got_ok, want_ok)
    if size == 64:
        assert not bool(got_ok[_t(valid)].all())  # the table ran out of probes
    else:
        assert bool((got_ok == _t(valid)).all())


def test_delete_present_absent_and_repeated_keys():
    rng = np.random.default_rng(9)
    jt = _preloaded(rng, 512, 150, 60)
    present = np.asarray(jt.keys)[np.asarray(jt.keys) >= 0]
    keys = np.concatenate([present[:80], rng.integers(2**41, 2**42, size=60, dtype=np.int64),
                           present[:10], [jhm.TOMBSTONE]])
    valid = rng.random(keys.shape[0]) < 0.85
    want = pops.delete(jt, jnp.asarray(keys), jnp.asarray(valid))
    tt = _port_table(jt)
    vals_before = tt.vals.clone()
    got = ops.delete(tt, _t(keys), _t(valid))
    assert got is tt
    _same(got.keys, want.keys)
    _same(got.vals, want.vals)
    assert torch.equal(got.vals, vals_before)


def test_cpu_tensors_launch_nothing():
    """Every new wrapper takes its plain version for CPU tensors: no build,
    no launch counted; a mix of devices is refused."""
    ops.reset_launches()
    table, slots, active, vals, mask = _case(7)
    ops.masked_row_update(_t(table), _t(slots), _t(active), _t(vals), _t(mask))
    ops.masked_row_max(_t(table), _t(slots), _t(active), _t(vals))
    ops.masked_row_add(_t(table), _t(slots), _t(active), _t(vals))
    t1, s1, a1, v1, _m = _case(8, width=0)
    ops.masked_lane_update(_t(t1), _t(s1), _t(a1), _t(v1))
    ops.masked_lane_accum(_t(t1), _t(s1), _t(a1), _t(v1))
    ops.masked_vec64_update(_t(t1.astype(np.int64)), _t(s1), _t(a1), _t(v1))
    tt = thm.make(64, device="cpu")
    keys = torch.arange(10, dtype=torch.int64)
    ops.insert(tt, keys, keys.to(torch.int32), torch.ones(10, dtype=torch.bool))
    ops.delete(tt, keys, torch.ones(10, dtype=torch.bool))
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    meta = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        ops.masked_lane_update(_t(t1), meta, _t(a1[:3]), _t(v1[:3]))
