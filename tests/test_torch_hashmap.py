"""zeebe_tpu_torch.tpu.hashmap against zeebe_tpu.tpu.hashmap, bit for bit.

The same numpy inputs (fixed seed) go through both; tables are compared
by bucket layout (keys and vals arrays), not only by key → value map,
because tables cross engines in snapshots.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeebe_tpu.tpu import hashmap as jhm
from zeebe_tpu_torch.tpu import hashmap as thm


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys(rng, n):
    """int64 keys: small, ≥ 2^32, negative, the sentinels and the extremes."""
    k = rng.integers(0, 2**40, size=n, dtype=np.int64)
    k[::5] = rng.integers(2**32, 2**62, size=k[::5].shape, dtype=np.int64)
    k[1::7] = rng.integers(-2**62, 0, size=k[1::7].shape, dtype=np.int64)
    k[:4] = [thm.EMPTY, thm.TOMBSTONE, np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    return k


@pytest.mark.parametrize("table_size", [8, 1024, 1 << 19])
def test_hash_matches_jax(table_size):
    rng = np.random.default_rng(11)
    keys = _keys(rng, 4096)
    want = np.asarray(jhm._hash(jnp.asarray(keys), table_size))
    got = thm._hash(_t(keys), table_size).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _filled(rng, size, n, dead_frac=0.25):
    """A table on both sides: n unique keys inserted, a fraction deleted."""
    keys = np.unique(rng.integers(0, 2**36, size=n, dtype=np.int64))
    vals = rng.integers(0, 2**31 - 1, size=keys.shape, dtype=np.int32)
    valid = np.ones(keys.shape, bool)
    dead = rng.random(keys.shape) < dead_frac
    jt, _ = jhm.insert(jhm.make(size), jnp.asarray(keys), jnp.asarray(vals),
                       jnp.asarray(valid))
    jt = jhm.delete(jt, jnp.asarray(keys), jnp.asarray(dead))
    tt, _ = thm.insert(thm.make(size), _t(keys), _t(vals), _t(valid))
    tt = thm.delete(tt, _t(keys), _t(dead))
    return keys, jt, tt


def _assert_table(tt, jt):
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.vals.numpy(), np.asarray(jt.vals))
    assert tt.keys.dtype == torch.int64 and tt.vals.dtype == torch.int32


@pytest.mark.parametrize("size,n", [(64, 40), (1024, 500), (4096, 1200)])
def test_insert_and_delete_bucket_layout(size, n):
    """Colliding keys race for buckets: the round-synchronous scatter-min
    claim must give the same layout (and tombstones) as the XLA path."""
    rng = np.random.default_rng(size)
    _keys_, jt, tt = _filled(rng, size, n)
    _assert_table(tt, jt)


def test_insert_overfull_reports_failures():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 2**30, size=80, dtype=np.int64))[:70]
    vals = np.arange(keys.shape[0], dtype=np.int32)
    valid = np.ones(keys.shape, bool)
    valid[::9] = False
    jt, jok = jhm.insert(jhm.make(64), jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(valid))
    tt, tok = thm.insert(thm.make(64), _t(keys), _t(vals), _t(valid))
    _assert_table(tt, jt)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not tok.numpy().all()


def test_lookup_hits_misses_tombstones():
    rng = np.random.default_rng(3)
    keys, jt, tt = _filled(rng, 2048, 900, dead_frac=0.3)
    q = np.concatenate([keys, rng.integers(0, 2**36, size=300, dtype=np.int64),
                        np.array([-1, -2], np.int64)])
    valid = rng.random(q.shape) < 0.8
    jf, jv = jhm.lookup(jt, jnp.asarray(q), jnp.asarray(valid))
    tf, tv = thm.lookup(tt, _t(q), _t(valid))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.dtype == torch.int32 and tf.dtype == torch.bool


def test_rebuild_from_and_fill_counts():
    rng = np.random.default_rng(8)
    keys, jt, tt = _filled(rng, 1024, 400, dead_frac=0.4)
    live = np.asarray(jt.keys) >= 0
    slots = np.arange(1024, dtype=np.int32)
    jr, jall = jhm.rebuild_from(2048, jt.keys, jnp.asarray(slots), jnp.asarray(live))
    tr, tall = thm.rebuild_from(2048, tt.keys, _t(slots), _t(live))
    _assert_table(tr, jr)
    assert bool(tall) == bool(jall)
    for t_side, j_side in ((tt, jt), (tr, jr)):
        tl, td = thm.fill_counts(t_side)
        jl, jd = jhm.fill_counts(j_side)
        assert (int(tl), int(td)) == (int(jl), int(jd))
