"""The hash kernels' plans, on the CPU: what ``csrc/hash_update.cu``'s
insert and ``csrc/hash_lookup.cu``'s fused lookup are given by
``tpu/ops.py`` and how they walk it, emulated in plain PyTorch.

- The insert: one cluster of ``ops._INSERT_BLOCKS`` blocks, each owning
  ``ops.insert_plan(n)`` consecutive keys; round 1 reads them all and
  writes every ``ok``, later rounds walk per-block worklists of (rank,
  bucket) pairs; every pending key claims its bucket unread, an atomic
  max of (epoch, rank) tags into a scratch that is never cleared, and
  the claim's holder places itself where the bucket it reads beside the
  claim is free. One barrier a round: a block's writes of one round and
  its claims for the next interleave with the other blocks' steps in a
  random order, the rounds claiming into alternate halves of the
  scratch. The emulation gives the buckets, values and ``ok`` of
  ``hashmap.insert`` in both packages: a scaled-down join shape (at least
  10 rounds), a fresh-table rebuild and an over-full table.
- The lookup: ``ops.lookup_plan`` gives every key of every probe to
  exactly one thread, empty probes and ragged lengths included;
  ``ops.fused_lookup`` on CPU tensors equals the JAX package's
  ``hashmap.lookup`` per probe (strided keys, an all-invalid probe,
  tombstones), and ``ops.lookup`` is its one-probe case.
- The argument blocks: the wrappers' packed layouts have the ctypes
  structures' sizes and read back as the call's fields, and the Python
  constants equal the kernels' ``#define``s.

Exact comparison: these are integer maps.
"""

import ctypes
import pathlib
import random
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeebe_tpu.tpu import hashmap as jhm
from zeebe_tpu_torch.tpu import hashmap as thm
from zeebe_tpu_torch.tpu import ops


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# insert: one cluster, per-block worklists
# ---------------------------------------------------------------------------


def _cluster_insert(tkeys, tvals, keys, vals, valid, seed, epoch=7):
    """The insert kernel's walk on CPU tensors, with its one barrier a round.
    Returns (keys, vals, ok, rounds run). Between two barriers each block
    writes its round-r winners and then claims for round r + 1 from the
    worklist it just filled; the blocks' steps interleave in a random
    order, each block's entries are taken in a shuffled order, and round r
    claims into half r % 2 of the scratch."""
    order = random.Random(seed)
    t = tkeys.shape[0]
    mask = t - 1
    tk, tv = tkeys.tolist(), tvals.tolist()
    ks, vs, live = keys.tolist(), vals.tolist(), valid.tolist()
    h0 = thm._hash(keys, t).tolist()
    n = len(ks)
    share = ops.insert_plan(n)
    owned = [range(b * share, min(n, (b + 1) * share)) for b in range(ops._INSERT_BLOCKS)]
    assert sorted(i for r in owned for i in r) == list(range(n))
    claims = {}  # (half, bucket) -> tag; never cleared: older epochs stay
    ok = [None] * n

    def tag(r, i):
        return ((epoch + r) << 32) | (0x7FFFFFFF - i)

    def claim(r, i, idx):  # every pending key claims, its bucket unread
        claims[r % 2, idx] = max(claims.get((r % 2, idx), 0), tag(r, i))

    def block_steps(b, r, work):
        """Block b between barrier r and barrier r + 1: its writes of round
        r, then its claims of round r + 1. Yields once per entry; returns
        its next worklist."""
        nxt = []
        mine = list(work)
        order.shuffle(mine)
        for i, idx in mine:
            # the lowest rank holds the largest tag; it places itself where
            # the bucket was free (only it writes the bucket, so a bucket
            # written earlier in this phase is a loser's read)
            won = tk[idx] < 0 and claims.get((r % 2, idx)) == tag(r, i)
            if won:
                tk[idx], tv[idx] = ks[i], vs[i]
            else:
                nxt.append((i, (idx + 1) & mask))
            ok[i] = won
            yield
        if r == 0:
            for i in owned[b]:
                if not live[i]:
                    ok[i] = False
        if r + 1 < thm.MAX_PROBES:
            for i, idx in order.sample(nxt, len(nxt)):
                claim(r + 1, i, idx)
                yield
        return nxt

    work = [[(i, h0[i]) for i in rng if live[i]] for rng in owned]
    entries = [e for w in work for e in w]
    for i, idx in order.sample(entries, len(entries)):
        claim(0, i, idx)
    rounds = 0
    for r in range(thm.MAX_PROBES):
        # the barrier: round r's claims are in
        if r > 0 and not any(work):
            break
        rounds += 1
        steps = [block_steps(b, r, w) for b, w in enumerate(work)]
        work = [None] * len(steps)
        running = list(range(len(steps)))
        while running:
            b = order.choice(running)
            try:
                next(steps[b])
            except StopIteration as done:
                work[b] = done.value
                running.remove(b)
    assert None not in ok
    return (torch.tensor(tk, dtype=torch.int64), torch.tensor(tv, dtype=torch.int32),
            torch.tensor(ok), rounds)


def _join_case(rng, t=1 << 12, b=1 << 10):
    """chip_smoke.py's ``_join_map`` scaled down: half the buckets filled
    with join-style keys, a fifth of those deleted (~40 % live, ~10 %
    tombstones), then ``b`` further keys, 9 in 10 valid."""
    scope = rng.permutation(1 << 22)[: t // 2 + b].astype(np.int64)
    keys = ((5 * scope + 1) << 10) | 4
    pre = keys[: t // 2]
    table, ok = thm.insert(thm.make(t), _t(pre), _t(np.arange(t // 2, dtype=np.int32)),
                           torch.ones(t // 2, dtype=torch.bool))
    assert bool(ok.all())
    table = thm.delete(table, _t(pre), _t(rng.random(t // 2) < 0.2))
    new = keys[t // 2:]
    return (table.keys.numpy(), table.vals.numpy(), new,
            rng.integers(0, 1 << 16, b).astype(np.int32), rng.random(b) < 0.9)


def _rebuild_case(rng, t=1 << 14, n=1 << 12):
    """A fresh table taking ``n`` keys, three in four live."""
    fresh = thm.make(t)
    keys = np.arange(n, dtype=np.int64) * 5 + 1
    return (fresh.keys.numpy(), fresh.vals.numpy(), keys,
            np.arange(n, dtype=np.int32), rng.random(n) < 0.75)


def _overfull_case(rng, t=1 << 8, pre=128, b=200):
    """More keys than free buckets: some find none within MAX_PROBES."""
    keys = rng.choice(1 << 30, pre + b, replace=False).astype(np.int64)
    table, _ok = thm.insert(thm.make(t), _t(keys[:pre]), _t(np.arange(pre, dtype=np.int32)),
                            torch.ones(pre, dtype=torch.bool))
    return (table.keys.numpy(), table.vals.numpy(), keys[pre:],
            np.arange(b, dtype=np.int32), np.ones(b, bool))


CASES = {"join": _join_case, "rebuild": _rebuild_case, "overfull": _overfull_case}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_insert_matches_both_packages(case, seed):
    tkeys, tvals, keys, vals, valid = CASES[case](np.random.default_rng(seed))
    got_k, got_v, got_ok, rounds = _cluster_insert(_t(tkeys), _t(tvals), _t(keys), _t(vals),
                                                   _t(valid), seed)
    port, port_ok = thm.insert(thm.HashTable(_t(tkeys), _t(tvals)), _t(keys), _t(vals),
                               _t(valid))
    jt, jok = jhm.insert(jhm.HashTable(keys=jnp.asarray(tkeys), vals=jnp.asarray(tvals)),
                         jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
    for got, want in ((got_k, port.keys), (got_v, port.vals), (got_ok, port_ok),
                      (got_k, np.asarray(jt.keys)), (got_v, np.asarray(jt.vals)),
                      (got_ok, np.asarray(jok))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "join":
        assert rounds >= 10
    if case == "overfull":
        assert not bool(got_ok.all()) and bool(got_ok.any())
        assert rounds == thm.MAX_PROBES


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4096, 4097])
def test_insert_plan_gives_each_key_one_block(n):
    share = ops.insert_plan(n)
    owners = [b for b in range(ops._INSERT_BLOCKS)
              for _i in range(b * share, min(n, (b + 1) * share))]
    assert len(owners) == n and owners == sorted(owners)
    assert share * ops._INSERT_BLOCKS >= n and (share - 1) * ops._INSERT_BLOCKS < max(n, 1)


# ---------------------------------------------------------------------------
# lookup: one launch for every probe of a step
# ---------------------------------------------------------------------------


def _walk_lookup_plan(lengths):
    """How many times the kernel walks each (probe, key) pair of the plan: a
    block takes the last probe whose first block it has reached (the
    kernel's unrolled scan of the starts), a thread the key at (block -
    start) * threads + thread, clipped to the probe's length."""
    starts = ops.lookup_plan(lengths)
    assert len(starts) == len(lengths) + 1 and starts[0] == 0
    seen = {}
    for blk in range(starts[-1]):
        p = 0
        for k in range(1, len(lengths)):
            if blk >= starts[k]:
                p = k
        for tid in range(ops._LOOKUP_THREADS):
            i = (blk - starts[p]) * ops._LOOKUP_THREADS + tid
            if i < lengths[p]:
                seen[(p, i)] = seen.get((p, i), 0) + 1
    return starts, seen


@pytest.mark.parametrize("lengths", [
    [3 * 1024, 1024], [0], [0, 5, 0], [1, 2, 3, 4], [255, 257, 4096, 4097],
    [0, 0, 1, 0, 6, 1024, 3, 0],
])
def test_lookup_plan_covers_every_key_once(lengths):
    starts, seen = _walk_lookup_plan(lengths)
    want = {(p, i) for p, n in enumerate(lengths) for i in range(n)}
    assert set(seen) == want and set(seen.values()) <= {1}
    for p, n in enumerate(lengths):  # no block without a key
        assert starts[p + 1] - starts[p] == -(-n // ops._LOOKUP_THREADS)


def test_fused_lookup_takes_at_most_eight_probes():
    table = thm.make(16)
    probe = ops.LookupOp(0, torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="at most 8"):
        ops._lookup_args([table], [probe] * (ops._MAX_LOOKUPS + 1))


def _map(rng, t, n):
    """A JAX map of ``t`` buckets holding ``n`` keys, a third deleted
    again, and its keys."""
    keys = rng.choice(1 << 40, n, replace=False).astype(np.int64)
    keys[::9] += 1 << 41  # some above 2^32
    jt, ok = jhm.insert(jhm.make(t), jnp.asarray(keys), jnp.asarray(np.arange(n, dtype=np.int32)),
                        jnp.ones(n, bool))
    assert bool(np.asarray(ok).all())
    jt = jhm.delete(jt, jnp.asarray(keys), jnp.asarray(rng.random(n) < 0.33))
    return jt, keys


def _probe_keys(rng, keys, n):
    """``n`` keys: held, deleted (a tombstone on the way) and absent ones,
    and the EMPTY sentinel."""
    q = keys[rng.integers(0, keys.shape[0], n)]
    q[::4] = rng.integers(1 << 42, 1 << 50, q[::4].shape[0])
    q[1::11] = thm.EMPTY
    return q


def test_fused_lookup_equals_jax_lookup_per_probe():
    rng = np.random.default_rng(5)
    (ja, ka), (jb, kb) = _map(rng, 1 << 12, 1500), _map(rng, 1 << 10, 300)
    tables = [thm.HashTable(_t(j.keys), _t(j.vals)) for j in (ja, jb)]
    qa = _probe_keys(rng, ka, 3001)
    wide = np.stack([qa, qa + 1, qa], axis=1)  # a strided key column
    qb = _probe_keys(rng, kb, 514)
    va = rng.random(3001) < 0.6
    probes = [
        (0, _t(wide)[:, 2], va),                # strided keys
        (1, _t(qb), np.zeros(514, bool)),       # no valid key
        (1, _t(qb), rng.random(514) < 0.9),     # tombstones, misses
        (0, _t(np.zeros(0, np.int64)), np.zeros(0, bool)),  # empty
    ]
    got = ops.fused_lookup(tables, [ops.LookupOp(m, k, _t(v)) for m, k, v in probes])
    assert len(got) == len(probes)
    for (m, k, v), (found, vals) in zip(probes, got):
        jf, jv = jhm.lookup((ja, jb)[m], jnp.asarray(k.numpy()), jnp.asarray(v))
        np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert not bool(got[1][0].any()) and bool((got[1][1] == -1).all())
    assert bool(got[2][0].any()) and not bool(got[2][0].all())


def test_lookup_is_the_one_probe_fused_lookup():
    rng = np.random.default_rng(9)
    ja, ka = _map(rng, 1 << 11, 700)
    table = thm.HashTable(_t(ja.keys), _t(ja.vals))
    q, valid = _t(_probe_keys(rng, ka, 999)), _t(rng.random(999) < 0.7)
    ops.reset_launches()
    (want,) = ops.fused_lookup([table], [ops.LookupOp(0, q, valid)])
    got = ops.lookup(table, q, valid)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ops.LAUNCHES["lookup"] == 0  # CPU tensors take the plain version


# ---------------------------------------------------------------------------
# argument blocks: what the wrappers pack is what the kernels read
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(ops.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("source, define, constant", [
    ("hash_lookup.cu", "ZB_MAX_LOOKUPS", "_MAX_LOOKUPS"),
    ("hash_lookup.cu", "ZB_LOOKUP_THREADS", "_LOOKUP_THREADS"),
    ("hash_update.cu", "ZB_INSERT_BLOCKS", "_INSERT_BLOCKS"),
])
def test_plan_constants_equal_the_kernels_defines(source, define, constant):
    found = re.findall(rf"^#define {define} (\d+)\s*$", (CSRC / source).read_text(), re.M)
    assert len(found) == 1
    assert getattr(ops, constant) == int(found[0])


def test_lookup_argument_block_holds_the_probes():
    """``_lookup_args`` on CPU tensors (built the same way for the card):
    each descriptor's fields, packed in one call, read back through the
    ctypes layout the kernel shares; the starts are the plan's."""
    assert ops._LOOKUP_LAYOUT.size == ctypes.sizeof(ops._LookupDesc)
    tables = [thm.make(64), thm.make(16)]
    wide = torch.arange(30, dtype=torch.int64).reshape(10, 3)
    probes = [ops.LookupOp(0, wide[:, 1], torch.ones(10, dtype=torch.bool)),
              ops.LookupOp(1, torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool)),
              ops.LookupOp(1, torch.arange(700), torch.zeros(700, dtype=torch.uint8))]
    args, outs, keep = ops._lookup_args(tables, probes)
    lengths = [p.keys.shape[0] for p in probes]
    starts = ops.lookup_plan(lengths)
    assert list(args.start[: len(starts)]) == starts and args.n_probes == len(probes)
    for j, p in enumerate(probes):
        d, t, (found, vals) = args.d[j], tables[p.table], outs[j]
        assert found.dtype == torch.bool and vals.dtype == torch.int32
        assert found.shape == vals.shape == (lengths[j],)
        assert keep[j].dtype == torch.bool and keep[j].shape == (lengths[j],)
        # a null pointer (an empty tensor's) reads back as None
        assert (d.tkeys, d.tvals) == (t.keys.data_ptr(), t.vals.data_ptr())
        assert ((d.keys or 0), (d.valid or 0), (d.found or 0), (d.vals or 0)) == (
            p.keys.data_ptr(), keep[j].data_ptr(), found.data_ptr(), vals.data_ptr())
        assert (d.key_stride, d.mask, d.n) == (p.keys.stride(0), t.keys.shape[0] - 1,
                                               lengths[j])
    assert args.d[0].key_stride == 3  # the column is read in place


def test_insert_argument_block_holds_the_call():
    """``_insert_args`` on CPU tensors: the fields packed in one call read
    back through the ctypes layout the kernel shares, the claims and
    worklists point at the per-device scratch, large enough for the call,
    and each call takes ``rounds`` epochs of its own."""
    assert ops._INSERT_LAYOUT.size == ctypes.sizeof(ops._InsertArgs)
    table = thm.make(256)
    wide = torch.arange(300, dtype=torch.int64).reshape(100, 3)
    keys = wide[:, 2]
    vals = torch.arange(100, dtype=torch.int64)     # converted to int32
    valid = torch.ones(100, dtype=torch.uint8)      # converted to bool
    args, ok, keep = ops._insert_args(table, keys, vals, valid)
    assert ok.dtype == torch.bool and ok.shape == (100,)
    assert keep[1].dtype == torch.int32 and keep[2].dtype == torch.bool
    assert (args.tkeys, args.tvals, args.keys, args.vals, args.valid, args.ok) == (
        table.keys.data_ptr(), table.vals.data_ptr(), keys.data_ptr(), keep[1].data_ptr(),
        keep[2].data_ptr(), ok.data_ptr())
    claims, epoch = ops._claims[torch.device("cpu")]
    work = ops._worklists[torch.device("cpu")]
    share = ops.insert_plan(100)
    assert (args.claims, args.work) == (claims.data_ptr(), work.data_ptr())
    assert claims.numel() >= 2 * 256 and work.numel() >= 2 * ops._INSERT_BLOCKS * share
    assert (args.key_stride, args.mask, args.n, args.share, args.rounds) == (
        3, 255, 100, share, thm.MAX_PROBES)
    assert args.epoch == epoch - thm.MAX_PROBES + 1
    again, _ok, _keep = ops._insert_args(table, keys, vals, valid, rounds=1)
    assert again.rounds == 1 and again.epoch == args.epoch + thm.MAX_PROBES
