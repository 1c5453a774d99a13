"""The hash delete's and the probe's window walk, on the CPU: what
``csrc/hash_update.cu``'s fused delete and ``csrc/probe.cu``'s probe are
given by their wrappers and how their warps walk it, emulated in plain
Python, and the step's and the demotion's deletes as one ``fused_delete``.

- The walk (``zb_hash.cuh`` ``zb_window_walk``): a warp takes 32
  consecutive keys and leaves when none is valid; G lanes walk a key, its
  first window of G buckets in one step and the rest of its chain in a
  second, and a key is settled at the lowest bucket read that holds it
  or is EMPTY, or after its last bucket. Every bucket read is a step of
  its own, interleaved at random with every other walker's reads and
  tombstone writes (a superset of the card's schedules). The
  result equals ``hashmap.delete`` in both packages: the join map at T =
  2^12, chains that wrap past T - 1, a key in the 32nd bucket of its
  chain, chains that run out, invalid keys; every G in {4, 8, 16, 32}.
- ``ops.fused_delete`` over 1-8 deletes on 1-4 tables: on CPU tensors
  (``fused_delete_reference``) and walked by the emulation as the one
  launch the card runs (``ops.lookup_plan`` blocks of
  ``ops._DELETE_THREADS`` keys), against the JAX deletes one after
  another.
- The argument block: the packed layout reads back as the ctypes
  structure, and the Python constants equal the kernels' ``#define``s.
- A step of a graph with timers and parallel joins issues one
  ``fused_delete`` (the timer and the join map), and equals the JAX step;
  a demotion issues one for its four maps, and its log equals the
  host oracle's.
- The probe: the window walk with the ``#define``d group of lanes on the
  probe's tables, against ``probe_reference``.

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

from zeebe_tpu.models.bpmn.builder import Bpmn as JBpmn
from zeebe_tpu.models.bpmn.model import ParallelGateway as JParallelGateway
from zeebe_tpu.models.transform.steps import BpmnStep
from zeebe_tpu.models.transform.transformer import transform_model as jtransform
from zeebe_tpu.protocol.intents import TimerIntent as JTI
from zeebe_tpu.tpu import batch as jb, drive as jd, graph as jg, hashmap as jhm
from zeebe_tpu.tpu import state as js
from zeebe_tpu_torch import probe as tprobe
from zeebe_tpu_torch.tpu import batch as tb, graph as tg, hashmap as thm, ops
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

from test_torch_conditions import NUM_VARS, _creates, _with_vars
from test_torch_drive import _subscribed
from test_torch_kernel import assert_step_equal, both_steps, jax_state_np
from test_torch_timers import _timer_batch

CSRC = pathlib.Path(ops.__file__).resolve().parents[1] / "csrc"
GROUPS = [4, 8, 16, 32]


def _t(a):
    return torch.from_numpy(np.array(a))


def _define(source, name):
    found = re.findall(rf"^#define {name} (\d+)\s*$", (CSRC / source).read_text(), re.M)
    assert len(found) == 1, (source, name)
    return int(found[0])


# ---------------------------------------------------------------------------
# the window walk, emulated
# ---------------------------------------------------------------------------


class _Walker:
    """One key of one warp: G lanes, two steps. Step 0 reads the key's
    first window (buckets 0..G-1 of its chain), step 1 every remaining
    window at once (G..P-1); after a step the group settles the key at the
    lowest bucket read that holds it or is EMPTY, else after step 1 (or a
    step 0 that read all P buckets) it ran out."""

    def __init__(self, table, mask, key, home, g, p, done):
        self.table, self.mask, self.key, self.home = table, mask, key, home
        self.done = done
        self.steps = [range(0, min(g, p))] + ([range(g, p)] if p > g else [])
        self.step, self.got = 0, {}
        self.unread = list(self.steps[0])

    def _bucket(self, j):
        return (self.home + j) & self.mask

    def advance(self, order):
        """One lane's read of one bucket, or, with the step's reads done,
        the group's ballots. Returns False once the key is settled."""
        if self.unread:
            j = self.unread.pop(order.randrange(len(self.unread)))
            self.got[j] = self.table[self._bucket(j)]
            return True
        stops = [j for j in sorted(self.got) if self.got[j] in (self.key, -1)]
        if stops:
            first = stops[0]
            self.done(self._bucket(first) if self.got[first] == self.key else -1)
            return False
        if self.step + 1 == len(self.steps):
            self.done(-1)
            return False
        self.step += 1
        self.got, self.unread = {}, list(self.steps[self.step])
        return True


def _warps(n, valid):
    """The warps over ``n`` keys (32 consecutive each, the last one ragged)
    that find a valid key: the others leave after reading the flags."""
    return [[i for i in range(w, min(w + 32, n)) if valid[i]] for w in range(0, n, 32)
            if any(valid[w:w + 32])]


def _run(walkers, seed):
    """Every walker's reads and ballots, interleaved at random."""
    order = random.Random(seed)
    live = list(walkers)
    while live:
        k = order.randrange(len(live))
        if not live[k].advance(order):
            live.pop(k)


def _emulated_deletes(tables, deletes, g, seed):
    """The fused delete kernel's launch on plain lists: ``tables`` are
    lists of int keys (updated in place), ``deletes`` (table, keys,
    valid) lists. Blocks come from ``ops.lookup_plan`` with
    ``_DELETE_THREADS`` keys each, the op of a block from its scan of the
    starts; the lane that read a held key writes its tombstone.
    Returns the warps that walked."""
    starts = ops.lookup_plan([len(k) for _t_, k, _v in deletes], ops._DELETE_THREADS)
    walkers, warps = [], 0
    for blk in range(starts[-1]):
        p = max(k for k in range(len(deletes)) if blk >= starts[k])
        t, keys, valid = deletes[p]
        table = tables[t]
        mask = len(table) - 1
        homes = thm._hash(_t(np.asarray(keys, np.int64)), len(table)).tolist()
        lo = (blk - starts[p]) * ops._DELETE_THREADS
        hi = min(lo + ops._DELETE_THREADS, len(keys))
        for warp in _warps(hi - lo, valid[lo:hi]):
            warps += 1
            for i in warp:
                i += lo

                def done(slot, table=table):
                    if slot >= 0:
                        table[slot] = thm.TOMBSTONE

                walkers.append(_Walker(table, mask, keys[i], homes[i], g, thm.MAX_PROBES, done))
    _run(walkers, seed)
    return warps


def _emulated_delete(tkeys, keys, valid, g, seed):
    table = list(map(int, tkeys))
    _emulated_deletes([table], [(0, list(map(int, keys)), list(map(bool, valid)))], g, seed)
    return np.asarray(table, np.int64)


def _both_deletes(tkeys, keys, valid):
    """The port's and the JAX package's ``hashmap.delete``."""
    tvals = np.arange(len(tkeys), dtype=np.int32)
    port = thm.delete(thm.HashTable(_t(tkeys), _t(tvals)), _t(keys), _t(valid)).keys.numpy()
    jax_ = np.asarray(jhm.delete(jhm.HashTable(jnp.asarray(tkeys), jnp.asarray(tvals)),
                                 jnp.asarray(keys), jnp.asarray(valid)).keys)
    np.testing.assert_array_equal(port, jax_)
    return port


def _join_case(rng):
    """chip_smoke's delete case at T = 2^12: half the buckets filled with
    join-style keys ((scope << 10) | gateway), a fifth deleted again; 256
    keys to delete, half held, half absent, ~90 % valid."""
    t, b = 1 << 12, 256
    scope = rng.permutation(1 << 22)[: t // 2 + b].astype(np.int64)
    keys = ((5 * scope + 1) << 10) | 4
    pre = keys[: t // 2]
    table, ok = thm.insert(thm.make(t), _t(pre), _t(np.arange(pre.shape[0], dtype=np.int32)),
                           torch.ones(pre.shape[0], dtype=torch.bool))
    assert bool(ok.all())
    table = thm.delete(table, _t(pre), _t(rng.random(pre.shape[0]) < 0.2))
    q = np.concatenate([rng.permutation(pre)[: b // 2], keys[t // 2:][: b // 2]])
    return table.keys.numpy(), q, rng.random(b) < 0.9


def _wrap_case(rng):
    """28 keys hashed into the last 4 of 2^10 buckets: their chains wrap
    past T - 1. Delete 14 of them, 10 absent keys hashed there (chains of
    up to 32 buckets) and 4 held keys marked invalid."""
    t = 1 << 10
    cand = np.arange(1, 1 << 18, dtype=np.int64) * 7 + 3 + int(rng.integers(0, 7))
    near = cand[thm._hash(_t(cand), t).numpy() >= t - 4][:38]
    table, ok = thm.insert(thm.make(t), _t(near[:28]), _t(np.arange(28, dtype=np.int32)),
                           torch.ones(28, dtype=torch.bool))
    assert bool(ok.all())
    tkeys = table.keys.numpy()
    assert (np.nonzero(tkeys >= 0)[0] < 32).any()  # a chain wrapped
    keys = np.concatenate([near[:14], near[28:38], near[14:18]])
    valid = np.arange(keys.shape[0]) < 24
    return tkeys, keys, valid


def _run_out_case(rng):
    """A full table of 2^10 buckets (no EMPTY, some tombstones): a key in
    the 32nd bucket of its chain, one in the 33rd (out of reach), one
    absent, one invalid."""
    t = 1 << 10
    tkeys = np.arange(t, dtype=np.int64) + 10**9
    tkeys[int(rng.integers(0, 37))::37] = thm.TOMBSTONE
    keys = np.array([11, 12, 13, 14], dtype=np.int64)
    h = thm._hash(_t(keys), t).tolist()
    at = ((h[0] + 31) % t, (h[1] + 32) % t)
    assert at[0] != at[1]
    tkeys[at[0]], tkeys[at[1]] = keys[0], keys[1]
    return tkeys, keys, np.array([True, True, True, False])


CASES = {"join": _join_case, "wrap": _wrap_case, "run_out": _run_out_case}


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_window_walk_deletes_as_both_packages(case, g):
    rng = np.random.default_rng(GROUPS.index(g))
    tkeys, keys, valid = CASES[case](rng)
    want = _both_deletes(tkeys, keys, valid)
    for seed in (0, 1):
        got = _emulated_delete(tkeys, keys, valid, g, seed)
        np.testing.assert_array_equal(got, want)
    if case == "run_out":  # the 32nd bucket is reached, the 33rd is not
        h = thm._hash(_t(keys), len(tkeys)).tolist()
        assert want[(h[0] + 31) % len(tkeys)] == thm.TOMBSTONE
        assert want[(h[1] + 32) % len(tkeys)] == keys[1]
        assert (want != tkeys).sum() == 1
    if case == "wrap":
        assert (want != tkeys).sum() == 14


def test_a_warp_without_valid_keys_walks_nothing():
    tkeys, keys, valid = _join_case(np.random.default_rng(3))
    valid[32:64] = False
    valid[200:] = False
    table = list(map(int, tkeys))
    warps = _emulated_deletes([table], [(0, list(map(int, keys)), list(map(bool, valid)))],
                              8, 0)
    assert warps == len(_warps(len(keys), valid)) == 6


@pytest.mark.parametrize("lengths", [[1], [0], [256, 257], [0, 5, 0, 1000],
                                     [1, 2, 3, 4, 5, 6, 7, 8]])
def test_delete_plan_gives_each_key_one_warp(lengths):
    """The delete's blocks (``lookup_plan`` with ``_DELETE_THREADS``): a
    block takes the last op whose first block it reached, its warps 32
    consecutive keys each; every key of every op is walked by one warp."""
    starts = ops.lookup_plan(lengths, ops._DELETE_THREADS)
    seen = {}
    for blk in range(starts[-1]):
        p = max(k for k in range(len(lengths)) if blk >= starts[k])
        for warp in range(ops._DELETE_THREADS // 32):
            for lane in range(32):
                i = (blk - starts[p]) * ops._DELETE_THREADS + warp * 32 + lane
                if i < lengths[p]:
                    seen[p, i] = seen.get((p, i), 0) + 1
    assert set(seen) == {(p, i) for p, n in enumerate(lengths) for i in range(n)}
    assert set(seen.values()) <= {1}


# ---------------------------------------------------------------------------
# fused_delete: the step's deletes in one launch
# ---------------------------------------------------------------------------


def _jax_map(rng, t, n):
    keys = rng.choice(1 << 40, n, replace=False).astype(np.int64)
    keys[::7] += 1 << 41  # some above 2^32
    jt, ok = jhm.insert(jhm.make(t), jnp.asarray(keys),
                        jnp.asarray(np.arange(n, dtype=np.int32)), jnp.ones(n, bool))
    assert bool(np.asarray(ok).all())
    jt = jhm.delete(jt, jnp.asarray(keys), jnp.asarray(rng.random(n) < 0.2))
    return jt, keys


def _fused_case(seed):
    """1-8 deletes on 1-4 JAX maps; the deletes on one map hold distinct
    keys (held, deleted already, absent, strided), ~85 % valid."""
    rng = np.random.default_rng(seed)
    maps = [_jax_map(rng, 1 << int(rng.integers(8, 11)), int(rng.integers(40, 90)))
            for _ in range(int(rng.integers(1, 5)))]
    pools = [list(rng.permutation(np.concatenate(
        [keys, rng.integers(1 << 42, 1 << 50, 60)]))) for _jt, keys in maps]
    deletes = []
    for _ in range(int(rng.integers(1, ops._MAX_DELETES + 1))):
        m = int(rng.integers(0, len(maps)))
        n = min(int(rng.integers(0, 40)), len(pools[m]))
        keys = np.asarray([pools[m].pop() for _ in range(n)], np.int64)
        deletes.append((m, keys, rng.random(n) < 0.85))
    return [jt for jt, _keys in maps], deletes


@pytest.mark.parametrize("seed", range(6))
def test_fused_delete_equals_jax_deletes_one_after_another(seed):
    jmaps, deletes = _fused_case(seed)
    want = list(jmaps)
    for m, keys, valid in deletes:
        want[m] = jhm.delete(want[m], jnp.asarray(keys), jnp.asarray(valid))
    # on CPU tensors: fused_delete_reference, in place; strided key columns
    tables = [thm.HashTable(_t(j.keys), _t(j.vals)) for j in jmaps]
    ops_ = [ops.DeleteOp(m, _t(np.stack([keys, keys + 1], 1))[:, 0], _t(valid))
            for m, keys, valid in deletes]
    ops.reset_launches()
    assert ops.fused_delete(tables, ops_) is None
    assert ops.LAUNCHES["delete"] == 0  # the plain version: nothing launched
    # the card's one launch, emulated with its interleavings
    lists = [list(map(int, np.asarray(j.keys))) for j in jmaps]
    _emulated_deletes(lists, [(m, list(map(int, k)), list(map(bool, v)))
                              for m, k, v in deletes], ops._DELETE_GROUP, seed)
    for j, w in enumerate(want):
        np.testing.assert_array_equal(tables[j].keys.numpy(), np.asarray(w.keys))
        np.testing.assert_array_equal(tables[j].vals.numpy(), np.asarray(w.vals))
        np.testing.assert_array_equal(np.asarray(lists[j], np.int64), np.asarray(w.keys))


def test_delete_is_the_one_op_fused_delete():
    jt, keys = _jax_map(np.random.default_rng(4), 1 << 10, 300)
    valid = np.random.default_rng(5).random(300) < 0.7
    a = thm.HashTable(_t(jt.keys), _t(jt.vals))
    b = thm.HashTable(_t(jt.keys), _t(jt.vals))
    assert ops.delete(a, _t(keys), _t(valid)) is a
    ops.fused_delete([b], [ops.DeleteOp(0, _t(keys), _t(valid))])
    np.testing.assert_array_equal(a.keys.numpy(), b.keys.numpy())
    with pytest.raises(ValueError, match="at most 8"):
        ops._delete_args([a], [ops.DeleteOp(0, _t(keys), _t(valid))] * (ops._MAX_DELETES + 1))


# ---------------------------------------------------------------------------
# argument block and defines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source, define, value", [
    ("hash_update.cu", "ZB_MAX_DELETES", lambda: ops._MAX_DELETES),
    ("hash_update.cu", "ZB_DELETE_THREADS", lambda: ops._DELETE_THREADS),
    ("hash_update.cu", "ZB_DELETE_GROUP", lambda: ops._DELETE_GROUP),
    ("probe.cu", "ZB_PROBE_LEN", lambda: tprobe.PROBES),
])
def test_constants_equal_the_kernels_defines(source, define, value):
    assert _define(source, define) == value()


def test_delete_groups_divide_a_warp_and_blocks_hold_whole_warps():
    for source, name in (("hash_update.cu", "ZB_DELETE_GROUP"), ("probe.cu", "ZB_PROBE_GROUP")):
        assert _define(source, name) in (2, 4, 8, 16, 32)
    assert ops._DELETE_THREADS % 32 == 0
    assert _define("zb_hash.cuh", "ZB_MAX_PROBES") == thm.MAX_PROBES


def test_delete_argument_block_holds_the_deletes():
    """``_delete_args`` on CPU tensors (built the same way for the card):
    each descriptor's fields, packed in one call, read back through the
    ctypes layout the kernel shares; the starts are the plan's."""
    assert ops._DELETE_LAYOUT.size == ctypes.sizeof(ops._DeleteDesc) == 40
    tables = [thm.make(64), thm.make(16)]
    wide = torch.arange(30, dtype=torch.int64).reshape(10, 3)
    deletes = [ops.DeleteOp(0, wide[:, 1], torch.ones(10, dtype=torch.bool)),
               ops.DeleteOp(1, torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool)),
               ops.DeleteOp(1, torch.arange(700, dtype=torch.int32),  # converted to int64
                            torch.zeros(700, dtype=torch.uint8))]     # converted to bool
    args, keep = ops._delete_args(tables, deletes)
    lengths = [op.keys.shape[0] for op in deletes]
    starts = ops.lookup_plan(lengths, ops._DELETE_THREADS)
    assert list(args.start[: len(starts)]) == starts and args.n_ops == len(deletes)
    for j, op in enumerate(deletes):
        d, t, (keys, valid) = args.d[j], tables[op.table], keep[j]
        assert keys.dtype == torch.int64 and valid.dtype == torch.bool
        assert d.tkeys == t.keys.data_ptr()
        assert ((d.keys or 0), (d.valid or 0)) == (keys.data_ptr(), valid.data_ptr())
        assert (d.key_stride, d.mask, d.n) == (keys.stride(0), t.keys.shape[0] - 1, lengths[j])
    assert args.d[0].key_stride == 3 and keep[0][0] is deletes[0].keys  # read in place
    with pytest.raises(ValueError, match="one length"):
        ops._delete_args(tables, [ops.DeleteOp(0, wide[:, 0], torch.ones(3, dtype=torch.bool))])


# ---------------------------------------------------------------------------
# the step: timers and joins, one fused delete
# ---------------------------------------------------------------------------

NOW = 1_000_000
DURATION = 10_000


def _timed_forkjoin_model():
    builder = JBpmn.create_process("timed-fork").start_event("start").parallel_gateway("fork")
    join = JParallelGateway(id="join")
    join.scope_id = "timed-fork"
    builder.model.add(join)
    builder.branch().timer_catch_event("wait", duration_ms=DURATION).connect_to("join")
    builder.branch().service_task("task", type="payment-service").connect_to("join")
    builder.move_to("join").end_event("end")
    return builder.done()


@pytest.fixture(scope="module")
def timed_forkjoin():
    workflows = jtransform(_timed_forkjoin_model())
    for w in workflows:
        w.key, w.version = 9, 1
    jgraph, meta = jg.compile_graph(workflows)
    jgraph = _with_vars(jgraph, meta)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == [
        g for g in tg.FEATURE_GATES if g in ("has_parallel_joins", "has_timers")]
    return jgraph, meta


def _counting_fused_delete(monkeypatch):
    """Record each ``fused_delete`` call's tables and valid counts."""
    calls = []
    real = ops.fused_delete

    def fused_delete(tables, deletes):
        deletes = list(deletes)
        calls.append(([id(t.keys) for t in tables],
                      [int(op.valid.sum()) for op in deletes]))
        return real(tables, deletes)

    monkeypatch.setattr(ops, "fused_delete", fused_delete)
    return calls


def _has_join_arrival(jgraph, cols):
    """True when a valid row of the batch is a join arrival (its step is
    PARALLEL_MERGE)."""
    st = np.asarray(jgraph.step_table)
    wf = np.clip(cols["wf"], 0, st.shape[0] - 1)
    el = np.clip(cols["elem"], 0, st.shape[1] - 1)
    it = np.clip(cols["intent"], 0, st.shape[2] - 1)
    return bool((cols["valid"] & (st[wf, el, it] == int(BpmnStep.PARALLEL_MERGE))).any())


def test_a_timers_and_joins_step_issues_one_fused_delete(timed_forkjoin, monkeypatch):
    """Instances wait at the join (the task done) and on their timers; half
    the timers are triggered, and the next batch that holds their join
    arrivals also takes the other half's TRIGGERs: one step that deletes
    from both maps. Every step equals the JAX step and issues one
    ``fused_delete`` of two deletes (the timer map's, the join map's)."""
    jgraph, meta = timed_forkjoin
    calls = _counting_fused_delete(monkeypatch)
    n, size = 8, 64
    jstate = _subscribed(js.make_state(capacity=256, num_vars=NUM_VARS, job_capacity=256,
                                       join_capacity=64, sub_capacity=8), meta.interns)
    jq = jd.enqueue(jd.make_queue(8 * size * jgraph.emit_width, NUM_VARS),
                    _creates(meta, n, 2, ("orderValue", [1.0])))
    later = None  # the second half's TRIGGER rows, once the first half is queued
    now, both = NOW, 0
    for _round in range(80):
        arrays = jax_state_np(jstate)
        if int(jq.count) == 0:
            if later is not None:
                break
            live = np.nonzero(arrays["timer_key"] >= 0)[0]
            assert len(live) == n and (arrays["join_key"] >= 0).sum() == n
            jq = jd.enqueue(jq, _timer_batch(arrays, [(JTI.TRIGGER, s) for s in live[: n // 2]]))
            later, now = [(JTI.TRIGGER, s) for s in live[n // 2:]], NOW + DURATION
            continue
        jq, batch = jd.dequeue(jq, size)
        cols = {f: np.array(getattr(batch, f)) for f in tb.FIELDS}
        if later and _has_join_arrival(jgraph, cols):
            more = _timer_batch(arrays, later)
            free = np.nonzero(~cols["valid"])[0][: len(later)]
            assert len(free) == len(later)
            for f in tb.FIELDS:
                cols[f][free] = np.asarray(getattr(more, f))[: len(later)]
            later = []
        before = len(calls)
        j_out, t_out = both_steps(jgraph, arrays, jb.RecordBatch(**cols), now,
                                  synthetic_workers=True)
        assert_step_equal(j_out, t_out)
        assert len(calls) == before + 1
        _tables, valid = calls[-1]
        assert len(valid) == 2
        both += valid[0] > 0 and valid[1] > 0
        jstate = j_out[0]
        jq = jd.enqueue(jq, j_out[1])
    assert later == [] and both >= 1
    arrays = jax_state_np(jstate)
    assert (arrays["timer_key"] >= 0).sum() == 0 and (arrays["join_key"] >= 0).sum() == 0


# ---------------------------------------------------------------------------
# the demotion: four maps, one fused delete
# ---------------------------------------------------------------------------


def _three_way_model():
    """A fork into a timer, a task that a worker completes and a task that
    no worker takes, joined: a live instance holds an element-instance, a
    job, a timer and an open join."""
    builder = JBpmn.create_process("three-way").start_event("start").parallel_gateway("fork")
    join = JParallelGateway(id="join")
    join.scope_id = "three-way"
    builder.model.add(join)
    builder.branch().timer_catch_event("wait", duration_ms=DURATION).connect_to("join")
    builder.branch().service_task("quick", type="payment-service").connect_to("join")
    builder.branch().service_task("stuck", type="nobody").connect_to("join")
    builder.move_to("join").end_event("end")
    return builder.done()


def test_a_demotion_issues_one_fused_delete_for_its_four_maps(tmp_path, monkeypatch):
    """CANCEL of an instance that holds a device job, timer and open join
    demotes it to the host oracle: one ``fused_delete`` of four deletes
    (element-instance, job, timer and join maps); the maps no longer hold
    its keys, and the log equals the host oracle's."""
    from test_torch_engine import JAX, PORT, _pay, _port_broker
    from test_tpu_parity import record_signature
    import zeebe_tpu.runtime as jax_runtime

    calls = _counting_fused_delete(monkeypatch)
    inside = []
    real_demote = CudaPartitionEngine._demote_instance

    def demote(self, key):
        inside.append(len(calls))
        real_demote(self, key)
        inside.append(len(calls))

    monkeypatch.setattr(CudaPartitionEngine, "_demote_instance", demote)
    logs = []
    for ns, make in ((JAX, lambda clock: jax_runtime.Broker(num_partitions=1, clock=clock)),
                     (PORT, lambda clock: _port_broker(clock, str(tmp_path / "port")))):
        clock = ns.runtime.ControlledClock(start_ms=NOW)
        broker = make(clock)
        ns.gateway.JobWorker(broker, "payment-service", _pay)
        client = ns.gateway.ZeebeClient(broker)
        ns.deploy(client, _three_way_model())
        first = client.create_instance("three-way", payload={"n": 1})
        client.create_instance("three-way", payload={"n": 2})
        broker.run_until_idle()
        if ns is PORT:
            engine = broker.partitions[0].engine
            s = engine.state
            # the element-instance and job keys may sit in their direct-mapped
            # indexes only: their maps' deletes then find nothing
            held = {name: int((getattr(s, name).keys >= 0).sum())
                    for name in ("ei_map", "job_map", "timer_map", "join_map")}
            assert held["timer_map"] == held["join_map"] == 2
            assert int((s.job_i64[:, 0] >= 0).sum()) == 2
        client.cancel_instance(first.workflow_instance_key)
        broker.run_until_idle()
        if ns is PORT:
            assert len(inside) == 2 and inside[1] == inside[0] + 1
            tables, valid = calls[inside[0]]
            assert tables == [id(getattr(s, name).keys)
                              for name in ("ei_map", "job_map", "timer_map", "join_map")]
            assert valid[1:] == [1, 1, 1] and valid[0] >= 1
            s = engine.state
            assert int((s.job_i64[:, 0] >= 0).sum()) == 1
            assert int((s.timer_map.keys >= 0).sum()) == 1
            assert int((s.join_map.keys >= 0).sum()) == 1
        clock.advance(2 * DURATION)
        broker.tick()
        broker.run_until_idle()
        logs.append(record_signature(broker.records(0)))
        broker.close()
    oracle, port = logs
    assert port == oracle and len(port) > 0


# ---------------------------------------------------------------------------
# the probe: one window step a key
# ---------------------------------------------------------------------------


def _emulated_probe(keys, tkeys, g, seed):
    cap = len(tkeys)
    homes = tprobe._home(_t(np.asarray(keys, np.int64)), cap).tolist()
    table = list(map(int, tkeys))
    out = [None] * len(keys)
    walkers = []
    for warp in _warps(len(keys), [True] * len(keys)):
        for i in warp:
            def done(slot, i=i):
                assert out[i] is None
                out[i] = slot
            walkers.append(_Walker(table, cap - 1, int(keys[i]), homes[i], g, tprobe.PROBES, done))
    _run(walkers, seed)
    assert list(map(int, tkeys)) == table  # read only
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("table", ["script", "hashed"])
def test_probe_window_walk_equals_probe_reference(table):
    rng = np.random.default_rng(2)
    cap, b = 1 << 12, 1000
    if table == "script":
        tkeys = tprobe.script_table(cap).numpy()
        keys = rng.integers(0, cap, b).astype(np.int32)
    else:
        present = rng.choice(2**31 - 1, cap // 2, replace=False)
        tkeys = tprobe.hashed_table(present, cap)
        keys = np.concatenate([rng.choice(present, b // 2),
                               rng.integers(-2**31, 0, b // 2)]).astype(np.int32)
        keys[::50] = tprobe.EMPTY  # the EMPTY sentinel as a key
    want = tprobe.probe_reference(_t(keys), _t(tkeys)).numpy()
    g = _define("probe.cu", "ZB_PROBE_GROUP")
    for group in sorted({g, 4}):
        np.testing.assert_array_equal(_emulated_probe(keys, tkeys, group, group), want)
    if table == "hashed":
        assert (want >= 0).sum() > b // 4 and (want == -1).sum() > b // 4
