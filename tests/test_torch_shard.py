"""zeebe_tpu_torch.tpu.shard against zeebe_tpu.tpu.shard, bit for bit.

The JAX programs run under ``shard_map`` on the virtual host devices that
``tests/conftest.py`` sets up; the port runs every shard on the CPU (a mesh
that names the CPU once per shard). The same seeded numpy inputs feed both.
Tolerance 0 throughout: every compared leaf is an integer or the bits of a
float32.

One difference is expected and pinned: the JAX routed step reduces the
owner's emissions with zeros (``_psum_masked``), which turns a ``-0.0``
payload into ``+0.0``; the port keeps the owner's value, as the
single-device step does.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
import chip_smoke
from test_torch_kernel import _assert_leaf, _bits, jax_state, jax_state_np, port_batch, port_graph
from zeebe_tpu.models.bpmn.builder import Bpmn
from zeebe_tpu.models.transform.transformer import transform_model
from zeebe_tpu.tpu import batch as jb, drive as jdrive, graph as jgraph_mod
from zeebe_tpu.tpu import kernel as jk, shard as jshard, state as js
from zeebe_tpu_torch.tpu import batch as tb, drive as tdrive, kernel as tk
from zeebe_tpu_torch.tpu import shard as tshard, state as ts

CPU = torch.device("cpu")
SEED = 0x5A4DED
NUM_VARS = 8


def _jax_mesh(n, axis=jshard.STATE_AXIS):
    return JaxMesh(np.asarray(jax.devices()[:n]), (axis,))


def _port_mesh(n, axis=tshard.STATE_AXIS):
    return tshard.Mesh([CPU] * n, axis)


# ---------------------------------------------------------------------------
# routing and sizing helpers
# ---------------------------------------------------------------------------


def _key_corpus():
    rng = np.random.default_rng(SEED)
    return np.concatenate([
        np.arange(-8, 4096, dtype=np.int64) * 5 + 1,
        rng.integers(-2**63, 2**63 - 1, size=4096, dtype=np.int64),
        np.array([0, -1, 2**63 - 1, -2**63, 1 << 51, 7 << 51], np.int64),
    ])


@pytest.mark.parametrize("span", [2, 3, 4, 8])
def test_key_hash_matches_jax(span):
    keys = _key_corpus()
    want = np.asarray(jshard.shard_of_key(jnp.asarray(keys), span))
    np.testing.assert_array_equal(tshard.shard_of_key(torch.from_numpy(keys), span).numpy(), want)
    np.testing.assert_array_equal(tshard.shard_of_key_host(keys, span), want)
    np.testing.assert_array_equal(tshard.shard_of_key_host(keys, span),
                                  jshard.shard_of_key_host(keys, span))
    valid = np.random.default_rng(span).random(keys.shape[0]) < 0.7
    np.testing.assert_array_equal(
        tshard.shard_row_counts(torch.from_numpy(keys), torch.from_numpy(valid), span).numpy(),
        np.asarray(jshard.shard_row_counts(jnp.asarray(keys), jnp.asarray(valid), span)))
    np.testing.assert_array_equal(tshard.shard_row_counts_host(keys, valid, span),
                                  jshard.shard_row_counts_host(keys, valid, span))


def _both_states(capacity, **kw):
    return (ts.make_state(capacity=capacity, num_vars=NUM_VARS, device="cpu", **kw),
            js.make_state(capacity=capacity, num_vars=NUM_VARS, **kw))


def _jax_specs(jstate, span):
    """{dotted leaf name: sharded?} of the JAX spec tree."""
    names = [name for name in jax_state_np(jstate)]
    specs = jax.tree_util.tree_leaves(jshard.state_partition_specs(jstate, span),
                                      is_leaf=lambda x: isinstance(x, P))
    return {n: tuple(s) == (jshard.STATE_AXIS,) for n, s in zip(names, specs)}


@pytest.mark.parametrize("span,capacity", [(2, 1024), (4, 1024), (8, 256), (3, 768), (3, 1000)])
def test_partition_specs_match_jax(span, capacity):
    """The port shards exactly the leaves JAX shards; 3 does not divide the
    pow2 map and index tables, which both replicate."""
    tstate, jstate = _both_states(capacity)
    got = tshard.state_partition_specs(tstate, span)
    want = _jax_specs(jstate, span)
    assert list(got) == list(want)
    assert {n: s == (tshard.STATE_AXIS,) for n, s in got.items()} == want
    assert tshard.unshardable_state_leaves(tstate, span) == \
        jshard.unshardable_state_leaves(jstate, span)
    for include in (True, False):
        assert tshard.state_exchange_bytes(tstate, span, include_lookup=include) == \
            jshard.state_exchange_bytes(jstate, span, include_lookup=include)
    names = list(got)
    assert [tshard.is_lookup_leaf(n) for n in names] == [jshard.is_lookup_leaf(n) for n in names]


@pytest.mark.parametrize("span", [2, 4])
def test_routed_exchange_bytes_match_jax(span):
    tbatch = tb.empty(96, NUM_VARS, device="cpu")
    jbatch = jb.empty(96, NUM_VARS)
    assert tshard.routed_exchange_bytes(tbatch, span) == jshard.routed_exchange_bytes(jbatch, span)


@pytest.mark.parametrize("span", [2, 4])
def test_scope_translation_matches_jax(span):
    rng = np.random.default_rng(span)
    rows = 64
    g = rng.integers(-3, rows * span + 5, size=(rows, 6)).astype(np.int32)
    for idx in range(span):
        want_local = np.asarray(jk.scope_to_local(jnp.asarray(g), idx, rows))
        got_local = tk.scope_to_local(torch.from_numpy(g.copy()), idx, rows).numpy()
        np.testing.assert_array_equal(got_local, want_local)
        moved = want_local.copy()
        # the kernel moved some rows and left the POISON ones alone
        step = rng.random(rows) < 0.3
        moved[step, 3] = rng.integers(-1, rows, size=int(step.sum()))
        prev = g[:, 3].copy()
        want = np.asarray(jk.scope_to_global(jnp.asarray(moved), jnp.asarray(prev), idx, rows))
        got = tk.scope_to_global(torch.from_numpy(moved.copy()), torch.from_numpy(prev),
                                 idx, rows).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the three state steps
# ---------------------------------------------------------------------------


def _jax_sharded(mesh, arrays):
    st = jax_state(arrays)
    return jax.device_put(st, jshard.state_shardings(mesh, st))


def _port_sharded(mesh, arrays):
    return tshard.shard_state(mesh, ts.state_from_numpy(arrays, device="cpu"))


def _global_np(sstate):
    return ts.state_to_numpy(tshard.gather_state(sstate))


def _assert_states(got, want, skip=()):
    assert sorted(got) == sorted(want)
    for name in want:
        if name not in skip:
            _assert_leaf(name, got[name], want[name])


def _assert_outs(t_out, t_stats, j_out, j_stats, sign_of_zero=False):
    """Emissions and stats equal; with ``sign_of_zero`` the JAX side may
    hold +0.0 where the port holds -0.0 (its zero-sum reduction), and
    nowhere else differs. Returns the count of such positions."""
    flips = 0
    for name in tb.FIELDS:
        got, want = getattr(t_out, name).numpy(), np.asarray(getattr(j_out, name))
        if sign_of_zero and name == "v_num":
            diff = _bits(got) != _bits(want)
            assert (_bits(got)[diff] == np.int32(-2**31)).all() and (_bits(want)[diff] == 0).all()
            flips += int(diff.sum())
            continue
        _assert_leaf(name, got, want)
    assert sorted(t_stats) == sorted(j_stats)
    for name in j_stats:
        _assert_leaf(name, t_stats[name].numpy(), j_stats[name])
    return flips


def _mixed(span):
    _fn, (jgraph, _s, _b, _n) = graft.entry()
    arrays, cols = chip_smoke.mixed_case(np.random.default_rng(100 + span), 1024, 256)
    return jgraph, arrays, cols


@pytest.mark.parametrize("span", [2, 4])
def test_gathered_step_matches_jax_and_the_single_device_step(span):
    jgraph, arrays, cols = _mixed(span)
    jbatch = jb.RecordBatch(**{n: jnp.asarray(a) for n, a in cols.items()})
    now, pid = 5_000, 3
    jmesh = _jax_mesh(span)
    jfn = jshard.build_state_step(jmesh, jax_state(arrays))
    jst, jout, jstats = jfn(jgraph, _jax_sharded(jmesh, arrays), jbatch,
                            jnp.asarray(now, jnp.int64), jnp.asarray(pid, jnp.int32))
    mesh = _port_mesh(span)
    tfn = tshard.build_state_step(mesh, ts.state_from_numpy(arrays, device="cpu"))
    sst, tout, tstats = tfn(port_graph(jgraph), _port_sharded(mesh, arrays),
                            port_batch(jbatch), now, pid)
    _assert_states(_global_np(sst), jax_state_np(jst))
    _assert_outs(tout, tstats, jout, jstats)
    single = tk.step_kernel(port_graph(jgraph), ts.state_from_numpy(arrays, device="cpu"),
                            port_batch(jbatch), now, partition_id=pid)
    _assert_states(_global_np(sst), ts.state_to_numpy(single[0]))
    _assert_outs(tout, tstats, single[1], {k: v.numpy() for k, v in single[2].items()})
    # the blocks hold the global table's rows, on their shard
    ei = jax_state_np(jst)["ei_i32"]
    rows = ei.shape[0] // span
    for d, block in enumerate(sst.shards):
        np.testing.assert_array_equal(block.ei_i32.numpy(), ei[d * rows:(d + 1) * rows])
        assert block.sub_key.shape == (64,)  # replicated, whole


@pytest.mark.parametrize("span", [2, 4])
def test_fallback_step_matches_jax_and_the_single_device_step(span):
    """The fallback rebuilds the lookup structures from the gathered rows,
    whatever the blocks held: the single-device step of the rebuilt state."""
    jgraph, arrays, cols = _mixed(span)
    stale = dict(arrays)
    for name in ("ei_index", "job_index", "ei_map.keys", "free_ei"):
        stale[name] = np.random.default_rng(span).permutation(arrays[name])
    jbatch = jb.RecordBatch(**{n: jnp.asarray(a) for n, a in cols.items()})
    now, pid = 5_000, 1
    jmesh = _jax_mesh(span)
    jfn = jshard.build_state_step_fallback(jmesh, jax_state(stale))
    jst, jout, jstats = jfn(jgraph, _jax_sharded(jmesh, stale), jbatch,
                            jnp.asarray(now, jnp.int64), jnp.asarray(pid, jnp.int32))
    mesh = _port_mesh(span)
    tfn = tshard.build_state_step_fallback(mesh, ts.state_from_numpy(stale, device="cpu"))
    sst, tout, tstats = tfn(port_graph(jgraph), _port_sharded(mesh, stale),
                            port_batch(jbatch), now, pid)
    _assert_states(_global_np(sst), jax_state_np(jst))
    _assert_outs(tout, tstats, jout, jstats)
    rebuilt = ts.rebuild_lookup_state(ts.state_from_numpy(arrays, device="cpu"))
    single = tk.step_kernel(port_graph(jgraph), rebuilt, port_batch(jbatch), now, partition_id=pid)
    _assert_states(_global_np(sst), ts.state_to_numpy(single[0]))


def _order_graph():
    jgraph, meta = graft._graph_and_meta()
    num_vars = max(jgraph.num_vars, NUM_VARS)
    return dataclasses.replace(jgraph, num_vars=num_vars), meta


def _subscribed(arrays, meta, credits):
    arrays = dict(arrays)
    for name, value in (("sub_key", 1), ("sub_type", meta.interns.intern("payment-service")),
                        ("sub_worker", meta.interns.intern("w")), ("sub_credits", credits),
                        ("sub_timeout", 300_000), ("sub_valid", True)):
        arrays[name] = arrays[name].copy()
        arrays[name][0] = value
    return arrays


def _next_batch(out, size=64):
    """The valid rows of an emission batch, as the next wave's batch."""
    o = tb.batch_to_numpy(out)
    keep = np.nonzero(o["valid"])[0]
    nxt = tb.batch_to_numpy(tb.empty(max(size, 1 << int(len(keep) - 1).bit_length()),
                                     out.num_vars, device="cpu"))
    for name in tb.FIELDS:
        nxt[name][: len(keep)] = o[name][keep]
    nxt["src"][: len(keep)] = -1
    return nxt


def _lanes(span, owner, cols):
    """The JAX routed program's lanes: the batch in the owner's, the
    staging defaults everywhere else."""
    blank = jb.empty(cols["valid"].shape[0], cols["v_vt"].shape[1])
    empty = {n: np.asarray(getattr(blank, n)) for n in tb.FIELDS}
    lanes = {n: np.stack([cols[n] if d == owner else empty[n] for d in range(span)])
             for n in tb.FIELDS}
    return jb.RecordBatch(**{n: jnp.asarray(a) for n, a in lanes.items()})


@pytest.mark.parametrize("span", [2, 4])
def test_routed_step_chain_matches_jax_and_the_single_device_step(span):
    """A CREATE wave and the waves of its follow-ups, each routed to the
    owner of the first new instance key (what the engine does): the port's
    state equals the JAX program's, but for the lookup scratch of the shards
    it does not step; the JAX program leaves those shards' other leaves as
    they were, which is why stepping only the owner is the same program;
    and the emissions equal the single-device step's. One CREATE carries a
    -0.0 payload, which the JAX reduction turns into +0.0."""
    jgraph, meta = _order_graph()
    graph = port_graph(jgraph)
    num_vars = jgraph.num_vars
    arrays = _subscribed(ts.state_to_numpy(ts.make_state(capacity=1024, num_vars=num_vars,
                                                          device="cpu")), meta, 4)
    owner = int(tshard.shard_of_key_host(int(arrays["next_wf_key"]), span))
    cols = {n: np.asarray(getattr(graft._create_batch(meta, 64, 12, num_vars), n))
            for n in tb.FIELDS}
    cols["v_num"] = cols["v_num"].copy()
    cols["v_num"][3, meta.varspace.column("orderValue")] = -0.0
    jmesh, mesh = _jax_mesh(span), _port_mesh(span)
    template = ts.state_from_numpy(arrays, device="cpu")
    jfn = jshard.build_state_step_routed(jmesh, jax_state(arrays))
    tfn = tshard.build_state_step_routed(mesh, template)
    jst = _jax_sharded(jmesh, arrays)
    sst = _port_sharded(mesh, arrays)
    single = ts.state_from_numpy(arrays, device="cpu")
    lanes_spec = NamedSharding(jmesh, P(jshard.STATE_AXIS))
    rows = 1024 // span
    flips = waves = 0
    while cols["valid"].any() and waves < 8:
        before = jax_state_np(jst)
        jst, jout, jstats = jfn(jgraph, jst, jax.device_put(_lanes(span, owner, cols), lanes_spec),
                                jnp.asarray(1_000, jnp.int64), jnp.asarray(0, jnp.int32))
        sst, tout, tstats = tfn(graph, sst, tb.batch_from_numpy(cols, device="cpu"),
                                owner, 1_000, 0)
        want, got = jax_state_np(jst), _global_np(sst)
        for name in want:
            if tshard.is_lookup_leaf(name):
                if tshard.state_partition_specs(template, span)[name]:
                    per = want[name].shape[0] // span
                    blk = slice(owner * per, (owner + 1) * per)
                    _assert_leaf(name, got[name][blk], want[name][blk])
                continue
            _assert_leaf(name, got[name], want[name])
            if tshard.state_partition_specs(template, span)[name]:
                per = want[name].shape[0] // span
                for d in range(span):
                    if d != owner:
                        blk = slice(d * per, (d + 1) * per)
                        _assert_leaf(f"{name} untouched", want[name][blk], before[name][blk])
        flips += _assert_outs(tout, tstats, jout, jstats, sign_of_zero=True)
        single, sout, sstats = tk.step_kernel(graph, single, tb.batch_from_numpy(cols, device="cpu"),
                                              1_000, partition_id=0)
        _assert_outs(tout, tstats, sout, {k: v.numpy() for k, v in sstats.items()})
        # the owner's rows stay in its block
        ei = got["ei_i32"]
        live = np.nonzero(ei[:, 1] >= 0)[0]
        assert ((live >= owner * rows) & (live < (owner + 1) * rows)).all()
        cols = _next_batch(tout)
        waves += 1
    assert waves >= 3 and flips > 0


# ---------------------------------------------------------------------------
# partitions as shards: the sharded step, the exchange and the drive
# ---------------------------------------------------------------------------

N_PART = 4
CAP = 256
BATCH = 64


def _port_partitioned(meta, num_vars, counts=None, capacity=CAP):
    states = tshard.make_partitioned_state(N_PART, capacity, num_vars, devices=[CPU] * N_PART,
                                           sub_capacity=8)
    out = []
    for st in states:
        arrays = ts.state_to_numpy(st)
        arrays = _subscribed(arrays, meta, 2**30)
        out.append(arrays)
    return out


def _stack(dicts):
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def _jax_partitioned(arrays_list):
    stacked = _stack(arrays_list)
    return jax_state(stacked)


def _port_states(arrays_list):
    return [ts.state_from_numpy(a, device="cpu") for a in arrays_list]


def _creates(meta, count, num_vars, value=99.0):
    b = graft._create_batch(meta, BATCH, count, num_vars)
    cols = {n: np.asarray(getattr(b, n)).copy() for n in tb.FIELDS}
    cols["v_num"][:count, meta.varspace.column("orderValue")] = value
    return cols


def _queues(creates, num_vars, qcap=8 * BATCH):
    jq = jshard.make_partitioned_queue(N_PART, qcap, num_vars)
    jq = jax.jit(jax.vmap(jdrive.enqueue))(
        jq, jb.RecordBatch(**{n: jnp.asarray(a) for n, a in _stack(creates).items()}))
    tq = []
    for c in creates:
        q = tdrive.make_queue(qcap, num_vars, device="cpu")
        tq.append(tdrive.enqueue(q, tb.batch_from_numpy(c, device="cpu")))
    return jq, tq


def _assert_partitions(tstates, jstate):
    want = jax_state_np(jstate)
    for p, st in enumerate(tstates):
        got = ts.state_to_numpy(st)
        for name in want:
            _assert_leaf(f"{name} partition {p}", got[name], want[name][p])


def _assert_totals(ttotals, jtotals):
    jt = jax.device_get(jtotals)
    for k in ("processed", "emitted", "completed_roots", "rounds", "overflow"):
        np.testing.assert_array_equal(np.array([np.asarray(t[k]) for t in ttotals]),
                                      np.asarray(jt[k]), err_msg=k)


def test_sharded_step_exchange_matches_jax():
    """The all_to_all of ``build_sharded_step``: source p addresses q with
    a recognisable key and payload; states, emissions, arrivals and the
    summed counts equal JAX's."""
    jgraph, meta = _order_graph()
    num_vars = jgraph.num_vars
    slots = 8
    sends = {n: np.asarray(getattr(jb.empty(slots, num_vars), n)) for n in tb.FIELDS}
    sends = {n: np.broadcast_to(a, (N_PART, N_PART) + a.shape).copy() for n, a in sends.items()}
    for p in range(N_PART):
        for q in range(N_PART):
            sends["key"][p, q, 0] = p * 100 + q
            sends["valid"][p, q, 0] = True
            sends["v_num"][p, q, 0, 0] = float(p * 1000 + q)
    arrays = _port_partitioned(meta, num_vars)
    creates = [_creates(meta, 4 * p, num_vars) for p in range(N_PART)]
    jfn, nparts = jshard.build_sharded_step(_jax_mesh(N_PART, "partitions"))
    jst, jout, jin, jtotal, jpend = jfn(
        jgraph, _jax_partitioned(arrays),
        jb.RecordBatch(**{n: jnp.asarray(a) for n, a in _stack(creates).items()}),
        jb.RecordBatch(**{n: jnp.asarray(a) for n, a in sends.items()}),
        jnp.asarray(0, jnp.int64))
    tfn, tparts = tshard.build_sharded_step(_port_mesh(N_PART, "partitions"))
    tsends = [[tb.batch_from_numpy({n: sends[n][p, q] for n in tb.FIELDS}, device="cpu")
               for q in range(N_PART)] for p in range(N_PART)]
    tst, tout, tin, ttotal, tpend = tfn(
        port_graph(jgraph), _port_states(arrays),
        [tb.batch_from_numpy(c, device="cpu") for c in creates], tsends, 0)
    assert nparts == tparts == N_PART
    blank = tshard.make_partitioned_batch(N_PART, 8, num_vars, devices=[CPU] * N_PART)
    assert [(b.size, b.num_vars, bool(b.valid.any())) for b in blank] == [(8, num_vars, False)] * 4
    buffer = tshard.make_exchange(N_PART, slots, num_vars, devices=[CPU] * N_PART)
    assert [[b.size for b in row] for row in buffer] == [[slots] * N_PART] * N_PART
    _assert_partitions(tst, jst)
    for p in range(N_PART):
        for name in tb.FIELDS:
            _assert_leaf(f"out {name} {p}", getattr(tout[p], name).numpy(),
                         np.asarray(getattr(jout, name))[p])
            for s in range(N_PART):
                _assert_leaf(f"in {name} {p} {s}", getattr(tin[p][s], name).numpy(),
                             np.asarray(getattr(jin, name))[p, s])
        assert int(tin[p][1].key[0]) == 100 + p
    np.testing.assert_array_equal([int(t) for t in ttotal], np.asarray(jtotal))
    np.testing.assert_array_equal([int(t) for t in tpend], np.asarray(jpend))


def test_sharded_drive_matches_jax():
    """Uneven loads drive to quiescence: every partition's state, queue
    count and totals equal the JAX lockstep program's (its idle partitions
    step empty batches, which change nothing)."""
    jgraph, meta = _order_graph()
    num_vars = jgraph.num_vars
    arrays = _port_partitioned(meta, num_vars)
    per_part = [4, 16, 0, 9]
    creates = [_creates(meta, n, num_vars, value=float(10 + n)) for n in per_part]
    jq, tq = _queues(creates, num_vars)
    jrun = jshard.build_sharded_drive(_jax_mesh(N_PART, "partitions"), BATCH,
                                      synthetic_workers=True)
    jst, jq, jtot = jrun(jgraph, _jax_partitioned(arrays), jq, jnp.asarray(0, jnp.int64))
    trun = tshard.build_sharded_drive(_port_mesh(N_PART, "partitions"), BATCH,
                                      synthetic_workers=True)
    tst, tq, ttot = trun(port_graph(jgraph), _port_states(arrays), tq, 0)
    _assert_partitions(tst, jst)
    _assert_totals(ttot, jtot)
    assert [int(t["completed_roots"]) for t in ttot] == per_part
    np.testing.assert_array_equal([int(q.count) for q in tq], np.asarray(jq.count))


def _msg_graph():
    model = (
        Bpmn.create_process("msgflow").start_event("start")
        .receive_task("wait", message_name="paid", correlation_key="$.oid")
        .end_event("done").done()
    )
    workflows = transform_model(model)
    for wf in workflows:
        wf.key, wf.version = 9, 1
    jgraph, meta = jgraph_mod.compile_graph(workflows)
    return dataclasses.replace(jgraph, num_vars=max(jgraph.num_vars, NUM_VARS)), meta


def _msg_cols(meta, num_vars, creates=(), publishes=()):
    from zeebe_tpu.protocol.enums import RecordType, ValueType
    from zeebe_tpu.protocol.intents import MessageIntent as MI
    from zeebe_tpu.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu.tpu.conditions import VT_BOOL, VT_STR

    cols = {n: np.asarray(getattr(jb.empty(BATCH, num_vars), n)).copy() for n in tb.FIELDS}
    for i, oid in enumerate(creates):
        cols["valid"][i] = True
        cols["rtype"][i], cols["vtype"][i] = int(RecordType.COMMAND), int(ValueType.WORKFLOW_INSTANCE)
        cols["intent"][i], cols["wf"][i] = int(WI.CREATE), 0
        cols["v_vt"][i, meta.varspace.column("oid")] = VT_STR
        cols["v_str"][i, meta.varspace.column("oid")] = meta.interns.intern(oid)
    for i, oid in enumerate(publishes):
        cols["valid"][i] = True
        cols["rtype"][i], cols["vtype"][i] = int(RecordType.COMMAND), int(ValueType.MESSAGE)
        cols["intent"][i] = int(MI.PUBLISH)
        cols["v_vt"][i, meta.varspace.column("paid")] = VT_BOOL
        cols["v_num"][i, meta.varspace.column("paid")] = 1.0
        cols["type_id"][i] = meta.interns.intern("paid")
        cols["retries"][i] = int(VT_STR)
        cols["worker"][i] = meta.interns.intern(oid)
    return cols


def test_sharded_drive_correlation_matches_jax():
    """Message correlation across partitions: the OPENs ride the exchange
    to the key's hash partition, then the PUBLISHes staged at their owner
    correlate back. Every partition's state and the totals equal JAX's."""
    jgraph, meta = _msg_graph()
    num_vars = jgraph.num_vars
    arrays = [ts.state_to_numpy(st) for st in tshard.make_partitioned_state(
        N_PART, CAP, num_vars, devices=[CPU] * N_PART)]
    oids = {p: [f"o-{p}-{i}" for i in range(3)] for p in range(N_PART)}
    jmesh, mesh = _jax_mesh(N_PART, "partitions"), _port_mesh(N_PART, "partitions")
    jrun = jshard.build_sharded_drive(jmesh, BATCH, exchange_slots=BATCH)
    trun = tshard.build_sharded_drive(mesh, BATCH, exchange_slots=BATCH)
    jq, tq = _queues([_msg_cols(meta, num_vars, creates=oids[p]) for p in range(N_PART)],
                     num_vars, qcap=32 * BATCH)
    jst, jq, jtot = jrun(jgraph, _jax_partitioned(arrays), jq, jnp.int64(1_000))
    tst, tq, ttot = trun(port_graph(jgraph), _port_states(arrays), tq, 1_000)
    _assert_partitions(tst, jst)
    _assert_totals(ttot, jtot)
    pubs = {p: [] for p in range(N_PART)}
    for p in range(N_PART):
        for oid in oids[p]:
            owner = tshard.correlation_route(_route_batch(meta, num_vars, oid), N_PART, -1)[0]
            pubs[int(owner)].append(oid)
    assert len([p for p in pubs if pubs[p]]) > 1
    pub_cols = [_msg_cols(meta, num_vars, publishes=pubs[p]) for p in range(N_PART)]
    jq = jax.jit(jax.vmap(jdrive.enqueue))(
        jq, jb.RecordBatch(**{n: jnp.asarray(a) for n, a in _stack(pub_cols).items()}))
    tq = [tdrive.enqueue(q, tb.batch_from_numpy(c, device="cpu")) for q, c in zip(tq, pub_cols)]
    jst, jq, jtot = jrun(jgraph, jst, jq, jnp.int64(2_000))
    tst, tq, ttot = trun(port_graph(jgraph), tst, tq, 2_000)
    _assert_partitions(tst, jst)
    _assert_totals(ttot, jtot)
    assert sum(int(t["completed_roots"]) for t in ttot) == 3 * N_PART


def _route_batch(meta, num_vars, oid):
    """A one-row MESSAGE_SUBSCRIPTION command for ``oid``: its route is the
    correlation key's hash partition (where the PUBLISH must be staged)."""
    from zeebe_tpu.protocol.enums import RecordType, ValueType
    from zeebe_tpu.tpu.conditions import VT_STR

    cols = {n: np.asarray(getattr(jb.empty(1, num_vars), n)).copy() for n in tb.FIELDS}
    cols["valid"][0] = True
    cols["rtype"][0] = int(RecordType.COMMAND)
    cols["vtype"][0] = int(ValueType.MESSAGE_SUBSCRIPTION)
    cols["type_id"][0] = meta.interns.intern("paid")
    cols["retries"][0] = int(VT_STR)
    cols["worker"][0] = meta.interns.intern(oid)
    return tb.batch_from_numpy(cols, device="cpu")


def test_correlation_route_matches_jax():
    jgraph, meta = _msg_graph()
    rng = np.random.default_rng(SEED)
    cols = {n: np.asarray(getattr(jb.empty(256, jgraph.num_vars), n)).copy() for n in tb.FIELDS}
    cols["valid"] = rng.random(256) < 0.8
    cols["rtype"][:] = rng.integers(0, 3, 256)
    cols["vtype"][:] = rng.choice([5, 9, 10, 11, 12], 256)
    cols["type_id"][:] = rng.integers(0, 50, 256)
    cols["retries"][:] = rng.integers(0, 4, 256)
    cols["worker"][:] = rng.integers(-2**31, 2**31 - 1, 256)
    cols["wf"][:] = rng.integers(-3, 9, 256)
    for nparts in (2, 3, 4):
        for pid in (0, nparts - 1):
            want = np.asarray(jshard.correlation_route(
                jb.RecordBatch(**{n: jnp.asarray(a) for n, a in cols.items()}), nparts, pid))
            got = tshard.correlation_route(tb.batch_from_numpy(cols, device="cpu"), nparts, pid)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("devices", [2, 4])
def test_frame_exchange_matches_jax(devices):
    rng = np.random.default_rng(devices)
    slots, width = 4, 32
    buf = rng.integers(0, 256, size=(devices, devices, slots, width), dtype=np.uint8)
    lens = rng.integers(-1, width, size=(devices, devices, slots)).astype(np.int32)
    pids = rng.integers(-1, 8, size=(devices, devices, slots)).astype(np.int32)
    want = jshard.build_frame_exchange(_jax_mesh(devices, "exchange"), slots, width)(
        buf, lens, pids)
    got = tshard.build_frame_exchange(_port_mesh(devices, "exchange"), slots, width)(
        buf, lens, pids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="buf shape"):
        tshard.build_frame_exchange(_port_mesh(devices, "exchange"), slots, width)(
            buf[:, :, :1], lens, pids)


def test_run_to_quiescence_unsynced_returns_device_totals():
    """``sync=False``: the totals stay tensors (rounds and the overflow flag
    among them) and equal the synced run's; an overflow raises nothing."""
    jgraph, meta = _order_graph()
    num_vars = jgraph.num_vars
    arrays = _port_partitioned(meta, num_vars)[0]
    creates = _creates(meta, 12, num_vars)
    results = []
    for sync in (True, False):
        q = tdrive.enqueue(tdrive.make_queue(8 * BATCH, num_vars, device="cpu"),
                           tb.batch_from_numpy(creates, device="cpu"))
        st, q, totals = tdrive.run_to_quiescence(
            port_graph(jgraph), ts.state_from_numpy(arrays, device="cpu"), q, 0, BATCH,
            synthetic_workers=True, sync=sync)
        results.append((ts.state_to_numpy(st), totals))
    (st_s, synced), (st_u, unsynced) = results
    assert all(isinstance(v, torch.Tensor) for v in unsynced.values())
    assert not bool(unsynced.pop("overflow"))
    assert {k: int(v) for k, v in unsynced.items()} == synced
    _assert_states(st_u, st_s)
    # a table too small: the unsynced drive stops and reports, the synced raises
    tiny = ts.state_to_numpy(ts.make_state(capacity=8, num_vars=num_vars, device="cpu"))
    tiny = _subscribed(tiny, meta, 2**30)
    for sync in (False, True):
        q = tdrive.enqueue(tdrive.make_queue(8 * BATCH, num_vars, device="cpu"),
                           tb.batch_from_numpy(_creates(meta, 40, num_vars), device="cpu"))
        if sync:
            with pytest.raises(RuntimeError, match="overflow"):
                tdrive.run_to_quiescence(port_graph(jgraph), ts.state_from_numpy(tiny, device="cpu"),
                                         q, 0, BATCH, synthetic_workers=True)
        else:
            _st, _q, t = tdrive.run_to_quiescence(
                port_graph(jgraph), ts.state_from_numpy(tiny, device="cpu"), q, 0, BATCH,
                synthetic_workers=True, sync=False)
            assert bool(t["overflow"])
