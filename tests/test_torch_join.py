"""The parallel fork/join path (BASELINE config 3, ``bench.build_graph_forkjoin``)
of the zeebe_tpu_torch step kernel and drive loop against zeebe_tpu's, bit
for bit, on the CPU with the kernels' plain versions.

Step level: the JAX kernel is walked round by round from a CREATE wave;
at every round both kernels step the same numpy state and batch, and
state, emissions and stats must be equal. Drive level: three waves through
``run_to_quiescence`` with a lookup-state rebuild between waves.
"""

import dataclasses

import jax
import numpy as np

import bench
from test_torch_drive import _subscribed
from test_torch_kernel import _assert_leaf, assert_step_equal, both_steps, jax_state_np
from test_torch_kernel import port_batch, port_graph
from zeebe_tpu.models.transform.steps import BpmnStep
from zeebe_tpu.tpu import batch as jb, drive as jd, state as js
from zeebe_tpu.tpu import graph as jg
from zeebe_tpu_torch.tpu import batch as tb, drive as td, graph as tg
from zeebe_tpu_torch.tpu import ops, state as ts

NUM_VARS = 8
RECORDS_PER_INSTANCE = 36
_jrebuild = jax.jit(js.rebuild_lookup_state)


def _forkjoin():
    jgraph, meta = bench.build_graph_forkjoin()
    for name in ("orderId", "orderValue", "paid"):
        meta.varspace.column(name)
    jgraph = dataclasses.replace(jgraph, num_vars=NUM_VARS)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == ["has_parallel_joins"]
    return jgraph, meta


def _jax_state(meta, capacity, join_capacity):
    return _subscribed(js.make_state(
        capacity=capacity, num_vars=NUM_VARS, job_capacity=capacity,
        join_capacity=join_capacity, sub_capacity=8,
    ), meta.interns)


def _merge_rows(jgraph, cols):
    """[B] bool: the rows whose step is PARALLEL_MERGE (a join arrival)."""
    st = np.asarray(jgraph.step_table)
    wf = np.clip(cols["wf"], 0, st.shape[0] - 1)
    el = np.clip(cols["elem"], 0, st.shape[1] - 1)
    it = np.clip(cols["intent"], 0, st.shape[2] - 1)
    return cols["valid"] & (st[wf, el, it] == int(BpmnStep.PARALLEL_MERGE))


def _scramble_payloads(rng, rows, cols):
    """Give the join arrivals their own variables: per variable absent, a
    number or a string id, so arrivals carry different variables and the
    same variable with different values."""
    n = int(rows.sum())
    vt = rng.choice([0, 3, 4], size=(n, NUM_VARS), p=[0.3, 0.4, 0.3]).astype(np.int8)
    cols["v_vt"][rows] = vt
    cols["v_num"][rows] = rng.normal(size=(n, NUM_VARS)).astype(np.float32)
    cols["v_str"][rows] = rng.integers(0, 40, size=(n, NUM_VARS)).astype(np.int32)


def _walk(jgraph, jstate, creates, batch_size, max_rounds, scramble=None,
          stop_on_overflow=False):
    """Step both kernels round by round from the JAX queue; returns what
    the join arrivals did: (joins completed within one batch, second
    arrivals of joins opened by an earlier batch, overflowed steps)."""
    qcap = 4 * max(creates.valid.shape[0], batch_size) * jgraph.emit_width
    jq = jd.enqueue(jd.make_queue(qcap, NUM_VARS), creates)
    same_batch = later_batch = overflowed = 0
    for _round in range(max_rounds):
        if int(jq.count) == 0:
            break
        jq, batch = jd.dequeue(jq, batch_size)
        cols = {n: np.array(getattr(batch, n)) for n in tb.FIELDS}
        merge = _merge_rows(jgraph, cols)
        if scramble is not None:
            _scramble_payloads(scramble, merge, cols)
        batch = jb.RecordBatch(**{n: np.asarray(a) for n, a in cols.items()})
        arrays = jax_state_np(jstate)
        j_out, t_out = both_steps(jgraph, arrays, batch, 0, synthetic_workers=True)
        assert_step_equal(j_out, t_out)
        gw = np.asarray(jgraph.elem_meta)[cols["wf"].clip(0), cols["elem"].clip(0),
                                          jg.EM_FLOW_TGT]
        keys = (cols["scope_key"][merge] << 10) | gw[merge].astype(np.int64)
        uniq, counts = np.unique(keys, return_counts=True)
        same_batch += int((counts > 1).sum())
        later_batch += int(np.isin(uniq[counts == 1], arrays["join_key"]).sum())
        overflowed += int(np.asarray(j_out[2]["overflow"]))
        if stop_on_overflow and overflowed:
            break
        jstate, emitted = j_out[0], j_out[1]
        jq = jd.enqueue(jq, emitted)
    return same_batch, later_batch, overflowed


def test_join_arrivals_within_and_across_batches():
    """Batches of 7 rows: some joins get both arrivals in one batch, others
    one arrival per batch (the second finds the join opened earlier); the
    arrivals carry scrambled payloads, so the flow-position stamps decide
    the merged payload."""
    jgraph, meta = _forkjoin()
    jstate = _jax_state(meta, capacity=64, join_capacity=64)
    creates = bench.stage_creates(meta, 4, NUM_VARS, meta.interns)
    same, later, over = _walk(jgraph, jstate, creates, 5, 60,
                              scramble=np.random.default_rng(3))
    assert same > 0 and later > 0 and over == 0


def test_join_overflow_with_fewer_join_slots_than_leaders():
    jgraph, meta = _forkjoin()
    jstate = _jax_state(meta, capacity=64, join_capacity=2)
    creates = bench.stage_creates(meta, 4, NUM_VARS, meta.interns)
    _same, _later, over = _walk(jgraph, jstate, creates, 64, 40, stop_on_overflow=True)
    assert over == 1


def test_run_to_quiescence_config3_three_waves():
    """3 waves of 256 CREATEs with synthetic workers and a lookup-state
    rebuild between waves (the rebuild goes through ops.insert): equal
    state and totals every wave, 36 records processed per instance."""
    jgraph, meta = _forkjoin()
    wave = 256
    jstate = _jax_state(meta, capacity=4 * wave, join_capacity=4 * wave)
    tgraph = port_graph(jgraph)
    tstate = ts.state_from_numpy(jax_state_np(jstate), device="cpu")
    qcap = 4 * wave * max(2, jgraph.emit_width)
    jq, tq = jd.make_queue(qcap, NUM_VARS), td.make_queue(qcap, NUM_VARS, device="cpu")
    creates = bench.stage_creates(meta, wave, NUM_VARS, meta.interns)
    tcreates = port_batch(creates)
    ops.reset_launches()
    for _wave in range(3):
        jq = jd.enqueue(jq, creates)
        tq = td.enqueue(tq, tcreates)
        jstate, jq, jtot = jd.run_to_quiescence(jgraph, jstate, jq, 0, wave,
                                                synthetic_workers=True)
        tstate, tq, ttot = td.run_to_quiescence(tgraph, tstate, tq, 0, wave,
                                                synthetic_workers=True)
        assert ttot == jtot
        assert ttot["processed"] == RECORDS_PER_INSTANCE * wave
        assert ttot["completed_roots"] == wave
        jstate = _jrebuild(jstate)
        tstate = ts.rebuild_lookup_state(tstate)
        want, got = jax_state_np(jstate), ts.state_to_numpy(tstate)
        for name in want:
            _assert_leaf(name, got[name], want[name])
    assert int(tq.count) == 0 and not bool(tq.overflow)
    assert sum(ops.LAUNCHES.values()) == 0
