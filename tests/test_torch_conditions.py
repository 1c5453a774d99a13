"""Exclusive gateways and I/O mappings (the ``has_conditions`` and
``has_mappings`` gates; BASELINE config 2, ``bench.build_graph_xor``) in
the zeebe_tpu_torch step kernel against zeebe_tpu's, bit for bit, on the
CPU with the kernels' plain versions.

- ``eval_programs`` on programs both packages' ``ProgramPool``s compile
  from the same conditions, over payload columns of every value type;
- ``step_kernel`` walked round by round from a CREATE wave, on config 2
  (conditioned flow, default flow, condition-error incident) and on an
  I/O-mapping graph (mapped documents, later mapping wins, missing
  source → incident, output merge): state, emissions and stats equal;
- config 2 driven to quiescence for three waves with a lookup-state
  rebuild between them: equal state and totals every wave.

Tolerance 0: integer tables and tri-states; f32 payloads compare by bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_torch_drive import _subscribed
from test_torch_kernel import _assert_leaf, assert_step_equal, both_steps, jax_state_np
from test_torch_kernel import port_batch, port_graph
from zeebe_tpu.models.bpmn.builder import Bpmn as JBpmn
from zeebe_tpu.models.el.parser import parse_condition as jparse
from zeebe_tpu.models.transform.transformer import transform_model as jtransform
from zeebe_tpu.tpu import batch as jb, conditions as jc, drive as jd, graph as jg
from zeebe_tpu.tpu import state as js
from zeebe_tpu.tpu.intern import InternTable as JInterns
from zeebe_tpu_torch.models.el.parser import parse_condition as tparse
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import JobIntent
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
from zeebe_tpu_torch.tpu import batch as tb, conditions as tc, drive as td
from zeebe_tpu_torch.tpu import graph as tg, ops, state as ts
from zeebe_tpu_torch.tpu.intern import InternTable as TInterns

NUM_VARS = 8
RECORDS_PER_INSTANCE_C2 = 22
_jrebuild = jax.jit(js.rebuild_lookup_state)

# every comparison, nested and/or, strings, booleans, nil, literals on the
# left, mixed types (→ ERROR), a variable no payload holds (absent → ERROR)
CONDITIONS = [
    "$.x == 5", "$.x != 5", "$.x < 5", "$.x <= 5", "$.x > 5", "$.x >= 5",
    "$.x > 1.5 && $.y < 10", "$.x > 1 || $.y > 1",
    "($.x > 1 && $.y > 1) || $.s == \"express\"",
    "$.x > 1 && ($.y > 1 || $.b == true)",
    "$.s == \"express\"", "$.s != \"bulk\"", "$.b == true", "$.b != false",
    "$.n == null", "$.x == null", "5 < $.x", "$.x == $.y", "$.s == $.x",
    "$.s < 3", "$.b > 0", "$.never == 1", "$.x > 1 || $.never == 1",
    "$.never == 1 || $.x > 1", "$.x < 0 && $.never == 1",
]
VARS = ["x", "y", "s", "b", "n", "never"]
STRINGS = ["express", "bulk", "other"]


def _pools():
    """Both packages' program pools over the same conditions, with the
    same variable columns and interned strings."""
    jpool = jc.ProgramPool(varspace=jg.VarSpace(VARS), interns=JInterns())
    tpool = tc.ProgramPool(varspace=tg.VarSpace(VARS), interns=TInterns())
    for s in STRINGS:
        jpool.interns.intern(s)
        tpool.interns.intern(s)
    for text in CONDITIONS:
        jpool.compile(jparse(text))
        tpool.compile(tparse(text))
    return jpool, tpool


def _payload_columns(rng, b):
    """[B, V] columns: each variable absent, nil, a bool, a number, a
    string id or a float; "never" always absent."""
    vt = rng.choice([tc.VT_ABSENT, tc.VT_NIL, tc.VT_BOOL, tc.VT_NUM, tc.VT_STR,
                     tc.VT_FLOAT], size=(b, NUM_VARS)).astype(np.int8)
    vt[:, VARS.index("never")] = tc.VT_ABSENT
    num = rng.choice([0.0, 1.0, 1.5, 5.0, 9.0, 12.0, -3.0], size=(b, NUM_VARS))
    num = np.where(vt == tc.VT_BOOL, rng.integers(0, 2, size=(b, NUM_VARS)), num)
    sid = rng.integers(1, len(STRINGS) + 1, size=(b, NUM_VARS)).astype(np.int32)
    return vt, num.astype(np.float32), sid


def test_eval_programs_matches_jax():
    jpool, tpool = _pools()
    jprogs, jlits = jpool.tensors()
    tprogs, tlits = tpool.arrays()
    np.testing.assert_array_equal(tprogs, np.asarray(jprogs))
    np.testing.assert_array_equal(tlits.view(np.int32), np.asarray(jlits).view(np.int32))
    b, p = 512, len(CONDITIONS)
    vt, num, sid = _payload_columns(np.random.default_rng(5), b)
    pid = np.broadcast_to(np.arange(p, dtype=np.int32), (b, p)).copy()
    pid[::7, 3] = -1  # clamped like the kernel's padding ids

    def bcast_j(a):
        return jnp.broadcast_to(jnp.asarray(a)[:, None, :], (b, p, NUM_VARS))

    def bcast_t(a):
        return torch.from_numpy(a)[:, None, :].expand(b, p, NUM_VARS)

    want = jc.eval_programs(jprogs, jlits, jnp.asarray(pid),
                            bcast_j(vt), bcast_j(num), bcast_j(sid))
    got = tc.eval_programs(torch.from_numpy(tprogs), torch.from_numpy(tlits),
                           torch.from_numpy(pid), bcast_t(vt), bcast_t(num), bcast_t(sid))
    _assert_leaf("tri", got.numpy(), want)
    # every outcome occurs, and per condition more than one
    counts = np.stack([np.bincount(got.numpy()[:, c], minlength=3) for c in range(p)])
    assert (counts.sum(axis=0) > 0).all()
    assert ((counts > 0).sum(axis=1) >= 2).sum() >= p - 2


# ---------------------------------------------------------------------------
# step kernel, round by round
# ---------------------------------------------------------------------------


def _with_vars(jgraph, meta, names=("orderId", "orderValue", "paid")):
    for name in names:
        meta.varspace.column(name)
    return dataclasses.replace(jgraph, num_vars=NUM_VARS)


@pytest.fixture(scope="module")
def config2():
    jgraph, meta = bench.build_graph_xor()
    jgraph = _with_vars(jgraph, meta)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == ["has_conditions"]
    return jgraph, meta


def _mapping_model():
    builder = JBpmn.create_process("mapped").start_event("start")
    builder = builder.service_task(
        "work", type="payment-service",
        inputs=[("$.total", "$.amount"), ("$.orderId", "$.ref")],
        outputs=[("$.result", "$.outcome")],
    )
    builder = builder.service_task(
        "twice", type="payment-service",
        inputs=[("$.outcome", "$.x"), ("$.orderId", "$.x")],  # the later one wins
    )
    return builder.end_event("end").done()


@pytest.fixture(scope="module")
def mapped():
    workflows = jtransform(_mapping_model())
    for w in workflows:
        w.key, w.version = 9, 1
    jgraph, meta = jg.compile_graph(workflows)
    jgraph = _with_vars(jgraph, meta, ("orderId", "total", "result"))
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == ["has_mappings"]
    return jgraph, meta


def _creates(meta, wave, seed, values):
    """CREATE commands with {orderId: i, <name>: one of ``values``}, that
    variable left out of about one in eight."""
    rng = np.random.default_rng(seed)
    name, choices = values
    creates = bench.stage_creates(meta, wave, NUM_VARS, meta.interns)
    vt, num = np.array(creates.v_vt), np.array(creates.v_num)
    col = meta.varspace.column(name)
    vt[:, col] = 3  # VT_NUM
    num[:, col] = rng.choice(choices, size=wave)
    vt[rng.random(wave) < 0.125, col] = 0  # absent
    return dataclasses.replace(creates, v_vt=jnp.asarray(vt), v_num=jnp.asarray(num))


def walk(jgraph, jstate, creates, batch_size, max_rounds, edit=None, now=0):
    """Step both kernels round by round from the JAX queue until it drains
    (``edit`` may rewrite a batch's numpy columns first); every round's
    state, emissions and stats must be equal. Returns (final JAX state,
    the emission columns of every round, the rounds that overflowed)."""
    qcap = 4 * max(creates.valid.shape[0], batch_size) * jgraph.emit_width
    jq = jd.enqueue(jd.make_queue(qcap, NUM_VARS), creates)
    emitted = []
    overflowed = 0
    for _round in range(max_rounds):
        if int(jq.count) == 0:
            break
        jq, batch = jd.dequeue(jq, batch_size)
        cols = {n: np.array(getattr(batch, n)) for n in tb.FIELDS}
        if edit is not None:
            edit(cols)
        batch = jb.RecordBatch(**{n: np.asarray(a) for n, a in cols.items()})
        j_out, t_out = both_steps(jgraph, jax_state_np(jstate), batch, now,
                                  synthetic_workers=True)
        assert_step_equal(j_out, t_out)
        jstate = j_out[0]
        overflowed += int(np.asarray(j_out[2]["overflow"]))
        emitted.append({n: np.asarray(getattr(j_out[1], n)) for n in tb.FIELDS})
        jq = jd.enqueue(jq, j_out[1])
    assert int(jq.count) == 0
    return jstate, emitted, overflowed


def _state(meta, capacity):
    return _subscribed(js.make_state(capacity=capacity, num_vars=NUM_VARS,
                                     sub_capacity=8), meta.interns)


def _incidents(emitted):
    return [int(r) for e in emitted for r in
            e["rej"][e["valid"] & (e["vtype"] == int(ValueType.INCIDENT))]]


def test_step_config2_conditioned_default_and_error_flows(config2):
    jgraph, meta = config2
    creates = _creates(meta, 48, 1, ("orderValue", [10.0, 50.0, 51.0, 99.0]))
    _jstate, emitted, _over = walk(jgraph, _state(meta, 256), creates, 32, 80)
    incidents = _incidents(emitted)
    assert incidents and set(incidents) == {tb.ERR_CONDITION_EVAL}
    flows = [int(x) for e in emitted for x in e["elem"][
        e["valid"] & (e["vtype"] == int(ValueType.WORKFLOW_INSTANCE))
        & (e["intent"] == int(WI.SEQUENCE_FLOW_TAKEN))]]
    assert len(set(flows)) >= 4  # both branches' flows were taken


def test_step_io_mappings_and_mapping_incidents(mapped):
    """Inputs map total → amount and orderId → ref (missing total → input
    incident); the synthetic COMPLETE carries result in most rows (absent
    → output incident), which the output mapping writes to outcome; the
    second task maps outcome and ref onto one target."""
    jgraph, meta = mapped
    result = meta.varspace.column("result")
    rng = np.random.default_rng(2)

    def give_results(cols):
        done = (cols["valid"] & (cols["vtype"] == int(ValueType.JOB))
                & (cols["rtype"] == int(RecordType.COMMAND))
                & (cols["intent"] == int(JobIntent.COMPLETE)))
        keep = done & (rng.random(done.shape[0]) < 0.8)
        cols["v_vt"][keep, result] = 3
        cols["v_num"][keep, result] = rng.choice([41.0, 7.0], size=int(keep.sum()))

    creates = _creates(meta, 40, 3, ("total", [99.0, 12.0]))
    _jstate, emitted, _over = walk(jgraph, _state(meta, 256), creates, 32, 120, edit=give_results)
    incidents = _incidents(emitted)
    assert tb.ERR_IO_MAPPING_IN in incidents and tb.ERR_IO_MAPPING_OUT in incidents
    completed = sum(int((e["valid"] & (e["vtype"] == int(ValueType.WORKFLOW_INSTANCE))
                         & (e["intent"] == int(WI.ELEMENT_COMPLETED))
                         & (e["elem"] == 0)).sum()) for e in emitted)
    assert completed > 10


# ---------------------------------------------------------------------------
# drive loop
# ---------------------------------------------------------------------------


def test_run_to_quiescence_config2_three_waves(config2):
    """3 waves of 256 CREATEs (orderValue above and below 50, absent in
    about one in eight) with synthetic workers and a lookup-state rebuild
    between waves: equal state and totals every wave; 22 records per
    completed instance, 8 per instance stopped by the condition incident."""
    jgraph, meta = config2
    wave = 256
    jstate = js.make_state(capacity=4 * wave, num_vars=NUM_VARS, job_capacity=4 * wave,
                           join_capacity=4 * wave, sub_capacity=8)
    jstate = _subscribed(jstate, meta.interns)
    tgraph = port_graph(jgraph)
    tstate = ts.state_from_numpy(jax_state_np(jstate), device="cpu")
    qcap = 4 * wave * max(2, jgraph.emit_width)
    jq, tq = jd.make_queue(qcap, NUM_VARS), td.make_queue(qcap, NUM_VARS, device="cpu")
    creates = _creates(meta, wave, 4, ("orderValue", [10.0, 99.0]))
    absent = int((np.asarray(creates.v_vt)[:, meta.varspace.column("orderValue")] == 0).sum())
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
        assert ttot["completed_roots"] == wave - absent
        assert ttot["processed"] == (RECORDS_PER_INSTANCE_C2 * (wave - absent)
                                     + 8 * absent)
        jstate = _jrebuild(jstate)
        tstate = ts.rebuild_lookup_state(tstate)
        want, got = jax_state_np(jstate), ts.state_to_numpy(tstate)
        for name in want:
            _assert_leaf(name, got[name], want[name])
    assert int(tq.count) == 0 and not bool(tq.overflow)
    assert sum(ops.LAUNCHES.values()) == 0
