"""Cardinality multi-instance (the ``has_multi_instance`` gate) in the
zeebe_tpu_torch step kernel and drive loop against zeebe_tpu's, bit for
bit, on the CPU with the kernels' plain versions:

- BASELINE config 5 (``bench.build_graph_c5``: a cardinality-4
  multi-instance sub-process around a service task) walked round by round
  from a CREATE wave (the fan-out over the emission slots with loopCounter
  f + 1, the container's token count, its own payload kept at completion);
- config 5 driven to quiescence for three waves with a lookup-state
  rebuild between them (``run_config5_sweep``'s cap_factor 16);
- one graph that turns every feature gate on at once: a service task with
  I/O mappings and a non-interrupting timer boundary, a parallel fork into
  a receive task with an interrupting message boundary and a cardinality-2
  multi-instance sub-process, their join, an exclusive gateway with a
  json-el condition and a timer catch — walked through CREATE, PUBLISH
  ("paid" for some, "abort" for others) and ticks.

Each round: state, emissions and stats equal; tolerance 0.
"""

import dataclasses

import jax
import numpy as np

import bench
from test_torch_boundaries import assert_tick_equal
from test_torch_conditions import NUM_VARS, walk
from test_torch_drive import _subscribed
from test_torch_kernel import _assert_leaf, jax_state_np, port_batch, port_graph
from zeebe_tpu.models.bpmn.builder import Bpmn as JBpmn
from zeebe_tpu.models.transform.transformer import transform_model as jtransform
from zeebe_tpu.tpu import batch as jb, drive as jd, graph as jg, state as js
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import MessageIntent as MI
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
from zeebe_tpu_torch.tpu import batch as tb, drive as td, graph as tg, ops, state as ts
from zeebe_tpu_torch.tpu.conditions import VT_NUM, VT_STR

NOW = 1_000_000
CARDINALITY = 4
# records a config-5 instance writes, its CREATE included
RECORDS_PER_INSTANCE_C5 = 70
_jrebuild = jax.jit(js.rebuild_lookup_state)


def _config5():
    jgraph, meta = bench.build_graph_c5()
    for name in ("orderId", "orderValue", "paid"):
        meta.varspace.column(name)
    jgraph = dataclasses.replace(jgraph, num_vars=NUM_VARS)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == ["has_multi_instance"]
    assert jgraph.emit_width == CARDINALITY
    return jgraph, meta


def _state(meta, capacity):
    return _subscribed(js.make_state(capacity=capacity, num_vars=NUM_VARS,
                                     job_capacity=capacity, join_capacity=capacity,
                                     sub_capacity=8), meta.interns)


def _count(emitted, intent, elem=None):
    hit = 0
    for e in emitted:
        m = (e["valid"] & (e["vtype"] == int(ValueType.WORKFLOW_INSTANCE))
             & (e["rtype"] == int(RecordType.EVENT)) & (e["intent"] == int(intent)))
        if elem is not None:
            m &= e["elem"] == elem
        hit += int(m.sum())
    return hit


def test_config5_round_by_round():
    jgraph, meta = _config5()
    n = 24
    creates = bench.stage_creates(meta, n, NUM_VARS, meta.interns)
    _jstate, emitted, over = walk(jgraph, _state(meta, 16 * n), creates, 16, 120)
    assert over == 0
    assert _count(emitted, WI.ELEMENT_COMPLETED, elem=0) == n
    # one body per iteration, each starting with its loopCounter
    starts = [e for e in emitted]
    lv = jgraph.mi_loop_var
    counters = sorted(
        float(x) for e in starts for x in e["v_num"][
            e["valid"] & (e["intent"] == int(WI.START_EVENT_OCCURRED))
            & (e["vtype"] == int(ValueType.WORKFLOW_INSTANCE))
            & (e["scope_key"] != e["instance_key"]), lv]
    )
    assert counters == sorted([float(f + 1) for f in range(CARDINALITY)] * n)
    assert sum(int(e["valid"].sum()) for e in emitted) + n == RECORDS_PER_INSTANCE_C5 * n


def test_config5_drive_three_waves_with_rebuilds():
    """``run_config5_sweep``'s shape at a wave of 64: cap_factor 16, three
    waves, the lookup state rebuilt after each."""
    jgraph, meta = _config5()
    wave = 64
    jstate = _state(meta, 16 * wave)
    tgraph = port_graph(jgraph)
    tstate = ts.state_from_numpy(jax_state_np(jstate), device="cpu")
    qcap = 4 * wave * max(2, jgraph.emit_width)
    jq, tq = jd.make_queue(qcap, NUM_VARS), td.make_queue(qcap, NUM_VARS, device="cpu")
    creates = bench.stage_creates(meta, wave, NUM_VARS, meta.interns)
    ops.reset_launches()
    for _wave in range(3):
        jq = jd.enqueue(jq, creates)
        tq = td.enqueue(tq, port_batch(creates))
        jstate, jq, jtot = jd.run_to_quiescence(jgraph, jstate, jq, 0, wave,
                                                synthetic_workers=True)
        tstate, tq, ttot = td.run_to_quiescence(tgraph, tstate, tq, 0, wave,
                                                synthetic_workers=True)
        assert ttot == jtot
        assert ttot["processed"] == RECORDS_PER_INSTANCE_C5 * wave
        assert ttot["completed_roots"] == wave
        jstate = _jrebuild(jstate)
        tstate = ts.rebuild_lookup_state(tstate)
        want, got = jax_state_np(jstate), ts.state_to_numpy(tstate)
        for name in want:
            _assert_leaf(name, got[name], want[name])
    assert int(tq.count) == 0 and not bool(tq.overflow)
    assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors: the plain versions


def every_gate_model():
    b = JBpmn.create_process("every").start_event("start")
    b.service_task("work", type="payment-service", inputs=[("$.orderValue", "$.amount")],
                   outputs=[("$.amount", "$.charged")])
    b.boundary_event("late", duration_ms=30_000, interrupting=False).end_event("late-end")
    b.move_to("work").parallel_gateway("fork")
    wait = b.branch().receive_task("wait", message_name="paid", correlation_key="$.oid")
    wait.boundary_event("abort", message_name="abort", correlation_key="$.oid")
    wait.end_event("aborted").move_to("wait")
    each = b.branch().sub_process("each", multi_instance={"cardinality": 2})
    each.start_event("s").service_task("item", type="payment-service").end_event("e")
    each.embedded_done().parallel_gateway("join")
    wait.connect_to("join")
    b.move_to("join").exclusive_gateway("split")
    b.branch("$.orderValue > 50").timer_catch_event("cool", duration_ms=1_000).end_event("end-a")
    b.branch(default=True).end_event("end-b")
    return b.done()


def _creates(meta, n):
    cols = tb.batch_to_numpy(tb.empty(n, NUM_VARS, device="cpu"))
    cols["valid"][:] = True
    cols["rtype"][:] = int(RecordType.COMMAND)
    cols["vtype"][:] = int(ValueType.WORKFLOW_INSTANCE)
    cols["intent"][:] = int(WI.CREATE)
    cols["wf"][:] = 0
    oid, value = meta.varspace.column("oid"), meta.varspace.column("orderValue")
    cols["v_vt"][:, oid] = VT_STR
    cols["v_str"][:, oid] = [meta.interns.intern(f"o-{i}") for i in range(n)]
    cols["v_vt"][:, value] = VT_NUM
    cols["v_num"][:, value] = np.where(np.arange(n) % 2 == 0, 10.0, 99.0)
    return jb.RecordBatch(**cols)


def _publishes(meta, n):
    """"paid" for one instance in three, "abort" for the next, none for
    the third (it waits); prefix-compacted, as the queue takes batches."""
    sent = [(("paid", "abort")[i % 3], i) for i in range(n) if i % 3 != 2]
    cols = tb.batch_to_numpy(tb.empty(n, NUM_VARS, device="cpu"))
    for row, (name, i) in enumerate(sent):
        cols["valid"][row] = True
        cols["rtype"][row] = int(RecordType.COMMAND)
        cols["vtype"][row] = int(ValueType.MESSAGE)
        cols["intent"][row] = int(MI.PUBLISH)
        cols["type_id"][row] = meta.interns.intern(name)
        cols["retries"][row] = VT_STR
        cols["worker"][row] = meta.interns.intern(f"o-{i}")
    return jb.RecordBatch(**cols)


def test_every_gate_graph_round_by_round():
    workflows = jtransform(every_gate_model())
    for w in workflows:
        w.key, w.version = 9, 1
    assert all(jg.check_device_compatible(w) is None for w in workflows)
    jgraph, meta = jg.compile_graph(workflows)
    for name in ("oid", "orderValue"):
        meta.varspace.column(name)
    jgraph = dataclasses.replace(jgraph, num_vars=NUM_VARS)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == list(tg.FEATURE_GATES)
    n = 18
    jstate = _state(meta, 512)
    jstate, created, over = walk(jgraph, jstate, _creates(meta, n), 16, 120, now=NOW)
    assert _count(created, WI.ELEMENT_ACTIVATED) > 0
    jstate, published, over2 = walk(jgraph, jstate, _publishes(meta, n), 16, 120, now=NOW)
    assert _count(published, WI.BOUNDARY_EVENT_OCCURRED) == n // 3
    completed = _count(created + published, WI.ELEMENT_COMPLETED, elem=0)
    for now in (NOW + 31_000, NOW + 62_000):
        trig, _due = assert_tick_equal(jstate, now)
        jstate, fired, over3 = walk(jgraph, jstate, trig, 16, 120, now=now)
        assert over == over2 == over3 == 0
        completed += _count(fired, WI.ELEMENT_COMPLETED, elem=0)
    # the "paid" third ran through the join and the gateway to an end; the
    # others' multi-instance branches wait at the join
    assert completed == n // 3
    arrays = jax_state_np(jstate)
    assert (arrays["join_key"] >= 0).sum() == 2 * n // 3


def test_chip_smoke_config5_drive_counts():
    """``chip_smoke.config5_drive`` (phases 3 and 5d) on the CPU at a wave
    of 64: every instance completes, 70 records each."""
    import chip_smoke

    _state, totals, _s = chip_smoke.config5_drive(2, 64, "cpu")
    assert totals["completed_roots"] == 128
    assert totals["processed"] == chip_smoke.TRANSITIONS_PER_INSTANCE_C5 * 128
