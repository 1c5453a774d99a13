"""zeebe_tpu_torch drive loop against zeebe_tpu's, bit for bit: the queue,
``run_to_quiescence`` with synthetic workers, and the lookup-state rebuild
between waves, on the CPU with the kernels' plain versions."""

import dataclasses

import __graft_entry__ as graft
from test_torch_kernel import _assert_leaf, jax_state_np, port_batch, port_graph
from zeebe_tpu.tpu import drive as jd, state as js
from zeebe_tpu_torch.tpu import drive as td, ops, state as ts


def _subscribed(jstate, interns):
    return dataclasses.replace(
        jstate,
        sub_key=jstate.sub_key.at[0].set(1),
        sub_type=jstate.sub_type.at[0].set(interns.intern("payment-service")),
        sub_worker=jstate.sub_worker.at[0].set(interns.intern("bench-worker")),
        sub_credits=jstate.sub_credits.at[0].set(2**31 - 1),
        sub_timeout=jstate.sub_timeout.at[0].set(300_000),
        sub_valid=jstate.sub_valid.at[0].set(True),
    )


def test_run_to_quiescence_three_waves():
    """3 waves of 256 CREATEs with synthetic workers and a lookup-state
    rebuild between waves: equal state and totals every wave, 20 records
    processed per instance."""
    jgraph, meta = graft._graph_and_meta()
    jgraph = dataclasses.replace(jgraph, num_vars=8)
    jstate = _subscribed(js.make_state(capacity=1024, num_vars=8), meta.interns)
    tgraph = port_graph(jgraph)
    tstate = ts.state_from_numpy(jax_state_np(jstate), device="cpu")
    jq, tq = jd.make_queue(2048, 8), td.make_queue(2048, 8, device="cpu")
    creates = graft._create_batch(meta, 256, 256, 8)
    tcreates = port_batch(creates)
    ops.reset_launches()
    for _wave in range(3):
        jq = jd.enqueue(jq, creates)
        tq = td.enqueue(tq, tcreates)
        jstate, jq, jtot = jd.run_to_quiescence(jgraph, jstate, jq, 0, 256,
                                                synthetic_workers=True)
        tstate, tq, ttot = td.run_to_quiescence(tgraph, tstate, tq, 0, 256,
                                                synthetic_workers=True)
        assert ttot == jtot
        assert ttot["processed"] == 20 * 256 and ttot["completed_roots"] == 256
        jstate = js.rebuild_lookup_state(jstate)
        tstate = ts.rebuild_lookup_state(tstate)
        want, got = jax_state_np(jstate), ts.state_to_numpy(tstate)
        for name in want:
            _assert_leaf(name, got[name], want[name])
    assert int(tq.count) == 0 and not bool(tq.overflow)
    # CPU tensors take the plain versions: no kernel launched
    assert sum(ops.LAUNCHES.values()) == 0


def test_run_to_quiescence_parallel_split_without_join():
    """A three-way parallel split that never joins (no feature gate on):
    fork emission slots, the zeroed third slot, and token counting."""
    from zeebe_tpu.models.bpmn.builder import Bpmn as JBpmn
    from zeebe_tpu.models.transform.transformer import transform_model as jtransform
    from zeebe_tpu.tpu import graph as jg

    builder = JBpmn.create_process("fork3").start_event("start").parallel_gateway("fork")
    for name in ("a", "b", "c"):
        builder.branch().service_task(f"task-{name}", type="payment-service").end_event(f"end-{name}")
    workflows = jtransform(builder.done())
    for w in workflows:
        w.key, w.version = 9, 1
    jgraph, meta = jg.compile_graph(workflows)
    jgraph = dataclasses.replace(jgraph, num_vars=8)
    assert jgraph.emit_width == 3 and not jgraph.has_parallel_joins
    jstate = _subscribed(js.make_state(capacity=512, num_vars=8), meta.interns)
    tstate = ts.state_from_numpy(jax_state_np(jstate), device="cpu")
    jq, tq = jd.make_queue(1536, 8), td.make_queue(1536, 8, device="cpu")
    creates = graft._create_batch(meta, 128, 64, 8)
    jq = jd.enqueue(jq, creates)
    tq = td.enqueue(tq, port_batch(creates))
    jstate, jq, jtot = jd.run_to_quiescence(jgraph, jstate, jq, 0, 128, synthetic_workers=True)
    tstate, tq, ttot = td.run_to_quiescence(port_graph(jgraph), tstate, tq, 0, 128,
                                            synthetic_workers=True)
    assert ttot == jtot and ttot["completed_roots"] == 64
    want, got = jax_state_np(jstate), ts.state_to_numpy(tstate)
    for name in want:
        _assert_leaf(name, got[name], want[name])
