"""Crash recovery of the port's device engine, held to the JAX engine.

``tests/test_snapshot_recovery.py``'s ``TestTpuEngineRecovery`` restarts a
broker served by the device engine: mid-workflow from a snapshot, after a
kill between snapshots (the committed tail replays), with no snapshot at
all (replay only), and round-trips the device state through the snapshot
codec. Each scenario runs here on the port's own ``Broker`` with
``CudaPartitionEngine`` on the CPU and on the JAX package's ``Broker`` with
``TpuPartitionEngine``, and the recovered runs end with the same log
(every encoded frame) and the same state (the ``stateser`` snapshot parts),
tolerance 0.
"""

import dataclasses
import itertools
import types

import numpy as np

import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu.log.stateser as jax_stateser
import zeebe_tpu.models.bpmn.builder as jax_builder
import zeebe_tpu.protocol.codec as jax_codec
import zeebe_tpu.runtime as jax_runtime
from zeebe_tpu.protocol.enums import RecordType, ValueType
from zeebe_tpu.protocol.intents import JobIntent
from zeebe_tpu.protocol.intents import WorkflowInstanceIntent as WI

import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.gateway.workers as port_workers
import zeebe_tpu_torch.log.stateser as port_stateser
import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.protocol.codec as port_codec
import zeebe_tpu_torch.runtime as port_runtime
from zeebe_tpu_torch.engine.interpreter import WorkflowRepository as PortRepository
from zeebe_tpu_torch.tpu import state as port_state
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine


def port_device_broker(data_dir=None, clock=None, num_partitions=1):
    """A single-node port ``Broker`` whose partitions run
    ``CudaPartitionEngine`` on the CPU (the counterpart of
    ``tests/conftest.py``'s ``make_tpu_broker``)."""
    clock = clock or port_runtime.ControlledClock(start_ms=1_000_000)
    repo = PortRepository()
    return port_runtime.Broker(
        num_partitions=num_partitions, data_dir=data_dir, clock=clock,
        engine_factory=lambda pid: CudaPartitionEngine(
            pid, num_partitions, repository=repo, clock=clock, device="cpu"),
    )


def jax_device_broker(data_dir=None, clock=None, num_partitions=1):
    from zeebe_tpu.engine.interpreter import WorkflowRepository
    from zeebe_tpu.tpu import TpuPartitionEngine

    clock = clock or jax_runtime.ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    return jax_runtime.Broker(
        num_partitions=num_partitions, data_dir=data_dir, clock=clock,
        engine_factory=lambda pid: TpuPartitionEngine(
            pid, num_partitions, repository=repo, clock=clock),
    )


def jax_oracle_broker(data_dir=None, clock=None):
    return jax_runtime.Broker(num_partitions=1, data_dir=data_dir, clock=clock)


JAX = types.SimpleNamespace(runtime=jax_runtime, gateway=jax_gateway,
                            workers=jax_workers, Bpmn=jax_builder.Bpmn,
                            codec=jax_codec, stateser=jax_stateser,
                            broker=jax_device_broker)
PORT = types.SimpleNamespace(runtime=port_runtime, gateway=port_gateway,
                             workers=port_workers, Bpmn=port_builder.Bpmn,
                             codec=port_codec, stateser=port_stateser,
                             broker=port_device_broker)


def order_model(ns):
    return (
        ns.Bpmn.create_process("order-process")
        .start_event("start")
        .service_task("collect-money", type="payment-service")
        .end_event("end")
        .done()
    )


def wi_events(broker):
    return [
        (int(r.metadata.intent), r.value.activity_id)
        for r in broker.records(0)
        if int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
        and int(r.metadata.record_type) == int(RecordType.EVENT)
    ]


ACTIVATED, COMPLETED = int(WI.ELEMENT_ACTIVATED), int(WI.ELEMENT_COMPLETED)


def _pay(ctx):
    return {"paid": True}


def restart_mid_workflow_with_snapshot(ns, data, clock, recovered_at):
    broker = ns.broker(data, clock)
    client = ns.gateway.ZeebeClient(broker)
    client.deploy_model(order_model(ns))
    client.create_instance("order-process", payload={"orderId": 1})
    broker.run_until_idle()
    assert (ACTIVATED, "collect-money") in wi_events(broker)
    broker.snapshot()
    n_records = len(broker.records(0))
    broker.close()

    broker = ns.broker(data, clock)
    recovered_at(broker)
    assert len(broker.records(0)) == n_records  # no side effect replayed
    worker = ns.gateway.JobWorker(broker, "payment-service", _pay)
    broker.run_until_idle()
    assert (COMPLETED, "order-process") in wi_events(broker)
    assert len(worker.handled) == 1
    return broker


def kill_between_snapshots(ns, data, clock, recovered_at):
    broker = ns.broker(data, clock)
    client = ns.gateway.ZeebeClient(broker)
    client.deploy_model(order_model(ns))
    client.create_instance("order-process", payload={"orderId": 1})
    broker.run_until_idle()
    broker.snapshot()
    worker = ns.gateway.JobWorker(broker, "payment-service", _pay)
    client.create_instance("order-process", payload={"orderId": 2})
    broker.run_until_idle()
    assert len(worker.handled) == 2
    n_records = len(broker.records(0))
    broker.close()  # the snapshot is stale: the tail must replay

    broker = ns.broker(data, clock)
    recovered_at(broker)
    assert len(broker.records(0)) == n_records
    client = ns.gateway.ZeebeClient(broker)
    ns.gateway.JobWorker(broker, "payment-service", _pay)
    client.create_instance("order-process", payload={"orderId": 3})
    broker.run_until_idle()
    assert wi_events(broker).count((COMPLETED, "order-process")) == 3
    return broker


def replay_only_restart(ns, data, clock, recovered_at):
    broker = ns.broker(data, clock)
    client = ns.gateway.ZeebeClient(broker)
    client.deploy_model(order_model(ns))
    client.create_instance("order-process", payload={"orderId": 7})
    broker.run_until_idle()
    broker.close()

    broker = ns.broker(data, clock)
    recovered_at(broker)
    worker = ns.gateway.JobWorker(broker, "payment-service", _pay)
    broker.run_until_idle()
    assert len(worker.handled) == 1
    assert (COMPLETED, "order-process") in wi_events(broker)
    return broker


def _frames_and_parts(ns, broker):
    frames = [ns.codec.encode_record(r) for r in broker.records(0)]
    parts = dict(ns.stateser.encode_state_parts(
        broker.partitions[0].engine.snapshot_state()))
    return frames, parts


def recovered(ns, scenario, data_dir):
    """Run ``scenario`` on ``ns``'s device broker; returns the frames and
    snapshot parts of the restarted broker as it recovered, and as it
    ended, and the ended broker's log."""
    ns.workers._subscriber_keys = itertools.count(1)
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    at_recovery = []
    broker = scenario(ns, data_dir, clock,
                      lambda b: at_recovery.append(_frames_and_parts(ns, b)))
    try:
        return at_recovery[0], _frames_and_parts(ns, broker), broker.records(0)
    finally:
        broker.close()


def _assert_same(port, jax, skip=(), frames=True):
    (port_frames, port_parts), (jax_frames, jax_parts) = port, jax
    assert len(port_frames) > 10
    assert not frames or port_frames == jax_frames
    assert sorted(port_parts) == sorted(jax_parts)
    for name, blob in jax_parts.items():
        assert name in skip or port_parts[name] == blob, name


def test_restart_resumes_mid_workflow_with_snapshot(tmp_path):
    port = recovered(PORT, restart_mid_workflow_with_snapshot, str(tmp_path / "port"))
    jax = recovered(JAX, restart_mid_workflow_with_snapshot, str(tmp_path / "jax"))
    _assert_same(port[0], jax[0])
    _assert_same(port[1], jax[1])


def test_kill_between_snapshots_replays_tail(tmp_path):
    port = recovered(PORT, kill_between_snapshots, str(tmp_path / "port"))
    jax = recovered(JAX, kill_between_snapshots, str(tmp_path / "jax"))
    _assert_same(port[0], jax[0])
    _assert_same(port[1], jax[1])


def _activations(records):
    """JOB ACTIVATE commands and JOB command rejections of a log."""
    job = [r for r in records if int(r.metadata.value_type) == int(ValueType.JOB)]
    activates = sum(int(r.metadata.record_type) == int(RecordType.COMMAND)
                    and int(r.metadata.intent) == int(JobIntent.ACTIVATE) for r in job)
    rejected = sum(int(r.metadata.record_type) == int(RecordType.COMMAND_REJECTION)
                   for r in job)
    return activates, rejected


def test_replay_only_restart_without_snapshot(tmp_path):
    """Recovered, the port's log and state equal the JAX engine's. Then a
    worker opens: the job's CREATED event is the unprocessed tail (no
    follow-up of it was written), so the JAX engine, like its host oracle,
    activates the job twice, from the subscription's backlog and from the
    tail's CREATED, and rejects the second ACTIVATE. The port counts the
    tail before the worker opens (``note_unprocessed``) and activates it
    once; its tables end equal to the JAX engine's, and only the root
    part (the last processed position) differs."""
    port = recovered(PORT, replay_only_restart, str(tmp_path / "port"))
    jax = recovered(JAX, replay_only_restart, str(tmp_path / "jax"))
    oracle = recovered(
        types.SimpleNamespace(**{**vars(JAX), "broker": jax_oracle_broker}),
        replay_only_restart, str(tmp_path / "oracle"))
    _assert_same(port[0], jax[0])
    _assert_same(port[1], jax[1], skip=("_root",), frames=False)
    assert _activations(jax[2]) == _activations(oracle[2]) == (2, 1)
    assert _activations(port[2]) == (1, 0)
    assert len(port[1][0]) == len(jax[1][0]) - 2


def test_device_state_round_trips_exactly(tmp_path):
    """snapshot_state → codec → restore_state reproduces the tables bit for
    bit (the lookup structures, derived at a restore, after the same
    derivation on both sides; the subscriptions drop), and the port's
    snapshot equals the JAX engine's for the same commands."""
    snaps = {}
    for ns in (PORT, JAX):
        ns.workers._subscriber_keys = itertools.count(1)
        clock = ns.runtime.ControlledClock(start_ms=1_000_000)
        broker = ns.broker(str(tmp_path / ns.runtime.__name__ / "a"), clock)
        client = ns.gateway.ZeebeClient(broker)
        client.deploy_model(order_model(ns))
        client.create_instance("order-process", payload={"orderId": 1, "tag": "x"})
        broker.run_until_idle()
        snaps[ns.runtime.__name__] = (broker, ns.stateser.encode_state(
            broker.partitions[0].engine.snapshot_state()))
    (broker, blob), (jax_broker, jax_blob) = snaps.values()
    jax_broker.close()
    assert blob == jax_blob
    engine = broker.partitions[0].engine
    snap = port_stateser.decode_state(blob)

    restored = port_device_broker(str(tmp_path / "b"))
    engine2 = restored.partitions[0].engine
    engine2.restore_state(snap)
    norm_a = port_state.rebuild_lookup_state(engine.state)
    norm_b = port_state.rebuild_lookup_state(engine2.state)
    derived = {
        "ei_map", "ei_index", "job_map", "job_index",
        "free_ei", "free_ei_pop", "free_ei_push",
        "free_job", "free_job_pop", "free_job_push",
    }
    for f in dataclasses.fields(engine.state):
        if f.name.startswith("sub_"):
            continue  # transient worker subscriptions drop at a restore
        if f.name in derived:
            a, b = getattr(norm_a, f.name), getattr(norm_b, f.name)
        else:
            a, b = getattr(engine.state, f.name), getattr(engine2.state, f.name)
        if hasattr(a, "keys"):
            np.testing.assert_array_equal(a.keys.numpy(), b.keys.numpy())
            np.testing.assert_array_equal(a.vals.numpy(), b.vals.numpy())
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
    assert engine2.interns._by_id == engine.interns._by_id
    assert engine2.meta.varspace.names == engine.meta.varspace.names
    broker.close()
    restored.close()
