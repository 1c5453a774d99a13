"""Delta snapshots of the port's device engine, held to the JAX package.

``tests/test_snapshot_delta.py``'s ``TestDeviceDirtyTracking`` pins the
device engine's dirty families: a second take with no traffic reads
nothing back, a backlog tick re-reads only the subscription family, a
dispatch marks every device family and keeps the host families tracked,
and a delta chain restores bit-identically. Here the same pins run on
``CudaPartitionEngine`` on the CPU, with the fixture's tables written as
torch tensors; the JAX engine built from the same fixture writes the same
snapshot parts. Then both packages' brokers serve the same commands and
take a full and a delta snapshot: the on-disk parts of the delta chain are
equal byte for byte (``FORMAT_DEVICE_V1``).
"""

import dataclasses
import itertools
import types

import numpy as np
import torch

import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu.log.snapshot as jax_snapshot
import zeebe_tpu.log.stateser as jax_stateser
import zeebe_tpu.models.bpmn.builder as jax_builder
import zeebe_tpu.runtime as jax_runtime
from zeebe_tpu.protocol.intents import JobIntent as JI
from test_torch_serving import port_broker

import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.gateway.workers as port_workers
import zeebe_tpu_torch.log.snapshot as port_snapshot
import zeebe_tpu_torch.log.stateser as port_stateser
import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.runtime as port_runtime
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine


def port_device_engine(n_jobs=4, capacity=256):
    """``CudaPartitionEngine`` on the CPU with ``n_jobs`` CREATED device
    jobs and one credited subscription, written into its torch tables (no
    kernel step needed)."""
    eng = CudaPartitionEngine(capacity=capacity, sub_capacity=8, device="cpu")
    s = eng.state
    tid = eng.interns.intern("work")
    for i in range(n_jobs):
        s.job_i32[i] = torch.tensor((int(JI.CREATED), 0, 0, tid, 3, 0))
        s.job_i64[i] = torch.tensor((100 + 5 * i, -1, -1, -1))
    s.sub_key[0], s.sub_type[0] = 1, tid
    s.sub_worker[0] = eng.interns.intern("w-1")
    s.sub_credits[0], s.sub_timeout[0], s.sub_valid[0] = 10, 1000, True
    return eng


def jax_device_engine(n_jobs=4, capacity=256):
    """The JAX engine with ``tests/test_snapshot_delta.py``'s fixture."""
    import jax.numpy as jnp

    from zeebe_tpu.tpu.engine import TpuPartitionEngine

    eng = TpuPartitionEngine(capacity=capacity, sub_capacity=8)
    s = eng.state
    tid = eng.interns.intern("work")
    tables = {name: np.asarray(getattr(s, name)).copy() for name in (
        "job_i32", "job_i64", "sub_key", "sub_type", "sub_worker",
        "sub_credits", "sub_timeout", "sub_valid")}
    for i in range(n_jobs):
        tables["job_i32"][i] = (int(JI.CREATED), 0, 0, tid, 3, 0)
        tables["job_i64"][i] = (100 + 5 * i, -1, -1, -1)
    tables["sub_key"][0], tables["sub_type"][0] = 1, tid
    tables["sub_worker"][0] = eng.interns.intern("w-1")
    tables["sub_credits"][0] = 10
    tables["sub_timeout"][0], tables["sub_valid"][0] = 1000, True
    eng.state = dataclasses.replace(
        s, **{k: jnp.asarray(v) for k, v in tables.items()})
    return eng


def port_controller(path):
    return port_snapshot.SnapshotController(port_snapshot.SnapshotStorage(str(path)))


def test_second_take_does_zero_device_readback(tmp_path):
    eng = port_device_engine()
    controller = port_controller(tmp_path)
    controller.take_engine(eng, port_snapshot.SnapshotMetadata(10, 12, 1))
    assert len(eng.last_snapshot_readback) > 0  # the cold take read all

    controller.take_engine(eng, port_snapshot.SnapshotMetadata(20, 22, 1))
    assert eng.last_snapshot_readback == []
    stats = controller.last_take_stats
    assert stats["new_bytes"] == 0
    assert stats["new_segments"] == 0
    assert stats["reused_parts"] > 0


def test_tick_mutation_reads_back_only_its_family(tmp_path):
    eng = port_device_engine()
    controller = port_controller(tmp_path)
    controller.take_engine(eng, port_snapshot.SnapshotMetadata(10, 12, 1))

    out = eng.device_backlog_activations()  # moves sub credits and cursor
    assert out, "the fixture must assign at least one backlog job"
    assert eng.snapshot_dirty_families() == frozenset({"d/sub"})
    controller.take_engine(eng, port_snapshot.SnapshotMetadata(20, 22, 1))
    read = set(eng.last_snapshot_readback)
    assert read, "the dirty sub family must be read again"
    assert all(name.startswith("sub_") for name in read), read


def test_a_due_probe_dirties_nothing(tmp_path):
    eng = port_device_engine()
    eng.snapshot_mark_clean()
    assert int(eng.deadlines_due_probe()) != 0  # the backlog bit is set
    assert eng.snapshot_dirty_families() == frozenset()


def test_kernel_dispatch_marks_all_device_families_not_cold():
    assert set(CudaPartitionEngine._ALL_DEVICE_FAMILIES) == set(
        port_stateser.DEVICE_ARRAY_FAMILIES
    ) == set(jax_stateser.DEVICE_ARRAY_FAMILIES)
    eng = port_device_engine()
    eng.snapshot_mark_clean()
    eng._mark_device_dirty()  # what _dispatch_device does each wave
    dirty = eng.snapshot_dirty_families()
    assert dirty is not None, "a dispatch must not collapse tracking to cold"
    assert {"d/" + f for f in port_stateser.DEVICE_ARRAY_FAMILIES} <= set(dirty)
    assert "h/workflows" not in dirty


def _delta_chain(eng, controller, snapshot):
    """A full take, a backlog tick and a credit increase, a delta take;
    returns the newest snapshot's on-disk parts."""
    controller.take_engine(eng, snapshot.SnapshotMetadata(10, 12, 1))
    eng.device_backlog_activations()
    eng.increase_job_credits(1, 5)
    controller.take_engine(eng, snapshot.SnapshotMetadata(20, 22, 1))
    assert controller.last_take_stats["reused_parts"] > 0
    return controller.storage.read_parts(controller.storage.list()[0])


def test_device_delta_restores_bit_identically_and_equals_jax(tmp_path):
    eng = port_device_engine()
    controller = port_controller(tmp_path / "port")
    on_disk = _delta_chain(eng, controller, port_snapshot)
    fresh = dict(port_stateser.encode_state_parts(eng.snapshot_state()))
    assert on_disk == fresh
    state, meta = controller.recover(log_last_position=100)
    assert meta == port_snapshot.SnapshotMetadata(20, 22, 1)
    assert dict(port_stateser.encode_state_parts(state)) == on_disk

    jax_controller = jax_snapshot.SnapshotController(
        jax_snapshot.SnapshotStorage(str(tmp_path / "jax")))
    assert _delta_chain(jax_device_engine(), jax_controller, jax_snapshot) == on_disk


# -- both packages' brokers: the delta chain after a served workload -------


def _jax_broker(clock, data_dir):
    from zeebe_tpu.engine.interpreter import WorkflowRepository
    from zeebe_tpu.tpu import TpuPartitionEngine

    repo = WorkflowRepository()
    return jax_runtime.Broker(
        num_partitions=1, clock=clock, data_dir=data_dir,
        engine_factory=lambda pid: TpuPartitionEngine(
            pid, 1, repository=repo, clock=clock, capacity=1 << 10),
    )


JAX = types.SimpleNamespace(runtime=jax_runtime, gateway=jax_gateway,
                            workers=jax_workers, Bpmn=jax_builder.Bpmn,
                            stateser=jax_stateser, broker=_jax_broker)
PORT = types.SimpleNamespace(runtime=port_runtime, gateway=port_gateway,
                             workers=port_workers, Bpmn=port_builder.Bpmn,
                             stateser=port_stateser,
                             broker=lambda clock, data_dir: port_broker(
                                 clock, data_dir, capacity=1 << 10))


def served_delta_chain(ns, data_dir):
    """32 instances parked at the service task, a full take; a worker and 4
    more instances, a delta take. Returns the stats of both takes and the
    newest snapshot's on-disk parts, which must equal a full encode."""
    ns.workers._subscriber_keys = itertools.count(1)
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = ns.broker(clock, data_dir)
    try:
        client = ns.gateway.ZeebeClient(broker)
        client.deploy_model(
            ns.Bpmn.create_process("order-process").start_event("start")
            .service_task("collect-money", type="payment-service")
            .end_event("end").done())
        for i in range(32):
            client.create_instance("order-process", {"orderId": i})
        broker.run_until_idle()
        partition = broker.partitions[0]
        broker.snapshot()
        full = dict(partition.snapshots.last_take_stats)
        ns.gateway.JobWorker(broker, "payment-service", lambda ctx: {"paid": True})
        for i in range(4):
            client.create_instance("order-process", {"orderId": 100 + i})
        broker.run_until_idle()
        broker.snapshot()
        delta = dict(partition.snapshots.last_take_stats)
        storage = partition.snapshots.storage
        on_disk = storage.read_parts(storage.list()[0])
        fresh = dict(ns.stateser.encode_state_parts(partition.engine.snapshot_state()))
        assert on_disk == fresh
        return full, delta, on_disk
    finally:
        broker.close()


def test_served_delta_chain_parts_equal_the_jax_engines(tmp_path):
    port_full, port_delta, port_parts = served_delta_chain(PORT, str(tmp_path / "port"))
    jax_full, jax_delta, jax_parts = served_delta_chain(JAX, str(tmp_path / "jax"))
    assert port_full["reused_parts"] == 0 and port_delta["reused_parts"] > 0
    assert port_delta == jax_delta and port_full == jax_full
    assert sorted(port_parts) == sorted(jax_parts)
    for name, blob in jax_parts.items():
        assert port_parts[name] == blob, name
