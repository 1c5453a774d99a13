"""One partition's state sharded over a span of devices, served end to end.

Port legs of ``tests/test_sharded_state.py``: ``CudaPartitionEngine`` with
``state_shards`` 2 and 4 (every shard on the CPU) serves the JAX test's
workload (a service task, then a timer) through the port's own ``Broker``.
Sharding changes where rows live, never what is written: the log's frames
and the raw segment bytes equal the single-device engine's, in the
gathered mode and in the resident mode (routed and fallback waves), and
the record signatures equal the JAX package's sharded engine's.
Tolerance 0: frames and segment files are compared byte for byte.
"""

import itertools
import math
import os
import random
import types

import numpy as np
import pytest
import torch

import zeebe_tpu.protocol.codec as jax_codec
from test_sharded_state import _sharded_workload as jax_sharded_workload
from test_tpu_parity import record_signature
from zeebe_tpu.models.bpmn.builder import Bpmn
from zeebe_tpu.models.bpmn.xml import write_model

import zeebe_tpu_torch.protocol.records as port_records
from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
from zeebe_tpu_torch.gateway import workers as workers_mod
from zeebe_tpu_torch.protocol import codec
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import MessageIntent, WorkflowInstanceIntent as WI
from zeebe_tpu_torch.protocol.records import MessageRecord, WorkflowInstanceRecord
from zeebe_tpu_torch.runtime import Broker, ControlledClock
from zeebe_tpu_torch.runtime import metrics as metrics_mod
from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY
from zeebe_tpu_torch.tpu import shard, state as state_mod
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

SEED = 0x5A4DED
CPU = torch.device("cpu")


def _engine(pid, repo, clock, shards, **kw):
    if shards > 1:
        return CudaPartitionEngine(pid, 1, repository=repo, clock=clock, capacity=1 << 10,
                                   state_shards=shards, shard_devices=[CPU] * shards, **kw)
    return CudaPartitionEngine(pid, 1, repository=repo, clock=clock, capacity=1 << 10,
                               device="cpu")


def _deploy(client, model):
    client.deploy_resources([port_records.DeploymentResource(
        resource=write_model(model), resource_name="process.bpmn")])


def _segments(data_dir):
    pdir = os.path.join(data_dir, "partition-0")
    blobs = []
    for name in sorted(os.listdir(pdir)):
        if name.startswith("segment-") and name.endswith(".log"):
            with open(os.path.join(pdir, name), "rb") as f:
                blobs.append(f.read())
    return blobs


def workload(data_dir, shards, box=None, zero=None, **kw):
    """The JAX test's workload through the port's broker: two bursts of 16
    instances of a service task followed by a 5 s timer (with ``zero``,
    every CREATE also carries it as ``z``). Returns (frames, raw segment
    bytes)."""
    workers_mod._subscriber_keys = itertools.count(1)
    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()

    def factory(pid):
        engine = _engine(pid, repo, clock, shards, **kw)
        if box is not None:
            box.append(engine)
        return engine

    broker = Broker(num_partitions=1, data_dir=data_dir, clock=clock, engine_factory=factory)
    broker.wave_size = 128
    try:
        _deploy(ZeebeClient(broker), Bpmn.create_process("shst").start_event("s")
                .service_task("w", type="shst-svc")
                .timer_catch_event("cool", duration_ms=5_000).end_event("e").done())
        JobWorker(broker, "shst-svc", lambda ctx: {"ok": True})
        for burst in range(2):
            for i in range(16):
                payload = {"b": burst, "i": i}
                if zero is not None:
                    payload["z"] = zero
                broker.write_command(
                    0, WorkflowInstanceRecord(bpmn_process_id="shst", payload=payload),
                    WI.CREATE)
            broker.run_until_idle()
            clock.advance(10_000)
            broker.tick()
            broker.run_until_idle()
        frames = [codec.encode_record(r) for r in broker.records(0)]
    finally:
        broker.close()
    return frames, _segments(data_dir)


@pytest.fixture(scope="module")
def single_device_baseline(tmp_path_factory):
    return workload(str(tmp_path_factory.mktemp("single")), 1)


def _spy(monkeypatch):
    observed = []
    real = metrics_mod.observe_sharded_wave

    def spy(split, xb, single_lane=False):
        observed.append(([int(x) for x in split], int(xb), single_lane))
        real(split, xb, single_lane=single_lane)

    monkeypatch.setattr(metrics_mod, "observe_sharded_wave", spy)
    return observed


@pytest.mark.parametrize("span", [2, 4])
def test_gathered_logs_equal_the_single_device_engine(tmp_path, monkeypatch, span,
                                                      single_device_baseline):
    observed = _spy(monkeypatch)
    bytes0 = GLOBAL_REGISTRY.counter("mesh_shard_exchange_bytes_total").value
    box = []
    frames, raw = workload(str(tmp_path / "sh"), span, box)
    base_frames, base_raw = single_device_baseline
    assert len(frames) > 100
    assert frames == base_frames, "frames diverged under sharding"
    assert raw and raw == base_raw, "raw segment bytes diverged"
    engine = box[0]
    assert engine.device_indices == list(range(span)) and engine.routing == "gathered"
    assert engine._shard_exchange_bytes == shard.state_exchange_bytes(
        state_mod.make_state(capacity=1 << 10, num_vars=16, sub_capacity=16, device="cpu"),
        span)
    served = [xb for split, xb, _ in observed if sum(split)]
    assert engine.sharded_waves == len(observed) and len(served) > 0
    assert served == [engine._shard_exchange_bytes] * len(served)
    d_bytes = GLOBAL_REGISTRY.counter("mesh_shard_exchange_bytes_total").value - bytes0
    assert d_bytes == engine._shard_exchange_bytes * len(served)
    # the blocks are the global tables' rows
    full = state_mod.state_to_numpy(engine.state)
    rows = full["ei_i32"].shape[0] // span
    for d, block in enumerate(engine._shards.shards):
        np.testing.assert_array_equal(block.ei_i32.numpy(), full["ei_i32"][d * rows:(d + 1) * rows])


@pytest.mark.parametrize("span", [2, 4])
def test_routed_logs_equal_the_single_device_engine(tmp_path, monkeypatch, span,
                                                    single_device_baseline):
    observed = _spy(monkeypatch)
    box = []
    frames, raw = workload(str(tmp_path / "rt"), span, box, routing="resident")
    engine = box[0]
    base_frames, base_raw = single_device_baseline
    assert frames == base_frames, "frames diverged under routing"
    assert raw == base_raw, "raw segment bytes diverged"
    assert engine.routing == "resident"
    assert engine.routed_waves > 0 and engine.routed_overflows == 0
    for ik, owner in engine._resident.items():
        assert owner == shard.shard_of_key_host(ik, span), ik
    routed = [split for split, _xb, single in observed if single and sum(split)]
    assert len(routed) == engine.routed_waves
    assert all(sum(1 for v in fill if v) == 1 for fill in routed)


def test_undersized_lanes_fall_back_losslessly(tmp_path, monkeypatch, single_device_baseline):
    observed = _spy(monkeypatch)
    box = []
    frames, raw = workload(str(tmp_path / "rt"), 4, box, routing="resident",
                           routed_lane_slots=2)
    engine = box[0]
    assert (frames, raw) == single_device_baseline
    assert engine.routed_overflows > 0 and engine.fallback_waves > 0
    fallbacks = [split for split, xb, single in observed if not single and sum(split)]
    assert len(fallbacks) == engine.fallback_waves
    assert {xb for split, xb, single in observed if not single and sum(split)} == \
        {engine._fallback_exchange_bytes}


def test_the_jax_sharded_engine_writes_the_same_records(tmp_path):
    """The JAX package's sharded engine (resident routing over four of the
    virtual host devices) against the port's, record by record."""
    jax_frames, _raw = jax_sharded_workload(str(tmp_path / "jax"), 4, routing="resident")
    port_frames, _raw = workload(str(tmp_path / "port"), 4, routing="resident")
    want = record_signature([jax_codec.decode_record(f)[0] for f in jax_frames])
    got = record_signature([codec.decode_record(f)[0] for f in port_frames])
    assert len(got) > 100 and got == want


def test_a_negative_zero_payload_stays_negative_when_routed(tmp_path):
    """The routed step takes the owner's emissions as they are (the JAX
    program sums them with zeros and writes +0.0): the log equals the
    single-device engine's byte for byte, and the -0.0 is in it."""
    box = []
    routed, _ = workload(str(tmp_path / "rt"), 4, box, zero=-0.0, routing="resident")
    single, _ = workload(str(tmp_path / "one"), 1, zero=-0.0)
    assert routed == single and box[0].routed_waves > 0
    zs = [r.value.payload["z"] for r in map(lambda f: codec.decode_record(f)[0], routed)
          if int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
          and "z" in (getattr(r.value, "payload", None) or {})]
    assert zs and all(z == 0 and math.copysign(1.0, z) < 0 for z in zs)


def test_message_graphs_refuse_routing(tmp_path):
    """A receive task correlates across the key space: a resident engine
    serving it routes nothing, and its log equals the single-device one."""
    logs = []
    for shards in (1, 4):
        workers_mod._subscriber_keys = itertools.count(1)
        clock = ControlledClock(start_ms=1_000_000)
        repo = WorkflowRepository()
        box = []
        broker = Broker(num_partitions=1, data_dir=str(tmp_path / f"m{shards}"), clock=clock,
                        engine_factory=lambda pid: box.append(
                            _engine(pid, repo, clock, shards, routing="resident")) or box[-1])
        _deploy(ZeebeClient(broker), Bpmn.create_process("msg").start_event("s")
                .receive_task("wait", message_name="paid", correlation_key="$.oid")
                .end_event("e").done())
        for i in range(12):
            broker.write_command(0, WorkflowInstanceRecord(
                bpmn_process_id="msg", payload={"oid": f"o{i}"}), WI.CREATE)
        broker.run_until_idle()
        for i in range(0, 12, 2):
            broker.write_command(0, MessageRecord(name="paid", correlation_key=f"o{i}",
                                                  time_to_live=60_000, payload={"ok": 1}),
                                 MessageIntent.PUBLISH)
        broker.run_until_idle()
        logs.append([codec.encode_record(r) for r in broker.records(0)])
        engine = box[0]
        if shards > 1:
            assert engine.graph.has_messages and not engine._routing_active()
            assert engine.routed_waves == 0 and engine.fallback_waves > 0
        broker.close()
    assert logs[0] == logs[1]
    completed = [f for f in logs[0] if codec.decode_record(f)[0].metadata.intent
                 == int(WI.ELEMENT_COMPLETED)]
    assert completed


def test_engine_guards():
    with pytest.raises(ValueError, match="routing"):
        CudaPartitionEngine(0, 1, capacity=256, state_shards=2, shard_devices=[CPU] * 2,
                            routing="telepathic")
    with pytest.raises(ValueError, match="cannot also be pinned"):
        CudaPartitionEngine(0, 1, capacity=256, state_shards=2, device="cpu",
                            shard_devices=[CPU] * 2)
    with pytest.raises(ValueError, match="needs that many devices"):
        CudaPartitionEngine(0, 1, capacity=256, state_shards=4, shard_devices=[CPU] * 2)
    with pytest.raises(ValueError, match="divisible"):
        CudaPartitionEngine(0, 1, capacity=302, state_shards=4, shard_devices=[CPU] * 4,
                            routing="resident")
    engine = CudaPartitionEngine(0, 1, capacity=256, state_shards=2, shard_devices=[CPU] * 2,
                                 routing="resident")
    assert engine.device_indices == [0, 1] and engine._shard_exchange_bytes > 0
    assert engine._routing_active() is False  # no graph yet
    with pytest.raises(RuntimeError, match="pinned to its mesh span"):
        engine.place_on(CPU, 0)


# -- residency invalidation ---------------------------------------------------


def _emissions(instance_keys, vtypes=None, intents=None, keys=None):
    n = len(instance_keys)
    return {
        "valid": np.ones(n, bool),
        "instance_key": np.asarray(instance_keys, np.int64),
        "vtype": np.asarray(vtypes if vtypes is not None else [0] * n, np.int32),
        "intent": np.asarray(intents if intents is not None else [0] * n, np.int32),
        "key": np.asarray(keys if keys is not None else [-1] * n, np.int64),
    }


def _resident_engine():
    engine = CudaPartitionEngine(0, 1, capacity=256, state_shards=2, shard_devices=[CPU] * 2,
                                 routing="resident")
    engine.graph = types.SimpleNamespace(has_messages=False, emit_width=4)
    assert engine._routing_active()
    return engine


def test_a_fallback_collect_retires_the_instances_its_emissions_name():
    engine = _resident_engine()
    engine._resident = {11: 1, 22: 0}
    engine._pop_residency_fallback(_emissions([11, 11, -1]), seq=7)
    assert engine._resident == {22: 0} and engine._residency_invalid[11] == 7


def test_a_stale_note_cannot_reinstate_a_popped_residency():
    engine = _resident_engine()
    o = _emissions([33], vtypes=[int(ValueType.JOB)], keys=[99])
    engine._residency_invalid = {33: 5}
    engine._note_residency(o, owner=1, seq=4)  # dispatched before the pop
    assert 33 not in engine._resident
    engine._note_residency(o, owner=1, seq=6)
    assert engine._resident[33] == 1
    done = _emissions([33], vtypes=[int(ValueType.WORKFLOW_INSTANCE)],
                      intents=[int(WI.ELEMENT_COMPLETED)], keys=[33])
    engine._note_residency(done, owner=1, seq=8)  # the root completed
    assert 33 not in engine._resident


def test_a_blind_fallback_in_flight_holds_routing_back():
    engine = _resident_engine()
    engine._resident = {44: 1}
    entry = types.SimpleNamespace(value=types.SimpleNamespace(
        headers=types.SimpleNamespace(workflow_instance_key=44)))
    args = (entry, False, int(ValueType.JOB), int(RecordType.COMMAND), 0)
    assert engine._wave_route_class(*args) == ("ik", 1)
    engine._blind_fb_inflight = 1
    assert engine._wave_route_class(*args) == ("fb",)
    create = (None, False, int(ValueType.WORKFLOW_INSTANCE), int(RecordType.COMMAND),
              int(WI.CREATE))
    assert engine._wave_route_class(*create) == ("create",)
    engine._blind_fb_inflight = 0
    assert engine._wave_route_class(*args) == ("ik", 1)


# -- snapshots across shard counts and engines -------------------------------

DERIVED = ("ei_map", "ei_index", "job_map", "job_index", "free_ei", "free_ei_pop",
           "free_ei_push", "free_job", "free_job_pop", "free_job_push")


def _normalised(arrays):
    """A state's arrays with the lookup structures derived from its rows and
    the transient worker subscriptions left out."""
    rebuilt = state_mod.state_to_numpy(state_mod.rebuild_lookup_state(
        state_mod.state_from_numpy(arrays, device="cpu")))
    return {k: (rebuilt[k] if k.split(".")[0] in DERIVED else v)
            for k, v in arrays.items() if not k.startswith("sub_")}


def _assert_same_tables(a, b):
    a, b = _normalised(a), _normalised(b)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_snapshots_round_trip_across_shard_counts(tmp_path):
    """1 → 2 → 4 → 1: each engine restores the previous one's snapshot and
    holds the same tables; a sharded restore is sharded end to end."""
    box = []
    workload(str(tmp_path / "w"), 1, box)
    snap = box[0].snapshot_state()
    want = snap["arrays"]
    clock = ControlledClock(start_ms=1_000_000)
    for shards, routing in ((2, "gathered"), (4, "resident"), (1, "gathered")):
        restored = _engine(0, WorkflowRepository(), clock, shards,
                           **({"routing": routing} if shards > 1 else {}))
        restored.restore_state(snap)
        snap = restored.snapshot_state()
        _assert_same_tables(snap["arrays"], want)
        if shards > 1:
            assert len(restored._shards.shards) == shards
            assert restored._shard_exchange_bytes > 0
            assert restored._shards.shards[-1].ei_i32.shape[0] == (1 << 10) // shards


def test_the_jax_sharded_engines_snapshot_restores_into_the_port(tmp_path):
    """A FORMAT_DEVICE_V1 snapshot of the JAX package's 2-way sharded engine
    restores into the port's 4-way sharded engine with the same tables."""
    box = []
    jax_sharded_workload(str(tmp_path / "jax"), 2, engine_box=box)
    snap = box[0].snapshot_state()
    port = _engine(0, WorkflowRepository(), ControlledClock(start_ms=1_000_000), 4)
    port.restore_state(snap)
    _assert_same_tables(state_mod.state_to_numpy(port.state),
                        {k: np.asarray(v) for k, v in snap["arrays"].items()})


def _chaos_run(data_dir, shards, crash, routing="gathered"):
    rnd = random.Random(SEED)
    clock = ControlledClock(start_ms=1_000_000)

    def boot():
        workers_mod._subscriber_keys = itertools.count(1)
        repo = WorkflowRepository()
        broker = Broker(num_partitions=1, data_dir=data_dir, clock=clock,
                        engine_factory=lambda pid: _engine(
                            pid, repo, clock, shards,
                            **({"routing": routing} if shards > 1 else {})))
        broker.wave_size = 128
        JobWorker(broker, "chaos-svc", lambda ctx: {"ok": True})
        return broker

    def burst(broker, b):
        for i in range(12):
            broker.write_command(0, WorkflowInstanceRecord(
                bpmn_process_id="chaos",
                payload={"b": b, "i": i, "r": rnd.randrange(1_000_000)}), WI.CREATE)
        broker.run_until_idle()

    broker = boot()
    try:
        _deploy(ZeebeClient(broker), Bpmn.create_process("chaos").start_event("s")
                .service_task("w", type="chaos-svc").end_event("e").done())
        burst(broker, 0)
        if crash:
            broker.close()
            broker = boot()
            n_records = len(broker.records(0))
            broker.run_until_idle()
            assert len(broker.records(0)) == n_records
        burst(broker, 1)
        return [codec.encode_record(r) for r in broker.records(0)]
    finally:
        broker.close()


@pytest.mark.parametrize("routing", ["gathered", "resident"])
def test_a_fixed_seed_crash_stop_replays_identically(tmp_path, routing):
    sharded = _chaos_run(str(tmp_path / "s"), 4, crash=True, routing=routing)
    single = _chaos_run(str(tmp_path / "u"), 1, crash=True)
    assert len(sharded) > 100 and sharded == single


def test_the_skew_gauge():
    g = GLOBAL_REGISTRY.gauge("mesh_shard_skew_ratio")
    skewed = GLOBAL_REGISTRY.counter("mesh_shard_skewed_waves_total")
    before = skewed.value
    metrics_mod.observe_sharded_wave(np.array([8, 8, 8, 8]), 0)
    assert g.value == pytest.approx(1.0)
    metrics_mod.observe_sharded_wave(np.array([32, 0, 0, 0]), 0)
    assert g.value == pytest.approx(4.0)
    metrics_mod.observe_sharded_wave(np.array([33, 0, 0, 0, 0]), 0)
    assert g.value > 4.0 and skewed.value > before
    held = g.value
    metrics_mod.observe_sharded_wave(np.array([0, 0, 0, 0]), 0)
    assert g.value == held
    counted = skewed.value
    metrics_mod.observe_sharded_wave(np.array([0, 40, 0, 0, 0]), 0, single_lane=True)
    assert g.value == held and skewed.value == counted


def test_the_due_probe_of_a_sharded_engine_reads_every_block(tmp_path):
    """The tick's probe ors the blocks' predicates without a gather, and
    equals the probe of the gathered tables."""
    box = []
    workers_mod._subscriber_keys = itertools.count(1)
    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = Broker(num_partitions=1, data_dir=str(tmp_path / "p"), clock=clock,
                    engine_factory=lambda pid: box.append(_engine(pid, repo, clock, 4)) or box[-1])
    try:
        _deploy(ZeebeClient(broker), Bpmn.create_process("t").start_event("s")
                .timer_catch_event("c", duration_ms=5_000).end_event("e").done())
        for i in range(8):
            broker.write_command(0, WorkflowInstanceRecord(bpmn_process_id="t"), WI.CREATE)
        broker.run_until_idle()
        engine = box[0]
        assert engine._shards.view is None
        assert int(engine.deadlines_due_probe()) == 0
        clock.advance(6_000)
        probe = int(engine.deadlines_due_probe())
        assert engine._shards.view is None  # no gather
        from zeebe_tpu_torch.tpu.engine import _due_probe_kernel

        assert probe == int(_due_probe_kernel(engine.state, clock())) == 1
    finally:
        broker.close()
