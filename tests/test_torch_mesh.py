"""The mesh of the port's serving plane: placement, migration, the exchange.

Port legs of ``tests/test_mesh.py``, every device the CPU (a plan may name
one device several times, each index a place of its own):

- ``MeshExchange`` delivers queued frames in order (destination device,
  then source device, then slot), refuses frames that do not fit, flushes
  nothing when nothing is queued, delivers directly when its exchange
  raises, and delivers what the JAX package's ``MeshExchange`` delivers;
- shared waves span the plan's devices, and a flap keeps in-flight waves;
- an engine's tables lie on its assigned device, ``place_on`` moves them
  between waves and serving goes on; logs are bit-identical whether the
  partitions are placed or not, and whether cross-partition frames ride
  the exchange or the direct hop;
- a ``ClusterBroker`` with ``[mesh] exchange`` over a two-device plan
  writes the unmeshed path's records, and ``exclude_device`` moves a CUDA
  engine (``place_on``) or re-spans a sharded one (its reinstall).

Tolerance 0: frames, segment bytes and record signatures compared exactly.
"""

import collections
import itertools
import os
import time

import jax
import pytest
import torch

from test_torch_cluster import _cfg, PORT
from test_tpu_parity import record_signature
from test_cluster import wait_until
from zeebe_tpu.scheduler.placement import MeshExchange as JaxMeshExchange

import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.protocol.records as port_records
from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
from zeebe_tpu_torch.gateway import workers as workers_mod
from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
from zeebe_tpu_torch.models.bpmn.builder import Bpmn
from zeebe_tpu_torch.models.bpmn.xml import write_model
from zeebe_tpu_torch.protocol import codec
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord
from zeebe_tpu_torch.runtime import Broker, ControlledClock
from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY, event_count
from zeebe_tpu_torch.scheduler import MeshExchange, PartitionFeed, WaveScheduler
from zeebe_tpu_torch.scheduler.placement import DevicePlan
from zeebe_tpu_torch.tpu import state as state_mod
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

CPU = torch.device("cpu")


# -- MeshExchange ------------------------------------------------------------


def test_frames_round_trip_in_order():
    ex = MeshExchange([CPU] * 4, slots=4, frame_bytes=64)
    assert ex.queue(0, 2, 7, b"one")
    assert ex.queue(0, 2, 7, b"two")
    assert ex.queue(3, 2, 9, b"three")
    assert ex.queue(2, 0, 1, b"home")
    got = []
    assert ex.flush(lambda pid, frame: got.append((pid, frame))) == 4
    assert got == [(1, b"home"), (7, b"one"), (7, b"two"), (9, b"three")]
    assert ex.pending() == 0


def test_the_exchange_delivers_what_the_jax_exchange_delivers():
    frames = [(s, d, 10 * s + d, bytes([s, d]) * (1 + (s + d) % 5))
              for s in range(4) for d in range(4)]
    got = []
    for ex in (MeshExchange([CPU] * 4, slots=2, frame_bytes=16),
               JaxMeshExchange(jax.devices()[:4], slots=2, frame_bytes=16)):
        for src, dst, pid, frame in frames:
            assert ex.queue(src, dst, pid, frame)
        out = []
        ex.flush(lambda pid, frame: out.append((pid, bytes(frame))))
        got.append(out)
    assert got[0] == got[1] and len(got[0]) == len(frames)


def test_an_oversize_frame_is_refused_and_counted():
    ex = MeshExchange([CPU] * 2, slots=2, frame_bytes=16)
    before = event_count("mesh_exchange_fallbacks")
    assert not ex.queue(0, 1, 0, b"x" * 17)
    assert event_count("mesh_exchange_fallbacks") == before + 1


def test_a_full_pair_is_refused():
    ex = MeshExchange([CPU] * 2, slots=2, frame_bytes=16)
    assert ex.queue(0, 1, 0, b"a") and ex.queue(0, 1, 0, b"b")
    assert not ex.queue(0, 1, 0, b"c")
    assert ex.queue(1, 0, 0, b"d")


def test_a_flush_with_nothing_queued_is_a_noop():
    ex = MeshExchange([CPU] * 2, slots=2, frame_bytes=16)
    assert ex.flush(lambda *_: pytest.fail("nothing to deliver")) == 0


def test_a_failing_exchange_still_delivers_the_frames():
    ex = MeshExchange([CPU] * 2, slots=4, frame_bytes=32)
    assert ex.queue(0, 1, 3, b"alpha") and ex.queue(0, 1, 3, b"beta")
    assert ex.queue(1, 0, 0, b"gamma")

    def boom(*_a, **_k):
        raise RuntimeError("device lost mid-exchange")

    ex._step = boom
    before = event_count("mesh_exchange_flush_failures")
    got = []
    assert ex.flush(lambda pid, frame: got.append((pid, frame))) == 3
    assert got == [(3, b"alpha"), (3, b"beta"), (0, b"gamma")]
    assert event_count("mesh_exchange_flush_failures") > before and ex.pending() == 0


def test_an_exchange_needs_two_devices():
    with pytest.raises(ValueError, match="at least two devices"):
        MeshExchange([CPU])


# -- shared waves over the plan ------------------------------------------------


class _Rec:
    __slots__ = ("position",)

    def __init__(self, position):
        self.position = position


class PlacedFeed(PartitionFeed):
    def __init__(self, pid, n, device_index, fail_dispatch=False):
        self.partition_id = pid
        self.device_index = device_index
        self.cursor = 0
        self.limit_n = n
        self.fail_dispatch = fail_dispatch
        self.dispatched = []
        self.collected = []

    def backlog(self):
        return self.limit_n - self.cursor

    def take(self, limit):
        take = min(limit, self.limit_n - self.cursor)
        out = [_Rec(self.cursor + i) for i in range(max(take, 0))]
        self.cursor += len(out)
        return out

    def dispatch(self, records):
        if self.fail_dispatch:
            raise RuntimeError("device lost")
        self.dispatched.append(list(records))
        return list(records), 0.0, 0.0

    def collect(self, pending):
        self.collected.append(list(pending))
        return 0.0, 0.0

    def rewind(self, position):
        self.cursor = min(self.cursor, position)


def test_a_shared_wave_spans_the_plans_devices():
    ws = WaveScheduler(wave_size=512)
    plan = DevicePlan(devices=[CPU] * 4)
    feeds = [PlacedFeed(p, 16, plan.assign(p)) for p in range(4)]
    for f in feeds:
        ws.register(f)
    devs0 = GLOBAL_REGISTRY.counter("scheduler_wave_devices_total").value
    shared0 = GLOBAL_REGISTRY.counter("scheduler_shared_waves_total").value
    ws.drain()
    shared = GLOBAL_REGISTRY.counter("scheduler_shared_waves_total").value - shared0
    devs = GLOBAL_REGISTRY.counter("scheduler_wave_devices_total").value - devs0
    assert sorted(f.device_index for f in feeds) == [0, 1, 2, 3]
    assert devs / max(shared, 1) > 1.0
    assert GLOBAL_REGISTRY.gauge("serving_wave_devices").value == 4


def test_a_flap_keeps_the_waves_in_flight():
    ws = WaveScheduler(wave_size=64, quantum=16)
    plan = DevicePlan(devices=[CPU] * 3)
    ok_a, flappy, ok_b = (PlacedFeed(p, 32, plan.assign(p)) for p in range(3))
    flappy.fail_dispatch = True
    for f in (ok_a, flappy, ok_b):
        ws.register(f)
    with pytest.raises(RuntimeError, match="device lost"):
        ws.drain()
    assert flappy.cursor == 0
    for f in (ok_a, ok_b):
        assert sum(map(len, f.collected)) == sum(map(len, f.dispatched))
    old = flappy.device_index
    plan.release(1)
    assert plan.assign(1) == old
    flappy.fail_dispatch = False
    ws.drain()
    assert flappy.cursor == 32 and sum(map(len, flappy.collected)) == 32


# -- engine placement ------------------------------------------------------------


def _deploy(client, model):
    client.deploy_resources([port_records.DeploymentResource(
        resource=write_model(model), resource_name="process.bpmn")])


def _segments(data_dir, pid):
    pdir = os.path.join(data_dir, f"partition-{pid}")
    out = []
    for name in sorted(os.listdir(pdir)):
        if name.startswith("segment-") and name.endswith(".log"):
            with open(os.path.join(pdir, name), "rb") as f:
                out.append(f.read())
    return out


def test_the_state_lies_on_the_assigned_device():
    engine = CudaPartitionEngine(0, 1, capacity=64, device="cpu", device_index=3)
    assert engine.state.ei_i32.device == CPU and engine.device_index == 3
    assert engine.device_indices == []


def test_place_on_moves_live_state_and_serving_goes_on(tmp_path, monkeypatch):
    moved = []
    real = CudaPartitionEngine.place_on
    monkeypatch.setattr(CudaPartitionEngine, "place_on",
                        lambda self, d, i=-1: moved.append((d, i)) or real(self, d, i))
    workers_mod._subscriber_keys = itertools.count(1)
    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    box = []
    broker = Broker(num_partitions=1, data_dir=str(tmp_path), clock=clock,
                    engine_factory=lambda pid: box.append(CudaPartitionEngine(
                        pid, 1, repository=repo, clock=clock, capacity=256, device="cpu",
                        device_index=1)) or box[-1])
    try:
        client = ZeebeClient(broker)
        _deploy(client, Bpmn.create_process("mig").start_event("s")
                .service_task("w", type="mig-svc").end_event("e").done())
        done = []
        JobWorker(broker, "mig-svc", lambda ctx: done.append(1) or {})
        client.create_instance("mig", {"i": 0})
        broker.run_until_idle()
        engine = box[0]
        before = state_mod.state_to_numpy(engine.state)
        snapshot_dirty = engine._dirty_device
        engine.place_on("cpu", 2)
        assert engine.device_index == 2 and moved == [("cpu", 2)]
        assert engine._dirty_device == snapshot_dirty
        after = state_mod.state_to_numpy(engine.state)
        assert all((after[k] == before[k]).all() for k in before)
        client.create_instance("mig", {"i": 1})
        broker.run_until_idle()
        assert len(done) == 2
    finally:
        broker.close()


def _mesh_workload(data_dir, placed, partitions=4):
    workers_mod._subscriber_keys = itertools.count(1)
    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = Broker(num_partitions=partitions, data_dir=data_dir, clock=clock,
                    engine_factory=lambda pid: CudaPartitionEngine(
                        pid, partitions, repository=repo, clock=clock, device="cpu",
                        device_index=pid if placed else -1))
    broker.wave_size = 256
    try:
        _deploy(ZeebeClient(broker), Bpmn.create_process("mesh-par").start_event("s")
                .service_task("w", type="mesh-par-svc").end_event("e").done())
        JobWorker(broker, "mesh-par-svc", lambda ctx: {"ok": True})
        for burst in range(2):
            for i in range(4 * partitions):
                broker.write_command(i % partitions, WorkflowInstanceRecord(
                    bpmn_process_id="mesh-par", payload={"b": burst, "i": i}), WI.CREATE)
            broker.run_until_idle()
        frames = [[codec.encode_record(r) for r in broker.records(p)] for p in range(partitions)]
    finally:
        broker.close()
    return frames, [_segments(data_dir, p) for p in range(partitions)]


def test_placed_logs_equal_the_unplaced_ones(tmp_path):
    placed = _mesh_workload(str(tmp_path / "m"), True)
    single = _mesh_workload(str(tmp_path / "s"), False)
    assert sum(map(len, placed[0])) > 100
    assert placed == single


def _correlation_workload(data_dir, exchange):
    workers_mod._subscriber_keys = itertools.count(1)
    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = Broker(num_partitions=2, data_dir=data_dir, clock=clock,
                    engine_factory=lambda pid: CudaPartitionEngine(
                        pid, 2, repository=repo, clock=clock, device="cpu", device_index=pid))
    if exchange:
        broker.mesh_exchange = MeshExchange([CPU, CPU], slots=8, frame_bytes=2048)
    try:
        client = ZeebeClient(broker)
        _deploy(client, Bpmn.create_process("xcorr").start_event("s")
                .receive_task("wait", message_name="paid", correlation_key="$.oid")
                .end_event("e").done())
        for i in range(6):
            client.create_instance("xcorr", {"oid": f"k-{i}"}, partition_id=(i + 1) % 2)
        broker.run_until_idle()
        for i in range(6):
            client.publish_message("paid", f"k-{i}")
        broker.run_until_idle()
        return [[codec.encode_record(r) for r in broker.records(p)] for p in range(2)]
    finally:
        broker.close()


def test_exchanged_correlation_equals_the_direct_hop(tmp_path):
    before = event_count("mesh_exchange_frames")
    exchanged = _correlation_workload(str(tmp_path / "x"), True)
    rode = event_count("mesh_exchange_frames") - before
    direct = _correlation_workload(str(tmp_path / "d"), False)
    assert rode > 0 and exchanged == direct


# -- the cluster broker ------------------------------------------------------------


def _mesh_cluster(tmp_path, name, plan_devices, exchange=True, sharded=0, partitions=2):
    cfg = _cfg(PORT, "n0", partitions=partitions)
    cfg.engine.capacity = 1 << 10
    cfg.mesh.exchange = exchange
    cfg.mesh.sharded_partitions = sharded
    broker = ClusterBroker(cfg, str(tmp_path / name),
                           engine_factory=engine_factory_from_config(cfg, device="cpu"))
    broker.device_plan = DevicePlan(devices=plan_devices)
    for pid in range(partitions):
        broker.open_partition(pid).join(30)
        broker.bootstrap_partition(pid, {})
    assert wait_until(lambda: all(broker.partitions[p].is_leader for p in range(partitions)), 60)
    return broker


def _quiet(broker, partitions=2, still=0.6, timeout=30.0):
    """Wait until no partition's committed log grows for ``still`` s."""
    last, since = None, time.monotonic()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        now = tuple(len(broker.partitions[p].log.reader(0).read_committed())
                    for p in range(partitions))
        if now != last:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= still:
            return
        time.sleep(0.05)
    raise AssertionError("the partitions never went quiet")


def _count(broker, value_type, record_type, intent, roots=False, partitions=2):
    """Committed records of one kind over the partitions (``roots``: only a
    process instance's own)."""
    n = 0
    for p in range(partitions):
        for r in broker.partitions[p].log.reader(0).read_committed():
            md = r.metadata
            n += (md.value_type == value_type and md.record_type == record_type
                  and int(md.intent) == intent
                  and (not roots or r.key == r.value.workflow_instance_key))
    return n


def _cluster_correlation(tmp_path, name, exchange):
    broker = _mesh_cluster(tmp_path, name, [CPU, CPU], exchange=exchange)
    client = ClusterClient([broker.client_address], num_partitions=2, request_timeout_ms=60_000)
    try:
        client.deploy_model(port_builder.Bpmn.create_process("xcorr").start_event("s")
                            .receive_task("wait", message_name="paid", correlation_key="$.oid")
                            .end_event("e").done())
        _quiet(broker)
        # one causal chain at a time, so each partition's log order is fixed
        for i in range(4):
            client.create_instance("xcorr", {"oid": f"k-{i}"}, partition_id=(i + 1) % 2)
            assert wait_until(lambda: _count(broker, ValueType.MESSAGE_SUBSCRIPTION,
                                             RecordType.EVENT, 1) > i, 30)  # OPENED
            _quiet(broker)
        for i in range(4):
            client.publish_message("paid", f"k-{i}")
            assert wait_until(lambda: _count(broker, ValueType.WORKFLOW_INSTANCE,
                                             RecordType.EVENT, int(WI.ELEMENT_COMPLETED),
                                             roots=True) > i, 30)
            _quiet(broker)
        engines = [broker.partitions[p].engine for p in range(2)]
        assert all(isinstance(e, CudaPartitionEngine) for e in engines)
        assert sorted(e.device_index for e in engines) == [0, 1]  # install order varies
        return [record_signature(broker.partitions[p].log.reader(0).read_committed())
                for p in range(2)]
    finally:
        client.close()
        broker.close()


def test_a_cluster_node_exchanges_frames_and_writes_the_unmeshed_records(tmp_path):
    before = event_count("mesh_exchange_frames")
    fallbacks = event_count("mesh_exchange_fallbacks")
    meshed = _cluster_correlation(tmp_path, "mesh", True)
    assert event_count("mesh_exchange_frames") > before
    assert event_count("mesh_exchange_fallbacks") == fallbacks
    direct = _cluster_correlation(tmp_path, "direct", False)
    assert meshed == direct
    completed = [s for s in meshed[0] + meshed[1]
                 if s[2] == int(ValueType.WORKFLOW_INSTANCE) and s[3] == int(WI.ELEMENT_COMPLETED)
                 and s[8] == "xcorr"]
    assert len(completed) == 4


def _serve(client, broker, pid, n):
    for i in range(n):
        rsp = client.create_instance("cx", {"i": i}, partition_id=pid)
        assert rsp.value.workflow_instance_key > 0


def test_exclude_device_moves_a_cuda_engine(tmp_path):
    broker = _mesh_cluster(tmp_path, "x", [CPU, CPU, CPU])
    client = ClusterClient([broker.client_address], num_partitions=2, request_timeout_ms=60_000)
    try:
        client.deploy_model(port_builder.Bpmn.create_process("cx").start_event("s")
                            .end_event("e").done())
        _serve(client, broker, 0, 2)
        plan = broker.device_plan
        victim = plan.device_index(0)
        engine = broker.partitions[0].engine
        moves = broker.exclude_device(victim).join(30)
        new = plan.device_index(0)
        assert moves[0] == new != victim
        assert broker.partitions[0].engine is engine  # moved, not rebuilt
        assert engine.device_index == new == broker.partitions[0].device_index
        _serve(client, broker, 0, 2)
        _quiet(broker)
        done = collections.Counter(
            r.key for r in broker.partitions[0].log.reader(0).read_committed()
            if int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
            and int(r.metadata.record_type) == int(RecordType.EVENT)
            and int(r.metadata.intent) == int(WI.ELEMENT_COMPLETED)
            and r.key == r.value.workflow_instance_key)
        assert len(done) == 4 and set(done.values()) == {1}
    finally:
        client.close()
        broker.close()


def _completed_once(broker, pid, n, timeout=30):
    """Wait until ``n`` root instances of partition ``pid`` completed, each once."""
    def done():
        return collections.Counter(
            r.key for r in broker.partitions[pid].log.reader(0).read_committed()
            if int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
            and int(r.metadata.record_type) == int(RecordType.EVENT)
            and int(r.metadata.intent) == int(WI.ELEMENT_COMPLETED)
            and r.key == r.value.workflow_instance_key)
    assert wait_until(lambda: len(done()) >= n, timeout), done()
    assert len(done()) == n and set(done().values()) == {1}


def test_exclude_device_respans_a_sharded_engine(tmp_path):
    """A sharded engine is pinned to its span: the exclusion reinstalls the
    partition from its log onto the plan's new span, its ``device_indices``
    follow the plan, and the reinstalled engine keeps the worker's
    subscription (the worker sees the same address and term)."""
    broker = _mesh_cluster(tmp_path, "s", [CPU] * 4, sharded=2)
    client = ClusterClient([broker.client_address], num_partitions=2, request_timeout_ms=60_000)
    try:
        client.deploy_model(port_builder.Bpmn.create_process("cx").start_event("s")
                            .service_task("w", type="cx-svc").end_event("e").done())
        worker = client.open_job_worker("cx-svc", lambda pid, rec: {"ok": True}, credits=8)
        plan = broker.device_plan
        spans = [list(broker.partitions[p].engine.device_indices) for p in range(2)]
        assert spans == [plan.device_indices(p) for p in range(2)]
        assert sorted(spans[0] + spans[1]) == [0, 1, 2, 3]
        _serve(client, broker, 0, 2)
        _completed_once(broker, 0, 2)
        victim = spans[0][0]
        before = event_count("mesh_state_migration_failures")
        broker.exclude_device(victim).join(30)
        assert event_count("mesh_state_migration_failures") == before + 1
        assert wait_until(lambda: broker.partitions[0].engine is not None
                          and broker.partitions[0].is_leader, 30)
        engine = broker.partitions[0].engine
        span = list(engine.device_indices)
        assert span == plan.device_indices(0) and victim not in span
        assert [s.job_type for s in engine.job_subscriptions()] == ["cx-svc"]
        _serve(client, broker, 0, 2)
        _completed_once(broker, 0, 4)
        worker.close()
    finally:
        client.close()
        broker.close()


def test_the_factory_spans_a_sharded_partition_and_routes_by_residency():
    """``[mesh] shardedPartitions`` and ``routing`` reach the engine: the
    partition's tables block-shard over the span the plan assigns it."""
    import types

    from zeebe_tpu_torch.runtime.config import BrokerCfg

    cfg = BrokerCfg()
    cfg.cluster.partitions = 2
    cfg.engine.type, cfg.engine.capacity = "cuda", 256
    cfg.mesh.sharded_partitions, cfg.mesh.routing = 2, "resident"
    plan = DevicePlan(devices=[CPU] * 4)

    def planned_span(pid):
        idx = plan.assign_span(pid, 2)
        return [plan.devices[i] for i in idx], idx

    broker = types.SimpleNamespace(
        cfg=cfg, repository=WorkflowRepository(), clock=lambda: 5, device_plan=plan,
        planned_span=planned_span,
        planned_device=lambda pid: pytest.fail("a sharded partition takes a span"))
    factory = engine_factory_from_config(cfg, device="cpu")
    engines = [factory(pid, broker) for pid in range(2)]
    assert [e.device_indices for e in engines] == [plan.device_indices(p) for p in range(2)]
    assert sorted(engines[0].device_indices + engines[1].device_indices) == [0, 1, 2, 3]
    assert all(e.routing == "resident" and len(e._shards.shards) == 2 for e in engines)
    assert [e.device_index for e in engines] == [e.device_indices[0] for e in engines]


def test_instance_keys_carry_their_partition(tmp_path):
    """A message partition holds subscriptions of several partitions'
    instances and tells them apart by their instance and activity keys.
    Partition-local counters gave two partitions' instances equal keys, and
    then one CLOSE closed the other's subscription and its own found none
    (chip_smoke 9b, 64 correlations over 8 partitions, lost a CLOSED in 3
    of 8 CPU runs). Now every instance and job key carries its partition in
    the high bits (partition 0's keys are as before); two instances whose
    keys hash to one message partition each correlate and close once."""
    from zeebe_tpu_torch.engine.interpreter import PartitionEngine

    for pid in (0, 1, 7):
        oracle = PartitionEngine(partition_id=pid, num_partitions=8)
        device = CudaPartitionEngine(pid, 8, capacity=64, device="cpu")
        assert oracle.wf_keys.peek == device._host.wf_keys.peek == (pid << 51) + 1
        assert oracle.job_keys.peek == (pid << 51) + 2
        assert int(device.state.next_wf_key) == (pid << 51) + 1
        assert int(device.state.next_job_key) == (pid << 51) + 2
    probe = PartitionEngine(partition_id=0, num_partitions=2)
    a, b = [k for k in (f"c-{i}" for i in range(64))
            if probe.partition_for_correlation_key(k) == 1][:2]
    workers_mod._subscriber_keys = itertools.count(1)
    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = Broker(num_partitions=2, data_dir=str(tmp_path), clock=clock,
                    engine_factory=lambda pid: CudaPartitionEngine(
                        pid, 2, repository=repo, clock=clock, device="cpu", device_index=pid))
    broker.mesh_exchange = MeshExchange([CPU, CPU], slots=8, frame_bytes=2048)
    try:
        client = ZeebeClient(broker)
        _deploy(client, Bpmn.create_process("pair").start_event("s")
                .receive_task("wait", message_name="paid", correlation_key="$.oid")
                .end_event("e").done())
        wiks = [client.create_instance("pair", {"oid": key}, partition_id=pid).workflow_instance_key
                for pid, key in ((0, a), (1, b))]
        broker.run_until_idle()
        assert [k >> 51 for k in wiks] == [0, 1]
        for key in (a, b):
            client.publish_message("paid", key)
        broker.run_until_idle()
        closed = [r for r in broker.records(1)
                  if r.metadata.value_type == ValueType.MESSAGE_SUBSCRIPTION
                  and r.metadata.record_type == RecordType.EVENT and int(r.metadata.intent) == 5]
        assert sorted(r.value.workflow_instance_key for r in closed) == sorted(wiks)
        done = [r.key for p in (0, 1) for r in broker.records(p)
                if r.metadata.value_type == ValueType.WORKFLOW_INSTANCE
                and int(r.metadata.intent) == int(WI.ELEMENT_COMPLETED)
                and r.key == r.value.workflow_instance_key]
        assert sorted(done) == sorted(wiks)
    finally:
        broker.close()
