"""The port's cluster node against the JAX package's.

The port's raft-replicated ``ClusterBroker`` (a copy of the JAX package's)
serves its leader partitions with ``CudaPartitionEngine`` on the CPU here
(every kernel wrapper takes its plain PyTorch version) and answers the
port's ``ClusterClient`` over TCP on ports the OS picks:

- one node, one instance at a time, writes the same log as the JAX
  package's node with its host oracle (``record_signature`` of
  ``tests/test_tpu_parity.py``, tolerance 0: every field is an integer,
  string or exact payload);
- three nodes with two partitions replicate the device snapshot, and the
  leader elected after a failover restores the engine from it, replays the
  committed log and serves on, every instance completing exactly once;
- the broker tick polls the engine's due probe without blocking, over
  several ticks, and writes the commands of a due job deadline and of a
  stranded backlog job.
"""

import collections
import dataclasses
import types

from test_cluster import make_cfg, wait_until
from test_tpu_parity import record_signature

import zeebe_tpu.gateway.cluster_client as jax_client
import zeebe_tpu.models.bpmn.builder as jax_builder
import zeebe_tpu.runtime.cluster_broker as jax_cluster
import zeebe_tpu.runtime.config as jax_config

import zeebe_tpu_torch.gateway.cluster_client as port_client
import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.runtime as port_runtime
import zeebe_tpu_torch.runtime.cluster_broker as port_cluster
import zeebe_tpu_torch.runtime.config as port_config
from zeebe_tpu_torch.log import stateser
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import JobIntent, WorkflowInstanceIntent
from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

JAX = types.SimpleNamespace(
    cluster=jax_cluster, config=jax_config, client=jax_client,
    builder=jax_builder, factory=lambda cfg: None,
)
PORT = types.SimpleNamespace(
    cluster=port_cluster, config=port_config, client=port_client,
    builder=port_builder,
    factory=lambda cfg: engine_factory_from_config(cfg, device="cpu"),
)


def order_process(ns):
    return (
        ns.builder.Bpmn.create_process("order-process")
        .start_event("start")
        .service_task("collect-money", type="payment-service")
        .end_event("end")
        .done()
    )


def _cfg(ns, node_id, partitions=1):
    """tests/test_cluster.py's timings, on the package's own config type."""
    cfg = ns.config.BrokerCfg()
    for section, ref in vars(make_cfg(node_id, partitions)).items():
        if dataclasses.is_dataclass(ref):
            for field, value in vars(ref).items():
                setattr(getattr(cfg, section), field, value)
    cfg.engine.type = "cuda" if ns is PORT else "host"
    return cfg


def _single_node(ns, tmp_path, clock=None):
    cfg = _cfg(ns, "n0")
    broker = ns.cluster.ClusterBroker(
        cfg, str(tmp_path / "n0"), clock=clock, engine_factory=ns.factory(cfg)
    )
    broker.open_partition(0).join(30)
    broker.bootstrap_partition(0, {})
    assert wait_until(lambda: broker.partitions[0].is_leader, 60)
    return broker


def _committed(log):
    return log.reader(0).read_committed()


def _identity(r):
    """What a replica stores of a record and no engine rewrites (a
    leader's log hands back the records its engine processed)."""
    md = r.metadata
    return (r.position, r.raft_term, r.timestamp, int(md.record_type),
            int(md.value_type), int(md.intent), r.key, r.source_record_position,
            md.request_id)


def _process_completions(log):
    """instance key → process-level ELEMENT_COMPLETED events in ``log``."""
    done = collections.Counter()
    for r in _committed(log):
        if (int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
                and int(r.metadata.record_type) == int(RecordType.EVENT)
                and int(r.metadata.intent) == int(WorkflowInstanceIntent.ELEMENT_COMPLETED)
                and r.key == r.value.workflow_instance_key):
            done[r.key] += 1
    return done


def _job_activations(records):
    """job key → ACTIVATE commands in ``records``, and the JOB commands
    rejected: a job activated twice shows as a second ACTIVATE and its
    rejection."""
    activates = collections.Counter()
    rejected = 0
    for r in records:
        if int(r.metadata.value_type) != int(ValueType.JOB):
            continue
        rt, intent = int(r.metadata.record_type), int(r.metadata.intent)
        if rt == int(RecordType.COMMAND) and intent == int(JobIntent.ACTIVATE):
            activates[r.key] += 1
        rejected += rt == int(RecordType.COMMAND_REJECTION)
    return activates, rejected


def _serve_sequentially(ns, tmp_path, instances):
    broker = _single_node(ns, tmp_path)
    client = ns.client.ClusterClient([broker.client_address], num_partitions=1)
    try:
        client.deploy_model(order_process(ns))
        pushed = []
        worker = client.open_job_worker(
            "payment-service",
            lambda pid, rec: pushed.append(rec.key) or {"paid": len(pushed)},
        )
        log = broker.partitions[0].log
        for i in range(instances):
            client.create_instance("order-process", {"orderId": i})
            assert wait_until(lambda: len(pushed) == i + 1, 30), pushed
            assert wait_until(
                lambda: sum(_process_completions(log).values()) == i + 1, 30)
        worker.close()
        engine = broker.partitions[0].engine
        return record_signature(_committed(log)), engine
    finally:
        client.close()
        broker.close()


def test_sequential_script_writes_the_oracles_log(tmp_path):
    want, _ = _serve_sequentially(JAX, tmp_path / "jax", 6)
    got, engine = _serve_sequentially(PORT, tmp_path / "port", 6)
    assert isinstance(engine, CudaPartitionEngine)
    assert engine.device_records_processed > 0 and engine.host_only_reasons == {}
    assert len(want) > 6 * 10
    assert got == want


class PortCluster:
    """tests/test_cluster.py's ClusterUnderTest on the port: every
    partition replicated on every broker, the CUDA engine on the CPU."""

    def __init__(self, tmp_path, n_brokers, partitions):
        self.partitions = partitions
        self.brokers = {}
        for i in range(n_brokers):
            cfg = _cfg(PORT, f"b{i}", partitions)
            self.brokers[cfg.cluster.node_id] = port_cluster.ClusterBroker(
                cfg, str(tmp_path / f"b{i}"), engine_factory=PORT.factory(cfg)
            )
        nodes = list(self.brokers.values())
        for broker in nodes[1:]:
            broker.join([nodes[0].gossip_address]).join(10)
        for pid in range(partitions):
            addrs = {nid: b.open_partition(pid).join(10) for nid, b in self.brokers.items()}
            for nid, broker in self.brokers.items():
                broker.bootstrap_partition(
                    pid, {n: a for n, a in addrs.items() if n != nid})

    def leader_of(self, pid):
        for broker in self.brokers.values():
            server = broker.partitions.get(pid)
            if server is not None and server.is_leader and server.engine is not None:
                return broker
        return None

    def client(self):
        return port_client.ClusterClient(
            [b.client_address for b in self.brokers.values()],
            num_partitions=self.partitions,
        )

    def close(self):
        for broker in self.brokers.values():
            broker.close()


def _create(client, pid, n, start):
    for i in range(n):
        client.create_instance("order-process", {"orderId": start + i}, partition_id=pid)


def test_three_node_failover_restores_the_device_snapshot(tmp_path, monkeypatch):
    per_partition = 32
    restored = []
    restore = CudaPartitionEngine.restore_state

    def recording_restore(self, snap):
        restored.append(self)
        return restore(self, snap)

    monkeypatch.setattr(CudaPartitionEngine, "restore_state", recording_restore)
    cluster = PortCluster(tmp_path, n_brokers=3, partitions=2)
    client = None
    try:
        assert wait_until(lambda: all(cluster.leader_of(p) for p in (0, 1)), 60)
        client = cluster.client()
        client.deploy_model(order_process(PORT))
        pushed = []
        worker = client.open_job_worker(
            "payment-service", lambda pid, rec: pushed.append((pid, rec.key)) or {})
        for pid in (0, 1):
            _create(client, pid, per_partition, 0)

        def completed(pid):
            leader = cluster.leader_of(pid)
            return _process_completions(leader.partitions[pid].log) if leader else {}

        # each poll decodes the leader's log: a few a second, or the polls
        # hold the interpreter the three brokers' raft heartbeats need, and
        # a leader re-elected under it pushes a job twice or loses a
        # completion (the 200 ms election timeout of tests/test_cluster.py)
        for pid in (0, 1):
            assert wait_until(lambda: len(completed(pid)) == per_partition, 60, 0.25), pid
        for pid in (0, 1):
            leader = cluster.leader_of(pid)
            assert isinstance(leader.partitions[pid].engine, CudaPartitionEngine)
            leader.snapshot_all()

        def every_replica_has_a_snapshot():
            return all(b.partitions[p].snapshots.storage.list()
                       for b in cluster.brokers.values() for p in (0, 1))

        assert wait_until(every_replica_has_a_snapshot, 60)
        for broker in cluster.brokers.values():
            for pid in (0, 1):
                server = broker.partitions[pid]
                state, meta = server.snapshots.recover(server.log.next_position - 1)
                assert state["fmt"] == stateser.FORMAT_DEVICE_V1, (broker.node_id, pid)
                assert meta.last_processed_position > 0

        old = cluster.leader_of(0)
        old.close()
        del cluster.brokers[old.node_id]
        assert wait_until(lambda: cluster.leader_of(0) is not None, 60)
        new_leader = cluster.leader_of(0)
        engine = new_leader.partitions[0].engine
        assert isinstance(engine, CudaPartitionEngine)
        assert any(e is engine for e in restored)

        _create(client, 0, per_partition, per_partition)
        assert wait_until(lambda: len(completed(0)) == 2 * per_partition, 90, 0.25)
        assert wait_until(lambda: cluster.leader_of(1) is not None, 60)
        assert len(completed(1)) == per_partition
        worker.close()
        for pid in (0, 1):
            assert set(completed(pid).values()) == {1}
            assert engine.device_records_processed > 0
            survivors = [b.partitions[pid].log for b in cluster.brokers.values()]
            # neither the new leader's tick nor the worker's new subscription
            # activates a job that the old leader's tail activates again
            activates, rejected = _job_activations(
                _committed(cluster.leader_of(pid).partitions[pid].log))
            want = 2 * per_partition if pid == 0 else per_partition
            assert len(activates) == want and set(activates.values()) == {1}, pid
            assert rejected == 0, pid
            common = min(log.commit_position for log in survivors)
            encoded = [
                [_identity(r) for r in _committed(log) if r.position <= common]
                for log in survivors
            ]
            assert encoded[0] and all(e == encoded[0] for e in encoded[1:])
    finally:
        if client is not None:
            client.close()
        cluster.close()


class _SlothWorker(port_client.RemoteJobWorker):
    """Takes pushes and keeps the credit: the job can only come back through
    the tick's deadline sweep, and a job created meanwhile is stranded."""

    def _on_record(self, partition, record, epoch=-1):
        self.handled.append(record)


def test_the_tick_polls_the_due_probe_and_writes_its_commands(tmp_path, monkeypatch):
    polled, calls = [], collections.defaultdict(list)
    probe = CudaPartitionEngine.deadlines_due_probe

    def counting_probe(self):
        handle = probe(self)
        polled.append(handle)
        return handle

    monkeypatch.setattr(CudaPartitionEngine, "deadlines_due_probe", counting_probe)
    for name in ("device_deadline_commands", "device_backlog_activations"):
        def recording(self, _orig=getattr(CudaPartitionEngine, name), _name=name):
            out = _orig(self)
            calls[_name] += out
            return out

        monkeypatch.setattr(CudaPartitionEngine, name, recording)

    # the engines' clock moves only when the test says: the first job's
    # 400 ms deadline passes once the second job is stranded, not while
    # its creation is still in flight (on the wall clock, under load, the
    # second job's CREATED could come after the returned credit and take it)
    clock = port_runtime.ControlledClock(start_ms=1_000_000)
    broker = _single_node(PORT, tmp_path, clock=clock)
    client = port_client.ClusterClient([broker.client_address], num_partitions=1)
    try:
        client.deploy_model(order_process(PORT))
        worker = _SlothWorker(client, "payment-service", handler=None,
                              worker_name="sloth", credits=1, timeout_ms=400,
                              partitions=[0])
        first = client.create_instance("order-process", {"orderId": 1})
        assert wait_until(lambda: len(worker.handled) == 1, 30)
        # no credit left: the second job is created and stranded
        client.create_instance("order-process", {"orderId": 2})
        engine, log = broker.partitions[0].engine, broker.partitions[0].log

        def second_job_stranded():
            created = [
                r.position for r in _committed(log)
                if int(r.metadata.value_type) == int(ValueType.JOB)
                and int(r.metadata.record_type) == int(RecordType.EVENT)
                and int(r.metadata.intent) == int(JobIntent.CREATED)
            ]
            return len(created) == 2 and engine.last_processed_position >= created[1]

        assert wait_until(second_job_stranded, 30)
        clock.advance(500)
        # the first job's deadline falls due: TIME_OUT from the tick
        assert wait_until(lambda: any(
            int(r.metadata.intent) == int(JobIntent.TIME_OUT)
            for r in calls["device_deadline_commands"]), 30)

        def timed_out_event_processed():
            # the engine has stepped the TIMED_OUT event with no credit free:
            # both jobs are stranded now
            timed_out = [
                r.position for r in _committed(log)
                if int(r.metadata.value_type) == int(ValueType.JOB)
                and int(r.metadata.record_type) == int(RecordType.EVENT)
                and int(r.metadata.intent) == int(JobIntent.TIMED_OUT)
            ]
            return timed_out and engine.last_processed_position >= timed_out[0]

        assert wait_until(timed_out_event_processed, 30)
        # a returned credit serves the backlog through the probe's bit
        worker._return_credit(0)
        assert wait_until(lambda: calls["device_backlog_activations"], 30)
        assert wait_until(lambda: len(worker.handled) == 2, 30)
        worker.close()

        written = [(int(r.metadata.record_type), int(r.metadata.intent), r.key)
                   for r in _committed(log)
                   if int(r.metadata.value_type) == int(ValueType.JOB)]
        for command in calls["device_deadline_commands"] + calls["device_backlog_activations"]:
            assert (int(RecordType.COMMAND), int(command.metadata.intent),
                    command.key) in written
        assert first.value.workflow_instance_key in {
            r.value.headers.workflow_instance_key for r in worker.handled}
        assert len(polled) >= 3
        assert all(p.is_ready() for p in polled)
    finally:
        client.close()
        broker.close()


def test_the_backlog_scan_leaves_out_jobs_whose_activation_is_in_flight(tmp_path):
    """Between a job's CREATE and the processing of its CREATED event, and
    again until the ACTIVATE the kernel writes for it is processed, the
    table already says CREATED while a credit is free. The oracle's backlog
    holds only jobs whose pool event found no credit, so the tick's scan
    must activate none of them: stepped one record at a time with a
    credited worker, it returns nothing at every step."""
    import zeebe_tpu_torch.gateway as port_gateway
    import zeebe_tpu_torch.runtime as port_runtime
    from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord

    clock = port_runtime.ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = port_runtime.Broker(
        num_partitions=1, clock=clock, data_dir=str(tmp_path),
        engine_factory=lambda pid: CudaPartitionEngine(
            pid, 1, repository=repo, clock=clock, capacity=64, device="cpu"),
    )
    try:
        port_gateway.ZeebeClient(broker).deploy_model(order_process(PORT))
        port_gateway.JobWorker(broker, "payment-service", lambda ctx: {}, credits=4)
        broker.run_until_idle()
        for i in range(3):
            broker.write_command(
                0, WorkflowInstanceRecord(bpmn_process_id="order-process",
                                          payload={"orderId": i}),
                WorkflowInstanceIntent.CREATE,
            )
        engine = broker.partitions[0].engine
        scheduler = broker._wave_scheduler()
        windows = 0
        while scheduler.drain(max_records=1):
            live = engine.state.job_key >= 0
            created = engine.state.job_i32[live, 0] == int(JobIntent.CREATED)
            windows += bool(created.any()) and bool(engine._job_records_in_flight)
            assert engine.device_backlog_activations() == []
        assert windows > 0
        assert sum(_process_completions(broker.partitions[0].log).values()) == 3
    finally:
        broker.close()


def test_a_restart_counts_the_unprocessed_tail_before_the_first_tick(tmp_path):
    """A snapshot taken while a job's CREATED event or ACTIVATE command is
    still unprocessed covers the record that wrote it, so no output of the
    restarted engine counts it: the broker's replay hands the engine its
    unprocessed tail, and a new worker's backlog and the tick's scan leave
    the job out until the tail drains. Restarted at every such window, each
    job is activated once and nothing stays counted."""
    import zeebe_tpu_torch.gateway as port_gateway
    import zeebe_tpu_torch.runtime as port_runtime
    from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord
    from zeebe_tpu_torch.tpu.state import JB_STATE

    clock = port_runtime.ControlledClock(start_ms=1_000_000)

    def open_broker():
        repo = WorkflowRepository()
        return port_runtime.Broker(
            num_partitions=1, clock=clock, data_dir=str(tmp_path),
            engine_factory=lambda pid: CudaPartitionEngine(
                pid, 1, repository=repo, clock=clock, capacity=64, device="cpu"),
        )

    broker = open_broker()
    try:
        port_gateway.ZeebeClient(broker).deploy_model(order_process(PORT))
        port_gateway.JobWorker(broker, "payment-service", lambda ctx: {}, credits=4)
        broker.run_until_idle()
        for i in range(2):
            broker.write_command(
                0, WorkflowInstanceRecord(bpmn_process_id="order-process",
                                          payload={"orderId": i}),
                WorkflowInstanceIntent.CREATE,
            )
        restarts = 0
        while broker._wave_scheduler().drain(max_records=1):
            engine = broker.partitions[0].engine
            live = engine.state.job_key >= 0
            created = engine.state.job_i32[live, JB_STATE] == int(JobIntent.CREATED)
            if not (bool(created.any()) and engine._job_records_in_flight):
                continue
            broker.snapshot()
            broker.close()
            broker = open_broker()
            engine = broker.partitions[0].engine
            assert engine._job_records_in_flight, restarts
            # subscriptions do not survive a restart: the new worker's
            # backlog and the tick's scan both leave the tail's jobs out
            port_gateway.JobWorker(broker, "payment-service", lambda ctx: {}, credits=4)
            assert engine.device_backlog_activations() == [], restarts
            restarts += 1
        activates, rejected = _job_activations(broker.records(0))
        assert len(activates) == 2 and set(activates.values()) == {1}
        assert rejected == 0
        assert broker.partitions[0].engine._job_records_in_flight == {}
        assert restarts >= 2
    finally:
        broker.close()


def test_a_step_down_during_the_leader_install_uninstalls_after_it(tmp_path):
    """The install checks the raft term when it starts; a step-down that
    arrives while it is still building the engine must take effect once
    it ends, or a follower keeps serving beside the real leader (seen on
    the card, where the CUDA engine's install takes long enough)."""
    import threading

    from zeebe_tpu_torch.cluster import RaftState

    building, release = threading.Event(), threading.Event()
    cfg = _cfg(PORT, "n0")
    base = PORT.factory(cfg)

    armed = []

    def slow_factory(pid, broker):
        engine = base(pid, broker)
        if armed:  # the second install: hold it until the step-down is in
            building.set()
            assert release.wait(30)
        return engine

    broker = port_cluster.ClusterBroker(cfg, str(tmp_path / "n0"),
                                        engine_factory=slow_factory)
    try:
        broker.open_partition(0).join(30)
        broker.bootstrap_partition(0, {})
        server = broker.partitions[0]
        assert wait_until(lambda: server.is_leader, 60)
        term = server.raft.term
        armed.append(True)
        broker.actor_control.run(server._uninstall_leader)
        broker.actor_control.run(lambda: server._install_leader(term))
        assert building.wait(30)
        server._on_raft_state_change(RaftState.FOLLOWER, term)  # while installing
        settled = threading.Event()
        broker.actor_control.run(settled.set)  # behind the install and the step-down
        release.set()
        assert settled.wait(30)
        assert server.is_leader is False and server.engine is None
    finally:
        release.set()
        broker.close()


def test_a_worker_resubscribes_when_its_leader_is_reelected(tmp_path):
    """A broker that loses a partition's leadership and wins it back at a
    higher term keeps its address but installs a new engine, which holds
    no job subscription. The worker compares the leader's term as well as
    its address and subscribes again; before, every job created after
    such a re-election stayed unactivated (seen in chip_smoke 8b)."""
    cluster = PortCluster(tmp_path, n_brokers=3, partitions=2)
    client = None
    try:
        assert wait_until(lambda: all(cluster.leader_of(p) for p in (0, 1)), 60)
        client = cluster.client()
        client.deploy_model(order_process(PORT))
        pushed = []
        worker = client.open_job_worker(
            "payment-service", lambda pid, rec: pushed.append((pid, rec.key)) or {})
        _create(client, 0, 4, 0)
        assert wait_until(lambda: len(pushed) == 4, 60), pushed
        leader = cluster.leader_of(0)
        for _ in range(20):  # until the same broker wins the election it starts
            raft = leader.partitions[0].raft
            term = raft.term
            raft.actor.run(raft._start_election)
            assert wait_until(lambda: cluster.leader_of(0) is not None
                              and cluster.leader_of(0).partitions[0].raft.term > term, 30)
            if cluster.leader_of(0) is leader:
                break
            leader = cluster.leader_of(0)
        assert cluster.leader_of(0) is leader
        _create(client, 0, 4, 4)
        assert wait_until(lambda: len(pushed) == 8, 30), pushed
        assert wait_until(lambda: len(_process_completions(leader.partitions[0].log)) == 8, 30)
        worker.close()
    finally:
        if client is not None:
            client.close()
        cluster.close()
