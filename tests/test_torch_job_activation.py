"""Job activation under load, on the port's serving path, deterministic.

A single ``ClusterBroker`` runs on a ``ControlledActorScheduler`` and a
``ControlledClock``: no thread runs an actor, and time moves only when the
test advances it, so every interleaving below is the one the test writes.
The port's node serves with ``CudaPartitionEngine`` on the CPU; the JAX
package's node serves the same commands with its host oracle, and the two
logs are held equal (``record_signature``, tolerance 0) but where a case
pins a difference.

- The broker's tick is armed anew when it ends: while the broker actor is
  busy, the timer queues one tick, not one per period, so a committed record
  does not wait behind a pile of ticks (under CPU load a fixed-rate tick
  slower than its period filled the mailbox and processing fell seconds
  behind).
- A stranded job (a worker with one credit, a second job created, the first
  job's deadline passing, the credit returned) is activated exactly once,
  through the tick's ``PROBE_JOB_BACKLOG`` bit.
- A worker's repeated ``add`` (a resubscribe after a term change, or a
  retried request), or a tick, activates no job a second time, also when
  the job lies in the engine's host-oracle table: a leader re-elected on
  its own node replays the DEPLOYMENT into the broker's repository, which
  already holds the workflow, and serves its instances on the host
  oracle. The JAX oracle activates such a job twice (its second ACTIVATE
  is rejected); the port writes the oracle's log of a single ``add``.
- A job pushed twice for one activation (by a leader that stepped down and
  by the next one) is handled once by the cluster worker.
- Once a served partition is quiet, ``job_records_in_flight()`` is empty,
  over ``tests/test_parity_fuzz.py``'s random workflows.
"""

import types

import pytest

from test_torch_cluster import _cfg, _job_activations, order_process
from test_torch_parity_fuzz import BASE, PORT as FUZZ_PORT, draw_case, run
from test_tpu_parity import record_signature

import zeebe_tpu.models.bpmn.xml as jax_xml
import zeebe_tpu.protocol.codec as jax_codec
import zeebe_tpu.protocol.metadata as jax_metadata
import zeebe_tpu.protocol.records as jax_records
import zeebe_tpu.runtime as jax_runtime
import zeebe_tpu.runtime.actors as jax_actors
from test_torch_cluster import JAX as JAX_NODE, PORT as PORT_NODE

import zeebe_tpu_torch.models.bpmn.xml as port_xml
import zeebe_tpu_torch.protocol.codec as port_codec
import zeebe_tpu_torch.protocol.metadata as port_metadata
import zeebe_tpu_torch.protocol.records as port_records
import zeebe_tpu_torch.runtime as port_runtime
import zeebe_tpu_torch.runtime.actors as port_actors
import zeebe_tpu_torch.runtime.cluster_broker as port_cluster
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import JobIntent
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

JAX = types.SimpleNamespace(
    node=JAX_NODE, runtime=jax_runtime, actors=jax_actors, codec=jax_codec,
    records=jax_records, metadata=jax_metadata, xml=jax_xml,
)
PORT = types.SimpleNamespace(
    node=PORT_NODE, runtime=port_runtime, actors=port_actors, codec=port_codec,
    records=port_records, metadata=port_metadata, xml=port_xml,
)
JOB_TYPE = "payment-service"
SUBSCRIBER = 7


class ControlledNode:
    """One broker, one partition, every actor job run by the test."""

    def __init__(self, ns, tmp_path):
        self.ns = ns
        self.clock = ns.runtime.ControlledClock(start_ms=1_000_000)
        self.scheduler = ns.actors.ControlledActorScheduler(self.clock).start()
        cfg = _cfg(ns.node, "n0")
        self.broker = ns.node.cluster.ClusterBroker(
            cfg, str(tmp_path), scheduler=self.scheduler, clock=self.clock,
            engine_factory=ns.node.factory(cfg),
        )
        self.settle()
        self.broker.open_partition(0)
        self.settle()
        self.broker.bootstrap_partition(0, {})
        self.settle(until=lambda: self.server.is_leader)

    @property
    def server(self):
        return self.broker.partitions[0]

    @property
    def engine(self):
        return self.server.engine

    def settle(self, until=None, step_ms=10, limit_ms=5_000):
        """Run every queued job; with ``until``, move the clock in steps
        until it holds (elections and the install's retries are timers)."""
        self.scheduler.work_until_done()
        waited = 0
        while until is not None and not until():
            assert waited < limit_ms, "the node did not settle"
            self.clock.advance(step_ms)
            waited += step_ms
            self.scheduler.work_until_done()

    def command(self, value, intent, key=-1):
        md = self.ns.metadata.RecordMetadata(
            record_type=RecordType.COMMAND, value_type=value.VALUE_TYPE,
            intent=int(intent),
        )
        record = self.ns.records.Record(key=key, metadata=md, value=value)
        self.broker._handle_command(
            {"partition": 0, "frame": self.ns.codec.encode_record(record)},
            self.ns.actors.ActorFuture(),
        )

    def deploy(self):
        resource = self.ns.xml.write_model(order_process(self.ns.node))
        self.command(self.ns.records.DeploymentRecord(resources=[
            self.ns.records.DeploymentResource(
                resource=resource, resource_name="process.bpmn")]), 0)

    def create(self, order_id):
        self.command(self.ns.records.WorkflowInstanceRecord(
            bpmn_process_id="order-process", payload={"orderId": order_id}), 0)

    def subscription(self, action, **fields):
        self.broker._handle_job_subscription(
            {"action": action, "partition": 0, "subscriber_key": SUBSCRIBER,
             **fields}, None, self.ns.actors.ActorFuture())

    def add(self, credits, timeout=60_000):
        self.subscription("add", job_type=JOB_TYPE, worker="w", credits=credits,
                          timeout=timeout)

    def reelect(self):
        raft = self.server.raft
        term = raft.term
        raft.actor.run(raft._start_election)
        self.settle(until=lambda: raft.term > term and self.server.is_leader
                    and self.engine is not None)

    def records(self):
        return list(self.server.log.reader(0))

    def jobs(self, intent, record_type=RecordType.EVENT):
        return [r for r in self.records()
                if int(r.metadata.value_type) == int(ValueType.JOB)
                and int(r.metadata.record_type) == int(record_type)
                and int(r.metadata.intent) == int(intent)]

    def close(self):
        self.broker.close()


@pytest.fixture
def ticks(monkeypatch):
    """The port broker's tick runs, counted (patched before a node starts:
    the tick timer binds the method when the broker actor starts)."""
    runs = []
    tick = port_cluster.ClusterBroker._tick_engines

    def counting_tick(self):
        runs.append("tick")
        return tick(self)

    monkeypatch.setattr(port_cluster.ClusterBroker, "_tick_engines", counting_tick)
    return runs


def _queued_ticks(broker):
    """The tick jobs in the broker actor's mailbox (a fixed-rate timer
    queues ``_tick_engines`` itself)."""
    cls = port_cluster.ClusterBroker
    tick_jobs = {cls._tick_engines, getattr(cls, "_tick_and_rearm", None)}
    return [fn for fn in broker._mailbox if getattr(fn, "__func__", None) in tick_jobs]


def test_the_tick_timer_queues_one_tick_behind_a_busy_broker(tmp_path, monkeypatch, ticks):
    """The broker actor is held for a second (a long drain, a leader
    install) while the scheduler's timer thread keeps expiring timers: the
    tick timer queues one tick, and a record committed meanwhile is
    processed behind at most that one and the late tick's one catch-up. A
    fixed-rate tick queued ten, and under CPU load, where a tick outlasts
    its 100 ms period, the queue never drained: the first push of the
    cluster test's worker did not come in 30 s."""
    events = ticks
    drain = port_cluster.ClusterBroker._drain_committed

    def counting_drain(self):
        events.append("drain")
        return drain(self)

    monkeypatch.setattr(port_cluster.ClusterBroker, "_drain_committed", counting_drain)
    node = ControlledNode(PORT, tmp_path)
    try:
        node.deploy()
        node.settle()
        for _ in range(10):  # the timer thread, while the actor is held
            node.clock.advance(100)
            node.scheduler._expire_due_timers(node.clock())
        assert len(_queued_ticks(node.broker)) == 1
        node.create(1)
        del events[:]
        node.settle()
        assert events.index("drain") <= 2, events
        assert len(node.jobs(JobIntent.CREATED)) == 1
    finally:
        node.close()


def _stranded_job(ns, tmp_path, busy_ticks, ticks=None):
    """chip_smoke's leg 8d on one node: a worker with one credit holds the
    first job, the second is created with no credit free, the first job's
    deadline passes (TIME_OUT from the tick), and the credit comes back
    while the broker actor is held for ``busy_ticks`` tick periods. Returns
    the node's log and the ticks run from the credit's return to the
    ACTIVATED event of the stranded job."""
    node = ControlledNode(ns, tmp_path)
    try:
        node.deploy()
        node.add(credits=1, timeout=400)
        node.create(1)
        node.settle()
        assert len(node.jobs(JobIntent.ACTIVATED)) == 1
        node.create(2)
        node.settle()
        assert len(node.jobs(JobIntent.CREATED)) == 2
        node.clock.advance(500)  # past the first job's deadline
        node.settle(until=lambda: node.jobs(JobIntent.TIMED_OUT))
        node.settle()
        activated = len(node.jobs(JobIntent.ACTIVATED))
        before = node.records()[-1].position
        node.subscription("credits", credits=1)
        for _ in range(busy_ticks):
            node.clock.advance(100)
            node.scheduler._expire_due_timers(node.clock())
        ran = len(ticks) if ticks is not None else 0
        node.settle(until=lambda: len(node.jobs(JobIntent.ACTIVATED)) > activated,
                    step_ms=100)
        node.settle()
        return (node.records(), before,
                len(ticks) - ran if ticks is not None else None)
    finally:
        node.close()


def test_a_stranded_job_is_activated_once_through_the_probe(tmp_path, monkeypatch, ticks):
    calls = []
    scan = CudaPartitionEngine.device_backlog_activations

    def recording(self):
        out = scan(self)
        calls.extend(out)
        return out

    monkeypatch.setattr(CudaPartitionEngine, "device_backlog_activations", recording)
    want, cut, _ = _stranded_job(JAX, tmp_path / "jax", busy_ticks=0)
    got, port_cut, after_credit = _stranded_job(PORT, tmp_path / "port",
                                                busy_ticks=10, ticks=ticks)
    activates, rejected = _job_activations(got)
    assert [int(r.metadata.intent) for r in calls] == [int(JobIntent.ACTIVATE)]
    # the scan takes the lowest key: the first job, timed out, activated
    # again; the second stays in the backlog (the worker has no credit)
    assert dict(activates) == {calls[0].key: 2} and rejected == 0
    # the probe launched on one tick is read on the next: the scan comes on
    # the second tick after the credit, its ACTIVATE is processed behind it
    assert after_credit <= 3, after_credit
    want, got = record_signature(want), record_signature(got)
    assert port_cut == cut
    cut = sum(1 for r in want if r[0] <= cut)
    assert got[:cut] == want[:cut]
    # after the credit's return the two differ in which stranded job they
    # take (a credit drought's known difference: the device scan takes the
    # lowest key, as the JAX engine's does; the oracle the job that waited
    # longest), and in nothing else
    first, second = sorted({r[4] for r in want if r[2] == int(ValueType.JOB) and r[4] >= 0})
    assert calls[0].key == first
    assert [r[4] for r in want[cut:] if r[2] == int(ValueType.JOB)] == [second] * 2

    def job_blind(sig):  # the job's key, payload and element instance
        return [tuple(None if i in (4, 9, 16) else v for i, v in enumerate(r))
                for r in sig]

    assert job_blind(got[cut:]) == job_blind(want[cut:])


def _repeated_request(ns, tmp_path, again, reelect):
    """One job in the backlog, a worker's ``add``, then ``again`` (None,
    "add": the same worker's second ``add``, or "tick": the broker's tick)
    before the first add's ACTIVATE is processed."""
    node = ControlledNode(ns, tmp_path)
    try:
        node.deploy()
        node.create(1)
        node.settle()
        if reelect:
            node.reelect()
        engine = node.engine
        node.add(credits=2)
        if again == "add":
            node.add(credits=2)
        elif again == "tick":
            node.broker._tick_engines()
        node.settle()
        return node.records(), engine
    finally:
        node.close()


@pytest.mark.parametrize("table, again", [
    ("device", "add"), ("host", "add"), ("host", "tick")])
def test_a_repeated_request_activates_the_backlog_job_once(tmp_path, table, again):
    """``host``: after the re-election the partition's one job lies in
    the engine's host-oracle table (the replayed DEPLOYMENT found the
    workflow in the broker's repository, so the new engine compiled
    nothing). Without the in-flight filter on the oracle's backlog scans,
    a new subscription's and the tick's, they activated it a second time."""
    reelect = table == "host"
    want, _ = _repeated_request(JAX, tmp_path / "jax1", None, reelect)
    got, engine = _repeated_request(PORT, tmp_path / "port", again, reelect)
    assert isinstance(engine, CudaPartitionEngine)
    job = next(r.key for r in got
               if int(r.metadata.value_type) == int(ValueType.JOB) and r.key >= 0)
    assert (job in engine._host.jobs) == reelect
    activates, rejected = _job_activations(got)
    assert set(activates.values()) == {1} and rejected == 0
    assert engine.job_records_in_flight() == {}
    assert record_signature(got) == record_signature(want)
    # the pinned difference: the JAX oracle, given the same requests,
    # writes a second ACTIVATE for the job and rejects it
    twice, _ = _repeated_request(JAX, tmp_path / "jax2", again, reelect)
    activates, rejected = _job_activations(twice)
    assert set(activates.values()) == {2} and rejected == 1


def _offline_worker(complete):
    """A ``RemoteJobWorker`` without a connection: its completions queue
    until the test runs them, ``complete(key)`` stands for the broker."""
    from zeebe_tpu_torch.gateway.cluster_client import RemoteJobWorker

    worker = object.__new__(RemoteJobWorker)
    queued, handled = [], []
    worker.handler = lambda pid, rec: handled.append(rec.key) or {}
    worker.handled = []
    worker._taken, worker._taken_lock = {}, __import__("threading").Lock()
    worker._completions = types.SimpleNamespace(
        submit=lambda fn, *args: queued.append((fn, args)))
    worker.client = types.SimpleNamespace(
        complete_job=lambda pid, key, payload: complete(key))
    worker._return_credit = lambda partition, n=1: None
    return worker, queued, handled


def _push(worker, key, deadline):
    from zeebe_tpu_torch.protocol.records import JobRecord, Record

    worker._on_record(0, Record(key=key, value=JobRecord(deadline=deadline, retries=3)))


def _run(queued):
    while queued:
        fn, args = queued.pop(0)
        fn(*args)


@pytest.mark.parametrize("first_completion", ["reaches a leader", "is lost"])
def test_a_job_pushed_twice_for_one_activation_is_handled_once(first_completion):
    """A leader that steps down pushes a job before its ACTIVATED event
    commits; the next leader processes the same ACTIVATE command and
    pushes it again, with the same deadline. The worker handles it once
    (a worker that takes every push completes it twice, and the second
    COMPLETE is rejected), and again only when the first completion never
    reached a leader; a later activation of the job (a new deadline) is
    handled as ever."""
    from zeebe_tpu_torch.transport import TransportError

    lost = first_completion == "is lost"
    completions = []

    def complete(key):
        completions.append(key)
        if lost and len(completions) == 1:
            raise TransportError("command failed after 24 retries: NOT_LEADER")

    worker, queued, handled = _offline_worker(complete)
    _push(worker, 5, 1_000)
    _push(worker, 5, 1_000)  # the next leader's push, the completion on its way
    _run(queued)
    assert handled == ([5, 5] if lost else [5]) and completions == handled
    _push(worker, 5, 1_000)  # a third push of the same activation
    _run(queued)
    assert handled == ([5, 5] if lost else [5])
    _push(worker, 5, 2_000)  # the job activated again
    _run(queued)
    assert handled[-1] == 5 and len(handled) == (3 if lost else 2)


def _quiet_in_flight(seed):
    case = draw_case(seed)
    _, engine = run(FUZZ_PORT, case)
    return engine.job_records_in_flight()


@pytest.mark.parametrize("seed", [BASE + k for k in (0, 5, 9)])
def test_a_quiet_partition_has_no_job_records_in_flight(seed):
    assert _quiet_in_flight(seed) == {}


@pytest.mark.slow
@pytest.mark.parametrize("seed", [BASE + k for k in range(1, 24) if k not in (5, 9)])
def test_a_quiet_partition_has_no_job_records_in_flight_slow(seed):
    assert _quiet_in_flight(seed) == {}
