"""``CudaPartitionEngine`` (on the CPU) against the JAX package's
``TpuPartitionEngine`` (on the CPU), each under its own package's
in-process ``Broker`` with the same commands: the credit-drought bursts of
config 1 and config 2 write the same log and leave the same state tables,
bit for bit; a snapshot written by either engine (with live device timers
in it) restores into the other and the run finishes with the same log; a
CANCEL of an instance waiting on a device timer writes the host oracle's
log; the tick probe and the device backlog agree; and the boot self-check
refuses to serve on a mismatch.
"""

import itertools
import re
import shutil
import types

import numpy as np
import pytest
import torch

import bench
import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu.runtime as jax_runtime
from zeebe_tpu.engine.interpreter import WorkflowRepository as JaxRepository
from zeebe_tpu.models.bpmn.xml import write_model
from zeebe_tpu.protocol.intents import WorkflowInstanceIntent as JaxWI
from zeebe_tpu.protocol.records import WorkflowInstanceRecord as JaxWIRecord
from zeebe_tpu.tpu import engine as jax_engine_mod
from zeebe_tpu.tpu import TpuPartitionEngine
from test_tpu_parity import order_process, record_signature
from test_torch_serving import timer_process

import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.gateway.workers as port_workers
import zeebe_tpu_torch.protocol.records as port_records
import zeebe_tpu_torch.runtime as port_runtime
from zeebe_tpu_torch.engine.interpreter import WorkflowRepository as PortRepository
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as PortWI
from zeebe_tpu_torch.tpu import engine as port_engine_mod
from zeebe_tpu_torch.tpu import ops
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

CAPACITY = 1 << 10


def _jax_broker(clock, data_dir):
    repo = JaxRepository()
    return jax_runtime.Broker(
        num_partitions=1, clock=clock, data_dir=data_dir,
        engine_factory=lambda pid: TpuPartitionEngine(
            pid, 1, repository=repo, clock=clock, capacity=CAPACITY
        ),
    )


def _port_broker(clock, data_dir):
    repo = PortRepository()
    return port_runtime.Broker(
        num_partitions=1, clock=clock, data_dir=data_dir,
        engine_factory=lambda pid: CudaPartitionEngine(
            pid, 1, repository=repo, clock=clock, capacity=CAPACITY,
            device="cpu",
        ),
    )


JAX = types.SimpleNamespace(
    runtime=jax_runtime, gateway=jax_gateway, broker=_jax_broker,
    WI=JaxWI, WIRecord=JaxWIRecord,
    deploy=lambda client, model: client.deploy_model(model),
)
PORT = types.SimpleNamespace(
    runtime=port_runtime, gateway=port_gateway, broker=_port_broker,
    WI=PortWI, WIRecord=port_records.WorkflowInstanceRecord,
    deploy=lambda client, model: client.deploy_resources([
        port_records.DeploymentResource(
            resource=write_model(model), resource_name="process.bpmn")
    ]),
)


@pytest.fixture(autouse=True)
def _subscriber_keys_from_one(monkeypatch):
    """Each package numbers its job workers from a counter of the process:
    start both at 1, so the subscription tables compare whatever else ran
    in this process before."""
    for workers in (jax_workers, port_workers):
        monkeypatch.setattr(workers, "_subscriber_keys", itertools.count(1))


def _pay(ctx):
    return {"paid": True}


def _pay_but_hang_the_first_four(ctx):
    if ctx.job.payload["orderId"] < 4:
        ctx.finished = True  # a crashed worker: the job stays ACTIVATED
        return None
    return {"paid": True}


def open_broker(ns, data_dir, credits=16, handler=_pay):
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = ns.broker(clock, str(data_dir))
    ns.gateway.JobWorker(broker, "payment-service", handler, credits=credits)
    return broker


def xor_process():
    """Config 2 (``bench.build_graph_xor``): an exclusive gateway sends
    orderValue > 50 to one service task and the rest, by default, to the
    other."""
    from zeebe_tpu.models.bpmn.builder import Bpmn

    builder = Bpmn.create_process("xor-process").start_event("start").exclusive_gateway("split")
    builder.branch("$.orderValue > 50").service_task(
        "big", type="payment-service").end_event("end-big")
    builder.branch(default=True).service_task(
        "small", type="payment-service").end_event("end-small")
    return builder.done()


def burst(ns, broker, n, model=order_process,
          payload=lambda i: {"orderId": i}):
    """Deploy ``model`` (the order-process) and write ``n`` CREATE
    commands at once, then drain once."""
    process_id = model().processes[0].id
    ns.deploy(ns.gateway.ZeebeClient(broker), model())
    for i in range(n):
        broker.write_command(
            0, ns.WIRecord(bpmn_process_id=process_id, payload=payload(i)),
            ns.WI.CREATE,
        )
    broker.run_until_idle()


def finish(broker):
    """Tick and drain until a tick adds no record."""
    while True:
        before = broker.partitions[0].log.next_position
        broker.tick()
        broker.run_until_idle()
        if broker.partitions[0].log.next_position == before:
            return


def test_drought_burst_equals_the_jax_engine(tmp_path):
    brokers = []
    for ns in (JAX, PORT):
        broker = open_broker(ns, tmp_path / ns.runtime.__name__)
        burst(ns, broker, 64)
        finish(broker)
        brokers.append(broker)
    jax_sig, port_sig = (record_signature(b.records(0)) for b in brokers)
    for i, (a, b) in enumerate(zip(jax_sig, port_sig)):
        assert a == b, f"record {i} mismatch:\n  jax:  {a}\n  port: {b}"
    assert len(jax_sig) == len(port_sig)
    completed = [s for s in port_sig if s[2] == 5 and s[3] == 8
                 and s[8] == "order-process"]
    assert len(completed) == 64
    jax_snap, port_snap = (b.partitions[0].engine.snapshot_state() for b in brokers)
    assert jax_snap["meta"] == port_snap["meta"]
    assert sorted(jax_snap["arrays"]) == sorted(port_snap["arrays"])
    for name, a in jax_snap["arrays"].items():
        b = port_snap["arrays"][name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for b in brokers:
        b.close()


def test_config2_burst_equals_the_jax_engine(tmp_path):
    """Config 2 with orderValue alternating above and below 50 (and absent
    in every tenth instance: the condition-error incident) through both
    engines: equal logs and equal snapshot arrays."""
    assert bench.build_graph_xor()[0].has_conditions

    def payload(i):
        return {"orderId": i} if i % 10 == 9 else {"orderId": i, "orderValue": (99, 10)[i % 2]}

    brokers = []
    for ns in (JAX, PORT):
        broker = open_broker(ns, tmp_path / ns.runtime.__name__)
        burst(ns, broker, 40, model=xor_process, payload=payload)
        finish(broker)
        brokers.append(broker)
    jax_sig, port_sig = (record_signature(b.records(0)) for b in brokers)
    for i, (a, b) in enumerate(zip(jax_sig, port_sig)):
        assert a == b, f"record {i} mismatch:\n  jax:  {a}\n  port: {b}"
    assert len(jax_sig) == len(port_sig)
    completed = [s for s in port_sig if s[2] == 5 and s[3] == 9 and s[8] == "xor-process"]
    incidents = [s for s in port_sig if s[2] == 6 and s[1] == 0]  # INCIDENT events
    assert len(completed) == 36 and len(incidents) == 4
    engine = brokers[1].partitions[0].engine
    assert engine.host_only_reasons == {} and engine.device_records_processed > 0
    jax_snap, port_snap = (b.partitions[0].engine.snapshot_state() for b in brokers)
    assert jax_snap["meta"] == port_snap["meta"]
    for name, a in jax_snap["arrays"].items():
        b = port_snap["arrays"][name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for b in brokers:
        b.close()


@pytest.mark.parametrize("first,then", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_snapshot_into_port", "port_snapshot_into_jax"])
def test_live_device_timers_carry_across_engines(tmp_path, first, then):
    """Instances waiting on device timers are snapshotted by one engine and
    reopened by the other; the clock passes the due date and the timers
    fire there: the same log as reopening under the first engine."""
    src = tmp_path / "src"
    broker = open_broker(first, src)
    burst(first, broker, 24, model=timer_process)
    engine = broker.partitions[0].engine
    assert int((np.asarray(engine.state.timer_key) >= 0).sum()) == 24
    broker.snapshot()
    broker.close()
    logs = []
    for ns in (first, then):
        copy = tmp_path / f"copy-{len(logs)}"
        shutil.copytree(src, copy)
        reopened = open_broker(ns, copy)
        reopened.run_until_idle()
        reopened.partitions[0].engine.clock.advance(20_000)
        finish(reopened)
        logs.append(record_signature(reopened.records(0)))
        if ns is PORT:
            engine = reopened.partitions[0].engine
            assert engine.device_records_processed > 0 and not engine._host.timers
        reopened.close()
    own, crossed = logs
    assert crossed == own
    triggered = [s for s in own if s[2] == 14 and s[3] == 3]  # TimerIntent.TRIGGERED
    caught = [s for s in own if s[2] == 5 and s[3] == 9 and s[8] == "wait"]
    assert len(triggered) == 24 and len(caught) == 24


def _cancel_waiting_on_timers(ns, broker):
    client = ns.gateway.ZeebeClient(broker)
    ns.deploy(client, timer_process())
    first = client.create_instance("timed", payload={"n": 1})
    client.create_instance("timed", payload={"n": 2})
    broker.run_until_idle()
    client.cancel_instance(first.workflow_instance_key)
    broker.run_until_idle()


def test_cancel_of_an_instance_waiting_on_a_device_timer_equals_the_oracle(tmp_path):
    """The CANCEL demotes the instance with its device timer to the
    embedded host oracle, which cancels the timer; the other instance's
    timer still fires on the device."""
    logs = []
    for ns, make in ((JAX, lambda clock: jax_runtime.Broker(num_partitions=1, clock=clock)),
                     (PORT, lambda clock: _port_broker(clock, str(tmp_path / "port")))):
        clock = ns.runtime.ControlledClock(start_ms=1_000_000)
        broker = make(clock)
        ns.gateway.JobWorker(broker, "payment-service", _pay)
        _cancel_waiting_on_timers(ns, broker)
        if ns is PORT:
            engine = broker.partitions[0].engine
            # the demoted timer left the device and the oracle cancelled it;
            # the other instance's timer stays on the device
            assert not engine._host.timers
            assert int((engine.state.timer_key >= 0).sum()) == 1
        clock.advance(20_000)
        finish(broker)
        logs.append(record_signature(broker.records(0)))
        broker.close()
    oracle, port = logs
    for i, (a, b) in enumerate(zip(oracle, port)):
        assert a == b, f"record {i} mismatch:\n  oracle: {a}\n  port:   {b}"
    assert len(oracle) == len(port)
    canceled = [s for s in port if s[2] == 14 and s[3] == 5]  # TimerIntent.CANCELED
    assert len(canceled) == 1


def test_probe_and_device_backlog_equal_the_jax_engine(tmp_path):
    engines = []
    for ns in (JAX, PORT):
        broker = open_broker(ns, tmp_path / ns.runtime.__name__,
                             handler=_pay_but_hang_the_first_four)
        burst(ns, broker, 64)
        engines.append(broker.partitions[0].engine)
    jax_engine, port_engine = engines
    for advance in (0, 400_000):  # then past every job deadline
        jax_engine.clock.advance(advance)
        port_engine.clock.advance(advance)
        now = port_engine.clock()
        want = int(jax_engine_mod._due_probe_kernel(jax_engine.state, now))
        assert int(port_engine.deadlines_due_probe()) == want
        assert int(port_engine_mod._due_probe_kernel(port_engine.state, now)) == want
        assert want & port_engine_mod.PROBE_JOB_BACKLOG
    assert want & port_engine_mod.PROBE_DEADLINES
    jax_cmds, port_cmds = (
        record_signature(e.device_backlog_activations()) for e in engines
    )
    assert jax_cmds == port_cmds and len(port_cmds) > 0
    assert (np.asarray(jax_engine.state.sub_credits).tolist()
            == port_engine.state.sub_credits.tolist())


@pytest.mark.parametrize("first,then", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_snapshot_into_port", "port_snapshot_into_jax"])
def test_snapshot_restores_across_engines(tmp_path, first, then):
    src = tmp_path / "src"
    broker = open_broker(first, src)
    burst(first, broker, 48)
    broker.snapshot()
    broker.tick()  # a committed tail past the snapshot, replayed on reopen
    broker.run_until_idle()
    at_close = len(record_signature(broker.records(0)))
    broker.close()
    logs = []
    for ns in (first, then):
        copy = tmp_path / f"copy-{len(logs)}"
        shutil.copytree(src, copy)
        reopened = open_broker(ns, copy)
        finish(reopened)
        logs.append(record_signature(reopened.records(0)))
        if ns is PORT:
            assert reopened.partitions[0].engine.device_records_processed > 0
        reopened.close()
    own, crossed = logs
    assert crossed == own
    assert len(own) > at_close  # the run went on after the restore
    completed = [s for s in own if s[2] == 5 and s[3] == 8
                 and s[8] == "order-process"]
    assert len(completed) == 48


# -- the boot self-check ----------------------------------------------------


def test_selfcheck_is_a_noop_without_a_cuda_device(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setattr(ops, "_selfcheck_on", lambda device: 1 / 0)
    before = dict(ops.LAUNCHES)
    ops.selfcheck()
    assert ops.LAUNCHES == before and ops._SELFCHECKED == set()


def test_selfcheck_passes_with_the_plain_versions():
    ops._selfcheck_on("cpu")


def _broken_lookup(real):
    def lookup(table, keys, valid):
        found, vals = real(table, keys, valid)
        return found, torch.where(found, vals + 1, vals)
    return lookup


def _broken_insert(real):
    def insert(table, keys, vals, valid):
        new, ok = real(table, keys, vals, valid)
        return new, ok & (torch.arange(ok.shape[0]) % 2 == 0)
    return insert


def _broken_delete(real):
    def delete(table, keys, valid):
        return real(table, keys, valid & (torch.arange(keys.shape[0]) > 0))
    return delete


def _broken_scatter(real):
    def scatter(table, slots, active, vals):
        return real(table, slots, active, vals) + 1
    return scatter


BROKEN = [
    ("hashmap", "insert", _broken_insert, "insert ok"),
    ("hashmap", "lookup", _broken_lookup, "lookup slots"),
    ("hashmap", "delete", _broken_delete, "delete keyset"),
    ("ops", "_plain_set", _broken_scatter, "row update"),
    ("ops", "_plain_add", _broken_scatter, "lane accum"),
]


@pytest.mark.parametrize("module,name,breaker,check", BROKEN,
                         ids=[f"{m}.{n}" for m, n, _b, _c in BROKEN])
def test_selfcheck_refuses_to_serve_on_a_mismatch(monkeypatch, module, name,
                                                  breaker, check):
    target = ops.hashmap if module == "hashmap" else ops
    monkeypatch.setattr(target, name, breaker(getattr(target, name)))
    with pytest.raises(RuntimeError, match=re.escape(f"MISMATCH [{check}")):
        ops._selfcheck_on("cpu")


def test_engine_constructor_runs_the_selfcheck_only_on_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "selfcheck", lambda: calls.append(1))
    CudaPartitionEngine(0, 1, capacity=64, device="cpu")
    assert calls == []


def test_state_to_numpy_is_a_copy_on_the_cpu_too():
    """A snapshot of CPU tables must not follow later in-place steps (the
    tensors' own numpy views would)."""
    from zeebe_tpu_torch.tpu import state

    s = state.make_state(capacity=16, num_vars=2, device="cpu")
    arrays = state.state_to_numpy(s)
    s.ei_i32[0, 0] = 7
    s.ei_map.keys[0] = 7
    assert arrays["ei_i32"][0, 0] == 0 and arrays["ei_map.keys"][0] == -1
