"""The port's serving path against the JAX package's host oracle.

The port's own in-process ``Broker`` with ``CudaPartitionEngine`` (on the
CPU here: every kernel wrapper takes its plain PyTorch version) writes the
same event log as the JAX package's ``Broker`` with the host oracle engine,
scenario by scenario. The scenarios and models are those of
``tests/test_tpu_parity.py``; each model is written to BPMN XML by the JAX
package and deployed as that resource on both sides, so both brokers deploy
the same document. Tolerance 0: every signature field is an integer,
string or exact payload.
"""

import types

import pytest

import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.runtime as jax_runtime
from zeebe_tpu.models.bpmn.builder import Bpmn
from zeebe_tpu.models.bpmn.xml import write_model
from test_tpu_parity import (
    boundary_message_process,
    boundary_timer_process,
    catch_event_process,
    dual_boundary_process,
    fork_join_process,
    gateway_process,
    mi_cardinality_process,
    order_process,
    receive_task_process,
    record_signature,
)

import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.protocol.records as port_records
import zeebe_tpu_torch.runtime as port_runtime
from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
from zeebe_tpu_torch.gateway.client import ClientException as PortClientException
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine
from zeebe_tpu.gateway.client import ClientException as JaxClientException


def port_deploy(client, model):
    return client.deploy_resources([port_records.DeploymentResource(
        resource=write_model(model), resource_name="process.bpmn",
    )])


ORACLE = types.SimpleNamespace(
    runtime=jax_runtime, JobWorker=jax_gateway.JobWorker,
    ClientException=JaxClientException, ZeebeClient=jax_gateway.ZeebeClient,
    deploy=lambda client, model: client.deploy_model(model),
)
PORT = types.SimpleNamespace(
    runtime=port_runtime, JobWorker=port_gateway.JobWorker,
    ClientException=PortClientException, ZeebeClient=port_gateway.ZeebeClient,
    deploy=port_deploy,
)


def port_engines(clock, partitions=1, **kwargs):
    """The port's engine factory for one broker: ``CudaPartitionEngine`` on
    the CPU, every partition sharing one workflow repository."""
    repo = WorkflowRepository()
    return lambda pid: CudaPartitionEngine(
        pid, partitions, repository=repo, clock=clock, device="cpu", **kwargs
    )


def jax_engines(clock, partitions=1):
    """The JAX package's device-engine factory for one broker."""
    from zeebe_tpu.engine.interpreter import WorkflowRepository as JaxRepository
    from zeebe_tpu.tpu import TpuPartitionEngine

    repo = JaxRepository()
    return lambda pid: TpuPartitionEngine(pid, partitions, repository=repo, clock=clock)


def port_broker(clock, data_dir=None, capacity=1 << 12, partitions=1):
    return port_runtime.Broker(
        num_partitions=partitions, clock=clock, data_dir=data_dir,
        engine_factory=port_engines(clock, partitions, capacity=capacity),
    )


def run_scenario(ns, scenario, make_broker=None):
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = (make_broker or (lambda c: ns.runtime.Broker(
        num_partitions=1, clock=c)))(clock)
    try:
        scenario(ns, broker, ns.ZeebeClient(broker), clock)
        broker.run_until_idle()
        return broker, record_signature(broker.records(0))
    finally:
        broker.close()


# -- the scenarios of TestServiceTaskParity and TestParallelGatewayParity --


def happy_path(ns, broker, client, clock):
    ns.deploy(client, order_process())
    ns.JobWorker(broker, "payment-service", lambda ctx: {"paid": True})
    client.create_instance(
        "order-process", payload={"orderId": 31243, "orderValue": 99}
    )


def multiple_instances(ns, broker, client, clock):
    ns.deploy(client, order_process())
    ns.JobWorker(broker, "payment-service", lambda ctx: {"paid": True}, credits=64)
    for i in range(10):
        client.create_instance("order-process", payload={"orderId": i})


def job_fail_and_retry(ns, broker, client, clock):
    ns.deploy(client, order_process())
    attempts = []

    def handler(ctx):
        attempts.append(1)
        if len(attempts) == 1:
            ctx.fail(retries=ctx.job.retries - 1)
            return None
        return {"paid": True}

    ns.JobWorker(broker, "payment-service", handler)
    client.create_instance("order-process", payload={"orderId": 1})


def job_no_retries_incident(ns, broker, client, clock):
    ns.deploy(client, order_process())

    def handler(ctx):
        ctx.fail(retries=0)

    ns.JobWorker(broker, "payment-service", handler)
    client.create_instance("order-process", payload={"orderId": 1})


def job_timeout_reactivation(ns, broker, client, clock):
    ns.deploy(client, order_process())
    seen = []

    def handler(ctx):
        seen.append(ctx.key)
        if len(seen) == 1:
            ctx.finished = True  # crashed worker: never completes
            return None
        return {"paid": True}

    ns.JobWorker(broker, "payment-service", handler, timeout_ms=5_000)
    client.create_instance("order-process", payload={"orderId": 1})
    broker.run_until_idle()
    clock.advance(10_000)
    broker.tick()


def complete_unknown_job_rejected(ns, broker, client, clock):
    ns.deploy(client, order_process())
    try:
        client.complete_job(999999)
    except ns.ClientException:
        pass


def create_unknown_workflow_rejected(ns, broker, client, clock):
    ns.deploy(client, order_process())
    try:
        client.create_instance("no-such-process")
    except ns.ClientException:
        pass


def fork_join(ns, broker, client, clock):
    ns.deploy(client, fork_join_process())
    ns.JobWorker(broker, "svc-a", lambda ctx: {"a": 1})
    ns.JobWorker(broker, "svc-b", lambda ctx: {"b": 2})
    client.create_instance("fork-join", payload={"seed": 7})


def fork_join_many(ns, broker, client, clock):
    ns.deploy(client, fork_join_process())
    ns.JobWorker(broker, "svc-a", lambda ctx: {"a": 1}, credits=64)
    ns.JobWorker(broker, "svc-b", lambda ctx: {"b": 2}, credits=64)
    for i in range(5):
        client.create_instance("fork-join", payload={"seed": i})


def _hang(ctx):
    ctx.finished = True  # the job stays ACTIVATED: the instance stays live
    return None


def cancel_and_update_live_instances(ns, broker, client, clock):
    """CANCEL and UPDATE_PAYLOAD demote a live device instance (its scope
    tree, its job, its in-flight join) to the embedded host oracle."""
    ns.deploy(client, order_process())
    ns.deploy(client, fork_join_process())
    ns.JobWorker(broker, "payment-service", _hang)
    ns.JobWorker(broker, "svc-a", lambda ctx: {"a": 1})
    ns.JobWorker(broker, "svc-b", _hang)
    first = client.create_instance("order-process", payload={"orderId": 1})
    second = client.create_instance("order-process", payload={"orderId": 2})
    joined = client.create_instance("fork-join", payload={"seed": 3})
    broker.run_until_idle()
    client.cancel_instance(first.workflow_instance_key)
    client.update_payload(second.workflow_instance_key, {"orderId": 22})
    client.cancel_instance(joined.workflow_instance_key)


# -- TestExclusiveGatewayParity, TestTimerParity, TestMappingParity -------


def _decision(ns, broker, client, payload):
    ns.deploy(client, gateway_process())
    ns.JobWorker(broker, "priority-service", lambda ctx: None)
    ns.JobWorker(broker, "normal-service", lambda ctx: None)
    client.create_instance("decision", payload=payload)


def condition_routes_high(ns, broker, client, clock):
    _decision(ns, broker, client, {"orderValue": 250})


def condition_routes_default(ns, broker, client, clock):
    _decision(ns, broker, client, {"orderValue": 42})


def condition_error_incident(ns, broker, client, clock):
    ns.deploy(client, gateway_process())
    client.create_instance("decision", payload={"unrelated": 1})


def string_and_mixed_conditions(ns, broker, client, clock):
    b = Bpmn.create_process("strings").start_event("start").exclusive_gateway("split")
    b.branch('$.kind == "express" && $.weight < 10').service_task(
        "a", type="svc-a"
    ).end_event("end-a")
    b.branch(default=True).service_task("b", type="svc-b").end_event("end-b")
    ns.deploy(client, b.done())
    ns.JobWorker(broker, "svc-a", lambda ctx: None)
    ns.JobWorker(broker, "svc-b", lambda ctx: None)
    client.create_instance("strings", payload={"kind": "express", "weight": 5})
    client.create_instance("strings", payload={"kind": "bulk", "weight": 5})


def timer_catch_event(ns, broker, client, clock):
    model = (
        Bpmn.create_process("timed")
        .start_event("start")
        .timer_catch_event("wait", duration_ms=60_000)
        .end_event("end")
        .done()
    )
    ns.deploy(client, model)
    client.create_instance("timed", payload={"x": 1})
    broker.run_until_idle()
    clock.advance(120_000)
    broker.tick()


def io_mappings(ns, broker, client, clock):
    model = (
        Bpmn.create_process("mapped")
        .start_event("start")
        .service_task("work", type="svc", inputs=[("$.total", "$.amount")],
                      outputs=[("$.result", "$.outcome")])
        .end_event("end")
        .done()
    )
    ns.deploy(client, model)
    ns.JobWorker(broker, "svc", lambda ctx: {"result": 41})
    client.create_instance("mapped", payload={"total": 99, "noise": 1})


def input_mapping_error_incident(ns, broker, client, clock):
    model = (
        Bpmn.create_process("mapped-err")
        .start_event("start")
        .service_task("work", type="svc", inputs=[("$.missing", "$.amount")])
        .end_event("end")
        .done()
    )
    ns.deploy(client, model)
    client.create_instance("mapped-err", payload={"total": 99})


# -- TestMessageCorrelationParity: the message store on the device --------


def message_open_then_publish(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.create_instance("msgflow", {"oid": "o-7"})
    broker.run_until_idle()
    client.publish_message("paid", "o-7", {"paid": True})


def message_publish_before_open_with_ttl(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.publish_message("paid", "o-1", {"amount": 5}, time_to_live_ms=60_000)
    broker.run_until_idle()
    client.create_instance("msgflow", {"oid": "o-1"})


def message_publish_without_ttl_does_not_store(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.publish_message("paid", "o-2", {"x": 1})  # no subscriber
    broker.run_until_idle()
    client.create_instance("msgflow", {"oid": "o-2"})
    broker.run_until_idle()
    client.publish_message("paid", "o-2", {"x": 2})  # now it correlates


def message_ttl_expiry_deletes_stored_message(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.publish_message("paid", "late", {"v": 1}, time_to_live_ms=5_000)
    broker.run_until_idle()
    clock.advance(6_000)
    broker.tick()
    broker.run_until_idle()
    client.create_instance("msgflow", {"oid": "late"})  # waits: expired


def message_catch_event_with_downstream_task(ns, broker, client, clock):
    ns.deploy(client, catch_event_process())
    ns.JobWorker(broker, "post-service", lambda ctx: {"done": 1})
    client.create_instance("catchflow", {"key": "k-1"})
    broker.run_until_idle()
    client.publish_message("go", "k-1", {"approved": True})


def message_numeric_correlation_key(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.create_instance("msgflow", {"oid": 42})
    broker.run_until_idle()
    client.publish_message("paid", "42", {"ok": True})


def message_string_correlation_keys(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.create_instance("msgflow", {"oid": "a"})
    client.create_instance("msgflow", {"oid": "b"})
    broker.run_until_idle()
    client.publish_message("paid", "b", {"who": "b"})
    broker.run_until_idle()
    client.publish_message("paid", "a", {"who": "a"})


def message_duplicate_id_rejected(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.publish_message("paid", "dup", {"n": 1}, time_to_live_ms=60_000,
                           message_id="m-1")
    broker.run_until_idle()
    try:
        client.publish_message("paid", "dup", {"n": 2}, time_to_live_ms=60_000,
                               message_id="m-1")
    except ns.ClientException:
        pass


def message_cancel_closes_subscription(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    inst = client.create_instance("msgflow", {"oid": "c-1"})
    broker.run_until_idle()
    client.cancel_instance(inst.workflow_instance_key)
    broker.run_until_idle()
    client.publish_message("paid", "c-1", {"late": 1}, time_to_live_ms=9_000)


def message_correlation_key_missing_incident(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.create_instance("msgflow", {"other": 1})


def message_float_correlation_key_incident(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.create_instance("msgflow", {"oid": 1.5})


def message_bool_correlation_key_subscribes(ns, broker, client, clock):
    ns.deploy(client, receive_task_process())
    client.create_instance("msgflow", {"oid": True})
    broker.run_until_idle()
    client.publish_message("paid", "True", {"ok": 1})


# -- TestBoundaryEventParity, TestDualBoundaryParity and the host engine's
# boundary tests (tests/test_boundary_multi_instance.py) ------------------


def _timer_boundary(ns, broker, client, clock, interrupting, worker):
    ns.deploy(client, boundary_timer_process(interrupting=interrupting))
    ns.JobWorker(broker, "esc-service", lambda ctx: {})
    if worker:
        ns.JobWorker(broker, "slow-service", lambda ctx: {"done": True})
    client.create_instance("bdflow", {"orderId": 1})
    broker.run_until_idle()
    clock.advance(31_000)
    broker.tick()
    broker.run_until_idle()


def boundary_interrupting_timer_fires(ns, broker, client, clock):
    # no slow-service worker: the job stays out, the timer wins and the
    # host's job is canceled
    _timer_boundary(ns, broker, client, clock, True, False)


def boundary_interrupting_timer_beaten_by_completion(ns, broker, client, clock):
    _timer_boundary(ns, broker, client, clock, True, True)


def boundary_non_interrupting_timer_host_continues(ns, broker, client, clock):
    _timer_boundary(ns, broker, client, clock, False, False)
    # the host task is still live: completing it now ends the instance
    ns.JobWorker(broker, "slow-service", lambda ctx: {"late": True})


def boundary_interrupting_message(ns, broker, client, clock):
    ns.deploy(client, boundary_message_process())
    client.create_instance("bdmsg", {"wid": "w-1"})
    broker.run_until_idle()
    client.publish_message("halt", "w-1", {"reason": "stop"})


def boundary_message_disarms_on_completion(ns, broker, client, clock):
    ns.deploy(client, boundary_message_process())
    ns.JobWorker(broker, "work-service", lambda ctx: {"ok": 1})
    client.create_instance("bdmsg", {"wid": "w-2"})
    broker.run_until_idle()
    client.publish_message("halt", "w-2", {"late": 1}, time_to_live_ms=5_000)


def boundary_non_interrupting_message_fires_twice(ns, broker, client, clock):
    ns.deploy(client, boundary_message_process(interrupting=False))
    client.create_instance("bdmsg", {"wid": "o-1"})
    broker.run_until_idle()
    client.publish_message("halt", "o-1", {"n": 1})
    broker.run_until_idle()
    client.publish_message("halt", "o-1", {"n": 2})


def boundary_receive_task_with_timer_config4(ns, broker, client, clock):
    """BASELINE config 4: half the instances correlate, half expire."""
    ns.deploy(client, (
        Bpmn.create_process("c4").start_event("start")
        .receive_task("wait-pay", message_name="paid", correlation_key="$.oid")
        .boundary_event("deadline", duration_ms=30_000)
        .end_event("expired").move_to("wait-pay").end_event("done").done()
    ))
    for i in range(6):
        client.create_instance("c4", {"oid": f"o-{i}"})
    broker.run_until_idle()
    for i in range(0, 6, 2):
        client.publish_message("paid", f"o-{i}", {"paid": True})
    broker.run_until_idle()
    clock.advance(31_000)
    broker.tick()


def _dual(ns, broker, client, cid):
    ns.deploy(client, dual_boundary_process())
    client.create_instance("dual", {"cid": cid})
    broker.run_until_idle()


def boundary_dual_message_fires_while_timer_armed(ns, broker, client, clock):
    _dual(ns, broker, client, "c-1")
    client.publish_message("abort", "c-1", {"why": "stop"})


def boundary_dual_timer_fires_while_message_armed(ns, broker, client, clock):
    _dual(ns, broker, client, "c-2")
    clock.advance(61_000)
    broker.tick()


def boundary_dual_main_message_disarms_both(ns, broker, client, clock):
    _dual(ns, broker, client, "c-3")
    client.publish_message("main", "c-3", {"ok": 1})
    broker.run_until_idle()
    clock.advance(61_000)
    broker.tick()


# -- TestMultiInstanceParity ------------------------------------------------


def mi_cardinality_fanout(ns, broker, client, clock):
    ns.deploy(client, mi_cardinality_process(3))
    ns.JobWorker(broker, "mi-service", lambda ctx: {"seen": ctx.job.payload.get("loopCounter")},
                 credits=16)
    client.create_instance("miflow", {"batch": 7})


def mi_two_instances_interleaved(ns, broker, client, clock):
    ns.deploy(client, mi_cardinality_process(2))
    ns.JobWorker(broker, "mi-service", lambda ctx: {}, credits=16)
    client.create_instance("miflow", {"a": 1})
    client.create_instance("miflow", {"a": 2})


SCENARIOS = [
    happy_path, multiple_instances, job_fail_and_retry,
    job_no_retries_incident, job_timeout_reactivation,
    complete_unknown_job_rejected, create_unknown_workflow_rejected,
    fork_join, fork_join_many, cancel_and_update_live_instances,
    condition_routes_high, condition_routes_default, condition_error_incident,
    string_and_mixed_conditions, timer_catch_event, io_mappings,
    input_mapping_error_incident,
    message_open_then_publish, message_publish_before_open_with_ttl,
    message_publish_without_ttl_does_not_store,
    message_ttl_expiry_deletes_stored_message,
    message_catch_event_with_downstream_task, message_numeric_correlation_key,
    message_string_correlation_keys, message_duplicate_id_rejected,
    message_cancel_closes_subscription, message_correlation_key_missing_incident,
    message_float_correlation_key_incident, message_bool_correlation_key_subscribes,
    boundary_interrupting_timer_fires, boundary_interrupting_timer_beaten_by_completion,
    boundary_non_interrupting_timer_host_continues, boundary_interrupting_message,
    boundary_message_disarms_on_completion,
    boundary_non_interrupting_message_fires_twice,
    boundary_receive_task_with_timer_config4,
    boundary_dual_message_fires_while_timer_armed,
    boundary_dual_timer_fires_while_message_armed,
    boundary_dual_main_message_disarms_both,
    mi_cardinality_fanout, mi_two_instances_interleaved,
]
# scenarios whose CANCEL demotes a live instance to the embedded oracle
DEMOTING = ("cancel_and_update_live_instances", "message_cancel_closes_subscription")


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_port_broker_writes_the_oracles_log(scenario):
    _b, oracle = run_scenario(ORACLE, scenario)
    broker, port = run_scenario(PORT, scenario, port_broker)
    for i, (a, b) in enumerate(zip(oracle, port)):
        assert a == b, f"record {i} mismatch:\n  oracle: {a}\n  port:   {b}"
    assert len(oracle) == len(port)
    engine = broker.partitions[0].engine
    # the workflows were device-served: instance records went through the
    # step kernel, and none but the demoted ones moved to the oracle
    assert engine.host_only_reasons == {}
    assert engine.device_records_processed > 0
    # a message workflow's store is on the device
    assert engine._messages_on_device == engine.graph.has_messages
    demoted = engine._host.element_instances.instances
    if scenario is cancel_and_update_live_instances:
        assert demoted  # the updated instance lives on in the oracle
    elif scenario.__name__ not in DEMOTING:
        assert not demoted


# -- host-routed workflows --------------------------------------------------


def timer_process():
    return (
        Bpmn.create_process("timed")
        .start_event("start")
        .timer_catch_event("wait", duration_ms=10_000)
        .service_task("after", type="after-service")
        .end_event("end")
        .done()
    )


def message_process():
    return (
        Bpmn.create_process("msg")
        .start_event("start")
        .message_catch_event("wait", message_name="go", correlation_key="$.key")
        .end_event("end")
        .done()
    )


def collection_mi_process():
    """A collection-driven multi-instance sub-process: no device column
    form, so ``graph.check_device_compatible`` refuses it."""
    builder = Bpmn.create_process("coll")
    sub = builder.start_event("s").sub_process(
        "each", multi_instance={"input_collection": "$.items", "input_element": "item"}
    )
    sub.start_event("ss").service_task("w", type="c-svc").end_event("se")
    return sub.embedded_done().end_event("e").done()


def host_routed(ns, broker, client, clock):
    ns.deploy(client, order_process())
    ns.deploy(client, message_process())
    ns.deploy(client, collection_mi_process())
    ns.JobWorker(broker, "payment-service", lambda ctx: {"done": True})
    ns.JobWorker(broker, "c-svc", lambda ctx: {"seen": ctx.job.payload["item"]})
    client.create_instance("order-process", payload={"orderId": 1})
    client.create_instance("msg", payload={"key": "k-1"})
    client.create_instance("coll", payload={"items": ["x", "y"]})
    broker.run_until_idle()
    client.publish_message("go", correlation_key="k-1")


def test_unported_gates_route_their_workflows_to_the_host_oracle():
    """What the device cannot execute (here a collection-driven
    multi-instance sub-process) runs on the embedded host oracle, named in
    ``host_only_reasons``; beside it, the message store stays host-side
    (a mixed deployment), so the publish still sees the device-served
    workflow's subscription."""
    _b, oracle = run_scenario(ORACLE, host_routed)
    broker, port = run_scenario(PORT, host_routed, port_broker)
    assert port == oracle
    engine = broker.partitions[0].engine
    reasons = {
        wf.id: engine.host_only_reasons.get(key)
        for key, wf in engine.repository.by_key.items()
    }
    assert reasons["order-process"] is None and reasons["msg"] is None
    assert reasons["coll"].startswith("collection-driven multi-instance (each)")
    assert not engine._messages_on_device
    completed = [
        s for s in port
        if s[2] == 5 and s[3] == 9 and s[8] in ("order-process", "msg", "coll")
    ]
    assert len(completed) == 3  # every process element completed
    assert engine.device_records_processed > 0
    assert engine.host_records_processed > 0


# -- durability: close, reopen on the same data_dir -------------------------


def test_port_broker_recovers_its_state_with_no_new_records(tmp_path):
    clock = port_runtime.ControlledClock(start_ms=1_000_000)
    broker = port_broker(clock, data_dir=str(tmp_path))
    client = port_gateway.ZeebeClient(broker)
    port_deploy(client, order_process())
    port_gateway.JobWorker(broker, "payment-service", lambda ctx: {"paid": True})
    client.create_instance("order-process", payload={"orderId": 1})
    broker.run_until_idle()
    broker.snapshot()
    # a second instance whose job is still open lives past the snapshot
    client.create_instance("order-process", payload={"orderId": 2})
    broker.run_until_idle()
    before = record_signature(broker.records(0))
    broker.close()

    reopened = port_broker(clock, data_dir=str(tmp_path))
    try:
        reopened.run_until_idle()
        assert record_signature(reopened.records(0)) == before
        engine = reopened.partitions[0].engine
        assert engine.device_records_processed > 0  # replay went through the kernel
    finally:
        reopened.close()
