"""Fixed-seed fuzz of the port's serving path against the JAX host oracle.

``tests/test_parity_fuzz.py``'s generator (``build_random_model``) builds
random workflows from every segment kind: service tasks, exclusive
gateways, parallel fork/join, timer catch events, message receive tasks,
embedded sub-processes, timer boundary events, collection and cardinality
multi-instance. Each case runs its scenario (instances with random
payloads, failing and exhausting workers, cancels, payload updates, a
message PUBLISHed for every receive task and instance, timer advances,
incident resolves) through the port's ``Broker`` with ``CudaPartitionEngine``
on the CPU and through the JAX package's ``Broker`` with its host oracle;
the two ``record_signature``s are equal (tolerance 0). The seeds count up
from the JAX fuzz's fixed base, 785858646, and draw exactly as its
``run_case`` does. A handful of cases run in tier-1 (among them the first
seeds whose workflows have a receive task, so messages are published);
the rest are ``slow``.
"""

import random
import types

import pytest

from test_parity_fuzz import (
    HOST_ONLY_KINDS,
    N_INSTANCES,
    SEGMENT_KINDS,
    build_random_model,
)
from test_torch_serving import port_broker
from test_tpu_parity import record_signature

import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.runtime as jax_runtime
from zeebe_tpu.models.bpmn.xml import write_model
from zeebe_tpu.protocol.enums import ValueType
from zeebe_tpu.protocol.intents import IncidentIntent

import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.protocol.records as port_records
import zeebe_tpu_torch.runtime as port_runtime

BASE = 785_858_646
TIER1_CASES = 4
SLOW_CASES = 36
# the first seeds from BASE whose workflows hold a receive task: their
# scenarios publish messages
RECEIVE_SEEDS = [BASE + 5, BASE + 8]


def _oracle_broker(clock):
    return jax_runtime.Broker(num_partitions=1, clock=clock)


ORACLE = types.SimpleNamespace(
    runtime=jax_runtime, JobWorker=jax_gateway.JobWorker,
    ZeebeClient=jax_gateway.ZeebeClient, broker=_oracle_broker,
    deploy=lambda client, model: client.deploy_model(model),
)
PORT = types.SimpleNamespace(
    runtime=port_runtime, JobWorker=port_gateway.JobWorker,
    ZeebeClient=port_gateway.ZeebeClient, broker=port_broker,
    deploy=lambda client, model: client.deploy_resources([
        port_records.DeploymentResource(
            resource=write_model(model), resource_name="process.bpmn")]),
)

INCIDENT, INCIDENT_CREATED = int(ValueType.INCIDENT), int(IncidentIntent.CREATED)


def draw_case(seed, kinds=SEGMENT_KINDS):
    """``tests/test_parity_fuzz.py``'s ``run_case`` draws, in its order."""
    rng = random.Random(seed)
    pid = f"fuzz{seed}"
    model, segments = build_random_model(rng, pid, kinds)
    n_instances = rng.randint(*N_INSTANCES)
    fail_mod = rng.choice([0, 3, 5])
    exhaust_mod = rng.choice([0, 0, 4])
    payloads = [
        {
            "orderValue": rng.choice([5, 25, 100, 400]),
            "orderId": i,
            "corr": f"c-{i}",
            "items": [1, 2][: rng.randint(1, 2)],
            "tag": rng.choice(["a", "bb", "ccc"]),
        }
        for i in range(n_instances)
    ]
    cancel_ids = {i for i in range(n_instances) if rng.random() < 0.2}
    update_ids = {i for i in range(n_instances) if rng.random() < 0.2}
    timer_advances = rng.randint(1, 3)
    needs_items = any(k in HOST_ONLY_KINDS for k in segments)
    list_payloads = needs_items or rng.random() < 0.15
    if not list_payloads:
        for p in payloads:
            p.pop("items")
    return types.SimpleNamespace(
        pid=pid, model=model, segments=segments, n_instances=n_instances,
        fail_mod=fail_mod, exhaust_mod=exhaust_mod, payloads=payloads,
        cancel_ids=cancel_ids, update_ids=update_ids,
        timer_advances=timer_advances, list_payloads=list_payloads,
        msg_names=[f"{pid}-msg{i}" for i, k in enumerate(segments) if k == "receive"],
    )


def run(ns, case):
    """The fuzz scenario on ``ns``'s broker; returns its log signature and
    its engine."""
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = ns.broker(clock)
    try:
        client = ns.ZeebeClient(broker)
        ns.deploy(client, case.model)

        def handler(ctx):
            oid = int(ctx.payload.get("orderId", 0))
            retries = int(ctx.job.retries)
            if case.exhaust_mod and oid % case.exhaust_mod == 1 and retries > 0:
                ctx.fail(retries=0)
                return None
            if case.fail_mod and oid % case.fail_mod == 0 and retries > 1:
                ctx.fail(retries=retries - 1)
                return None
            return {"res": oid * 2}

        for k in (0, 1):
            ns.JobWorker(broker, f"{case.pid}-svc{k}", handler)
        created = []
        for i, payload in enumerate(case.payloads):
            inst = client.create_instance(case.pid, dict(payload))
            created.append(inst.workflow_instance_key)
            if i in case.update_ids:
                broker.run_until_idle()
                try:
                    client.update_payload(created[-1], {**payload, "updated": True})
                except Exception:  # noqa: BLE001 - the rejection is compared
                    pass
            if i in case.cancel_ids:
                broker.run_until_idle()
                try:
                    client.cancel_instance(created[-1])
                except Exception:  # noqa: BLE001 - the rejection is compared
                    pass
        broker.run_until_idle()
        for name in case.msg_names:
            for i in range(case.n_instances):
                client.publish_message(name, f"c-{i}", {"paid": i})
        broker.run_until_idle()
        for _ in range(case.timer_advances):
            clock.advance(31_000)
            broker.tick()
            broker.run_until_idle()
        incidents = [
            r for r in broker.records(0)
            if int(r.metadata.value_type) == INCIDENT
            and int(r.metadata.intent) == INCIDENT_CREATED
        ]
        for inc in incidents:
            try:
                client.resolve_incident(inc.key, {
                    "orderId": 999, "orderValue": 100, "corr": "c-0",
                    **({"items": [1]} if case.list_payloads else {})})
            except Exception:  # noqa: BLE001 - the rejection is compared
                pass
        broker.run_until_idle()
        for _ in range(2):
            clock.advance(31_000)
            broker.tick()
            broker.run_until_idle()
        return record_signature(broker.records(0)), broker.partitions[0].engine
    finally:
        broker.close()


def check_case(seed):
    case = draw_case(seed)
    oracle, _ = run(ORACLE, case)
    port, engine = run(PORT, case)
    assert oracle, f"seed {seed}: no records"
    for i, (a, b) in enumerate(zip(oracle, port)):
        assert a == b, (f"seed {seed} ({case.segments}): signature record {i}:"
                        f"\n  oracle: {a}\n  port:   {b}")
    assert len(oracle) == len(port), (seed, len(oracle), len(port))
    if not set(case.segments) & HOST_ONLY_KINDS and not case.list_payloads:
        assert engine.device_records_processed > 0, (seed, case.segments)
    return case


def test_receive_seeds_hold_receive_tasks():
    for seed in RECEIVE_SEEDS:
        assert "receive" in draw_case(seed).segments, seed
    for seed in range(BASE, min(RECEIVE_SEEDS)):
        assert "receive" not in draw_case(seed).segments, seed


@pytest.mark.parametrize("seed", [BASE + k for k in range(TIER1_CASES)] + RECEIVE_SEEDS)
def test_fuzz_parity_with_the_oracle(seed):
    check_case(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [
    s for s in range(BASE + TIER1_CASES, BASE + TIER1_CASES + SLOW_CASES)
    if s not in RECEIVE_SEEDS])
def test_fuzz_parity_with_the_oracle_slow(seed):
    check_case(seed)
