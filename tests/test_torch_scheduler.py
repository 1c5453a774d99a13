"""The shared-wave scheduler over the port's device engine.

After ``tools/scheduler_smoke.py`` and ``tests/test_scheduler.py``: four
partitions of the port's in-process ``Broker``, each served by
``CudaPartitionEngine`` on the CPU, drain a skewed load (four bursts of
``[0]*12 + [1]*3 + [2]*2 + [3]``, waves of 256) once through the shared
wave scheduler and once per partition. Every partition's log is
bit-identical between the two drains and equal to the JAX package's host
run of the same commands (``record_signature``), and the shared drain's mean wave fill is at
least twice the baseline's. Under overload (one command in flight per
connection) a ``ClusterBroker`` served by the port's engine sheds
retryably: the shed counter fires and every command completes.

The port's instance and job keys carry their partition in bits 51 and up
(ROADMAP Queue 3); the JAX package's do not. So partition 0's
log signature equals the JAX run's, and the other partitions' equal it
once the partition bits are masked off the keys. As in the JAX package,
only the partition that processed the DEPLOYMENT steps the workflow on its
device; the others run it on their engine's host oracle (ROADMAP Queue 3).
"""

import itertools
import threading
import types

from test_torch_serving import jax_engines, port_engines
from test_tpu_parity import record_signature

import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu.models.bpmn.builder as jax_builder
import zeebe_tpu.protocol.codec as jax_codec
import zeebe_tpu.protocol.intents as jax_intents
import zeebe_tpu.protocol.records as jax_records
import zeebe_tpu.runtime as jax_runtime
import zeebe_tpu.runtime.metrics as jax_metrics

import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.gateway.workers as port_workers
import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.protocol.codec as port_codec
import zeebe_tpu_torch.protocol.intents as port_intents
import zeebe_tpu_torch.protocol.records as port_records
import zeebe_tpu_torch.runtime as port_runtime
import zeebe_tpu_torch.runtime.metrics as port_metrics
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

PARTITIONS = 4
# tools/scheduler_smoke.py's mix: a heavy head partition, a sparse tail
MIX = [0] * 12 + [1] * 3 + [2] * 2 + [3] * 1
BURSTS = 4
KEY_FIELDS = (4, 10, 11, 16)  # record_signature's key, scope, instance, activity keys
PARTITION_BITS = 51


PORT = types.SimpleNamespace(
    runtime=port_runtime, gateway=port_gateway, workers=port_workers,
    Bpmn=port_builder.Bpmn, codec=port_codec, intents=port_intents,
    records=port_records, metrics=port_metrics, engines=port_engines,
)
JAX = types.SimpleNamespace(
    runtime=jax_runtime, gateway=jax_gateway, workers=jax_workers,
    Bpmn=jax_builder.Bpmn, codec=jax_codec, intents=jax_intents,
    records=jax_records, metrics=jax_metrics, engines=lambda clock, n: None,
)


def skewed_run(ns, data_dir, use_scheduler):
    """The smoke's skewed drain on ``ns``'s broker; returns each
    partition's records and frames, and the mean wave fill."""
    ns.workers._subscriber_keys = itertools.count(1)
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = ns.runtime.Broker(num_partitions=PARTITIONS, data_dir=data_dir,
                               clock=clock, engine_factory=ns.engines(clock, PARTITIONS))
    broker.use_scheduler = use_scheduler
    broker.wave_size = 256
    waves = ns.metrics.GLOBAL_REGISTRY.counter("serving_waves_total")
    recs = ns.metrics.GLOBAL_REGISTRY.counter("serving_wave_records_total")
    w0, r0 = waves.value, recs.value
    try:
        client = ns.gateway.ZeebeClient(broker)
        client.deploy_model(
            ns.Bpmn.create_process("smoke-flow").start_event("s")
            .service_task("work", type="smoke-service").end_event("e").done())
        ns.gateway.JobWorker(broker, "smoke-service", lambda ctx: {"ok": True})
        for burst in range(BURSTS):
            for i, pid in enumerate(MIX):
                broker.write_command(pid, ns.records.WorkflowInstanceRecord(
                    bpmn_process_id="smoke-flow", payload={"b": burst, "i": i},
                ), ns.intents.WorkflowInstanceIntent.CREATE)
            broker.run_until_idle()
        logs = [broker.records(pid) for pid in range(PARTITIONS)]
        frames = [[ns.codec.encode_record(r) for r in log] for log in logs]
        fill = (recs.value - r0) / max(waves.value - w0, 1)
        if ns is PORT:
            assert broker.partitions[0].engine.device_records_processed > 0
        return logs, frames, fill
    finally:
        broker.close()


def _without_partition_bits(signature):
    mask = (1 << PARTITION_BITS) - 1
    return [
        tuple(v & mask if i in KEY_FIELDS and isinstance(v, int) and v > 0 else v
              for i, v in enumerate(rec))
        for rec in signature
    ]


def test_shared_waves_bit_identical_to_baseline_and_to_jax_and_fill_twice(tmp_path):
    logs, shared, fill_shared = skewed_run(PORT, str(tmp_path / "s"), True)
    _, base, fill_base = skewed_run(PORT, str(tmp_path / "b"), False)
    assert sum(len(f) for f in shared) > 300
    for pid, (a, b) in enumerate(zip(shared, base)):
        assert a == b, f"partition {pid} log diverged under scheduling"
    assert fill_shared >= 2 * fill_base, (fill_shared, fill_base)

    jax_logs, _, jax_fill = skewed_run(JAX, str(tmp_path / "j"), True)
    assert fill_shared == jax_fill
    assert record_signature(logs[0]) == record_signature(jax_logs[0])
    for pid in range(1, PARTITIONS):
        instance_keys = {r.key >> PARTITION_BITS for r in logs[pid]
                         if r.key > 0 and getattr(r.value, "workflow_instance_key", -1) == r.key}
        assert instance_keys == {pid}, (pid, instance_keys)
        assert _without_partition_bits(record_signature(logs[pid])) == (
            record_signature(jax_logs[pid])), pid


def test_overload_sheds_retryably_on_the_device_engine(tmp_path):
    """``tools/scheduler_smoke.py``'s overload leg on a ``ClusterBroker``
    whose partition is served by ``CudaPartitionEngine`` on the CPU."""
    from test_cluster import wait_until

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.config import BrokerCfg
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config

    cfg = BrokerCfg()
    cfg.network.client_port = 0
    cfg.network.management_port = 0
    cfg.network.subscription_port = 0
    cfg.metrics.port = 0
    cfg.metrics.enabled = False
    cfg.engine.type = "cuda"
    cfg.admission.max_inflight_per_connection = 1
    cfg.admission.retry_after_ms = 5
    broker = ClusterBroker(cfg, str(tmp_path / "b0"),
                           engine_factory=engine_factory_from_config(cfg, device="cpu"))
    client = None
    try:
        broker.open_partition(0).join(60)
        broker.bootstrap_partition(0, {})
        assert wait_until(lambda: broker.partitions[0].is_leader, 60)
        assert isinstance(broker.partitions[0].engine, CudaPartitionEngine)
        client = ClusterClient([broker.client_address], num_partitions=1,
                               request_timeout_ms=60_000)
        client.deploy_model(
            port_builder.Bpmn.create_process("ovl").start_event("s")
            .end_event("e").done())
        shed = port_metrics.GLOBAL_REGISTRY.counter(
            "gateway_commands_shed", reason="CONNECTION_INFLIGHT")
        s0 = shed.value
        keys, errors = [], []
        lock = threading.Lock()

        def pump():
            try:
                rsp = client.create_instance("ovl")
                with lock:
                    keys.append(rsp.value.workflow_instance_key)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=pump, daemon=True) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors[:2]
        assert len(set(keys)) == 8, keys
        assert shed.value > s0, "the overload never shed"
        assert broker.partitions[0].engine.device_records_processed > 0
    finally:
        if client is not None:
            client.close()
        broker.close()


def test_a_workflow_deployed_on_another_partition_runs_on_the_host_oracle(tmp_path):
    """A workflow deployed on partition 0 lands in the repository the
    broker's partitions share; partition 1's engine never processes the
    DEPLOYMENT record, so it never compiles the workflow. The JAX device
    engine then runs every record of partition 1 on its host oracle, and
    the port's engine does the same (a fault of the JAX package that the
    port follows, ROADMAP Queue 3). Both write the same log."""
    runs = {}
    for ns in (PORT, types.SimpleNamespace(**{**vars(JAX), "engines": jax_engines})):
        ns.workers._subscriber_keys = itertools.count(1)
        clock = ns.runtime.ControlledClock(start_ms=1_000_000)
        broker = ns.runtime.Broker(num_partitions=2, data_dir=str(tmp_path / str(len(runs))),
                                   clock=clock, engine_factory=ns.engines(clock, 2))
        try:
            client = ns.gateway.ZeebeClient(broker)
            client.deploy_model(
                ns.Bpmn.create_process("p").start_event("s")
                .service_task("work", type="svc").end_event("e").done())
            ns.gateway.JobWorker(broker, "svc", lambda ctx: {"ok": True})
            broker.write_command(1, ns.records.WorkflowInstanceRecord(
                bpmn_process_id="p", payload={"i": 1},
            ), ns.intents.WorkflowInstanceIntent.CREATE)
            broker.run_until_idle()
            engines = [broker.partitions[pid].engine for pid in range(2)]
            runs[ns.runtime.__name__] = (record_signature(broker.records(1)),
                                         [e.device_records_processed for e in engines],
                                         engines[1].host_records_processed)
        finally:
            broker.close()
    (port_sig, port_device, port_host), (jax_sig, jax_device, jax_host) = runs.values()
    assert port_device == jax_device == [port_device[0], 0]
    assert port_host == jax_host > 10
    assert len(port_sig) > 10
    assert _without_partition_bits(port_sig) == jax_sig
