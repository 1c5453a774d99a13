"""The trace plane over the port's device engine, held to the JAX package.

After ``tests/test_tracing.py`` and ``tools/trace_smoke.py``: with a
rate-1.0 ``RecordTracer`` installed, the port's in-process ``Broker`` served
by ``CudaPartitionEngine`` on the CPU stamps every answered command with
the full in-process lifecycle (gateway receive through exporter ack) in
stamp order, and each span carries the same stages as the JAX device
engine's span of the same command. The wave timelines are consistent
(collect at or after dispatch, and the segments' records add up to the
records served). A cluster node's pipelined feed stamps ``DEVICE_COLLECT``
before ``APPLY``. The tracer's dump converts through
``tools/trace_report.py``, run as a program, into Chrome-trace JSON that
parses back.
"""

import itertools
import json
import os
import subprocess
import sys
import types

import zeebe_tpu.exporter as jax_exporter
import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu.models.bpmn.builder as jax_builder
import zeebe_tpu.runtime as jax_runtime
import zeebe_tpu.runtime.config as jax_config
from test_torch_serving import jax_engines, port_engines
from zeebe_tpu import tracing as jax_tracing

import zeebe_tpu_torch.exporter as port_exporter
import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.gateway.workers as port_workers
import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.runtime as port_runtime
import zeebe_tpu_torch.runtime.config as port_config
from zeebe_tpu_torch import tracing
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the single-writer (in-process) lifecycle
HOST_LIFECYCLE = [
    tracing.GATEWAY_RECV,
    tracing.COMMIT,
    tracing.FEED_TAKE,
    tracing.WAVE_DISPATCH,
    tracing.APPLY,
    tracing.RESPONSE,
    tracing.EXPORT_DISPATCH,
    tracing.EXPORT_ACK,
]


PORT = types.SimpleNamespace(
    runtime=port_runtime, gateway=port_gateway, workers=port_workers,
    Bpmn=port_builder.Bpmn, config=port_config, exporter=port_exporter,
    tracing=tracing, engines=port_engines,
)
JAX = types.SimpleNamespace(
    runtime=jax_runtime, gateway=jax_gateway, workers=jax_workers,
    Bpmn=jax_builder.Bpmn, config=jax_config, exporter=jax_exporter,
    tracing=jax_tracing, engines=jax_engines,
)


def traced_run(ns, data_dir, instances=4):
    """Serve ``instances`` order-process instances on ``ns``'s device
    engine under a rate-1.0 tracer with an in-memory exporter; returns the
    tracer (uninstalled) and the records the partition served."""
    tracer = ns.tracing.install(ns.tracing.RecordTracer(sample_rate=1.0, seed=42))
    ns.exporter.InMemoryExporter.reset()
    ns.workers._subscriber_keys = itertools.count(1)
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = ns.runtime.Broker(
        num_partitions=1, data_dir=data_dir, clock=clock,
        engine_factory=ns.engines(clock),
        exporters=[ns.config.ExporterCfg(id="trace-mem", type="memory")],
    )
    try:
        client = ns.gateway.ZeebeClient(broker)
        client.deploy_model(
            ns.Bpmn.create_process("order-process").start_event("start")
            .service_task("work", type="payment-service").end_event("end").done())
        ns.gateway.JobWorker(broker, "payment-service", lambda ctx: {"paid": True})
        for i in range(instances):
            client.create_instance("order-process", {"orderId": i})
        broker.run_until_idle()
        served = len(broker.records(0))
        assert broker.partitions[0].engine.device_records_processed > 0
    finally:
        broker.close()
        ns.tracing.install(None)
        ns.exporter.InMemoryExporter.reset()
    return tracer, served


def complete_spans(ns, tracer):
    return [s for s in tracer.spans() if ns.tracing.RESPONSE in s.stage_names()]


def test_device_engine_full_lifecycle_equal_to_jax(tmp_path):
    tracer, _ = traced_run(PORT, str(tmp_path / "port"))
    spans = complete_spans(PORT, tracer)
    assert len(spans) >= 4  # the four CREATE commands at least
    for span in spans:
        names = span.stage_names()
        missing = [s for s in HOST_LIFECYCLE if s not in names]
        assert not missing, (span.trace_id, names, missing)
        ts = [t for _n, t, _f in span.stages]
        assert ts == sorted(ts), list(zip(names, ts))
        assert span.position >= 0
    jax_tracer, _ = traced_run(JAX, str(tmp_path / "jax"))
    port_stages = sorted((s.position, tuple(s.stage_names())) for s in tracer.spans())
    jax_stages = sorted((s.position, tuple(s.stage_names()))
                        for s in jax_tracer.spans())
    assert port_stages == jax_stages


def test_wave_timelines_are_consistent_and_cover_the_served_records(tmp_path):
    tracer, served = traced_run(PORT, str(tmp_path / "port"), instances=8)
    waves = tracer.waves.snapshot()
    assert waves, "no wave timelines recorded"
    for wave in waves:
        assert wave["t_collect_us"] >= wave["t_dispatch_us"]
        assert wave["records"] == sum(seg["records"] for seg in wave["segments"])
        for seg in wave["segments"]:
            assert seg["t_collect_us"] >= seg["t_dispatch_us"] >= 0
            assert seg["host_s"] >= 0 and seg["device_s"] >= 0
    assert sum(wave["records"] for wave in waves) == served


def test_scheduler_collect_stamps_device_collect_before_apply():
    """The cluster feed's collect stamps DEVICE_COLLECT before the apply
    stamps APPLY (``tests/test_tracing.py``'s stub of ``PartitionServer``)."""
    from zeebe_tpu_torch.runtime.cluster_broker import PartitionServer

    tracer = tracing.install(tracing.RecordTracer(sample_rate=1.0, seed=42))
    try:
        span = tracer.maybe_sample(0)
        tracer.bind_position(span, 0, 7, committed=True)
        stub = types.SimpleNamespace(partition_id=0, device_index=3)
        stub.engine = types.SimpleNamespace(collect_wave=lambda pending: [])

        def apply_chunk(records, merged):
            tracer.stamp_positions(0, tracing.positions_of(records), tracing.APPLY)

        stub._apply_chunk = apply_chunk
        pending = types.SimpleNamespace(
            records=[types.SimpleNamespace(position=7)],
            host_seconds=0.0, device_seconds=0.0,
        )
        assert PartitionServer.collect(stub, pending) == (0.0, 0.0)
        names = span.stage_names()
        assert names.index(tracing.DEVICE_COLLECT) < names.index(tracing.APPLY)
        assert {n: f for n, _t, f in span.stages}[tracing.DEVICE_COLLECT]["device"] == 3
    finally:
        tracing.install(None)


def test_cluster_node_on_the_device_engine_stamps_collect_before_apply(tmp_path):
    """A one-node cluster served by ``CudaPartitionEngine``: its pipelined
    waves stamp DEVICE_COLLECT, then APPLY, on the sampled commands."""
    from test_cluster import make_cfg, wait_until

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config

    cfg = port_config.BrokerCfg()
    for section, ref in vars(make_cfg("n0", 1)).items():
        for field, value in getattr(ref, "__dict__", {}).items():
            setattr(getattr(cfg, section), field, value)
    cfg.engine.type = "cuda"
    tracer = tracing.install(tracing.RecordTracer(sample_rate=1.0, seed=3))
    broker = ClusterBroker(cfg, str(tmp_path / "n0"),
                           engine_factory=engine_factory_from_config(cfg, device="cpu"))
    client = None
    try:
        broker.open_partition(0).join(30)
        broker.bootstrap_partition(0, {})
        assert wait_until(lambda: broker.partitions[0].is_leader, 60)
        assert isinstance(broker.partitions[0].engine, CudaPartitionEngine)
        client = ClusterClient([broker.client_address], num_partitions=1,
                               request_timeout_ms=60_000)
        client.deploy_model(
            port_builder.Bpmn.create_process("order-process").start_event("start")
            .service_task("work", type="payment-service").end_event("end").done())
        done = []
        worker = client.open_job_worker(
            "payment-service", lambda pid, rec: done.append(rec.key) or {})
        for i in range(3):
            client.create_instance("order-process", {"orderId": i}, partition_id=0)
        assert wait_until(lambda: len(done) >= 3, 60)
        worker.close()
        want = {tracing.ADMISSION, tracing.RAFT_QUEUE, tracing.COMMIT,
                tracing.WAVE_DISPATCH, tracing.DEVICE_COLLECT, tracing.APPLY,
                tracing.RESPONSE}
        full = [s for s in tracer.spans() if want <= set(s.stage_names())]
        assert full, [(s.trace_id, s.stage_names()) for s in tracer.spans()]
        for span in full:
            names = span.stage_names()
            assert names.index(tracing.DEVICE_COLLECT) < names.index(tracing.APPLY)
            ts = [t for _n, t, _f in span.stages]
            assert ts == sorted(ts)
    finally:
        if client is not None:
            client.close()
        broker.close()
        tracing.install(None)


def test_dump_converts_through_trace_report(tmp_path):
    tracer, _ = traced_run(PORT, str(tmp_path / "port"))
    dump = str(tmp_path / "dump.json")
    out = str(tmp_path / "chrome.json")
    tracer.dump(dump)
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_report.py"), dump,
         "-o", out], check=True, timeout=120, cwd=ROOT,
    )
    with open(out) as f:
        chrome = json.loads(json.dumps(json.load(f)))
    events = chrome["traceEvents"]
    assert events
    assert any(e["pid"] == "records" for e in events)
    assert any(e["pid"] == "devices" for e in events)
