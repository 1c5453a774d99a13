"""The port's wave drain against record-at-a-time and the JAX device engine.

``tests/test_serving_wave.py`` pins that the broker's wave drain is a
packing change: the log at ``wave_size`` 256 is bit-identical to the log
record at a time. Here the same workload runs through the port's own
``Broker`` with ``CudaPartitionEngine`` on the CPU (every kernel wrapper
takes its plain version), at both wave sizes, and through the JAX
package's ``Broker`` with ``TpuPartitionEngine``: every encoded frame is
equal across the three runs (tolerance 0).

The lazy-emission pin follows ``tests/test_scheduler.py``'s
``TestLazyEmissions``: the port keeps only the lazy path (the JAX
default), so its drain re-stages device rows straight from emission
columns and materializes no more ``Record`` objects than the JAX engine
in lazy mode, and fewer than the JAX engine in eager mode
(``ZB_LAZY_EMISSIONS=0`` at its construction).
"""

import itertools
import types

import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu.models.bpmn.builder as jax_builder
import zeebe_tpu.protocol.codec as jax_codec
import zeebe_tpu.protocol.columnar as jax_columnar
import zeebe_tpu.runtime as jax_runtime
import zeebe_tpu.runtime.metrics as jax_metrics
from test_torch_serving import jax_engines, port_engines

import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.gateway.workers as port_workers
import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.protocol.codec as port_codec
import zeebe_tpu_torch.protocol.columnar as port_columnar
import zeebe_tpu_torch.runtime as port_runtime
import zeebe_tpu_torch.runtime.metrics as port_metrics

JAX = types.SimpleNamespace(
    runtime=jax_runtime, gateway=jax_gateway, workers=jax_workers,
    Bpmn=jax_builder.Bpmn, codec=jax_codec, columnar=jax_columnar,
    metrics=jax_metrics,
)
PORT = types.SimpleNamespace(
    runtime=port_runtime, gateway=port_gateway, workers=port_workers,
    Bpmn=port_builder.Bpmn, codec=port_codec, columnar=port_columnar,
    metrics=port_metrics,
)


def order_model(ns):
    return (
        ns.Bpmn.create_process("order-process")
        .start_event("start")
        .service_task("collect-money", type="payment-service")
        .end_event("end")
        .done()
    )


def xor_model(ns):
    builder = (
        ns.Bpmn.create_process("xor-process")
        .start_event("start")
        .exclusive_gateway("split")
    )
    builder.branch("$.orderValue > 50").service_task(
        "big", type="payment-service"
    ).end_event("end-big")
    builder.branch(default=True).service_task(
        "small", type="payment-service"
    ).end_event("end-small")
    return builder.done()


def run_workload(ns, data_dir, wave_size, engines):
    """``tests/test_serving_wave.py``'s workload on ``ns``'s broker with
    the engines ``engines(clock)`` builds; returns the encoded frames."""
    ns.workers._subscriber_keys = itertools.count(1)
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = ns.runtime.Broker(
        num_partitions=1, data_dir=data_dir, clock=clock,
        engine_factory=engines(clock),
    )
    broker.wave_size = wave_size
    try:
        client = ns.gateway.ZeebeClient(broker)
        client.deploy_model(order_model(ns))
        client.deploy_model(xor_model(ns))
        ns.gateway.JobWorker(broker, "payment-service", lambda ctx: {"paid": True})
        for i in range(20):
            client.create_instance("order-process", {"orderId": i})
        for i in range(10):
            client.create_instance("xor-process", {"orderValue": 10 + 10 * i})
        clock.advance(1_000)
        broker.tick()
        broker.run_until_idle()
        return [ns.codec.encode_record(r) for r in broker.records(0)]
    finally:
        broker.close()


def test_wave_log_bit_identical_to_record_at_a_time_and_to_jax(tmp_path):
    port_wave = run_workload(PORT, str(tmp_path / "wave"), 256, port_engines)
    port_one = run_workload(PORT, str(tmp_path / "one"), 1, port_engines)
    assert len(port_wave) > 100
    assert port_wave == port_one
    jax_wave = run_workload(JAX, str(tmp_path / "jax"), 256, jax_engines)
    assert port_wave == jax_wave


def lazy_workload(ns, data_dir, engines):
    """``TestLazyEmissions``'s device workload; returns (frames, rows
    materialized, rows staged from columns, device records) of the drain
    alone: reading the frames materializes every lazy entry afterwards."""
    ns.workers._subscriber_keys = itertools.count(1)
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    broker = ns.runtime.Broker(
        num_partitions=1, data_dir=data_dir, clock=clock,
        engine_factory=engines(clock),
    )
    broker.wave_size = 256
    staged = ns.metrics.GLOBAL_REGISTRY.counter("serving_rows_staged_columnar_total")
    m0, s0 = ns.columnar.rows_materialized_total(), staged.value
    try:
        client = ns.gateway.ZeebeClient(broker)
        client.deploy_model(
            ns.Bpmn.create_process("lazy-process")
            .start_event("start")
            .service_task("work", type="lazy-service")
            .end_event("end")
            .done()
        )
        ns.gateway.JobWorker(broker, "lazy-service", lambda ctx: {"done": True})
        for i in range(12):
            client.create_instance("lazy-process", {"n": i})
        clock.advance(1_000)
        broker.tick()
        broker.run_until_idle()
        mat = ns.columnar.rows_materialized_total() - m0
        stg = staged.value - s0
        device = broker.partitions[0].engine.device_records_processed
        frames = [ns.codec.encode_record(r) for r in broker.records(0)]
        return frames, mat, stg, device
    finally:
        broker.close()


def test_lazy_emissions_stage_from_columns_and_materialize_no_more_than_jax(
    tmp_path, monkeypatch
):
    port_frames, port_mat, port_staged, port_device = lazy_workload(
        PORT, str(tmp_path / "port"), port_engines
    )
    jax_frames, jax_lazy_mat, jax_staged, _ = lazy_workload(
        JAX, str(tmp_path / "lazy"), jax_engines
    )

    def jax_eager(clock):
        make = jax_engines(clock)

        def factory(pid):
            with monkeypatch.context() as m:
                m.setenv("ZB_LAZY_EMISSIONS", "0")
                return make(pid)

        return factory

    eager_frames, jax_eager_mat, eager_staged, _ = lazy_workload(
        JAX, str(tmp_path / "eager"), jax_eager
    )
    assert len(port_frames) > 100
    assert port_frames == jax_frames == eager_frames
    assert eager_staged == 0, "the JAX engine's eager mode must not column-stage"
    # a healthy share of the device rows re-staged from columns: every
    # follow-up the kernel emits and the next wave steps again
    assert port_staged == jax_staged
    assert port_staged * 4 >= port_device, (port_staged, port_device)
    assert port_mat <= jax_lazy_mat, (port_mat, jax_lazy_mat)
    assert port_mat < jax_eager_mat, (port_mat, jax_eager_mat)
