"""BASELINE config 5 (a cardinality-4 multi-instance sub-process around a
service task) served in a credit drought: a burst of instances into each
package's in-process ``Broker`` with one worker of fewer credits than
their jobs (64 instances at 32 credits; and chip_smoke 6b's 512 instances,
2,048 jobs, at 256 and 512 credits, about two minutes each).
``CudaPartitionEngine`` (on the CPU) and the JAX package's
``TpuPartitionEngine`` (on the CPU) write the same log and leave the same
state tables, bit for bit. (In a drought both re-assign stranded jobs in
an order the host oracle does not share, so the port is held to the JAX
engine here and to the oracle only with a credit for every job.)
"""

import types

import numpy as np
import pytest

from test_torch_engine import (  # noqa: F401  (the fixture is autouse)
    JAX, PORT, TpuPartitionEngine, _subscriber_keys_from_one, burst, finish,
    open_broker,
)
from test_tpu_parity import record_signature
import zeebe_tpu.runtime as jax_runtime
import zeebe_tpu_torch.runtime as port_runtime
from zeebe_tpu.engine.interpreter import WorkflowRepository as JaxRepository
from zeebe_tpu.models.bpmn.builder import Bpmn
from zeebe_tpu_torch.engine.interpreter import WorkflowRepository as PortRepository
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

CARDINALITY = 4
RECORDS_PER_INSTANCE = 70


def config5_process():
    builder = Bpmn.create_process("c5")
    sub = builder.start_event("start").sub_process(
        "each", multi_instance={"cardinality": CARDINALITY})
    sub.start_event("s").service_task("work", type="payment-service").end_event("e")
    return sub.embedded_done().end_event("done").done()


def _jax_broker(capacity):
    def make(clock, data_dir):
        repo = JaxRepository()
        return jax_runtime.Broker(
            num_partitions=1, clock=clock, data_dir=data_dir,
            engine_factory=lambda pid: TpuPartitionEngine(
                pid, 1, repository=repo, clock=clock, capacity=capacity),
        )
    return make


def _port_broker(capacity):
    def make(clock, data_dir):
        repo = PortRepository()
        return port_runtime.Broker(
            num_partitions=1, clock=clock, data_dir=data_dir,
            engine_factory=lambda pid: CudaPartitionEngine(
                pid, 1, repository=repo, clock=clock, capacity=capacity, device="cpu"),
        )
    return make


# (instances, credits, engine capacity); 512 instances at the served
# benchmark's capacity (bench.py:336: max(4096, 2 * instances))
@pytest.mark.parametrize("instances, credits, capacity", [
    (64, 32, 1 << 10),
    pytest.param(512, 256, 1 << 12, marks=pytest.mark.slow),
    pytest.param(512, 512, 1 << 12, marks=pytest.mark.slow),
])
def test_config5_drought_equals_the_jax_engine(tmp_path, instances, credits, capacity):
    brokers = []
    for ns in (types.SimpleNamespace(**{**vars(JAX), "broker": _jax_broker(capacity)}),
               types.SimpleNamespace(**{**vars(PORT), "broker": _port_broker(capacity)})):
        broker = open_broker(ns, tmp_path / ns.runtime.__name__, credits=credits)
        burst(ns, broker, instances, model=config5_process,
              payload=lambda i: {"orderId": i, "orderValue": 99})
        finish(broker)
        brokers.append(broker)
    jax_sig, port_sig = (record_signature(b.records(0)) for b in brokers)
    for i, (a, b) in enumerate(zip(jax_sig, port_sig)):
        assert a == b, f"record {i} mismatch:\n  jax:  {a}\n  port: {b}"
    assert len(jax_sig) == len(port_sig) == RECORDS_PER_INSTANCE * instances
    completed = [s for s in port_sig if s[2] == 5 and s[3] == 8 and s[8] == "c5"]
    assert len(completed) == instances
    engine = brokers[1].partitions[0].engine
    assert engine.host_only_reasons == {} and engine.device_records_processed > 0
    assert not engine._host.element_instances.instances
    jax_snap, port_snap = (b.partitions[0].engine.snapshot_state() for b in brokers)
    assert jax_snap["meta"] == port_snap["meta"]
    assert sorted(jax_snap["arrays"]) == sorted(port_snap["arrays"])
    for name, a in jax_snap["arrays"].items():
        b = port_snap["arrays"][name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for b in brokers:
        b.close()
