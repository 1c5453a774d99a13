"""The JSONL audit exporter over the port's device engine.

After ``tools/exporter_smoke.py``: the port's in-process ``Broker`` with
``CudaPartitionEngine`` on the CPU and the rotating JSONL audit exporter
serves order-process instances in waves of 256. Many of the rows it
exports leave the engine as lazy ``(batch, idx)`` references into a
readback batch. The audit directory replays to exactly the partition's
committed records: positions, record types, value types and intents, and
every other field of the audit document, read back from the log's
segments on disk after the broker closed, but for the one field the JAX
package's host oracle writes into the DEPLOYMENT command after its append
(ROADMAP Queue 3). The JAX device engine's audit documents for the
same commands are the same.
"""

import itertools
import json
import os
import types

import zeebe_tpu.exporter as jax_exporter
import zeebe_tpu.gateway as jax_gateway
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu.models.bpmn.builder as jax_builder
import zeebe_tpu.runtime as jax_runtime
import zeebe_tpu.runtime.config as jax_config
from test_torch_serving import jax_engines, port_engines

import zeebe_tpu_torch.exporter as port_exporter
import zeebe_tpu_torch.gateway as port_gateway
import zeebe_tpu_torch.gateway.workers as port_workers
import zeebe_tpu_torch.models.bpmn.builder as port_builder
import zeebe_tpu_torch.runtime as port_runtime
import zeebe_tpu_torch.runtime.config as port_config
from zeebe_tpu_torch.exporter.base import record_to_doc
from zeebe_tpu_torch.log import LogStream, SegmentedLogStorage
from zeebe_tpu_torch.protocol.columnar import rows_materialized_total
from zeebe_tpu_torch.protocol.enums import ValueType


PORT = types.SimpleNamespace(runtime=port_runtime, gateway=port_gateway,
                             workers=port_workers, Bpmn=port_builder.Bpmn,
                             config=port_config, exporter=port_exporter,
                             engines=port_engines)
JAX = types.SimpleNamespace(runtime=jax_runtime, gateway=jax_gateway,
                            workers=jax_workers, Bpmn=jax_builder.Bpmn,
                            config=jax_config, exporter=jax_exporter,
                            engines=jax_engines)


def audited_run(ns, root, instances=24):
    """Serve ``instances`` instances with the JSONL exporter; returns the
    audit documents, the data directory, and the lazy rows materialized
    during the drain (the port's counter)."""
    ns.workers._subscriber_keys = itertools.count(1)
    clock = ns.runtime.ControlledClock(start_ms=1_000_000)
    data_dir, audit_dir = os.path.join(root, "data"), os.path.join(root, "audit")
    broker = ns.runtime.Broker(
        num_partitions=1, data_dir=data_dir, clock=clock,
        engine_factory=ns.engines(clock),
        exporters=[ns.config.ExporterCfg(id="audit", type="jsonl",
                                         args={"path": audit_dir})],
    )
    broker.wave_size = 256
    m0 = rows_materialized_total()
    try:
        client = ns.gateway.ZeebeClient(broker)
        client.deploy_model(
            ns.Bpmn.create_process("smoke-order").start_event("start")
            .service_task("work", type="smoke-svc").end_event("end").done())
        ns.gateway.JobWorker(broker, "smoke-svc", lambda ctx: {"done": True})
        for i in range(instances):
            client.create_instance("smoke-order", {"i": i})
        broker.run_until_idle()
        materialized = rows_materialized_total() - m0
        assert broker.partitions[0].engine.device_records_processed > 0
    finally:
        broker.close()
    return ns.exporter.read_audit_docs(audit_dir), data_dir, materialized


def committed_docs(data_dir):
    """The committed records of partition 0, decoded from the segments on
    disk, as audit documents (exporter acknowledgements left out, as the
    exporter leaves them out)."""
    storage = SegmentedLogStorage(os.path.join(data_dir, "partition-0"))
    try:
        log = LogStream(storage)
        return [
            json.loads(json.dumps(record_to_doc(r), separators=(",", ":"),
                                  sort_keys=True))
            for r in log.reader(0)
            if r.position <= log.commit_position
            and int(r.metadata.value_type) != int(ValueType.EXPORTER)
        ]
    finally:
        storage.close()


def test_audit_replays_to_the_committed_log_field_by_field(tmp_path):
    docs, data_dir, materialized = audited_run(PORT, str(tmp_path / "port"))
    expected = committed_docs(data_dir)
    assert len(expected) > 200
    assert materialized > 0, "no row left the engine as a lazy reference"
    key = ("position", "recordType", "valueType", "intent")
    assert [tuple(d[k] for k in key) for d in docs] == [
        tuple(d[k] for k in key) for d in expected]
    differ = [(got, want) for got, want in zip(docs, expected) if got != want]
    # the one exception is the reference's: the host oracle fills the
    # DEPLOYMENT command's deployedWorkflows in the Record object it was
    # appended as, and the exporter reads that object, not the frame
    assert [(got["valueType"], got["recordType"]) for got, _ in differ] == [
        ("DEPLOYMENT", "COMMAND")]
    got, want = differ[0]
    assert want["value"]["deployedWorkflows"] == []
    assert {**got["value"], "deployedWorkflows": []} == want["value"]
    assert {**got, "value": None} == {**want, "value": None}


def test_audit_documents_equal_the_jax_device_engines(tmp_path):
    port_docs, _, _ = audited_run(PORT, str(tmp_path / "port"), instances=12)
    jax_docs, _, _ = audited_run(JAX, str(tmp_path / "jax"), instances=12)
    assert len(port_docs) > 100
    assert port_docs == jax_docs
