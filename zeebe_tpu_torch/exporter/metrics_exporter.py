"""Metrics exporter: per-ValueType/intent record counts and commit→export
latency histograms, fed into the process-global metrics registry so they
appear on every broker's ``/metrics`` endpoint and metrics file
(``render_with_global``).

Reference analogue: the reference's metrics exporter feeding the
prometheus stack (docker/compose + MetricsFileWriter); here the exporter
IS the pipeline — no sidecar."""

from __future__ import annotations

from typing import Optional

from zeebe_tpu_torch.exporter.base import Exporter, ExporterContext, intent_name
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY


class MetricsExporter(Exporter):
    """args: ``latency_buckets`` (optional list of upper bounds, ms)."""

    def __init__(self, registry=None):
        self.registry = registry or GLOBAL_REGISTRY
        self.partition_id = 0
        self.clock = None
        self.buckets: Optional[tuple] = None
        # metric handles cached per (record_type, value_type, intent):
        # resolving through the registry lock per RECORD would put two
        # mutex round-trips on the egress hot path (same fix as the
        # director's _lag_gauges)
        self._counters: dict = {}
        self._hists: dict = {}

    def configure(self, context: ExporterContext) -> None:
        self.partition_id = context.partition_id
        self.clock = context.clock
        raw = (context.args or {}).get("latency_buckets")
        if raw:
            self.buckets = tuple(float(b) for b in raw)

    def export_batch(self, records) -> None:
        from zeebe_tpu_torch.runtime.metrics import Histogram

        now = self.clock() if self.clock is not None else None
        # columnar egress: this sink needs only the metadata scalar
        # columns — it never materializes a single Record object from a
        # columnar view (the wave stays the currency through this edge)
        if hasattr(records, "value_types"):
            vts = records.value_types()
            rts = records.record_types()
            intents = records.intents()
            timestamps = records.timestamps()
        else:  # plain record lists (tests, custom drivers)
            vts = [int(r.metadata.value_type) for r in records]
            rts = [int(r.metadata.record_type) for r in records]
            intents = [int(r.metadata.intent) for r in records]
            timestamps = [r.timestamp for r in records]
        for row in range(len(vts)):
            vt = vts[row]
            rt = rts[row]
            intent = intents[row]
            key = (rt, vt, intent)
            counter = self._counters.get(key)
            if counter is None:
                vt_name = ValueType(vt).name \
                    if vt in ValueType._value2member_map_ else str(vt)
                rt_name = RecordType(rt).name \
                    if rt in RecordType._value2member_map_ else str(rt)
                labels = {
                    "value_type": vt_name,
                    "intent": intent_name(vt, intent),
                    "partition": str(self.partition_id),
                }
                counter = self.registry.counter(
                    "exported_records_total",
                    "Committed records seen by the metrics exporter",
                    record_type=rt_name,
                    **labels,
                )
                self._counters[key] = counter
                self._hists[key] = self.registry.histogram(
                    "export_latency_ms",
                    "Record timestamp → export latency",
                    buckets=self.buckets or Histogram.DEFAULT_BUCKETS,
                    record_type=rt_name,
                    **labels,
                )
            counter.inc()
            ts = timestamps[row]
            if now is not None and ts >= 0:
                self._hists[key].observe(max(0, now - ts))
