"""Metrics: registry + prometheus text rendering + periodic file writer.

Reference parity: ``util/.../metrics/MetricsManager.java`` (allocate
counters with name + labels, ``dump`` renders Prometheus text format) and
``broker-core/.../system/metrics/MetricsFileWriter.java:34-90`` (an actor
flushes the registry to ``metrics/zeebe.prom`` every 5s; scraped via node
exporter). Counters are used throughout the broker: records processed /
skipped / written per stream processor (``StreamProcessorMetrics``),
workflow-instance counts (``WorkflowInstanceMetrics``), transport and
scheduler internals.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from zeebe_tpu_torch.runtime.actors import Actor, ActorScheduler


class Metric:
    """A counter/gauge with fixed labels. Increment-only use makes it a
    counter; ``set`` makes it a gauge — prometheus typing is emitted from
    ``kind``."""

    __slots__ = ("name", "labels", "kind", "_value", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...], kind: str):
        self.name = name
        self.labels = labels
        self.kind = kind
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self._value += delta

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """A cumulative-bucket histogram with fixed labels (prometheus
    `histogram` type: `_bucket{le=...}`, `_sum`, `_count` series). Used by
    the metrics exporter for per-ValueType/intent export latencies."""

    DEFAULT_BUCKETS = (1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000, 30000)

    __slots__ = ("name", "labels", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(
        self,
        name: str,
        labels: Tuple[Tuple[str, str], ...],
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self._counts[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def render(self, prefix: str, ts: int) -> List[str]:
        base = ",".join(f'{k}="{v}"' for k, v in self.labels)
        sep = "," if base else ""
        lines = []
        with self._lock:
            # _counts are cumulative already (observe bumps every bucket
            # whose bound covers the value) — prometheus `le` semantics
            for le, n in zip(self.buckets, self._counts):
                lines.append(
                    f'{prefix}{self.name}_bucket{{{base}{sep}le="{le:g}"}} '
                    f"{n} {ts}"
                )
            lines.append(
                f'{prefix}{self.name}_bucket{{{base}{sep}le="+Inf"}} '
                f"{self._count} {ts}"
            )
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{prefix}{self.name}_sum{suffix} {self._sum:g} {ts}")
            lines.append(f"{prefix}{self.name}_count{suffix} {self._count} {ts}")
        return lines


class MetricsRegistry:
    """Reference MetricsManager: allocate once, render many."""

    def __init__(self, prefix: str = "zb_"):
        self.prefix = prefix
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Metric] = {}
        self._histograms: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "", **labels: str) -> Metric:
        return self._allocate(name, "counter", help_text, labels)

    def gauge(self, name: str, help_text: str = "", **labels: str) -> Metric:
        return self._allocate(name, "gauge", help_text, labels)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: Tuple[float, ...] = Histogram.DEFAULT_BUCKETS,
        **labels: str,
    ) -> Histogram:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = Histogram(name, key[1], buckets)
                self._histograms[key] = h
            elif h.buckets != tuple(sorted(buckets)):
                # allocate-once semantics: the first caller's buckets win
                # for the process lifetime (observations already landed in
                # them) — silently dropping a DIFFERENT buckets arg would
                # let an operator believe a changed latency_buckets config
                # took effect when it did not
                logging.getLogger(__name__).warning(
                    "histogram %r already allocated with buckets %s; "
                    "ignoring different buckets %s (restart the process "
                    "to change histogram buckets)",
                    name, h.buckets, tuple(sorted(buckets)),
                )
            if help_text:
                self._help[name] = help_text
            return h

    def _allocate(self, name: str, kind: str, help_text: str, labels: Dict[str, str]) -> Metric:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = Metric(name, key[1], kind)
                self._metrics[key] = metric
            if help_text:
                self._help[name] = help_text
            return metric

    def dump(self, now_ms: Optional[int] = None) -> str:
        """Prometheus text format (reference MetricsManager.dump renders
        `name{label="v",...} value timestamp`)."""
        ts = now_ms if now_ms is not None else int(time.time() * 1000)
        by_name: Dict[str, List[Metric]] = {}
        hists_by_name: Dict[str, List[Histogram]] = {}
        with self._lock:
            for metric in self._metrics.values():
                by_name.setdefault(metric.name, []).append(metric)
            for hist in self._histograms.values():
                hists_by_name.setdefault(hist.name, []).append(hist)
        lines: List[str] = []
        for name in sorted(by_name):
            full = self.prefix + name
            if name in self._help:
                lines.append(f"# HELP {full} {self._help[name]}")
            lines.append(f"# TYPE {full} {by_name[name][0].kind}")
            for metric in by_name[name]:
                if metric.labels:
                    label_str = ",".join(f'{k}="{v}"' for k, v in metric.labels)
                    lines.append(f"{full}{{{label_str}}} {metric.value:g} {ts}")
                else:
                    lines.append(f"{full} {metric.value:g} {ts}")
        for name in sorted(hists_by_name):
            full = self.prefix + name
            if name in self._help:
                lines.append(f"# HELP {full} {self._help[name]}")
            lines.append(f"# TYPE {full} histogram")
            for hist in hists_by_name[name]:
                lines.extend(hist.render(self.prefix, ts))
        return "\n".join(lines) + "\n"


# -- process-global event counters ------------------------------------------
# Low-level components (transport, log storage, snapshot storage, raft) have
# no broker registry in reach — they are constructed in many places, some
# (raft's own ClientTransport) several layers away from the broker. Chaos-
# relevant events from those layers count into one process-global registry
# instead, merged into every /metrics dump and metrics-file flush via
# ``render_with_global``. Names used today: raft_elections_started,
# raft_elections_won, transport_reconnects, transport_pending_expired,
# log_torn_tail_truncations, snapshot_salvage_events; exporter plane:
# exporter_lag (gauge, per exporter/partition), exporter_records_exported,
# exporter_export_failures, exporter_floor_stalls, exporter_open_failures,
# exporter_skipped_compacted; snapshot lifecycle (docs/STATE.md):
# snapshot_last_new_bytes / snapshot_last_total_bytes /
# snapshot_take_seconds / snapshot_capture_pause_seconds /
# snapshot_restore_seconds (gauges), snapshot_full_takes,
# snapshot_delta_takes, snapshot_take_failures, snapshot_skipped_inflight,
# snapshot_recover_skipped; columnar record plane (docs/SERVING.md):
# serving_rows_materialized_total — Record objects lazily materialized from
# columnar batch views (protocol/columnar.py); 0 on the pure host wave
# path, where every row is an engine-built Record already; tracing plane
# (docs/operations/tracing.md): raft_commit_stalls,
# raft_appends_truncated, serving_commit_stalls, serving_slow_waves,
# flight_recorder_dumps.
GLOBAL_REGISTRY = MetricsRegistry()


def global_counter(name: str, help_text: str = "", **labels: str) -> Metric:
    return GLOBAL_REGISTRY.counter(name, help_text, **labels)


def global_gauge(name: str, help_text: str = "", **labels: str) -> Metric:
    """Labeled process-global gauge (exporter lag per exporter/partition,
    etc.) — merged into every /metrics dump via ``render_with_global``."""
    return GLOBAL_REGISTRY.gauge(name, help_text, **labels)


def count_event(name: str, help_text: str = "", delta: float = 1.0) -> None:
    """Bump a process-global event counter (allocate-on-first-use)."""
    GLOBAL_REGISTRY.counter(name, help_text).inc(delta)


def event_count(name: str) -> float:
    """Current value of a global event counter (0 if never bumped)."""
    return GLOBAL_REGISTRY.counter(name).value


# -- serving-plane wave instrumentation --------------------------------------
# The pipelined batched drain (runtime/broker.run_until_idle waves,
# cluster_broker.PartitionServer._process_committed chunks) reports each
# dispatched wave here: fill + occupancy gauges localize "the pipeline is
# running empty" vs "the device is the bottleneck" without a profiler, and
# the host/device second counters give the time split the serving bench
# prints. Handles are cached — this sits on the drain hot loop.
_WAVE_HANDLES: dict = {}


def _wave_handles() -> dict:
    if not _WAVE_HANDLES:
        g = GLOBAL_REGISTRY
        _WAVE_HANDLES.update(
            waves=g.counter(
                "serving_waves_total",
                "Committed-record drain waves dispatched to the engine",
            ),
            records=g.counter(
                "serving_wave_records_total",
                "Committed records drained through waves",
            ),
            fill=g.gauge(
                "serving_wave_fill", "Records in the most recent drain wave"
            ),
            fill_mean=g.gauge(
                "serving_wave_fill_mean",
                "Mean records per drain wave since process start",
            ),
            occupancy=g.gauge(
                "serving_wave_occupancy",
                "Most recent wave's fill fraction of the drain-chunk capacity",
            ),
            host_s=g.counter(
                "serving_host_seconds_total",
                "Serving-path host seconds (staging, host-routed records, "
                "emission materialization)",
            ),
            device_s=g.counter(
                "serving_device_seconds_total",
                "Serving-path seconds blocked on device outputs",
            ),
        )
    return _WAVE_HANDLES


def observe_wave(
    records: int,
    capacity: int,
    host_seconds: float = 0.0,
    device_seconds: float = 0.0,
) -> None:
    """Record one committed-record drain wave (process-global; shows up on
    every /metrics dump and metrics file via ``render_with_global``)."""
    h = _wave_handles()
    h["waves"].inc()
    h["records"].inc(records)
    h["fill"].set(records)
    h["fill_mean"].set(h["records"].value / max(h["waves"].value, 1.0))
    if capacity > 0:
        h["occupancy"].set(records / capacity)
    if host_seconds > 0:
        h["host_s"].inc(host_seconds)
    if device_seconds > 0:
        h["device_s"].inc(device_seconds)


# -- shared-wave scheduler instrumentation -----------------------------------
# The cross-partition wave scheduler (zeebe_tpu/scheduler/) reports each
# SHARED wave here on top of the plain wave series: how many partitions
# contributed (the fill-by-traffic-mix view — high fill with many sources
# is the scheduler doing its job; high fill from one source is just a
# firehose), plus its own backpressure/shed counters (allocated on first
# use via count_event / the admission controller).
_SCHED_HANDLES: dict = {}


def _sched_handles() -> dict:
    if not _SCHED_HANDLES:
        g = GLOBAL_REGISTRY
        _SCHED_HANDLES.update(
            shared_waves=g.counter(
                "scheduler_shared_waves_total",
                "Shared waves packed across partitions by the wave scheduler",
            ),
            sources=g.gauge(
                "serving_wave_sources",
                "Partitions contributing records to the most recent shared "
                "wave",
            ),
            sources_total=g.counter(
                "scheduler_wave_sources_total",
                "Sum of contributing partitions over all shared waves "
                "(mean = this / scheduler_shared_waves_total)",
            ),
            sources_mean=g.gauge(
                "serving_wave_sources_mean",
                "Mean partitions per shared wave since process start",
            ),
        )
    return _SCHED_HANDLES


def observe_shared_wave(
    records: int,
    capacity: int,
    sources: int,
    host_seconds: float = 0.0,
    device_seconds: float = 0.0,
) -> None:
    """Record one SHARED drain wave (scheduler path): the plain wave
    series (fill/occupancy/time split) plus the traffic-mix gauges."""
    observe_wave(records, capacity, host_seconds, device_seconds)
    h = _sched_handles()
    h["shared_waves"].inc()
    h["sources"].set(sources)
    h["sources_total"].inc(sources)
    h["sources_mean"].set(
        h["sources_total"].value / max(h["shared_waves"].value, 1.0)
    )


# -- mesh serving instrumentation --------------------------------------------
# The mesh-sharded serving plane (scheduler/placement.DevicePlan) places
# leader partitions across devices; these series prove the spread is real:
# per-device wave/record/occupancy/time-split (labeled by plan device
# index) and the per-shared-wave distinct-device count — ">1 device active
# per scheduling round" is serving_wave_devices_mean > 1.
_DEVICE_WAVE_HANDLES: dict = {}
_MESH_WAVE_HANDLES: dict = {}


def _device_wave_handles(device: str) -> dict:
    h = _DEVICE_WAVE_HANDLES.get(device)
    if h is None:
        g = GLOBAL_REGISTRY
        h = dict(
            waves=g.counter(
                "serving_device_waves_total",
                "Wave segments dispatched to each mesh device",
                device=device,
            ),
            records=g.counter(
                "serving_device_records_total",
                "Records processed per mesh device",
                device=device,
            ),
            share=g.gauge(
                "serving_device_wave_share",
                "Share of the most recent shared wave's records that "
                "landed on each mesh device (balance view; ~1/active "
                "devices under uniform load)",
                device=device,
            ),
            host_s=g.counter(
                "serving_device_host_seconds_total",
                "Host seconds spent staging/collecting per mesh device",
                device=device,
            ),
            device_s=g.counter(
                "serving_device_device_seconds_total",
                "Seconds blocked on each mesh device's outputs",
                device=device,
            ),
        )
        _DEVICE_WAVE_HANDLES[device] = h
    return h


def observe_device_wave(
    device_index: int,
    records: int,
    wave_total: int,
    host_seconds: float = 0.0,
    device_seconds: float = 0.0,
) -> None:
    """Record one wave segment landing on a mesh device (labeled by the
    DevicePlan index). ``wave_total`` is the WHOLE shared wave's record
    count — the share gauge reads balance across devices, not fill.
    Called by the wave scheduler per dispatched segment; engines without
    a plan placement (index < 0) are skipped."""
    if device_index < 0:
        return
    h = _device_wave_handles(str(device_index))
    h["waves"].inc()
    h["records"].inc(records)
    if wave_total > 0:
        h["share"].set(records / wave_total)
    if host_seconds > 0:
        h["host_s"].inc(host_seconds)
    if device_seconds > 0:
        h["device_s"].inc(device_seconds)


def observe_mesh_wave(devices_active: int) -> None:
    """Distinct mesh devices that received segments of one shared wave."""
    h = _MESH_WAVE_HANDLES
    if not h:
        g = GLOBAL_REGISTRY
        h.update(
            devices=g.gauge(
                "serving_wave_devices",
                "Mesh devices active in the most recent shared wave",
            ),
            devices_total=g.counter(
                "scheduler_wave_devices_total",
                "Sum of active mesh devices over all shared waves "
                "(mean = this / scheduler_shared_waves_total)",
            ),
            waves=g.counter("scheduler_shared_waves_total"),
            devices_mean=g.gauge(
                "serving_wave_devices_mean",
                "Mean mesh devices active per shared wave since process "
                "start (>1 = device compute overlaps across the mesh)",
            ),
        )
    h["devices"].set(devices_active)
    h["devices_total"].inc(devices_active)
    h["devices_mean"].set(
        h["devices_total"].value / max(h["waves"].value, 1.0)
    )


_SHARDED_WAVE_HANDLES: Dict[str, Metric] = {}
_SHARD_ROW_HANDLES: Dict[str, Metric] = {}
_SHARD_FILL_HANDLES: Dict[str, Metric] = {}
# edge-trigger for the skew warn log: one line per skew EPISODE, re-armed
# by the next balanced wave (flooding the log at wave rate would bury the
# signal the warn exists to surface)
_SKEW_WARNED = [False]

# waves skewed beyond this (max/mean routed rows) warn: one shard is
# doing >4x its fair share — the residency router's load-balance signal
SHARD_SKEW_WARN_RATIO = 4.0


def observe_sharded_wave(
    shard_rows, exchange_bytes: int, single_lane: bool = False
) -> None:
    """Record one wave dispatched through a SHARDED-state partition:
    ``shard_rows`` is the per-shard row count of the staged batch (owner
    lane fill under resident routing, advisory key-hash split under
    gathered — the balance signal operators watch for hot shards),
    ``exchange_bytes`` the wave's ACTUAL cross-shard volume (0 for waves
    that dispatched no records — idle/warm steps move nothing worth
    accounting). ``single_lane`` marks a RESIDENT-ROUTED wave: one lane
    holds everything BY DESIGN, so the skew gauge/warn skip it (the
    ratio would read num_shards on every healthy routed wave — skew is a
    key-hash-split signal, scored on gathered and fallback waves)."""
    h = _SHARDED_WAVE_HANDLES
    if not h:
        g = GLOBAL_REGISTRY
        h.update(
            waves=g.counter(
                "serving_sharded_waves_total",
                "Waves dispatched through the mesh-sharded step program",
            ),
            exchange=g.counter(
                "mesh_shard_exchange_bytes_total",
                "Cross-shard collective bytes moved by sharded-state waves "
                "(table gathers over the mesh axis, or boundary psum "
                "volume under resident routing)",
            ),
            skew=g.gauge(
                "mesh_shard_skew_ratio",
                "max/mean routed rows across the shard span for the most "
                "recent non-empty sharded wave (1.0 = perfectly balanced, "
                "num_shards = one shard takes everything)",
            ),
            skew_waves=g.counter(
                "mesh_shard_skewed_waves_total",
                "Sharded waves whose routed-row skew exceeded the 4x "
                "warn threshold (at meaningful fill)",
            ),
        )
    h["waves"].inc()
    if exchange_bytes > 0:
        h["exchange"].inc(exchange_bytes)
    total = 0
    peak = 0
    for i, rows in enumerate(shard_rows):
        rows = int(rows)
        total += rows
        peak = max(peak, rows)
        key = str(i)
        m = _SHARD_ROW_HANDLES.get(key)
        if m is None:
            m = GLOBAL_REGISTRY.gauge(
                "mesh_shard_rows",
                "Rows of the most recent sharded wave routed to each "
                "shard by key hash",
                device=key,
            )
            _SHARD_ROW_HANDLES[key] = m
        m.set(rows)
    nshards = max(len(shard_rows), 1)
    if total > 0 and not single_lane:
        ratio = peak * nshards / total  # max over mean
        h["skew"].set(ratio)
        # the warn gates on meaningful fill (>= 4 rows/shard on average):
        # a 3-record wave on 8 shards is ALWAYS "skewed" and means nothing
        if ratio > SHARD_SKEW_WARN_RATIO and total >= 4 * nshards:
            h["skew_waves"].inc()
            if not _SKEW_WARNED[0]:
                _SKEW_WARNED[0] = True
                logging.getLogger(__name__).warning(
                    "sharded wave skew %.1fx across %d shards (%d rows, "
                    "peak %d): one shard is doing >%gx its fair share — "
                    "resident routing is only as parallel as the "
                    "instance spread",
                    ratio, nshards, total, peak, SHARD_SKEW_WARN_RATIO,
                )
        else:
            _SKEW_WARNED[0] = False


def observe_shard_fill(plan_indices, fill) -> None:
    """Per-shard staged-row fill of one collected sharded-state segment,
    keyed by the PLAN device index each shard occupies (the scheduler's
    view — ``mesh_shard_rows`` above is keyed by shard ordinal, which
    every sharded partition shares)."""
    for d, rows in zip(plan_indices, fill):
        key = str(int(d))
        m = _SHARD_FILL_HANDLES.get(key)
        if m is None:
            m = GLOBAL_REGISTRY.gauge(
                "mesh_shard_wave_fill",
                "Staged rows the most recent collected sharded segment "
                "routed to this plan device",
                device=key,
            )
            _SHARD_FILL_HANDLES[key] = m
        m.set(int(rows))


def render_with_global(registry: MetricsRegistry, now_ms: Optional[int] = None) -> str:
    """A registry's Prometheus dump with the global event counters appended
    (skipped when the registry IS the global one — no duplicate series)."""
    text = registry.dump(now_ms)
    if registry is not GLOBAL_REGISTRY:
        text += GLOBAL_REGISTRY.dump(now_ms)
    return text


class MetricsHttpServer:
    """Serves ``GET /metrics`` with the registry's Prometheus text dump.

    The reference exposes the metrics file through a node exporter
    (prometheus/prometheus.yml + MetricsFileWriter); here the broker
    serves the same text directly so the compose stack needs no exporter
    sidecar."""

    def __init__(self, registry: MetricsRegistry, host: str = "0.0.0.0", port: int = 9600):
        import http.server

        registry_ref = registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API name
                if self.path.rstrip("/") not in ("", "/metrics", "/healthz"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = render_with_global(registry_ref).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="zb-metrics-http", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class MetricsFileWriter(Actor):
    """Periodically dumps the registry to a file (reference
    MetricsFileWriter: temp-write then rename so scrapers never see a torn
    file)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        path: str,
        scheduler: ActorScheduler,
        flush_period_ms: int = 5_000,
    ):
        super().__init__("metrics-file-writer")
        self.registry = registry
        self.path = path
        self.flush_period_ms = flush_period_ms
        scheduler.submit_actor(self, io_bound=True)  # zblint: disable=unobserved-actor-future (boot submit; start failures land in the scheduler failure ring)

    def on_actor_started(self) -> None:
        self.actor.run_at_fixed_rate(self.flush_period_ms, self.flush)

    def flush(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(render_with_global(self.registry))
        os.replace(tmp, self.path)
