"""End-to-end record tracing + the always-on flight recorder.

Three layers (docs/operations/tracing.md is the operator guide):

- **Record-lifecycle spans** (:mod:`spans`): sampled commands are stamped
  at every hop from gateway receive to exporter ack. ``TRACER`` is the
  process-wide instance; ``None`` means tracing is off and every call
  site returns after one global read (the zero-allocation fast path).
- **Wave timelines** (:class:`spans.WaveTimeline`): per-wave dispatch/
  collect events per device segment, exportable as Chrome-trace JSON via
  ``tools/trace_report.py``.
- **Flight recorder** (:mod:`recorder`): always on regardless of the
  span tracer — a bounded lock-free ring of recent control-plane events,
  dumped to disk on chaos-invariant failure or explicit signal.
"""

from __future__ import annotations

from typing import Optional

from zeebe_tpu_torch.tracing.recorder import (  # noqa: F401 - public surface
    FLIGHT,
    FlightRecorder,
    dump_flight_recorder,
    install_signal_dump,
    read_flight_dump,
    record_event,
)
from zeebe_tpu_torch.tracing.spans import (  # noqa: F401 - public surface
    ACTOR_ENQUEUE,
    ADMISSION,
    APPLY,
    COMMIT,
    DEVICE_COLLECT,
    EXPORT_ACK,
    EXPORT_DISPATCH,
    FEED_TAKE,
    GATEWAY_RECV,
    RAFT_FSYNC,
    RAFT_QUEUE,
    RESPONSE,
    STAGE_ORDER,
    WAVE_DISPATCH,
    RecordTracer,
    Span,
    now_us,
)

# the process-wide span tracer; None = spans off (flight recorder stays on)
TRACER: Optional[RecordTracer] = None
# install(None) is STICKY: a broker boot without an explicit [tracing]
# config must not silently re-enable sampling the caller just turned off
# (the bench's tracing-off A/B leg and the disabled-fast-path test both
# depend on OFF meaning off)
_EXPLICITLY_DISABLED = False


def install(tracer: Optional[RecordTracer]) -> Optional[RecordTracer]:
    """Install (or, with None, remove) the process-wide span tracer.
    Removal is sticky for config-less broker boots: only ``install`` with
    a tracer or an ``enabled=true`` config re-enables spans."""
    global TRACER, _EXPLICITLY_DISABLED
    TRACER = tracer
    _EXPLICITLY_DISABLED = tracer is None
    return tracer


def ensure_tracer(cfg=None) -> Optional[RecordTracer]:
    """Broker-boot entry: install the process tracer from a ``TracingCfg``
    (or defaults). A second broker in the same process reuses the
    existing tracer — one span store per process, like the metrics
    registry. ``cfg.enabled = False`` uninstalls (spans off everywhere;
    several in-process brokers share the switch by design), and a
    config-less boot (the in-process Broker) respects a prior explicit
    ``install(None)``."""
    global TRACER
    if cfg is not None and not cfg.enabled:
        return install(None)
    if TRACER is not None:
        return TRACER
    if cfg is None:
        if _EXPLICITLY_DISABLED:
            return None
        return install(RecordTracer())
    return install(RecordTracer(
        sample_rate=cfg.sample_rate,
        seed=cfg.seed,
        per_partition_budget=cfg.per_partition_budget,
        commit_stall_ms=cfg.commit_stall_ms,
        slow_wave_ms=cfg.slow_wave_ms,
    ))


def no_ack_plane(partition_or_server) -> bool:
    """True when no exporter ack will ever arrive for this partition's
    records — no exporter plane at all, or one whose every exporter broke
    at open. Then the response/apply is a span's final reachable stage.
    The ONE place this rule lives (both broker types consult it): a
    response path and a finish path that disagree would leak a span in
    the live budget with every per-record stamp path kept hot."""
    director = getattr(partition_or_server, "exporter_director", None)
    return director is None or not director.can_ack()


def positions_of(records):
    """Log positions of a drained span (list of Records, a columnar
    ``RecordsView``, or scheduler-harness plain ints) — the shared helper
    every stamp site uses."""
    fn = getattr(records, "positions", None)
    if fn is not None:
        return fn()
    return [getattr(r, "position", r) for r in records]
