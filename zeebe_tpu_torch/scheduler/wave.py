"""Continuous-batching device-wave scheduler (Orca-style).

The serving plane's wave metrics (PR 4) exposed the structural gap: each
partition drained its OWN committed tail into its own wave, so under
sparse or skewed traffic wave fill collapsed and every partition paid a
full device round-trip for a handful of records. On a TPU, batch
occupancy is the difference between rated and realized throughput — the
"millions of users" regime is heavy AGGREGATE traffic from many small
tenants, which must pack as tightly as one synthetic firehose.

:class:`WaveScheduler` is the single place waves are formed. It keeps a
per-partition cursor into each partition's committed tail (the one-lock
``committed_view``/``slice_records`` spans are the feed), packs records
from ALL leader partitions on a broker into SHARED waves up to
``wave_size``, dispatches each partition's segment through that
partition's engine (the existing ``dispatch_wave``/``collect_wave``
double-buffered pipeline), and de-multiplexes results back to the owning
partition's apply/append/response path. Per-partition processing order is
cursor order, so every partition's log stays bit-identical to what the
unscheduled per-partition drain produces.

Packing policy is deficit round-robin (DRR) fairness: each feed earns
``quantum`` record credits per packing round and spends them against its
backlog, so a partition with a deep backlog cannot starve sparse ones —
it simply fills whatever room the others leave. Backpressure is per
partition: a feed with more than ``backpressure_limit`` records dispatched
but not yet collected/applied is skipped (counted) until its apply side
catches up, so one slow partition can neither starve the others nor
overrun itself.

The scheduler is deliberately broker-agnostic: a feed is anything that
implements the small :class:`PartitionFeed` surface. The cluster broker's
``PartitionServer`` and the in-process broker's partitions both adapt to
it, so tier-1 covers the exact packing/dispatch code the cluster runs.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from zeebe_tpu_torch import tracing
from zeebe_tpu_torch.runtime.metrics import (
    count_event,
    observe_device_wave,
    observe_mesh_wave,
    observe_shard_fill,
    observe_shared_wave,
)
from zeebe_tpu_torch.tracing.recorder import FLIGHT, record_event

logger = logging.getLogger(__name__)


class PartitionFeed:
    """One partition's drain surface, as the scheduler sees it.

    Implementations (``runtime/cluster_broker.PartitionServer``,
    ``runtime/broker._BrokerFeed``) adapt their partition plumbing to:

    - ``partition_id`` — the segment tag.
    - ``backlog()`` — committed-but-unconsumed record count (packing and
      admission hints; never negative).
    - ``take(limit)`` — CONSUME up to ``limit`` committed records at the
      cursor and advance it. Returns a sequence (list or ``RecordsView``);
      empty when nothing is available (also used for parking: a feed
      waiting on a workflow fetch returns nothing until unparked).
    - ``dispatch(records)`` — hand one wave segment to the engine.
      Returns ``(pending, host_seconds, device_seconds)``: ``pending`` is
      an opaque in-flight wave to pass to ``collect`` later (device
      pipeline), or None when the segment was processed AND applied
      inline (synchronous engines).
    - ``collect(pending)`` — materialize + apply one dispatched segment;
      returns ``(host_seconds, device_seconds)``.
    - ``rewind(position)`` — undo ``take``: reset the cursor to
      ``position`` (called when a dispatch raised before consuming the
      segment, so the records re-drain instead of being lost).
    - ``tick()`` — deadline/TTL sweep entry (probe + command append);
      optional.
    - ``device_index`` — the mesh device this partition's engine is placed
      on (scheduler/placement.DevicePlan index), -1 when unplaced. Used
      only for the per-device wave metrics; dispatch itself is routed by
      the ENGINE's committed state placement.
    - ``device_indices`` — EVERY plan index the partition occupies: the
      span of a mesh-sharded-state engine (its wave computes on all of
      them at once), else just ``[device_index]``. Feeds may leave it
      empty; the scheduler falls back to ``device_index``.
    """

    partition_id: int = -1
    device_index: int = -1
    device_indices: tuple = ()

    def backlog(self) -> int:  # pragma: no cover - interface default
        return 0

    def take(self, limit: int):  # pragma: no cover - interface default
        return []

    def dispatch(self, records):  # pragma: no cover - interface default
        raise NotImplementedError

    def collect(self, pending):  # pragma: no cover - interface default
        raise NotImplementedError

    def rewind(self, position: int) -> None:  # pragma: no cover - default
        pass

    def tick(self) -> None:  # pragma: no cover - interface default
        pass


def _first_position(records) -> int:
    """First log position of a taken span (list of Records or a columnar
    view) — the rewind target when a dispatch fails."""
    positions = getattr(records, "positions", None)
    if positions is not None:
        col = positions()
        return col[0] if col else -1
    first = records[0]
    # plain ints serve as positions in scheduler-core harness feeds
    return getattr(first, "position", first)


class WaveSegment:
    """One partition's contiguous slice of a shared wave."""

    __slots__ = ("feed", "records", "pending", "count", "trace",
                 "shard_fill")

    def __init__(self, feed: PartitionFeed, records):
        self.feed = feed
        self.records = records
        self.count = len(records)
        self.pending = None  # dispatched-but-uncollected engine wave
        self.trace = None  # wave-timeline segment entry (tracing on)
        self.shard_fill = None  # per-shard staged rows, stamped at dispatch


class SharedWave:
    """A wave packed from several partitions' committed tails."""

    __slots__ = ("segments", "total", "host_seconds", "device_seconds",
                 "dispatched", "trace")

    def __init__(self):
        self.segments: List[WaveSegment] = []
        self.total = 0
        self.host_seconds = 0.0
        self.device_seconds = 0.0
        self.dispatched = False
        self.trace = None  # wave-timeline event (tracing on)


class _FeedState:
    __slots__ = ("feed", "deficit", "inflight")

    def __init__(self, feed: PartitionFeed):
        self.feed = feed
        self.deficit = 0
        self.inflight = 0  # records dispatched but not collected/applied


class WaveScheduler:
    """Shared-wave scheduler over registered partition feeds."""

    def __init__(
        self,
        wave_size: int = 512,
        quantum: Optional[int] = None,
        backpressure_limit: Optional[int] = None,
        slow_wave_ms: Optional[int] = None,
    ):
        # slow-wave watchdog threshold: the [tracing] slowWaveMs knob,
        # honored even with spans disabled (the watchdog is sampling-
        # independent); None falls back to the tracer's value, then 5s
        self.slow_wave_ms = slow_wave_ms
        self.wave_size = max(1, wave_size)
        # DRR quantum: fairness granularity. Small enough that several
        # active partitions share one wave, large enough that a lone
        # partition fills the wave in a few rounds.
        self.quantum = quantum if quantum and quantum > 0 else max(
            1, self.wave_size // 8
        )
        # per-partition cap on dispatched-but-unapplied records (the
        # double-buffer depth in records); at the cap the feed is skipped
        self.backpressure_limit = (
            backpressure_limit if backpressure_limit and backpressure_limit > 0
            else 4 * self.wave_size
        )
        self._feeds: Dict[int, _FeedState] = {}
        self._order: List[int] = []  # sorted pids (deterministic packing)
        self._rr = 0  # rotating start index into _order
        # slow-wave watchdog: warn once per stall episode (every slow
        # wave still counts + flight-records; a fast wave re-arms)
        self._slow_wave_warned = False
        from zeebe_tpu_torch.tracing.recorder import RateLimitedEvent

        self._backpressure_event = RateLimitedEvent(
            "scheduler", "backpressure skip"
        )

    # -- registration ------------------------------------------------------
    def register(self, feed: PartitionFeed) -> None:
        self._feeds[feed.partition_id] = _FeedState(feed)
        self._order = sorted(self._feeds)

    def unregister(self, partition_id: int) -> None:
        self._feeds.pop(partition_id, None)
        self._order = sorted(self._feeds)
        if self._order:
            self._rr %= len(self._order)
        else:
            self._rr = 0

    def feeds(self) -> List[PartitionFeed]:
        return [self._feeds[pid].feed for pid in self._order]

    def backlog(self) -> int:
        """Total committed-but-unconsumed records across feeds (the
        gateway admission queue-depth probe)."""
        total = 0
        for state in self._feeds.values():
            total += max(0, state.feed.backlog()) + state.inflight
        return total

    # -- packing (deficit round-robin) -------------------------------------
    def _pack(self) -> Optional[SharedWave]:
        order = self._order
        if not order:
            return None
        wave = SharedWave()
        room = self.wave_size
        start = self._rr
        rotated = order[start:] + order[:start]
        self._rr = (start + 1) % len(order)
        by_feed: Dict[int, WaveSegment] = {}
        # cycle DRR rounds until the wave is full or a whole round adds
        # nothing (every feed empty, parked, or backpressured)
        while room > 0:
            added = False
            for pid in rotated:
                if room <= 0:
                    break
                state = self._feeds.get(pid)
                if state is None:  # unregistered mid-drain (step-down)
                    continue
                state.deficit += self.quantum
                seg = by_feed.get(pid)
                # records already packed into THIS wave count against the
                # in-flight cap too: they dispatch together, so a feed
                # revisited across DRR rounds must not assemble a segment
                # larger than its configured apply-side bound
                packed = seg.count if seg is not None else 0
                budget = min(
                    state.deficit,
                    room,
                    self.backpressure_limit - state.inflight - packed,
                )
                if budget <= 0:
                    if state.feed.backlog() > 0:
                        count_event(
                            "scheduler_backpressure_skips",
                            "Feed visits skipped because the partition hit "
                            "its in-flight backpressure limit",
                        )
                        # skips repeat every DRR round while a partition
                        # is wedged — rate-limited like admission sheds,
                        # or the burst would wrap the flight ring
                        self._backpressure_event.record(
                            partition=pid, inflight=state.inflight,
                            backlog=state.feed.backlog(),
                        )
                    state.deficit = min(state.deficit, self.quantum)
                    continue
                records = state.feed.take(budget)
                taken = len(records)
                if not taken:
                    state.deficit = 0  # empty queue: DRR resets the credit
                    continue
                state.deficit -= taken
                room -= taken
                added = True
                seg = by_feed.get(pid)
                if seg is None:
                    seg = WaveSegment(state.feed, records)
                    by_feed[pid] = seg
                    wave.segments.append(seg)
                else:
                    # a feed revisited within one wave extends its single
                    # contiguous segment (cursor order is preserved)
                    seg.records = _concat(seg.records, records)
                    seg.count += taken
            if not added:
                break
        if not wave.segments:
            return None
        wave.total = sum(seg.count for seg in wave.segments)
        return wave

    # -- dispatch / collect ------------------------------------------------
    def _dispatch(self, wave: SharedWave) -> None:
        wave.dispatched = True
        tracer = tracing.TRACER
        if tracer is not None:
            waves = tracer.waves
            wave_id = next(waves.seq)
            if wave_id % waves.stride == 0:
                wave.trace = waves.begin(wave_id, self.wave_size)
        for i, seg in enumerate(wave.segments):
            state = self._feeds.get(seg.feed.partition_id)
            pid = seg.feed.partition_id
            device = getattr(seg.feed, "device_index", -1)
            if tracer is not None:
                if wave.trace is not None:  # this wave's timeline sampled
                    seg.trace = tracer.waves.segment(
                        wave.trace, pid, device, seg.count
                    )
                if tracer.by_position:
                    tracer.stamp_positions(
                        pid, tracing.positions_of(seg.records),
                        tracing.WAVE_DISPATCH, device=device,
                    )
            try:
                pending, host_s, device_s = seg.feed.dispatch(seg.records)
            except Exception:
                # this segment's records were consumed but never entered
                # the engine: rewind its cursor (and every not-yet-
                # dispatched segment's) so they re-drain — then surface
                # the failure like the per-partition drain would
                count_event(
                    "scheduler_dispatch_rewinds",
                    "Wave segments rewound because their dispatch raised",
                )
                record_event(
                    "scheduler", "dispatch raised; segments rewound",
                    partition=pid, segment_records=seg.count,
                )
                for later in wave.segments[i:]:
                    if later.pending is None and later.count:
                        try:
                            later.feed.rewind(_first_position(later.records))
                        except Exception:  # noqa: BLE001 - best effort
                            logger.exception(
                                "scheduler: rewind failed on partition %d",
                                later.feed.partition_id,
                            )
                    later.count = 0
                wave.total = sum(s.count for s in wave.segments)
                raise
            seg.pending = pending
            # snapshot the engine's per-shard fill NOW: the attribute is
            # mutable "last dispatched" state, and by collect time a later
            # segment's dispatch has overwritten it
            seg.shard_fill = getattr(seg.feed, "shard_fill", None)
            wave.host_seconds += host_s
            wave.device_seconds += device_s
            if pending is None:
                # synchronous engine: the segment processed+applied inline,
                # so its per-device accounting lands here (pipelined
                # segments report at collect, when their times are known)
                observe_device_wave(
                    getattr(seg.feed, "device_index", -1), seg.count,
                    wave.total, host_s, device_s,
                )
                if seg.trace is not None:
                    tracer.waves.segment_collected(
                        seg.trace, host_s, device_s
                    )
            if pending is not None and state is not None:
                state.inflight += seg.count

    def _collect(self, wave: SharedWave) -> None:
        """Materialize a dispatched shared wave's segments (apply appends/
        responses/sends/pushes per partition) and observe its metrics."""
        error = None
        tracer = tracing.TRACER
        for seg in wave.segments:
            if seg.pending is None:
                continue
            pending, seg.pending = seg.pending, None
            state = self._feeds.get(seg.feed.partition_id)
            try:
                host_s, device_s = seg.feed.collect(pending)
                wave.host_seconds += host_s
                wave.device_seconds += device_s
                observe_device_wave(
                    getattr(seg.feed, "device_index", -1), seg.count,
                    wave.total, host_s, device_s,
                )
                if tracer is not None and seg.trace is not None:
                    # DEVICE_COLLECT is stamped inside feed.collect()
                    # between device collect and apply, so stage order
                    # matches the baseline drain
                    tracer.waves.segment_collected(
                        seg.trace, host_s, device_s
                    )
            except Exception as e:  # noqa: BLE001 - one partition's
                # collect failure must not strand the other segments'
                # responses; re-raised after the loop
                error = e
            finally:
                if state is not None:
                    state.inflight = max(0, state.inflight - seg.count)
        if tracer is not None and wave.trace is not None:
            tracer.waves.end(wave.trace)
        self._check_slow_wave(wave)
        observe_shared_wave(
            wave.total, self.wave_size, len(wave.segments),
            wave.host_seconds, wave.device_seconds,
        )
        devices = set()
        for seg in wave.segments:
            if not seg.count:
                continue
            span = getattr(seg.feed, "device_indices", None)
            if span:
                # a sharded-state segment computes on its WHOLE span
                devices.update(span)
                # per-shard fill accounting (sharded-state v2): what each
                # plan device actually staged for this segment — under
                # resident routing a routed wave fills ONE lane, and this
                # is where that concentration becomes visible per device
                # (the fill was snapshotted at THIS segment's dispatch)
                if seg.shard_fill:
                    observe_shard_fill(span, seg.shard_fill)
            else:
                devices.add(getattr(seg.feed, "device_index", -1))
        devices.discard(-1)
        if devices:
            # >1 here means this wave's compute overlapped across the mesh
            observe_mesh_wave(len(devices))
        if error is not None:
            raise error

    def _check_slow_wave(self, wave: SharedWave) -> None:
        """Slow-wave watchdog: a wave whose host+device time exceeds the
        threshold is counted + flight-recorded, and the FIRST one of an
        episode logs the recorder slice (the next fast wave re-arms the
        warning). The threshold is the scheduler's own slowWaveMs when
        configured (honored even with [tracing] enabled=false), else the
        tracer's; with neither the watchdog defaults to 5s."""
        threshold_ms = self.slow_wave_ms
        if threshold_ms is None:
            tracer = tracing.TRACER
            threshold_ms = tracer.slow_wave_ms if tracer is not None else 5000
        threshold_s = threshold_ms / 1000.0
        duration = wave.host_seconds + wave.device_seconds
        if duration <= threshold_s:
            self._slow_wave_warned = False
            return
        count_event(
            "serving_slow_waves",
            "Waves whose host+device time exceeded the slow-wave "
            "watchdog threshold",
        )
        record_event(
            "stall", "slow wave", records=wave.total,
            segments=len(wave.segments),
            host_s=round(wave.host_seconds, 4),
            device_s=round(wave.device_seconds, 4),
        )
        if not self._slow_wave_warned:
            self._slow_wave_warned = True
            logger.warning(
                "slow wave: %d records across %d segments took %.2fs "
                "(host %.2fs / device %.2fs, threshold %.1fs); recent "
                "flight-recorder events:\n%s",
                wave.total, len(wave.segments), duration,
                wave.host_seconds, wave.device_seconds, threshold_s,
                FLIGHT.format_slice(last=25),
            )

    def drain(self, max_records: Optional[int] = None) -> int:
        """Pack + dispatch shared waves until every feed runs dry, double-
        buffering: wave N+1 dispatches (host staging overlaps device
        compute of wave N) before wave N collects. Returns records
        drained. The ``finally`` collects every in-flight wave even when a
        dispatch or collect raises — dispatched records are consumed into
        engine state and their responses must land."""
        total = 0
        inflight: List[SharedWave] = []
        try:
            while True:
                wave = self._pack()
                if wave is None:
                    if inflight:
                        # every feed empty OR backpressured: collecting
                        # the oldest in-flight wave frees its in-flight
                        # budget (and may commit follow-ups) — then retry
                        self._collect(inflight.pop(0))
                        continue
                    break
                inflight.append(wave)
                try:
                    self._dispatch(wave)
                finally:
                    total += wave.total
                while len(inflight) > 1:
                    self._collect(inflight.pop(0))
                if max_records is not None and total >= max_records:
                    break
        finally:
            while inflight:
                self._collect(inflight.pop(0))
        return total

    # -- time-driven sweeps -------------------------------------------------
    def tick(self) -> None:
        """Deadline-probe sweeps for every registered feed: the resulting
        commands append through each feed's own partition and re-enter the
        shared waves as committed records."""
        for pid in list(self._order):
            state = self._feeds.get(pid)
            if state is not None:
                state.feed.tick()


def _concat(a, b):  # noqa: D401
    """Concatenate two taken spans preserving laziness (RecordsView
    entries stay lazy; plain lists concatenate)."""
    from zeebe_tpu_torch.protocol.columnar import RecordsView

    if isinstance(a, RecordsView) or isinstance(b, RecordsView):
        ea = a._entries if isinstance(a, RecordsView) else list(a)
        eb = b._entries if isinstance(b, RecordsView) else list(b)
        return RecordsView(ea + eb)
    return list(a) + list(b)
