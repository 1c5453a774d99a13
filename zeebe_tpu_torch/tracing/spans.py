"""Sampled record-lifecycle spans: position-keyed stage stamps.

The serving plane spans gateway admission → raft group commit → shared
wave scheduler → device kernels → apply → exporter egress; aggregate
counters say *that* a wave was slow, never *which stage of which record's
lifecycle* ate the time. This module is the per-record attribution layer
(the reference analogue: StreamProcessorController's batched loop makes
each stage legible per record; docs/operations/tracing.md is the operator
guide).

Design constraints, in priority order:

1. **Zero cost when off.** Call sites read one module global
   (``tracing.TRACER``) and return; nothing allocates, nothing locks
   (``tests/test_tracing.py`` pins the disabled fast path).
2. **Near-zero cost when on but not sampling.** The sampling decision is
   one float add + compare per command; hot drain loops guard on the
   ``tracer.by_position`` dict's truthiness INLINE (no method call — see
   ``tracking()``) before touching per-record positions.
3. **Deterministic schedules.** Sampling uses a per-partition seeded
   error-accumulator (``acc += rate; sample when acc >= 1``), so which
   arrivals get sampled depends ONLY on (seed, partition, arrival index)
   — a chaos run replayed under the same seed traces the same commands.
4. **Bounded memory.** Live spans per partition are capped
   (``per_partition_budget``); overflow evicts the oldest live span to
   the bounded finished ring (counted, never an error).

A span is keyed twice during its life: by gateway ``request_id`` until
the raft append assigns a log position, then by ``(partition,
position)`` for every post-append hop. Stages are appended as
``(stage, t_us, fields)`` in stamp order; timestamps come from one
process-wide ``perf_counter_ns`` origin so they are monotonic and
directly comparable across threads.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

# -- lifecycle stages (canonical order; reports sort stamps by time, the
# order here is the completeness contract tools/trace_smoke.py checks) ------
GATEWAY_RECV = "gateway_recv"          # command arrived at the client API
ADMISSION = "admission"                # admission verdict (admitted/shed)
ACTOR_ENQUEUE = "actor_enqueue"        # handed to the broker actor
RAFT_QUEUE = "raft_queue"              # entered the raft group-commit queue
RAFT_FSYNC = "raft_fsync"              # group commit appended + fsynced
COMMIT = "commit"                      # raft commit covered the position
FEED_TAKE = "feed_take"                # scheduler feed consumed it
WAVE_DISPATCH = "wave_dispatch"        # packed+dispatched in a device wave
DEVICE_COLLECT = "device_collect"      # device outputs collected
APPLY = "apply"                        # interpreter applied the results
RESPONSE = "response"                  # response/push marshalled
EXPORT_DISPATCH = "exporter_dispatch"  # dispatched to an exporter sink
EXPORT_ACK = "exporter_ack"            # exporter ack durably appended

STAGE_ORDER: Tuple[str, ...] = (
    GATEWAY_RECV, ADMISSION, ACTOR_ENQUEUE, RAFT_QUEUE, RAFT_FSYNC, COMMIT,
    FEED_TAKE, WAVE_DISPATCH, DEVICE_COLLECT, APPLY, RESPONSE,
    EXPORT_DISPATCH, EXPORT_ACK,
)

# one origin per process: stamps are monotonic microseconds since this
_T0_NS = time.perf_counter_ns()
# wall-clock instant of the span timebase's zero (captured back-to-back
# with _T0_NS): lets trace_report place the flight recorder's wall-clock
# events on the same timeline as span/wave perf-counter stamps
_T0_WALL = time.time()


def now_us() -> int:
    return (time.perf_counter_ns() - _T0_NS) // 1000


class Span:
    """One sampled record's lifecycle. Mutated only under the tracer lock."""

    __slots__ = (
        "trace_id", "partition", "position", "request_id", "stages",
        "finished", "_commit_warned",
    )

    def __init__(self, trace_id: int, partition: int):
        self.trace_id = trace_id
        self.partition = partition
        self.position = -1
        self.request_id = -1
        # (stage, t_us, fields-or-None) in stamp order
        self.stages: List[tuple] = []
        self.finished = False
        self._commit_warned = False

    def stamp(self, stage: str, fields: Optional[dict] = None) -> None:
        self.stages.append((stage, now_us(), fields))

    def stage_names(self) -> List[str]:
        return [s[0] for s in self.stages]

    def stage_ts(self, stage: str) -> Optional[int]:
        for name, ts, _fields in self.stages:
            if name == stage:
                return ts
        return None

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "partition": self.partition,
            "position": self.position,
            "request_id": self.request_id,
            "stages": [
                {"stage": name, "t_us": ts, **(fields or {})}
                for name, ts, fields in self.stages
            ],
        }


class WaveTimeline:
    """Bounded ring of per-wave trace events (one dict per shared wave:
    dispatch/collect timestamps per device segment, fill, host/device time
    split) — the Perfetto per-device track source.

    Waves are SAMPLED at a stride derived from the tracer's sample rate
    (every wave at rate 1.0): an in-process drain can run thousands of
    near-empty waves per second, and recording a timeline for each one
    degenerates to per-record allocation — exactly what the ≤2% overhead
    gate forbids. ``wave_id`` stays the GLOBAL wave sequence number, so
    recorded timelines remain positioned in the stream."""

    def __init__(self, capacity: int = 2048, stride: int = 1):
        self._ring: deque = deque(maxlen=max(16, capacity))
        self.stride = max(1, int(stride))
        import itertools

        self.seq = itertools.count()  # GIL-atomic wave sequence
        # no lock: begin()/segment()/snapshot() rely on GIL-atomic deque
        # append and single-writer dict mutation (the scheduler thread)

    def begin(self, wave_id: int, capacity: int) -> dict:
        """Record a timeline for an already stride-selected wave. The
        dispatcher draws ``wave_id`` from ``next(waves.seq)`` and checks
        ``wave_id % waves.stride`` inline — on the 1-record-wave
        degenerate path even one extra method call per wave is measurable
        against the ≤2% overhead gate."""
        event = {
            "wave_id": wave_id,
            "t_dispatch_us": now_us(),
            "t_collect_us": -1,
            "capacity": capacity,
            "records": 0,
            "segments": [],
        }
        self._ring.append(event)
        return event

    @staticmethod
    def segment(event: dict, partition: int, device: int, records: int) -> dict:
        seg = {
            "partition": partition,
            "device": device,
            "records": records,
            "t_dispatch_us": now_us(),
            "t_collect_us": -1,
            "host_s": 0.0,
            "device_s": 0.0,
        }
        event["segments"].append(seg)
        event["records"] += records
        return seg

    @staticmethod
    def segment_collected(seg: dict, host_s: float, device_s: float) -> None:
        seg["t_collect_us"] = now_us()
        seg["host_s"] = host_s
        seg["device_s"] = device_s

    @staticmethod
    def end(event: dict) -> None:
        event["t_collect_us"] = now_us()

    def snapshot(self) -> List[dict]:
        return list(self._ring)


class RecordTracer:
    """The per-process span store. One instance serves every broker in the
    process (tests run several in one interpreter); spans are partitioned
    by partition id, and stamps are cheap enough to share."""

    def __init__(
        self,
        sample_rate: float = 0.01,
        seed: int = 0,
        per_partition_budget: int = 256,
        finished_capacity: int = 4096,
        commit_stall_ms: int = 5000,
        slow_wave_ms: int = 5000,
    ):
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self.seed = int(seed)
        self.per_partition_budget = max(1, int(per_partition_budget))
        self.commit_stall_ms = int(commit_stall_ms)
        self.slow_wave_ms = int(slow_wave_ms)
        self._lock = threading.Lock()
        # the sampling decision runs on transport threads for EVERY
        # command; its state lives under its own tiny lock so the 99%
        # not-sampled case never waits behind wave stamping or ack sweeps
        self._sample_lock = threading.Lock()
        self._next_trace_id = 0
        # per-partition deterministic sampling state: accumulator starts at
        # a seeded phase so rate=0.5 doesn't always pick even arrivals
        self._acc: Dict[int, float] = {}
        # live spans: request_id → span (pre-append), (pid, pos) → span
        self.by_request: Dict[int, Span] = {}
        self.by_position: Dict[Tuple[int, int], Span] = {}
        # spans appended+fsynced but not yet committed, per partition
        self._await_commit: Dict[int, Dict[int, Span]] = {}
        # live spans per partition in sampling order (budget eviction)
        self._live: Dict[int, OrderedDict] = {}
        self.finished: deque = deque(maxlen=max(16, finished_capacity))
        # wave-timeline stride follows the span sample rate (all waves at
        # rate 1.0, 1-in-100 at the default 0.01), capped so SOME waves
        # always record
        stride = 1
        if self.sample_rate <= 0.0:
            stride = 1000  # spans off: keep only a sparse wave pulse
        elif self.sample_rate < 1.0:
            stride = min(1000, max(1, round(1.0 / self.sample_rate)))
        self.waves = WaveTimeline(stride=stride)
        self._dropped = 0
        self._sampled = 0

    # -- sampling ----------------------------------------------------------
    def maybe_sample(self, partition: int) -> Optional[Span]:
        """The gateway-receive decision point: returns a new span (with
        GATEWAY_RECV stamped) for sampled arrivals, None otherwise. The
        decision sequence per partition depends only on (seed, partition,
        arrival index) — deterministic across replays."""
        rate = self.sample_rate
        if rate <= 0.0:
            return None
        with self._sample_lock:
            acc = self._acc.get(partition)
            if acc is None:
                acc = random.Random(
                    (self.seed << 16) ^ (partition & 0xFFFF)
                ).random()
            acc += rate
            if acc < 1.0:
                self._acc[partition] = acc
                return None
            self._acc[partition] = acc - 1.0
        with self._lock:
            span = Span(self._next_trace_id, partition)
            self._next_trace_id += 1
            self._sampled += 1
            live = self._live.setdefault(partition, OrderedDict())
            live[span.trace_id] = span
            while len(live) > self.per_partition_budget:
                _tid, evicted = live.popitem(last=False)
                self._evict(evicted)
        span.stamp(GATEWAY_RECV)
        return span

    def _evict(self, span: Span) -> None:
        # caller holds the lock; the span is already popped from _live
        self._dropped += 1
        self._unindex(span)
        span.finished = True
        self.finished.append(span)

    def _finish_locked(self, span: Span) -> None:
        """The one span-termination sequence (caller holds the lock):
        mark finished, drop from the live budget, unindex, move to the
        finished ring. Every terminal path MUST go through here — a
        missed step is exactly the 'unfinishable span pins tracking()
        true' leak this module exists to avoid."""
        span.finished = True
        live = self._live.get(span.partition)
        if live is not None:
            live.pop(span.trace_id, None)
        self._unindex(span)
        self.finished.append(span)

    def _unindex(self, span: Span) -> None:
        if span.request_id >= 0:
            self.by_request.pop(span.request_id, None)
        if span.position >= 0:
            self.by_position.pop((span.partition, span.position), None)
            waiting = self._await_commit.get(span.partition)
            if waiting is not None:
                waiting.pop(span.position, None)

    # -- fast-path guards --------------------------------------------------
    def tracking(self) -> bool:
        """True when any live span is position-indexed. Hot drain loops
        read ``tracer.by_position`` directly instead of calling this —
        at ~4 guard checks per record the method-call overhead alone is
        measurable against the ≤2% gate; this wrapper is for tests and
        cold callers."""
        return bool(self.by_position)

    def tracking_requests(self) -> bool:
        return bool(self.by_request)

    # -- stamping ----------------------------------------------------------
    def stamp(self, span: Span, stage: str, **fields) -> None:
        with self._lock:
            span.stamp(stage, fields or None)

    def finish(self, span: Span, stage: Optional[str] = None,
               **fields) -> None:
        """Terminate a span whose lifecycle ends early (admission shed,
        NOT_LEADER, duplicate command, malformed frame): stamp the
        optional final stage, unindex, move to the finished ring —
        abandoned spans must not sit in the live budget evicting real
        traces exactly when the system is overloaded."""
        with self._lock:
            if span.finished:
                return
            if stage is not None:
                span.stamp(stage, fields or None)
            self._finish_locked(span)

    def bind_request(self, span: Span, request_id: int, partition: int) -> None:
        with self._lock:
            span.request_id = request_id
            span.partition = partition
            if not span.finished:  # evicted between sample and bind
                self.by_request[request_id] = span

    def stamp_request(self, request_id: int, stage: str,
                      final: bool = False, **fields) -> None:
        """Stamp by request id. ``final=True`` finishes the span (brokers
        WITHOUT an exporter plane pass it at RESPONSE — no ack will ever
        come, and a span that can never finish would pin ``tracking()``
        true and keep every per-record stamp path hot forever)."""
        with self._lock:
            span = self.by_request.get(request_id)
            if span is None:
                return
            span.stamp(stage, fields or None)
            if final:
                self._finish_locked(span)

    def finish_positions(self, partition: int, positions) -> None:
        """A broker with no exporter plane just applied these positions:
        that apply (or the response stamped moments before) is the LAST
        stage their spans can ever reach — no ack will come. Finish any
        still-live span here, because one unfinishable span pins
        ``tracking()`` true and keeps every per-record stamp path hot for
        the rest of the process (the ≤2% overhead gate caught exactly
        this: deterministic stride sampling kept landing on response-less
        internal commands)."""
        by_pos = self.by_position
        if not by_pos:
            return
        matched = []
        for pos in positions:
            span = by_pos.get((partition, pos))
            if span is not None:
                matched.append(span)
        if not matched:
            return
        with self._lock:
            for span in matched:
                if not span.finished:
                    self._finish_locked(span)

    def truncate_positions_from(self, partition: int, position: int,
                                only=None) -> None:
        """A new leader's replication truncated this partition's log from
        ``position`` on: the records those spans were bound to no longer
        exist, and the positions will be REUSED by the new leader's
        records. Finish the affected spans (stamped with the truncation)
        so a later commit covering the reused position cannot stamp
        COMMIT onto a command that actually failed, and so the dead span
        does not sit in the live budget evicting real traces. ``only``
        restricts the sweep to the caller's OWN bound positions — the
        tracer is process-global, and an in-process follower's truncate
        must not finish the authoritative leader's live spans."""
        if not self.by_position:
            return
        with self._lock:
            live = self._live.get(partition)
            if not live:
                return
            cut = [
                span for span in live.values()
                if span.position >= position
                and (only is None or span.position in only)
            ]
            for span in cut:
                span.stamp("truncated", {"from": position})
                self._finish_locked(span)

    def finish_partition_spans(self, partition: int, reason: str) -> None:
        """Leadership left this partition on this node: its live spans
        can never progress here (drain/apply/response/export are
        leader-side), and a stranded span would keep every per-record
        stamp path hot until budget eviction. Finish them with a terminal
        ``orphaned`` marker."""
        if not self.by_position:
            return
        with self._lock:
            live = self._live.get(partition)
            if not live:
                return
            for span in list(live.values()):
                span.stamp("orphaned", {"reason": reason})
                self._finish_locked(span)

    def bind_append(self, request_id: int, partition: int, position: int) -> bool:
        """Raft group commit assigned the record's log position (and the
        group fsync just landed): re-key the span by position. First bind
        wins — a command's FOLLOW-UP records reuse its request id (that is
        how the response frame finds its request), and the span tracks
        the sampled command record itself; the follow-up's append/commit
        shows up as the apply→response gap. Returns whether a span was
        bound (the appender remembers its own bound positions for
        truncation cleanup)."""
        with self._lock:
            span = self.by_request.get(request_id)
            if span is None or span.position >= 0:
                return False
            span.position = position
            span.partition = partition
            self.by_position[(partition, position)] = span
            self._await_commit.setdefault(partition, {})[position] = span
            span.stamp(RAFT_FSYNC)
            return True

    def bind_position(self, span: Span, partition: int, position: int,
                      committed: bool = False) -> None:
        """Single-writer brokers (no raft): the append IS the commit."""
        with self._lock:
            span.position = position
            span.partition = partition
            if span.finished:  # evicted between sample and bind
                return
            self.by_position[(partition, position)] = span
            if committed:
                span.stamp(COMMIT)
            else:
                self._await_commit.setdefault(partition, {})[position] = span

    def on_commit(self, partition: int, commit_position: int) -> None:
        """Raft advanced the commit position: stamp COMMIT on every span
        at or below it."""
        waiting = self._await_commit.get(partition)
        if not waiting:
            return
        with self._lock:
            done = [p for p in waiting if p <= commit_position]
            for pos in done:
                span = waiting.pop(pos)
                span.stamp(COMMIT)

    def stamp_positions(self, partition: int, positions, stage: str,
                        **fields) -> None:
        """Stamp ``stage`` on every traced position in a drained span/wave
        segment. The caller guards with ``tracking()``; the wave-length
        lookup loop runs LOCK-FREE (dict reads are GIL-atomic; a racing
        pop just misses) and the lock is taken only for the rare
        matches — a 512-record wave must not hold the tracer lock the
        transport threads sample under."""
        by_pos = self.by_position
        if not by_pos:
            return
        matched = []
        for pos in positions:
            span = by_pos.get((partition, pos))
            if span is not None:
                matched.append(span)
        if not matched:
            return
        f = fields or None
        with self._lock:
            for span in matched:
                span.stamp(stage, f)

    def ack_exported(self, partition: int, ack_position: int) -> None:
        """An exporter ack covered everything at or below ``ack_position``:
        stamp EXPORT_ACK and finish those spans (the lifecycle's last
        hop). The sweep walks only the ACKED partition's live spans
        (bounded by its budget), never the whole position index."""
        if not self.by_position:
            return
        with self._lock:
            live = self._live.get(partition)
            if not live:
                return
            done = [
                span for span in live.values()
                if 0 <= span.position <= ack_position
                # only finish spans the exporter actually dispatched —
                # an ack can race a span still mid-drain
                and EXPORT_DISPATCH in span.stage_names()
            ]
            for span in done:
                span.stamp(EXPORT_ACK)
                self._finish_locked(span)

    # -- stall detection ---------------------------------------------------
    def check_commit_stalls(self, partitions=None) -> List[Span]:
        """Sampled commands appended (RAFT_FSYNC/queue stamped) but not
        committed within ``commit_stall_ms``: the commit-latency watchdog.
        Returns newly stalled spans (each reported once). ``partitions``
        restricts the sweep — on a process-global tracer shared by several
        in-process brokers, each broker claims only the partitions it
        leads, so the warning names the node actually sitting on the
        stall."""
        stalled: List[Span] = []
        threshold_us = self.commit_stall_ms * 1000
        now = now_us()
        with self._lock:
            for pid, waiting in self._await_commit.items():
                if partitions is not None and pid not in partitions:
                    continue
                for span in waiting.values():
                    if span._commit_warned:
                        continue
                    ts = span.stage_ts(RAFT_FSYNC) or span.stage_ts(RAFT_QUEUE)
                    if ts is not None and now - ts > threshold_us:
                        span._commit_warned = True
                        stalled.append(span)
        return stalled

    # -- reporting ---------------------------------------------------------
    def spans(self) -> List[Span]:
        """All spans, live and finished, oldest first."""
        with self._lock:
            live = [
                span
                for per_pid in self._live.values()
                for span in per_pid.values()
            ]
            return sorted(
                list(self.finished) + live, key=lambda s: s.trace_id
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "sampled": self._sampled,
                "dropped": self._dropped,
                "live": sum(len(v) for v in self._live.values()),
                "finished": len(self.finished),
            }

    def dump(self, path: str) -> str:
        """Write spans + wave timelines + the flight-recorder ring as one
        JSON document (the ``tools/trace_report.py`` input format)."""
        import json

        from zeebe_tpu_torch.tracing.recorder import FLIGHT

        doc = {
            "format": "zeebe-tpu-trace-v1",
            "span_t0_wall": round(_T0_WALL, 6),
            "stats": self.stats(),
            "spans": [span.to_dict() for span in self.spans()],
            "waves": self.waves.snapshot(),
            "events": FLIGHT.snapshot(),
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
