"""ExporterDirector: per-partition committed-stream fan-out to exporters.

Reference parity: ``broker-core/.../exporter/ExporterDirector`` (one
director per partition tails the committed log, dispatches to every
configured exporter, persists per-exporter positions, and bounds segment
deletion by their minimum). Differences here:

- **Batched dispatch** (``export_batch``) instead of per-record calls —
  the same batch-first shape as the device engine's drain loop.
- **Replicated positions**: acks are EXPORTER ACKNOWLEDGE records appended
  to the partition's own log (raft-replicated on clusters), folded into
  engine state by the interpreter, snapshotted with it, and recovered by
  the same snapshot+replay path as everything else. A new leader's
  director reads ``engine.exporter_positions`` and resumes without gaps.
- **Failure isolation**: each exporter has its own cursor, retry backoff
  and stall tracking; one failing exporter never blocks the others (it
  pins the compaction floor and fires a stall warning instead).

The director core is threading-agnostic (``pump()`` is a plain method);
the in-process ``Broker`` pumps it inside ``run_until_idle`` while the
cluster broker drives it from an actor (``ExporterDirectorActor``) hooked
to the log's commit signal.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from zeebe_tpu_torch.exporter.base import Exporter, ExporterContext, ExporterController
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import ExporterIntent
from zeebe_tpu_torch.protocol.metadata import RecordMetadata
from zeebe_tpu_torch.protocol.records import ExporterPositionRecord, Record
from zeebe_tpu_torch.runtime.actors import Actor
from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY, count_event
from zeebe_tpu_torch import tracing

logger = logging.getLogger(__name__)

# records exporters never see: the exporter plane's own ack traffic (a
# dispatched ack would ack itself forever); positions still advance past
# them
_HIDDEN_VALUE_TYPES = {int(ValueType.EXPORTER)}


def fold_tail_acks(positions: Dict[str, int], log, from_position: int) -> Dict[str, int]:
    """Recovered ``engine.exporter_positions`` + EXPORTER acks in the log
    tail the replay boundary has not folded in yet (acks produce no
    follow-ups, so they never extend the boundary; without this scan a
    restart re-opens at the last SNAPSHOTTED ack and re-exports the whole
    tail). The scan deliberately covers the WHOLE local tail, not just the
    committed prefix: right after a restart the leadership install can run
    before raft re-advances the commit position over the recovered log,
    and stopping there resumes from a stale snapshot ack (duplicate
    burst). Trusting a not-yet-recommitted ack is safe — its VALUE only
    attests records that were already committed and exported when the ack
    was written, so no gap can result even if raft later truncates the ack
    record itself (the next real ack re-persists a higher position)."""
    out = dict(positions)
    try:
        reader = log.reader(max(0, from_position))
    except Exception:  # noqa: BLE001 - scan is best-effort (at-least-once)
        return out
    for record in reader:
        md = record.metadata
        if (
            int(md.value_type) != int(ValueType.EXPORTER)
            or int(md.record_type) != int(RecordType.COMMAND)
            or record.value is None
            or not record.value.exporter_id
        ):
            continue
        if int(md.intent) == int(ExporterIntent.ACKNOWLEDGE):
            prior = out.get(record.value.exporter_id)
            if prior is None or record.value.position > prior:
                out[record.value.exporter_id] = record.value.position
        elif int(md.intent) == int(ExporterIntent.REMOVE):
            out.pop(record.value.exporter_id, None)
    return out


def ack_record(
    exporter_id: str, position: int,
    intent: ExporterIntent = ExporterIntent.ACKNOWLEDGE,
) -> Record:
    return Record(
        metadata=RecordMetadata(
            record_type=RecordType.COMMAND,
            value_type=ValueType.EXPORTER,
            intent=int(intent),
        ),
        value=ExporterPositionRecord(
            exporter_id=exporter_id, position=position
        ),
    )


def remove_stale_positions(
    positions: Dict[str, int], configured,
) -> List[Record]:
    """REMOVE records for recovered exporter ids no longer in the
    configured set — deconfiguring an exporter must actually release its
    compaction pin, INCLUDING when the last exporter was removed (the
    brokers call this with an empty ``configured`` set when no director
    is installed at all)."""
    return [
        ack_record(stale_id, -1, ExporterIntent.REMOVE)
        for stale_id in sorted(set(positions) - set(configured))
    ]


class ExporterHandle:
    """One exporter's dispatch state inside a director."""

    def __init__(self, exporter_id: str, exporter: Exporter, position: int):
        self.id = exporter_id
        self.exporter = exporter
        # last durably acked position (mirrors engine.exporter_positions)
        self.position = position
        # like .position but advanced only when the ack's append COMMITS
        # (_append_acks on_durable): tracing's EXPORT_ACK keys off this,
        # never off the optimistic in-flight value
        self.durable_position = position
        # next read position; >= position+1 (runs ahead over hidden/admin
        # records and, for MANUAL_ACK exporters, over delivered batches)
        self.cursor = position + 1
        self.failures = 0
        self.retry_at_ms = 0
        self.last_advance_ms: Optional[int] = None
        self.stall_warned = False
        self.broken: Optional[str] = None  # open/configure failed: reason
        # MANUAL_ACK exporters confirm through the controller
        self.manual_position = position
        self.controller: Optional[ExporterController] = None
        # registry handles resolved once (the pump is the hot loop — no
        # global-registry lock round-trip per batch)
        self.exported_counter = None
        self.failure_counter = None


class ExporterDirector:
    """Tails one partition's committed records into N exporters."""

    BATCH_SIZE = 512
    INITIAL_BACKOFF_MS = 100
    MAX_BACKOFF_MS = 10_000
    # a floor-pinning exporter that has not advanced for this long fires
    # the stall warning (once per stall episode)
    STALL_AFTER_MS = 10_000

    def __init__(
        self,
        partition_id: int,
        log,
        exporters: List[Tuple[str, Exporter]],
        append_fn: Callable[[List[Record]], object],
        clock: Optional[Callable[[], int]] = None,
        node_label: str = "",
    ):
        self.partition_id = partition_id
        self.log = log
        self.append_fn = append_fn
        self.clock = clock or (lambda: int(time.time() * 1000))
        self.node_label = node_label
        self.handles: List[ExporterHandle] = []
        self._exporters = list(exporters)
        self._scheduled: List[Tuple[int, Callable[[], None]]] = []
        self.closed = False
        self._lag_gauges: Dict[str, object] = {}
        # last visible committed position, cached per commit position (the
        # backwards scan only walks the trailing run of hidden ack records)
        self._lv_cache = -1
        self._lv_cache_commit = -1

    def can_ack(self) -> bool:
        """Whether ANY exporter can still advance an ack. A handle whose
        open/configure raised is broken for the life of the director —
        when every handle is, no ack will ever arrive, and tracing must
        treat the response/apply as a span's final stage (an unfinishable
        span keeps every per-record stamp path hot forever)."""
        return any(h.broken is None for h in self.handles)

    def dispatch_passed(self, position: int) -> bool:
        """Every live exporter's read cursor is already beyond
        ``position``: no future dispatch will stamp it, so a span that
        missed its dispatch window (bound after the pump raced past) can
        never be finished by an ack — ``ack_exported`` requires an
        EXPORT_DISPATCH stamp. The caller closes such a span instead of
        leaking it."""
        live = [h for h in self.handles if h.broken is None]
        return bool(live) and all(h.cursor > position for h in live)

    # -- lifecycle ----------------------------------------------------------
    def open(self, positions: Dict[str, int]) -> None:
        """Configure+open every exporter, resuming each at its recovered
        acked position (``engine.exporter_positions``); exporters never
        seen before are REGISTERED with an ack at -1 so the compaction
        floor pins the whole log until their first real ack commits."""
        now = self.clock()
        register: List[Record] = []
        # recovered ids no longer configured: append REMOVE so their stale
        # positions (possibly a -1 registration that never acked) stop
        # pinning the compaction floor — deconfiguring an exporter must
        # actually release its pin
        configured = {exporter_id for exporter_id, _ in self._exporters}
        register.extend(remove_stale_positions(positions, configured))
        for exporter_id, exporter in self._exporters:
            acked = positions.get(exporter_id)
            handle = ExporterHandle(
                exporter_id, exporter, -1 if acked is None else acked
            )
            handle.last_advance_ms = now
            self.handles.append(handle)
            if acked is None:
                register.append(self._ack_record(exporter_id, -1))
            try:
                context = ExporterContext(
                    exporter_id=exporter_id,
                    args=getattr(exporter, "_cfg_args", {}) or {},
                    partition_id=self.partition_id,
                    clock=self.clock,
                )
                exporter.configure(context)
                handle.controller = ExporterController(
                    update_position=lambda pos, h=handle: self._manual_ack(h, pos),
                    schedule=self._schedule,
                    acked_position=handle.position,
                )
                exporter.open(handle.controller)
            except Exception as e:  # noqa: BLE001 - isolation: a broken
                # exporter must not take down the partition; it pins the
                # floor (stall warning) until fixed or deconfigured
                handle.broken = repr(e)
                count_event(
                    "exporter_open_failures",
                    "Exporters whose configure/open raised",
                )
                logger.error(
                    "exporter %r on partition %d failed to open "
                    "(floor stays pinned at its last ack): %r",
                    exporter_id, self.partition_id, e,
                )
        if register:
            self._append_acks(register)
        # the director itself bounds LogStream.compact (second belt next
        # to the engine-state positions, and the only one covering the
        # window before a registration ack commits)
        if hasattr(self.log, "add_floor_provider"):
            self.log.add_floor_provider(self.compaction_floor)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if hasattr(self.log, "remove_floor_provider"):
            self.log.remove_floor_provider(self.compaction_floor)
        # the lag gauges are process-global: left at their last value an
        # ex-leader's /metrics would report a stuck non-zero lag for a
        # partition it no longer serves (false alerts)
        for gauge in self._lag_gauges.values():
            gauge.set(0)
        for handle in self.handles:
            if handle.broken is not None:
                continue
            try:
                handle.exporter.close()
            except Exception as e:  # noqa: BLE001 - shutdown best effort
                logger.warning(
                    "exporter %r close failed: %r", handle.id, e
                )

    # -- position plumbing --------------------------------------------------
    def _ack_record(
        self, exporter_id: str, position: int,
        intent: ExporterIntent = ExporterIntent.ACKNOWLEDGE,
    ) -> Record:
        return ack_record(exporter_id, position, intent)

    def _append_acks(self, records: List[Record], on_durable=None) -> None:
        try:
            result = self.append_fn(records)
        except Exception as e:  # noqa: BLE001 - a deposed leader's append
            # fails; positions simply stay at the last committed ack and
            # the next leader re-exports from there (at-least-once)
            self._ack_append_failed(e)
            return
        # the cluster path (raft.append) reports failure through the
        # returned ActorFuture, never by raising here — observe it, or a
        # deposed leader's lost ack vanishes silently. The handle keeps
        # its optimistic position either way: the director closes on
        # step-down and the NEXT leader resumes from the replicated
        # (committed) state, so at-least-once is unaffected.
        # ``on_durable`` fires only once the ack actually committed
        # (raft futures resolve at commit) — tracing's EXPORT_ACK must
        # not stamp an ack a new leader is about to truncate
        on_complete = getattr(result, "on_complete", None)
        if on_complete is not None:
            on_complete(lambda f: (
                self._ack_append_failed(f._exception)
                if getattr(f, "_exception", None) is not None
                else (on_durable() if on_durable is not None else None)
            ))
        elif on_durable is not None:  # single-writer: append IS commit
            on_durable()

    def _ack_append_failed(self, exc) -> None:
        count_event(
            "exporter_ack_append_failures",
            "Exporter position acks whose log append failed "
            "(typically a deposed leader; re-export covers the gap)",
        )
        logger.debug(
            "exporter ack append failed on partition %d "
            "(re-export will cover the gap): %r", self.partition_id, exc,
        )

    def _manual_ack(self, handle: ExporterHandle, position: int) -> None:
        if position > handle.manual_position:
            handle.manual_position = position

    def _schedule(self, delay_ms: int, fn: Callable[[], None]) -> None:
        self._scheduled.append((self.clock() + max(0, delay_ms), fn))

    def compaction_floor(self) -> int:
        """First position still needed by some exporter (exclusive bound
        for ``LogStream.compact``): nothing above the minimum acked
        position may be dropped — a restart resumes there."""
        floor = None
        for handle in self.handles:
            pinned = handle.position + 1
            floor = pinned if floor is None else min(floor, pinned)
        return floor if floor is not None else (1 << 62)

    # -- the pump -----------------------------------------------------------
    def pump(self) -> bool:
        """One dispatch round over all exporters. Returns True when any
        exporter made durable progress (ack appended) — the in-process
        broker loops until quiescence on this signal."""
        if self.closed:
            return False
        now = self.clock()
        self._run_scheduled(now)
        progress = False
        for handle in self.handles:
            if handle.broken is not None:
                self._update_lag(handle)
                self._maybe_warn_stall(handle, now)
                continue
            if now < handle.retry_at_ms:
                # still refresh the gauge: lag grows fastest exactly when
                # the exporter is failing, and a frozen pre-failure value
                # underreports the backlog for the whole backoff window
                self._update_lag(handle)
                self._maybe_warn_stall(handle, now)
                continue
            progress = self._pump_one(handle, now) or progress
            self._update_lag(handle)
            self._maybe_warn_stall(handle, now)
        return progress

    def _pump_one(self, handle: ExporterHandle, now: int) -> bool:
        commit = self.log.commit_position
        base = self.log.base_position
        if handle.cursor < base:
            # only possible for an exporter configured AFTER compaction
            # already dropped the early log (the floor protects everything
            # else) — resume at the surviving base, count the skip
            # upper bound, not an exact record count: the compacted range
            # is gone, so the positions the plane's own hidden ack records
            # occupied (which this exporter never would have seen) cannot
            # be subtracted out
            count_event(
                "exporter_skipped_compacted",
                "Log positions an exporter could not see (compacted "
                "before it was configured; includes the plane's own "
                "hidden admin records)",
                delta=base - handle.cursor,
            )
            handle.cursor = base
        progress = False
        view_fn = getattr(self.log, "committed_view", None)
        while handle.cursor <= commit:
            if view_fn is not None:
                # columnar read: ONE lock acquisition for the whole batch,
                # hidden-record filtering over the value-type COLUMN — no
                # row materialization before the sink edge
                batch = view_fn(handle.cursor, self.BATCH_SIZE)
                if not len(batch):
                    break
                vts = batch.value_types()
                pos = handle.cursor + len(batch)
                visible = batch.select([
                    i for i, vt in enumerate(vts)
                    if vt not in _HIDDEN_VALUE_TYPES
                ])
            else:  # plain-log fallback (test doubles without the view API)
                plain: List[Record] = []
                pos = handle.cursor
                while pos <= commit and len(plain) < self.BATCH_SIZE:
                    record = self.log.record_at(pos)
                    if record is None:
                        break
                    plain.append(record)
                    pos += 1
                if not plain:
                    break
                visible = [
                    r for r in plain
                    if int(r.metadata.value_type) not in _HIDDEN_VALUE_TYPES
                ]
            if len(visible):
                try:
                    handle.exporter.export_batch(visible)
                except Exception as e:  # noqa: BLE001 - isolate + backoff
                    handle.failures += 1
                    backoff = min(
                        self.INITIAL_BACKOFF_MS * (2 ** (handle.failures - 1)),
                        self.MAX_BACKOFF_MS,
                    )
                    handle.retry_at_ms = now + backoff
                    if handle.failure_counter is None:
                        handle.failure_counter = GLOBAL_REGISTRY.counter(
                            "exporter_export_failures",
                            "export_batch calls that raised",
                            exporter=handle.id,
                            partition=str(self.partition_id),
                        )
                    handle.failure_counter.inc()
                    logger.warning(
                        "exporter %r partition %d failed at position %d "
                        "(retry in %dms, attempt %d): %r",
                        handle.id, self.partition_id, handle.cursor,
                        backoff, handle.failures, e,
                    )
                    return progress
                handle.failures = 0
                if handle.exported_counter is None:
                    handle.exported_counter = GLOBAL_REGISTRY.counter(
                        "exporter_records_exported",
                        "Records dispatched to exporters",
                        exporter=handle.id,
                        partition=str(self.partition_id),
                    )
                handle.exported_counter.inc(len(visible))
                tracer = tracing.TRACER
                if tracer is not None and tracer.by_position:
                    tracer.stamp_positions(
                        self.partition_id, tracing.positions_of(visible),
                        tracing.EXPORT_DISPATCH, exporter=handle.id,
                    )
            handle.cursor = pos
            ack_to = self._ack_target(handle, visible)
            if ack_to > handle.position:
                handle.position = ack_to
                handle.last_advance_ms = now
                handle.stall_warned = False
                self._append_acks(
                    [self._ack_record(handle.id, ack_to)],
                    on_durable=lambda h=handle, a=ack_to:
                        self._ack_durable(h, a),
                )
                progress = True
        # MANUAL_ACK exporters may confirm between pumps without new
        # committed records arriving
        if handle.exporter.MANUAL_ACK and handle.manual_position > handle.position:
            handle.position = handle.manual_position
            handle.last_advance_ms = now
            handle.stall_warned = False
            self._append_acks(
                [self._ack_record(handle.id, handle.position)],
                on_durable=lambda h=handle, a=handle.position:
                    self._ack_durable(h, a),
            )
            progress = True
        return progress

    def _ack_durable(self, handle: ExporterHandle, position: int) -> None:
        """An ack's append COMMITTED (raft future resolved, or the
        single-writer append that is its own commit): only now may
        tracing treat the position as acked — an optimistic in-flight
        ack could still be truncated by a new leader."""
        if position > handle.durable_position:
            handle.durable_position = position
        self._stamp_acked()

    def _stamp_acked(self) -> None:
        """Record-lifecycle tracing: EXPORT_ACK is the lifecycle's final
        stage, so a span finishes only once EVERY exporter's DURABLE ack
        covers its position — the min across handles. Finishing on the
        fastest exporter's ack would unindex the span before slower
        exporters dispatch it, and their egress would vanish from the
        trace."""
        tracer = tracing.TRACER
        if tracer is None or not tracer.by_position:
            return
        # broken exporters never dispatch again, so their frozen cursor
        # must not hold every span open forever; backoff handles recover
        # and DO count
        ack = min(
            (h.durable_position for h in self.handles if h.broken is None),
            default=-1,
        )
        if ack >= 0:
            tracer.ack_exported(self.partition_id, ack)

    def _ack_target(self, handle: ExporterHandle, visible) -> int:
        if handle.exporter.MANUAL_ACK:
            return handle.manual_position
        # auto-ack: a successful batch acks its last VISIBLE record, never
        # a trailing hidden admin position — the replicated ack must point
        # at a record the exporter actually saw (a file sink compares its
        # recovered tail against the ack on open, and an ack sitting on a
        # hidden record would false-report an audit hole after restart).
        # An admin-only batch advances the cursor without an ack (an ack
        # record acking only ack records would ping-pong forever). The
        # position comes from the view's COLUMN — no row materializes.
        if len(visible):
            positions = getattr(visible, "positions", None)
            if positions is not None:
                return positions()[-1]
            return visible[-1].position
        return handle.position

    def _run_scheduled(self, now: int) -> None:
        if not self._scheduled:
            return
        due = [fn for at, fn in self._scheduled if at <= now]
        self._scheduled = [(at, fn) for at, fn in self._scheduled if at > now]
        for fn in due:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - exporter callback
                logger.warning("scheduled exporter callback failed: %r", e)

    # -- observability ------------------------------------------------------
    def _last_visible_commit(self) -> int:
        """Position of the last committed record exporters can SEE (the
        commit position itself usually sits on this plane's own hidden ack
        records — measuring lag/stalls against it reads >=1 forever on a
        fully caught-up exporter and false-warns healthy MANUAL_ACK sinks
        that acked everything visible)."""
        commit = self.log.commit_position
        if commit == self._lv_cache_commit:
            return self._lv_cache
        pos = commit
        base = self.log.base_position
        while pos >= base:
            record = self.log.record_at(pos)
            if record is None or (
                int(record.metadata.value_type) not in _HIDDEN_VALUE_TYPES
            ):
                break
            pos -= 1
        self._lv_cache_commit = commit
        self._lv_cache = pos
        return pos

    def _update_lag(self, handle: ExporterHandle) -> None:
        # gauge resolved once per handle (pump runs on every commit signal
        # plus the retry tick — don't pay the registry lock each time)
        gauge = self._lag_gauges.get(handle.id)
        if gauge is None:
            gauge = GLOBAL_REGISTRY.gauge(
                "exporter_lag",
                "Records behind the commit position, per exporter",
                exporter=handle.id,
                partition=str(self.partition_id),
            )
            self._lag_gauges[handle.id] = gauge
        gauge.set(max(0, self._last_visible_commit() - handle.position))

    def _maybe_warn_stall(self, handle: ExporterHandle, now: int) -> None:
        # "stalled" means NOT advancing the durable position past records
        # it can see: broken, in failure backoff, or a MANUAL_ACK exporter
        # that consumes without confirming (its cursor runs ahead but
        # position stays put — the floor is pinned all the same). Measured
        # against the last VISIBLE record: an exporter acked there is
        # fully caught up even though the raw commit position sits on the
        # trailing hidden ack records.
        behind = self._last_visible_commit() - handle.position
        if behind <= 0:
            return
        floor = self.compaction_floor()
        if handle.position + 1 > floor:
            return  # not the exporter pinning the floor
        if handle.last_advance_ms is None:
            handle.last_advance_ms = now
            return
        if handle.stall_warned or now - handle.last_advance_ms < self.STALL_AFTER_MS:
            return
        handle.stall_warned = True
        count_event(
            "exporter_floor_stalls",
            "Stalled exporters pinning the compaction floor",
        )
        if handle.broken:
            cause = f"broken: {handle.broken}"
        elif handle.failures:
            cause = f"{handle.failures} consecutive failures"
        else:
            # MANUAL_ACK consuming without confirming (or an ack append
            # path that never lands): nothing "failed", progress just
            # never became durable
            cause = "positions never confirmed/durable"
        logger.warning(
            "exporter %r on partition %d is STALLED %d records behind the "
            "last exportable record (%s) and is pinning the compaction "
            "floor at %d — segments cannot be deleted until it recovers",
            handle.id, self.partition_id, behind, cause,
            handle.position + 1,
        )


class ExporterDirectorActor(Actor):
    """Cluster-broker driver: runs the director on its OWN actor, pumped
    on every commit signal plus a periodic retry tick (reference: the
    exporter stream processor runs in its own actor, decoupled from the
    engine's processing actor). Owning the actor is the isolation
    contract's last clause: a custom exporter whose ``export_batch``
    BLOCKS (rather than raises) stalls only this actor — record
    processing, raft, and the other partitions keep running."""

    RETRY_TICK_MS = 100

    def __init__(self, director: ExporterDirector, scheduler) -> None:
        super().__init__(
            f"exporter-{director.node_label or 'p'}-{director.partition_id}"
        )
        self.director = director
        self._scheduler = scheduler
        self._pump_scheduled = False
        self.can_ack = director.can_ack  # tracing's final-stage probe
        self._closing = False
        self._commit_listener = lambda _pos: self.schedule_pump()
        scheduler.submit_actor(self)  # zblint: disable=unobserved-actor-future (boot submit; start failures land in the scheduler failure ring)
        self.director.log.on_commit(self._commit_listener)

    def on_actor_started(self) -> None:
        self._tick()

    def schedule_pump(self) -> None:
        if self._closing or self._pump_scheduled or self.actor is None:
            return
        self._pump_scheduled = True
        self.actor.run(self._pump)

    def _pump(self) -> None:
        self._pump_scheduled = False
        if self._closing:
            return
        self.director.pump()

    def _tick(self) -> None:
        # periodic re-pump: retry backoffs and scheduled exporter
        # callbacks have no commit edge to ride
        if self._closing:
            return
        self.actor.run_delayed(self.RETRY_TICK_MS, self._tick)
        self.schedule_pump()

    def on_actor_closing(self) -> None:
        self.director.close()

    def close(self, wait_s: float = 2.0) -> None:
        """Stop pumping and close the director ON the actor, serialized
        after any in-flight export_batch. Waits briefly so the common
        step-down/shutdown path keeps synchronous close semantics, but a
        blocked exporter cannot hang it past ``wait_s``."""
        if self._closing:
            return
        self._closing = True
        if hasattr(self.director.log, "remove_commit_listener"):
            self.director.log.remove_commit_listener(self._commit_listener)
        done = self._scheduler.close_actor(self)
        try:
            done.join(wait_s)
        except TimeoutError:
            logger.warning(
                "exporter actor %s did not close within %.1fs (a blocked "
                "export_batch?); director close continues in background",
                self.name, wait_s,
            )
