"""Exporter API: the broker-side egress contract.

Reference parity: ``exporter/src/main/java/io/zeebe/exporter/*`` — an
exporter is configured (``Exporter#configure(Context)``), opened with a
controller handle (``Exporter#open(Controller)``), receives committed
records, and acknowledges progress through
``Controller#updateLastExportedRecordPosition``; the broker deletes log
segments only below the minimum acknowledged position across exporters.

Differences from the reference, driven by the TPU architecture:

- **Batched delivery.** The engine's throughput comes from SIMD batches;
  per-record `export(record)` calls would serialize the egress path, so the
  contract is ``export_batch(records)`` — an ordered slice of the committed
  stream. Delivery is at-least-once, in order, gap-free per exporter.
- **Replicated positions.** Acked positions are persisted as EXPORTER
  ACKNOWLEDGE records on the partition's own replicated log (not a local
  column store), so a new raft leader resumes exactly from the old
  leader's progress.

An exporter that raises from ``export_batch`` is retried with exponential
backoff on the same batch; other exporters are unaffected (failure
isolation). A durably failing exporter pins the partition's compaction
floor and fires a stall warning — it never blocks processing or the other
exporters.
"""

from __future__ import annotations

import base64
import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import INTENTS_BY_VALUE_TYPE
from zeebe_tpu_torch.protocol.records import Record


@dataclasses.dataclass
class ExporterContext:
    """Configure-time context (reference ``Exporter.Context``): the
    exporter's configured id, its raw ``args`` table from ``[[exporters]]``
    config, and the partition it serves."""

    exporter_id: str
    args: Dict[str, Any]
    partition_id: int = 0
    logger: Optional[logging.Logger] = None
    clock: Optional[Callable[[], int]] = None  # ms

    def log(self) -> logging.Logger:
        return self.logger or logging.getLogger(
            f"zeebe_tpu.exporter.{self.exporter_id}"
        )


class ExporterController:
    """Open-time handle (reference ``Exporter.Controller``): position acks
    and scheduled callbacks, both routed through the owning director."""

    def __init__(self, update_position: Callable[[int], None],
                 schedule: Callable[[int, Callable[[], None]], None],
                 acked_position: int = -1):
        self._update_position = update_position
        self._schedule = schedule
        # the durably acked position this exporter resumes from — lets a
        # file-backed sink detect on open that its recovered tail is
        # BEHIND the ack (un-fsynced lines lost to an OS crash: the
        # director will not re-deliver below the ack, so the sink should
        # report the hole rather than silently continue)
        self.acked_position = acked_position

    def update_position(self, position: int) -> None:
        """Acknowledge that every record up to ``position`` (inclusive) is
        durably exported. Only meaningful for ``MANUAL_ACK`` exporters —
        auto-ack exporters are acked by the director when ``export_batch``
        returns. Monotonic; a lower position is ignored."""
        self._update_position(position)

    def schedule(self, delay_ms: int, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the director's pump after at least ``delay_ms``
        (reference ``Controller#scheduleTask`` — used by exporters for
        their own flush/retry timers)."""
        self._schedule(delay_ms, fn)


class Exporter:
    """Base exporter (reference ``io.zeebe.exporter.Exporter``). Override
    the lifecycle hooks; all run on the director (one thread at a time).

    Set ``MANUAL_ACK = True`` for asynchronous sinks: the director then
    keeps delivering batches but only persists the position the exporter
    confirms via ``controller.update_position`` — after a crash the stream
    replays from that confirmed position (at-least-once)."""

    MANUAL_ACK = False

    def configure(self, context: ExporterContext) -> None:  # noqa: B027
        """Validate args, capture the context. Raising fails the director
        open loudly (a misconfigured exporter must not silently no-op)."""

    def open(self, controller: ExporterController) -> None:  # noqa: B027
        """Acquire resources. Called once per leadership install."""

    def export_batch(self, records) -> None:
        """Handle an ordered batch of committed records. ``records`` is a
        sequence of ``Record`` objects — on the hot path a COLUMNAR view
        (``protocol.columnar.RecordsView``): iterating/indexing yields
        ``Record`` rows, while the column accessors (``positions()``,
        ``value_types()``, ``record_types()``, ``intents()``,
        ``timestamps()``) read scalar columns without materializing any
        row (the metrics exporter needs nothing else; a file sink can
        dedup by the position column before touching rows). Raising keeps
        the position where it was; the director retries the same batch
        with backoff."""
        raise NotImplementedError

    def close(self) -> None:  # noqa: B027
        """Release resources (leadership step-down or broker shutdown)."""


# ---------------------------------------------------------------------------
# record → plain-data document (shared by the JSONL exporter and its replay
# verifier; json-safe: bytes become {"$bytes": base64})
# ---------------------------------------------------------------------------


def _json_safe(v: Any) -> Any:
    if isinstance(v, bytes):
        return {"$bytes": base64.b64encode(v).decode("ascii")}
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


def intent_name(value_type: int, intent: int) -> str:
    """Human-readable intent for metrics labels / audit docs; falls back to
    the wire integer for unknown combinations."""
    try:
        enum_cls = INTENTS_BY_VALUE_TYPE.get(ValueType(value_type))
        if enum_cls is not None:
            return enum_cls(intent).name
    except ValueError:
        pass
    return str(intent)


def record_to_doc(record: Record) -> Dict[str, Any]:
    """A log record as a stable, json-safe document (the JSONL audit line).
    Field names follow the reference's exported-record JSON shape."""
    md = record.metadata
    vt = int(md.value_type)
    doc = {
        "position": record.position,
        "sourceRecordPosition": record.source_record_position,
        "key": record.key,
        "timestamp": record.timestamp,
        "raftTerm": record.raft_term,
        "recordType": RecordType(int(md.record_type)).name,
        "valueType": ValueType(vt).name,
        "intent": intent_name(vt, int(md.intent)),
        "value": _json_safe(record.value.to_document())
        if record.value is not None
        else None,
    }
    if int(md.rejection_type) != 255:
        doc["rejectionType"] = int(md.rejection_type)
        doc["rejectionReason"] = md.rejection_reason
    return doc
