"""In-memory debug exporter (tests / REPL).

Collects every dispatched record. Because cluster leadership churn creates
a FRESH exporter instance per install, records also accumulate into
class-level sinks keyed by exporter id — a chaos test can assert the
at-least-once/in-order/gap-free contract across crash-stop/restart and
leader failover by reading ``InMemoryExporter.sink(<id>)`` (all records
ever exported under that id, in dispatch order) and
``InMemoryExporter.episodes(<id>)`` (one ordered list per exporter
incarnation)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from zeebe_tpu_torch.exporter.base import Exporter, ExporterContext


class InMemoryExporter(Exporter):
    """args: ``fail`` (optional bool: raise from export_batch until
    cleared — the stuck-exporter fixture for compaction-gating tests)."""

    _LOCK = threading.Lock()
    _SINKS: Dict[str, List] = {}
    _EPISODES: Dict[str, List[List]] = {}

    def __init__(self):
        self.exporter_id = ""
        self.records: List = []  # this incarnation's stream, in order
        self.fail = False
        self.opened = False
        self.closed = False
        self.controller = None

    # -- class-level sinks (survive incarnations) ---------------------------
    @classmethod
    def sink(cls, exporter_id: str) -> List:
        with cls._LOCK:
            return list(cls._SINKS.get(exporter_id, []))

    @classmethod
    def episodes(cls, exporter_id: str) -> List[List]:
        with cls._LOCK:
            return [list(e) for e in cls._EPISODES.get(exporter_id, [])]

    @classmethod
    def reset(cls, exporter_id: Optional[str] = None) -> None:
        with cls._LOCK:
            if exporter_id is None:
                cls._SINKS.clear()
                cls._EPISODES.clear()
            else:
                cls._SINKS.pop(exporter_id, None)
                cls._EPISODES.pop(exporter_id, None)

    # -- lifecycle ----------------------------------------------------------
    def configure(self, context: ExporterContext) -> None:
        self.exporter_id = context.exporter_id
        # default keeps a directly-set flag (tests hand the instance in)
        self.fail = bool((context.args or {}).get("fail", self.fail))

    def open(self, controller) -> None:
        self.opened = True
        self.controller = controller
        with self._LOCK:
            self._SINKS.setdefault(self.exporter_id, [])
            self._EPISODES.setdefault(self.exporter_id, []).append(self.records)

    def export_batch(self, records) -> None:
        if self.fail:
            raise RuntimeError(f"injected failure in exporter {self.exporter_id!r}")
        # debug sink = an API edge: iterating the (possibly columnar)
        # view materializes rows here, deliberately — the asserts need
        # real Record objects
        rows = list(records)
        self.records.extend(rows)
        with self._LOCK:
            self._SINKS.setdefault(self.exporter_id, []).extend(rows)

    def close(self) -> None:
        self.closed = True

    # -- test helpers -------------------------------------------------------
    def positions(self) -> List[int]:
        return [r.position for r in self.records]
