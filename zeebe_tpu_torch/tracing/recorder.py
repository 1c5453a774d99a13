"""Always-on flight recorder: a bounded lock-free ring of recent
structured events per process.

When a chaos invariant trips or a broker wedges, the question is always
"what happened in the last few seconds" — raft state changes and term
bumps, leader installs/deferrals, scheduler rewinds and backpressure
skips, mesh exchange fallbacks, admission sheds, snapshot takes. Those
events are rare (control-plane rate, never per record), so recording
every one into a preallocated ring costs nothing measurable and means
the NEXT flake comes with forensics attached instead of a guess.

Lock-free by construction: writers claim a slot with one atomic counter
increment (``itertools.count`` — C-implemented, safe under the GIL) and
store one tuple; readers snapshot by scanning the ring and sorting by
sequence. A reader racing a writer sees either the old or the new tuple
for a slot — both are valid events.

Dumps go to disk as JSONL, triggered by chaos-invariant failures
(``testing/chaos.invariant``), crash-harness assertions, an explicit
``SIGUSR2`` (``install_signal_dump``), or any caller of
:func:`dump_flight_recorder`. The dump directory is ``ZB_FLIGHT_DIR``
(default: the system temp dir).

This module must stay import-light (raft and the transports import it):
no runtime/metrics import at module level — the counter shim goes
through :mod:`zeebe_tpu._events`, which is cycle-free by design.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from typing import List, Optional

from zeebe_tpu_torch._events import count_event

_WALL_T0 = time.time()
_PERF_T0 = time.perf_counter()


class FlightRecorder:
    """Bounded ring of ``(seq, t_wall, category, message, fields)``."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(64, int(capacity))
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._seq = itertools.count()
        self._dump_lock = threading.Lock()
        self._dump_n = itertools.count()

    def record(self, category: str, message: str, **fields) -> None:
        """One event. Cheap enough for any control-plane path: a counter
        increment, a tuple build, one list-slot store."""
        seq = next(self._seq)
        self._buf[seq % self.capacity] = (
            seq,
            _WALL_T0 + (time.perf_counter() - _PERF_T0),
            category,
            message,
            fields or None,
        )

    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        """The ring's surviving events, oldest first (optionally only the
        newest ``last``)."""
        events = sorted(
            (e for e in self._buf if e is not None), key=lambda e: e[0]
        )
        if last is not None:
            events = events[-last:]
        return [
            {
                "seq": seq,
                "t": round(t, 6),
                "cat": cat,
                "msg": msg,
                **({"fields": fields} if fields else {}),
            }
            for seq, t, cat, msg, fields in events
        ]

    def format_slice(self, last: int = 40) -> str:
        """Human-readable tail for log messages (stall warnings, chaos
        tolerance branches)."""
        lines = []
        for e in self.snapshot(last=last):
            fields = e.get("fields")
            suffix = f" {fields}" if fields else ""
            lines.append(
                f"  #{e['seq']} t={e['t']:.3f} [{e['cat']}] {e['msg']}{suffix}"
            )
        return "\n".join(lines) if lines else "  (recorder empty)"

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Write the ring to disk as JSONL (one event per line, preceded by
        a header line). Returns the path."""
        with self._dump_lock:
            if path is None:
                directory = os.environ.get(
                    "ZB_FLIGHT_DIR", tempfile.gettempdir()
                )
                os.makedirs(directory, exist_ok=True)
                path = os.path.join(
                    directory,
                    f"zb-flight-{os.getpid()}-{next(self._dump_n)}.jsonl",
                )
            events = self.snapshot()
            with open(path, "w") as f:
                f.write(json.dumps({
                    "format": "zeebe-tpu-flight-v1",
                    "reason": reason,
                    "pid": os.getpid(),
                    "events": len(events),
                }) + "\n")
                for event in events:
                    f.write(json.dumps(event) + "\n")
        count_event(
            "flight_recorder_dumps",
            "Flight-recorder rings dumped to disk (invariant failures, "
            "signals, explicit calls)",
        )
        return path

    def clear(self) -> None:
        """Test isolation: forget everything (the seq counter keeps
        counting — dumps stay distinguishable)."""
        self._buf = [None] * self.capacity


# the process-wide recorder: always on, resized only via ZB_FLIGHT_RING
FLIGHT = FlightRecorder(int(os.environ.get("ZB_FLIGHT_RING", "4096")))


def record_event(category: str, message: str, **fields) -> None:
    """Module-level shim for layers that should not hold a recorder
    reference (raft, transports, scheduler)."""
    FLIGHT.record(category, message, **fields)


class RateLimitedEvent:
    """Flight recording for events that can burst at PER-RECORD rate
    (admission sheds, mesh slot overflows): at most one ring entry per
    ``interval_s``, carrying how many occurrences the window suppressed.

    The ring's design constraint is control-plane rate — a sustained
    overload shedding thousands of commands per second would otherwise
    wrap the whole ring in under a second and evict exactly the
    leadership/election history a dump taken during that window exists
    to show. Unlocked on purpose: a racing increment can lose a count or
    emit one extra ring entry, both harmless for forensics (the metrics
    counters stay exact — they are incremented by the caller, not here)."""

    def __init__(self, category: str, message: str, interval_s: float = 1.0):
        self.category = category
        self.message = message
        self.interval_s = interval_s
        self._last_t = 0.0
        self._suppressed = 0

    def record(self, **fields) -> None:
        now = time.monotonic()
        if now - self._last_t < self.interval_s:
            self._suppressed += 1
            return
        suppressed, self._suppressed, self._last_t = self._suppressed, 0, now
        if suppressed:
            fields["suppressed_in_window"] = suppressed
        FLIGHT.record(self.category, self.message, **fields)


def dump_flight_recorder(reason: str = "manual",
                         path: Optional[str] = None) -> str:
    return FLIGHT.dump(path=path, reason=reason)


def read_flight_dump(path: str) -> List[dict]:
    """Parse a dump file back into its event list (header line skipped);
    raises on a corrupt line — forensics must not silently truncate."""
    events = []
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("format") != "zeebe-tpu-flight-v1":
            raise ValueError(f"not a flight-recorder dump: {path}")
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def install_signal_dump(signum: Optional[int] = None) -> None:
    """Dump the ring on an explicit signal (default SIGUSR2) — the
    operator's "what is this broker doing right now" hook; wired by the
    standalone entry point, not by tests."""
    import signal as _signal

    if signum is None:
        signum = getattr(_signal, "SIGUSR2", None)
        if signum is None:  # platform without SIGUSR2
            return

    def handler(_sig, _frame):
        path = dump_flight_recorder(reason="signal")
        print(f"flight recorder dumped to {path}", flush=True)

    _signal.signal(signum, handler)
