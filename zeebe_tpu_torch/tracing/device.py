"""Spans of the device path: the drive's rounds, the step's phases, the tick
and the lookup rebuild, with the host and the device time of each.

The record-lifecycle spans of :mod:`zeebe_tpu_torch.tracing.spans` follow a
record through the broker; these follow the card's work inside one drive
(docs/operations/tracing.md, "The device-path recorder"):

- ``drive.run``: one ``tpu.drive.run_to_quiescence`` call;
- ``drive.round``: one round of it, whose children are ``drive.launch``
  (the dequeue, the step and the enqueue being issued) and ``drive.sync``
  (the round's one read of the queue's count and overflow flag);
- ``step``: one ``tpu.kernel.step_kernel`` call, whose children are its
  phases ``step.lookups``, ``step.routing``, ``step.compute``, ``step.keys``,
  ``step.emit``, ``step.commit`` and ``step.compact``, one after another;
  the step's own time, after the last phase, is the teardown of its frame.
  A drive's step replayed from a CUDA graph (``tpu.capture``) is a ``step``
  with no phases: its copies in and the graph's launch. With a recorder
  installed the drive steps eagerly, phases and all;
- ``tick``: one ``tpu.kernel.tick_kernel`` call;
- ``rebuild``: one ``tpu.state.rebuild_lookup_state`` call.

``TRACER`` is the process's recorder; ``None`` means off. Off, and with no
``torch.profiler`` recording, a span site reads those two flags and returns:
no clock, no CUDA event, no allocation. While the profiler records, every
span site opens a ``torch.profiler.record_function`` of the span's name,
recorder or not, so the spans sit in the profiler's own trace, on its clock.

With a recorder installed, each span boundary reads ``time.perf_counter_ns``
once and records one CUDA event, from a pool made at install, on the traced
card's stream (its current stream at install); spans that end and begin at
one boundary share it, so a phase's device interval is the time between
its two boundary events (idle inside the phase included). On the CPU the
events are left out and the host times kept.
The spans stay in memory, at most ``MAX_SPANS`` (those beyond are counted
in ``dropped``), and are read only by ``summary`` and ``dump``, after one
synchronize. While a recorder is installed, ``tpu.ops`` adds up the host
nanoseconds of each wrapper call that reaches the card (``ops.HOST_NS``);
``summary`` gives them over the calls made while it was installed.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["TRACER", "DeviceTracer", "install", "recording", "begin", "phase", "end",
           "traced"]

# the process's device-path recorder; None = off
TRACER: Optional["DeviceTracer"] = None
# spans a recorder keeps (a drive round makes 11); those beyond are counted
MAX_SPANS = 1 << 16
# CUDA events a recorder makes when installed (a drive round takes 12)
POOL = 4096

# each thread's open spans, outermost first
_OPEN = threading.local()


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class DeviceTracer:
    """Spans of the device path on one card (``device``; the current CUDA
    device by default, none on a machine without one). Install it with
    ``install`` or ``recording``; read it with ``summary`` or ``dump``."""

    def __init__(self, device=None):
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device) if device is not None else None
        self.device = device if device is not None and device.type == "cuda" else None
        self.dropped = 0
        # [name, parent index, drive, round, thread, host ns, event, host ns, event]
        self._spans: List[list] = []
        self._events: List[torch.cuda.Event] = []
        self._pool: List[torch.cuda.Event] = []
        self._stream = None  # the card's current stream when installed
        self._lock = threading.Lock()
        self._drives = itertools.count()
        self._anchor = None  # (host ns, event): the two clocks at one instant
        # the ops counters when last installed, and their gains over the
        # times installed before
        self._ops_from: Optional[Dict[str, Dict[str, int]]] = None
        self._ops_gained: Dict[str, Dict[str, int]] = {"calls": {}, "host_ns": {}}

    # -- installed and removed --------------------------------------------------
    def _start(self) -> None:
        if self.device is not None and self._anchor is None:
            # the pool's events are created by a first record, here and not
            # inside a round
            self._stream = torch.cuda.current_stream(self.device)
            for _ in range(POOL):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(self._stream)
                self._pool.append(ev)
            # after the synchronize the stream is idle: the anchor event runs
            # at the host time read just before it is recorded
            torch.cuda.synchronize(self.device)
            ev = torch.cuda.Event(enable_timing=True)
            now = time.perf_counter_ns()
            ev.record(self._stream)
            self._anchor = (now, ev)
        self._ops_from = _ops_counts()

    def _stop(self) -> None:
        self._ops_gained = self._ops()
        self._ops_from = None

    def _ops(self) -> Dict[str, Dict[str, int]]:
        """The ops counters' gains over the times this recorder was installed."""
        out = {k: dict(v) for k, v in self._ops_gained.items()}
        if self._ops_from is not None:
            now = _ops_counts()
            for kind, counts in now.items():
                for name, n in counts.items():
                    out[kind][name] = out[kind].get(name, 0) + n - self._ops_from[kind][name]
        return out

    # -- recorded at the span sites ---------------------------------------------
    def _mark(self):
        """One boundary: (this recorder, host ns, event index; -1 without one)."""
        now = time.perf_counter_ns()
        if self.device is None or len(self._events) >= 2 * MAX_SPANS:
            return self, now, -1
        with self._lock:
            ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self._events.append(ev)
            return self, now, len(self._events) - 1

    def _store(self, name: str, parent: int, drive, rnd, at) -> int:
        with self._lock:
            if len(self._spans) >= MAX_SPANS:
                self.dropped += 1
                return -1
            self._spans.append([name, parent, drive, rnd, threading.get_ident(), at[1], at[2],
                                None, -1])
            return len(self._spans) - 1

    def _finish(self, index: int, at) -> None:
        if at is None or at[0] is not self:  # installed or removed while the span was open
            at = self._mark()
        rec = self._spans[index]
        rec[7], rec[8] = at[1], at[2]

    # -- read after the run -------------------------------------------------------
    def _device_ms(self) -> List[Optional[float]]:
        """Each event's time on the card, in ms after the anchor."""
        if self._anchor is None:
            return [None] * len(self._events)
        torch.cuda.synchronize(self.device)
        anchor = self._anchor[1]
        return [anchor.elapsed_time(ev) for ev in self._events]

    def summary(self) -> dict:
        """Totals by span name over the closed spans: ``count``, ``host_ms``,
        ``device_ms`` and ``lag_ms``, the mean of how far the card ran
        behind the host where the span ended (its end event's time on the
        card less its end on the host, through the anchor; the device
        readings None where an event is missing: on the CPU); ``rounds``,
        the ``drive.round`` count; ``ops``, the wrapper calls that reached
        the card while the recorder was installed and their host ns;
        ``dropped``; the traced ``device``; and ``capture``, the process's
        ``tpu.capture.CAPTURE`` counts when read (the drive's steps replayed
        from a CUDA graph, and those run eagerly by reason: with the
        recorder installed, ``eager.recorder``)."""
        at = self._device_ms()
        base = self._anchor[0] * 1e-6 if self._anchor is not None else 0.0
        spans: Dict[str, dict] = {}
        for name, _parent, _drive, _rnd, _thread, h0, e0, h1, e1 in list(self._spans):
            if h1 is None:
                continue
            s = spans.setdefault(name, {"count": 0, "host_ms": 0.0, "device_ms": 0.0,
                                        "lag_ms": 0.0})
            s["count"] += 1
            s["host_ms"] += (h1 - h0) * 1e-6
            timed = e0 >= 0 and e1 >= 0 and s["device_ms"] is not None
            s["device_ms"] = s["device_ms"] + at[e1] - at[e0] if timed else None
            s["lag_ms"] = s["lag_ms"] + base + at[e1] - h1 * 1e-6 if timed else None
        for s in spans.values():
            if s["lag_ms"] is not None:
                s["lag_ms"] /= s["count"]
        ops = self._ops()
        calls, host_ns = ops["calls"], ops["host_ns"]
        return {
            "rounds": spans.get("drive.round", {}).get("count", 0),
            "spans": spans,
            "ops": {"calls": sum(calls.values()), "host_ns": sum(host_ns.values()),
                    "by_wrapper": {k: [calls[k], host_ns[k]] for k in calls if calls[k]}},
            "dropped": self.dropped,
            "device": str(self.device) if self.device is not None else None,
            "capture": _capture_counts(),
        }

    def dump(self, path: str) -> None:
        """The spans as Chrome-trace JSON (``chrome://tracing``, Perfetto):
        a host track per thread and a device track, both on the host's
        ``perf_counter`` clock in µs, the device times placed through the
        anchor event; each span's ``args`` name its drive and round."""
        at = self._device_ms()
        base = self._anchor[0] if self._anchor is not None else 0
        events = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "host"}},
                  {"ph": "M", "name": "process_name", "pid": 2,
                   "args": {"name": f"device {self.device}"}}]
        for name, _parent, drive, rnd, thread, h0, e0, h1, e1 in list(self._spans):
            if h1 is None:
                continue
            args = {"drive": drive, "round": rnd}
            events.append({"ph": "X", "name": name, "pid": 1, "tid": thread, "ts": h0 / 1e3,
                           "dur": (h1 - h0) / 1e3, "args": args})
            if e0 >= 0 and e1 >= 0 and at[e0] is not None:
                ts = base / 1e3 + at[e0] * 1e3
                events.append({"ph": "X", "name": name, "pid": 2, "tid": 0, "ts": ts,
                               "dur": (at[e1] - at[e0]) * 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def _capture_counts() -> dict:
    from zeebe_tpu_torch.tpu import capture

    return capture.counts()


def _ops_counts() -> Dict[str, Dict[str, int]]:
    from zeebe_tpu_torch.tpu import ops

    with ops._count_lock:
        return {"calls": dict(ops.LAUNCHES), "host_ns": dict(ops.HOST_NS)}


def install(tracer: Optional[DeviceTracer]) -> Optional[DeviceTracer]:
    """Make ``tracer`` the process's recorder (None: off). Install and
    remove it between drives, from the thread that drives."""
    global TRACER
    old = TRACER
    if old is not None and old is not tracer:
        old._stop()
    if tracer is not None and tracer is not old:
        tracer._start()
    TRACER = tracer
    return tracer


@contextlib.contextmanager
def recording(device=None):
    """A ``DeviceTracer`` installed for the block, and removed after it."""
    tracer = install(DeviceTracer(device))
    try:
        yield tracer
    finally:
        install(None)


# -- span sites -------------------------------------------------------------------


class Span:
    """An open span: its store index in its recorder (-1 without one), its
    ``record_function`` while the profiler records, its depth on its
    thread's stack, and whether it is a phase of the span below it."""

    __slots__ = ("tracer", "index", "drive", "round", "rounds", "rf", "depth", "phase")

    def __init__(self, tracer, name: str, stack: list, at, phase: bool = False):
        parent = stack[-1] if stack else None
        self.tracer, self.rounds, self.rf = tracer, 0, None
        self.depth, self.phase = len(stack), phase
        if name == "drive.run":
            self.drive, self.round = (next(tracer._drives) if tracer is not None else None), None
        elif name == "drive.round" and parent is not None:
            self.drive, self.round = parent.drive, parent.rounds
            parent.rounds += 1
        else:
            self.drive = parent.drive if parent is not None else None
            self.round = parent.round if parent is not None else None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(name)
            self.rf.__enter__()
        self.index = -1
        if tracer is not None:
            self.index = tracer._store(name, parent.index if parent is not None else -1,
                                       self.drive, self.round, at)
        stack.append(self)

    def close(self, at) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.index >= 0:
            self.tracer._finish(self.index, at)


def begin(name: str, first: Optional[str] = None) -> Optional[Span]:
    """Open span ``name`` under the thread's innermost open span and, with
    ``first``, its first phase at the same boundary. None when neither the
    recorder nor the profiler is on."""
    tracer = TRACER
    if tracer is None and not _autograd_profiler._is_profiler_enabled:
        return None
    at = tracer._mark() if tracer is not None else None
    stack = _stack()
    sp = Span(tracer, name, stack, at)
    if first is not None:
        Span(tracer, first, stack, at, phase=True)
    return sp


def phase(name: Optional[str]) -> None:
    """End the phase open on this thread's innermost span, if any, and open
    the span's next phase ``name`` (None: no other), at one boundary."""
    tracer = TRACER
    if tracer is None and not _autograd_profiler._is_profiler_enabled:
        return
    at = tracer._mark() if tracer is not None else None
    stack = _stack()
    if stack and stack[-1].phase:
        stack.pop().close(at)
    if name is not None:
        Span(tracer, name, stack, at, phase=True)


def end(sp: Optional[Span]) -> None:
    """End ``sp`` and whatever it holds open, at one boundary."""
    stack = _stack()
    if sp is None or sp.depth >= len(stack) or stack[sp.depth] is not sp:
        return  # off, or an outer span that ended closed it
    at = sp.tracer._mark() if sp.tracer is not None else None
    for inner in reversed(stack[sp.depth:]):
        inner.close(at)
    del stack[sp.depth:]


def traced(name: str, first: Optional[str] = None):
    """Decorate a function so that each call, its frame's teardown included,
    is span ``name`` (with ``first``, opened with its first phase)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if TRACER is None and not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            sp = begin(name, first)
            try:
                return fn(*args, **kwargs)
            finally:
                end(sp)

        return call

    return wrap
