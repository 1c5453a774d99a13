"""Actor clock equivalents.

Reference parity: ``util/.../sched/clock/ActorClock.java`` and
``ControlledActorClock.java`` (tests pin and advance time deterministically).
"""

from __future__ import annotations

import time


class SystemClock:
    def __call__(self) -> int:
        return int(time.time() * 1000)

    def millis(self) -> int:
        return self()


class ControlledClock:
    """Deterministic clock for tests and replay (reference ControlledActorClock)."""

    def __init__(self, start_ms: int = 0):
        self.current = start_ms

    def __call__(self) -> int:
        return self.current

    def millis(self) -> int:
        return self.current

    def set(self, ms: int) -> None:
        self.current = ms

    def advance(self, ms: int) -> None:
        self.current += ms
