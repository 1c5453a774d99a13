"""Process-global event counting for low-level layers.

Transport, log storage, snapshot storage and raft have no broker metrics
registry in reach (they are constructed in many places, some several
layers from a broker), so chaos-relevant events count into the global
registry of :mod:`zeebe_tpu.runtime.metrics`. This module exists so those
layers share ONE shim: it is import-cycle-free (no imports at module
level) because ``zeebe_tpu.runtime`` initializes the broker — which
imports ``zeebe_tpu.log`` — at package-init time, and a top-level metrics
import from inside ``log`` would re-enter that cycle half-built.
"""

from __future__ import annotations


def count_event(name: str, help_text: str = "", delta: float = 1.0) -> None:
    """Bump a process-global event counter (allocate-on-first-use)."""
    from zeebe_tpu_torch.runtime.metrics import count_event as _impl

    _impl(name, help_text, delta)


def set_gauge(name: str, value: float, help_text: str = "", **labels: str) -> None:
    """Set a process-global gauge (allocate-on-first-use); same shim rules
    as :func:`count_event` — merged into every /metrics dump."""
    from zeebe_tpu_torch.runtime.metrics import global_gauge

    global_gauge(name, help_text, **labels).set(value)
