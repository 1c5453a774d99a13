"""Exporter plane: position-tracked committed-record egress.

See ``docs/EXPORTERS.md``. Public surface:

- :class:`Exporter` / :class:`ExporterContext` / :class:`ExporterController`
  — the sink API (``zeebe_tpu.exporter.base``).
- :class:`ExporterDirector` / :class:`ExporterDirectorActor` — per-partition
  dispatch with replicated positions and compaction gating.
- Built-ins: :class:`JsonlExporter` (rotating audit files),
  :class:`MetricsExporter` (per-ValueType/intent latency histograms →
  ``/metrics``), :class:`InMemoryExporter` (tests/debug).
- :func:`build_exporter` — config (``[[exporters]]``) → instance.
"""

from __future__ import annotations

import importlib
from typing import Tuple

from zeebe_tpu_torch.exporter.base import (
    Exporter,
    ExporterContext,
    ExporterController,
    record_to_doc,
)
from zeebe_tpu_torch.exporter.director import ExporterDirector, ExporterDirectorActor
from zeebe_tpu_torch.exporter.jsonl import JsonlExporter, read_audit_docs
from zeebe_tpu_torch.exporter.memory import InMemoryExporter
from zeebe_tpu_torch.exporter.metrics_exporter import MetricsExporter

BUILTIN_TYPES = {
    "jsonl": JsonlExporter,
    "metrics": MetricsExporter,
    "memory": InMemoryExporter,
    "debug": InMemoryExporter,
}


def build_exporter(spec) -> Tuple[str, Exporter]:
    """``ExporterCfg`` (id/type/args) → (id, fresh exporter instance).

    ``type`` is a built-in name or a ``package.module:Class`` path; the
    instance carries its config args for the director's configure call.
    Raises on unknown types — a misconfigured exporter must fail broker
    boot loudly, not silently drop records."""
    type_name = spec.type
    cls = BUILTIN_TYPES.get(type_name)
    if cls is None and ":" in type_name:
        module_name, _, class_name = type_name.partition(":")
        cls = getattr(importlib.import_module(module_name), class_name)
    if cls is None:
        raise ValueError(
            f"unknown exporter type {type_name!r} for exporter {spec.id!r} "
            f"(built-ins: {sorted(BUILTIN_TYPES)}; or 'module.path:Class')"
        )
    exporter = cls()
    exporter._cfg_args = dict(spec.args or {})
    return spec.id, exporter


__all__ = [
    "Exporter",
    "ExporterContext",
    "ExporterController",
    "ExporterDirector",
    "ExporterDirectorActor",
    "JsonlExporter",
    "MetricsExporter",
    "InMemoryExporter",
    "build_exporter",
    "read_audit_docs",
    "record_to_doc",
    "BUILTIN_TYPES",
]
