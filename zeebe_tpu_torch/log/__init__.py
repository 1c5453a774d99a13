"""Append-only event-sourced log (reference: ``logstreams/`` module)."""

from zeebe_tpu_torch.log.storage import SegmentedLogStorage
from zeebe_tpu_torch.log.logstream import LogStream, LogStreamReader, LogStreamWriter

__all__ = ["SegmentedLogStorage", "LogStream", "LogStreamReader", "LogStreamWriter"]
