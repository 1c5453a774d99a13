"""Continuous-batching wave scheduler + gateway admission control.

``wave.WaveScheduler`` packs committed records from ALL leader partitions
on a broker into shared device waves (deficit-round-robin fairness,
per-partition backpressure); ``admission.AdmissionController`` bounds
client in-flight and sheds retryably before the broker collapses under
overload. See docs/SERVING.md ("The wave scheduler").
"""

from zeebe_tpu_torch.scheduler.admission import (
    AdmissionConfig,
    AdmissionController,
    REASON_CONNECTION_INFLIGHT,
    REASON_QUEUE_DEPTH,
)
from zeebe_tpu_torch.scheduler.placement import DevicePlan, MeshExchange
from zeebe_tpu_torch.scheduler.wave import (
    PartitionFeed,
    SharedWave,
    WaveScheduler,
    WaveSegment,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "DevicePlan",
    "MeshExchange",
    "PartitionFeed",
    "REASON_CONNECTION_INFLIGHT",
    "REASON_QUEUE_DEPTH",
    "SharedWave",
    "WaveScheduler",
    "WaveSegment",
]
