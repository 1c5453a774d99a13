"""Broker runtime: partitions, processing loop, config, clock.

Reference parity: ``broker-core/.../Broker.java`` bootstrap +
``clustering/base/partitions/PartitionInstallService`` + the
``StreamProcessorController`` processing loop.
"""

from zeebe_tpu_torch.runtime.clock import ControlledClock, SystemClock
from zeebe_tpu_torch.runtime.broker import Broker, Partition

__all__ = ["Broker", "Partition", "ControlledClock", "SystemClock"]
