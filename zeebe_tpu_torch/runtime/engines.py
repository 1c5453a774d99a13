"""Engine selection: config → partition engine factory.

PyTorch counterpart of ``zeebe_tpu.runtime.engines``. The broker serves
its leader partitions with the host oracle interpreter or with
``CudaPartitionEngine`` on the card, per the ``[engine]`` config section
(``ZEEBE_ENGINE_TYPE`` overrides it); both serve the same record contract.
"""

from __future__ import annotations

from typing import Callable, Optional

from zeebe_tpu_torch.device import DeviceLike, resolve
from zeebe_tpu_torch.runtime.config import BrokerCfg


def engine_factory_from_config(
    cfg: BrokerCfg, device: DeviceLike = None,
) -> Optional[Callable]:
    """Build the ``engine_factory`` for :class:`ClusterBroker` from
    ``cfg.engine``: ``None`` for ``type = "host"`` (the brokers' built-in
    oracle), ``factory(partition_id, broker)`` for ``type = "cuda"``.

    The device is resolved here, when the broker starts: without a card
    (and without ``device="cpu"``, which is for tests) this raises before
    anything serves, rather than failing later inside a partition's
    install. With no explicit device each partition goes to the card the
    broker's ``DevicePlan`` assigns it."""
    etype = cfg.engine.type.lower()
    if etype == "host":
        return None
    if etype == "tpu":
        raise ValueError(
            "[engine] type = \"tpu\" is the JAX package's engine: run "
            "python -m zeebe_tpu for it, or use type = \"cuda\" here"
        )
    if etype != "cuda":
        raise ValueError(
            f"unknown engine type {cfg.engine.type!r} (expected 'host' or 'cuda')"
        )
    if int(cfg.mesh.sharded_partitions) > 1:
        raise ValueError(
            "[mesh] shardedPartitions > 1 (sharded partition state) is not "
            "ported to the CUDA engine yet (ROADMAP Queue 1 item 7)"
        )
    if cfg.mesh.routing != "gathered":
        raise ValueError(
            f"[mesh] routing = {cfg.mesh.routing!r} is not ported to the CUDA "
            "engine yet (ROADMAP Queue 1 item 7)"
        )
    explicit = device is not None
    resolved = resolve(device)
    if not explicit and cfg.mesh.enabled and cfg.mesh.exchange:
        from zeebe_tpu_torch.scheduler.placement import DevicePlan

        if len(DevicePlan(max_devices=cfg.mesh.devices).devices) >= 2:
            raise ValueError(
                "[mesh] exchange over two or more cards needs MeshExchange, "
                "which is not ported yet (ROADMAP Queue 1 item 7): set "
                "[mesh] exchange = false or devices = 1"
            )
    capacity = int(cfg.engine.capacity)
    num_vars = int(cfg.engine.num_vars)
    sub_capacity = int(cfg.engine.sub_capacity)

    def factory(partition_id: int, broker):
        from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

        dev = resolved
        if not explicit:
            planned, _index = broker.planned_device(partition_id)
            if planned is not None:
                dev = planned
        engine = CudaPartitionEngine(
            partition_id,
            broker.cfg.cluster.partitions,
            repository=broker.repository,
            clock=broker.clock,
            capacity=capacity,
            num_vars=num_vars,
            sub_capacity=sub_capacity,
            device=dev,
        )
        if engine.device.type == "cuda":
            # launch every kernel once at install time, not on the first
            # served batch, which runs on the broker actor while client
            # requests wait on it
            engine.warm()
        return engine

    return factory
