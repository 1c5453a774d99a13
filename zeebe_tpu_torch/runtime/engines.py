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
    broker's ``DevicePlan`` assigns it, or, with ``[mesh]
    shardedPartitions > 1``, block-shards its tables over the span of cards
    the plan assigns it (``[mesh] routing`` picks the gathered or the
    resident step). With ``[mesh] exchange`` the broker carries
    cross-partition command frames between the cards through
    ``MeshExchange``."""
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
    if cfg.mesh.routing not in ("gathered", "resident"):
        raise ValueError(
            f"[mesh] routing = {cfg.mesh.routing!r} is unknown (expected "
            "'gathered' or 'resident')"
        )
    explicit = device is not None
    resolved = resolve(device)
    span = int(cfg.mesh.sharded_partitions)
    if cfg.mesh.enabled and 0 < int(cfg.mesh.devices) < span:
        # a span wider than the cards the plan may use cannot be placed
        raise ValueError(
            f"[mesh] shardedPartitions = {span} needs that many cards; "
            f"[mesh] devices = {cfg.mesh.devices}"
        )
    capacity = int(cfg.engine.capacity)
    num_vars = int(cfg.engine.num_vars)
    sub_capacity = int(cfg.engine.sub_capacity)

    def factory(partition_id: int, broker):
        from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

        dev = resolved
        device_index = -1
        shard_devices = None
        device_indices = None
        state_shards = 1
        # an explicit device (the tests' "cpu") pins every partition there,
        # unless the broker was handed a DevicePlan of its own
        if not explicit or getattr(broker, "device_plan", None) is not None:
            # a sharded-state span first ([mesh] shardedPartitions > 1): the
            # partition's tables block-shard over it instead of lying on
            # one card
            spanned = getattr(broker, "planned_span", None)
            if spanned is not None:
                shard_devs, shard_idx = spanned(partition_id)
                if shard_devs:
                    shard_devices = shard_devs
                    device_indices = shard_idx
                    device_index = shard_idx[0]
                    state_shards = len(shard_devs)
            if state_shards == 1:
                planned, device_index = broker.planned_device(partition_id)
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
            device=dev if state_shards == 1 else None,
            device_index=device_index,
            state_shards=state_shards,
            shard_devices=shard_devices,
            device_indices=device_indices,
            routing=cfg.mesh.routing,
        )
        if engine.device.type == "cuda":
            # launch every kernel once at install time, not on the first
            # served batch, which runs on the broker actor while client
            # requests wait on it
            engine.warm()
        return engine

    return factory
