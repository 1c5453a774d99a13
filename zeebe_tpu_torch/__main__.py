"""Standalone broker entry point of the PyTorch/CUDA package.

Counterpart of ``python -m zeebe_tpu``: read the TOML config, start a
broker node, join the configured contact points, self-bootstrap the
cluster once the expected node count is present, serve the gRPC gateway
where ``grpcio`` is installed, run until SIGINT/SIGTERM. The engine that
serves led partitions (``CudaPartitionEngine`` on the card, or the host
oracle) comes from the ``[engine]`` config section / ``ZEEBE_ENGINE_TYPE``
(``"cuda"`` or ``"host"``).

    python -m zeebe_tpu_torch [--config zeebe.cfg.toml] [--data-dir DIR]
    python -m zeebe_tpu_torch zeebe.cfg.toml      # positional also accepted
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m zeebe_tpu_torch", description="zeebe-tpu standalone broker"
    )
    parser.add_argument(
        "config_positional", nargs="?", default=None, metavar="CONFIG",
        help="config file path (same as --config)",
    )
    parser.add_argument("--config", default=None, help="TOML config file path")
    parser.add_argument(
        "--data-dir", default=None,
        help="data directory root (overrides [data] directory)",
    )
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    config_path = (
        args.config or args.config_positional or os.environ.get("ZEEBE_CFG")
    )

    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.config import load_config
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config

    cfg = load_config(config_path)
    if args.data_dir:
        cfg.data.directory = args.data_dir
    data_dir = os.path.join(cfg.data.directory, cfg.cluster.node_id)
    # operator forensics hook: SIGUSR2 dumps the flight recorder's recent
    # control-plane events to disk (docs/operations/tracing.md)
    from zeebe_tpu_torch.tracing import install_signal_dump

    install_signal_dump()
    # built before the broker: an engine the config asks for on a card
    # this host lacks stops the node here, before it serves
    factory = engine_factory_from_config(cfg)
    broker = ClusterBroker(cfg, data_dir, engine_factory=factory)
    print(
        f"zeebe-tpu broker {cfg.cluster.node_id}: engine={cfg.engine.type} "
        f"storage={'native' if cfg.data.native_storage else 'python'} "
        f"client={broker.client_address.host}:{broker.client_address.port} "
        f"gossip={broker.gossip_address.host}:{broker.gossip_address.port} "
        f"data={data_dir}",
        flush=True,
    )

    gateway = None
    try:
        from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
        from zeebe_tpu_torch.gateway.grpc_gateway import GrpcGateway

        gw_client = ClusterClient(
            [broker.client_address], num_partitions=cfg.cluster.partitions
        )
        gateway = GrpcGateway(
            gw_client, host=cfg.network.host, port=cfg.network.gateway_port
        )
        print(f"gRPC gateway on {cfg.network.host}:{gateway.port}", flush=True)
    except Exception as e:  # noqa: BLE001 - port may be taken, grpcio absent; broker still runs
        print(f"gateway disabled: {e}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print("shutting down", flush=True)
    if gateway is not None:
        gateway.close()
    broker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
