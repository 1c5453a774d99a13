"""Broker configuration: TOML file → typed config tree + env overrides.

Reference parity: ``broker-core/.../system/configuration/`` —
``TomlConfigurationReader`` parses ``zeebe.cfg.toml`` into the ``BrokerCfg``
bean tree (network with port offset, data, cluster, threads, metrics,
gossip, raft, bootstrap topics), and ``Environment`` applies env-var
overrides (e.g. ``ZEEBE_PORT_OFFSET`` in ``NetworkCfg``). The canonical
commented default file lives at ``dist/zeebe.cfg.toml`` (reference
``dist/src/main/config/zeebe.cfg.toml``).
"""

from __future__ import annotations

import dataclasses
import os

try:
    import tomllib
except ImportError:  # Python < 3.11: tomli is the API-compatible backport
    import tomli as tomllib
from typing import Any, Dict, List, Optional

# default ports mirror the reference layout (client 26501, management 26502,
# replication 26503, subscription 26504; gateway 26500)
DEFAULT_GATEWAY_PORT = 26500
DEFAULT_CLIENT_PORT = 26501
DEFAULT_MANAGEMENT_PORT = 26502
DEFAULT_REPLICATION_PORT = 26503
DEFAULT_SUBSCRIPTION_PORT = 26504


@dataclasses.dataclass
class NetworkCfg:
    host: str = "127.0.0.1"
    port_offset: int = 0
    gateway_port: int = DEFAULT_GATEWAY_PORT
    client_port: int = DEFAULT_CLIENT_PORT
    management_port: int = DEFAULT_MANAGEMENT_PORT
    replication_port: int = DEFAULT_REPLICATION_PORT
    subscription_port: int = DEFAULT_SUBSCRIPTION_PORT

    def apply_offset(self) -> None:
        # reference: portOffset shifts every socket binding by offset * 10
        shift = self.port_offset * 10
        self.gateway_port += shift
        self.client_port += shift
        self.management_port += shift
        self.replication_port += shift
        self.subscription_port += shift


@dataclasses.dataclass
class DataCfg:
    directory: str = "data"
    segment_size_bytes: int = 64 * 1024 * 1024
    snapshot_period_ms: int = 15 * 60 * 1000
    snapshot_replication_period_ms: int = 5 * 60 * 1000
    # serve the partition logs through the C++ storage backend
    # (native/log_storage.cc — same on-disk format as the Python one);
    # requires the native toolchain, fails loudly when missing
    native_storage: bool = False


@dataclasses.dataclass
class ClusterCfg:
    node_id: str = "node-0"
    initial_contact_points: List[str] = dataclasses.field(default_factory=list)
    bootstrap_expect: int = 1
    replication_factor: int = 1
    partitions: int = 1


@dataclasses.dataclass
class ThreadsCfg:
    cpu_thread_count: int = 2
    io_thread_count: int = 2


@dataclasses.dataclass
class MetricsCfg:
    enabled: bool = True
    file: str = "metrics/zeebe.prom"
    flush_period_ms: int = 5_000
    # HTTP /metrics endpoint for prometheus scraping (0 disables; the
    # file writer keeps running either way — the reference exposes the
    # file via node exporter, here the broker serves it directly)
    port: int = 9600


@dataclasses.dataclass
class EngineCfg:
    """Which stream-processing engine serves the partitions this node
    leads: ``host`` = the Python oracle interpreter, ``tpu`` = the batched
    device kernel (``zeebe_tpu.tpu.TpuPartitionEngine``). The reference
    has exactly one engine, installed unconditionally per partition
    (broker-core/.../PartitionInstallService.java:106-291); here the
    device engine is the flagship and the host oracle the fallback."""

    # the port serves on the card unless a config asks for the oracle
    type: str = "cuda"  # "host" | "cuda"
    capacity: int = 1 << 12  # device table capacity (instances/jobs rows)
    num_vars: int = 16  # payload variable columns on device
    sub_capacity: int = 16  # sub-process nesting table rows
    # on-chip pallas-vs-XLA parity smoke before the first TPU engine
    # serves (refuses to serve on divergence); no-op off-TPU
    pallas_selfcheck: bool = True


@dataclasses.dataclass
class SchedulerCfg:
    """Cross-partition continuous-batching wave scheduler
    (``zeebe_tpu/scheduler/``): committed records from every leader
    partition on this broker pack into SHARED device waves. ``enabled =
    false`` restores the per-partition drain (the A/B baseline the bench
    compares against)."""

    enabled: bool = True
    wave_size: int = 512  # shared-wave record capacity (= drain chunk)
    # deficit-round-robin quantum: records of credit per feed per packing
    # round (0 = wave_size // 8)
    quantum: int = 0
    # per-partition cap on dispatched-but-unapplied records; a partition
    # at the cap is skipped until its apply side catches up (0 = 4 waves)
    backpressure_limit: int = 0


@dataclasses.dataclass
class MeshCfg:
    """Mesh-sharded serving plane (``scheduler/placement.DevicePlan``):
    leader partitions are placed across the visible accelerator devices
    (round-robin, rebalanced on leadership change), so the wave
    scheduler's drain dispatches different partitions' wave segments to
    DIFFERENT devices within one scheduling round. ``enabled = false``
    pins every engine to the default device — the single-device A/B
    baseline ``bench.py --mesh`` compares against. Only the device engine
    (``[engine] type = "tpu"``) is placed; the host oracle has no device
    state."""

    enabled: bool = True
    # cap on devices used (0 = every visible device)
    devices: int = 0
    # route cross-partition message-correlation command frames over the
    # mesh's all_to_all exchange instead of the host transport hop when
    # both partitions are device-resident on this broker
    exchange: bool = True
    exchange_slots: int = 32  # frames per (src, dst) device pair per round
    exchange_frame_bytes: int = 1024  # slot width; larger frames fall back
    # mesh-SHARDED partition state: each leader partition's row tables
    # block-shard over a span of this many devices (engine
    # ``state_shards``) — the wave's step gathers the tables over ICI,
    # computes on the whole span at once, and keeps local row blocks.
    # 0/1 = single-device placement (the default); replays are
    # bit-identical either way (tests/test_sharded_state.py pins it)
    sharded_partitions: int = 0
    # sharded-state ROUTING mode (v2): "gathered" = every wave gathers
    # the sharded tables (v1 — compute does not divide by the span);
    # "resident" = residency-routed staging — single-owner waves stage
    # into the owner shard's batch lane and step only its local rows (no
    # per-wave table gather; unknown-residency/overflow waves fall back
    # to a gathered step). Logs are bit-identical in every mode.
    routing: str = "gathered"


@dataclasses.dataclass
class AdmissionCfg:
    """Gateway admission control (shed-before-collapse): commands beyond
    the per-connection in-flight bound — or arriving while the broker
    backlog sits above the queue-depth watermark — are rejected with a
    retryable RESOURCE_EXHAUSTED instead of queueing until timeout."""

    enabled: bool = True
    max_inflight_per_connection: int = 1024
    queue_depth_high: int = 8192
    retry_after_ms: int = 50


@dataclasses.dataclass
class TracingCfg:
    """Record-lifecycle tracing (``zeebe_tpu/tracing/``): sampled
    commands are stamped at every serving-plane hop (gateway receive →
    … → exporter ack) and per-wave timelines are kept for Perfetto
    export (``tools/trace_report.py``). Sampling is deterministic per
    (seed, partition, arrival index) so chaos replays trace the same
    commands. ``enabled = false`` removes the span tracer entirely —
    the hot paths fall back to a single global read. The flight
    recorder (bounded event ring, dump-on-invariant-failure) is always
    on regardless of this section."""

    enabled: bool = True
    sample_rate: float = 0.01  # sampled fraction of commands per partition
    seed: int = 0
    per_partition_budget: int = 256  # live spans per partition (cap)
    commit_stall_ms: int = 5_000  # commit-latency watchdog threshold
    slow_wave_ms: int = 5_000  # slow-wave watchdog threshold


@dataclasses.dataclass
class GossipCfg:
    probe_interval_ms: int = 250
    probe_timeout_ms: int = 500
    probe_indirect_nodes: int = 2
    suspicion_multiplier: int = 5
    sync_interval_ms: int = 10_000


@dataclasses.dataclass
class RaftCfg:
    heartbeat_interval_ms: int = 250
    election_timeout_ms: int = 1_000


@dataclasses.dataclass
class TopicCfg:
    name: str = "default-topic"
    partitions: int = 1
    replication_factor: int = 1


@dataclasses.dataclass
class ExporterCfg:
    """One ``[[exporters]]`` entry (reference: the exporters section of
    zeebe.cfg.toml — id + className + per-exporter args). ``type`` is a
    built-in name (``jsonl``, ``metrics``, ``memory``) or a
    ``package.module:Class`` path; ``args`` passes through to
    ``Exporter.configure`` verbatim."""

    id: str = ""
    type: str = ""
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BrokerCfg:
    network: NetworkCfg = dataclasses.field(default_factory=NetworkCfg)
    data: DataCfg = dataclasses.field(default_factory=DataCfg)
    cluster: ClusterCfg = dataclasses.field(default_factory=ClusterCfg)
    threads: ThreadsCfg = dataclasses.field(default_factory=ThreadsCfg)
    metrics: MetricsCfg = dataclasses.field(default_factory=MetricsCfg)
    gossip: GossipCfg = dataclasses.field(default_factory=GossipCfg)
    raft: RaftCfg = dataclasses.field(default_factory=RaftCfg)
    engine: EngineCfg = dataclasses.field(default_factory=EngineCfg)
    scheduler: SchedulerCfg = dataclasses.field(default_factory=SchedulerCfg)
    mesh: MeshCfg = dataclasses.field(default_factory=MeshCfg)
    admission: AdmissionCfg = dataclasses.field(default_factory=AdmissionCfg)
    tracing: TracingCfg = dataclasses.field(default_factory=TracingCfg)
    topics: List[TopicCfg] = dataclasses.field(default_factory=list)
    exporters: List[ExporterCfg] = dataclasses.field(default_factory=list)


_SECTION_KEYS = {
    "network": NetworkCfg,
    "data": DataCfg,
    "cluster": ClusterCfg,
    "threads": ThreadsCfg,
    "metrics": MetricsCfg,
    "gossip": GossipCfg,
    "raft": RaftCfg,
    "engine": EngineCfg,
    "scheduler": SchedulerCfg,
    "mesh": MeshCfg,
    "admission": AdmissionCfg,
    "tracing": TracingCfg,
}

# env overrides (reference Environment: ZEEBE_* wins over the file)
_ENV_OVERRIDES = {
    "ZEEBE_HOST": ("network", "host", str),
    "ZEEBE_PORT_OFFSET": ("network", "port_offset", int),
    "ZEEBE_NODE_ID": ("cluster", "node_id", str),
    "ZEEBE_PARTITIONS": ("cluster", "partitions", int),
    "ZEEBE_REPLICATION_FACTOR": ("cluster", "replication_factor", int),
    "ZEEBE_BOOTSTRAP_EXPECT": ("cluster", "bootstrap_expect", int),
    "ZEEBE_CONTACT_POINTS": (
        "cluster",
        "initial_contact_points",
        lambda v: [p.strip() for p in v.split(",") if p.strip()],
    ),
    # singular alias: both spellings appear in reference deployments
    "ZEEBE_CONTACT_POINT": (
        "cluster",
        "initial_contact_points",
        lambda v: [p.strip() for p in v.split(",") if p.strip()],
    ),
    "ZEEBE_DATA_DIR": ("data", "directory", str),
    "ZEEBE_NATIVE_STORAGE": (
        "data",
        "native_storage",
        lambda v: v.strip().lower() in ("1", "true", "yes"),
    ),
    "ZEEBE_ENGINE_TYPE": ("engine", "type", str),
    "ZEEBE_METRICS_PORT": ("metrics", "port", int),
    "ZEEBE_SCHEDULER_ENABLED": (
        "scheduler",
        "enabled",
        lambda v: v.strip().lower() in ("1", "true", "yes"),
    ),
    "ZEEBE_ADMISSION_ENABLED": (
        "admission",
        "enabled",
        lambda v: v.strip().lower() in ("1", "true", "yes"),
    ),
    "ZEEBE_MESH_ENABLED": (
        "mesh",
        "enabled",
        lambda v: v.strip().lower() in ("1", "true", "yes"),
    ),
    "ZEEBE_MESH_DEVICES": ("mesh", "devices", int),
    "ZEEBE_MESH_SHARDED_PARTITIONS": ("mesh", "sharded_partitions", int),
    "ZEEBE_MESH_ROUTING": ("mesh", "routing", str),
    "ZEEBE_TRACING_ENABLED": (
        "tracing",
        "enabled",
        lambda v: v.strip().lower() in ("1", "true", "yes"),
    ),
    "ZEEBE_TRACING_SAMPLE_RATE": ("tracing", "sample_rate", float),
}


def _apply_section(cfg_obj: Any, table: Dict[str, Any], path: str) -> None:
    fields = {f.name: f for f in dataclasses.fields(cfg_obj)}
    for key, value in table.items():
        # accept camelCase (reference TOML style) and snake_case
        snake = "".join(
            "_" + c.lower() if c.isupper() else c for c in key
        ).lstrip("_")
        if snake not in fields:
            raise ValueError(f"unknown config key [{path}] {key!r}")
        setattr(cfg_obj, snake, value)


def load_config(
    path: Optional[str] = None,
    toml_text: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
) -> BrokerCfg:
    """Parse config (file path or literal text), then apply env overrides.
    Missing sections keep defaults (the reference ships a fully commented
    default file; every knob is optional) — but an explicitly named file
    that does not exist is an error: silently running on all-defaults is
    how a container ignores its own config."""
    cfg = BrokerCfg()
    data: Dict[str, Any] = {}
    if toml_text is not None:
        data = tomllib.loads(toml_text)
    elif path is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(f"config file not found: {path}")
        with open(path, "rb") as f:
            data = tomllib.load(f)

    for section, table in data.items():
        if section == "topics":
            for entry in table:
                topic = TopicCfg()
                _apply_section(topic, entry, "topics")
                cfg.topics.append(topic)
            continue
        if section == "exporters":
            for entry in table:
                exporter = ExporterCfg()
                _apply_section(exporter, entry, "exporters")
                if not exporter.id or not exporter.type:
                    raise ValueError(
                        "[[exporters]] entries need both 'id' and 'type'"
                    )
                if any(e.id == exporter.id for e in cfg.exporters):
                    # two exporters sharing an id would share one
                    # replicated position entry — the faster one's ack
                    # overwrites the slower one's real progress and a
                    # restart silently skips the difference
                    raise ValueError(
                        f"duplicate exporter id {exporter.id!r}"
                    )
                cfg.exporters.append(exporter)
            continue
        target_cls = _SECTION_KEYS.get(section)
        if target_cls is None:
            raise ValueError(f"unknown config section [{section}]")
        _apply_section(getattr(cfg, section), table, section)

    environment = env if env is not None else os.environ
    for var, (section, attr, conv) in _ENV_OVERRIDES.items():
        if var in environment:
            setattr(getattr(cfg, section), attr, conv(environment[var]))

    cfg.network.apply_offset()
    # the metrics endpoint is a socket binding too: shift it with the rest
    # so several brokers can share one host (reference portOffset contract)
    if cfg.metrics.port:
        cfg.metrics.port += cfg.network.port_offset * 10
    return cfg
