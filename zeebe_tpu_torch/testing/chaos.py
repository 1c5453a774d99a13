"""Deterministic chaos plane: seeded fault injection for cluster tests.

The paper's core claim — state is always reconstructible by replay over a
fault-tolerant replicated log — is only a claim until faults are actually
injected. This module makes fault schedules a first-class, REPRODUCIBLE
test input (reference analogue: the reference's ClusteringRule kills real
brokers; Jepsen-style nemeses do the same for network faults — here both
run in-process and deterministically):

- :class:`FaultPlane` — network faults (drop, delay, duplicate, symmetric/
  asymmetric partitions) installed into ``ClientTransport``/
  ``ServerTransport`` via their ``fault_hook`` injection point. All
  randomness comes from per-edge RNGs derived from one seed, so the same
  seed over the same per-edge traffic produces the same decision sequence;
  every decision is appended to ``plane.trace`` for replay/debugging.
- :class:`DiskFaults` — disk-level crash simulation: torn segment-tail
  writes, failing fsync, and a crash at any point inside the snapshot
  storage's two-rename commit (``_swap_in``).
- :class:`ChaosHarness` — crash-stops and restarts in-process
  ``ClusterBroker`` nodes (data dirs survive, sockets and schedulers do
  not), re-wiring raft membership to the restarted node's fresh ephemeral
  addresses.
- :func:`replay_oracle` — replays a committed record sequence through a
  fresh host oracle engine with side effects suppressed (the recovery
  contract of ``StreamProcessorController`` reprocessing): the parity
  baseline for the "replay reconstructs the same state" invariant.

The six invariants chaos runs assert (see ``tests/test_chaos.py``,
``tests/test_snapshot_delta.py`` and ``docs/CHAOS.md``):

1. no acked (committed) append is ever lost,
2. at most one raft leader per term,
3. replay of the surviving committed log is bit-identical across
   independent oracle replays and structurally equal to the live engine,
4. snapshot-restore after a mid-commit crash converges to the same state,
5. a delta-chain snapshot restores bit-identically to a from-scratch
   full take of the same state,
6. a crash mid-delta-commit never orphans the previous snapshot's
   referenced segments (it stays restorable across salvage sweep + GC).
"""

from __future__ import annotations

import os
import random
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from zeebe_tpu_torch.transport import RemoteAddress
from zeebe_tpu_torch.tracing.recorder import (
    FLIGHT,
    dump_flight_recorder,
    record_event,
)

WILDCARD = "*"


def forensics_dump(reason: str) -> str:
    """Dump the process flight recorder for a chaos failure; returns the
    dump path. Every invariant-failure path goes through here so the
    next flake comes with the broker-side event history attached."""
    return dump_flight_recorder(reason=reason)


def invariant(condition, message: str) -> None:
    """Chaos-invariant assert: on failure, dump the flight recorder to
    disk and attach the dump path (plus the recent event slice) to the
    raised AssertionError — a failing chaos run must carry its own
    forensics, not require a re-run under instrumentation."""
    if condition:
        return
    path = forensics_dump("invariant-failure")
    raise AssertionError(
        f"{message}\n[flight recorder dump: {path}]\n"
        f"recent events:\n{FLIGHT.format_slice(last=30)}"
    )


class FaultPlane:
    """Seeded network-fault injector for the TCP transports.

    Install with :meth:`install_client` / :meth:`install_server` (sets the
    transport's ``fault_hook``) and :meth:`register_endpoint` (maps a
    listening address to a node label so destinations resolve). Faults are
    configured either as hard partitions (:meth:`partition`,
    :meth:`isolate`) or probabilistic per-edge rules (:meth:`set_rule`).

    Determinism contract: each directed edge ``src → dst`` draws from its
    own ``random.Random`` seeded by ``(seed, src, dst)``, so the decision
    SEQUENCE per edge depends only on the seed and how many frames crossed
    that edge — not on cross-edge thread interleaving. ``trace`` records
    every decision as ``(edge_seq, src, dst, verb, n_bytes)``.

    Scope: REQUEST/MESSAGE frames on the client side, RESPONSE frames on
    the server side. Server-initiated pushes (``ConnectionHandle.push``)
    bypass the plane — partitions sever RPC by blocking the request
    direction, which starves pushes of the subscriptions that feed them.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.trace: List[tuple] = []
        self._lock = threading.Lock()
        self._endpoints: Dict[Tuple[str, int], str] = {}
        self._blocked: set = set()  # directed (src, dst); WILDCARD allowed
        # (src, dst) → rule dict; WILDCARD allowed on either side
        self._rules: Dict[Tuple[str, str], dict] = {}
        self._edge_rngs: Dict[Tuple[str, str], random.Random] = {}
        self._edge_seq: Dict[Tuple[str, str], int] = {}

    # -- wiring ------------------------------------------------------------
    def register_endpoint(self, node: str, addr: RemoteAddress) -> None:
        """Teach the plane that ``addr`` (a listening address) belongs to
        ``node`` so outbound frames resolve their destination label."""
        with self._lock:
            self._endpoints[(addr.host, addr.port)] = node

    def install_client(self, transport, node: str) -> None:
        """Intercept ``transport``'s outbound REQUEST/MESSAGE frames as
        traffic originating at ``node``."""
        transport.fault_hook = self._make_hook(node)

    def install_server(self, transport, node: str) -> None:
        """Intercept ``transport``'s outbound RESPONSE frames as traffic
        originating at ``node`` (destination resolves to the wildcard —
        responses ride the requester's connection)."""
        transport.fault_hook = self._make_hook(node)

    def _make_hook(self, src: str) -> Callable:
        def hook(peer: Optional[RemoteAddress], data: bytes):
            return self.decide(src, self._node_of(peer), data)

        return hook

    def _node_of(self, peer: Optional[RemoteAddress]) -> Optional[str]:
        if peer is None:
            return None
        with self._lock:
            return self._endpoints.get((peer.host, peer.port))

    # -- fault configuration ----------------------------------------------
    def partition(self, a: str, b: str, symmetric: bool = True) -> None:
        """Block all traffic ``a → b`` (and ``b → a`` when symmetric)."""
        with self._lock:
            self._blocked.add((a, b))
            if symmetric:
                self._blocked.add((b, a))

    def isolate(self, node: str) -> None:
        """Full isolation: nothing in, nothing out."""
        with self._lock:
            self._blocked.add((node, WILDCARD))
            self._blocked.add((WILDCARD, node))

    def heal(self, a: Optional[str] = None, b: Optional[str] = None) -> None:
        """Remove partitions: ``heal()`` clears all, ``heal(a)`` clears
        every edge touching ``a``, ``heal(a, b)`` clears that pair only."""
        with self._lock:
            if a is None:
                self._blocked.clear()
            elif b is None:
                self._blocked = {
                    e for e in self._blocked if a not in e
                }
            else:
                self._blocked -= {(a, b), (b, a)}

    def set_rule(
        self,
        src: str = WILDCARD,
        dst: str = WILDCARD,
        drop: float = 0.0,
        duplicate: float = 0.0,
        delay_ms: int = 0,
        delay_jitter_ms: int = 0,
    ) -> None:
        """Probabilistic faults on an edge (wildcards match any node):
        ``drop``/``duplicate`` are per-frame probabilities; every delivered
        frame is deferred ``delay_ms`` plus a seeded jitter draw from
        ``[0, delay_jitter_ms]`` (jitter across frames IS reordering —
        frames overtake each other)."""
        with self._lock:
            self._rules[(src, dst)] = {
                "drop": drop,
                "duplicate": duplicate,
                "delay_ms": delay_ms,
                "delay_jitter_ms": delay_jitter_ms,
            }

    def clear_rules(self) -> None:
        with self._lock:
            self._rules.clear()

    # -- the decision point -------------------------------------------------
    def _edge_rng(self, src: str, dst: str) -> random.Random:
        key = (src, dst)
        rng = self._edge_rngs.get(key)
        if rng is None:
            # string seeding is stable across processes (unlike hash());
            # crc32 keeps the derived seed integral and readable in traces
            rng = random.Random(zlib.crc32(f"{self.seed}|{src}|{dst}".encode()))
            self._edge_rngs[key] = rng
        return rng

    def _find_rule(self, src: str, dst: Optional[str]) -> Optional[dict]:
        for key in (
            (src, dst),
            (src, WILDCARD),
            (WILDCARD, dst),
            (WILDCARD, WILDCARD),
        ):
            if key[1] is None and key != (WILDCARD, WILDCARD):
                continue
            rule = self._rules.get(key)  # type: ignore[arg-type]
            if rule is not None:
                return rule
        return None

    def decide(
        self, src: str, dst: Optional[str], data: bytes
    ) -> Optional[List[Tuple[float, bytes]]]:
        """Fault decision for one frame. Returns ``None`` (deliver
        normally), ``[]`` (drop), or a list of ``(delay_s, payload)``
        deliveries (delay/duplicate/reorder)."""
        with self._lock:
            blocked = (
                (src, dst) in self._blocked
                or (src, WILDCARD) in self._blocked
                or (WILDCARD, dst) in self._blocked
            )
            rule = self._find_rule(src, dst)
            edge = (src, dst or WILDCARD)
            seq = self._edge_seq.get(edge, 0)
            self._edge_seq[edge] = seq + 1
            if blocked:
                self.trace.append((seq, src, dst, "drop-partition", len(data)))
                return []
            if rule is None:
                self.trace.append((seq, src, dst, "pass", len(data)))
                return None
            rng = self._edge_rng(*edge)
            if rule["drop"] > 0 and rng.random() < rule["drop"]:
                self.trace.append((seq, src, dst, "drop", len(data)))
                return []
            delay = rule["delay_ms"]
            if rule["delay_jitter_ms"]:
                delay += rng.randrange(rule["delay_jitter_ms"] + 1)
            deliveries = [(delay / 1000.0, data)]
            verb = "delay" if delay else "pass"
            if rule["duplicate"] > 0 and rng.random() < rule["duplicate"]:
                deliveries.append((delay / 1000.0, data))
                verb = "duplicate"
            self.trace.append((seq, src, dst, verb, len(data)))
            return deliveries


class DiskFaults:
    """Disk-level crash simulation for ``SegmentedLogStorage`` and
    ``SnapshotStorage``. All methods operate on CLOSED/QUIESCENT state —
    they simulate what a kernel crash leaves behind, then the normal open
    path must recover."""

    # -- log storage --------------------------------------------------------
    @staticmethod
    def tear_log_tail(directory: str, nbytes: int = 7) -> str:
        """Cut ``nbytes`` off the last segment file — the on-disk state a
        crash mid-append leaves (a partial record frame at the tail).
        Returns the path of the torn segment."""
        segments = sorted(
            name for name in os.listdir(directory)
            if name.startswith("segment-") and name.endswith(".log")
        )
        if not segments:
            raise FileNotFoundError(f"no segments in {directory}")
        path = os.path.join(directory, segments[-1])
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(0, size - nbytes))
        return path

    @staticmethod
    def break_fsync(storage, times: int = 1) -> None:
        """Make the next ``times`` calls of ``storage.flush`` raise
        ``OSError`` (fsync failure), then restore the real flush."""
        real_flush = storage.flush
        state = {"left": times}

        def failing_flush():
            if state["left"] > 0:
                state["left"] -= 1
                raise OSError("injected fsync failure")
            storage.flush = real_flush
            real_flush()

        storage.flush = failing_flush

    # -- snapshot storage ---------------------------------------------------
    # crash points inside SnapshotStorage._swap_in's two-rename commit
    CRASH_TMP_WRITTEN = "tmp-written"    # tmp dir durable, no rename ran
    CRASH_OLD_ASIDE = "old-aside"        # old final moved aside, tmp not in
    CRASH_SWAPPED = "swapped"            # new final in, set-aside not deleted

    # additional crash point for MANIFEST (delta) snapshots: the new
    # segments are durable in segments/ but the manifest commit never ran —
    # they are orphans until GC'd, and the PREVIOUS snapshot must stay
    # fully restorable
    CRASH_SEGMENTS_WRITTEN = "segments-written"

    @classmethod
    def crash_snapshot_commit(
        cls, storage, metadata, payload: bytes, point: str
    ) -> None:
        """Replay ``SnapshotStorage.write(metadata, payload)`` but crash at
        ``point`` inside the two-rename commit, leaving exactly the on-disk
        state a real crash leaves. The next ``SnapshotStorage(root)`` open
        must salvage (restore the set-aside or delete the orphans)."""
        tmp = os.path.join(storage.root, metadata.dirname + ".tmp")
        final = os.path.join(storage.root, metadata.dirname)
        # the real writer populates the tmp dir (same files, same fsyncs) —
        # only the commit renames are simulated here
        storage.populate_blob_dir(tmp, payload)
        cls._crash_commit_renames(tmp, final, point)

    @classmethod
    def crash_manifest_commit(
        cls, storage, metadata, parts, reused, point: str
    ) -> None:
        """Replay ``SnapshotStorage.write_parts_delta`` (a delta/manifest
        snapshot take) but crash at ``point``: after the new segments are
        durable (``CRASH_SEGMENTS_WRITTEN``) or inside the manifest dir's
        two-rename commit. The previous snapshot's referenced segments must
        survive the crash AND the subsequent open+GC."""
        from zeebe_tpu_torch.log.snapshot import _pack_manifest, part_hash
        import zlib as _zlib

        entries = []
        for name, data in parts:
            h = part_hash(data)
            if not storage.has_segment(h):
                storage._write_segment(h, _zlib.compress(data, 1))
            entries.append({"n": name, "h": h, "l": len(data)})
        for e in reused:
            entries.append({"n": str(e["n"]), "h": str(e["h"]), "l": int(e["l"])})
        if point == cls.CRASH_SEGMENTS_WRITTEN:
            return
        entries.sort(key=lambda e: e["n"])
        manifest = _pack_manifest(entries)
        tmp = os.path.join(storage.root, metadata.dirname + ".tmp")
        final = os.path.join(storage.root, metadata.dirname)
        if os.path.exists(tmp):
            import shutil as _shutil

            _shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "manifest.bin"), "wb") as f:
            f.write(manifest)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "checksum.crc32"), "w") as f:
            f.write(str(_zlib.crc32(manifest)))
            f.flush()
            os.fsync(f.fileno())
        cls._crash_commit_renames(tmp, final, point)

    @classmethod
    def _crash_commit_renames(cls, tmp: str, final: str, point: str) -> None:
        if point == cls.CRASH_TMP_WRITTEN:
            return
        aside = final + ".aside"
        if os.path.exists(final):
            os.rename(final, aside)
        if point == cls.CRASH_OLD_ASIDE:
            return
        os.rename(tmp, final)
        if point == cls.CRASH_SWAPPED:
            return
        raise ValueError(f"unknown crash point {point!r}")


def replay_oracle(records, partition_id: int = 0, num_partitions: int = 1):
    """Replay committed ``records`` through a fresh host oracle engine with
    side effects suppressed (results are discarded — every follow-up they
    would produce is already IN the committed sequence), exactly the
    recovery replay contract. Returns the engine for state comparison."""
    from zeebe_tpu_torch.engine.interpreter import PartitionEngine, WorkflowRepository

    engine = PartitionEngine(
        partition_id=partition_id,
        num_partitions=num_partitions,
        repository=WorkflowRepository(),
        clock=lambda: 0,
    )
    for record in records:
        engine.process(record)
    return engine


def oracle_state_bytes(engine) -> bytes:
    """The engine's snapshot state under the data-only codec — the
    bit-identity witness for invariant 3."""
    from zeebe_tpu_torch.log import stateser

    return stateser.encode_state(engine.snapshot_state())


class ChaosHarness:
    """In-process ``ClusterBroker`` cluster with crash/restart and fault-
    plane wiring (the chaos analogue of the tests' ClusteringRule).

    ``crash(node)`` stops a broker (transports, scheduler, actors die; the
    data dir survives). ``restart(node)`` brings it back on fresh ephemeral
    ports and re-installs raft membership everywhere with the new
    addresses — the same re-bootstrap a deployment's service discovery
    performs. Combine with :class:`DiskFaults` between crash and restart
    to simulate torn writes.
    """

    def __init__(
        self,
        data_root: str,
        n_brokers: int = 3,
        partitions: int = 1,
        plane: Optional[FaultPlane] = None,
        engine_factory=None,
        cfg_tweaks: Optional[Callable] = None,
    ):
        from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker

        self._broker_cls = ClusterBroker
        self.data_root = data_root
        self.partitions = partitions
        self.plane = plane
        self.engine_factory = engine_factory
        self.cfg_tweaks = cfg_tweaks
        self.crashed: set = set()
        self.brokers: Dict[str, object] = {}
        for i in range(n_brokers):
            node = f"b{i}"
            self.brokers[node] = self._make_broker(node)
        nodes = list(self.brokers.values())
        for broker in nodes[1:]:
            broker.join([nodes[0].gossip_address]).join(10)
        for pid in range(partitions):
            addrs = {
                node: broker.open_partition(pid).join(10)
                for node, broker in self.brokers.items()
            }
            for node, broker in self.brokers.items():
                members = {n: a for n, a in addrs.items() if n != node}
                broker.bootstrap_partition(pid, members)
        if self.plane is not None:
            for node in self.brokers:
                self._adopt(node)

    def _make_cfg(self, node: str):
        from zeebe_tpu_torch.runtime.config import BrokerCfg

        cfg = BrokerCfg()
        cfg.network.client_port = 0
        cfg.network.management_port = 0
        cfg.network.subscription_port = 0
        cfg.metrics.port = 0
        cfg.metrics.enabled = False
        cfg.cluster.node_id = node
        cfg.cluster.partitions = self.partitions
        cfg.raft.heartbeat_interval_ms = 30
        cfg.raft.election_timeout_ms = 200
        cfg.gossip.probe_interval_ms = 50
        cfg.gossip.probe_timeout_ms = 250
        cfg.gossip.sync_interval_ms = 500
        cfg.data.snapshot_replication_period_ms = 300
        if self.cfg_tweaks is not None:
            self.cfg_tweaks(cfg)
        return cfg

    def _make_broker(self, node: str):
        return self._broker_cls(
            self._make_cfg(node),
            os.path.join(self.data_root, node),
            engine_factory=self.engine_factory,
        )

    def _adopt(self, node: str) -> None:
        """Wire one broker's transports into the fault plane."""
        broker = self.brokers[node]
        plane = self.plane
        plane.register_endpoint(node, broker.client_address)
        plane.register_endpoint(node, broker.subscription_server.address)
        plane.install_client(broker.client_transport, node)
        plane.install_server(broker.client_server, node)
        for server in broker.partitions.values():
            plane.register_endpoint(node, server.raft.address)
            plane.install_client(server.raft.client, node)
            plane.install_server(server.raft.server, node)

    # -- cluster queries ----------------------------------------------------
    def leader_of(self, pid: int = 0):
        for node, broker in self.brokers.items():
            if node in self.crashed:
                continue  # a closed broker's stale is_leader flag is a corpse
            server = broker.partitions.get(pid)
            if server is not None and server.is_leader:
                return broker
        return None

    def await_leaders(self, timeout: float = 60.0) -> None:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(
                self.leader_of(pid) is not None for pid in range(self.partitions)
            ):
                return
            time.sleep(0.02)
        raise AssertionError(
            "no leader within timeout: "
            + str({
                node: {
                    pid: p.is_leader for pid, p in broker.partitions.items()
                }
                for node, broker in self.brokers.items()
            })
        )

    def client(self, **kw):
        from zeebe_tpu_torch.gateway.cluster_client import ClusterClient

        return ClusterClient(
            [b.client_address for b in self.brokers.values()],
            num_partitions=self.partitions,
            **kw,
        )

    def partition_data_dir(self, node: str, pid: int = 0) -> str:
        return os.path.join(self.data_root, node, f"partition-{pid}")

    # -- chaos actions ------------------------------------------------------
    def crash(self, node: str) -> None:
        """Crash-stop a broker: transports, raft actors and scheduler die;
        the data dir stays for a later restart. (File buffers are flushed
        on close — use :class:`DiskFaults` on the data dir afterwards to
        simulate torn writes.)"""
        record_event("chaos", "crash-stop broker", node=node)
        self.crashed.add(node)
        self.brokers[node].close()

    def restart(self, node: str) -> None:
        """Bring a crashed broker back (fresh ephemeral ports) and re-
        install raft membership cluster-wide with the new addresses."""
        record_event("chaos", "restart broker", node=node)
        broker = self._make_broker(node)
        self.brokers[node] = broker
        self.crashed.discard(node)
        contact = next(
            (
                b.gossip_address
                for n, b in self.brokers.items()
                if n != node and n not in self.crashed
            ),
            None,
        )
        if contact is not None:
            broker.join([contact]).join(10)
        for pid in range(self.partitions):
            broker.open_partition(pid).join(10)
        for pid in range(self.partitions):
            addrs = {
                n: b.partitions[pid].raft.address
                for n, b in self.brokers.items()
                if n not in self.crashed and pid in b.partitions
            }
            for n, b in self.brokers.items():
                if n not in self.crashed and pid in b.partitions:
                    members = {m: a for m, a in addrs.items() if m != n}
                    b.bootstrap_partition(pid, members)
        if self.plane is not None:
            self._adopt(node)

    def close(self) -> None:
        for broker in self.brokers.values():
            try:
                broker.close()
            except Exception:  # noqa: BLE001 - already-crashed nodes
                pass
