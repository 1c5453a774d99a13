"""Partition→device placement over the accelerator mesh + frame exchange.

The serving plane historically ran every leader partition's engine on the
default device: 8 healthy chips (MULTICHIP_r05) and one of them doing all
the work. :class:`DevicePlan` is the missing map — it assigns each LEADER
partition a device (least-loaded with round-robin tie-break, which
degenerates to plain round-robin for sequential installs), rebalances on
leadership change (a step-down releases the slot; the next install lands
on the emptiest device), and survives device loss (``exclude`` moves the
dead device's partitions onto the remaining healthy ones — the caller
migrates live engine state via ``TpuPartitionEngine.place_on``).

With the plan in place the PR-8 ``WaveScheduler`` drain needs no new
mechanics to go wide: it already dispatches every partition's wave
segment (async, no device sync) before collecting the previous wave, so
segments landing on DIFFERENT devices compute concurrently across the
whole mesh within one scheduling round.

:class:`MeshExchange` is the cross-partition data plane of the meshed
serving plane: instead of the host subscription-transport hop, the
message-correlation command frames of one scheduling round ride the
device mesh through the same ``all_to_all`` exchange-slot machinery
``build_sharded_step`` uses (``tpu/shard.build_frame_exchange``). The
slots carry the ENCODED WIRE FRAMES — exactly the bytes the transport
would carry — so the record appended at the destination partition is
bit-identical to the unmeshed path by construction.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY, count_event

logger = logging.getLogger(__name__)


class DevicePlan:
    """Leader-partition → device placement over the visible mesh."""

    def __init__(self, devices=None, max_devices: int = 0):
        if devices is None:
            import torch

            devices = [
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count())
            ]
        devices = list(devices)
        if max_devices > 0:
            devices = devices[:max_devices]
        if not devices:
            raise ValueError("DevicePlan needs at least one device")
        self.devices = devices
        self._lock = threading.Lock()
        self._assigned: Dict[int, int] = {}  # partition id → device index
        # sharded-state partitions occupy a SPAN of devices (their tables
        # block-shard over the span's mesh axis); the primary index also
        # lives in _assigned so single-device queries keep working
        self._spans: Dict[int, List[int]] = {}
        self._excluded: set = set()
        self._rr = 0  # round-robin tie-break cursor
        self._device_gauges: Dict[int, object] = {}  # cached metric handles

    # -- queries -----------------------------------------------------------
    def healthy_indices(self) -> List[int]:
        with self._lock:
            return [
                i for i in range(len(self.devices)) if i not in self._excluded
            ]

    def device_index(self, partition_id: int) -> int:
        with self._lock:
            return self._assigned.get(partition_id, -1)

    def device_for(self, partition_id: int):
        idx = self.device_index(partition_id)
        return self.devices[idx] if idx >= 0 else None

    def assignments(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._assigned)

    def device_indices(self, partition_id: int) -> List[int]:
        """Every device index a partition occupies: its span when sharded,
        the single assignment otherwise, [] when unplaced."""
        with self._lock:
            sp = self._spans.get(partition_id)
            if sp is not None:
                return list(sp)
            idx = self._assigned.get(partition_id, -1)
            return [idx] if idx >= 0 else []

    def devices_for(self, partition_id: int) -> List:
        return [self.devices[i] for i in self.device_indices(partition_id)]

    def load(self) -> Dict[int, int]:
        """Partitions per device index (all devices, excluded included).
        A sharded partition counts on EVERY device of its span."""
        with self._lock:
            return self._load_locked(range(len(self.devices)))

    def _load_locked(self, indices) -> Dict[int, int]:
        counts = {i: 0 for i in indices}
        for pid, idx in self._assigned.items():
            sp = self._spans.get(pid)
            for i in (sp if sp is not None else (idx,)):
                if i in counts:
                    counts[i] += 1
        return counts

    # -- placement ---------------------------------------------------------
    def assign(self, partition_id: int) -> int:
        """Place a partition (sticky: re-assigning a placed partition keeps
        its device). Least-loaded healthy device wins; ties resolve
        round-robin so sequential leadership installs spread like a plain
        round-robin over the mesh. Returns the device index."""
        with self._lock:
            idx = self._assigned.get(partition_id)
            if idx is not None and idx not in self._excluded:
                return idx
            idx = self._pick_locked()
            self._assigned[partition_id] = idx
        count_event(
            "mesh_partition_assigns",
            "Leader partitions placed onto a mesh device",
        )
        self._publish_load()
        return idx

    def assign_span(self, partition_id: int, span: int) -> List[int]:
        """Place a SHARDED-state partition across ``span`` devices — the
        mesh span its tables block-shard over (engine ``state_shards``).
        Sticky like :meth:`assign`; picks the least-loaded healthy
        devices (index tie-break) and returns their indices in mesh
        order. The first is the primary that ``device_index`` reports."""
        if span <= 1:
            return [self.assign(partition_id)]
        with self._lock:
            got = self._spans.get(partition_id)
            if got is not None and not (set(got) & self._excluded):
                return list(got)
            chosen = self._pick_span_locked(span)
            self._spans[partition_id] = chosen
            self._assigned[partition_id] = chosen[0]
        count_event(
            "mesh_span_assigns",
            "Sharded-state partitions placed across a mesh device span",
        )
        self._publish_load()
        return list(chosen)

    def _pick_span_locked(self, span: int) -> List[int]:
        healthy = [
            i for i in range(len(self.devices)) if i not in self._excluded
        ]
        if len(healthy) < span:
            raise RuntimeError(
                f"DevicePlan: sharded span {span} exceeds the "
                f"{len(healthy)} healthy devices"
            )
        counts = self._load_locked(healthy)
        return sorted(sorted(healthy, key=lambda i: (counts[i], i))[:span])

    def _pick_locked(self) -> int:
        healthy = [
            i for i in range(len(self.devices)) if i not in self._excluded
        ]
        if not healthy:
            raise RuntimeError("DevicePlan: every device is excluded")
        counts = self._load_locked(healthy)
        low = min(counts.values())
        # rotate the tie-break start so equal-load devices fill in order
        n = len(healthy)
        for k in range(n):
            cand = healthy[(self._rr + k) % n]
            if counts[cand] == low:
                self._rr = (healthy.index(cand) + 1) % n
                return cand
        return healthy[0]  # unreachable

    def release(self, partition_id: int) -> None:
        """Leadership left this partition: free its slot so the next
        install (here or elsewhere) rebalances onto the emptiest device."""
        with self._lock:
            removed = self._assigned.pop(partition_id, None)
            self._spans.pop(partition_id, None)
        if removed is not None:
            count_event(
                "mesh_partition_releases",
                "Leader partitions released from their mesh device "
                "(step-down / close)",
            )
            self._publish_load()

    # -- device health -----------------------------------------------------
    def exclude(self, device_index: int) -> Dict[int, int]:
        """Mark a device dead/excluded and move its partitions onto the
        remaining healthy devices. Returns {partition_id: new device index}
        for the caller to migrate live engine state (``place_on``)."""
        moves: Dict[int, int] = {}
        with self._lock:
            self._excluded.add(device_index)
            victims = [
                pid for pid, idx in self._assigned.items()
                if idx == device_index
                or device_index in self._spans.get(pid, ())
            ]
            spans = {
                pid: len(self._spans[pid])
                for pid in victims if pid in self._spans
            }
            for pid in victims:
                del self._assigned[pid]
                self._spans.pop(pid, None)
            for pid in victims:
                if pid in spans:
                    # a sharded partition re-spans over the survivors; the
                    # caller rebuilds its engine on the new span (the
                    # sharded engine is pinned — no live place_on)
                    chosen = self._pick_span_locked(spans[pid])
                    self._spans[pid] = chosen
                    self._assigned[pid] = chosen[0]
                    moves[pid] = chosen[0]
                else:
                    moves[pid] = self._pick_locked()
                    self._assigned[pid] = moves[pid]
        if moves:
            count_event(
                "mesh_rebalance_moves",
                "Partitions moved to another device by a rebalance "
                "(device exclusion)",
                delta=len(moves),
            )
        self._publish_load()
        return moves

    def readmit(self, device_index: int) -> None:
        with self._lock:
            self._excluded.discard(device_index)
        self._publish_load()

    def _publish_load(self) -> None:
        load = self.load()
        for idx, n in load.items():
            handle = self._device_gauges.get(idx)
            if handle is None:
                handle = GLOBAL_REGISTRY.gauge(
                    "mesh_device_partitions",
                    "Leader partitions currently placed on each mesh device",
                    device=str(idx),
                )
                self._device_gauges[idx] = handle
            handle.set(n)
        GLOBAL_REGISTRY.gauge(
            "mesh_devices_healthy",
            "Mesh devices currently accepting partition placements",
        ).set(len(self.devices) - len(self._excluded))


class MeshExchange:
    """Cross-partition command frames over the mesh's ``all_to_all``.

    ``queue`` buffers one encoded record frame addressed from a source
    device to a destination device (and destination PARTITION — several
    partitions may share a device); ``flush`` runs ONE collective exchange
    for everything queued and hands each arrival to the caller's deliver
    callback in deterministic order (destination device → source device →
    slot, which per (src, dst) pair preserves queue order).

    Frames larger than ``frame_bytes`` or beyond the ``slots`` budget of
    their (src, dst) pair are REFUSED (``queue`` returns False) and the
    caller falls back to the host transport hop — counted, never dropped.
    """

    def __init__(self, devices, slots: int = 32, frame_bytes: int = 1024):
        import numpy as np  # noqa: F401 - verified importable at build

        from zeebe_tpu_torch.tpu import shard

        self.devices = list(devices)
        if len(self.devices) < 2:
            raise ValueError("MeshExchange needs at least two devices")
        self.slots = int(slots)
        self.frame_bytes = int(frame_bytes)
        mesh = shard.Mesh(self.devices, "exchange")
        self._step = shard.build_frame_exchange(
            mesh, self.slots, self.frame_bytes
        )
        self._n = len(self.devices)
        # queued[src][dst] = list of (dst_pid, frame)
        self._queued: Dict[int, Dict[int, List]] = {}
        self._count = 0
        # fallbacks can burst at per-frame rate under sustained slot
        # overflow — rate-limit the flight-ring entries so an overloaded
        # mesh cannot evict the control-plane history (the
        # mesh_exchange_fallbacks counter stays exact)
        from zeebe_tpu_torch.tracing.recorder import RateLimitedEvent

        self._fallback_event = RateLimitedEvent(
            "mesh", "frames fell back to transport"
        )

    def pending(self) -> int:
        return self._count

    def queue(
        self, src_device: int, dst_device: int, dst_partition: int,
        frame: bytes,
    ) -> bool:
        if not (0 <= src_device < self._n and 0 <= dst_device < self._n):
            return False
        if len(frame) > self.frame_bytes:
            count_event(
                "mesh_exchange_fallbacks",
                "Cross-partition frames routed over the host transport "
                "because they did not fit the mesh exchange slots",
            )
            self._fallback_event.record(
                why="oversize", src=src_device, dst=dst_device,
                bytes=len(frame),
            )
            return False
        per_dst = self._queued.setdefault(src_device, {})
        block = per_dst.setdefault(dst_device, [])
        if len(block) >= self.slots:
            count_event(
                "mesh_exchange_fallbacks",
                "Cross-partition frames routed over the host transport "
                "because they did not fit the mesh exchange slots",
            )
            self._fallback_event.record(
                why="pair slots full", src=src_device, dst=dst_device,
                slots=self.slots,
            )
            return False
        block.append((dst_partition, frame))
        self._count += 1
        return True

    def flush(self, deliver: Callable[[int, bytes], None]) -> int:
        """Exchange everything queued; ``deliver(dst_partition, frame)``
        per arrival. Returns the number of frames delivered. The mesh hop
        is an OPTIMIZATION, never a durability boundary: the frames also
        sit in host memory, so a failing collective delivers them
        directly (counted) instead of dropping the round's commands — a
        lost subscription OPEN would wedge its instance forever, which
        the transport path this replaces never does."""
        import numpy as np

        if not self._count:
            return 0
        n, s, b = self._n, self.slots, self.frame_bytes
        buf = np.zeros((n, n, s, b), np.uint8)
        lens = np.full((n, n, s), -1, np.int32)
        pids = np.full((n, n, s), -1, np.int32)
        for src, per_dst in self._queued.items():
            for dst, block in per_dst.items():
                for slot, (pid, frame) in enumerate(block):
                    buf[src, dst, slot, : len(frame)] = np.frombuffer(
                        frame, np.uint8
                    )
                    lens[src, dst, slot] = len(frame)
                    pids[src, dst, slot] = pid
        queued, snapshot = self._count, self._queued
        self._queued = {}
        self._count = 0

        def safe_deliver(pid: int, frame: bytes) -> bool:
            try:
                deliver(pid, frame)
                return True
            except Exception:  # noqa: BLE001 - one bad frame must not
                # strand the rest of the round's arrivals
                count_event(
                    "mesh_exchange_flush_failures",
                    "Mesh exchange frame deliveries that raised",
                )
                logger.exception(
                    "mesh exchange delivery failed for partition %d", pid
                )
                return False

        try:
            out_buf, out_lens, out_pids = self._step(buf, lens, pids)
            out_buf = np.asarray(out_buf)
            out_lens = np.asarray(out_lens)
            out_pids = np.asarray(out_pids)
        except Exception:  # noqa: BLE001 - collective failed: fall back
            # to direct host delivery of the snapshot (per-pair order
            # preserved)
            count_event(
                "mesh_exchange_flush_failures",
                "Mesh exchange frame deliveries that raised",
            )
            logger.exception(
                "mesh exchange collective failed; delivering %d frames "
                "directly", queued,
            )
            delivered = 0
            for src in sorted(snapshot):
                for dst in sorted(snapshot[src]):
                    for pid, frame in snapshot[src][dst]:
                        if safe_deliver(pid, frame):
                            delivered += 1
            return delivered
        delivered = 0
        # arrivals per destination device, ordered by source device then
        # slot (all_to_all preserves slot order per pair)
        for dst in range(n):
            for src in range(n):
                for slot in range(s):
                    length = int(out_lens[dst, src, slot])
                    if length < 0:
                        continue
                    if safe_deliver(
                        int(out_pids[dst, src, slot]),
                        out_buf[dst, src, slot, :length].tobytes(),
                    ):
                        delivered += 1
        if delivered:
            count_event(
                "mesh_exchange_frames",
                "Cross-partition command frames delivered over the mesh "
                "all_to_all exchange (instead of the host transport hop)",
                delta=delivered,
            )
        if delivered != queued:  # pragma: no cover - exchange invariant
            logger.error(
                "mesh exchange delivered %d of %d queued frames",
                delivered, queued,
            )
        return delivered
