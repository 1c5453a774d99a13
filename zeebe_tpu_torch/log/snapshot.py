"""Snapshot storage + controller: checkpoint/recover partition state.

Reference parity:
- ``logstreams/.../impl/snapshot/fs/FsSnapshotStorage.java`` /
  ``FsSnapshotController.java`` — snapshots on disk with checksums,
  temp-write then commit-rename.
- ``logstreams/.../state/StateSnapshotController.java`` /
  ``StateSnapshotMetadata.java`` — checkpoints keyed by
  (lastProcessedPosition, lastWrittenPosition, term); recovery picks the
  newest snapshot *valid against the log* (the written position must still
  exist — guards against a truncated/diverged log, the term check of
  ``StreamProcessorController.validateSnapshot:177-187``).

Resume contract (SURVEY.md §5 checkpoint/resume): recover best valid
snapshot, then REPLAY committed records after ``last_processed_position``
to rebuild state without re-executing side effects.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import re
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from zeebe_tpu_torch._events import count_event as _count_event, set_gauge as _set_gauge

logger = logging.getLogger(__name__)


class SnapshotPartError(Exception):
    """A committed snapshot's parts cannot be read back (missing/corrupt
    segment or manifest) — recovery skips the snapshot and tries an older
    one."""

_SNAPSHOT_DIR_RE = re.compile(r"^snapshot_(-?\d+)_(-?\d+)_(-?\d+)$")
_STATE_FILE = "state.bin"
_MANIFEST_FILE = "manifest.bin"
_CHECKSUM_FILE = "checksum.crc32"
_SEGMENTS_DIR = "segments"
_HASH_HEX_RE = re.compile(r"^[0-9a-f]{32}$")
# GC grace: segments younger than this are kept even when unreferenced —
# they may belong to a checkpoint/install whose manifest has not committed
# yet (the manifest dir rename is the commit point)
_SEGMENT_GC_GRACE_SEC = 120.0

MANIFEST_FORMAT = "zbtpu-snapshot-manifest-v1"


def part_hash(data: bytes) -> str:
    """Content address of an (uncompressed) snapshot part."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


@dataclasses.dataclass(frozen=True, order=True)
class SnapshotMetadata:
    """Reference: StateSnapshotMetadata.java (ordering = recency)."""

    last_processed_position: int
    last_written_position: int
    term: int = 0

    @property
    def dirname(self) -> str:
        return (
            f"snapshot_{self.last_processed_position}"
            f"_{self.last_written_position}_{self.term}"
        )

    @staticmethod
    def parse(dirname: str) -> Optional["SnapshotMetadata"]:
        m = _SNAPSHOT_DIR_RE.match(dirname)
        if not m:
            return None
        return SnapshotMetadata(int(m.group(1)), int(m.group(2)), int(m.group(3)))


class SnapshotStorage:
    """Directory of committed snapshots for one partition/processor.

    Layout: ``{root}/snapshot_{processed}_{written}_{term}/state.bin`` with a
    crc32 checksum file; writes go to a ``.tmp`` sibling and are committed by
    atomic rename (reference FsSnapshotStorage temp-write + commit).
    """

    # set-aside suffix used by _swap_in; ".old" is the legacy spelling
    # (pre-chaos-plane dirs) and is swept identically
    _ASIDE_SUFFIXES = (".aside", ".old")

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._sweep_orphans()

    def _sweep_orphans(self) -> None:
        """Crash-recovery sweep of the snapshot root (runs on open).

        ``.tmp`` dirs are torn writes — DELETED (never just skipped: a
        skipped orphan survives forever and later swap-ins trip over it).
        ``.aside`` set-aside dirs come from a crash between ``_swap_in``'s
        two renames: when the replacement never landed the set-aside IS the
        committed snapshot and is restored; when the final exists the
        set-aside is obsolete and DELETED. Every action logs a salvage
        event and counts into ``snapshot_salvage_events``."""
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if name.endswith(".tmp"):
                shutil.rmtree(path, ignore_errors=True)
                self._salvage("deleted torn temp dir %s", name)
                continue
            suffix = next(
                (s for s in self._ASIDE_SUFFIXES if name.endswith(s)), None
            )
            if suffix is None:
                continue
            final = path[: -len(suffix)]
            if os.path.exists(final):
                shutil.rmtree(path, ignore_errors=True)
                self._salvage(
                    "deleted orphaned set-aside %s (replacement committed)", name
                )
            else:
                os.rename(path, final)
                self._salvage(
                    "restored set-aside snapshot %s (replacement never landed)",
                    name,
                )

    def _salvage(self, fmt: str, *args) -> None:
        logger.warning("snapshot salvage in %s: " + fmt, self.root, *args)
        _count_event("snapshot_salvage_events")

    def _swap_in(self, tmp: str, final: str) -> None:
        """Commit ``tmp`` over ``final`` without ever unlinking a committed
        snapshot before its replacement is durable: move the old dir aside,
        rename the new one in, THEN delete the set-aside — a crash at any
        point leaves either the old or the new snapshot on disk
        (round-4 advisor finding on _commit_manifest)."""
        if os.path.exists(final):
            aside = final + ".aside"
            if os.path.exists(aside):
                shutil.rmtree(aside)
            os.rename(final, aside)
            os.rename(tmp, final)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.rename(tmp, final)  # the commit point

    def list(self) -> List[SnapshotMetadata]:
        """Committed snapshots, newest (highest positions) first."""
        out = []
        for name in os.listdir(self.root):
            meta = SnapshotMetadata.parse(name)
            if meta is not None:
                out.append(meta)
        out.sort(reverse=True)
        return out

    @staticmethod
    def populate_blob_dir(tmp: str, payload: bytes) -> None:
        """Write a single-blob snapshot's content (state + checksum, both
        fsync'd) into ``tmp``. Shared with the chaos plane's crash-point
        injector so simulated crashes leave exactly the on-disk layout a
        real one would."""
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _CHECKSUM_FILE), "w") as f:
            f.write(str(zlib.crc32(payload)))
            f.flush()
            os.fsync(f.fileno())

    def write(self, metadata: SnapshotMetadata, payload: bytes) -> None:
        tmp = os.path.join(self.root, metadata.dirname + ".tmp")
        final = os.path.join(self.root, metadata.dirname)
        self.populate_blob_dir(tmp, payload)
        self._swap_in(tmp, final)

    def read(self, metadata: SnapshotMetadata) -> Optional[bytes]:
        """Payload, or None if missing/corrupt (checksum mismatch)."""
        path = os.path.join(self.root, metadata.dirname)
        try:
            with open(os.path.join(path, _STATE_FILE), "rb") as f:
                payload = f.read()
            with open(os.path.join(path, _CHECKSUM_FILE)) as f:
                expected = int(f.read().strip())
        except (OSError, ValueError):
            return None
        if zlib.crc32(payload) != expected:
            return None
        return payload

    def delete(self, metadata: SnapshotMetadata) -> None:
        shutil.rmtree(os.path.join(self.root, metadata.dirname), ignore_errors=True)

    def purge_older_than(self, keep: SnapshotMetadata) -> None:
        """Reference: FsSnapshotStorage purges obsolete snapshots on commit."""
        for meta in self.list():
            if meta < keep:
                self.delete(meta)
        self.gc_segments()

    # -- incremental checkpoints: content-addressed segment store ----------
    # A snapshot is a manifest of named parts, each stored once per content
    # hash under segments/. Unchanged parts (fixed-capacity device tables,
    # deployed workflow resources) are shared across checkpoints, so the
    # per-checkpoint write cost tracks the CHANGED state, not total state
    # size — the analogue of RocksDB checkpoints hard-linking unchanged SST
    # files (logstreams/.../state/StateSnapshotController.java).

    def _segments_root(self) -> str:
        path = os.path.join(self.root, _SEGMENTS_DIR)
        os.makedirs(path, exist_ok=True)
        return path

    def _segment_path(self, h: str) -> str:
        if not _HASH_HEX_RE.match(h):
            raise ValueError(f"bad segment hash {h!r}")
        return os.path.join(self._segments_root(), h + ".seg")

    def has_segment(self, h: str) -> bool:
        return os.path.exists(self._segment_path(h))

    def read_segment(self, h: str) -> Optional[bytes]:
        """Compressed segment bytes as stored (the replication wire unit)."""
        try:
            with open(self._segment_path(h), "rb") as f:
                return f.read()
        except OSError:
            return None

    @staticmethod
    def verify_segment(
        h: str, compressed: bytes, length: int, exact: bool = True
    ) -> Optional[bytes]:
        """THE segment verification: bounded decompress + length +
        content-hash check, shared by local reads, follower installs and
        the replication fetch path (one implementation, so a future
        hardening cannot miss a copy). Returns the decompressed bytes or
        None; ``exact=False`` treats ``length`` as an upper bound."""
        try:
            d = zlib.decompressobj()
            data = d.decompress(compressed, length + 1)
            if d.unconsumed_tail or (
                len(data) != length if exact else len(data) > length
            ):
                return None
        except zlib.error:
            return None
        if part_hash(data) != h:
            return None
        return data

    def install_segment(
        self, h: str, compressed: bytes, max_len: int
    ) -> Optional[bytes]:
        """Verify + persist a fetched segment; returns the decompressed
        bytes (so the caller need not decompress again) or None on any
        violation. The content address makes the transfer self-verifying:
        the decompressed bytes must hash to ``h``."""
        data = self.verify_segment(h, compressed, max_len, exact=False)
        if data is None:
            return None
        self._write_segment(h, compressed)
        return data

    def _write_segment(self, h: str, compressed: bytes) -> None:
        path = self._segment_path(h)
        if os.path.exists(path):
            return
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(compressed)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def write_parts(
        self, metadata: SnapshotMetadata, parts: List[Tuple[str, bytes]]
    ) -> Dict[str, int]:
        """Commit a manifest snapshot; returns write-cost stats
        (``new_bytes`` is the incremental cost — bytes whose content hash
        was not already in the segment store)."""
        return self.write_parts_delta(metadata, parts, [])[0]

    def write_parts_delta(
        self,
        metadata: SnapshotMetadata,
        parts: List[Tuple[str, bytes]],
        reused: List[dict],
    ) -> Tuple[Dict[str, int], List[dict]]:
        """Commit a manifest snapshot from freshly encoded ``parts`` plus
        ``reused`` manifest entries (``{"n","h","l"}``) carried over from a
        previous take whose families did not change — those parts were
        never re-read, re-encoded or re-hashed; their segments are already
        in the store. Returns ``(stats, entries)`` with the committed
        manifest entries (the next take's delta base)."""
        stats = {"total_bytes": 0, "new_bytes": 0,
                 "parts": len(parts) + len(reused), "new_segments": 0,
                 "reused_parts": len(reused)}
        entries = []
        for name, data in parts:
            h = part_hash(data)
            stats["total_bytes"] += len(data)
            if not self.has_segment(h):
                self._write_segment(h, zlib.compress(data, 1))
                stats["new_bytes"] += len(data)
                stats["new_segments"] += 1
            entries.append({"n": name, "h": h, "l": len(data)})
        for e in reused:
            stats["total_bytes"] += int(e["l"])
            entries.append({"n": str(e["n"]), "h": str(e["h"]), "l": int(e["l"])})
        # canonical manifest order: sorted by part name, which puts the
        # "_root" part first ("_" < "a" < "h") — the streaming restore
        # relies on reading the root before any family part, and a delta
        # take's manifest is byte-identical to a full take's of the same
        # state regardless of which families were re-encoded
        entries.sort(key=lambda e: e["n"])
        self._commit_manifest(metadata, _pack_manifest(entries))
        return stats, entries

    def iter_parts(self, metadata: SnapshotMetadata):
        """Stream a snapshot's ``(name, payload)`` parts in manifest order,
        verifying each segment as it is read (one decompressed part in
        memory at a time — the restore-side analogue of the wave pipeline's
        per-family readback). Raises :class:`SnapshotPartError` on a
        missing/corrupt manifest or segment; legacy single-blob snapshots
        yield one ``("state", payload)`` part."""
        path = os.path.join(self.root, metadata.dirname)
        if os.path.exists(os.path.join(path, _STATE_FILE)):
            payload = self.read(metadata)
            if payload is None:
                raise SnapshotPartError(f"{metadata.dirname}: corrupt state blob")
            yield "state", payload
            return
        entries = self.manifest(metadata)
        if entries is None:
            raise SnapshotPartError(f"{metadata.dirname}: missing/corrupt manifest")
        for e in entries:
            name, h, length = str(e["n"]), str(e["h"]), int(e["l"])
            compressed = self.read_segment(h)
            if compressed is None:
                raise SnapshotPartError(
                    f"{metadata.dirname}: segment {h} of part {name!r} missing"
                )
            data = self.verify_segment(h, compressed, length)
            if data is None:
                raise SnapshotPartError(
                    f"{metadata.dirname}: segment {h} of part {name!r} "
                    "failed verification (corrupt/truncated/hash mismatch)"
                )
            yield name, data

    def _commit_manifest(self, metadata: SnapshotMetadata, manifest: bytes) -> None:
        """Atomic manifest commit: fsync'd tmp dir, rename = commit point."""
        tmp = os.path.join(self.root, metadata.dirname + ".tmp")
        final = os.path.join(self.root, metadata.dirname)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _MANIFEST_FILE), "wb") as f:
            f.write(manifest)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _CHECKSUM_FILE), "w") as f:
            f.write(str(zlib.crc32(manifest)))
            f.flush()
            os.fsync(f.fileno())
        self._swap_in(tmp, final)

    def manifest(self, metadata: SnapshotMetadata) -> Optional[List[dict]]:
        """Part list ``[{"n", "h", "l"}, ...]`` of a manifest snapshot, or
        None (missing / corrupt / legacy single-blob snapshot)."""
        path = os.path.join(self.root, metadata.dirname)
        try:
            with open(os.path.join(path, _MANIFEST_FILE), "rb") as f:
                raw = f.read()
            with open(os.path.join(path, _CHECKSUM_FILE)) as f:
                expected = int(f.read().strip())
        except (OSError, ValueError):
            return None
        if zlib.crc32(raw) != expected:
            return None
        return _unpack_manifest(raw)

    def install_manifest(
        self, metadata: SnapshotMetadata, entries: List[dict]
    ) -> bool:
        """Follower side: commit a manifest whose segments are already
        installed. Refuses if any referenced segment is missing."""
        for e in entries:
            if not self.has_segment(str(e["h"])):
                return False
        self._commit_manifest(metadata, _pack_manifest(entries))
        return True

    def read_parts(self, metadata: SnapshotMetadata) -> Optional[Dict[str, bytes]]:
        """Named part payloads of a snapshot (legacy single-blob snapshots
        come back as ``{"state": payload}``); None if missing/corrupt."""
        try:
            return dict(self.iter_parts(metadata))
        except SnapshotPartError:
            return None

    def gc_segments(self) -> int:
        """Delete segments referenced by no committed manifest (with a
        grace period for segments of an install in progress). Returns the
        number of files removed."""
        seg_root = os.path.join(self.root, _SEGMENTS_DIR)
        if not os.path.isdir(seg_root):
            return 0
        referenced = set()
        for meta in self.list():
            for e in self.manifest(meta) or []:
                referenced.add(str(e["h"]))
        removed = 0
        cutoff = time.time() - _SEGMENT_GC_GRACE_SEC
        for name in os.listdir(seg_root):
            if name.endswith(".seg"):
                if name[:-4] in referenced:
                    continue
            elif not name.endswith(".seg.tmp"):
                continue  # .tmp = torn write from a crash: GC after grace
            path = os.path.join(seg_root, name)
            try:
                if os.path.getmtime(path) > cutoff:
                    continue
                os.unlink(path)
                removed += 1
            except OSError:
                continue
        return removed


def _pack_manifest(entries: List[dict]) -> bytes:
    from zeebe_tpu_torch.protocol import msgpack

    return msgpack.pack({"fmt": MANIFEST_FORMAT, "parts": entries})


def _unpack_manifest(raw: bytes) -> Optional[List[dict]]:
    from zeebe_tpu_torch.protocol import msgpack

    try:
        doc = msgpack.unpack(raw)
    except Exception:
        return None
    if not isinstance(doc, dict) or doc.get("fmt") != MANIFEST_FORMAT:
        return None
    parts = doc.get("parts")
    if not isinstance(parts, list):
        return None
    out = []
    for e in parts:
        if not isinstance(e, dict):
            return None
        try:
            name, h, length = str(e["n"]), str(e["h"]), int(e["l"])
        except (KeyError, TypeError, ValueError):
            return None
        if not _HASH_HEX_RE.match(h) or length < 0:
            return None
        out.append({"n": name, "h": h, "l": length})
    return out


@dataclasses.dataclass
class PendingSnapshot:
    """A fenced capture awaiting its (possibly off-thread) commit: the
    dirty families' freshly encoded parts plus the previous manifest's
    entries for the clean ones. Produced by ``SnapshotController.capture``
    on the processing thread; ``commit`` does the hash/compress/fsync work
    and may run anywhere (it touches only this object and the storage)."""

    metadata: SnapshotMetadata
    parts: List[Tuple[str, bytes]]
    reused: List[dict]
    # families captured (None = full take); on commit failure the caller
    # re-marks these dirty so the next take re-captures them
    dirty: Optional[frozenset]
    capture_seconds: float = 0.0
    # set by cluster callers at capture time (engine state is unsafe to
    # read off-actor)
    compaction_floor: Optional[int] = None
    engine: Any = None


class SnapshotController:
    """Takes/recovers engine-state snapshots for one stream processor.

    The processor supplies ``snapshot_state() -> state dict`` and
    ``restore_state(obj)`` (the engine's analogue of the reference's
    ``SnapshotSupport`` composition: ComposedSnapshot over ZbMapSnapshotSupport
    / SerializableWrapper, FsSnapshotController.java).

    Engines that track dirty state families (``snapshot_dirty_families`` /
    ``snapshot_mark_clean`` / ``snapshot_mark_dirty``) get DELTA takes:
    ``capture`` encodes only dirty families and reuses the previous
    manifest's entries for clean ones — no device→host readback, no
    re-encode, no re-hash for unchanged state. The first take of a
    controller incarnation is always full (no delta base yet).

    Payloads are encoded with the explicit data-only codec
    (``zeebe_tpu.log.stateser``), never pickle: snapshots are fetched from
    cluster peers during replication and must be safe to decode untrusted
    (the reference replicates opaque RocksDB files; it never deserializes
    executable objects from peers).
    """

    def __init__(self, storage: SnapshotStorage):
        self.storage = storage
        # write-cost stats of the last take(): {"total_bytes", "new_bytes",
        # "parts", "new_segments", "reused_parts"} — new_bytes is the
        # incremental cost
        self.last_take_stats: Optional[Dict[str, int]] = None
        # name → manifest entry of the newest take committed by THIS
        # controller incarnation; the delta base. None forces a full take
        # (fresh boot, failed commit, or legacy-layout predecessor).
        self._delta_base: Optional[Dict[str, dict]] = None

    def take(self, state: Any, metadata: SnapshotMetadata) -> None:
        """Full take from an already-materialized state (legacy entry;
        engines with dirty tracking go through take_engine/capture)."""
        from zeebe_tpu_torch.log import stateser

        parts = stateser.encode_state_parts(state)
        stats, entries = self.storage.write_parts_delta(metadata, parts, [])
        self._finish_take(metadata, stats, entries)

    def take_engine(self, engine: Any, metadata: SnapshotMetadata) -> Dict[str, int]:
        """Capture + commit in one call (single-threaded brokers). Cluster
        brokers split the two so commit runs off the partition actor."""
        pending = self.capture(engine, metadata)
        try:
            return self.commit(pending)
        except BaseException:
            remark = getattr(engine, "snapshot_mark_dirty", None)
            if remark is not None:
                remark(pending.dirty)
            raise

    # -- capture (on the processing thread, at a wave boundary) ------------
    def capture(self, engine: Any, metadata: SnapshotMetadata) -> PendingSnapshot:
        """Fenced capture: grab + encode ONLY the dirty state families
        (full state when the engine has no tracking or no delta base
        exists). Resets the engine's dirty tracking — mutations from the
        moment capture returns belong to the next take. The pause this
        imposes on serving is the capture time, reported as the
        ``snapshot_capture_pause_seconds`` gauge; the expensive
        hash/compress/fsync work happens in :meth:`commit`."""
        from zeebe_tpu_torch.log import stateser

        t0 = time.perf_counter()
        dirty = None
        if self._delta_base is not None:
            dirty = getattr(engine, "snapshot_dirty_families", lambda: None)()
        reused: List[dict] = []
        if dirty is not None:
            reusable = self._reusable_entries(dirty)
            if reusable is None:
                dirty = None  # base segment vanished: full take
            else:
                reused = reusable
        parts: List[Tuple[str, bytes]] = []
        if dirty is not None:
            state = engine.snapshot_state(families=dirty)
            parts, clean = stateser.encode_state_parts_delta(state, dirty)
            if set(clean) != {e["n"] for e in reused}:
                # part layout drifted from the delta base (should not
                # happen mid-run) — take a full snapshot instead
                dirty = None
                reused = []
        if dirty is None:
            state = engine.snapshot_state()
            parts = stateser.encode_state_parts(state)
        mark_clean = getattr(engine, "snapshot_mark_clean", None)
        if mark_clean is not None:
            mark_clean()  # the capture fence: later mutations → next take
        capture_seconds = time.perf_counter() - t0
        _set_gauge(
            "snapshot_capture_pause_seconds", capture_seconds,
            "Serving pause imposed by the last snapshot capture (encode of "
            "dirty families only; commit runs off the serving path)",
        )
        return PendingSnapshot(
            metadata=metadata, parts=parts, reused=reused,
            dirty=dirty, capture_seconds=capture_seconds, engine=engine,
        )

    def _reusable_entries(self, dirty: frozenset) -> Optional[List[dict]]:
        """Delta-base entries of clean families, verified present in the
        segment store; None when any is gone (forces a full take)."""
        from zeebe_tpu_torch.log import stateser

        out: List[dict] = []
        for name, e in self._delta_base.items():
            family = stateser.part_family(name)
            if family is None or family in dirty:
                continue  # re-encoded on every take / captured as dirty
            if not self.storage.has_segment(str(e["h"])):
                return None
            out.append({"n": name, "h": str(e["h"]), "l": int(e["l"])})
        return out

    # -- commit (anywhere; touches only the pending capture + storage) -----
    def commit(self, pending: PendingSnapshot) -> Dict[str, int]:
        t0 = time.perf_counter()
        try:
            stats, entries = self.storage.write_parts_delta(
                pending.metadata, pending.parts, pending.reused
            )
        except BaseException:
            # on-disk state unknown: never build a delta on it
            self._delta_base = None
            raise
        self._finish_take(pending.metadata, stats, entries)
        _count_event(
            "snapshot_delta_takes" if pending.dirty is not None
            else "snapshot_full_takes",
        )
        _set_gauge(
            "snapshot_take_seconds",
            pending.capture_seconds + (time.perf_counter() - t0),
            "Duration of the last snapshot take (capture + commit)",
        )
        return stats

    def _finish_take(
        self, metadata: SnapshotMetadata, stats: Dict[str, int], entries: List[dict]
    ) -> None:
        self._delta_base = {
            str(e["n"]): {"h": str(e["h"]), "l": int(e["l"])} for e in entries
        }
        self.last_take_stats = stats
        _set_gauge(
            "snapshot_last_new_bytes", stats["new_bytes"],
            "Bytes of the last take not already in the segment store (the "
            "delta cost)",
        )
        _set_gauge(
            "snapshot_last_total_bytes", stats["total_bytes"],
            "Total uncompressed state bytes referenced by the last take",
        )
        self.storage.purge_older_than(metadata)

    def recover(self, log_last_position: int):
        """Newest snapshot whose written position is still on the log.

        Returns (state, metadata) or (None, None). Invalid/corrupt/
        unparseable snapshots are skipped (and the next older one is tried),
        mirroring ``StateSnapshotController.recover`` trying metadata
        candidates — each skip logs a warning naming the snapshot and
        counts into ``snapshot_recover_skipped``: every skip moves recovery
        one snapshot closer to a full-log replay, and operators should see
        that drift. Parts stream per family (one decompressed part in
        memory at a time) and the decode time reports as the
        ``snapshot_restore_seconds`` gauge."""
        from zeebe_tpu_torch.log import stateser

        t0 = time.perf_counter()
        for meta in self.storage.list():
            if meta.last_written_position > log_last_position:
                self._skip(meta, f"written position past log end {log_last_position}")
                continue  # log was truncated past this snapshot: stale
            try:
                state = stateser.decode_state_parts_stream(
                    self.storage.iter_parts(meta)
                )
            except (SnapshotPartError, stateser.SnapshotFormatError) as e:
                self._skip(meta, str(e))
                continue
            # zblint: disable=metrics-hot-loop (runs once: the loop returns right after)
            _set_gauge(
                "snapshot_restore_seconds", time.perf_counter() - t0,
                "Duration of the last snapshot recovery (read + streamed "
                "per-family decode; excludes log replay)",
            )
            return state, meta
        return None, None

    def _skip(self, meta: SnapshotMetadata, reason: str) -> None:
        logger.warning(
            "recovery in %s skipped snapshot %s (%s); falling back to an "
            "older snapshot or full-log replay",
            self.storage.root, meta.dirname, reason,
        )
        _count_event(
            "snapshot_recover_skipped",
            "Snapshots skipped during recovery (stale/corrupt/unreadable)",
        )
