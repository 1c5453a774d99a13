"""Segmented append-only log storage.

Reference parity: ``logstreams/.../impl/log/fs/FsLogStorage.java`` (512 LoC;
segments, addresses = (segmentId, offset), block append, truncate, recovery
scan) and ``FsLogSegment.java``.

This is the pure-Python backend; ``native/log_storage.cc`` provides a C++
mmap backend with the same on-disk format (selected via
``SegmentedLogStorage(native=True)`` once built).
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

from zeebe_tpu_torch._events import count_event as _count_event

logger = logging.getLogger(__name__)

SEGMENT_MAGIC = 0x5A4C4F47  # "ZLOG"
SEGMENT_HEADER = struct.Struct("<IIq")  # magic, segment_id, start_offset_unused
SEGMENT_HEADER_SIZE = SEGMENT_HEADER.size

DEFAULT_SEGMENT_SIZE = 64 * 1024 * 1024  # reference default is 512M; smaller here

# Shared record-frame prefix (protocol/codec.py layout): u32 frame_length
# (total, including itself), u32 crc32 over bytes [8:frame_length). The
# storage layer validates this prefix on reopen to find a torn tail; the
# full decode stays the codec's concern.
_FRAME_PREFIX = struct.Struct("<iI")


def _has_resync_frame(data: bytes, start: int) -> bool:
    """Does any byte position after ``start`` begin a valid frame? True
    means the invalid region does not extend to EOF — intact frames follow
    the corruption, which a torn append can never produce (a crash leaves
    at most one partial frame, at the tail)."""
    for pos in range(start + 1, len(data) - _FRAME_PREFIX.size + 1):
        frame_len, crc = _FRAME_PREFIX.unpack_from(data, pos)
        if frame_len < _FRAME_PREFIX.size or pos + frame_len > len(data):
            continue
        if zlib.crc32(data[pos + 8 : pos + frame_len]) == crc:
            return True
    return False


class SegmentedLogStorage:
    """Append-only storage of opaque blocks across size-bounded segment files.

    Addresses are ``(segment_id << 32) | byte_offset`` — the reference packs
    (segmentId, offset) into a long the same way.

    ``native=True`` serves the same on-disk format through the C++ mmap
    backend (``native/log_storage.cc``); it requires the native toolchain
    (``zeebe_tpu.native.available()``) and raises when missing rather than
    silently falling back — an operator asking for the native backend
    should not unknowingly run the Python one.
    """

    def __new__(cls, directory: str, segment_size: int = DEFAULT_SEGMENT_SIZE,
                native: bool = False):
        if native and cls is SegmentedLogStorage:
            from zeebe_tpu_torch import native as native_mod

            if not native_mod.available():
                raise RuntimeError(
                    "native log storage requested but the native layer is "
                    f"unavailable: {native_mod.build_error()}"
                )
            return native_mod.NativeLogStorage(directory, segment_size)
        return object.__new__(cls)

    def __init__(self, directory: str, segment_size: int = DEFAULT_SEGMENT_SIZE,
                 native: bool = False):
        del native  # handled by __new__ (this body only runs for the Python backend)
        self.directory = directory
        self.segment_size = segment_size
        os.makedirs(directory, exist_ok=True)
        self._segments: List[int] = []  # segment ids, sorted
        self._current_file = None
        self._current_id = -1
        self._current_size = 0
        self._open()

    # -- address packing ---------------------------------------------------
    @staticmethod
    def address(segment_id: int, offset: int) -> int:
        return (segment_id << 32) | offset

    @staticmethod
    def segment_of(address: int) -> int:
        return address >> 32

    @staticmethod
    def offset_of(address: int) -> int:
        return address & 0xFFFFFFFF

    # -- lifecycle ---------------------------------------------------------
    def _segment_path(self, segment_id: int) -> str:
        return os.path.join(self.directory, f"segment-{segment_id:06d}.log")

    def _open(self) -> None:
        existing = sorted(
            int(name[len("segment-") : -len(".log")])
            for name in os.listdir(self.directory)
            if name.startswith("segment-") and name.endswith(".log")
        )
        self._segments = existing
        if existing:
            last = existing[-1]
            path = self._segment_path(last)
            self._current_file = open(path, "r+b")
            self._current_file.seek(0, os.SEEK_END)
            self._current_size = self._current_file.tell()
            self._current_id = last
            self._truncate_torn_tail()
        else:
            self._roll_segment(0)

    def _truncate_torn_tail(self) -> None:
        """Crash recovery for the current (last) segment: walk its record
        frames validating the shared length+crc32 prefix and truncate the
        file to the last whole record. Without this, a torn append poisons
        replay — recovery's scan stops at the partial frame, but new appends
        land AFTER it, so every record written post-restart is unreachable.

        Only the last segment can be torn (appends never touch earlier
        ones). Opaque non-record payloads are left alone: if the FIRST frame
        after the header does not validate, the segment is treated as
        opaque and not scanned (raw-block users of this storage)."""
        f = self._current_file
        f.seek(0)
        header = f.read(SEGMENT_HEADER_SIZE)
        if len(header) < SEGMENT_HEADER_SIZE or (
            SEGMENT_HEADER.unpack(header)[0] != SEGMENT_MAGIC
        ):
            # crash during _roll_segment: the header itself is torn — the
            # segment never held a record, rewrite it empty
            logger.warning(
                "segment %s: torn header (%d bytes), rewriting empty",
                self._segment_path(self._current_id), len(header),
            )
            f.seek(0)
            f.truncate(0)
            f.write(SEGMENT_HEADER.pack(SEGMENT_MAGIC, self._current_id, 0))
            f.flush()
            self._current_size = SEGMENT_HEADER_SIZE
            _count_event("log_torn_tail_truncations")
            return
        data = f.read()
        offset = 0
        while offset < len(data):
            if len(data) - offset < _FRAME_PREFIX.size:
                break
            frame_len, crc = _FRAME_PREFIX.unpack_from(data, offset)
            if frame_len < _FRAME_PREFIX.size or offset + frame_len > len(data):
                break
            if zlib.crc32(data[offset + 8 : offset + frame_len]) != crc:
                break
            offset += frame_len
        if offset == 0 and data:
            return  # opaque content: never truncate what we can't parse
        valid_end = SEGMENT_HEADER_SIZE + offset
        if valid_end < SEGMENT_HEADER_SIZE + len(data):
            if _has_resync_frame(data, offset):
                # A later frame validates, so the invalid region does NOT
                # reach EOF: this is mid-file corruption (bitrot, external
                # tampering), not the single partial frame a crashed append
                # leaves. Truncation is still the only state that lets
                # replay and appends proceed — records are positionally
                # sequential, so the suffix is unreachable either way, and
                # raft re-replicates it from the leader — but it discards
                # INTACT frames, so escalate past the benign-tail warning.
                logger.error(
                    "segment %s: CRC failure at %d with valid frames after "
                    "it — mid-file corruption, not a torn tail; discarding "
                    "the suffix (%d bytes) including intact records",
                    self._segment_path(self._current_id), valid_end,
                    len(data) - offset,
                )
                _count_event("log_midfile_corruption")
            else:
                logger.warning(
                    "segment %s: torn tail at %d (%d bytes discarded)",
                    self._segment_path(self._current_id), valid_end,
                    len(data) - offset,
                )
            f.truncate(valid_end)
            f.flush()
            self._current_size = valid_end
            _count_event("log_torn_tail_truncations")

    def _roll_segment(self, segment_id: int) -> None:
        if self._current_file is not None:
            self._current_file.flush()
            self._current_file.close()
        path = self._segment_path(segment_id)
        self._current_file = open(path, "w+b")
        self._current_file.write(SEGMENT_HEADER.pack(SEGMENT_MAGIC, segment_id, 0))
        self._current_size = SEGMENT_HEADER_SIZE
        self._current_id = segment_id
        self._segments.append(segment_id)

    def close(self) -> None:
        if self._current_file is not None:
            self._current_file.flush()
            self._current_file.close()
            self._current_file = None

    def _ensure_open(self) -> None:
        """Reopen the current segment after ``close()``. An append can
        legally arrive after the storage was closed (broker shutdown races
        a late drain; seen as ``AttributeError: 'NoneType' ... 'seek'`` in
        the BENCH_r05 tail) — reopening is cheap and keeps the address
        sequence intact."""
        if self._current_file is None:
            self._current_file = open(self._segment_path(self._current_id), "r+b")
            self._current_file.seek(0, os.SEEK_END)
            self._current_size = self._current_file.tell()

    # -- append / read -----------------------------------------------------
    def append(self, block: bytes) -> int:
        """Append a block; returns its address."""
        self._ensure_open()
        if self._current_size + len(block) > self.segment_size and self._current_size > SEGMENT_HEADER_SIZE:
            self._roll_segment(self._current_id + 1)
        address = self.address(self._current_id, self._current_size)
        self._current_file.seek(self._current_size)
        self._current_file.write(block)
        self._current_size += len(block)
        return address

    def delete_segments_before(self, segment_id: int) -> int:
        """Delete whole segment files with id < ``segment_id`` (log
        compaction floor — reference: the broker deletes segments below the
        committed snapshot position). Never deletes the current segment.
        Returns the number of segments removed."""
        removed = 0
        for sid in list(self._segments):
            if sid >= segment_id or sid == self._current_id:
                break
            try:
                os.remove(self._segment_path(sid))
            except OSError:
                break
            self._segments.remove(sid)
            removed += 1
        return removed

    def flush(self) -> None:
        if self._current_file is not None:
            self._current_file.flush()
            os.fsync(self._current_file.fileno())
            # fsync count vs log_group_commit_coalesced = how well the
            # group-commit plane amortizes the durability round trip
            _count_event("log_fsyncs")

    def read(self, address: int, length: int) -> bytes:
        segment_id = self.segment_of(address)
        offset = self.offset_of(address)
        if segment_id == self._current_id and self._current_file is not None:
            self._current_file.flush()
        with open(self._segment_path(segment_id), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def read_segment(self, segment_id: int) -> bytes:
        if segment_id == self._current_id and self._current_file is not None:
            self._current_file.flush()
        with open(self._segment_path(segment_id), "rb") as f:
            f.seek(SEGMENT_HEADER_SIZE)
            return f.read()

    def iter_blocks(self) -> Iterator[Tuple[int, bytes]]:
        """Recovery scan: yields (address, segment_bytes) per segment; framing
        of records inside the segment is the codec's concern."""
        for segment_id in list(self._segments):
            data = self.read_segment(segment_id)
            yield self.address(segment_id, SEGMENT_HEADER_SIZE), data

    def first_address(self) -> Optional[int]:
        if not self._segments:
            return None
        return self.address(self._segments[0], SEGMENT_HEADER_SIZE)

    # -- truncate (test/failure injection; reference FsLogStorage.truncate) --
    def reset(self) -> None:
        """Delete ALL segments and roll a fresh one (snapshot fast-forward:
        the installed snapshot supersedes everything on disk)."""
        if self._current_file is not None:
            self._current_file.close()
        self._current_file = None
        for sid in list(self._segments):
            try:
                os.unlink(self._segment_path(sid))
            except OSError:
                pass
        self._segments = []
        self._roll_segment(0)

    def truncate(self, address: int) -> None:
        self._ensure_open()
        segment_id = self.segment_of(address)
        offset = self.offset_of(address)
        for sid in [s for s in self._segments if s > segment_id]:
            os.unlink(self._segment_path(sid))
            self._segments.remove(sid)
        if self._current_id != segment_id:
            self._current_file.close()
            self._current_file = open(self._segment_path(segment_id), "r+b")
            self._current_id = segment_id
        self._current_file.truncate(offset)
        self._current_file.seek(offset)
        self._current_size = offset
