"""ctypes bindings for the native runtime layer (native/*.cc).

Components (reference parity cited in the .cc files):
- ``RingBuffer`` — many-producer claim/commit ring buffer (the dispatcher,
  ``dispatcher/.../Dispatcher.java``).
- ``NativeLogStorage`` — segmented append-only storage, on-disk compatible
  with the Python backend (``FsLogStorage``).
- ``frame_scan`` / ``crc32`` — recovery-path frame validation.
- ``KvStore`` — keyed cold-state store with checkpoint/restore (zb-map +
  RocksDB ``StateController`` analogue).

The shared library is built on demand with ``g++`` (no pip deps); call
``available()`` to gate features on the toolchain being present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libzbtpu.so")
_SRC_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Build libzbtpu.so from native/. Returns an error string or None."""
    try:
        proc = subprocess.run(
            # the Makefile's TARGET names the JAX package's copy; a
            # variable given on make's command line overrides it
            ["make", "-C", os.path.abspath(_SRC_DIR),
             "TARGET=" + os.path.abspath(_LIB_PATH)],
            capture_output=True,
            text=True,
            timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"native build failed to run: {e}"
    if proc.returncode != 0:
        return f"native build failed:\n{proc.stdout}\n{proc.stderr}"
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        src_newer = False
        if os.path.exists(_LIB_PATH) and os.path.isdir(_SRC_DIR):
            lib_mtime = os.path.getmtime(_LIB_PATH)
            src_newer = any(
                os.path.getmtime(os.path.join(_SRC_DIR, f)) > lib_mtime
                for f in os.listdir(_SRC_DIR)
                if f.endswith((".cc", ".h"))
            )
        if not os.path.exists(_LIB_PATH) or src_newer:
            _build_error = _build()
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # stale or wrong-arch binary (e.g. left over from another
            # machine): force a full rebuild — the binary must go first,
            # else make's mtime check would skip compiling it again
            try:
                os.remove(_LIB_PATH)
            except OSError:
                pass
            _build_error = _build()
            if _build_error is not None:
                return None
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError as e:
                _build_error = f"built library failed to load: {e}"
                return None
        _bind(lib)
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.rb_create.restype = c.c_void_p
    lib.rb_create.argtypes = [c.c_int64]
    lib.rb_destroy.argtypes = [c.c_void_p]
    lib.rb_capacity.restype = c.c_int64
    lib.rb_capacity.argtypes = [c.c_void_p]
    lib.rb_claim.restype = c.c_int64
    lib.rb_claim.argtypes = [c.c_void_p, c.c_int32]
    lib.rb_buffer_ptr.restype = c.POINTER(c.c_uint8)
    lib.rb_buffer_ptr.argtypes = [c.c_void_p, c.c_int64]
    lib.rb_commit.argtypes = [c.c_void_p, c.c_int64]
    lib.rb_abort.argtypes = [c.c_void_p, c.c_int64]
    lib.rb_peek.restype = c.c_int32
    lib.rb_peek.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.rb_consume.argtypes = [c.c_void_p, c.c_int64, c.c_int32]
    lib.rb_offer.restype = c.c_int64
    lib.rb_offer.argtypes = [c.c_void_p, c.c_char_p, c.c_int32]
    lib.rb_poll.restype = c.c_int32
    lib.rb_poll.argtypes = [c.c_void_p, c.c_char_p, c.c_int32]

    lib.ls_open.restype = c.c_void_p
    lib.ls_open.argtypes = [c.c_char_p, c.c_int64]
    lib.ls_close.argtypes = [c.c_void_p]
    lib.ls_append.restype = c.c_int64
    lib.ls_append.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.ls_flush.restype = c.c_int
    lib.ls_flush.argtypes = [c.c_void_p]
    lib.ls_read.restype = c.c_int64
    lib.ls_read.argtypes = [c.c_void_p, c.c_int64, c.c_char_p, c.c_int64]
    lib.ls_segment_count.restype = c.c_int32
    lib.ls_segment_count.argtypes = [c.c_void_p]
    lib.ls_segment_id.restype = c.c_int32
    lib.ls_segment_id.argtypes = [c.c_void_p, c.c_int32]
    lib.ls_segment_data_size.restype = c.c_int64
    lib.ls_segment_data_size.argtypes = [c.c_void_p, c.c_int32]
    lib.ls_first_address.restype = c.c_int64
    lib.ls_first_address.argtypes = [c.c_void_p]
    lib.ls_truncate.restype = c.c_int
    lib.ls_truncate.argtypes = [c.c_void_p, c.c_int64]
    lib.ls_delete_before.restype = c.c_int32
    lib.ls_delete_before.argtypes = [c.c_void_p, c.c_int32]
    lib.ls_reset.restype = c.c_int
    lib.ls_reset.argtypes = [c.c_void_p]

    lib.frame_scan.restype = c.c_int64
    lib.frame_scan.argtypes = [
        c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.c_int64,
        c.POINTER(c.c_int64),
    ]
    lib.zb_crc32.restype = c.c_uint32
    lib.zb_crc32.argtypes = [c.c_char_p, c.c_int64, c.c_uint32]

    lib.kv_create.restype = c.c_void_p
    lib.kv_destroy.argtypes = [c.c_void_p]
    lib.kv_put.restype = c.c_int
    lib.kv_put.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.c_char_p, c.c_int64]
    lib.kv_get.restype = c.POINTER(c.c_uint8)
    lib.kv_get.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.POINTER(c.c_int64)]
    lib.kv_del.restype = c.c_int
    lib.kv_del.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.kv_count.restype = c.c_int64
    lib.kv_count.argtypes = [c.c_void_p]
    lib.kv_iter_next.restype = c.c_int64
    lib.kv_iter_next.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_int64), c.POINTER(c.POINTER(c.c_uint8)),
    ]
    lib.kv_checkpoint.restype = c.c_int
    lib.kv_checkpoint.argtypes = [c.c_void_p, c.c_char_p]
    lib.kv_restore.restype = c.c_void_p
    lib.kv_restore.argtypes = [c.c_char_p]


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class RingBuffer:
    """Dispatcher-equivalent claim/commit ring buffer (many producers, one
    consumer)."""

    def __init__(self, capacity: int = 1 << 20):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native layer unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.rb_create(capacity)
        if not self._h:
            raise ValueError("capacity must be a power of two >= 64")

    @property
    def capacity(self) -> int:
        return self._lib.rb_capacity(self._h)

    def offer(self, data: bytes) -> bool:
        """Publish one fragment; False on backpressure (ring full)."""
        result = self._lib.rb_offer(self._h, data, len(data))
        if result == -2:
            raise ValueError("fragment too large for ring")
        return result >= 0

    def poll(self) -> Optional[bytes]:
        """Consume one fragment; None when empty. Payloads are contiguous in
        the ring (claims never wrap — padding frames fill the tail), so the
        copy-out reads the exact committed length."""
        pos = ctypes.c_int64(0)
        n = self._lib.rb_peek(self._h, ctypes.byref(pos))
        if n == 0:
            return None
        data = ctypes.string_at(self._lib.rb_buffer_ptr(self._h, pos.value), n)
        self._lib.rb_consume(self._h, pos.value, n)
        return data

    def drain(self) -> List[bytes]:
        out = []
        while (item := self.poll()) is not None:
            out.append(item)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.rb_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeLogStorage:
    """C++ segmented log storage — drop-in for
    ``zeebe_tpu.log.storage.SegmentedLogStorage`` (same disk format)."""

    SEGMENT_HEADER_SIZE = 16

    def __init__(self, directory: str, segment_size: int = 64 * 1024 * 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native layer unavailable: {_build_error}")
        self._lib = lib
        self.directory = directory
        self.segment_size = segment_size
        os.makedirs(directory, exist_ok=True)
        self._h = lib.ls_open(directory.encode(), segment_size)
        if not self._h:
            raise OSError(f"cannot open log storage at {directory}")

    # address packing (same as the Python backend)
    @staticmethod
    def address(segment_id: int, offset: int) -> int:
        return (segment_id << 32) | offset

    @staticmethod
    def segment_of(address: int) -> int:
        return address >> 32

    @staticmethod
    def offset_of(address: int) -> int:
        return address & 0xFFFFFFFF

    def append(self, block) -> int:
        if not isinstance(block, bytes):
            # the batch codec hands the wave's single bytearray straight
            # through; the ctypes signature wants an immutable buffer
            block = bytes(block)
        addr = self._lib.ls_append(self._h, block, len(block))
        if addr < 0:
            raise OSError("append failed")
        return addr

    def flush(self) -> None:
        self._lib.ls_flush(self._h)

    def read(self, address: int, length: int) -> bytes:
        buf = ctypes.create_string_buffer(length)
        n = self._lib.ls_read(self._h, address, buf, length)
        if n < 0:
            raise OSError(f"read failed at {address:#x}")
        return buf.raw[:n]

    def read_segment(self, segment_id: int) -> bytes:
        size = self._lib.ls_segment_data_size(self._h, segment_id)
        if size < 0:
            raise OSError(f"no segment {segment_id}")
        return self.read(self.address(segment_id, self.SEGMENT_HEADER_SIZE), size)

    def iter_blocks(self):
        for i in range(self._lib.ls_segment_count(self._h)):
            sid = self._lib.ls_segment_id(self._h, i)
            data = self.read_segment(sid)
            yield self.address(sid, self.SEGMENT_HEADER_SIZE), data

    def first_address(self) -> Optional[int]:
        addr = self._lib.ls_first_address(self._h)
        return None if addr < 0 else addr

    @property
    def _segments(self) -> List[int]:
        """Sorted live segment ids (same bookkeeping view as the Python
        backend exposes; tests and compaction assertions read it)."""
        return [
            self._lib.ls_segment_id(self._h, i)
            for i in range(self._lib.ls_segment_count(self._h))
        ]

    def delete_segments_before(self, segment_id: int) -> int:
        return self._lib.ls_delete_before(self._h, segment_id)

    def reset(self) -> None:
        if self._lib.ls_reset(self._h) != 0:
            raise OSError("reset failed")

    def truncate(self, address: int) -> None:
        if self._lib.ls_truncate(self._h, address) != 0:
            raise OSError(f"truncate failed at {address:#x}")

    def close(self) -> None:
        if self._h:
            self._lib.ls_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def frame_scan(data: bytes, max_frames: int = 1 << 20) -> Tuple[List[int], int]:
    """Validate frames in ``data``; returns (frame offsets, valid prefix
    length). Native recovery-scan fast path."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native layer unavailable: {_build_error}")
    # frames are 8-aligned and >8 bytes, so a buffer holds < len/16 + 1
    cap = min(max_frames, len(data) // 16 + 1)
    offsets = (ctypes.c_int64 * cap)()
    valid_len = ctypes.c_int64(0)
    n = lib.frame_scan(data, len(data), offsets, cap, ctypes.byref(valid_len))
    return list(offsets[:n]), valid_len.value


def crc32(data: bytes, seed: int = 0) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native layer unavailable: {_build_error}")
    return lib.zb_crc32(data, len(data), seed)


class KvStore:
    """Keyed cold-state store with checkpoint/restore."""

    def __init__(self, _handle=None):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native layer unavailable: {_build_error}")
        self._lib = lib
        self._h = _handle if _handle is not None else lib.kv_create()

    def put(self, key: bytes, value: bytes) -> None:
        if self._lib.kv_put(self._h, key, len(key), value, len(value)) != 0:
            raise MemoryError("kv_put failed")

    def get(self, key: bytes) -> Optional[bytes]:
        vlen = ctypes.c_int64(0)
        ptr = self._lib.kv_get(self._h, key, len(key), ctypes.byref(vlen))
        if not ptr:
            return None
        return ctypes.string_at(ptr, vlen.value)

    def delete(self, key: bytes) -> bool:
        return bool(self._lib.kv_del(self._h, key, len(key)))

    def __len__(self) -> int:
        return self._lib.kv_count(self._h)

    def items(self) -> List[Tuple[bytes, bytes]]:
        cursor = ctypes.c_int64(0)
        key_ptr = ctypes.POINTER(ctypes.c_uint8)()
        klen = ctypes.c_int64(0)
        val_ptr = ctypes.POINTER(ctypes.c_uint8)()
        out = []
        while True:
            vlen = self._lib.kv_iter_next(
                self._h, ctypes.byref(cursor), ctypes.byref(key_ptr),
                ctypes.byref(klen), ctypes.byref(val_ptr),
            )
            if vlen < 0:
                break
            out.append(
                (ctypes.string_at(key_ptr, klen.value), ctypes.string_at(val_ptr, vlen))
            )
        return out

    def checkpoint(self, path: str) -> None:
        if self._lib.kv_checkpoint(self._h, path.encode()) != 0:
            raise OSError(f"checkpoint to {path} failed")

    @classmethod
    def restore(cls, path: str) -> "KvStore":
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native layer unavailable: {_build_error}")
        h = lib.kv_restore(path.encode())
        if not h:
            raise OSError(f"restore from {path} failed (missing or corrupt)")
        return cls(_handle=h)

    def close(self) -> None:
        if self._h:
            self._lib.kv_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
