"""Minimal MessagePack codec.

The reference stores every record value and payload document as MessagePack
(reference: ``msgpack-core/src/main/java/io/zeebe/msgpack/spec/MsgPackWriter.java``,
``MsgPackReader.java``). This is a fresh, small, dependency-free implementation
of the subset of the spec the engine needs: nil, bool, int, float64, str,
bin, array, map.

Payloads on the device are columnarized (see ``zeebe_tpu.engine.variables``);
this codec is the host-side boundary format for logs, clients, and parity
with reference semantics (documents compare equal iff their canonical
key-ordered encoding is equal).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

EMPTY_DOCUMENT = b"\x80"  # fixmap of size 0 (reference MsgPackHelper.EMTPY_OBJECT)


_BH = struct.Struct(">BH")
_BI = struct.Struct(">BI")
_BQ = struct.Struct(">BQ")
_Bh = struct.Struct(">Bh")
_Bi = struct.Struct(">Bi")
_Bq = struct.Struct(">Bq")
_D = struct.Struct(">d")


def pack(obj: Any) -> bytes:
    out = bytearray()
    _pack_into(out, obj)
    return bytes(out)


def _pack_into(out: bytearray, obj: Any) -> None:
    # exact-type dispatch first: this packer encodes every record value on
    # the log-append hot path, and the common cases (str keys, small ints,
    # flat dicts) must not wade through an isinstance chain. Subclasses
    # (IntEnum, str subtypes) fall through to the general chain below —
    # byte output is IDENTICAL either way.
    t = type(obj)
    if t is str:
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 256:
            out.append(0xD9)
            out.append(n)
        elif n < 65536:
            out += _BH.pack(0xDA, n)
        else:
            out += _BI.pack(0xDB, n)
        out += data
        return
    if t is int:
        if 0 <= obj < 128:
            out.append(obj)
        else:
            _pack_int(out, obj)
        return
    if t is dict:
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 65536:
            out += _BH.pack(0xDE, n)
        else:
            out += _BI.pack(0xDF, n)
        for k, v in obj.items():
            # the msgpack spec allows any key type; record documents use
            # str keys (reference wire parity), engine-state snapshots
            # (log/stateser.py) also use int keys (entity-key maps).
            # Short str keys and scalar values pack INLINE — a record
            # document is ~2 map entries per recursive call otherwise,
            # and the call overhead dominated the append-path profile
            tk = type(k)
            if tk is str:
                data = k.encode("utf-8")
                kn = len(data)
                if kn < 32:
                    out.append(0xA0 | kn)
                    out += data
                else:
                    _pack_into(out, k)
            elif tk is int:
                if 0 <= k < 128:
                    out.append(k)
                else:
                    _pack_int(out, k)
            else:
                if not isinstance(k, (str, int)) or isinstance(k, bool):
                    raise TypeError(
                        f"map keys must be str or int, got {type(k)}"
                    )
                _pack_into(out, k)
            tv = type(v)
            if tv is str:
                data = v.encode("utf-8")
                vn = len(data)
                if vn < 32:
                    out.append(0xA0 | vn)
                    out += data
                else:
                    _pack_into(out, v)
            elif tv is int:
                if -32 <= v < 128:  # both fixint ranges, one byte
                    out.append(v & 0xFF)
                else:
                    _pack_int(out, v)
            elif v is None:
                out.append(0xC0)
            elif v is True:
                out.append(0xC3)
            elif v is False:
                out.append(0xC2)
            else:
                _pack_into(out, v)
        return
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _D.pack(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 256:
            out.append(0xD9)
            out.append(n)
        elif n < 65536:
            out += _BH.pack(0xDA, n)
        else:
            out += _BI.pack(0xDB, n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 256:
            out.append(0xC4)
            out.append(n)
        elif n < 65536:
            out += _BH.pack(0xC5, n)
        else:
            out += _BI.pack(0xC6, n)
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 65536:
            out += _BH.pack(0xDC, n)
        else:
            out += _BI.pack(0xDD, n)
        for item in obj:
            _pack_into(out, item)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 65536:
            out += _BH.pack(0xDE, n)
        else:
            out += _BI.pack(0xDF, n)
        for k, v in obj.items():
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"map keys must be str or int, got {type(k)}")
            _pack_into(out, k)
            _pack_into(out, v)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj)}")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v < 256:
        out.append(0xCC)
        out.append(v)
    elif 0 <= v < 65536:
        out += _BH.pack(0xCD, v)
    elif 0 <= v < 2**32:
        out += _BI.pack(0xCE, v)
    elif 0 <= v < 2**64:
        out += _BQ.pack(0xCF, v)
    elif -128 <= v < 0:
        out.append(0xD0)
        out.append(v & 0xFF)
    elif -32768 <= v < 0:
        out += _Bh.pack(0xD1, v)
    elif -(2**31) <= v < 0:
        out += _Bi.pack(0xD2, v)
    elif -(2**63) <= v < 0:
        out += _Bq.pack(0xD3, v)
    else:
        raise OverflowError(f"int out of msgpack range: {v}")


def unpack(data: bytes) -> Any:
    obj, offset = _unpack_from(data, 0)
    if offset != len(data):
        raise ValueError(f"trailing bytes after msgpack value: {len(data) - offset}")
    return obj


def unpack_from(data: bytes, offset: int = 0) -> Tuple[Any, int]:
    """Decode one value starting at ``offset``; returns (value, next_offset)."""
    return _unpack_from(data, offset)


def _unpack_from(data: bytes, o: int) -> Tuple[Any, int]:
    b = data[o]
    o += 1
    if b < 0x80:  # positive fixint
        return b, o
    if b >= 0xE0:  # negative fixint
        return b - 256, o
    if 0x80 <= b <= 0x8F:
        return _unpack_map(data, o, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(data, o, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return data[o : o + n].decode("utf-8"), o + n
    if b == 0xC0:
        return None, o
    if b == 0xC2:
        return False, o
    if b == 0xC3:
        return True, o
    if b == 0xC4:
        n = data[o]
        return bytes(data[o + 1 : o + 1 + n]), o + 1 + n
    if b == 0xC5:
        (n,) = struct.unpack_from(">H", data, o)
        return bytes(data[o + 2 : o + 2 + n]), o + 2 + n
    if b == 0xC6:
        (n,) = struct.unpack_from(">I", data, o)
        return bytes(data[o + 4 : o + 4 + n]), o + 4 + n
    if b == 0xCA:
        (v,) = struct.unpack_from(">f", data, o)
        return v, o + 4
    if b == 0xCB:
        (v,) = struct.unpack_from(">d", data, o)
        return v, o + 8
    if b == 0xCC:
        return data[o], o + 1
    if b == 0xCD:
        return struct.unpack_from(">H", data, o)[0], o + 2
    if b == 0xCE:
        return struct.unpack_from(">I", data, o)[0], o + 4
    if b == 0xCF:
        return struct.unpack_from(">Q", data, o)[0], o + 8
    if b == 0xD0:
        return struct.unpack_from(">b", data, o)[0], o + 1
    if b == 0xD1:
        return struct.unpack_from(">h", data, o)[0], o + 2
    if b == 0xD2:
        return struct.unpack_from(">i", data, o)[0], o + 4
    if b == 0xD3:
        return struct.unpack_from(">q", data, o)[0], o + 8
    if b == 0xD9:
        n = data[o]
        return data[o + 1 : o + 1 + n].decode("utf-8"), o + 1 + n
    if b == 0xDA:
        (n,) = struct.unpack_from(">H", data, o)
        return data[o + 2 : o + 2 + n].decode("utf-8"), o + 2 + n
    if b == 0xDB:
        (n,) = struct.unpack_from(">I", data, o)
        return data[o + 4 : o + 4 + n].decode("utf-8"), o + 4 + n
    if b == 0xDC:
        (n,) = struct.unpack_from(">H", data, o)
        return _unpack_array(data, o + 2, n)
    if b == 0xDD:
        (n,) = struct.unpack_from(">I", data, o)
        return _unpack_array(data, o + 4, n)
    if b == 0xDE:
        (n,) = struct.unpack_from(">H", data, o)
        return _unpack_map(data, o + 2, n)
    if b == 0xDF:
        (n,) = struct.unpack_from(">I", data, o)
        return _unpack_map(data, o + 4, n)
    raise ValueError(f"unsupported msgpack byte 0x{b:02x} at offset {o - 1}")


def _unpack_array(data: bytes, o: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, o = _unpack_from(data, o)
        out.append(v)
    return out, o


def _unpack_map(data: bytes, o: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, o = _unpack_from(data, o)
        v, o = _unpack_from(data, o)
        out[k] = v
    return out, o


def canonical(obj: Any) -> bytes:
    """Key-sorted encoding for document equality in tests/parity checks."""
    if isinstance(obj, dict):
        out = bytearray()
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 65536:
            out += struct.pack(">BH", 0xDE, n)
        else:
            out += struct.pack(">BI", 0xDF, n)
        for k in sorted(obj.keys()):
            _pack_into(out, k)
            out += canonical(obj[k])
        return bytes(out)
    if isinstance(obj, (list, tuple)):
        out = bytearray()
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 65536:
            out += struct.pack(">BH", 0xDC, n)
        else:
            out += struct.pack(">BI", 0xDD, n)
        for item in obj:
            out += canonical(item)
        return bytes(out)
    return pack(obj)
