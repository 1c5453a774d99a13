"""Fixed-layout binary record frame codec.

SBE-equivalent framing for log storage and the wire (reference: the SBE
schema ``protocol/src/main/resources/protocol.xml`` plus logstreams'
``LogEntryDescriptor`` framing: position, raft term, producer id, source
event position, key, metadata + value).

Frame layout (little-endian):

    offset  size  field
    0       4     frame_length (total, including this field)
    4       4     crc32 of bytes [8:frame_length)
    8       8     position
    16      8     source_record_position
    24      8     key
    32      8     timestamp
    40      4     producer_id
    44      4     raft_term
    48      8     request_id
    56      4     request_stream_id
    60      8     incident_key
    68      1     record_type
    69      1     value_type
    70      1     intent
    71      1     rejection_type
    72      4     rejection_reason_length = R
    76      R     rejection_reason (utf-8)
    76+R    4     value_length = V
    80+R    V     value (msgpack document)
    ...           zero padding to 8-byte alignment

Alignment keeps mmap'd native readers (native/log_storage.cc) word-aligned,
mirroring the reference's dispatcher fragment alignment.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.protocol.enums import RecordType, RejectionType, ValueType
from zeebe_tpu_torch.protocol.metadata import RecordMetadata
from zeebe_tpu_torch.protocol.records import Record, VALUE_CLASS_BY_TYPE

# struct formats cached at module level — pack/unpack on the append hot
# path must never re-parse a format string
_HEADER = struct.Struct("<iIqqqqiiqiqBBBB")
# header + reason_length(=0) + value_length in ONE pack — the layout is
# contiguous exactly when the rejection reason is empty, which is every
# non-rejection record (the append hot path)
_HEADER_NR = struct.Struct("<iIqqqqiiqiqBBBBII")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
HEADER_SIZE = _HEADER.size  # 72
assert HEADER_SIZE == 72
assert _HEADER_NR.size == HEADER_SIZE + 8

FRAME_ALIGNMENT = 8


def _frame_length(reason_len: int, value_len: int) -> int:
    body_len = HEADER_SIZE + 4 + reason_len + 4 + value_len
    return (body_len + FRAME_ALIGNMENT - 1) // FRAME_ALIGNMENT * FRAME_ALIGNMENT


def _pack_frame(
    buf: bytearray,
    mv: memoryview,
    offset: int,
    frame_len: int,
    position: int,
    source_pos: int,
    key: int,
    timestamp: int,
    producer_id: int,
    raft_term: int,
    request_id: int,
    request_stream_id: int,
    incident_key: int,
    record_type: int,
    value_type: int,
    intent: int,
    rejection_type: int,
    reason: bytes,
    value_bytes: bytes,
) -> None:
    """Pack one frame into ``buf`` at ``offset`` (``buf`` pre-sized and
    zeroed, so alignment padding needs no explicit write)."""
    if not reason:
        # empty rejection reason (every non-rejection record): header +
        # both length fields are contiguous — one struct pack
        _HEADER_NR.pack_into(
            buf, offset,
            frame_len, 0, position, source_pos, key, timestamp,
            producer_id, raft_term, request_id, request_stream_id,
            incident_key, record_type & 0xFF, value_type & 0xFF,
            intent & 0xFF, rejection_type & 0xFF,
            0, len(value_bytes),
        )
        o = offset + HEADER_SIZE + 8
        buf[o : o + len(value_bytes)] = value_bytes
    else:
        _HEADER.pack_into(
            buf,
            offset,
            frame_len,
            0,  # crc placeholder
            position,
            source_pos,
            key,
            timestamp,
            producer_id,
            raft_term,
            request_id,
            request_stream_id,
            incident_key,
            record_type & 0xFF,
            value_type & 0xFF,
            intent & 0xFF,
            rejection_type & 0xFF,
        )
        o = offset + HEADER_SIZE
        _U32.pack_into(buf, o, len(reason))
        o += 4
        buf[o : o + len(reason)] = reason
        o += len(reason)
        _U32.pack_into(buf, o, len(value_bytes))
        o += 4
        buf[o : o + len(value_bytes)] = value_bytes
    # crc over a view slice: no per-frame copy of the frame body (the
    # caller owns one memoryview for the whole wave's buffer)
    crc = zlib.crc32(mv[offset + 8 : offset + frame_len])
    _U32.pack_into(buf, offset + 4, crc)


def encode_records(records: Sequence[Record]) -> Tuple[bytearray, List[int]]:
    """ONE encode pass per wave: every record's frame into a single
    pre-sized bytearray (bit-identical to per-record ``encode_record``
    concatenation). Returns ``(buffer, per-record frame offsets)`` — the
    offsets feed the log's sparse block index without a re-walk."""
    reasons: List[bytes] = []
    values: List[bytes] = []
    sizes: List[int] = []
    total = 0
    for record in records:
        md = record.metadata
        reason = md.rejection_reason
        reason = reason.encode("utf-8") if reason else b""
        value_bytes = (
            record.value.encode() if record.value is not None
            else msgpack.EMPTY_DOCUMENT
        )
        frame_len = _frame_length(len(reason), len(value_bytes))
        reasons.append(reason)
        values.append(value_bytes)
        sizes.append(frame_len)
        total += frame_len
    buf = bytearray(total)
    mv = memoryview(buf)
    offsets: List[int] = []
    o = 0
    for record, reason, value_bytes, frame_len in zip(
        records, reasons, values, sizes
    ):
        offsets.append(o)
        md = record.metadata
        _pack_frame(
            buf, mv, o, frame_len,
            record.position, record.source_record_position, record.key,
            record.timestamp, record.producer_id, record.raft_term,
            md.request_id, md.request_stream_id, md.incident_key,
            int(md.record_type), int(md.value_type), int(md.intent),
            int(md.rejection_type), reason, value_bytes,
        )
        o += frame_len
    mv.release()
    return buf, offsets


def encode_columnar(batch) -> Tuple[bytearray, List[int]]:
    """One encode pass over a :class:`ColumnarBatch`/``RecordsView``
    directly from its columns + per-row value bytes — NO ``Record``
    objects materialize for rows whose value (or value bytes) the batch
    already holds. Bit-identical to ``encode_records`` over the
    materialized rows."""
    n = len(batch)
    col = batch.col
    positions = col("position")
    sources = col("source_record_position")
    keys = col("key")
    timestamps = col("timestamp")
    producers = col("producer_id")
    terms = col("raft_term")
    req_ids = col("request_id")
    req_streams = col("request_stream_id")
    incident_keys = col("incident_key")
    rtypes = col("record_type")
    vtypes = col("value_type")
    intents = col("intent")
    rej_types = col("rejection_type")
    reasons = [s.encode("utf-8") if s else b"" for s in col("rejection_reason")]
    values = [batch.value_bytes(i) for i in range(n)]
    sizes = [
        _frame_length(len(reasons[i]), len(values[i])) for i in range(n)
    ]
    buf = bytearray(sum(sizes))
    mv = memoryview(buf)
    offsets: List[int] = []
    o = 0
    for i in range(n):
        offsets.append(o)
        _pack_frame(
            buf, mv, o, sizes[i],
            positions[i], sources[i], keys[i], timestamps[i], producers[i],
            terms[i], req_ids[i], req_streams[i], incident_keys[i],
            rtypes[i], vtypes[i], intents[i], rej_types[i],
            reasons[i], values[i],
        )
        o += sizes[i]
    mv.release()
    return buf, offsets


def encode_record(record: Record) -> bytes:
    buf, _ = encode_records((record,))
    return bytes(buf)


def decode_value(value_type: int, value_bytes: bytes):
    """Typed ``RecordValue`` (or None for unknown types) from a frame's
    value document — the one place frame bytes become typed values."""
    vt = ValueType(value_type) if value_type != 255 else ValueType.NULL_VAL
    value_cls = VALUE_CLASS_BY_TYPE.get(vt)
    return (
        vt,
        value_cls.decode(value_bytes) if value_cls is not None else None,
    )


def decode_record(data: bytes, offset: int = 0) -> Tuple[Record, int]:
    """Decode one frame at ``offset``; returns (record, next_offset)."""
    (
        frame_len,
        crc,
        position,
        source_pos,
        key,
        timestamp,
        producer_id,
        raft_term,
        request_id,
        request_stream_id,
        incident_key,
        record_type,
        value_type,
        intent,
        rejection_type,
    ) = _HEADER.unpack_from(data, offset)

    actual_crc = zlib.crc32(bytes(data[offset + 8 : offset + frame_len]))
    if actual_crc != crc:
        raise ValueError(f"crc mismatch at offset {offset}: {actual_crc:#x} != {crc:#x}")

    o = offset + HEADER_SIZE
    (reason_len,) = struct.unpack_from("<I", data, o)
    o += 4
    reason = bytes(data[o : o + reason_len]).decode("utf-8")
    o += reason_len
    (value_len,) = struct.unpack_from("<I", data, o)
    o += 4
    value_bytes = bytes(data[o : o + value_len])

    vt, value = decode_value(value_type, value_bytes)

    record = Record(
        position=position,
        source_record_position=source_pos,
        key=key,
        timestamp=timestamp,
        producer_id=producer_id,
        raft_term=raft_term,
        metadata=RecordMetadata(
            record_type=RecordType(record_type),
            value_type=vt,
            intent=intent,
            rejection_type=RejectionType(rejection_type),
            rejection_reason=reason,
            request_id=request_id,
            request_stream_id=request_stream_id,
            incident_key=incident_key,
        ),
        value=value,
    )
    return record, offset + frame_len


def peek_frame_length(data: bytes, offset: int = 0) -> Optional[int]:
    if len(data) - offset < 4:
        return None
    (frame_len,) = struct.unpack_from("<i", data, offset)
    return frame_len if frame_len > 0 else None
