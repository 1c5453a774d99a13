"""Record metadata.

Reference parity: ``protocol/src/main/java/io/zeebe/protocol/impl/RecordMetadata.java``
and the log entry framing in
``logstreams/.../impl/log/entry/LogEntryDescriptor`` (position, raft term,
producer id, source event position, key, metadata+value).
"""

from __future__ import annotations

import dataclasses

from zeebe_tpu_torch.protocol.enums import RecordType, RejectionType, ValueType


@dataclasses.dataclass
class RecordMetadata:
    record_type: RecordType = RecordType.NULL_VAL
    value_type: ValueType = ValueType.NULL_VAL
    intent: int = 0
    rejection_type: RejectionType = RejectionType.NULL_VAL
    rejection_reason: str = ""
    # request correlation (set on commands coming from a client; copied onto
    # the accepting/rejecting follow-up record so the responder can answer)
    request_id: int = -1
    request_stream_id: int = -1
    # incident bookkeeping (reference RecordMetadata.incidentKey)
    incident_key: int = -1

    def copy(self) -> "RecordMetadata":
        return dataclasses.replace(self)
