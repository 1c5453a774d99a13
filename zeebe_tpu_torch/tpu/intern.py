"""Host-side string interning.

The device never sees strings: element ids, job types, worker names,
message names, string literals in conditions, and string-valued payload
variables are interned host-side to dense int32 ids. Equality on device is
id equality (exact, unlike hashing). The reference's analogue is the
garbage-free DirectBuffer string handling in msgpack-value
(``msgpack-value/.../value/StringValue.java``) — strings are compared as
bytes there; here they are compared as ids.
"""

from __future__ import annotations

from typing import Dict, List, Optional


NIL_ID = 0  # id 0 is reserved: "no string"


class InternTable:
    def __init__(self):
        self._by_str: Dict[str, int] = {}
        self._by_id: List[Optional[str]] = [None]  # id 0 reserved

    def intern(self, s: str) -> int:
        sid = self._by_str.get(s)
        if sid is None:
            sid = len(self._by_id)
            self._by_str[s] = sid
            self._by_id.append(s)
        return sid

    def lookup(self, s: str) -> int:
        """Id of ``s`` or NIL_ID when never interned (device compares will
        simply not match)."""
        return self._by_str.get(s, NIL_ID)

    def string(self, sid: int) -> Optional[str]:
        if 0 < sid < len(self._by_id):
            return self._by_id[sid]
        return None

    def __len__(self) -> int:
        return len(self._by_id)
