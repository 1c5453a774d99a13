"""JSONPath tokenizer, compiled queries, and a msgpack traverser.

Reference parity: ``json-path/.../jsonpath/JsonPathQueryCompiler.java``
(tokenizer → compiled ``JsonPathQuery``) and
``json-path/.../query/MsgPackTraverser.java`` (evaluate a compiled query
against a PACKED msgpack document, skipping over subtrees without
materializing them). The supported grammar is the engine subset plus
wildcards:

    $                     the whole document
    $.a.b.c               nested map fields
    $['a']["b"]           bracket field notation
    $.items[0]            array index
    $.items[*]  /  $.*    wildcard over array elements / map values

Queries compile once (deploy time: correlation keys, io mappings) and
evaluate many times (hot path).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Tuple, Union


class JsonPathError(ValueError):
    """Tokenizer/compiler error (→ deployment rejection)."""


class TokenKind(enum.Enum):
    ROOT = "$"
    NAME = "name"
    INDEX = "index"
    WILDCARD = "*"


@dataclasses.dataclass(frozen=True)
class Token:
    kind: TokenKind
    value: Union[str, int, None] = None
    position: int = 0


WILDCARD = object()  # compiled-step sentinel


def tokenize(path: str) -> List[Token]:
    """Split a JSONPath expression into tokens. Errors carry the offset
    (reference JsonPathQueryCompiler reports the invalid position)."""
    if not path or path[0] != "$":
        raise JsonPathError(f"JSONPath must start with '$': {path!r}")
    tokens: List[Token] = [Token(TokenKind.ROOT, "$", 0)]
    i, n = 1, len(path)
    while i < n:
        ch = path[i]
        if ch == ".":
            i += 1
            if i < n and path[i] == "*":
                tokens.append(Token(TokenKind.WILDCARD, "*", i))
                i += 1
                continue
            start = i
            while i < n and path[i] not in ".[":
                i += 1
            if i == start:
                raise JsonPathError(f"empty field name at {start} in {path!r}")
            tokens.append(Token(TokenKind.NAME, path[start:i], start))
        elif ch == "[":
            i += 1
            if i >= n:
                raise JsonPathError(f"unterminated '[' at {i - 1} in {path!r}")
            if path[i] in "'\"":
                quote = path[i]
                i += 1
                start = i
                while i < n and path[i] != quote:
                    i += 1
                if i >= n or i + 1 >= n or path[i + 1] != "]":
                    raise JsonPathError(f"unterminated string at {start} in {path!r}")
                tokens.append(Token(TokenKind.NAME, path[start:i], start))
                i += 2
            elif path[i] == "*":
                if i + 1 >= n or path[i + 1] != "]":
                    raise JsonPathError(f"bad wildcard at {i} in {path!r}")
                tokens.append(Token(TokenKind.WILDCARD, "*", i))
                i += 2
            else:
                start = i
                while i < n and path[i] != "]":
                    i += 1
                if i >= n:
                    raise JsonPathError(f"unterminated '[' at {start} in {path!r}")
                try:
                    tokens.append(Token(TokenKind.INDEX, int(path[start:i]), start))
                except ValueError:
                    raise JsonPathError(
                        f"bad array index {path[start:i]!r} at {start} in {path!r}"
                    ) from None
                i += 1
        else:
            raise JsonPathError(f"bad JSONPath syntax at {i} in {path!r}")
    return tokens


@dataclasses.dataclass(frozen=True)
class JsonPathQuery:
    """A compiled query: the access-step program the traversers run."""

    path: str
    steps: Tuple[Any, ...]  # str field | int index | WILDCARD

    @property
    def is_root(self) -> bool:
        return not self.steps

    @property
    def has_wildcard(self) -> bool:
        return any(s is WILDCARD for s in self.steps)

    # -- evaluation over materialized documents -----------------------------
    def evaluate(self, document: Any) -> List[Any]:
        """All matches (wildcards can fan out)."""
        nodes = [document]
        for step in self.steps:
            nxt: List[Any] = []
            for node in nodes:
                if step is WILDCARD:
                    if isinstance(node, dict):
                        nxt.extend(node.values())
                    elif isinstance(node, list):
                        nxt.extend(node)
                elif isinstance(step, str):
                    if isinstance(node, dict) and step in node:
                        nxt.append(node[step])
                elif isinstance(step, int):
                    if isinstance(node, list) and -len(node) <= step < len(node):
                        nxt.append(node[step])
            nodes = nxt
            if not nodes:
                break
        return nodes

    def evaluate_one(self, document: Any) -> Tuple[bool, Any]:
        matches = self.evaluate(document)
        if not matches:
            return False, None
        return True, matches[0]


import functools


@functools.lru_cache(maxsize=4096)
def compile_query(path: str) -> JsonPathQuery:
    steps: List[Any] = []
    for token in tokenize(path)[1:]:
        if token.kind == TokenKind.NAME:
            steps.append(token.value)
        elif token.kind == TokenKind.INDEX:
            steps.append(int(token.value))
        elif token.kind == TokenKind.WILDCARD:
            steps.append(WILDCARD)
    return JsonPathQuery(path=path, steps=tuple(steps))


# ---------------------------------------------------------------------------
# msgpack traverser: evaluate a query against PACKED bytes
# ---------------------------------------------------------------------------


def _skip_value(data: bytes, o: int) -> int:
    """Offset just past the value at ``o`` without materializing it — the
    subtree-skipping that makes the traverser sublinear in document size
    (reference MsgPackTraverser)."""
    b = data[o]
    if b <= 0x7F or 0xE0 <= b:  # fixint
        return o + 1
    if 0x80 <= b <= 0x8F:  # fixmap
        o += 1
        for _ in range((b & 0x0F) * 2):
            o = _skip_value(data, o)
        return o
    if 0x90 <= b <= 0x9F:  # fixarray
        o += 1
        for _ in range(b & 0x0F):
            o = _skip_value(data, o)
        return o
    if 0xA0 <= b <= 0xBF:  # fixstr
        return o + 1 + (b & 0x1F)
    if b in (0xC0, 0xC2, 0xC3):  # nil / false / true
        return o + 1
    if b == 0xC4:  # bin8
        return o + 2 + data[o + 1]
    if b == 0xC5:  # bin16
        return o + 3 + int.from_bytes(data[o + 1 : o + 3], "big")
    if b == 0xC6:  # bin32
        return o + 5 + int.from_bytes(data[o + 1 : o + 5], "big")
    if b == 0xCA:  # float32
        return o + 5
    if b == 0xCB:  # float64
        return o + 9
    if b in (0xCC, 0xD0):  # uint8 / int8
        return o + 2
    if b in (0xCD, 0xD1):  # uint16 / int16
        return o + 3
    if b in (0xCE, 0xD2):  # uint32 / int32
        return o + 5
    if b in (0xCF, 0xD3):  # uint64 / int64
        return o + 9
    if b == 0xD9:  # str8
        return o + 2 + data[o + 1]
    if b == 0xDA:  # str16
        return o + 3 + int.from_bytes(data[o + 1 : o + 3], "big")
    if b == 0xDB:  # str32
        return o + 5 + int.from_bytes(data[o + 1 : o + 5], "big")
    if b == 0xDC:  # array16
        n = int.from_bytes(data[o + 1 : o + 3], "big")
        o += 3
        for _ in range(n):
            o = _skip_value(data, o)
        return o
    if b == 0xDD:  # array32
        n = int.from_bytes(data[o + 1 : o + 5], "big")
        o += 5
        for _ in range(n):
            o = _skip_value(data, o)
        return o
    if b == 0xDE:  # map16
        n = int.from_bytes(data[o + 1 : o + 3], "big")
        o += 3
        for _ in range(n * 2):
            o = _skip_value(data, o)
        return o
    if b == 0xDF:  # map32
        n = int.from_bytes(data[o + 1 : o + 5], "big")
        o += 5
        for _ in range(n * 2):
            o = _skip_value(data, o)
        return o
    raise JsonPathError(f"unsupported msgpack byte {b:#x} at {o}")


def _container_header(data: bytes, o: int) -> Tuple[Optional[str], int, int]:
    """(kind, count, offset-past-header) for maps/arrays, else (None, 0, o)."""
    b = data[o]
    if 0x80 <= b <= 0x8F:
        return "map", b & 0x0F, o + 1
    if b == 0xDE:
        return "map", int.from_bytes(data[o + 1 : o + 3], "big"), o + 3
    if b == 0xDF:
        return "map", int.from_bytes(data[o + 1 : o + 5], "big"), o + 5
    if 0x90 <= b <= 0x9F:
        return "array", b & 0x0F, o + 1
    if b == 0xDC:
        return "array", int.from_bytes(data[o + 1 : o + 3], "big"), o + 3
    if b == 0xDD:
        return "array", int.from_bytes(data[o + 1 : o + 5], "big"), o + 5
    return None, 0, o


def _read_str(data: bytes, o: int) -> Tuple[Optional[str], int]:
    b = data[o]
    if 0xA0 <= b <= 0xBF:
        ln = b & 0x1F
        return data[o + 1 : o + 1 + ln].decode("utf-8"), o + 1 + ln
    if b == 0xD9:
        ln = data[o + 1]
        return data[o + 2 : o + 2 + ln].decode("utf-8"), o + 2 + ln
    if b == 0xDA:
        ln = int.from_bytes(data[o + 1 : o + 3], "big")
        return data[o + 3 : o + 3 + ln].decode("utf-8"), o + 3 + ln
    if b == 0xDB:
        ln = int.from_bytes(data[o + 1 : o + 5], "big")
        return data[o + 5 : o + 5 + ln].decode("utf-8"), o + 5 + ln
    return None, o
