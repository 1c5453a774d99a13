"""Condition AST (reference: json-el ``JsonCondition.scala`` case classes)."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Union


class Condition:
    pass


@dataclasses.dataclass(frozen=True)
class Literal:
    """A constant: str, int, float, bool, or None."""

    value: Any


@dataclasses.dataclass(frozen=True)
class JsonPathLiteral:
    """A JSONPath reference into the payload, e.g. ``$.orderValue`` or
    ``$.items[0].price`` (reference: JsonPath case class; paths are compiled
    by json-path's JsonPathQueryCompiler)."""

    path: str

    @property
    def steps(self) -> List[Union[str, int]]:
        return compile_json_path(self.path)


@dataclasses.dataclass(frozen=True)
class Comparison(Condition):
    op: str  # '==', '!=', '<', '<=', '>', '>='
    left: Union[Literal, JsonPathLiteral]
    right: Union[Literal, JsonPathLiteral]


@dataclasses.dataclass(frozen=True)
class Disjunction(Condition):
    left: Condition
    right: Condition


@dataclasses.dataclass(frozen=True)
class Conjunction(Condition):
    left: Condition
    right: Condition


def compile_json_path(path: str) -> List[Union[str, int]]:
    """Compile a JSONPath subset to flat access steps.

    Reference: ``json-path/.../jsonpath/JsonPathQueryCompiler.java``. The
    single grammar lives in ``zeebe_tpu.protocol.jsonpath`` (tokenizer +
    compiled queries); this legacy step-list form rejects wildcards —
    callers that can fan out use ``compile_query`` directly.
    """
    from zeebe_tpu_torch.protocol.jsonpath import WILDCARD, JsonPathError, compile_query

    try:
        query = compile_query(path)
    except JsonPathError as e:
        raise ValueError(str(e)) from None
    if any(s is WILDCARD for s in query.steps):
        raise ValueError(f"wildcards not supported here: {path!r}")
    return list(query.steps)


def query_json_path(document: Any, path: str):
    """Apply a compiled path to a document; returns (found, value).

    Full grammar (incl. wildcards) lives in
    ``zeebe_tpu.protocol.jsonpath`` — the tokenizer/compiler layer
    (reference JsonPathQueryCompiler); this is the convenience form."""
    from zeebe_tpu_torch.protocol.jsonpath import JsonPathError, compile_query

    try:
        return compile_query(path).evaluate_one(document)
    except JsonPathError as e:
        raise ValueError(str(e)) from None
