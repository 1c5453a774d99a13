"""Payload input/output mapping processor.

Reference parity: ``json-path/.../mapping/MappingProcessor.java`` —
``extract(document, mappings)`` builds a new msgpack document from
source-path → target-path moves; ``merge(source, target, mappings)`` merges
the (mapped) source document into the target document. With no mappings,
merge is a top-level document merge. A mapping whose source path has no
result raises (→ IO_MAPPING_ERROR incident).
"""

from __future__ import annotations

from typing import Any, Dict, List

from zeebe_tpu_torch.models.bpmn.model import Mapping
from zeebe_tpu_torch.models.el.ast import compile_json_path, query_json_path


class MappingError(ValueError):
    """Reference: MappingException → IO_MAPPING_ERROR incident."""


def _set_path(document: Dict[str, Any], path: str, value: Any) -> None:
    try:
        steps = compile_json_path(path)
    except ValueError as e:
        raise MappingError(str(e)) from None
    if not steps:
        raise MappingError("Target mapping '$' must be the only mapping")
    node = document
    for step in steps[:-1]:
        if not isinstance(step, str):
            raise MappingError(f"Unsupported target path step: {step!r}")
        nxt = node.get(step)
        if not isinstance(nxt, dict):
            nxt = {}
            node[step] = nxt
        node = nxt
    last = steps[-1]
    if not isinstance(last, str):
        raise MappingError(f"Unsupported target path step: {last!r}")
    node[last] = value


def _query(document: Dict[str, Any], path: str):
    """Runtime query: any path error becomes a MappingError so the engine
    raises an IO_MAPPING_ERROR incident instead of crashing the step."""
    try:
        return query_json_path(document, path)
    except ValueError as e:
        raise MappingError(str(e)) from None


def extract(document: Dict[str, Any], mappings: List[Mapping]) -> Dict[str, Any]:
    """Build a new document from mappings (reference MappingProcessor.extract)."""
    result: Dict[str, Any] = {}
    for mapping in mappings:
        found, value = _query(document, mapping.source)
        if not found:
            raise MappingError(
                f"No data found for query {mapping.source}."
            )
        if mapping.target == "$":
            if not isinstance(value, dict):
                raise MappingError(
                    "Processing failed, since mapping will result in a non map object (json object)."
                )
            result = dict(value)
        else:
            _set_path(result, mapping.target, value)
    return result


def merge(
    source: Dict[str, Any],
    target: Dict[str, Any],
    mappings: List[Mapping],
) -> Dict[str, Any]:
    """Merge ``source`` into ``target`` (reference MappingProcessor.merge).

    With mappings: each target path is set to the value at the source path
    in ``source``. Without mappings: top-level merge of source into target.
    """
    result = dict(target)
    if not mappings:
        result.update(source)
        return result
    for mapping in mappings:
        found, value = _query(source, mapping.source)
        if not found:
            raise MappingError(f"No data found for query {mapping.source}.")
        if mapping.target == "$":
            if not isinstance(value, dict):
                raise MappingError(
                    "Processing failed, since mapping will result in a non map object (json object)."
                )
            result = dict(value)
        else:
            _set_path(result, mapping.target, value)
    return result
