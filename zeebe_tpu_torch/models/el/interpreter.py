"""Host condition interpreter with exact reference semantics.

Reference parity: ``json-el/.../JsonConditionInterpreter.java``:

- a JSONPath with no result raises (→ CONDITION_ERROR incident);
- ``==``/``!=``: NIL equals only NIL; otherwise both sides must have the
  same type (ints widen to float when mixed with float), else raises;
- ``<``/``<=``/``>``/``>=``: numbers only, same widening rule, else raises.
"""

from __future__ import annotations

from typing import Any

from zeebe_tpu_torch.models.el.ast import (
    Comparison,
    Condition,
    Conjunction,
    Disjunction,
    JsonPathLiteral,
    Literal,
    query_json_path,
)


class ConditionEvalError(ValueError):
    """Reference: JsonConditionException → raises a CONDITION_ERROR incident."""


_TYPE_NAMES = {
    type(None): "NIL",
    bool: "BOOLEAN",
    int: "INTEGER",
    float: "FLOAT",
    str: "STRING",
    list: "ARRAY",
    dict: "MAP",
}


def _resolve(operand, payload: Any):
    if isinstance(operand, Literal):
        return operand.value
    assert isinstance(operand, JsonPathLiteral)
    found, value = query_json_path(payload, operand.path)
    if not found:
        raise ConditionEvalError(f"JSON path '{operand.path}' has no result.")
    return value


def _coerce_same_type(x, y):
    tx, ty = type(x), type(y)
    if tx is int and ty is float:
        return float(x), y
    if tx is float and ty is int:
        return x, float(y)
    if tx is not ty:
        raise ConditionEvalError(
            f"Cannot compare values of different types: "
            f"{_TYPE_NAMES.get(tx, tx.__name__)} and {_TYPE_NAMES.get(ty, ty.__name__)}"
        )
    return x, y


def _equals(x, y) -> bool:
    if x is None:
        return y is None
    if y is None:
        return False
    x, y = _coerce_same_type(x, y)
    if isinstance(x, (str, bool, int, float)):
        return x == y
    raise ConditionEvalError(
        f"Cannot compare value of type: {_TYPE_NAMES.get(type(x), type(x).__name__)}"
    )


def _ordering(op: str, x, y) -> bool:
    x, y = _coerce_same_type(x, y)
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise ConditionEvalError(
            f"Cannot compare value of type: {_TYPE_NAMES.get(type(x), type(x).__name__)}"
        )
    if op == "<":
        return x < y
    if op == "<=":
        return x <= y
    if op == ">":
        return x > y
    return x >= y


def evaluate_condition(condition: Condition, payload: Any) -> bool:
    if isinstance(condition, Disjunction):
        return evaluate_condition(condition.left, payload) or evaluate_condition(
            condition.right, payload
        )
    if isinstance(condition, Conjunction):
        return evaluate_condition(condition.left, payload) and evaluate_condition(
            condition.right, payload
        )
    assert isinstance(condition, Comparison)
    x = _resolve(condition.left, payload)
    y = _resolve(condition.right, payload)
    if condition.op == "==":
        return _equals(x, y)
    if condition.op == "!=":
        return not _equals(x, y)
    return _ordering(condition.op, x, y)
