"""json-el conditions → device predicate programs (host side).

Counterpart of ``zeebe_tpu.tpu.conditions``: the value-type constants and
tri-state codes the kernel shares, the f32-exactness gate, and the
``ProgramPool`` that compiles each condition once at deployment to a
postfix program over columnarized payload variables (host numpy).

Evaluating the programs on the device (``eval_programs``) belongs to the
exclusive-gateway slice: the step kernel here raises for graphs that have
conditions, so nothing in this package evaluates a program yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from zeebe_tpu_torch.models.el.ast import (
    Comparison,
    Condition,
    Conjunction,
    Disjunction,
    JsonPathLiteral,
    Literal,
    compile_json_path,
)
from zeebe_tpu_torch.tpu.intern import InternTable

# tri-state
FALSE, TRUE, ERROR = 0, 1, 2

# opcodes
OP_NOP, OP_CMP, OP_AND, OP_OR = 0, 1, 2, 3

# comparison ops
CMP_OPS = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

# operand kinds
K_VAR, K_NUM, K_STR, K_BOOL, K_NIL = 0, 1, 2, 3, 4

# variable value types (the ``vtype`` payload column); INTEGER and FLOAT are
# distinct for document round-trips but compare as one numeric class
VT_ABSENT, VT_NIL, VT_BOOL, VT_NUM, VT_STR, VT_FLOAT = 0, 1, 2, 3, 4, 5


def f32_exact(value: float) -> bool:
    """True when ``value`` survives a float32 round trip exactly. Payload
    numerics are stored as f32 on the device; both gates — payload
    columnarization (batch.payload_to_columns) and condition-literal
    compilation below — use this same predicate."""
    f = np.float32(value)
    return bool(np.isfinite(f)) and float(f) == float(value)


class DeviceIneligible(ValueError):
    """Condition uses a feature the device path cannot evaluate (nested
    JSONPath, non-scalar literal) — the workflow falls back to the host
    oracle engine."""


@dataclasses.dataclass
class ProgramPool:
    """Host-side accumulator for compiled programs; ``arrays`` yields the
    padded numpy form the graph uploads."""

    varspace: "object"  # VarSpace (graph.py); needs .column(name)
    interns: InternTable
    programs: List[List[Tuple[int, int, int, int, int, int]]] = dataclasses.field(
        default_factory=list
    )
    lit_nums: List[float] = dataclasses.field(default_factory=list)

    def _num_literal(self, value: float) -> int:
        if not f32_exact(value):
            raise DeviceIneligible(
                f"condition literal not f32-exact: {value!r}"
            )
        self.lit_nums.append(float(value))
        return len(self.lit_nums) - 1

    def _operand(self, operand) -> Tuple[int, int]:
        if isinstance(operand, JsonPathLiteral):
            steps = compile_json_path(operand.path)
            if len(steps) != 1 or not isinstance(steps[0], str):
                raise DeviceIneligible(
                    f"non-flat JSONPath in condition: {operand.path}"
                )
            return K_VAR, self.varspace.column(steps[0])
        assert isinstance(operand, Literal)
        v = operand.value
        if v is None:
            return K_NIL, 0
        if isinstance(v, bool):
            return K_BOOL, 1 if v else 0
        if isinstance(v, (int, float)):
            return K_NUM, self._num_literal(v)
        if isinstance(v, str):
            return K_STR, self.interns.intern(v)
        raise DeviceIneligible(f"non-scalar literal in condition: {v!r}")

    def _emit(self, condition: Condition, out: list) -> None:
        if isinstance(condition, Comparison):
            lk, li = self._operand(condition.left)
            rk, ri = self._operand(condition.right)
            out.append((OP_CMP, CMP_OPS[condition.op], lk, li, rk, ri))
        elif isinstance(condition, Conjunction):
            self._emit(condition.left, out)
            self._emit(condition.right, out)
            out.append((OP_AND, 0, 0, 0, 0, 0))
        elif isinstance(condition, Disjunction):
            self._emit(condition.left, out)
            self._emit(condition.right, out)
            out.append((OP_OR, 0, 0, 0, 0, 0))
        else:
            raise DeviceIneligible(f"unknown condition node: {condition!r}")

    def compile(self, condition: Condition) -> int:
        """Compile one condition; returns its program id."""
        out: list = []
        self._emit(condition, out)
        self.programs.append(out)
        return len(self.programs) - 1

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(progs [P, L, 6] int32, lit_nums [Q] float32), padded to the
        same coarse sizes as the JAX package's ``ProgramPool.tensors``."""

        def _pad(n: int, mult: int) -> int:
            return ((max(n, 1) + mult - 1) // mult) * mult

        max_len = _pad(max((len(p) for p in self.programs), default=0), 8)
        count = _pad(len(self.programs), 4)
        arr = [
            [list(ins) for ins in p] + [[OP_NOP] * 6] * (max_len - len(p))
            for p in self.programs
        ]
        arr += [[[OP_NOP] * 6] * max_len] * (count - len(arr))
        progs = np.array(arr, dtype=np.int32).reshape(count, max_len, 6)
        lits = list(self.lit_nums)
        lits += [0.0] * (_pad(len(lits), 8) - len(lits))
        return progs, np.array(lits, dtype=np.float32)
