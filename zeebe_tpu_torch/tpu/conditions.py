"""json-el conditions → device predicate programs (host side).

Counterpart of ``zeebe_tpu.tpu.conditions``: the value-type constants and
tri-state codes the kernel shares, the f32-exactness gate, the
``ProgramPool`` that compiles each condition once at deployment to a
postfix program over columnarized payload variables (host numpy), and
``eval_programs``, the fixed-depth stack machine the step kernel runs for
every record × every conditioned flow of an exclusive gateway.

Tri-state logic keeps the oracle's short-circuit error semantics:
FALSE=0, TRUE=1, ERROR=2; ``and``: F→F, E→E, else right; ``or``: T→T,
E→E, else right. A comparison errors when a referenced variable is
absent, the types differ (int/float widen) or ordering meets a
non-number. Strings compare by interned id, numbers as float32 (only
f32-exact values reach the device).

``eval_programs`` is plain PyTorch on either device (the JAX package's is
jnp code, not a Pallas kernel): the ``lax.scan`` over instructions is a
Python loop over the static program length.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

import torch

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

STACK_DEPTH = 8


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


def _take(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cols[..., idx]`` per query. The index is clamped into the column
    range: a literal operand's id lies outside it, and its read is
    discarded by the caller (XLA's gather clamps; ``torch.gather`` raises)."""
    c = idx.clamp(0, cols.shape[-1] - 1).to(torch.int64)
    return torch.gather(cols, -1, c[..., None])[..., 0]


def _select(conds, vals, default):
    """``jnp.select``: the value of the FIRST true condition, else default."""
    out = default
    for cond, val in zip(reversed(conds), reversed(vals)):
        out = torch.where(cond, val, out)
    return out


def _resolve(kind, idx, v_vt, v_num, v_str, lit_nums):
    """Operand → (vtype, num, sid). ``kind``/``idx`` have the query shape;
    v_* are [..., V] payload columns."""
    var_vt = _take(v_vt, idx).to(torch.int32)
    var_num = _take(v_num, idx)
    var_str = _take(v_str, idx)
    lit_num = lit_nums[idx.clamp(0, lit_nums.shape[0] - 1).to(torch.int64)]
    zero_f = torch.zeros((), dtype=torch.float32, device=idx.device)
    vt = _select(
        [kind == K_VAR, kind == K_NUM, kind == K_STR, kind == K_BOOL],
        [var_vt, VT_NUM, VT_STR, VT_BOOL],
        torch.full_like(idx, VT_NIL),
    )
    num = _select(
        [kind == K_VAR, kind == K_NUM, kind == K_BOOL],
        [var_num, lit_num, idx.to(torch.float32)],
        zero_f,
    )
    sid = _select([kind == K_VAR, kind == K_STR], [var_str, idx], torch.zeros_like(idx))
    return vt, num, sid


def _compare(op, lvt, lnum, lsid, rvt, rnum, rsid):
    """Tri-state comparison, oracle semantics."""
    absent = (lvt == VT_ABSENT) | (rvt == VT_ABSENT)
    any_nil = (lvt == VT_NIL) | (rvt == VT_NIL)
    both_nil = (lvt == VT_NIL) & (rvt == VT_NIL)
    l_num_t = (lvt == VT_NUM) | (lvt == VT_FLOAT)
    r_num_t = (rvt == VT_NUM) | (rvt == VT_FLOAT)
    same_type = (lvt == rvt) | (l_num_t & r_num_t)

    num_eq = lnum == rnum
    eq_raw = torch.where(lvt == VT_STR, lsid == rsid, num_eq)
    # equality: nil equals only nil (no error); else same type required
    eq_err = ~any_nil & ~same_type
    eq_val = torch.where(any_nil, both_nil, eq_raw)
    err = torch.full_like(op, ERROR)
    eq_tri = torch.where(eq_err, err, eq_val.to(torch.int32))
    ne_tri = torch.where(eq_err, err, (~eq_val).to(torch.int32))

    # ordering: numbers only
    ord_err = ~(l_num_t & r_num_t)
    ord_raw = _select(
        [op == 2, op == 3, op == 4],
        [lnum < rnum, lnum <= rnum, lnum > rnum],
        lnum >= rnum,
    )
    ord_tri = torch.where(ord_err, err, ord_raw.to(torch.int32))

    tri = _select([op == 0, op == 1], [eq_tri, ne_tri], ord_tri)
    return torch.where(absent, err, tri)


def _combine_and(a, b):
    return torch.where(a == FALSE, FALSE, torch.where(a == ERROR, ERROR, b))


def _combine_or(a, b):
    return torch.where(a == TRUE, TRUE, torch.where(a == ERROR, ERROR, b))


def eval_programs(progs, lit_nums, prog_id, v_vt, v_num, v_str):
    """Evaluate programs for a batch of queries.

    progs: [P, L, 6] int32; lit_nums: [Q] float32
    prog_id: [...] int32 (clamped; callers mask out -1 themselves)
    v_vt/v_num/v_str: [..., V] payload columns (same leading shape; an
    ``expand``ed view is fine)
    returns tri-state [...] int32
    """
    pid = prog_id.clamp(0, progs.shape[0] - 1).to(torch.int64)
    code = progs[pid]  # [..., L, 6]
    shape = tuple(prog_id.shape)
    dev = prog_id.device
    stack = torch.zeros(shape + (STACK_DEPTH,), dtype=torch.int32, device=dev)
    sp = torch.zeros(shape, dtype=torch.int32, device=dev)
    lanes = torch.arange(STACK_DEPTH, dtype=torch.int32, device=dev)
    for i in range(progs.shape[1]):
        ins = code[..., i, :]
        opcode = ins[..., 0]
        is_cmp = opcode == OP_CMP
        is_and = opcode == OP_AND
        is_bin = is_and | (opcode == OP_OR)

        lvt, lnum, lsid = _resolve(ins[..., 2], ins[..., 3], v_vt, v_num, v_str, lit_nums)
        rvt, rnum, rsid = _resolve(ins[..., 4], ins[..., 5], v_vt, v_num, v_str, lit_nums)
        cmp_tri = _compare(ins[..., 1], lvt, lnum, lsid, rvt, rnum, rsid)

        # pop two for AND/OR
        top = torch.gather(stack, -1, (sp - 1).clamp(min=0).to(torch.int64)[..., None])[..., 0]
        under = torch.gather(stack, -1, (sp - 2).clamp(min=0).to(torch.int64)[..., None])[..., 0]
        comb = torch.where(is_and, _combine_and(under, top), _combine_or(under, top))

        push_val = torch.where(is_cmp, cmp_tri, comb)
        push_pos = torch.where(is_bin, (sp - 2).clamp(min=0), sp)
        write = (is_cmp | is_bin)[..., None] & (lanes == push_pos[..., None])
        stack = torch.where(write, push_val[..., None], stack)
        sp = torch.where(is_cmp, sp + 1, torch.where(is_bin, sp - 1, sp))
    return stack[..., 0]
