"""The table commit's launch plan, on the CPU: ``ops.commit_plan`` and the
claim rule of ``csrc/table_commit.cu``, emulated in plain PyTorch.

- Random op lists over 3-5 tables (mixed kinds, lane masks, 1D tables,
  heavy duplicate slots, the sentinel slot T, wrapping and dropped
  slots): the ops applied stage by stage in the kernel's pass order (a
  stage's adds and maxes in pass 0, its sets after) give the op-major
  chain's tables, and so does the kernel's claim rule — per cell the
  largest (op epoch, batch rank) over the stage, in each table's own row
  and lane regions of one never-cleared scratch full of stale tags.
- The main path's commits (element instances, jobs, timers, recorded from
  a CPU drive of the timer workflow) plan 2, 1 and 1 stages: 3, 2 and 2
  launches, down from 23, 16 and 16.

Exact comparison: the commit is integer data movement.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from zeebe_tpu_torch.tpu import drive, ops


def _random_case(rng):
    """3-5 tables (2D of 1-24 lanes or 1D) and 4-14 ops of every kind."""
    n_tables = int(rng.integers(3, 6))
    tables = []
    for _ in range(n_tables):
        rows = int(rng.integers(4, 40))
        width = int(rng.choice([0, 1, 2, 6, 24]))
        shape = (rows, width) if width else (rows,)
        tables.append(torch.from_numpy(
            rng.integers(-1000, 1000, size=shape).astype(np.int32)))
    b = int(rng.integers(8, 64))
    op_list = []
    for _ in range(int(rng.integers(4, 15))):
        ti = int(rng.integers(0, n_tables))
        t = tables[ti]
        rows = t.shape[0]
        s = rng.integers(0, 3, size=b)  # heavy duplicates
        s[b // 2:] = rng.integers(0, rows, size=b - b // 2)
        s[::7] = rows          # the sentinel: dropped
        s[1::9] = -1           # wraps to the last row
        s[2::11] = -rows - 2   # still out of range after the wrap: dropped
        kind = str(rng.choice(["set", "set", "set", "add", "max"]))
        vshape = (b,) + tuple(t.shape[1:])
        vals = torch.from_numpy(rng.integers(-1000, 1000, size=vshape).astype(np.int32))
        mask = None
        if t.dim() == 2 and rng.random() < 0.6:
            mask = torch.from_numpy(rng.random(vshape) < 0.5)
        op_list.append(ops.TableOp(ti, kind, torch.from_numpy(s.astype(np.int32)),
                                   torch.from_numpy(rng.random(b) < 0.7), vals, mask))
    return tables, op_list


def _copies(tables):
    return [t.clone() for t in tables]


def _stages(plan):
    out = {}
    for k, st in enumerate(plan.stages):
        out.setdefault(st, []).append(k)
    return [out[st] for st in sorted(out)]


def _launches(plan):
    """The kernel's launches for the plan: pass 0 per stage, pass 1 where
    the stage has a set."""
    return sum(1 + any(plan.kinds[k] == "set" for k in st) for st in _stages(plan))


def _stage_order(tables, op_list, plan):
    """The plain version, op by op, in the kernel's pass order."""
    for st in _stages(plan):
        first = [k for k in st if plan.kinds[k] != "set"]
        for k in first + [k for k in st if plan.kinds[k] == "set"]:
            ops._apply_op_reference(tables[op_list[k].table], op_list[k])
    return tables


def _cells(t, op, masked):
    """(records, lanes, slots) of an op's live (record, lane) pairs, and
    whether each pair is live: active, in range after one wrap, masked in."""
    rows = t.shape[0]
    width = t.shape[1] if t.dim() == 2 else 1
    s = ops._wrap_slots(op.slots, rows)
    keep = op.active & (s >= 0) & (s < rows)
    live = keep[:, None].expand(-1, width)
    if masked:
        live = live & op.mask.reshape(-1, width)
    r, l = torch.nonzero(live, as_tuple=True)
    return r, l, s[r], width


def _claim_rule(tables, op_list, plan, rng):
    """The kernel's two passes per stage on CPU tensors, with one scratch of
    ``plan.words`` words full of stale tags (epoch 0) and epochs from 1."""
    scratch = torch.from_numpy(rng.integers(0, 2**32, size=plan.words + 1, dtype=np.int64))
    epochs, e = {}, 1
    for k, kind in enumerate(plan.kinds):
        if kind == "set":
            epochs[k], e = e, e + 1
    for st in _stages(plan):
        for k in st:  # pass 0: claims, adds and maxes
            op, t = op_list[k], tables[op_list[k].table]
            if plan.kinds[k] != "set":
                ops._apply_op_reference(t, op)
                continue
            r, l, s, width = _cells(t, op, plan.masked[k])
            tag = (epochs[k] << 32) | (r + 1)
            row, lane = plan.regions[k]
            idx = lane + s * width + l if plan.masked[k] else row + s
            scratch.scatter_reduce_(0, idx, tag, reduce="amax")
        for k in st:  # pass 1: each cell's largest claim writes
            if plan.kinds[k] != "set":
                continue
            op, t = op_list[k], tables[op_list[k].table]
            r, l, s, width = _cells(t, op, plan.masked[k])
            tag = (epochs[k] << 32) | (r + 1)
            row, lane = plan.regions[k]
            best = torch.zeros_like(tag)
            if row >= 0:
                best = torch.maximum(best, scratch[row + s])
            if lane >= 0:
                best = torch.maximum(best, scratch[lane + s * width + l])
            win = best == tag
            t.view(-1)[(s * width + l)[win]] = op.vals.reshape(-1, width)[r[win], l[win]]
    return tables


@pytest.mark.parametrize("seed", range(12))
def test_stages_and_claims_equal_the_op_chain(seed):
    rng = np.random.default_rng(seed)
    tables, op_list = _random_case(rng)
    plan = ops.commit_plan(tables, op_list)
    want = ops.fused_table_commit_reference(_copies(tables), op_list)
    for got in (_stage_order(_copies(tables), op_list, plan),
                _claim_rule(_copies(tables), op_list, plan, rng)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # stages: contiguous, and inside one a table takes one kind
    assert plan.stages == sorted(plan.stages)
    for st in _stages(plan):
        kinds = {}
        for k in st:
            assert kinds.setdefault(op_list[k].table, plan.kinds[k]) == plan.kinds[k]
    # regions: one row and one lane region per table a set writes, disjoint
    spans = {}
    for k, (row, lane) in enumerate(plan.regions):
        t = tables[op_list[k].table]
        if row >= 0:
            spans[(op_list[k].table, 0)] = (row, t.shape[0])
        if lane >= 0:
            spans[(op_list[k].table, 1)] = (lane, t.numel())
    ends = sorted(spans.values())
    assert all(a[0] + a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert sum(n for _, n in ends) == plan.words


def test_stage_rule_by_hand():
    """add then set on one table: two stages; sets on several tables, an
    add on another and a 1D max (a set): one; add then max on one table:
    two; a 2D max ignores its lane mask."""
    t2 = torch.zeros((8, 4), dtype=torch.int32)
    t1 = torch.zeros((8,), dtype=torch.int32)
    z = torch.zeros((3,), dtype=torch.int32)
    on = torch.ones((3,), dtype=torch.bool)
    v2 = torch.zeros((3, 4), dtype=torch.int32)
    m2 = torch.ones((3, 4), dtype=torch.bool)

    def plan(*specs):
        return ops.commit_plan([t2, t1, t2.clone()], [
            ops.TableOp(ti, kind, z, on, v2 if ti != 1 else z, m2 if masked else None)
            for ti, kind, masked in specs])

    p = plan((0, "add", True), (0, "set", False))
    assert p.stages == [0, 1] and p.regions[1] == (0, -1) and p.words == 8
    p = plan((0, "set", True), (2, "add", False), (1, "max", False), (0, "set", False))
    assert p.stages == [0, 0, 0, 0] and p.kinds[2] == "set" and p.words == 48
    assert p.regions[0] == p.regions[3] == (40, 0) and p.regions[2] == (32, -1)
    p = plan((0, "add", False), (0, "max", True), (0, "max", False))
    assert p.stages == [0, 1, 1] and p.masked == [False, False, False] and p.words == 0


@pytest.fixture(scope="module")
def main_path_commits():
    """The (tables, ops) of every commit of one CPU drive of the timer
    workflow (config 1's commits plus the timer table's)."""
    calls = []
    real = ops.fused_table_commit

    def record(tables, op_list):
        calls.append(([t.clone() for t in tables], list(op_list)))
        return real(tables, op_list)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "fused_table_commit", record)
    try:
        graph, state, queue, creates = chip_smoke.config_setup(
            64, "cpu", model_fn=chip_smoke.timer_model)
        queue = drive.enqueue(queue, creates)
        drive.run_to_quiescence(graph, state, queue, 0, 64, synthetic_workers=True)
    finally:
        mp.undo()
    return calls


def test_main_path_commits_plan_three_two_and_two_launches(main_path_commits):
    """Each step commits the element-instance group (the token add, then 11
    sets), the job group (8 sets) and the timer group (8 sets): 2, 1 and 1
    stages, 3, 2 and 2 launches."""
    assert len(main_path_commits) % 3 == 0 and main_path_commits
    for i, (tables, op_list) in enumerate(main_path_commits):
        plan = ops.commit_plan(tables, op_list)
        group = i % 3
        kinds = {0: ["add"] + ["set"] * 11, 1: ["set"] * 8, 2: ["set"] * 8}[group]
        assert plan.kinds == kinds, (group, plan.kinds)
        assert len(_stages(plan)) == (2, 1, 1)[group]
        assert _launches(plan) == (3, 2, 2)[group]


def test_main_path_commits_under_the_claim_rule(main_path_commits):
    """The recorded commits of the first step, from the tables as each found
    them: the emulated kernel equals the plain version."""
    rng = np.random.default_rng(5)
    for tables, op_list in main_path_commits[:3]:
        plan = ops.commit_plan(tables, op_list)
        want = ops.fused_table_commit_reference(_copies(tables), op_list)
        got = _claim_rule(_copies(tables), op_list, plan, rng)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_descriptors_hold_the_plan():
    """``_commit_descs`` and ``_scatter_desc`` on CPU tensors (built the same
    way for the card): the fields packed in one call read back through the
    ctypes layout the kernel shares — kinds, stages, increasing epochs for
    the sets, claim pointers at the plan's regions of one scratch, a null
    mask where the plan drops it."""
    assert ops._COMMIT_LAYOUT.size == ctypes.sizeof(ops._CommitDesc)
    rng = np.random.default_rng(21)
    tables, op_list = _random_case(rng)
    plan = ops.commit_plan(tables, op_list)
    descs, keep = ops._commit_descs(tables, op_list)
    scratch = ops._claims[torch.device("cpu")][0].data_ptr() if "set" in plan.kinds else 0
    epochs = [d.epoch for d, kind in zip(descs, plan.kinds) if kind == "set"]
    assert epochs == list(range(epochs[0], epochs[0] + len(epochs))) if epochs else True
    for k, (d, op) in enumerate(zip(descs, op_list)):
        t = tables[op.table]
        assert (d.table, d.rows, d.n) == (t.data_ptr(), t.shape[0], op.slots.shape[0])
        assert d.width == (t.shape[1] if t.dim() == 2 else 1)
        assert (d.kind, d.stage) == (ops._KINDS[plan.kinds[k]], plan.stages[k])
        assert (d.mask is not None) == plan.masked[k]
        row, lane = plan.regions[k]
        assert d.row_claims == (scratch + 8 * row if row >= 0 else None)
        assert d.lane_claims == (scratch + 8 * lane if lane >= 0 else None)
    t2 = torch.zeros((8, 4), dtype=torch.int32)
    z = torch.zeros((3,), dtype=torch.int64)  # slots of another dtype: converted
    on = torch.ones((3,), dtype=torch.bool)
    v = torch.zeros((3, 4), dtype=torch.int32)
    d, keep = ops._scatter_desc("masked_row_max", t2, "max", z, on, v, on[:, None].expand(3, 4))
    assert d.mask is None and d.kind == ops._KINDS["max"] and d.row_claims is None
    assert keep[0].dtype == torch.int32 and d.slots == keep[0].data_ptr()
    d, _ = ops._scatter_desc("masked_row_update", t2, "set", z, on, v, None)
    assert d.row_claims is not None and d.lane_claims is None and d.epoch > 0
