"""The commutative scatters' kernel (``csrc/scatter_accum.cu``) on the CPU:
``ops.fused_accumulate`` against the JAX ops, the kernel's decomposition
emulated in plain Python, its packed call against the ``.cu``'s layout,
and config 3's step issuing one ``fused_accumulate`` for its row maxima.

- ``fused_accumulate`` on CPU tensors (its plain version, after the
  card's checks) equals ``pallas_ops.masked_row_max`` / ``masked_row_add``
  / ``masked_lane_accum`` applied one after another, as
  ``tests/test_torch_scatter.py`` runs them (the XLA fallback), with
  duplicate, wrapping, sentinel, still-out-of-range and int64 slots, with
  and without lane masks. Slots past int32 are clamped by the port
  (``ops._slots_i32``) and wrapped by the JAX CPU path, so the emulation
  below holds those against the plain version.
- The emulation reads the packed call back through the ctypes layout and
  runs the kernel's threads — per-op block ranges, a thread a (record,
  lane), each atomic one step — in random order: it equals the plain
  version, and a copy that skips the wrap of a negative slot does not.
- The packed layout and the ``#define``s equal the ``.cu``'s.
- A config-3 step issues one ``fused_accumulate`` (two maxima) and no
  ``masked_row_max``, and equals the JAX step.

Exact comparison: integer tables.
"""

import ctypes
import pathlib
import random
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import bench
import test_torch_join as tj
from zeebe_tpu.tpu import pallas_ops as pops
from zeebe_tpu_torch.tpu import ops

CSRC = pathlib.Path(ops.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "scatter_accum.cu").read_text()


def _t(a):
    return torch.from_numpy(np.array(a))


def _slots(rng, b, t, dtype, past_int32=False):
    """Heavy duplicates, the sentinel T, a wrapping -1, slots still out of
    range after one wrap, and with ``past_int32`` int64 values past int32,
    which the port clamps and drops (a cast alone would wrap 2^32 + 5 to
    5, as the JAX package's CPU path does: those are held against the
    port's plain version only)."""
    s = rng.integers(0, 6, size=b).astype(np.int64)
    s[b // 2:] = rng.integers(0, t, size=b - b // 2)
    s[::9] = t
    s[1::11] = -1
    s[2::13] = -t - 4
    s[3::17] = t + 5
    if past_int32:
        s[4::19] = 2**32 + 5
        s[5::23] = -2**33 + 1
    return s.astype(dtype)


def _ops_case(seed, slot_dtype=np.int32, masked=True, past_int32=False):
    """Four tables and five ops: a [40, 4] max (a mask given, which a max
    ignores), a [40, 6] add (masked or not), a [48] lane
    accumulate, a [40, 8] add and a second max into the first table, each
    op with slots, flags and values of its own."""
    rng = np.random.default_rng(seed)
    shapes = [(40, 4), (40, 6), (48,), (40, 8)]
    tables = [rng.integers(-1000, 1000, size=s).astype(np.int32) for s in shapes]
    specs = [(0, "max"), (1, "add"), (2, "add"), (3, "add"), (0, "max")]
    op_list = []
    for k, (table, kind) in enumerate(specs):
        t = tables[table]
        b = 60 + 7 * k
        width = t.shape[1] if t.ndim == 2 else 0
        vshape = (b, width) if width else (b,)
        mask = rng.random((b, width)) < 0.5 if width and (masked or kind == "max") else None
        op_list.append((table, kind, _slots(rng, b, t.shape[0], slot_dtype, past_int32), rng.random(b) < 0.7,
                        rng.integers(-1000, 1000, size=vshape).astype(np.int32), mask))
    return tables, op_list


def _jax_apply(tables, op_list):
    out = [jnp.asarray(t) for t in tables]
    for table, kind, slots, active, vals, mask in op_list:
        args = (out[table], jnp.asarray(slots), jnp.asarray(active), jnp.asarray(vals))
        if out[table].ndim == 1:
            out[table] = pops.masked_lane_accum(*args)
        elif kind == "max":
            out[table] = pops.masked_row_max(*args)
        else:
            out[table] = pops.masked_row_add(*args, None if mask is None else jnp.asarray(mask))
    return [np.asarray(t) for t in out]


def _port(tables, op_list):
    tt = [_t(t) for t in tables]
    top = [ops.TableOp(table, kind, _t(s), _t(a), _t(v), None if m is None else _t(m))
           for table, kind, s, a, v, m in op_list]
    return tt, top


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("slot_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_accumulate_equals_the_jax_ops_one_after_another(seed, slot_dtype, masked):
    tables, op_list = _ops_case(seed, slot_dtype, masked)
    want = _jax_apply(tables, op_list)
    tt, top = _port(tables, op_list)
    got = ops.fused_accumulate(tt, top)
    assert all(g is t for g, t in zip(got, tt))  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_fused_accumulate_refuses_what_the_kernel_does_not_take():
    """On the CPU too: a 1D max (the JAX chain sets there), a table taking
    add and max in one call, more than 8 ops, a kind other than add/max,
    an int64 table, values of the wrong width."""
    t1, t2 = torch.zeros(8, dtype=torch.int32), torch.zeros((8, 4), dtype=torch.int32)
    s, a = torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.bool)
    v1, v2 = torch.ones(3, dtype=torch.int32), torch.ones((3, 4), dtype=torch.int32)
    bad = [
        ([t1], [ops.TableOp(0, "max", s, a, v1)], "1D table for an 'add' only"),
        ([t2], [ops.TableOp(0, "add", s, a, v2), ops.TableOp(0, "max", s, a, v2)], "one kind"),
        ([t2], [ops.TableOp(0, "add", s, a, v2)] * 9, "at most 8"),
        ([t2], [ops.TableOp(0, "set", s, a, v2)], "an 'add' or 'max' into a contiguous"),
        ([t2.to(torch.int64)], [ops.TableOp(0, "add", s, a, v2)], "contiguous int32"),
        ([t2], [ops.TableOp(0, "add", s, a, v1)], "disagree"),
    ]
    for tables, op_list, match in bad:
        with pytest.raises(ValueError, match=match):
            ops.fused_accumulate(tables, op_list)


def test_one_op_wrappers_are_the_fused_call():
    """``masked_row_max``, ``masked_row_add`` and ``masked_lane_accum`` on
    CPU tensors equal their one-op ``fused_accumulate`` and count no
    launch."""
    ops.reset_launches()
    tables, op_list = _ops_case(5)
    for table, kind, s, a, v, m in op_list[:4]:
        tt, top = _port([tables[table]], [(0, kind, s, a, v, m)])
        want = ops.fused_accumulate(tt, top)[0]
        args = (_t(tables[table]), _t(s), _t(a), _t(v))
        if tables[table].ndim == 1:
            got = ops.masked_lane_accum(*args)
        elif kind == "max":
            got = ops.masked_row_max(*args)
        else:
            got = ops.masked_row_add(*args, None if m is None else _t(m))
        assert torch.equal(got, want)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def test_one_op_wrappers_take_the_fused_path(monkeypatch):
    """Each one-op wrapper is one ``fused_accumulate`` call of one op of its
    kind on its own table, counted under its own name."""
    calls = []
    real = ops._accumulate

    def spy(name, tables, op_list):
        calls.append((name, len(tables), [(op.table, op.kind, op.mask is None)
                                          for op in op_list]))
        return real(name, tables, op_list)
    monkeypatch.setattr(ops, "_accumulate", spy)
    t2, t1 = torch.zeros((8, 4), dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
    s, a = torch.tensor([1, 1, -1], dtype=torch.int32), torch.ones(3, dtype=torch.bool)
    v2, v1 = torch.ones((3, 4), dtype=torch.int32), torch.ones(3, dtype=torch.int32)
    ops.masked_row_max(t2, s, a, v2)
    ops.masked_row_add(t2, s, a, v2, a[:, None].expand(3, 4))
    ops.masked_lane_accum(t1, s, a, v1)
    assert calls == [("masked_row_max", 1, [(0, "max", True)]),
                     ("masked_row_add", 1, [(0, "add", False)]),
                     ("masked_lane_accum", 1, [(0, "add", True)])]
    assert t2[1].tolist() == [3, 3, 3, 3] and t1.tolist() == [0, 2, 0, 0, 0, 0, 0, 1]


# ---------------------------------------------------------------------------
# the kernel's decomposition, emulated
# ---------------------------------------------------------------------------


def _read_call(blob):
    """The packed call read back: (stream, [AccumOp fields])."""
    stream, n_ops = ops._ACCUM_HEAD.unpack_from(blob, 0)
    descs = []
    for k in range(n_ops):
        at = ops._ACCUM_HEAD.size + k * ops._ACCUM_LAYOUT.size
        descs.append(ops._AccumOp.from_buffer_copy(blob[at: at + ops._ACCUM_LAYOUT.size]))
    return stream, descs


def _units(descs, threads):
    """Every thread of the launch as (op, record, lane): the C entry's plan
    — op k's blocks start where op k - 1's end, ceil(n * width / threads)
    each — and the kernel's scan of the starts; thread u of an op takes
    record u // width, lane u % width."""
    starts, block = [], 0
    for d in descs:
        starts.append(block)
        block += -(-d.n * d.width // threads)
    starts.append(block)
    units = []
    for b in range(block):
        k = 0
        while k + 1 < len(descs) and b >= starts[k + 1]:
            k += 1
        d = descs[k]
        for x in range(threads):
            u = (b - starts[k]) * threads + x
            if u < d.n * d.width:
                units.append((k, u // d.width, u % d.width))
    return units


def _emulate(descs, memory, rng, wrap=True):
    """Run the kernel's threads in random order on ``memory`` (data_ptr ->
    tensor): each reads its flag, mask byte and slot, then applies its
    lane as one atomic step; the atomics of all threads interleave.
    ``wrap=False``: a broken kernel that drops a negative slot instead of
    wrapping it once."""
    steps = []
    for k, r, lane in _units(descs, ops._ACCUM_THREADS):
        d = descs[k]
        if not memory[d.active][r]:
            continue
        if d.mask and not memory[d.mask].reshape(-1)[r * d.width + lane]:
            continue
        s = int(memory[d.slots][r])
        if s < 0 and wrap:
            s += d.rows
        if not 0 <= s < d.rows:
            continue
        steps.append((d, s * d.width + lane, int(memory[d.vals].reshape(-1)[r * d.width + lane])))
    rng.shuffle(steps)
    for d, cell, v in steps:
        flat = memory[d.table].view(-1)
        flat[cell] = flat[cell] + v if d.kind == ops._KINDS["add"] else max(int(flat[cell]), v)


def _memory(tables, top, keep):
    mem = {}
    for t in list(tables) + [x for op in top for x in (op.slots, op.active, op.vals, op.mask)
                             if x is not None] + keep:
        mem[t.data_ptr()] = t
    return mem


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_emulated_kernel_in_random_order_equals_the_plain_version(seed):
    tables, op_list = _ops_case(seed, np.int64, past_int32=True)
    tt, top = _port(tables, op_list)
    want = ops.fused_accumulate_reference([t.clone() for t in tt], top)
    blob, keep = ops._accum_call("fused_accumulate", tt, top, 0, False)
    stream, descs = _read_call(blob)
    assert stream == 0 and len(descs) == len(top)
    # the two-dim max ignores its mask; int64 slots arrive converted
    assert descs[0].mask is None and descs[0].kind == ops._KINDS["max"]
    assert len(keep) == len(top) and all(t.dtype == torch.int32 for t in keep)
    _emulate(descs, _memory(tt, top, keep), random.Random(seed))
    for g, w in zip(tt, want):
        assert torch.equal(g, w)


def test_a_model_without_the_slot_wrap_fails():
    """Slot -1 names the last row: a kernel that skips the wrap loses those
    records' values, and the check above would see it."""
    tables, op_list = _ops_case(6)
    tt, top = _port(tables, op_list)
    want = ops.fused_accumulate_reference([t.clone() for t in tt], top)
    blob, keep = ops._accum_call("fused_accumulate", tt, top, 0, False)
    _stream, descs = _read_call(blob)
    _emulate(descs, _memory(tt, top, keep), random.Random(0), wrap=False)
    assert not all(torch.equal(g, w) for g, w in zip(tt, want))


def test_the_plan_gives_each_op_its_own_blocks():
    """Op k's threads cover its n * width (record, lane) units exactly
    once, and an op without records takes no block."""
    z = torch.zeros
    tables = [z((16, 6), dtype=torch.int32), z((16,), dtype=torch.int32)]
    top = [ops.TableOp(0, "add", z(300, dtype=torch.int32), z(300, dtype=torch.bool),
                       z((300, 6), dtype=torch.int32)),
           ops.TableOp(1, "add", z(0, dtype=torch.int32), z(0, dtype=torch.bool),
                       z(0, dtype=torch.int32)),
           ops.TableOp(1, "add", z(513, dtype=torch.int32), z(513, dtype=torch.bool),
                       z(513, dtype=torch.int32))]
    _stream, descs = _read_call(ops._accum_call("fused_accumulate", tables, top, 0, False)[0])
    units = _units(descs, ops._ACCUM_THREADS)
    assert sorted(units) == sorted({(0, r, lane) for r in range(300) for lane in range(6)}
                                   | {(2, r, 0) for r in range(513)})


# ---------------------------------------------------------------------------
# the packed call and the kernel's defines
# ---------------------------------------------------------------------------


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SOURCE).group(1))


@pytest.mark.parametrize("define, value", [
    ("ZB_MAX_ACCUM_OPS", lambda: ops._MAX_ACCUM_OPS),
    ("ZB_ACCUM_THREADS", lambda: ops._ACCUM_THREADS),
])
def test_constants_equal_the_kernels_defines(define, value):
    assert _define(define) == value()


def test_packed_call_matches_the_kernels_structs():
    """``AccumCall``: an 8-byte stream, the op count and a pad, then 56-byte
    ``AccumOp``s (5 pointers, rows, width, n, kind); the kinds are the
    enum's. A one-op call is the head and one op."""
    assert re.search(r"enum \{ ZB_ADD = (\d), ZB_MAX = (\d) \}", SOURCE).groups() == (
        str(ops._KINDS["add"]), str(ops._KINDS["max"]))
    assert ops._ACCUM_HEAD.size == 16
    assert ops._ACCUM_LAYOUT.size == ctypes.sizeof(ops._AccumOp) == 56
    assert [c.size for c in ops._ACCUM_CALLS] == [16 + 56 * n for n in range(9)]
    fields = re.search(r"struct AccumOp \{(.*?)\};", SOURCE, re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == [f[0] for f in ops._AccumOp._fields_]
    t = torch.zeros((8, 4), dtype=torch.int32)
    s, a, v = torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.bool), t[:3].clone()
    keep = []
    fields = ops._accum_fields("masked_row_max", t, "max", s, a, v, a[:, None].expand(3, 4), keep)
    blob = ops._ACCUM_HEAD.pack(12345, 1) + ops._ACCUM_LAYOUT.pack(*fields)
    assert blob == ops._ACCUM_CALLS[1].pack(12345, 1, *fields)
    stream, (d,) = _read_call(blob)
    assert stream == 12345 and d.mask is None  # a max ignores the lane mask
    assert (d.table, d.slots, d.active, d.vals) == (t.data_ptr(), keep[0].data_ptr(),
                                                    a.data_ptr(), v.data_ptr())
    assert (d.rows, d.width, d.n, d.kind) == (8, 4, 3, ops._KINDS["max"])
    assert blob == ops._accum_call("masked_row_max", [t], [ops.TableOp(0, "max", keep[0], a, v)],
                                   12345, False)[0]


# ---------------------------------------------------------------------------
# config 3: one launch for the step's two row maxima
# ---------------------------------------------------------------------------


def test_a_config3_step_issues_one_fused_accumulate(monkeypatch):
    """Config 3 walked round by round (the joins' arrivals within and across
    batches, scrambled payloads): each step equals the JAX step and issues
    exactly one ``fused_accumulate`` of two maxima, into the arrival flags
    and the flow-position stamps, and no ``masked_row_max``."""
    calls = []
    real = ops.fused_accumulate

    def counted(tables, op_list):
        op_list = list(op_list)
        calls.append([(op.kind, tuple(tables[op.table].shape)) for op in op_list])
        return real(tables, op_list)

    def refused(*_args, **_kwargs):
        raise AssertionError("config 3's step called masked_row_max")

    rounds = []
    real_both = tj.both_steps

    def counting_both(*args, **kwargs):
        before = len(calls)
        out = real_both(*args, **kwargs)
        rounds.append(len(calls) - before)
        return out

    monkeypatch.setattr(ops, "fused_accumulate", counted)
    monkeypatch.setattr(ops, "masked_row_max", refused)
    monkeypatch.setattr(tj, "both_steps", counting_both)
    jgraph, meta = tj._forkjoin()
    jstate = tj._jax_state(meta, capacity=64, join_capacity=64)
    creates = bench.stage_creates(meta, 4, tj.NUM_VARS, meta.interns)
    same, later, _over = tj._walk(jgraph, jstate, creates, 5, 60,
                                  scramble=np.random.default_rng(3))
    assert same > 0 and later > 0
    assert rounds and rounds == [1] * len(rounds)
    shapes = [tuple(jstate.join_arrived.shape), tuple(jstate.join_pos_stamp.shape)]
    assert calls == [list(zip(("max", "max"), shapes))] * len(calls)
