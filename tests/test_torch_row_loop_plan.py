"""The probe's row loop (``csrc/probe.cu``) on the CPU: its claim pass and
its warp-a-record write pass, chained by programmatic dependent launch,
emulated under random interleavings against ``probe.row_loop_reference``
and ``benchmarks/pallas_probe.py``'s Pallas kernel in interpret mode.

The emulation is an event schedule. Every event gets a random time that
respects only what the card guarantees:
- the claim pass: one ``atomicMax`` of the record's tag (epoch << 32 |
  rank + 1) per in-range record, at any time in [0, 1);
- the write pass: each warp loads its record's index and first row unit
  before ``griddepcontrol.wait``, at any time in [0, 1) too (they read
  inputs no pass writes, so they may run beside the claims); the wait
  returns at 1, after every claim; then the warp reads its row's claim
  and, if it holds its own tag, stores each unit of the row n_writes
  times (a unit is an int4 at n_writes 1, a 4-byte word above), the
  stores of one unit in order, every store of every warp interleaved at
  random with every other.
A row's final unit is the last store to it. The claim scratch and epochs
are ``ops._claim_scratch``'s, kept across calls: a stale tag of a higher
rank from an earlier epoch loses, and the wrap of the 32-bit epoch space
zeroes the scratch. Two deliberately broken schedules — the claim read
before the wait returns, or the stores too — must fail.

Exact comparison: int32 tables.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import pallas_probe as jp
from zeebe_tpu_torch import probe as tp
from zeebe_tpu_torch.tpu import ops

CPU = torch.device("cpu")


def _emulate(tbl, idx, rows, n_writes, rng, claim_read="after_wait", stores="after_wait"):
    """The two passes on ``tbl`` (numpy [CAP, K] int32, in place), with
    the claim scratch and epoch ``ops._claim_scratch`` hands out.
    ``claim_read`` / ``stores``: "after_wait" (the kernel) or "early" (a
    broken kernel that does not wait for the claim pass)."""
    cap, k = tbl.shape
    b = idx.shape[0]
    scratch, epoch = ops._claim_scratch(CPU, cap, 1)
    claims = scratch.numpy()[:cap].view(np.uint64)
    rank = np.arange(b, dtype=np.uint64)
    tags = (np.uint64(epoch) << np.uint64(32)) | (rank + np.uint64(1))
    live = (idx >= 0) & (idx < cap)
    rec = np.nonzero(live)[0]
    t = idx[rec].astype(np.int64)
    claim_at = rng.random(rec.shape[0])
    # early loads of index and first unit: any time in [0, 1), of inputs
    # no pass writes, so the value is the input's whatever the time
    first = rows[rec].copy()
    read_at = rng.random(rec.shape[0]) + (1.0 if claim_read == "after_wait" else 0.0)
    # each read sees the row's claim as the claims before it left it
    seen = np.empty(rec.shape[0], dtype=np.uint64)
    events = sorted([(claim_at[j], 0, j) for j in range(rec.shape[0])]
                    + [(read_at[j], 1, j) for j in range(rec.shape[0])])
    for _time, kind, j in events:
        if kind == 0:
            claims[t[j]] = max(claims[t[j]], tags[rec[j]])
        else:
            seen[j] = claims[t[j]]
    win = np.nonzero(seen == tags[rec])[0]
    unit = 4 if n_writes == 1 else 1
    units = k // unit
    start = read_at[win] if stores == "after_wait" else rng.random(win.shape[0])
    start = np.maximum(start, 1.0) if stores == "after_wait" else start
    # [winner, unit, w]: stores of one unit in order, all of them interleaved
    times = start[:, None, None] + rng.random((win.shape[0], units, n_writes)).cumsum(-1)
    cells = t[win][:, None, None] * units + np.arange(units)[None, :, None]
    cells = np.broadcast_to(cells, times.shape).reshape(-1)
    order = np.lexsort((times.reshape(-1), cells))
    last = order[np.r_[cells[order][1:] != cells[order][:-1], True]]
    w_of = last % n_writes
    unit_of = (last // n_writes) % units
    winner_of = last // (n_writes * units)
    vals = first[win].reshape(win.shape[0], units, unit)[winner_of, unit_of] + w_of[:, None]
    tbl.reshape(cap * units, unit)[cells[last]] = vals.astype(np.int32)
    return tbl


def _case(seed, b=jp.B, cap=jp.CAP, k=jp.K, out_of_range=False):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(-2**31, 2**31 - 1, size=(cap, k), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, cap, size=b).astype(np.int32)
    if out_of_range:
        idx[::37] = cap
        idx[1::41] = -1
    rows = rng.integers(-2**31, 2**31 - 1, size=(b, k), dtype=np.int64).astype(np.int32)
    return tbl, idx, rows


def _reference(tbl, idx, rows, n_writes):
    return tp.row_loop_reference(torch.from_numpy(tbl.copy()), torch.from_numpy(idx),
                                 torch.from_numpy(rows), n_writes).numpy()


@pytest.mark.parametrize("n_writes", [1, 10])
def test_emulated_passes_equal_the_pallas_kernel_and_the_plain_version(n_writes):
    """At the probe's own sizes (B = 2^14 into [2^16, 128]; about 1,700
    rows named more than once)."""
    tbl, idx, rows = _case(n_writes)
    want = np.asarray(pl.pallas_call(
        functools.partial(jp._row_loop_kernel, n_writes=n_writes),
        out_shape=jax.ShapeDtypeStruct(tbl.shape, jnp.int32),
        input_output_aliases={2: 0},
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(tbl)))
    got = _emulate(tbl.copy(), idx, rows, n_writes, np.random.default_rng(100 + n_writes))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _reference(tbl, idx, rows, n_writes))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_passes_with_out_of_range_indices(seed):
    """Indices outside [0, CAP) claim nothing and write nothing."""
    tbl, idx, rows = _case(seed, b=2048, cap=512, k=16, out_of_range=True)
    for n_writes in (1, 3):
        got = _emulate(tbl.copy(), idx, rows, n_writes, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, _reference(tbl, idx, rows, n_writes))


def test_a_stale_tag_of_a_higher_rank_from_an_earlier_call_loses():
    """Call 1 has 2,048 records, so its tags reach rank 2,048; call 2 has
    64 records into the same rows: their ranks are lower, their epoch
    higher, so they win and the table is call 2's plain result."""
    tbl, idx, rows = _case(5, b=2048, cap=256, k=8)
    rng = np.random.default_rng(5)
    first = _emulate(tbl.copy(), idx, rows, 1, rng)
    small_idx = np.ascontiguousarray(idx[-64:][::-1])  # rows call 1's high ranks won
    got = _emulate(first.copy(), small_idx, rows[:64], 2, rng)
    np.testing.assert_array_equal(got, _reference(first, small_idx, rows[:64], 2))


def test_the_epoch_wrap_zeroes_the_scratch():
    """Past the last epoch the scratch is zeroed and the epochs start
    again at 1: a tag left by the call before the wrap (epoch 2^32 - 2)
    would beat every new one, so without the zeroing the next call would
    write nothing where the old call claimed."""
    tbl, idx, rows = _case(6, b=1024, cap=256, k=8)
    rng = np.random.default_rng(6)
    ops._claim_scratch(CPU, 256, 1)  # a scratch of at least 256 words
    ops._claims[CPU][1] = 2**32 - 3
    before = _emulate(tbl.copy(), idx, rows, 1, rng)  # epoch 2^32 - 2
    assert ops._claims[CPU][1] == 2**32 - 2
    got = _emulate(before.copy(), idx[::-1].copy(), rows, 1, rng)  # wraps: epoch 1
    assert ops._claims[CPU][1] == 1
    np.testing.assert_array_equal(got, _reference(before, idx[::-1].copy(), rows, 1))


@pytest.mark.parametrize("claim_read, stores", [("early", "after_wait"), ("early", "early")])
def test_a_pass_that_does_not_wait_for_the_claims_fails(claim_read, stores):
    """A write pass that decides from a claim read before the wait, or
    also stores before it, lets a record whose claim was not yet beaten
    write: rows end mixed or with a loser's values."""
    tbl, idx, rows = _case(7, b=4096, cap=1024, k=8)
    want = _reference(tbl, idx, rows, 2)
    bad = [not np.array_equal(_emulate(tbl.copy(), idx, rows, 2, np.random.default_rng(s),
                                       claim_read, stores), want) for s in range(3)]
    assert all(bad)
