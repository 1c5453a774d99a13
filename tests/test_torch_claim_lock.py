"""The claim scratch under threads: epochs reach the stream in grant order.

``ops._claim_scratch`` hands out claim epochs from one scratch per device,
and a kernel writes only where the largest claim equals its own tag, so a
lower epoch launched after a higher one loses its writes without a trace
(``csrc/table_commit.cu``, ``csrc/hash_update.cu``). A cluster node launches
from several threads (one drain actor per broker), so the table commit,
the one-op commit and the insert hold ``ops._scratch_lock`` from the grant
through the launch. Here the C entry points are replaced by recorders and
the wrappers' CUDA paths run on CPU tensors (their descriptors hold plain
pointers): whatever the thread schedule, the epochs recorded in launch
order must be the ones granted, in the order granted. Without the lock the
schedule below interleaves grants and launches within a few calls.
"""

import contextlib
import sys
import threading
import time

import pytest
import torch

from zeebe_tpu_torch.tpu import hashmap, ops

THREADS = 6
CALLS = 60
CPU = torch.device("cpu")


@pytest.fixture
def recorded(monkeypatch):
    """Replace every C entry with a recorder of (first epoch, epochs) per
    launch, make each grant yield the interpreter, and start from a fresh
    scratch large enough for all of them."""
    launches = []

    def commit(descs, n, _stream):
        descs = getattr(descs, "_obj", descs)  # a one-op commit passes byref
        descs = [descs] if isinstance(descs, ops._CommitDesc) else descs
        epochs = [descs[k].epoch for k in range(n) if descs[k].epoch]
        launches.append((epochs[0], len(epochs)))
        return 1

    def insert(args_ref, _stream):
        args = args_ref._obj
        launches.append((args.epoch, args.rounds))
        return 1

    grant = ops._claim_scratch

    def yielding_grant(*a, **kw):
        out = grant(*a, **kw)
        time.sleep(0)  # another thread may take the interpreter here
        return out

    monkeypatch.setattr(ops, "_commit_fn", lambda: commit)
    monkeypatch.setattr(ops, "_insert_fn", lambda: insert)
    monkeypatch.setattr(ops, "_stream", lambda _device: 0)
    monkeypatch.setattr(ops, "_device_guard", lambda _device: contextlib.nullcontext())
    monkeypatch.setattr(ops, "_claim_scratch", yielding_grant)
    monkeypatch.setattr(ops, "_claims", {})
    monkeypatch.setattr(ops, "_worklists", {})
    # one scratch for every call below: a larger request would start a
    # fresh, zeroed scratch at epoch 1
    grant(torch.device("cpu"), 1 << 12, 0)
    return launches


def _calls(seed):
    """One thread's mix of two-set table commits, one-op sets and inserts
    into tables of its own."""
    g = torch.Generator().manual_seed(seed)
    table = torch.zeros((64, 4), dtype=torch.int32)
    lane = torch.zeros(64, dtype=torch.int32)
    hmap = hashmap.make(256, device="cpu")
    slots = torch.randint(0, 64, (16,), generator=g)
    on = torch.ones(16, dtype=torch.bool)
    vals = torch.randint(0, 9, (16, 4), generator=g, dtype=torch.int32)
    keys = torch.arange(16, dtype=torch.int64) + 1000 * seed
    commit_ops = [ops.TableOp(0, "set", slots, on, vals),
                  ops.TableOp(1, "set", slots, on, vals[:, 0])]
    for k in range(CALLS):
        if k % 3 == 0:
            ops._commit_cuda([table, lane], commit_ops, CPU)
        elif k % 3 == 1:
            ops._scatter_cuda("masked_row_update", table, "set", slots, on, vals, None, CPU)
        else:
            ops._insert_cuda(hmap, keys, keys.to(torch.int32), on, CPU)


def test_epochs_reach_the_stream_in_grant_order(recorded):
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=_calls, args=(s,)) for s in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(recorded) == THREADS * CALLS
    expected = 1
    for first, count in recorded:
        assert first == expected, recorded
        expected += count
