"""Microbenchmark of the two primitives the step kernel's design rests on.

PyTorch counterpart of ``benchmarks/pallas_probe.py``: a serial dynamic
row write (``row_loop``: records write whole rows of a table, the last
writer in batch order winning) and a scalar hash probe (``probe``: an
8-step linear probe of int32 keys), each a hand-written CUDA kernel
(``csrc/probe.cu``) beside its plain PyTorch version, against the library
arm, a chain of ``index_put_`` row scatters (the counterpart of the JAX
script's ``xla_scatter_chain``).

    python -m zeebe_tpu_torch.probe       # on the CUDA card, B = 2^14,
                                          # CAP = 2^16, K = 128

Dispatch is by the tensors' device, as in ``tpu/ops.py``: CPU tensors take
the plain version (``*_reference``), CUDA tensors launch the kernel or
raise. ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from zeebe_tpu_torch import _build
from zeebe_tpu_torch.device import DeviceLike, resolve
from zeebe_tpu_torch.tpu import ops

B = 16384
CAP = 65536
K = 128  # table row width
PROBES = 8
HASH_MUL = 0x9E3779B1
EMPTY = -1

LAUNCHES: Dict[str, int] = {"row_loop": 0, "probe": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _entry(name: str, argtypes: tuple):
    fn = getattr(_build.library("probe"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check_row_loop(tbl, idx, rows, n_writes):
    if tbl.dtype != torch.int32 or tbl.dim() != 2 or not tbl.is_contiguous():
        raise ValueError("row_loop: the table must be a contiguous [CAP, K] int32 tensor")
    if idx.shape != (rows.shape[0],) or rows.shape[1:] != tbl.shape[1:]:
        raise ValueError("row_loop: idx [B] and rows [B, K] must match the table")
    if n_writes < 1:
        raise ValueError("row_loop: n_writes must be at least 1")


# ---------------------------------------------------------------------------
# row loop
# ---------------------------------------------------------------------------


def row_loop_reference(tbl: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                       n_writes: int) -> torch.Tensor:
    """Plain version, in place: per table row, the last record in batch
    order that names it leaves ``rows[last] + n_writes - 1``; an index
    outside the table writes nothing."""
    _check_row_loop(tbl, idx, rows, n_writes)
    cap = tbl.shape[0]
    i = idx.to(torch.int64)
    ok = (i >= 0) & (i < cap)
    rank = torch.arange(i.shape[0], dtype=torch.int64, device=i.device)
    last = torch.full((cap + 1,), -1, dtype=torch.int64, device=i.device)
    last.scatter_reduce_(0, torch.where(ok, i, cap), torch.where(ok, rank, -1),
                         reduce="amax", include_self=True)
    win = ok & (last[torch.where(ok, i, cap)] == rank)
    tbl[i[win]] = rows[win] + (n_writes - 1)
    return tbl


@functools.lru_cache(maxsize=None)
def _row_loop_fn():
    """``zb_row_loop`` of csrc/probe.cu: (tbl, idx, rows, b, cap, k,
    n_writes, claims, epoch, passes, stream) -> launches enqueued, or
    minus a CUDA error."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _entry("zb_row_loop", (p, p, p, i64, i64, i64, ctypes.c_int, p, ctypes.c_uint64,
                                  ctypes.c_int, p))


def row_loop(tbl: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
             n_writes: int) -> torch.Tensor:
    """``tbl[idx[i]] = rows[i] + w`` for i in batch order and w < n_writes,
    IN PLACE: one kernel call on CUDA tensors (the claim pass, and the
    write pass chained to it by programmatic dependent launch)."""
    device = ops._cuda_device([tbl, idx, rows], "row_loop")
    if device is None:
        return row_loop_reference(tbl, idx, rows, n_writes)
    _check_row_loop(tbl, idx, rows, n_writes)
    idx = idx.to(torch.int32).contiguous()
    rows = rows.to(torch.int32).contiguous()
    cap, k = tbl.shape
    # grant to launch (see ops._claims)
    with ops._scratch_lock(device), ops._device_guard(device):
        scratch, epoch = ops._claim_scratch(tbl.device, cap, 1)
        launched = _row_loop_fn()(tbl.data_ptr(), idx.data_ptr(), rows.data_ptr(),
                                  idx.shape[0], cap, k, n_writes, scratch.data_ptr(), epoch,
                                  3, ops._stream(device))
    if launched < 0:
        raise RuntimeError(f"row_loop: CUDA error {-launched} at launch")
    if launched:
        LAUNCHES["row_loop"] += 1
    return tbl


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------


def _home(keys: torch.Tensor, cap: int) -> torch.Tensor:
    """The probe's first bucket, (k · 0x9E3779B1) & (CAP - 1) in 32-bit
    arithmetic (the low bits of the int64 product are the same)."""
    return (keys.to(torch.int64) * HASH_MUL) & (cap - 1)


def probe_reference(keys: torch.Tensor, tkeys: torch.Tensor) -> torch.Tensor:
    """Plain version: the index of the first bucket holding the key within
    8 linear probes, or -1; an EMPTY bucket ends the chain."""
    cap = tkeys.shape[0]
    h = _home(keys, cap)
    k = keys.to(torch.int32)
    slot = torch.full(k.shape, -1, dtype=torch.int32, device=k.device)
    done = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
    for j in range(PROBES):
        at = (h + j) & (cap - 1)
        tk = tkeys[at]
        hit = ~done & (tk == k)
        slot = torch.where(hit, at.to(torch.int32), slot)
        done = done | (tk == k) | (tk == EMPTY)
    return slot


def probe(keys: torch.Tensor, tkeys: torch.Tensor) -> torch.Tensor:
    """[B] int32 slots of ``keys`` in the linear-probe table ``tkeys``
    ([CAP] int32, CAP a power of two, EMPTY = -1); one kernel launch on
    CUDA tensors."""
    cap = tkeys.shape[0]
    if keys.dim() != 1 or tkeys.dim() != 1 or cap & (cap - 1):
        raise ValueError("probe: keys [B] and a power-of-two table [CAP] expected")
    device = ops._cuda_device([keys, tkeys], "probe")
    if device is None:
        return probe_reference(keys, tkeys)
    keys = keys.to(torch.int32).contiguous()
    tkeys = tkeys.to(torch.int32).contiguous()
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = _entry("zb_probe", (p, p, i64, i64, p, p))
    with ops._device_guard(device):
        _build.check(fn(keys.data_ptr(), tkeys.data_ptr(), keys.shape[0], cap,
                        out.data_ptr(), ops._stream(device)), "probe")
    LAUNCHES["probe"] += 1
    return out


def hashed_table(keys: np.ndarray, cap: int) -> np.ndarray:
    """A [cap] int32 table holding ``keys`` (distinct) where the probe
    looks for them: each at its home bucket or the next free one after it
    (linear probing), so chains form and some run past 8 probes."""
    table = np.full((cap,), EMPTY, dtype=np.int32)
    homes = _home(torch.from_numpy(keys.astype(np.int32)), cap).numpy()
    for key, at in zip(keys.tolist(), homes.tolist()):
        while table[at] != EMPTY:
            at = (at + 1) & (cap - 1)
        table[at] = key
    return table


def script_table(cap: int = CAP) -> torch.Tensor:
    """The JAX script's own table: key k at index k for every third k
    (``pallas_probe.py:148-149``): keys away from their hash, so nearly
    every probe misses."""
    t = torch.full((cap,), EMPTY, dtype=torch.int32)
    t[0::3] = torch.arange(0, cap, 3, dtype=torch.int32)
    return t


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------


def _time_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of one call over ``iters`` back-to-back calls
    between two CUDA events, after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def index_put_chain(tbl: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                    n_ops: int) -> torch.Tensor:
    """The library arm: ``n_ops`` dependent ``index_put_`` row scatters of
    ``rows + i`` (PyTorch orders no duplicate indices: timed only)."""
    i = idx.to(torch.int64)
    for op in range(n_ops):
        tbl.index_put_((i,), rows + op)
    return tbl


def main(device: DeviceLike = None, seed: int = 0, iters: int = 20) -> Dict[str, float]:
    """Time the library arm, the row loop at n_writes 1 and 10 and the
    probe on the script's table and on a hashed table with chains; print
    one line each and return the numbers (ms per call)."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe benchmark times CUDA kernels: run it on the card")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, CAP, (B,), generator=gen, dtype=torch.int32).to(dev)
    rows = torch.ones((B, K), dtype=torch.int32, device=dev)
    tbl = torch.zeros((CAP, K), dtype=torch.int32, device=dev)
    out: Dict[str, float] = {}

    def line(label: str, key: str, ms: float, per: int, unit: str) -> None:
        out[key] = ms
        print(f"{label:<22}{ms:8.3f} ms  ({ms / per * 1e6:6.1f} ns/{unit})", flush=True)

    for n in (1, 10):
        line(f"index_put_ x{n}:", f"index_put_x{n}_ms",
             _time_ms(lambda: index_put_chain(tbl, idx, rows, n), iters), B * n,
             "row" if n == 1 else "row/op")
    for n in (1, 10):
        line(f"cuda row loop w={n}:", f"row_loop_w{n}_ms",
             _time_ms(lambda: row_loop(tbl, idx, rows, n), iters), B, "iter")
    keys = torch.randint(0, CAP, (B,), generator=gen, dtype=torch.int32).to(dev)
    tkeys = script_table().to(dev)
    line("cuda probe:", "probe_ms", _time_ms(lambda: probe(keys, tkeys), iters), B, "key")
    present = np.random.default_rng(seed).choice(2**31 - 1, CAP // 2, replace=False)
    chained = torch.from_numpy(hashed_table(present, CAP)).to(dev)
    mixed = torch.from_numpy(np.concatenate(
        [present[: B // 2], present[: B // 2] + 1]).astype(np.int32)).to(dev)
    line("cuda probe, chained:", "probe_chained_ms",
         _time_ms(lambda: probe(mixed, chained), iters), B, "key")
    return out


if __name__ == "__main__":
    main()
