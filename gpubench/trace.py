"""The traced run's readings: ``torch.profiler`` over the traced units, read
from its Chrome trace, and the bytes each hand-written kernel has to move,
counted from the shapes of the calls into ``zeebe_tpu_torch.tpu.ops``.

What ``chip_smoke.py`` does for its ``--profile`` tables (``profile_config``,
``_device_events``) and phase 2's bounds, kept here as the benchmark's own.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# H100 SXM device memory rate (NVIDIA data sheet): the least time of a
# kernel that moves bytes and does no arithmetic to speak of is its bytes
# over this
HBM_BYTES_PER_S = 3.35e12

# the hand-written kernels of zeebe_tpu_torch/csrc as the profiler names
# them, by the ops wrapper that launches each
KERNELS = {
    "gather_rows": "gather_rows_kernel",
    "table_commit": "commit_pass_kernel",
    "scatter_accum": "scatter_accum_kernel",
    "hash_lookup": "hash_lookup_kernel",
    "hash_insert": "hash_insert_kernel",
    "hash_delete": "hash_delete_kernel",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
# the idle gaps named by what the host was doing: the longest this many
NAMED_GAPS = 500


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read (``gpubench/metrics/*.py``)."""

    rounds: int                      # drive rounds of the profiled units
    window_s: float                  # wall seconds of the profiled units
    plain_rounds: int                # the same of units run untraced
    plain_s: float
    busy_s: float
    launches: int
    kernel_s: Dict[str, float]       # device seconds by kernel name
    bytes_moved: Dict[str, float]    # least bytes by csrc kernel (KERNELS' keys), of
                                     # as many units of the same sizes, counted apart
    rebuild_ms: List[float]
    tick_ms: List[float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    # the same busy time and kernels by card (the profiler's device index)
    card_busy_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    card_launches: Dict[int, int] = dataclasses.field(default_factory=dict)

    def csrc_seconds(self, short: str) -> float:
        name = KERNELS[short]
        return sum(s for k, s in self.kernel_s.items() if name in k)


class ByteCounter:
    """Wraps the ``ops`` wrappers that launch the csrc kernels and counts, per
    kernel, the least bytes its calls have to move: each input byte a call
    needs read once (a row that several records name, once), each output
    byte written once. The counts that depend on the data stay on the
    device until ``totals``. The counting adds launches and syncs nothing:
    run it over units that are neither timed nor profiled."""

    WRAPPED = ("fused_gather_rows", "fused_table_commit", "fused_lookup", "insert",
               "fused_delete", "fused_accumulate")

    def __init__(self):
        from zeebe_tpu_torch.tpu import ops

        self.ops = ops
        self.fixed: Dict[str, float] = defaultdict(float)
        self.counted: List[Tuple[str, torch.Tensor, float]] = []
        self.saved = {name: getattr(ops, name) for name in self.WRAPPED}
        for name in self.WRAPPED:
            setattr(ops, name, getattr(self, "_" + name))

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def _per(self, kernel: str, count: torch.Tensor, nbytes: float):
        self.counted.append((kernel, count, nbytes))

    @staticmethod
    def _row_bytes(t: torch.Tensor) -> int:
        return (t.numel() // max(1, t.shape[0])) * t.element_size()

    @staticmethod
    def _distinct(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """How many distinct values ``values`` holds where ``mask`` is set."""
        v = values.reshape(-1).to(torch.int64)
        if v.numel() == 0:
            return torch.zeros((), dtype=torch.int64, device=v.device)
        if mask is not None:
            v = torch.where(mask.reshape(-1), v, torch.iinfo(torch.int64).min)
        s = torch.sort(v).values
        n = (s[1:] != s[:-1]).sum() + 1
        if mask is not None:
            n = n - (~mask).any().to(torch.int64)
        return n

    def _fused_gather_rows(self, tables, ops):
        ops = list(ops)
        for op in ops:
            n, row = op.slots.shape[0], self._row_bytes(tables[op.table])
            self.fixed["gather_rows"] += n * (op.slots.element_size() + row)
            self._per("gather_rows", self._distinct(op.slots, None), row)
        return self.saved["fused_gather_rows"](tables, ops)

    def _commit_like(self, kernel, tables, ops):
        for op in ops:
            b = op.active.shape[0]
            self.fixed[kernel] += b * op.active.element_size()
            self._per(kernel, torch.count_nonzero(op.active), op.slots.element_size())
            rows = self._distinct(op.slots, op.active)
            if op.mask is None:
                self._per(kernel, rows, 2 * self._row_bytes(tables[op.table]))
            else:
                self.fixed[kernel] += op.mask.numel() * op.mask.element_size()
                self._per(kernel, rows, 2 * tables[op.table].element_size())

    def _fused_table_commit(self, tables, ops):
        ops = list(ops)
        self._commit_like("table_commit", tables, ops)
        return self.saved["fused_table_commit"](tables, ops)

    def _fused_accumulate(self, tables, ops):
        ops = list(ops)
        self._commit_like("scatter_accum", tables, ops)
        return self.saved["fused_accumulate"](tables, ops)

    def _fused_lookup(self, tables, probes):
        probes = list(probes)
        for p in probes:
            # the valid mask in, found and value out for every row; each
            # distinct valid key read, with at least its bucket's key and value
            self.fixed["hash_lookup"] += p.valid.shape[0] * (p.valid.element_size() + 1 + 4)
            self._per("hash_lookup", self._distinct(p.keys, p.valid),
                      p.keys.element_size() + 8 + 4)
        return self.saved["fused_lookup"](tables, probes)

    def _insert(self, table, keys, vals, valid):
        # the valid mask in, ok out; each valid key and value read and its
        # bucket's key and value written (an insert's keys are distinct)
        self.fixed["hash_insert"] += valid.shape[0] * (valid.element_size() + 1)
        self._per("hash_insert", torch.count_nonzero(valid),
                  keys.element_size() + vals.element_size() + 8 + 4)
        return self.saved["insert"](table, keys, vals, valid)

    def _fused_delete(self, tables, deletes):
        deletes = list(deletes)
        for d in deletes:
            # each valid key read, its bucket's key read and a tombstone
            # written (a delete's keys on one table are distinct)
            self.fixed["hash_delete"] += d.valid.shape[0] * d.valid.element_size()
            self._per("hash_delete", torch.count_nonzero(d.valid), d.keys.element_size() + 16)
        return self.saved["fused_delete"](tables, deletes)

    def totals(self) -> Dict[str, float]:
        out = dict(self.fixed)
        if self.counted:
            first = self.counted[0][1].device
            counts = torch.stack([c.to(first, torch.int64) for _, c, _ in self.counted])
            counts = counts.cpu().tolist()
            for (kernel, _, per), n in zip(self.counted, counts):
                out[kernel] = out.get(kernel, 0.0) + n * per
        return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _card(event: dict) -> int:
    """The card a device event ran on: its ``device`` argument, else the
    trace's process id, which the profiler sets to the device's index."""
    card = event.get("args", {}).get("device", event.get("pid", 0))
    return int(card) if str(card).isdigit() else 0


def read_profile(prof) -> dict:
    """Device busy time (also by card), kernels by name and the idle gaps of a finished
    ``torch.profiler.profile``, from its Chrome trace (written to the
    temporary directory and removed). The longest idle gaps are named by
    what the host was doing at their middle: the innermost harness span
    and the innermost operator or runtime call open there, and summed by
    name."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev, host = [], []
    kernel_s: Dict[str, float] = defaultdict(float)
    launches = 0
    by_card: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    card_launches: Dict[int, int] = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            kernel_s[e["name"]] += d * 1e-6
            launches += cat == "kernel"
            card = _card(e)
            by_card[card].append((s, s + d))
            card_launches[card] += cat == "kernel"
        elif cat in HOST_CATS:
            host.append((s, s + d, e["name"], cat))
    busy = _merge(dev)
    gaps = sorted(((a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]),
                  key=lambda g: g[0] - g[1])[:NAMED_GAPS]
    spans = [h for h in host if h[3] == "user_annotation"]
    ops = sorted(h for h in host if h[3] != "user_annotation")
    starts = [h[0] for h in ops]
    named: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [h for h in spans if h[0] <= mid <= h[1]]
        label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "no span"
        i = bisect.bisect_right(starts, mid)
        inner = [h for h in ops[max(0, i - 256):i] if h[1] >= mid]
        op = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "Python between ops"
        named[f"{label} / {op}"] += (e - s) * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "launches": launches,
        "kernel_s": dict(kernel_s),
        "device_ops": sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1])[:10],
        "card_busy_s": {c: sum(e - s for s, e in _merge(iv)) * 1e-6 for c, iv in by_card.items()},
        "card_launches": dict(card_launches),
    }
