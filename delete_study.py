#!/usr/bin/env python3
"""The hash delete's design measurements on the CUDA card (PERF.md §6).

On chip_smoke.py's phase-2 delete case (its data, its seed): the delete's
device time as it is and with every key whose plain walk is longer than
16 / 8 / 4 / 2 buckets made invalid (how much the longest chain costs);
on L2-warm and cold absent keys and with no valid key; the probe
benchmark's two kernels; and config 3's delete launches one by one in a
profiled full-width wave, each beside its valid keys. ``--sweep`` also
rebuilds ``csrc/hash_update.cu`` with each given ZB_DELETE_GROUP under
``build/`` and repeats the delete cases and the wave for each, bit-equal
to the plain version first.

    python3 delete_study.py                      # this checkout's package
    python3 delete_study.py --sweep 4,8,16,32    # + each group width
    python3 delete_study.py --package DIR        # another checkout's package
                                                 #   (an older commit, for an A/B)

Prints one ``STUDY {...}`` JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys


def walk_lengths(table, keys, valid):
    """Buckets the plain delete reads for each valid key (0 for invalid)."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap

    t = table.keys.shape[0]
    h0 = hashmap._hash(keys, t).to(torch.int64)
    length = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    done = ~valid
    for j in range(hashmap.MAX_PROBES):
        k = table.keys[(h0 + j) & (t - 1)]
        stop = ~done & ((k == keys) | (k == hashmap.EMPTY))
        length = torch.where(stop, j + 1, length)
        done = done | stop
    return torch.where(done, length, hashmap.MAX_PROBES)


def drive_launches(cs):
    """Config 3's delete launches in one profiled wave (after a warm one):
    (valid keys, device µs) per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeebe_tpu_torch.tpu import drive, ops, state as state_mod

    entry = "fused_delete" if hasattr(ops, "fused_delete") else "delete"
    real, valid_keys = getattr(ops, entry), []

    def counted(*args):  # (tables, deletes) or, in an older package, (table, keys, valid)
        flags = [op.valid for op in args[1]] if entry == "fused_delete" else [args[2]]
        valid_keys.append(sum(int(v.sum()) for v in flags))
        return real(*args)

    graph, state, queue, creates = cs.config_setup(cs.WAVE, "cuda", cs.config3_model)
    queue = drive.enqueue(queue, creates)
    state, queue, _t = drive.run_to_quiescence(graph, state, queue, 0, cs.WAVE,
                                               synthetic_workers=True)
    state = state_mod.rebuild_lookup_state(state)
    torch.cuda.synchronize()
    setattr(ops, entry, counted)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            queue = drive.enqueue(queue, creates)
            drive.run_to_quiescence(graph, state, queue, 0, cs.WAVE, synthetic_workers=True)
            torch.cuda.synchronize()
    finally:
        setattr(ops, entry, real)
    us = [getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
          for e in prof.events()
          if "hash_delete" in e.name and e.device_type != torch.autograd.DeviceType.CPU]
    if len(us) != len(valid_keys):
        raise AssertionError(f"{len(us)} delete kernels profiled for {len(valid_keys)} calls")
    empty = [t for v, t in zip(valid_keys, us) if v == 0]
    return {"launches": len(us), "mean_us": sum(us) / len(us),
            "empty_mean_us": sum(empty) / max(len(empty), 1),
            "dense": [(v, t) for v, t in zip(valid_keys, us) if v > 0]}


def delete_cases(cs):
    """chip_smoke's delete data, and its wrap-around, run-out and fused
    cases where that chip_smoke.py has them."""
    import torch

    gen = torch.Generator().manual_seed(1234 + 5)  # check_delete's generator
    b = cs.WAVE
    base, pre, absent = cs._join_map("cuda", gen, b)
    pick = torch.randperm(pre.shape[0], generator=gen)[: b // 2].to("cuda")
    keys = torch.cat([pre[pick], absent[: b - b // 2]])
    valid = (torch.rand((b,), generator=gen) < 0.9).to("cuda")
    extra = []
    if hasattr(cs, "_fused_cases"):
        from zeebe_tpu_torch.tpu import ops

        extra = [("wrap", *cs._wrap_case("cuda")), ("run_out", *cs._run_out_case("cuda"))]
        extra = [(label, [t], [ops.DeleteOp(0, k, v)]) for label, t, k, v in extra]
        extra += cs._fused_cases("cuda", gen, (base, pre, absent))
    return base, keys, valid, absent[:b].contiguous(), extra


def measure(cs):
    """Every delete number of one package (or of one rebuilt group width)."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    base, keys, valid, absent, extra = delete_cases(cs)
    out = {}
    length = walk_lengths(base, keys, valid)
    lv = length[valid].double()
    out["walk"] = {"mean": float(lv.mean()), "p99": float(lv.quantile(0.99)),
                   "max": int(lv.max())}
    for cut in (None, 16, 8, 4, 2):
        v = valid if cut is None else valid & (length <= cut)
        out[f"delete_us_cut{cut}"] = cs.device_us_calls(
            [lambda c=c, v=v: ops.delete(c, keys, v) for c in cs._copies(base, 101)])
    everything = torch.ones(absent.shape, dtype=torch.bool, device="cuda")
    nothing = torch.zeros_like(valid)
    out["absent_warm_us"] = cs.device_us_calls(
        [lambda: ops.delete(base, absent, everything)] * 101)
    out["absent_cold_us"] = cs.device_us_calls(
        [lambda c=c: ops.delete(c, absent, everything) for c in cs._copies(base, 101)])
    out["none_valid_us"] = cs.device_us_calls([lambda: ops.delete(base, keys, nothing)] * 101)
    equal = True
    for label, tables, deletes in extra:
        got = [cs._copies(t, 1)[0] for t in tables]
        ops.fused_delete(got, deletes)
        want = [cs._copies(t, 1)[0] for t in tables]
        for op in deletes:
            want[op.table] = hashmap.delete(want[op.table], op.keys, op.valid)
        equal = equal and all(torch.equal(g.keys, w.keys) for g, w in zip(got, want))
        if label.startswith("fused"):
            sets = list(zip(*[cs._copies(t, 101) for t in tables]))
            out[label + "_us"] = cs.device_us_calls(
                [lambda c=c, d=deletes: ops.fused_delete(list(c), d) for c in sets])
            del sets
    got = ops.delete(cs._copies(base, 1)[0], keys, valid)
    out["bit_equal"] = equal and bool(torch.equal(got.keys, hashmap.delete(base, keys,
                                                                          valid).keys))
    out["config3_delete"] = drive_launches(cs)
    return out


def probe_times(cs):
    """The probe benchmark's two kernels at chip_smoke's phase-2 shapes."""
    import torch

    from zeebe_tpu_torch import probe

    gen = torch.Generator().manual_seed(1234 + 6)  # check_row_loop's generator
    b, cap, k = probe.B, probe.CAP, probe.K
    tbl = torch.randint(-2**31, 2**31 - 1, (cap, k), generator=gen,
                        dtype=torch.int64).to(torch.int32).to("cuda")
    idx = torch.randint(0, cap, (b,), generator=gen, dtype=torch.int32).to("cuda")
    rows = torch.randint(-2**31, 2**31 - 1, (b, k), generator=gen,
                         dtype=torch.int64).to(torch.int32).to("cuda")
    (_, _sk, _st), (_, keys, tkeys) = cs._probe_cases(
        "cuda", torch.Generator().manual_seed(1234 + 7))  # check_probe's
    return {
        "row_loop_us": cs.device_us_calls([lambda: probe.row_loop(tbl, idx, rows, 1)] * 101),
        "row_loop_host_us": cs.host_us(lambda: probe.row_loop(tbl, idx, rows, 1)),
        "probe_us": cs.device_us_calls([lambda: probe.probe(keys, tkeys)] * 101),
        "probe_host_us": cs.host_us(lambda: probe.probe(keys, tkeys)),
        "probe_bit_equal": bool(torch.equal(probe.probe(keys, tkeys),
                                            probe.probe_reference(keys, tkeys))),
    }


def build_group(root, g):
    """hash_update.cu with ZB_DELETE_GROUP = g, built under build/ and
    loaded: its zb_hash_delete, typed as the package's wrapper calls it."""
    from zeebe_tpu_torch import _build
    from zeebe_tpu_torch.tpu import ops

    csrc = os.path.join(root, "zeebe_tpu_torch", "csrc")
    work = os.path.join(root, "build", "delete_study")
    os.makedirs(work, exist_ok=True)
    src = open(os.path.join(csrc, "hash_update.cu")).read()
    cu = os.path.join(work, f"hash_update_g{g}.cu")
    with open(cu, "w") as f:
        f.write(re.sub(r"^#define ZB_DELETE_GROUP \d+$", f"#define ZB_DELETE_GROUP {g}",
                       src, flags=re.M))
    so = os.path.join(work, f"hash_update_g{g}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).zb_hash_delete
    fn.argtypes = [ctypes.POINTER(ops._DeleteArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose zeebe_tpu_torch and chip_smoke.py to measure")
    ap.add_argument("--sweep", default="", help="group widths to rebuild and measure, e.g. 4,8")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("delete_study: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from zeebe_tpu_torch.tpu import ops

    report = {"card": cs.smi_line(), "package": ops.__file__, **measure(cs),
              **probe_times(cs)}
    if args.sweep:
        real = ops._delete_fn
        try:
            for g in (int(x) for x in args.sweep.split(",")):
                fn = build_group(root, g)
                ops._delete_fn = lambda fn=fn: fn
                report[f"G{g}"] = measure(cs)
        finally:
            ops._delete_fn = real
    print("STUDY " + json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
