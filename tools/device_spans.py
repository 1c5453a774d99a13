"""The device-path spans (``zeebe_tpu_torch.tracing.device``) of one
benchmark cell, on the card.

    python3 -m tools.device_spans --workload <cell> --seed <n> [--dump trace.json]

Builds the cell's engine and traffic as ``gpubench.run`` does and runs its
warm unit, then lookup-rebuild periods of units: untraced and with the
recorder installed, in turns (plain, spanned, plain, spanned), and last one
under ``torch.profiler`` (the device's busy time a round, and the idle
gaps named by the innermost span open on the host, as a ``--trace 1`` run's
``breakdown`` names them; last, so that the profiler's set-up and teardown
stay out of the other periods). Prints one JSON line: the recorder's readings a round over both
spanned periods, how far the card ran behind the host where each span
ended, the checks that tie them to each other and to the
harness's own CUDA events around the ticks and rebuilds, what the
recorder costs (the spanned periods' wall time a round against the
untraced ones'), the profiled period's host time a round in the drive's
spans, and ``tpu.capture``'s counts over each kind of period.
The untraced and the profiled periods replay the drive's step from a CUDA
graph; with the recorder installed it runs eagerly (``eager.recorder``),
so the spanned periods read the eager step's phases, and their cost
against the untraced ones is the recorder's and the eager step's
together. ``--dump`` writes the spanned periods as Chrome-trace JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("lookups", "routing", "compute", "keys", "emit", "commit", "compact")


def per_round(summary: dict) -> dict:
    """The recorder's summary a ``drive.round``: the host time of the round's
    launching and of its sync, the step's host time, each phase's device
    interval (None on the CPU), and the host µs of a csrc wrapper call."""
    spans, rounds = summary["spans"], summary["rounds"]

    def of(name, clock):
        s = spans.get(name)
        if not rounds or s is None or s[clock] is None:
            return None
        return s[clock] / rounds

    out = {"drive.launch_ms": of("drive.launch", "host_ms"),
           "drive.sync_wait_ms": of("drive.sync", "host_ms"),
           "step.host_ms": of("step", "host_ms")}
    for p in PHASES:
        out[f"step.{p}_ms"] = of(f"step.{p}", "device_ms")
    calls = summary["ops"]["calls"]
    out["ops.host_us_per_launch"] = summary["ops"]["host_ns"] / calls / 1e3 if calls else None
    return out


def _host_split(prof, rounds: int) -> dict:
    """The host ms a round of the drive's spans in a finished profile (each
    span a ``record_function`` there: its host duration; the profile's
    device-side copy of an annotation is left out)."""
    from torch.autograd import DeviceType

    totals: dict = {}
    for e in prof.key_averages():
        if e.key in ("drive.round", "drive.launch", "drive.sync", "step") and (
                e.device_type == DeviceType.CPU):
            totals[e.key] = totals.get(e.key, 0.0) + e.cpu_time_total
    return {k + "_ms": v / 1e3 / rounds for k, v in totals.items()} if rounds else {}


def _add(into: dict, before: dict, after: dict) -> None:
    """Add ``after`` less ``before`` (two ``tpu.capture.counts()``) to ``into``,
    the eager steps flattened to ``eager.<reason>``."""
    for k, v in after.items():
        if isinstance(v, dict):
            for reason, n in v.items():
                key = f"eager.{reason}"
                into[key] = into.get(key, 0) + n - before[k][reason]
        else:
            into[k] = into.get(k, 0) + v - before[k]


def _share(a: Optional[float], b: Optional[float]) -> Optional[float]:
    """How far ``a`` lies from ``b``, in percent of ``b``."""
    if a is None or not b:
        return None
    return 100.0 * (a - b) / b


def measure(workload: str, seed: int, device: str = "cuda", mix_spec: Optional[dict] = None,
            dump: Optional[str] = None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpubench import run as bench
    from gpubench import trace as bench_trace
    from zeebe_tpu_torch.tpu import capture
    from zeebe_tpu_torch.tracing import device as device_spans

    cell, config, _e2e, _layers = bench.load_cell(workload, ROOT)
    runner = bench.Runner(cell, config, seed, device, mix_spec)
    runner.unit(0)
    runner.sync()
    period, u = runner.mix.rebuild_every, 1

    # what tpu.capture counted over each kind of period
    captured = {"plain": {}, "spanned": {}, "profiled": {}}

    def units(n, kind):
        nonlocal u
        before = capture.counts()
        start = time.perf_counter()
        recs = [runner.unit(u + i) for i in range(n)]
        runner.sync()
        u += n
        seconds = time.perf_counter() - start
        _add(captured[kind], before, capture.counts())
        return sum(t["rounds"] for r in recs for t in r.totals), seconds

    tracer = device_spans.DeviceTracer(runner.device if runner.cuda else None)
    plain, spanned = [0, 0.0], [0, 0.0]
    ticks, rebuilds = [], []  # the harness's CUDA events around the spanned calls
    for _turn in range(2):
        for sink, on, kind in ((plain, None, "plain"), (spanned, tracer, "spanned")):
            runner.rebuild_ms, runner.tick_ms = [], []
            device_spans.install(on)
            rounds, seconds = units(period, kind)
            device_spans.install(None)
            sink[0] += rounds
            sink[1] += seconds
            if on is not None:
                ticks += runner.tick_ms
                rebuilds += runner.rebuild_ms
    summary = tracer.summary()
    busy, gaps, profiled_split = None, [], {}
    if runner.cuda:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_rounds, _s = units(period, "profiled")
        read = bench_trace.read_profile(prof)
        busy, gaps = read["busy_s"] * 1e3 / traced_rounds, read["idle_gaps"]
        profiled_split = _host_split(prof, traced_rounds)
    if dump:
        tracer.dump(dump)
    metrics = per_round(summary)
    spans, rounds = summary["spans"], summary["rounds"]
    round_ms = spans["drive.round"]["host_ms"] / rounds
    step_device = spans["step"]["device_ms"]
    phases = [metrics[f"step.{p}_ms"] for p in PHASES]
    phases_host = sum(spans[f"step.{p}"]["host_ms"] for p in PHASES) / rounds

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    def span_ms(name):
        s = spans.get(name)
        return s["device_ms"] / s["count"] if s and s["device_ms"] is not None else None

    tick_ms, rebuild_ms = mean(bench.event_ms(ticks)), mean(bench.event_ms(rebuilds))
    checks = {
        "rounds": [rounds, spanned[0]],
        "launch_and_sync_vs_round_pct": _share(
            metrics["drive.launch_ms"] + metrics["drive.sync_wait_ms"], round_ms),
        "phases_vs_step_pct": (_share(sum(phases), step_device / rounds)
                               if step_device is not None else None),
        "tick_span_vs_events_pct": _share(span_ms("tick"), tick_ms),
        "rebuild_span_vs_events_pct": _share(span_ms("rebuild"), rebuild_ms),
        "dropped": summary["dropped"],
    }
    return {
        "workload": workload, "seed": seed,
        "card": torch.cuda.get_device_name(runner.device) if runner.cuda else None,
        "power_limit": bench.power_limit() if runner.cuda else None,
        "metrics": metrics,
        "round_span_ms": round_ms,
        "step_device_ms": step_device / rounds if step_device is not None else None,
        # after the last phase: the step frame's teardown, on either clock
        "step_own_ms": [metrics["step.host_ms"] - phases_host,
                        step_device / rounds - sum(phases) if step_device is not None else None],
        "plain_round_ms": plain[1] * 1e3 / plain[0],
        "spanned_round_ms": spanned[1] * 1e3 / spanned[0],
        "on_cost_pct": _share(spanned[1] / spanned[0], plain[1] / plain[0]),
        "profiled_busy_ms_per_round": busy,
        # the profiled period's host time a round in the drive's spans: a
        # replayed round's launching, its sync wait and its step
        "profiled_host_ms_per_round": profiled_split,
        "idle_gaps": gaps,
        # how far the card ran behind the host where each span ended
        "lag_ms": {name: s["lag_ms"] for name, s in spans.items()},
        "tick_ms": [span_ms("tick"), tick_ms],
        "rebuild_ms": [span_ms("rebuild"), rebuild_ms],
        "checks": checks,
        # the drive's steps replayed from a CUDA graph, and those run eagerly
        # by reason, over the untraced, the spanned and the profiled periods;
        # and the process's counts, the warm unit's capture included
        "capture": {**captured, "replayed_share_plain_pct": (
            100.0 * captured["plain"].get("replays", 0) / plain[0] if plain[0] else None),
            "process": summary["capture"]},
        "summary": summary,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--dump", help="write the spanned periods as Chrome-trace JSON here")
    args = ap.parse_args(argv)
    from gpubench import run as bench

    bench.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the device-path spans are measured on a CUDA card; this machine has none",
              file=sys.stderr)
        return 2
    print(json.dumps(measure(args.workload, args.seed, dump=args.dump)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
