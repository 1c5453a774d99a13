"""The benchmark of ``zeebe_tpu_torch`` on the card.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process on the cell's card. It reads the cell from
``BENCHMARK.json``, its configuration from ``gpubench/configs/<config>.json``
and its traffic mix from ``gpubench/traffic/<mix>.json``; builds (or loads)
the engine's kernels, the graph, the state and the queue; runs one unit of
the mix as warm-up; then runs whole units until ``--seconds`` have passed
(``--trace 1``: profiles one lookup-rebuild period of units instead) and
prints one JSON line. The records, drive totals, state and tick output of
the window's units are compared with ``gpubench/reference.py`` once the
window has closed; a run on a machine without enough CUDA cards fails.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# rows of each round's output the tap copies, and units the reference replays
TAP_ROWS = 128
CHECKED_UNITS = 3
STATE_TABLES = ("ei", "job", "timer", "msub", "msg")
FORBIDDEN = ("jax", "jaxlib", "flax", "zeebe_tpu")


def cache_env(root: Path) -> None:
    """Every kernel cache at a fixed path inside the checkout, and no JAX
    loaded by a library on the port's behalf."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "gpubench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "gpubench" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(name: str, root: Path = ROOT):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name} in BENCHMARK.json")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return cell, config, end_to_end, per_layer


def load_reader(metric: str, root: Path = ROOT):
    path = root / "gpubench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class UnitRecord:
    """One unit's inputs and what the engine produced: per drive its totals
    and its tables' digests, the tick's (phase, count, row, copied rows),
    and the counters. Each is one partition's as it stands, or over several
    partitions a list with an entry a partition (``Runner._each`` reads
    both alike) and counters of [P, 3]."""

    unit: int
    inputs: object
    totals: list = dataclasses.field(default_factory=list)
    states: list = dataclasses.field(default_factory=list)
    tick: object = None
    scalars: object = None


def devices_for(config: dict, chips: int, device) -> list:
    """Partition p's device: card ``p % chips`` where the partitions are
    several and ``device`` names CUDA, else ``device`` itself."""
    import torch

    dev = torch.device(device)
    parts = int(config.get("partitions", 1))
    if parts == 1 or dev.type != "cuda":
        return [dev] * parts
    return [torch.device("cuda", p % chips) for p in range(parts)]


class Runner:
    """One cell's engine, mix and taps on the cell's devices."""

    def __init__(self, cell, config, seed: int, device, mix_spec: Optional[dict] = None):
        import torch

        from gpubench import generator, reference, system

        self.torch = torch
        self.seed = seed
        self.config = config
        self.mix = (generator.Mix(mix_spec, config) if mix_spec is not None
                    else generator.load(cell["traffic"], config))
        self.devices = devices_for(config, int(cell["chips"]), device)
        self.device = self.devices[0]
        self.parts = len(self.devices)
        if self.parts == 1:
            self.engine = system.Engine(config, self.mix.unit_size, self.mix.batch_size,
                                        self.device)
        else:
            self.engine = system.ShardedEngine(config, self.mix.unit_size, self.mix.batch_size,
                                               self.devices, self.mix.synthetic_workers)
        self.enc = self.engine.enc
        self.tap = system.RoundTap(min(TAP_ROWS, self.mix.batch_size), self.mix.batch_size, seed)
        self.sem = reference.Semantics(config["graph"], config.get("worker"))
        self.cuda = self.device.type == "cuda"
        self.rebuild_ms: List = []
        self.tick_ms: List = []

    def _timed(self, sink, fn, *args):
        if not self.cuda:
            return fn(*args)
        torch = self.torch
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        sink.append((a, b))
        return out

    def _each(self, x) -> list:
        """The engine's answer, one entry a partition."""
        return [x] if self.parts == 1 else x

    def unit(self, u: int) -> UnitRecord:
        from gpubench import system

        torch, eng, mix = self.torch, self.engine, self.mix
        inp = mix.inputs(self.seed, u, self.device)
        rec = UnitRecord(u, inp)
        now = mix.now(u)
        for i, phase in enumerate(mix.phases):
            at = now
            with torch.profiler.record_function(f"gpubench.{phase['op']}"):
                if phase["op"] == "create":
                    batch = eng.creates(inp.variables)
                elif phase["op"] == "publish":
                    corr = inp.variables[mix.correlation[phase["message"]]][inp.publish[i]]
                    batch = eng.publishes(phase["message"], corr, phase["variables"])
                else:
                    at = now + int(phase["after_ms"])
                    ticked = self._each(self._timed(self.tick_ms, eng.tick, at))
                    ticks = []
                    for tb, count in ticked:
                        # one partition: the instances no publish reached
                        due = (mix.unit_size - sum(len(p) for p in inp.publish.values())
                               if self.parts == 1 else int(count))
                        rows = min(TAP_ROWS, tb.size)
                        row = int(self.tap.rng.integers(0, max(1, due - rows + 1)))
                        ticks.append((i, count, row, system.copy_rows(tb, row, rows)))
                    if self.parts == 1:
                        rec.tick, batch = ticks[0], ticked[0][0]
                    else:
                        rec.tick, batch = ticks, [tb for tb, _ in ticked]
                self.tap.begin(u, i)
                with torch.profiler.record_function("tpu.drive.run_to_quiescence"):
                    rec.totals.append(eng.drive(batch, at, mix.synthetic_workers))
                self.tap.where = None
            rec.states.append(eng.state_digest(STATE_TABLES))
        rec.scalars = eng.scalars()
        if u % mix.rebuild_every == 0:
            with torch.profiler.record_function("gpubench.rebuild"):
                self._timed(self.rebuild_ms, eng.rebuild)
        return rec

    def sync(self):
        if self.cuda:
            for d in sorted({d.index for d in self.devices}):
                self.torch.cuda.synchronize(d)

    def peak(self) -> int:
        """The largest of the cards' peak allocations."""
        if not self.cuda:
            return 0
        return max(self.torch.cuda.max_memory_allocated(d) for d in set(self.devices))


def event_ms(pairs) -> List[float]:
    return [a.elapsed_time(b) for a, b in pairs]


def unit_steps(mix, inputs, unit: int) -> list:
    """A unit's inputs as ``reference.unit_kind_counts`` takes them (host
    arrays)."""
    now, steps = mix.now(unit), []
    for i, phase in enumerate(mix.phases):
        if phase["op"] == "create":
            steps.append(("create", {k: v.cpu().numpy() for k, v in inputs.variables.items()},
                          now))
        elif phase["op"] == "publish":
            steps.append(("publish", inputs.publish[i].cpu().numpy(), now))
        else:
            steps.append(("tick", None, now + int(phase["after_ms"])))
    return steps


def check_units(runner: Runner, records: List[UnitRecord], seed: int):
    """Replay a seeded sample of the window's units on the reference and
    compare, partition by partition; returns {name: (number, limit,
    detail)} and the failed count."""
    import numpy as np

    from gpubench import reference as ref
    from gpubench import system

    mix, enc, sem, parts = runner.mix, runner.enc, runner.sem, runner.parts
    rng = np.random.default_rng([seed, 11])
    pick = sorted(rng.choice(len(records), size=min(CHECKED_UNITS, len(records)),
                             replace=False).tolist())
    taken = {}
    for u, d, p, r, row, buf in runner.tap.taken:
        taken.setdefault(u, []).append((d, p, r, row, buf))
    # every check compares something: a tap that no round reached, or a
    # tick phase with no rows to compare, reads as not correct
    out = dict(records=[0, 0, None], tapped_rounds=[0, 0, None], drive_totals=[0, 0, None],
               state_tables=[0, 0, None], counters=[0, 0, None])
    if any(p["op"] == "tick" for p in mix.phases):
        out["tick_rows"] = [0, 0, None]
    unit_totals = None

    def note(name, bad, total, detail):
        out[name][0] += bad
        out[name][1] += total
        if bad and out[name][2] is None:
            out[name][2] = detail

    # the records each partition processed in each unit before the
    # sampled ones: one partition's are the same every unit (every unit
    # has the same sizes and nothing is routed); several partitions' follow
    # from each unit's inputs, drawn again from the seed
    counted: Dict[int, object] = {}

    def earlier(u):
        if parts == 1:
            return None
        for v in range(u):
            if v not in counted:
                inputs = mix.inputs(seed, v, runner.device)
                counted[v] = ref.unit_kind_counts(sem, enc, mix.unit_size, parts,
                                                  unit_steps(mix, inputs, v))
        return sum((counted[v] for v in range(u)), np.zeros((parts, len(sem.names)), np.int64))

    each = runner._each
    for idx in pick:
        rec = records[idx]
        u = rec.unit
        rec_totals = [each(t) for t in rec.totals]
        rec_tick = None if rec.tick is None else each(rec.tick)
        cl = ref.Cluster(sem, enc, mix.unit_size, parts)
        steps = unit_steps(mix, rec.inputs, u)
        raw, rests, ticks, totals = {}, [], None, []
        for i, (op, arg, at) in enumerate(steps):
            if op == "create":
                cl.create(arg)
            elif op == "publish":
                cl.publish(arg, mix.phases[i]["variables"])
            else:
                fires = cl.tick(at)
                ticks = [(fire, cl.trigger_rows(fire, t[2], t[3].shape[0]))
                         for fire, t in zip(fires, rec_tick)]
                cl.trigger(fires)
            plan = {(p, r): (row, buf.shape[0]) for d, p, r, row, buf in taken.get(u, [])
                    if d == i}
            t, caps = cl.drive(mix.batch_size, at, plan)
            totals.append(t)
            raw[i] = caps
            rests.append(cl.snapshot())
        this_unit = cl.kind_counts
        before = earlier(u)
        if before is None:
            before = u * this_unit
        else:
            again = ref.unit_kind_counts(sem, enc, mix.unit_size, parts, steps)
            note("counters", int(not np.array_equal(again, this_unit)), 1,
                 f"unit {u}: the reference's replay and its count of records disagree")
        cl.shift_keys(cl.draws(before))
        unit_totals = totals
        for i, (got, want) in enumerate(zip(rec_totals, totals)):
            for p, (g, w) in enumerate(zip(got, want)):
                g = {k: g[k] for k in w}
                note("drive_totals", int(g != w), 1,
                     f"unit {u} phase {i} partition {p}: got {g}, want {w}")
        for i, got in enumerate(rec_totals):
            for p, g in enumerate(got):
                tapped = sum(1 for d, q, *_rest in taken.get(u, []) if d == i and q == p)
                want = cl.read[i][p]
                note("tapped_rounds", int(tapped != want), 1,
                     f"unit {u} phase {i} partition {p}: the tap saw {tapped} of the "
                     f"reference's {want} rounds")
        for d, p, r, row, buf in taken.get(u, []):
            rows = raw[d].get((p, r))
            if rows is None:
                note("records", buf.shape[0], buf.shape[0],
                     f"unit {u} phase {d} partition {p}: the engine ran round {r}, "
                     f"the reference fewer")
                continue
            n, bad, first = ref.compare_records(system.split_rows(buf), cl.records(rows))
            note("records", bad, n,
                 f"unit {u} phase {d} partition {p} round {r} from row {row}: {first}")
        for i, (state, rest) in enumerate(zip(rec.states, rests)):
            for p, (got, want) in enumerate(zip(each(state), cl.state_rows(rest))):
                for name in STATE_TABLES:
                    count, dig = (int(x) for x in got[name])
                    w = (len(want[name]), ref.digest(want[name]))
                    note("state_tables", int((count, dig) != w), 1,
                         f"unit {u} phase {i} partition {p} table {name}: {count} rows, "
                         f"digest {dig}; want {w[0]} rows, digest {w[1]}")
        if rec_tick is not None:
            for p, ((i, count, row, buf), (fire, want)) in enumerate(zip(rec_tick, ticks)):
                note("tick_rows", int(int(count) != len(fire)), 1,
                     f"unit {u} partition {p}: tick count {int(count)}, want {len(fire)}")
                n, bad, first = ref.compare_records(system.split_rows(buf), cl.records(want))
                note("tick_rows", bad, n, f"unit {u} partition {p} tick from row {row}: {first}")
        acts = (before + this_unit)[:, sem.index["JOB_ACTIVATE"]] if "worker" in runner.config \
            else None
        for p, got in enumerate(rec.scalars.reshape(parts, -1).cpu().tolist()):
            got = [int(x) for x in got]
            c = cl.counters[p]
            want = [c["wf"], c["job"], got[2]]
            if acts is not None:
                want[2] = int(runner.config["worker"]["credits"]) - int(acts[p])
            note("counters", int(got != want), 1,
                 f"unit {u} partition {p}: counters {got}, want {want}")
    # every unit has the same sizes, so every unit's totals are the same:
    # one partition's as they stand; over several, where each unit's inputs
    # route records to other partitions and rounds, their sums over the
    # partitions, without the rounds
    failed = 0
    keys = ("processed", "emitted", "completed_roots") + (("rounds",) if parts == 1 else ())

    def summed(ts):
        return [{k: sum(t[k] for t in phase) for k in keys} for phase in ts]

    want = summed(unit_totals)
    for rec in records:
        rec_totals = [each(t) for t in rec.totals]
        done = sum(t["completed_roots"] for ts in rec_totals for t in ts)
        failed += mix.unit_size - done
        got = summed(rec_totals)
        note("drive_totals", int(got != want), 1, f"unit {rec.unit}: totals {got}, want {want}")
    return out, failed


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        root: Path = ROOT, mix_spec: Optional[dict] = None, log=None):
    """One run; returns the result line's object (``correct`` and the rest),
    with the numbers compared under ``checks``."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell, config, end_to_end, per_layer = load_cell(workload, root)
    import torch

    from gpubench import trace as tr

    import zeebe_tpu_torch.tpu.drive  # noqa: F401

    imported = time.perf_counter()
    runner = Runner(cell, config, seed, device, mix_spec)
    built = time.perf_counter()
    runner.unit(0)
    runner.sync()
    # what set-up made stays alive all run: out of the collector's way
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s: {config['name']} with units of {runner.mix.unit_size}; "
        f"imports {imported - T0:.3f} s, engine {built - imported:.3f} s, "
        f"warm unit {T0 + setup_s - built:.3f} s")
    records: List[UnitRecord] = []
    u = 1
    result: dict = {}
    if not trace:
        start = time.perf_counter()
        while True:
            records.append(runner.unit(u))
            u += 1
            runner.sync()
            window_s = time.perf_counter() - start
            if window_s >= seconds:
                break
        processed = sum(t["processed"] for r in records for ts in r.totals
                        for t in runner._each(ts))
        metrics = {"transitions_per_s": processed / window_s, "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()
                             if k in units}
        rounds = [max(t["rounds"] for t in runner._each(ts)) for r in records for ts in r.totals]
        log(f"window {window_s:.3f} s: {len(records)} units, {processed} records, "
            f"{sum(rounds)} drive rounds in {len(rounds)} drives")
    else:
        from torch.profiler import ProfilerActivity, profile

        # three passes over one lookup-rebuild period of units each: timed
        # on the host's clock with CUDA events around the rebuilds and
        # ticks; profiled; and with the kernels' bytes counted
        period = runner.mix.rebuild_every
        runner.rebuild_ms, runner.tick_ms = [], []
        start = time.perf_counter()
        plain = [runner.unit(u + i) for i in range(period)]
        runner.sync()
        plain_s = time.perf_counter() - start
        u += period
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if runner.cuda else [])
        with profile(activities=acts) as prof:
            start = time.perf_counter()
            traced = [runner.unit(u + i) for i in range(period)]
            runner.sync()
            window_s = time.perf_counter() - start
        u += period
        counter = tr.ByteCounter()
        counted = [runner.unit(u + i) for i in range(period)]
        counter.close()
        records = plain + traced + counted
        read = tr.read_profile(prof)

        def rounds(recs):
            return sum(max(x["rounds"] for x in runner._each(ts)) for r in recs for ts in r.totals)

        t = tr.Trace(
            rounds=rounds(traced), window_s=window_s, plain_rounds=rounds(plain),
            plain_s=plain_s, busy_s=read["busy_s"], launches=read["launches"],
            kernel_s=read["kernel_s"],
            bytes_moved=counter.totals(), rebuild_ms=event_ms(runner.rebuild_ms),
            tick_ms=event_ms(runner.tick_ms), device_ops=read["device_ops"],
            idle_gaps=read["idle_gaps"], card_busy_s=read["card_busy_s"],
            card_launches=read["card_launches"])
        result["metrics"] = {}
        for m in per_layer:
            value = load_reader(m["name"], root)(t)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
        # the device's busy seconds, averaged over the cell's cards
        chips = int(cell["chips"])
        busy = t.busy_s if chips == 1 else sum(t.card_busy_s.values()) / chips
        result["_trace"] = (busy, window_s)
        log(f"traced window {window_s:.3f} s: {period} units, {t.rounds} rounds, device busy "
            f"{t.busy_s:.6f} s, {t.launches} kernels; timed untraced units {plain_s:.3f} s")
    peak = runner.peak()
    runner.tap.close()
    engine = runner.engine
    runner.engine = None
    del engine
    begun = time.perf_counter()
    checks, failed = check_units(runner, records, seed)
    log(f"reference check {time.perf_counter() - begun:.3f} s")
    result["attempted"] = runner.mix.unit_size * len(records)
    result["failed"] = failed
    checks["instances_failed"] = [failed, result["attempted"], None]
    result["checks"] = checks
    result["peak"] = peak
    return result


def result_line(res: dict, chips: int, kind: str, card: Optional[str]) -> dict:
    """The one JSON object a run prints last: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (``breakdown`` when traced), and the
    numbers compared with their limits under ``checks``, last."""
    from gpubench.control import correct

    checks = res["checks"]
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(res["peak"])}
    if card:
        device["card"] = card
    if "_trace" in res:
        device["busy_s"], device["window_s"] = res["_trace"]
    out = {"correct": correct(checks), "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {name: {"value": bad, "limit": 0, "of": total}
                     for name, (bad, total, _detail) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    cell, _config, _e, _p = load_cell(args.workload)
    import torch

    chips = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    res = run(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"the run loaded {', '.join(loaded)}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    out = result_line(res, chips, torch.cuda.get_device_name(0), power_limit())
    for name, (bad, total, detail) in res["checks"].items():
        if bad and detail:
            print(f"{name}: {detail}", file=sys.stderr)
    for name, (bad, total, _detail) in res["checks"].items():
        print(f"{name}: {bad} of {total} differ, limit 0", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
