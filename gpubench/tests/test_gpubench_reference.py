"""The plain reference against the port, on CPU tensors, for both graphs:
every record a round emits, the drive totals, the tables once a drive has
drained and the key counters, with batches of the unit's size and smaller
(so rounds mix the records of many instances)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import generator, reference as ref, system

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("order-process-1p", "message-timer-1p")
MIXES = {"order-process-1p": "creates-1m", "message-timer-1p": "publish-half-1m"}


def _drive_units(config_name, n, batch, units, seed):
    config = json.loads((ROOT / f"gpubench/configs/{config_name}.json").read_text())
    spec = json.loads((ROOT / f"gpubench/traffic/{MIXES[config_name]}.json").read_text())
    spec["unit"][0]["count"], spec["batch_size"] = n, batch
    spec["payload"] = {k: ({"distinct_below": 1 << 16} if "distinct_below" in v else v)
                       for k, v in spec["payload"].items()}
    mix = generator.Mix(spec, config)
    eng = system.Engine(config, n, batch, "cpu")
    tap = system.RoundTap(rows=min(16, batch), batch_size=batch, seed=seed)
    sem = ref.Semantics(config["graph"], config.get("worker"))
    bad = []
    try:
        for u in range(units):
            inp = mix.inputs(seed, u, "cpu")
            part = ref.Partition(sem, eng.enc, n)
            now = mix.now(u)
            states, rests, all_caps = [], [], {}
            for i, phase in enumerate(mix.phases):
                at = now
                if phase["op"] == "create":
                    batch_in = eng.creates(inp.variables)
                    part.create({k: v.numpy() for k, v in inp.variables.items()})
                elif phase["op"] == "publish":
                    corr = inp.variables[mix.correlation[phase["message"]]][inp.publish[i]]
                    batch_in = eng.publishes(phase["message"], corr, phase["variables"])
                    part.publish(inp.publish[i].numpy(), phase["variables"])
                else:
                    at = now + phase["after_ms"]
                    batch_in, count = eng.tick(at)
                    fire = part.tick(at)
                    assert int(count) == len(fire)
                    got = system.split_rows(system.copy_rows(batch_in, 0, 8))
                    want_tick = part.trigger_rows(fire, 0, 8)
                    part.trigger(fire)
                tap.begin(u, i)
                got_t = eng.drive(batch_in, at, mix.synthetic_workers)
                plan = {r: (row, tap.rows) for uu, d, _p, r, row, _ in tap.taken
                        if uu == u and d == i}
                want_t, all_caps[i] = part.drive(batch, at, plan)
                assert {k: got_t[k] for k in want_t} == want_t
                states.append(eng.state_digest(("ei", "job", "timer", "msub", "msg")))
                rests.append(part.snapshot())
                if phase["op"] == "tick":
                    tick_pair = (got, want_tick)
            part.shift_keys(u * (part.counters["wf"] - ref.WF_KEY0),
                            u * (part.counters["job"] - ref.JOB_KEY0))
            for uu, d, _p, r, row, buf in tap.taken:
                if uu == u:
                    _n, n_bad, first = ref.compare_records(system.split_rows(buf),
                                                           part.records(all_caps[d][r]))
                    if n_bad:
                        bad.append((u, d, r, first))
            for state, rest in zip(states, rests):
                want = part.state_rows(rest)
                for name, (count, dig) in state.items():
                    if (int(count), int(dig)) != (len(want[name]), ref.digest(want[name])):
                        bad.append((u, name))
            if "tick" in [p["op"] for p in mix.phases]:
                n_rows, n_bad, first = ref.compare_records(tick_pair[0],
                                                           part.records(tick_pair[1]))
                assert n_bad == 0, first
            assert [int(x) for x in eng.scalars()[:2]] == [part.counters["wf"],
                                                           part.counters["job"]]
            eng.rebuild()
    finally:
        tap.close()
    return bad


@pytest.mark.parametrize("config_name", CONFIGS)
@pytest.mark.parametrize("n,batch", [(24, 24), (24, 7)])
def test_reference_matches_port(config_name, n, batch):
    assert _drive_units(config_name, n, batch, units=2, seed=2**33 + 5) == []


@pytest.mark.parametrize("config_name", CONFIGS)
def test_records_match_port(config_name, mix):
    from gpubench import run

    cell = next(w for w, c in (("order-process-1p.burst-1m", "order-process-1p"),
                               ("message-timer-1p.burst-1m", "message-timer-1p"))
                if c == config_name)
    res = run.run(cell, 99, 0.5, False, device="cpu", mix_spec=mix(cell, 32, 11))
    checks = res["checks"]
    assert checks["records"][1] > 0 and checks["state_tables"][1] > 0
    assert {k: v[0] for k, v in checks.items()} == dict.fromkeys(checks, 0), checks


def test_digest_matches_device_form():
    rng = np.random.default_rng(3)
    rows = rng.integers(-2**40, 2**40, size=(50, 9))
    live = rng.random(50) < 0.6
    got = system._digest(torch.from_numpy(rows), torch.from_numpy(live))
    assert int(got) == ref.digest(rows[live])
