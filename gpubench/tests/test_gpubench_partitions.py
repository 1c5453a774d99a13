"""Configurations of several partitions: the reference ``Cluster`` (at one
partition, ``Partition`` itself), and whole runs of the sharded drive on
``[cpu] * P`` from a copy of the checkout whose ``BENCHMARK.json`` names
the test configurations under ``gpubench/tests/partitions/``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import control, generator, reference as ref, run, system

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent / "partitions"
MIXES = {"message-timer-4p": "publish-half-1m", "order-process-4p": "creates-1m"}


def _config(name, partitions):
    config = json.loads((HERE / f"{name}.json").read_text())
    config["partitions"] = partitions
    return config


def _mix(name, count, batch):
    spec = json.loads((ROOT / "gpubench" / "traffic" / f"{MIXES[name]}.json").read_text())
    spec["unit"][0]["count"], spec["batch_size"] = count, batch
    for how in spec["payload"].values():
        if "distinct_below" in how:
            how["distinct_below"] = 1 << 16
    return spec


def _root(tmp_path, name, partitions):
    """A checkout's copy whose BENCHMARK.json holds one cell of ``name`` at
    ``partitions`` partitions on one card."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = _config(name, partitions)
    cell = f"{name}.test"
    (tmp_path / "gpubench" / "configs").mkdir(parents=True)
    (tmp_path / "gpubench" / "configs" / f"{name}.json").write_text(json.dumps(config))
    bench["configs"] = [{"name": name, "source": config["source"],
                         "file": f"gpubench/configs/{name}.json", "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": cell, "config": name, "traffic": MIXES[name], "chips": 1,
                           "why": "test"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def _run(tmp_path, name, partitions, seed, count=1 << 10, batch=1 << 8):
    cell = _root(tmp_path, name, partitions)
    return run.run(cell, seed, 0.2, False, device="cpu", root=tmp_path,
                   mix_spec=_mix(name, count, batch))


def _drive_both(name, n, batch, seed):
    """One unit on ``Partition`` and on ``Cluster(partitions=1)``, every
    round captured whole: (totals, records, digests, counters) of each."""
    config = _config(name, 1)
    spec = _mix(name, n, batch)
    mix = generator.Mix(spec, config)
    enc = system.compile_config(config, "cpu")[2]
    sem = ref.Semantics(config["graph"], config.get("worker"))
    inp = mix.inputs(seed, 0, "cpu")
    host = {k: v.numpy() for k, v in inp.variables.items()}
    out = []
    for cluster in (False, True):
        part = ref.Cluster(sem, enc, n, 1) if cluster else ref.Partition(sem, enc, n)
        seen = []
        for i, phase in enumerate(mix.phases):
            at = mix.now(0)
            if phase["op"] == "create":
                part.create(host)
            elif phase["op"] == "publish":
                part.publish(inp.publish[i].numpy(), phase["variables"])
            else:
                at += phase["after_ms"]
                fire = part.tick(at)
                part.trigger(fire)
            plan = {((0, r) if cluster else r): (0, batch * 4) for r in range(1, 200)}
            totals, caps = part.drive(batch, at, plan)
            rows = part.state_rows(part.snapshot())
            seen.append((totals[0] if cluster else totals,
                         {r[-1] if cluster else r: part.records(v) for r, v in caps.items()},
                         {k: ref.digest(v) for k, v in (rows[0] if cluster else rows).items()}))
        counters = part.counters[0] if cluster else part.counters
        out.append((seen, counters))
    return out


@pytest.mark.parametrize("name", sorted(MIXES))
def test_cluster_of_one_is_partition(name):
    (plain, plain_c), (cl, cl_c) = _drive_both(name, 40, 9, 2**31 + 77)
    assert plain_c == cl_c
    for (t0, r0, d0), (t1, r1, d1) in zip(plain, cl):
        assert t0 == t1 and d0 == d1 and sorted(r0) == sorted(r1) and len(r0) > 0
        for r in r0:
            for f in r0[r]:
                assert np.array_equal(r0[r][f], r1[r][f]), (r, f)


@pytest.mark.parametrize("partitions", [2, 4])
@pytest.mark.parametrize("name", sorted(MIXES))
def test_partitioned_run_is_correct(tmp_path, name, partitions):
    """message-timer drives in lockstep with the exchange; order-process,
    with no message step, drives its partitions independently."""
    res = _run(tmp_path, name, partitions, 2**32 + 5)
    checks = res["checks"]
    assert control.correct(checks), checks
    assert res["failed"] == 0 and res["attempted"] > 0
    # each partition's tables are compared on their own, after every drive
    drives = len(_mix(name, 8, 8)["unit"])
    assert checks["state_tables"][1] % (drives * partitions * len(run.STATE_TABLES)) == 0


@pytest.mark.parametrize("name", sorted(control.CONTROLS) + sorted(control.EXCHANGE_CONTROLS))
def test_broken_drive_of_four_partitions_is_not_correct(tmp_path, name):
    undo = control.install(name)
    try:
        res = _run(tmp_path, "message-timer-4p", 4, 3, count=1 << 8, batch=1 << 6)
    finally:
        undo()
    assert not control.correct(res["checks"]), (name, res["checks"])


@pytest.mark.parametrize("partitions", [2, 4])
def test_share_of_subscriptions_off_their_instance(partitions):
    """oids hash to partitions independently of the round-robin CREATEs:
    about (P - 1) / P of the subscriptions open on another partition than
    their instance's; the harness routes each PUBLISH where the reference
    opens its subscription."""
    config = _config("message-timer-4p", partitions)
    n = 1 << 14
    mix = generator.Mix(_mix("message-timer-4p", n, n), config)
    enc = system.compile_config(config, "cpu")[2]
    cl = ref.Cluster(ref.Semantics(config["graph"]), enc, n, partitions)
    inp = mix.inputs(11, 0, "cpu")
    cl.create({k: v.numpy() for k, v in inp.variables.items()})
    off = np.mean(cl.values["part:msg"] != cl.values["part:inst"])
    assert abs(off - (partitions - 1) / partitions) < 0.05
    eng = system.ShardedEngine(config, 64, 64, ["cpu"] * partitions, False)
    corr = inp.variables["oid"][:4096]
    sent = eng.publishes("paid", corr, {"paid": True})
    for p, batch in enumerate(sent):
        got = batch.worker.view(torch.float32)
        want = corr[torch.from_numpy(cl.values["part:msg"][:4096] == p)]
        assert torch.equal(got, want)


@pytest.mark.parametrize("partitions", [1, 3])
def test_counted_records_match_the_replay(partitions):
    """``unit_kind_counts``, which the check uses for the units before a
    sampled one, gives what a replay of the unit processes."""
    config = _config("message-timer-4p", partitions)
    n, batch = 96, 17
    mix = generator.Mix(_mix("message-timer-4p", n, batch), config)
    enc = system.compile_config(config, "cpu")[2]
    sem = ref.Semantics(config["graph"])
    for unit in (0, 5):
        inp = mix.inputs(2**40 + 1, unit, "cpu")
        cl = ref.Cluster(sem, enc, n, partitions)
        for op, arg, at in run.unit_steps(mix, inp, unit):
            if op == "create":
                cl.create(arg)
            elif op == "publish":
                cl.publish(arg, {"paid": True})
            else:
                cl.trigger(cl.tick(at))
            cl.drive(batch, at)
        counted = ref.unit_kind_counts(sem, enc, n, partitions, run.unit_steps(mix, inp, unit))
        assert np.array_equal(counted, cl.kind_counts)
