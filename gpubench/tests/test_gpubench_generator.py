"""The traffic generator: the same seed gives the same inputs, another seed
others, every number exact in float32, every unit the same sizes."""

import json
from pathlib import Path

import pytest
import torch

from gpubench import generator

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _mix(cell, small):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    config = json.loads((ROOT / f"gpubench/configs/{w['config']}.json").read_text())
    return generator.Mix(small(cell, 64), config)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_deterministic_in_seed(cell, mix):
    m = _mix(cell, mix)
    seed = 2**31 + 12345
    a, b, c = m.inputs(seed, 3, "cpu"), m.inputs(seed, 3, "cpu"), m.inputs(seed + 1, 3, "cpu")
    for name in a.variables:
        assert torch.equal(a.variables[name], b.variables[name])
        assert not torch.equal(a.variables[name], c.variables[name])
    for i in a.publish:
        assert torch.equal(a.publish[i], b.publish[i])
    other_unit = m.inputs(seed, 4, "cpu")
    assert any(not torch.equal(a.variables[n], other_unit.variables[n]) for n in a.variables)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_values_and_sizes(cell, mix):
    m = _mix(cell, mix)
    for seed in (0, 7, 2**40 + 3):
        inp = m.inputs(seed, 1, "cpu")
        for name, vals in inp.variables.items():
            assert vals.dtype == torch.float32 and vals.shape == (m.unit_size,)
            assert torch.equal(vals, vals.round()) and bool((vals < 2**24).all())
            if "distinct_below" in m.payload[name]:
                assert torch.unique(vals).numel() == m.unit_size
        for i, order in inp.publish.items():
            share = m.phases[i]["share"]
            assert order.numel() == round(share * m.unit_size)
            assert torch.unique(order).numel() == order.numel()


def test_full_mixes_read():
    for w in BENCH["workloads"]:
        config = json.loads((ROOT / f"gpubench/configs/{w['config']}.json").read_text())
        m = generator.load(w["traffic"], config)
        assert m.batch_size == m.unit_size
        assert m.phases[0]["op"] == "create"
