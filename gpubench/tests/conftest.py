"""Settings of the benchmark's tests: ``python -m pytest gpubench/tests -q``
runs them on the CPU at small sizes; those marked ``chip`` need a CUDA card
and skip without one (``python -m pytest gpubench/tests -m chip`` on the
card)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def small_mix(cell: str, count: int = 48, batch: int = None) -> dict:
    """The cell's traffic mix at ``count`` instances a unit (batch ``batch``,
    the unit by default), with distinct values drawn below 2^16."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = next(w["traffic"] for w in bench["workloads"] if w["name"] == cell)
    spec = json.loads((ROOT / "gpubench" / "traffic" / f"{traffic}.json").read_text())
    spec["unit"][0]["count"] = count
    spec["batch_size"] = batch or count
    for how in spec["payload"].values():
        if "distinct_below" in how:
            how["distinct_below"] = 1 << 16
    return spec


@pytest.fixture
def mix():
    return small_mix
