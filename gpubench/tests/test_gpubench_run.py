"""The run as the driver sees it: the last line's schema, the refusal
without a card, and what a run loads."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "zeebe_tpu"}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_schema(cell, trace, mix):
    res = run.run(cell, 2**32 + 9, 0.3, trace, device="cpu", mix_spec=mix(cell, 32))
    line = run.result_line(res, 1, "cpu run", None)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell_e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cell_pl = {m["name"]: m for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)}
    wanted = cell_pl if trace else cell_e2e
    for name, m in line["metrics"].items():
        assert name in wanted and m["unit"] == wanted[name]["unit"]
        assert isinstance(m["value"], float)
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(cell_e2e)
    for name, c in line["checks"].items():
        assert c["value"] == 0 and c["limit"] == 0
    json.dumps(line)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_loads_no_jax():
    """Every module a small run loads, by its top-level name compared whole:
    ``zeebe_tpu_torch`` starts with ``zeebe_tpu`` and is allowed."""
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'gpubench/tests')\n"
        "from conftest import small_mix\n"
        "from gpubench import run, control\n"
        f"r = run.run({CELLS[-1]!r}, 3, 0.2, True, device='cpu',\n"
        f"            mix_spec=small_mix({CELLS[-1]!r}, 16))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "zeebe_tpu_torch" in tops and not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport gpubench.reference\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    tops = set(eval(res.stdout.strip()))
    assert not tops & (FORBIDDEN | {"zeebe_tpu_torch", "torch"}), tops


def test_imports_nothing_outside_its_paths():
    """No file of the benchmark imports the JAX package, JAX or the scripts
    beside it (``bench.py``, ``benchmarks/``, ``chip_smoke.py``)."""
    import ast

    banned = FORBIDDEN | {"bench", "benchmarks", "chip_smoke"}
    for path in (ROOT / "gpubench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


@pytest.mark.chip
def test_cell_on_the_card(card):
    """One short run of each cell on the card, correct, with its metrics."""
    for cell in CELLS:
        res = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", cell,
                              "--seed", "77", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        assert res.returncode == 0, res.stderr[-3000:]
        line = json.loads(res.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
