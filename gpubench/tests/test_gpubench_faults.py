"""A run with the timed path broken underneath comes out not correct: the
control (the step's payload numbers in bfloat16, below the configurations'
float32) and each fault a cell can have. These drive the whole run but its
look for a card, on the CPU at a small size; ``python3 -m gpubench.control``
runs the same on the card at the cell's size."""

import json
from pathlib import Path

import pytest

from gpubench import control, run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, mix, name, seed):
    undo = control.install(name) if name else (lambda: None)
    try:
        return run.run(cell, seed, 0.3, False, device="cpu", mix_spec=mix(cell, 40, 16))
    finally:
        undo()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, mix):
    res = _run(cell, mix, None, 5)
    assert control.correct(res["checks"]), res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("name", sorted(control.CONTROLS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, name, mix):
    for seed in (1, 2, 3):
        res = _run(cell, mix, name, seed)
        assert not control.correct(res["checks"]), (name, seed, res["checks"])


def test_control_entry_restores_the_step():
    import zeebe_tpu_torch.tpu.drive as drive

    step = drive.step_kernel
    undo = control.install("half-batch")
    assert drive.step_kernel is not step
    undo()
    assert drive.step_kernel is step


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_the_tap_never_sees_is_not_correct(cell, mix, monkeypatch):
    """A drive that calls the step some other way than through
    ``tpu.drive.step_kernel`` leaves the tap empty: not correct."""
    import zeebe_tpu_torch.tpu.drive as drive
    from zeebe_tpu_torch.tpu import kernel

    def drive_round(graph, state, queue, now, batch_size, synthetic_workers=False,
                    partition_id=0):
        queue, batch = drive.dequeue(queue, batch_size)
        state, out, stats = kernel.step_kernel(graph, state, batch, now,
                                               synthetic_workers=synthetic_workers,
                                               partition_id=partition_id)
        queue = drive.enqueue(queue, out)
        stats = dict(stats)
        stats["overflow"] = stats["overflow"] | queue.overflow
        return state, queue, stats
    monkeypatch.setattr(drive, "drive_round", drive_round)
    res = _run(cell, mix, None, 4)
    assert not control.correct(res["checks"]), res["checks"]
    assert res["checks"]["tapped_rounds"][0] > 0 and res["checks"]["records"][1] == 0
