"""The drive's captured step (``zeebe_tpu_torch.tpu.capture``) on the CPU.

A CUDA graph is recorded and replayed only on the card. Here the dispatcher
runs eagerly on CPU tensors, and, with a fake capturer installed (``fake``:
CPU tensors taken for the card's, and a recording that runs the step body
on its static buffers at each replay and copies its outputs into the
recorded ones, as a graph writes the same buffers every time), the
dispatcher's own rules run whole: the signature, the wrapped-op and
recorder rules, the static batch and clock, the rebind after a lookup
rebuild, the write-back of the step's new scalars and the counts. Every
drive is held bit for bit to the eager step's.
"""

import pytest
import torch

import chip_smoke
from zeebe_tpu_torch.tpu import batch as rb
from zeebe_tpu_torch.tpu import capture, drive, kernel, ops
from zeebe_tpu_torch.tpu import state as ts
from zeebe_tpu_torch.tracing import device as device_spans

WAVE = 32


class FakeGraph:
    """``capture.record`` on the CPU. The recording runs the body once on an
    all-invalid batch for its output buffers and puts back every state
    tensor it wrote (a capture runs nothing); a replay runs the body and
    copies what it returns into those buffers."""

    def __init__(self, launched=None):
        self.recorded, self.replays = [], 0
        self.launched = launched or {}

    def __call__(self, body, device):
        for f in rb.FIELDS:
            getattr(body.batch, f).zero_()
        leaves = capture._leaves(body.state)
        kept = [t.clone() for t in leaves]
        out, stats = body()
        for t, k in zip(leaves, kept):
            t.copy_(k)
        self.recorded.append(body)

        def replay():
            self.replays += 1
            o, s = body()
            for f in rb.FIELDS:
                getattr(out, f).copy_(getattr(o, f))
            for k in stats:
                stats[k].copy_(s[k])

        return replay, (out, stats), dict(self.launched)


@pytest.fixture(autouse=True)
def _released():
    capture.release()
    device_spans.install(None)
    yield
    capture.release()
    device_spans.install(None)
    ops.reset_launches()  # later tests in the process count from 0


@pytest.fixture
def fake(monkeypatch):
    rec = FakeGraph()
    monkeypatch.setattr(capture, "record", rec)
    monkeypatch.setattr(capture, "_on_card", lambda batch: True)
    return rec


def _tapped(monkeypatch):
    """Every step's output batch, copied, in the drive's order."""
    seen = []
    step = drive.step_kernel

    def tapped(*args, **kwargs):
        state, out, stats = step(*args, **kwargs)
        seen.append({f: getattr(out, f).clone() for f in rb.FIELDS})
        return state, out, stats

    monkeypatch.setattr(drive, "step_kernel", tapped)
    return seen


def _order_process():
    """Config 1: two waves, a lookup rebuild after the first."""
    state, totals, _s = chip_smoke.drive_config(2, WAVE, "cpu")
    return state, totals


def _message_timer():
    """Config 4: two waves of CREATE, PUBLISH for half and the tick 31 s
    later (the clock 100 s on a wave), a lookup rebuild after the first."""
    state, totals, _s = chip_smoke.c4_drive(2, WAVE, "cpu")
    return state, totals


DRIVES = {"order-process": _order_process, "message-timer": _message_timer}


def _run(name, monkeypatch, step=None):
    if step is not None:
        monkeypatch.setattr(drive, "step_kernel", step)
    seen = _tapped(monkeypatch)
    state, totals = DRIVES[name]()
    monkeypatch.undo()
    return ts.state_to_numpy(state), totals, seen


def _assert_same(a, b):
    (state_a, totals_a, seen_a), (state_b, totals_b, seen_b) = a, b
    assert totals_a == totals_b
    assert len(seen_a) == len(seen_b) == totals_a["rounds"]
    for r, (x, y) in enumerate(zip(seen_a, seen_b)):
        for f in rb.FIELDS:
            assert torch.equal(x[f], y[f]), (r, f)
    for name in state_a:
        assert (state_a[name] == state_b[name]).all(), name


def test_cpu_tensors_step_eagerly():
    _state, totals = _order_process()
    assert capture.counts() == {"captures": 0, "replays": 0, "rebinds": 0,
                                "eager": {"cpu": totals["rounds"], "wrapped_op": 0,
                                          "recorder": 0, "signature": 0}}
    assert drive.CAPTURE is capture.CAPTURE


@pytest.mark.parametrize("graph", sorted(DRIVES))
def test_now_as_a_device_scalar_steps_as_the_int(graph, monkeypatch):
    """The clock a graph reads (an int64 scalar) gives the int's records
    and tables, over drives at several clocks with a rebuild between."""

    def scalar_now(g, state, batch, now, **kw):
        return kernel.step_kernel(g, state, batch, torch.tensor(now, dtype=torch.int64), **kw)

    _assert_same(_run(graph, monkeypatch), _run(graph, monkeypatch, scalar_now))


@pytest.mark.parametrize("graph", sorted(DRIVES))
def test_replayed_drive_is_the_eager_drive(graph, monkeypatch, fake):
    want = _run(graph, monkeypatch, kernel.step_kernel)
    monkeypatch.setattr(capture, "record", fake)
    monkeypatch.setattr(capture, "_on_card", lambda batch: True)
    got = _run(graph, monkeypatch)
    _assert_same(got, want)
    rounds = want[1]["rounds"]
    # one capture, after the signature's first (eager) step; one rebind,
    # the rebuild's tables copied into the held ones
    assert capture.counts() == {"captures": 1, "replays": rounds - 1, "rebinds": 1,
                                "eager": {"cpu": 0, "wrapped_op": 0, "recorder": 0,
                                          "signature": 1}}
    assert fake.replays == rounds - 1 and len(fake.recorded) == 1


def _config1():
    graph, state, queue, creates = chip_smoke.config_setup(WAVE, "cpu")
    return graph, state, creates


def _step(graph, state, creates, **kw):
    return drive.step_kernel(graph, state, creates, 5, synthetic_workers=True, **kw)


def test_one_graph_a_signature(fake):
    graph, state, creates = _config1()
    _g, other, _c = _config1()
    half = rb.RecordBatch(**{f: getattr(creates, f)[: WAVE // 2].clone() for f in rb.FIELDS})
    for _ in range(2):
        state, _o, _s = _step(graph, state, creates)
    assert (capture.CAPTURE["captures"], capture.CAPTURE["replays"]) == (1, 1)
    for args, kw in (((graph, state, half), {}),               # batch size
                     ((graph, state, creates), {"partition_id": 1}),
                     ((graph, other, creates), {})):           # another state
        capture.step(*args, 0, synthetic_workers=True, **kw)
    assert capture.CAPTURE["captures"] == 4
    assert capture.CAPTURE["eager"]["signature"] == 4
    state, _o, _s = _step(graph, state, creates)
    assert capture.CAPTURE["replays"] == 2 and len(capture._graphs) == 4


def test_the_least_recently_replayed_graph_goes_first(fake, monkeypatch):
    monkeypatch.setattr(capture, "MAX_GRAPHS", 1)
    graph, state, creates = _config1()
    _g, other, _c = _config1()
    _step(graph, state, creates)
    _step(graph, other, creates)
    assert len(capture._graphs) == 1
    _step(graph, state, creates)   # dropped: eager and captured again
    assert capture.CAPTURE["eager"]["signature"] == 3


def test_two_states_of_one_shape_keep_their_own_tables(fake, monkeypatch):
    graph, a, creates = _config1()
    _g, b, _c = _config1()
    want_a, want_b = ts.state_to_numpy(a), ts.state_to_numpy(b)
    for _ in range(3):
        a, _o, _s = _step(graph, a, creates)
        b, _o, _s = _step(graph, b, creates)
    got_a, got_b = ts.state_to_numpy(a), ts.state_to_numpy(b)
    capture.release()
    monkeypatch.undo()
    ea, eb = ts.state_from_numpy(want_a, "cpu"), ts.state_from_numpy(want_b, "cpu")
    for _ in range(3):
        ea, _o, _s = _step(graph, ea, creates)
        eb, _o, _s = _step(graph, eb, creates)
    for got, want in ((got_a, ts.state_to_numpy(ea)), (got_b, ts.state_to_numpy(eb))):
        for name in want:
            assert (got[name] == want[name]).all(), name


def test_a_swapped_entry_point_steps_eagerly_through_it(fake, monkeypatch):
    graph, state, creates = _config1()
    state, _o, _s = _step(graph, state, creates)
    calls = []
    real = ops.fused_gather_rows

    def counted(tables, gather_ops):
        calls.append(1)
        return real(tables, gather_ops)

    monkeypatch.setattr(ops, "fused_gather_rows", counted)
    held = capture._graphs[next(iter(capture._graphs))]
    new, _o, _s = _step(graph, state, creates)
    assert calls and new is held.body.state and fake.replays == 0
    assert capture.CAPTURE["eager"]["wrapped_op"] == 1
    monkeypatch.setattr(ops, "fused_gather_rows", real)
    _step(graph, new, creates)
    assert fake.replays == 1 and capture.CAPTURE["rebinds"] == 0


def test_a_wrapped_op_is_never_captured(fake, monkeypatch):
    graph, state, creates = _config1()
    monkeypatch.setattr(ops, "insert", lambda *a: ops.insert_reference(*a))
    _step(graph, state, creates)
    assert capture.CAPTURE["captures"] == 0 and fake.recorded == []


def test_the_recorder_steps_eagerly(fake):
    graph, state, creates = _config1()
    state, _o, _s = _step(graph, state, creates)
    with device_spans.recording() as tracer:
        _step(graph, state, creates)
    assert capture.CAPTURE["eager"]["recorder"] == 1 and fake.replays == 0
    assert tracer.summary()["spans"]["step"]["count"] == 1


def test_a_rebuilt_state_is_copied_into_the_held_tables(fake):
    graph, state, creates = _config1()
    state, _o, _s = _step(graph, state, creates)
    held = capture._graphs[next(iter(capture._graphs))]
    rebuilt = ts.rebuild_lookup_state(state)
    want = ts.state_to_numpy(rebuilt)
    moved = [n for n in ts.STATE_FIELDS if getattr(rebuilt, n) is not getattr(state, n)]
    assert "ei_index" in moved and "free_ei" in moved and "ei_map" in moved
    capture._rebind(held, rebuilt)
    got = ts.state_to_numpy(held.body.state)
    for name in want:
        assert (got[name] == want[name]).all(), name
    capture._rebind(held, held.body.state)
    capture._rebind(held, rebuilt)   # the same memory's values, copied again
    assert capture.CAPTURE["rebinds"] == 2


def test_a_replay_credits_its_captures_launches(monkeypatch):
    rec = FakeGraph(launched={"lookup": (1, 1), "fused_table_commit": (3, 7)})
    monkeypatch.setattr(capture, "record", rec)
    monkeypatch.setattr(capture, "_on_card", lambda batch: True)
    graph, state, creates = _config1()
    ops.reset_launches()
    for _ in range(3):
        state, _o, _s = _step(graph, state, creates)
    assert ops.LAUNCHES["lookup"] == 2 and ops.LAUNCHES["fused_table_commit"] == 6
    assert ops.DEVICE_LAUNCHES["fused_table_commit"] == 14


def test_launch_counts_put_back_and_credited():
    ops.reset_launches()
    before = ops.launch_counts()
    ops.LAUNCHES["insert"] += 2
    ops.DEVICE_LAUNCHES["insert"] += 2
    ops.set_launch_counts(before)
    assert ops.launch_counts() == before
    ops.credit({"insert": (1, 1), "delete": (2, 3)})
    assert (ops.LAUNCHES["insert"], ops.DEVICE_LAUNCHES["delete"]) == (1, 3)
    ops.reset_launches()


def test_a_private_scratch_claims_apart_from_the_devices():
    dev = torch.device("cpu")
    ops._claims.pop(dev, None)
    shared, first = ops._claim_scratch(dev, 64, 5)
    own = ops.PrivateScratch()
    with ops.private_scratch(own):
        mine, mine_first = ops._claim_scratch(dev, 32, 3)
        work = ops._worklist_scratch(dev, 16)
        assert ops._scratch() == (own.claims, own.worklists)
    assert (first, mine_first) == (1, 1) and mine is not shared
    assert own.claims[dev][1] == 3 and own.worklists[dev] is work
    assert ops._claims[dev][1] == 5 and ops._claim_scratch(dev, 64, 1)[1] == 6
    ops._claims.pop(dev, None)


def test_a_wrapped_step_is_never_replayed(fake, monkeypatch):
    graph, state, creates = _config1()
    state, _o, _s = _step(graph, state, creates)
    calls = []
    real = kernel.step_kernel
    monkeypatch.setattr(kernel, "step_kernel", lambda *a, **k: calls.append(1) or real(*a, **k))
    _step(graph, state, creates)
    assert calls == [1] and fake.replays == 0
    assert capture.CAPTURE["eager"]["wrapped_op"] == 1


def test_chip_smokes_capture_phase_on_the_cpu(fake, monkeypatch):
    """chip_smoke's phase 11 (captured against eager, bit for bit, with
    exact counts) at small sizes on the CPU, with the fake capturer."""
    import json
    import os

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    rows = chip_smoke.capture_configs(wave=WAVE, device="cpu")
    assert sorted(rows) == ["config1", "config2", "config3", "config4", "config5"]
    mesh = chip_smoke.capture_mesh(wave=WAVE, devs=[torch.device("cpu")] * 2)
    assert mesh["capture"]["captures"] == 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mixes = {}
    for cell, mix, var in (("order-process-1p.burst-1m", "creates-1m", "orderId"),
                           ("message-timer-1p.burst-1m", "publish-half-1m", "oid")):
        with open(os.path.join(root, "gpubench", "traffic", mix + ".json")) as f:
            spec = json.load(f)
        spec["unit"][0]["count"] = spec["batch_size"] = WAVE
        spec["payload"][var]["distinct_below"] = 1 << 16
        mixes[cell] = spec
    cells = chip_smoke.capture_cells(device="cpu", mixes=mixes)
    assert all(row["capture"]["rebinds"] == 1 for row in cells.values())
