"""The device-path recorder (``zeebe_tpu_torch.tracing.device``) on the CPU.

Off, a drive records nothing and reads no clock; on, it changes nothing the
drive computes, and its spans nest drive.run ⊃ drive.round ⊃ {drive.launch ⊃
step ⊃ the seven phases, drive.sync}, each under its drive and round. The
ops wrappers' host nanoseconds move only while a recorder is installed
(their CUDA paths run on CPU tensors that ``ops._device_index`` reports on a
card, as in ``test_torch_device_guard``). On the CPU the spans carry host
times and no device times.
"""

import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from tests.test_torch_device_guard import _calls, rig  # noqa: F401 - the fixture
from zeebe_tpu_torch.tpu import batch as rb
from zeebe_tpu_torch.tpu import drive, ops, state as ts
from zeebe_tpu_torch.tracing import device as device_spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE = 32
PHASES = ["step.lookups", "step.routing", "step.compute", "step.keys", "step.emit",
          "step.commit", "step.compact"]
SPANS = ["drive.run", "drive.round", "drive.launch", "drive.sync", "step", "rebuild"] + PHASES


def _order_process():
    """Config 1 (order-process): two waves, a lookup rebuild after the first."""
    state, totals, _s = chip_smoke.drive_config(2, WAVE, "cpu")
    return state, totals


def _message_timer():
    """Config 4 (message wait with a timer boundary): two waves of CREATE,
    PUBLISH for half, and the tick that fires the rest."""
    state, totals, _s = chip_smoke.c4_drive(2, WAVE, "cpu")
    return state, totals


DRIVES = {"order-process": _order_process, "message-timer": _message_timer}


@pytest.fixture(autouse=True)
def _off():
    device_spans.install(None)
    yield
    device_spans.install(None)


def _emissions(monkeypatch):
    """Every step's output batch, copied, in the order the drive ran them."""
    seen = []
    step = drive.step_kernel

    def tapped(*args, **kwargs):
        state, out, stats = step(*args, **kwargs)
        seen.append({f: getattr(out, f).clone() for f in rb.FIELDS})
        return state, out, stats

    monkeypatch.setattr(drive, "step_kernel", tapped)
    return seen


def _spans(tracer):
    keys = ("name", "parent", "drive", "round", "thread", "h0", "e0", "h1", "e1")
    return [dict(zip(keys, rec)) for rec in tracer._spans]


def test_the_sites_read_the_autograd_profilers_flag():
    """The span sites read this flag to know that the profiler records."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True


def test_off_a_drive_records_nothing_and_reads_no_clock(monkeypatch):
    reads = []
    clock = time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns", lambda: reads.append(1) or clock())
    tracer = device_spans.DeviceTracer()
    _order_process()
    assert reads == [] and tracer._spans == [] and device_spans._stack() == []


@pytest.mark.parametrize("graph", sorted(DRIVES))
def test_on_the_drives_compute_what_they_compute_off(graph, monkeypatch):
    seen_off = _emissions(monkeypatch)
    state_off, totals_off = DRIVES[graph]()
    monkeypatch.undo()
    seen_on = _emissions(monkeypatch)
    with device_spans.recording() as tracer:
        state_on, totals_on = DRIVES[graph]()
    assert totals_on == totals_off
    assert len(seen_on) == len(seen_off) == totals_off["rounds"]
    for a, b in zip(seen_on, seen_off):
        for f in rb.FIELDS:
            assert torch.equal(a[f], b[f]), f
    want, got = ts.state_to_numpy(state_off), ts.state_to_numpy(state_on)
    for name in want:
        assert (got[name] == want[name]).all(), name
    summary = tracer.summary()
    assert summary["rounds"] == totals_off["rounds"] and summary["dropped"] == 0
    assert summary["device"] is None
    for s in summary["spans"].values():
        assert s["device_ms"] is None and s["lag_ms"] is None and s["host_ms"] > 0
    if graph == "message-timer":
        assert summary["spans"]["tick"]["count"] == 2


def test_spans_nest_and_share_their_round():
    with device_spans.recording() as tracer:
        _state, totals = _order_process()
    spans = _spans(tracer)
    assert {s["name"] for s in spans} == set(SPANS)
    runs = [i for i, s in enumerate(spans) if s["name"] == "drive.run"]
    rounds = [i for i, s in enumerate(spans) if s["name"] == "drive.round"]
    assert len(runs) == 2 and len(rounds) == totals["rounds"]
    assert [spans[i]["drive"] for i in runs] == [0, 1]
    for i in rounds:
        r = spans[i]
        run = spans[r["parent"]]
        assert run["name"] == "drive.run" and r["drive"] == run["drive"]
        kids = [j for j, s in enumerate(spans) if s["parent"] == i]
        assert [spans[j]["name"] for j in kids] == ["drive.launch", "drive.sync"]
        steps = [j for j, s in enumerate(spans) if s["parent"] == kids[0]]
        assert [spans[j]["name"] for j in steps] == ["step"]
        phases = [s for s in spans if s["parent"] == steps[0]]
        assert [s["name"] for s in phases] == PHASES
        for s in [spans[j] for j in kids + steps] + phases:
            assert (s["drive"], s["round"]) == (r["drive"], r["round"])
        # children share their parent's boundaries, and each other's
        assert spans[kids[0]]["h0"] == r["h0"] and spans[kids[1]]["h1"] == r["h1"]
        assert spans[kids[0]]["h1"] == spans[kids[1]]["h0"]
        step = spans[steps[0]]
        assert phases[0]["h0"] == step["h0"] and phases[-1]["h1"] <= step["h1"]
        assert all(a["h1"] == b["h0"] for a, b in zip(phases, phases[1:]))
    for d in (0, 1):
        numbers = [spans[i]["round"] for i in rounds if spans[i]["drive"] == d]
        assert numbers == list(range(len(numbers)))
    summary = tracer.summary()
    host = {k: v["host_ms"] for k, v in summary["spans"].items()}
    assert host["drive.launch"] + host["drive.sync"] == pytest.approx(host["drive.round"])
    # the phases end before the step's frame is torn down
    assert sum(host[p] for p in PHASES) < host["step"]


def test_the_profiler_sees_the_spans_with_the_recorder_off():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _order_process()
    names = {e.name for e in prof.events()}
    assert set(SPANS) <= names
    assert device_spans.TRACER is None and device_spans._stack() == []


OPS_WRAPPERS = [w for w in sorted(_calls()) if w not in ("probe", "row_loop")]


@pytest.mark.parametrize("wrapper", OPS_WRAPPERS)
def test_the_ops_host_ns_move_only_while_recording(rig, wrapper):  # noqa: F811
    _entry, call, _inputs = _calls()[wrapper]
    ops.reset_launches()
    call()
    assert sum(ops.LAUNCHES.values()) == 1 and sum(ops.HOST_NS.values()) == 0
    with device_spans.recording() as tracer:
        call()
    spent = sum(ops.HOST_NS.values())
    assert sum(ops.LAUNCHES.values()) == 2 and spent > 0
    call()  # after the recorder: counted, not timed
    assert sum(ops.LAUNCHES.values()) == 3 and sum(ops.HOST_NS.values()) == spent
    got = tracer.summary()["ops"]
    assert got["calls"] == 1 and got["host_ns"] == spent
    assert [v[0] for v in got["by_wrapper"].values()] == [1]


def test_the_off_wrappers_read_no_clock(rig, monkeypatch):  # noqa: F811
    reads = []
    clock = time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns", lambda: reads.append(1) or clock())
    for wrapper, (_entry, call, _inputs) in _calls().items():
        call()
    assert reads == []


def test_dump_writes_a_chrome_trace(tmp_path):
    with device_spans.recording() as tracer:
        _order_process()
    path = tmp_path / "spans.json"
    tracer.dump(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    slices = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in slices} == set(SPANS)
    assert all(e["pid"] == 1 and e["dur"] >= 0 for e in slices)  # host only on the CPU
    rounds = [e for e in slices if e["name"] == "drive.round"]
    assert [e["args"]["round"] for e in rounds if e["args"]["drive"] == 0] == list(
        range(sum(1 for e in rounds if e["args"]["drive"] == 0)))


def test_a_raising_call_closes_what_it_held_open():
    inner = device_spans.traced("outer")(lambda: (device_spans.begin("step", "step.lookups"),
                                                   1 / 0))
    with device_spans.recording() as tracer:
        with pytest.raises(ZeroDivisionError):
            inner()
        assert device_spans._stack() == []
    spans = _spans(tracer)
    assert [s["name"] for s in spans] == ["outer", "step", "step.lookups"]
    assert all(s["h1"] is not None for s in spans)


def test_spans_beyond_the_bound_are_counted(monkeypatch):
    monkeypatch.setattr(device_spans, "MAX_SPANS", 5)
    with device_spans.recording() as tracer:
        _state, totals = _order_process()
    summary = tracer.summary()
    assert sum(s["count"] for s in summary["spans"].values()) == 5
    assert summary["dropped"] > 0 and summary["rounds"] < totals["rounds"]


def test_the_tool_reads_a_cell_on_the_cpu():
    """``tools/device_spans.py`` on a small order-process mix: the host
    readings a round, no device ones (no card), every round spanned."""
    from tools import device_spans as tool

    with open(os.path.join(ROOT, "gpubench", "traffic", "creates-1m.json")) as f:
        spec = json.load(f)
    spec["unit"][0]["count"] = spec["batch_size"] = WAVE
    spec["payload"]["orderId"]["distinct_below"] = 1 << 16
    got = tool.measure("order-process-1p.burst-1m", 2**33 + 3, device="cpu", mix_spec=spec)
    m = got["metrics"]
    assert m["drive.launch_ms"] > 0 and m["drive.sync_wait_ms"] > 0 and m["step.host_ms"] > 0
    assert all(m[f"step.{p}_ms"] is None for p in tool.PHASES)
    assert m["ops.host_us_per_launch"] is None
    assert got["checks"]["rounds"][0] == got["checks"]["rounds"][1] > 0
    assert got["checks"]["launch_and_sync_vs_round_pct"] == pytest.approx(0, abs=1e-6)
    # off the card every drive step runs eagerly, and the tool says so
    assert got["capture"]["spanned"]["eager.cpu"] == got["checks"]["rounds"][0]
    assert got["capture"]["replayed_share_plain_pct"] == 0


def test_a_span_open_across_an_install_closes_on_its_own_recorder():
    first = device_spans.install(device_spans.DeviceTracer())
    sp = device_spans.begin("step", "step.lookups")
    second = device_spans.install(device_spans.DeviceTracer())
    device_spans.phase("step.routing")
    device_spans.end(sp)
    device_spans.install(None)
    assert {k: v["count"] for k, v in first.summary()["spans"].items()} == {
        "step": 1, "step.lookups": 1}
    assert {k: v["count"] for k, v in second.summary()["spans"].items()} == {"step.routing": 1}
    assert device_spans._stack() == []
