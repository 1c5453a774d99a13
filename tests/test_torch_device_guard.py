"""Every kernel wrapper launches on its tensors' card, on that card's stream.

A C entry launches on the runtime's current device, and the stream it is
handed must belong to the card whose memory its pointers name. So each
wrapper of ``tpu/ops.py`` and ``probe.py`` finds the one CUDA device all
of its tensors lie on (tensors on two cards, or on the CPU and a card,
raise), makes that device current for the launch (``ops._device_guard``)
and passes that device's current stream (``ops._stream(device)``). Here
the C entry points are replaced by recorders, the wrappers' CUDA paths run
on CPU tensors that ``ops._device_index`` reports on a card (the descriptors
hold plain pointers), and the guard is a recorder too: each launch must
happen inside the guard of its tensors' card, with that card's stream.
"""

import contextlib

import pytest
import torch

from zeebe_tpu_torch import probe
from zeebe_tpu_torch.tpu import hashmap, ops

CARD = torch.device("cuda", 1)
OTHER = torch.device("cuda", 0)


def _stream_of(device):
    return 1000 + device.index


@pytest.fixture
def rig(monkeypatch):
    """Recorders for the C entries, the guard and the stream; tensors
    report ``CARD`` unless ``rig.tags`` names another device for them."""
    state = type("Rig", (), {})()
    state.current = []  # the guard's stack of current devices
    state.launches = []  # (entry, stream, current device at the launch)
    state.tags = {}

    def record(entry, stream, ret=1):
        state.launches.append((entry, stream, state.current[-1] if state.current else None))
        return ret

    @contextlib.contextmanager
    def guard(device):
        state.current.append(device)
        try:
            yield
        finally:
            state.current.pop()

    monkeypatch.setattr(ops, "_device_index", lambda t: state.tags.get(id(t), CARD).index
                        if state.tags.get(id(t), CARD).type == "cuda" else -1)
    monkeypatch.setattr(ops, "_device_guard", guard)
    monkeypatch.setattr(ops, "_stream", _stream_of)
    monkeypatch.setattr(ops, "_gather_fn",
                        lambda: lambda args, stream: record("gather", stream))
    monkeypatch.setattr(ops, "_commit_fn",
                        lambda: lambda descs, n, stream: record("commit", stream))
    monkeypatch.setattr(ops, "_lookup_fn",
                        lambda: lambda args, stream: record("lookup", stream))
    monkeypatch.setattr(
        ops, "_accum_fn",
        lambda: lambda call: record("accumulate", ops._ACCUM_HEAD.unpack_from(call)[0]))
    monkeypatch.setattr(ops, "_insert_fn",
                        lambda: lambda args, stream: record("insert", stream))
    monkeypatch.setattr(ops, "_delete_fn",
                        lambda: lambda args, stream: record("delete", stream))
    monkeypatch.setattr(probe, "_row_loop_fn",
                        lambda: lambda *a: record("row_loop", a[-1]))
    monkeypatch.setattr(probe, "_entry",
                        lambda name, types: lambda *a: record("probe", a[-1], 0))
    monkeypatch.setattr(ops, "_claims", {})
    monkeypatch.setattr(ops, "_worklists", {})
    return state


def _calls():
    """(C entry, wrapper call, its input tensors) for every wrapper."""
    g = torch.Generator().manual_seed(7)
    b, t, k = 16, 64, 4
    slots = torch.randint(0, t, (b,), generator=g, dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool)
    rows = torch.randint(0, 9, (b, k), generator=g, dtype=torch.int32)
    vals = rows[:, 0].contiguous()
    table = torch.zeros((t, k), dtype=torch.int32)
    lane = torch.zeros(t, dtype=torch.int32)
    wide = torch.zeros(t, dtype=torch.int64)
    hmap = hashmap.make(128, device="cpu")
    keys = torch.arange(b, dtype=torch.int64) + 5
    probe_table = torch.full((64,), -1, dtype=torch.int32)
    pair = [ops.TableOp(0, "max", slots, active, rows), ops.TableOp(1, "add", slots, active, vals)]
    return {
        "fused_gather_rows": ("gather", lambda: ops.fused_gather_rows(
            [table, lane], [ops.GatherOp(0, slots), ops.GatherOp(1, slots)]),
            [table, lane, slots]),
        "fused_table_commit": ("commit", lambda: ops.fused_table_commit(
            [table, lane], [ops.TableOp(0, "set", slots, active, rows),
                            ops.TableOp(1, "add", slots, active, vals)]),
            [table, lane, slots, active, rows, vals]),
        "lookup": ("lookup", lambda: ops.lookup(hmap, keys, active),
                   [hmap.keys, hmap.vals, keys, active]),
        "fused_lookup": ("lookup", lambda: ops.fused_lookup(
            [hmap], [ops.LookupOp(0, keys, active), ops.LookupOp(0, keys, active)]),
            [hmap.keys, hmap.vals, keys, active]),
        "masked_row_update": ("commit", lambda: ops.masked_row_update(
            table, slots, active, rows), [table, slots, active, rows]),
        "masked_row_max": ("accumulate", lambda: ops.masked_row_max(
            table, slots, active, rows), [table, slots, active, rows]),
        "masked_row_add": ("accumulate", lambda: ops.masked_row_add(
            table, slots, active, rows), [table, slots, active, rows]),
        "masked_lane_update": ("commit", lambda: ops.masked_lane_update(
            lane, slots, active, vals), [lane, slots, active, vals]),
        "masked_lane_accum": ("accumulate", lambda: ops.masked_lane_accum(
            lane, slots, active, vals), [lane, slots, active, vals]),
        "masked_vec64_update": ("commit", lambda: ops.masked_vec64_update(
            wide, slots, active, keys), [wide, slots, active, keys]),
        "fused_accumulate": ("accumulate", lambda: ops.fused_accumulate(
            [table, lane], pair), [table, lane, slots, active, rows, vals]),
        "insert": ("insert", lambda: ops.insert(hmap, keys, keys.to(torch.int32), active),
                   [hmap.keys, hmap.vals, keys, active]),
        "delete": ("delete", lambda: ops.delete(hmap, keys, active),
                   [hmap.keys, hmap.vals, keys, active]),
        "fused_delete": ("delete", lambda: ops.fused_delete(
            [hmap], [ops.DeleteOp(0, keys, active)]), [hmap.keys, hmap.vals, keys, active]),
        "row_loop": ("row_loop", lambda: probe.row_loop(table, slots, rows, 2),
                     [table, slots, rows]),
        "probe": ("probe", lambda: probe.probe(slots, probe_table), [slots, probe_table]),
    }


WRAPPERS = sorted(_calls())


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_the_wrapper_launches_on_its_tensors_card_and_stream(rig, wrapper):
    entry, call, _inputs = _calls()[wrapper]
    call()
    assert rig.launches == [(entry, _stream_of(CARD), CARD)]
    assert rig.current == []  # the guard is left after the launch


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_tensors_on_two_cards_raise(rig, wrapper):
    _entry, call, inputs = _calls()[wrapper]
    rig.tags[id(inputs[1])] = OTHER
    with pytest.raises(ValueError, match="mixed or unsupported devices"):
        call()
    assert rig.launches == []


@pytest.mark.parametrize("wrapper", ["fused_gather_rows", "fused_table_commit", "insert",
                                     "fused_accumulate", "probe"])
def test_a_card_and_the_cpu_raise(rig, wrapper):
    _entry, call, inputs = _calls()[wrapper]
    rig.tags[id(inputs[0])] = torch.device("cpu")
    with pytest.raises(ValueError, match="mixed or unsupported devices"):
        call()
    assert rig.launches == []


def test_the_cpu_takes_the_plain_versions(monkeypatch):
    """Without the tags every tensor here lies on the CPU: no C entry runs."""
    monkeypatch.setattr(ops, "_gather_fn", lambda: 1 / 0)
    monkeypatch.setattr(ops, "_commit_fn", lambda: 1 / 0)
    for wrapper in WRAPPERS:
        _calls()[wrapper][1]()


def test_the_guard_and_the_stream_name_the_device(monkeypatch):
    guard = ops._device_guard(torch.device("cuda", 3))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 3
    asked = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: asked.append(index) or 77, raising=False)
    assert ops._stream(torch.device("cuda", 2)) == 77 and asked == [2]


def test_the_selfcheck_runs_once_per_card(monkeypatch):
    checked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ops, "_selfcheck_on", checked.append)
    monkeypatch.setattr(ops, "_SELFCHECKED", set())
    for device in (CARD, CARD, OTHER, "cuda:1", torch.device("cpu")):
        ops.selfcheck(device)
    assert checked == [CARD, OTHER]
    assert ops._SELFCHECKED == {0, 1}
