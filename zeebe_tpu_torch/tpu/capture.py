"""The drive's step, replayed as a CUDA graph.

``tpu.drive`` steps through ``step`` here (its module global
``step_kernel``), which takes and returns what ``kernel.step_kernel`` does.
On the card the first call for a signature runs the step eagerly (kernels
built, caches allocated) and then records it once as a CUDA graph, on a
side stream into a private memory pool: every csrc kernel and every
PyTorch op the step launches, in the same order, on static buffers (the
state's tables, a batch, the clock as an int64 device scalar). Every later
call with that signature copies its batch in (one copy a field), fills the
clock and replays the graph: one launch for the 1,413-2,391 the eager step
issues from Python (PERF.md, section 5). The tables are updated in place as
before; a scalar the step returns anew (a key counter, a free-ring cursor,
the credits) is copied back, inside the graph, into the tensor it read, so
the state a replay returns is the static one, and the next call finds it.

The signature: the card, the graph object, the batch size,
``synthetic_workers``, ``partition_id``, the state (its element-instance
table: two states of one shape are two graphs) and the shapes and dtypes
of the state's and the batch's tensors. A call runs eagerly, and counts
why in ``CAPTURE["eager"]``:

- ``cpu``: CPU tensors;
- ``recorder``: the device-path recorder is installed; a replay has no
  boundaries between the step's phases to record its events at;
- ``wrapped_op``: an ``ops`` entry point of ``ENTRY_POINTS``, or
  ``kernel.step_kernel``, is not the one its module defined, which is the
  one every graph recorded (a test double, a counter such as the
  benchmark's byte counter): a replay would bypass it;
- ``signature``: the first call for a signature, before its capture.

A state whose tensors are not the held ones but have their shapes and
dtypes (``state.rebuild_lookup_state``'s new indexes, maps and free rings)
is copied into them (``CAPTURE["rebinds"]``), not captured again; an eager
call on a held state writes back into it the same way. A replay credits
``ops.LAUNCHES`` and ``ops.DEVICE_LAUNCHES`` with what its capture
launched.

Only the drive replays. Everything there that reads a round's outputs (the
enqueue, the totals, a tap) is enqueued before the next replay overwrites
them, on the same stream. The served engine and the mesh's gathered and
routed steps call ``kernel.step_kernel`` and stay eager: the engine hands
emissions on across frames. A graph is replayed by one thread at a time.

The csrc kernels' claim epochs: a replay reuses its capture's, so the
recorded launches claim in a scratch of their own (``ops.PrivateScratch``),
zeroed by each replay before its first claim.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, List, Tuple

import torch

from zeebe_tpu_torch.tpu import batch as rb
from zeebe_tpu_torch.tpu import kernel, ops
from zeebe_tpu_torch.tpu.batch import RecordBatch
from zeebe_tpu_torch.tpu.graph import DeviceGraph
from zeebe_tpu_torch.tpu.hashmap import HashTable
from zeebe_tpu_torch.tpu.state import STATE_FIELDS, EngineState
from zeebe_tpu_torch.tracing import device as device_spans

__all__ = ["CAPTURE", "ENTRY_POINTS", "counts", "record", "release", "step"]

# why a call ran eagerly
REASONS = ("cpu", "wrapped_op", "recorder", "signature")
# the process's captures, replays, rebinds and eager calls by reason
CAPTURE: dict = {"captures": 0, "replays": 0, "rebinds": 0, "eager": dict.fromkeys(REASONS, 0)}
# the ops entry points the step calls
ENTRY_POINTS = (
    "fused_gather_rows", "fused_table_commit", "fused_lookup", "lookup", "fused_accumulate",
    "masked_row_update", "masked_lane_update", "masked_vec64_update", "insert", "fused_delete",
)
_DEFINED = tuple(getattr(ops, name) for name in ENTRY_POINTS) + (kernel.step_kernel,)
# graphs held at once, the least recently replayed dropped first
MAX_GRAPHS = 8

_lock = threading.Lock()
_graphs: "collections.OrderedDict[tuple, _Held]" = collections.OrderedDict()


def _note(kind: str, reason: str = "") -> None:
    with _lock:
        if reason:
            CAPTURE["eager"][reason] += 1
        else:
            CAPTURE[kind] += 1


def counts() -> dict:
    """A copy of ``CAPTURE``."""
    with _lock:
        return {**CAPTURE, "eager": dict(CAPTURE["eager"])}


def release() -> None:
    """Drop every held graph (and with it its memory pool and its hold on
    the state it was captured on); zero ``CAPTURE``."""
    with _lock:
        _graphs.clear()
        CAPTURE.update(captures=0, replays=0, rebinds=0, eager=dict.fromkeys(REASONS, 0))


def _leaves(state: EngineState) -> List[torch.Tensor]:
    """The state's tensors in ``STATE_FIELDS`` order, a map's keys then vals."""
    out = []
    for name in STATE_FIELDS:
        value = getattr(state, name)
        if isinstance(value, HashTable):
            out += (value.keys, value.vals)
        else:
            out.append(value)
    return out


def _on_card(batch: RecordBatch) -> bool:
    return batch.valid.is_cuda


def record(fn: Callable, device: torch.device):
    """``fn()`` recorded as a CUDA graph on ``device`` (a side stream, a
    private memory pool, claims in an ``ops.PrivateScratch``); nothing runs.
    Returns (a function that replays the graph on ``device``'s current
    stream, ``fn``'s result, the ops calls and device launches one replay
    makes: ``ops.credit``'s argument)."""
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    try:
        with torch.cuda.device(device), ops.private_scratch(ops.PrivateScratch()):
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                result = fn()
    finally:
        after = ops.launch_counts()
        ops.set_launch_counts(before)
    launched = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1]) for k in after}

    def replay():
        with torch.cuda.device(device):
            graph.replay()

    return replay, result, {k: v for k, v in launched.items() if v != (0, 0)}


@dataclasses.dataclass
class _Body:
    """The recorded step: ``kernel.step_kernel`` on the static buffers, and
    each tensor it returns anew copied back into the one it read."""

    graph: DeviceGraph
    state: EngineState
    batch: RecordBatch
    now: torch.Tensor
    synthetic_workers: bool
    partition_id: int

    def __call__(self):
        new, out, stats = kernel.step_kernel(
            self.graph, self.state, self.batch, self.now,
            synthetic_workers=self.synthetic_workers, partition_id=self.partition_id)
        _write_back(_leaves(self.state), new)
        return out, stats


@dataclasses.dataclass
class _Held:
    """One signature's graph and its static buffers."""

    replay: Callable[[], None]
    body: _Body
    leaves: List[torch.Tensor]
    out: RecordBatch
    stats: Dict[str, torch.Tensor]
    launched: Dict[str, Tuple[int, int]]


def _write_back(leaves: List[torch.Tensor], new: EngineState) -> None:
    for old, t in zip(leaves, _leaves(new)):
        if t is not old:
            old.copy_(t)


def _rebind(held: _Held, state: EngineState) -> None:
    """Copy each of ``state``'s tensors that is not held into the held one."""
    if state is held.body.state:
        return
    copied = False
    for old, t in zip(held.leaves, _leaves(state)):
        if t is not old and (t.data_ptr() != old.data_ptr() or t.stride() != old.stride()):
            old.copy_(t)
            copied = True
    if copied:
        _note("rebinds")


def _signature(graph, state, batch, synthetic_workers, partition_id) -> tuple:
    return (
        batch.device, id(graph), batch.size, bool(synthetic_workers), int(partition_id),
        state.ei_i32.data_ptr(),
        tuple((t.shape, t.dtype) for t in _leaves(state)),
        tuple((getattr(batch, f).shape, getattr(batch, f).dtype) for f in rb.FIELDS),
    )


def _capture(key, graph, state, like: RecordBatch, synthetic_workers, partition_id) -> None:
    dev = like.device
    body = _Body(
        graph, state,
        RecordBatch(**{f: torch.empty_like(getattr(like, f)) for f in rb.FIELDS}),
        torch.zeros((), dtype=torch.int64, device=dev), bool(synthetic_workers),
        int(partition_id))
    replay, (out, stats), launched = record(body, dev)
    held = _Held(replay, body, _leaves(state), out, stats, launched)
    with _lock:
        CAPTURE["captures"] += 1
        _graphs[key] = held
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)


@device_spans.traced("step")
def _replay(held: _Held, state: EngineState, batch: RecordBatch, now: int):
    _rebind(held, state)
    for f in rb.FIELDS:
        getattr(held.body.batch, f).copy_(getattr(batch, f))
    held.body.now.fill_(now)
    held.replay()
    ops.credit(held.launched)
    _note("replays")
    return held.body.state, held.out, dict(held.stats)


def step(graph: DeviceGraph, state: EngineState, batch: RecordBatch, now,
         synthetic_workers: bool = False, partition_id=0):
    """``kernel.step_kernel``, replayed from a CUDA graph where it can be
    (the module's docstring says when)."""
    opts = {"synthetic_workers": synthetic_workers, "partition_id": partition_id}
    if not _on_card(batch):
        _note("eager", "cpu")
        return kernel.step_kernel(graph, state, batch, now, **opts)
    key = _signature(graph, state, batch, synthetic_workers, partition_id)
    with _lock:
        held = _graphs.get(key)
        if held is not None:
            _graphs.move_to_end(key)
    if device_spans.TRACER is not None:
        reason = "recorder"
    elif tuple(getattr(ops, name) for name in ENTRY_POINTS) + (kernel.step_kernel,) != _DEFINED:
        reason = "wrapped_op"
    elif held is None:
        reason = "signature"
    else:
        return _replay(held, state, batch, now)
    _note("eager", reason)
    if held is None:
        new, out, stats = kernel.step_kernel(graph, state, batch, now, **opts)
        if reason == "signature":
            _capture(key, graph, new, batch, synthetic_workers, partition_id)
        return new, out, stats
    _rebind(held, state)
    new, out, stats = kernel.step_kernel(graph, held.body.state, batch, now, **opts)
    _write_back(held.leaves, new)
    return held.body.state, out, stats
