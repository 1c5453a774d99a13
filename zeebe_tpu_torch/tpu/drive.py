"""Device-resident record queue + drive loop.

PyTorch counterpart of ``zeebe_tpu.tpu.drive``. The broker's hot loop
(``StreamProcessorController.java:296-399``) reads committed records and
feeds follow-ups back into the log; on the device that feedback never
crosses to the host: emissions are appended to a device FIFO and dequeued
as the next fixed-size input batch.

Queue layout (same as the JAX package): the FIFO front is kept at index 0.
- dequeue = slice ``rows[:B]`` + one contiguous shift-down copy per field;
- enqueue = one block write per field at the tail, at a start index that
  stays on the device (``index_copy_``), so neither needs a host sync. The
  incoming batch must be PREFIX-COMPACTED (the kernel's emission
  compaction guarantees it); rows at index >= count are always invalid.

The JAX package runs the whole loop as one device program. Here the loop
is Python and reads ``count`` and the overflow flag once per round: one
host sync a round. On the card each round's step is one replay of a CUDA
graph of ``kernel.step_kernel`` (``tpu.capture``; ``CAPTURE`` counts the
captures, replays, rebinds and eager steps): the module global
``step_kernel``, which a caller may wrap, is ``capture.step``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from zeebe_tpu_torch.device import DeviceLike, resolve
from zeebe_tpu_torch.tpu import batch as rb
from zeebe_tpu_torch.tpu.batch import RecordBatch
from zeebe_tpu_torch.tpu.capture import CAPTURE  # noqa: F401 - drive.CAPTURE
from zeebe_tpu_torch.tpu.capture import step as step_kernel
from zeebe_tpu_torch.tpu.graph import DeviceGraph
from zeebe_tpu_torch.tpu.state import EngineState
from zeebe_tpu_torch.tracing import device as device_spans


@dataclasses.dataclass
class RecordQueue:
    rows: RecordBatch      # [Q] storage; live rows are exactly [0, count)
    count: torch.Tensor    # int32 scalar
    overflow: torch.Tensor  # bool scalar, sticky: an enqueue didn't fit

    @property
    def capacity(self) -> int:
        return self.rows.size


def make_queue(capacity: int, num_vars: int, device: DeviceLike = None) -> RecordQueue:
    """``capacity`` must budget for block writes: an enqueue needs the whole
    (padded) incoming block to fit, so the usable record count is
    ``capacity - largest_enqueued_block``."""
    dev = resolve(device)
    return RecordQueue(
        rows=rb.empty(capacity, num_vars, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def enqueue(queue: RecordQueue, batch: RecordBatch) -> RecordQueue:
    """Append a prefix-compacted batch in row order (FIFO), writing the
    queue's storage in place. Sets the sticky overflow flag (and leaves the
    queue corrupt) if the block doesn't fit; callers abort on overflow."""
    qcap = queue.capacity
    ob = batch.size
    if ob > qcap:
        raise ValueError(f"enqueue: block of {ob} rows exceeds queue capacity {qcap}")
    add = torch.sum(batch.valid, dtype=torch.int32)
    tail = queue.count
    # the block start clamps (as dynamic_update_slice does); past qcap-ob
    # the block would land over live rows, so that is the overflow line
    overflow = queue.overflow | (tail > qcap - ob)
    start = torch.clamp(tail, max=qcap - ob).to(torch.int64)
    dst = start + torch.arange(ob, dtype=torch.int64, device=start.device)
    for name in rb.FIELDS:
        getattr(queue.rows, name).index_copy_(0, dst, getattr(batch, name))
    return RecordQueue(rows=queue.rows, count=tail + add, overflow=overflow)


def dequeue(queue: RecordQueue, batch_size: int) -> Tuple[RecordQueue, RecordBatch]:
    """Take the first ``batch_size`` rows and shift the remainder down.
    Valid flags in storage already mask the sub-batch tail when fewer than
    ``batch_size`` rows are pending."""
    take = torch.clamp(queue.count, max=batch_size)
    blanks = rb.empty(batch_size, queue.rows.num_vars, device=queue.count.device)
    out, rows = {}, {}
    for name in rb.FIELDS:
        col = getattr(queue.rows, name)
        out[name] = col[:batch_size].clone()
        rows[name] = torch.cat([col[batch_size:], getattr(blanks, name)], dim=0)
    return (
        RecordQueue(rows=RecordBatch(**rows), count=queue.count - take,
                    overflow=queue.overflow),
        RecordBatch(**out),
    )


def drive_round(
    graph: DeviceGraph,
    state: EngineState,
    queue: RecordQueue,
    now,
    batch_size: int,
    synthetic_workers: bool = False,
    partition_id: int = 0,
):
    """Dequeue one batch, step the kernel, enqueue the emissions.
    Returns (state, queue, stats)."""
    queue, batch = dequeue(queue, batch_size)
    state, out, stats = step_kernel(
        graph, state, batch, now, synthetic_workers=synthetic_workers,
        partition_id=partition_id,
    )
    queue = enqueue(queue, out)
    stats = dict(stats)
    stats["overflow"] = stats["overflow"] | queue.overflow
    return state, queue, stats


def _pending(queue: RecordQueue, overflow: torch.Tensor):
    """The queue's count and the overflow flag in ONE transfer: a round's
    host sync."""
    return torch.stack([queue.count.to(torch.int64), overflow.to(torch.int64)]).tolist()


@device_spans.traced("drive.run")
def run_to_quiescence(
    graph: DeviceGraph,
    state: EngineState,
    queue: RecordQueue,
    now,
    batch_size: int,
    synthetic_workers: bool = False,
    max_rounds: int = 10_000,
    sync: bool = True,
    partition_id: int = 0,
):
    """Drive rounds until the queue drains. Returns (state, queue, totals).

    The totals accumulate on the device; each round reads the queue count
    and the overflow flag back in ONE transfer to decide whether to go on
    (an overflow ends the loop). Raises on a table or queue overflow, and
    when ``max_rounds`` rounds leave records queued.

    ``sync=False`` returns the totals as device tensors (``processed``,
    ``emitted``, ``completed_roots``, ``rounds`` and ``overflow``) and
    raises nothing: the caller, who may gather the totals of several drives
    in one read, checks the overflow and the quiescence.
    ``partition_id`` is the step kernel's."""
    dev = queue.count.device
    now = int(now)
    totals = {
        "processed": torch.zeros((), dtype=torch.int64, device=dev),
        "emitted": torch.zeros((), dtype=torch.int64, device=dev),
        "completed_roots": torch.zeros((), dtype=torch.int64, device=dev),
    }
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    rounds = 0
    # a round is its launches and then the read that decides on the next
    count, flagged = _pending(queue, overflow) if max_rounds > 0 else (0, 0)
    while count > 0 and not flagged:
        span = device_spans.begin("drive.round", "drive.launch")
        state, queue, stats = drive_round(
            graph, state, queue, now, batch_size, synthetic_workers, partition_id
        )
        for k in totals:
            totals[k] += stats[k].to(torch.int64)
        overflow = overflow | stats["overflow"]
        rounds += 1
        if rounds >= max_rounds:
            device_spans.end(span)
            break
        device_spans.phase("drive.sync")
        count, flagged = _pending(queue, overflow)
        device_spans.end(span)
    if not sync:
        totals["rounds"] = torch.tensor(rounds, dtype=torch.int32, device=dev)
        totals["overflow"] = overflow
        return state, queue, totals
    if bool(overflow):
        raise RuntimeError("device table or queue overflow during drive loop")
    out = {k: int(t) for k, t in totals.items()}
    out["rounds"] = rounds
    if rounds >= max_rounds and int(queue.count) > 0:
        raise RuntimeError("drive loop did not quiesce")
    return state, queue, out
