"""Partitions and partition state over several devices.

PyTorch counterpart of ``zeebe_tpu.tpu.shard``, with its names. The JAX
module runs under ``shard_map``: one program, every shard on its own chip,
collectives between them. Here one process drives every shard, as the JAX
package's brokers do, and each collective becomes explicit copies between
the shards' devices:

| JAX                          | here                                        |
| ---------------------------- | ------------------------------------------- |
| ``all_gather(tiled)``        | the blocks copied to the computing device   |
|                              | and concatenated                            |
| keep-local on write          | each block's rows copied back to its device |
| single-owner ``psum``        | the owner lane's value                      |
| ``all_to_all``               | one copy per (source, destination) pair     |

A copy between two cards waits for the current streams of both ends
(PyTorch records an event on each), and every kernel of ``tpu/ops.py``
launches on its card's current stream, so a shard's kernels and the
copies of its rows are ordered without a host synchronisation. A mesh may
name one device several times (one card, or the CPU in the tests): every
shard still holds tensors of its own, and the copies are same-device
copies.

Two uses:

- **Partitions as shards** (``build_sharded_step``, ``build_sharded_drive``,
  ``build_frame_exchange``): each device owns one whole partition, and
  hash-routed message-correlation commands (``correlation_route``) cross
  between them.
- **One partition's state sharded** (``ShardedState``, the three state
  steps): the row tables block-shard on dim 0 over the mesh
  (``state_partition_specs``); the gathered step (``build_state_step``)
  steps the whole gathered table, the routed step
  (``build_state_step_routed``) steps only the owner shard's block and its
  batch, and the fallback (``build_state_step_fallback``) gathers the row
  tables and rebuilds the lookup structures from them.

Where the JAX package reduces the owner's values with zeros (``psum``), the
port takes the owner's values as they are: a ``-0.0`` payload stays
``-0.0`` and a replicated leaf is the owner's new value, as in the
single-device step (the JAX reduction turns ``-0.0`` into ``+0.0``).

Unlike JAX arrays, a state handed to a step here is consumed: its blocks
are updated in place.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from zeebe_tpu_torch.device import DeviceLike, resolve
from zeebe_tpu_torch.engine import keyspace
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.tpu import batch as rb
from zeebe_tpu_torch.tpu import graph as graph_mod
from zeebe_tpu_torch.tpu import hashmap
from zeebe_tpu_torch.tpu import state as state_mod
from zeebe_tpu_torch.tpu.batch import RecordBatch
from zeebe_tpu_torch.tpu.graph import DeviceGraph
from zeebe_tpu_torch.tpu.kernel import scope_to_global, scope_to_local, step_kernel
from zeebe_tpu_torch.tpu.state import EngineState, corr_composite

# partition id lives in the key's high bits (reference Protocol.java keeps
# partition-local key spaces; 13 bits of partition, 51 bits of counter)
PARTITION_KEY_SHIFT = 51

# default mesh axis name for sharded-state programs
STATE_AXIS = "shards"

# the hash multiplier of the key routing (a Fibonacci multiplicative hash,
# wrapping mod 2^64)
_HASH_MUL = -7046029254386353131


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along one named axis. The same device may
    appear more than once: each position is a shard of its own."""

    devices: Tuple[torch.device, ...]
    axis_name: str = STATE_AXIS

    def __init__(self, devices: Sequence, axis_name: str = STATE_AXIS):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_name", axis_name)

    @property
    def size(self) -> int:
        return len(self.devices)


# ---------------------------------------------------------------------------
# multi-partition programs: each device owns one whole partition
# ---------------------------------------------------------------------------


def correlation_route(out: RecordBatch, nparts: int, my_pid: int) -> torch.Tensor:
    """Destination partition per emission row: message-subscription
    commands (OPEN/CLOSE) hash their correlation composite, CORRELATE
    commands carry their destination in the ``wf`` column, everything else
    stays local (``zeebe_tpu.tpu.shard.correlation_route``)."""
    rt_cmd = out.rtype == int(RecordType.COMMAND)
    is_msub = out.valid & rt_cmd & (out.vtype == int(ValueType.MESSAGE_SUBSCRIPTION))
    is_corr = out.valid & rt_cmd & (
        out.vtype == int(ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION)
    )
    ckey = corr_composite(out.type_id, out.retries, out.worker)
    h = ((ckey * _HASH_MUL) >> 33) & 0x7FFFFFFF
    hash_target = (h % nparts).to(torch.int32)
    mine = torch.full_like(hash_target, int(my_pid))
    return torch.where(
        is_msub, hash_target,
        torch.where(is_corr, out.wf.clamp(0, nparts - 1).to(torch.int32), mine),
    )


def _first_true_indices_local(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` True entries, padded with ``len(mask)``."""
    n = mask.shape[0]
    m = mask.to(torch.int32)
    rank = torch.cumsum(m, 0, dtype=torch.int32) - m
    tgt = torch.where(mask & (rank < k), rank, k).to(torch.int64)
    out = torch.full((k + 1,), n, dtype=torch.int32, device=mask.device)
    out[tgt] = torch.arange(n, dtype=torch.int32, device=mask.device)
    return out[:k]


def _devices(num: int, devices) -> List[torch.device]:
    if devices is None:
        return [resolve(None)] * num
    devs = [resolve(d) for d in devices]
    if len(devs) != num:
        raise ValueError(f"{num} partitions need {num} devices, got {len(devs)}")
    return devs


def make_partitioned_state(num_partitions: int, capacity: int, num_vars: int,
                           devices=None, **kw) -> List[EngineState]:
    """One state per partition, partition ``p`` on ``devices[p]`` (the card
    by default); key counters start at partition-disjoint bases."""
    out = []
    for pid, dev in enumerate(_devices(num_partitions, devices)):
        st = state_mod.make_state(capacity=capacity, num_vars=num_vars, device=dev, **kw)
        base = pid << PARTITION_KEY_SHIFT
        st.next_wf_key.fill_(base + keyspace.WF_OFFSET)
        st.next_job_key.fill_(base + keyspace.JOB_OFFSET)
        out.append(st)
    return out


def make_partitioned_batch(num_partitions: int, size: int, num_vars: int,
                           devices=None) -> List[RecordBatch]:
    return [rb.empty(size, num_vars, device=d) for d in _devices(num_partitions, devices)]


def make_partitioned_queue(num_partitions: int, capacity: int, num_vars: int,
                           devices=None):
    from zeebe_tpu_torch.tpu import drive as drive_mod

    return [drive_mod.make_queue(capacity, num_vars, device=d)
            for d in _devices(num_partitions, devices)]


def make_exchange(num_partitions: int, slots: int, num_vars: int,
                  devices=None) -> List[List[RecordBatch]]:
    """The cross-partition send buffer: ``sends[p][q]`` holds the ``slots``
    rows partition ``p`` addresses to partition ``q``, on ``p``'s device."""
    devs = _devices(num_partitions, devices)
    return [[rb.empty(slots, num_vars, device=d) for _ in devs] for d in devs]


def _to(batch: RecordBatch, device: torch.device) -> RecordBatch:
    if batch.device == device:
        return batch
    return RecordBatch(**{n: getattr(batch, n).to(device) for n in rb.FIELDS})


def _cat_batches(batches: Sequence[RecordBatch], device: torch.device) -> RecordBatch:
    return RecordBatch(**{
        n: torch.cat([getattr(b, n).to(device) for b in batches]) for n in rb.FIELDS
    })


def graph_on(graph: DeviceGraph, device: torch.device) -> DeviceGraph:
    """``graph`` with its tensors on ``device`` (itself when already there)."""
    if graph.step_table.device == device:
        return graph
    return dataclasses.replace(graph, **{
        n: getattr(graph, n).to(device) for n in graph_mod.DATA_FIELDS
    })


class _GraphCopies:
    """One copy of the latest graph per device, so a step does not copy the
    graph every call."""

    def __init__(self):
        self._graph = None
        self._copies: Dict[torch.device, DeviceGraph] = {}

    def on(self, graph: DeviceGraph, device: torch.device) -> DeviceGraph:
        if graph is not self._graph:
            self._graph, self._copies = graph, {}
        copy = self._copies.get(device)
        if copy is None:
            copy = self._copies[device] = graph_on(graph, device)
        return copy


def build_sharded_step(mesh: Mesh, exchange_slots: int = 128):
    """The multi-partition step: ``(graph, states[P], batches[P],
    sends[P][P], now) → (states', emissions[P], sends_in[P][P],
    total[P], pending[P])``. ``sends_in[q][p]`` is ``sends[p][q]`` on
    ``q``'s device (the all_to_all); ``total`` and ``pending`` are the
    summed processed count and emission-plus-arrival count, one copy per
    partition. Returns ``(step, P)``."""
    nparts = mesh.size
    devs = mesh.devices
    graphs = _GraphCopies()

    def sharded_step(graph, states, batches, sends, now):
        new_states, outs, processed, pend = [], [], [], []
        for p in range(nparts):
            st, out, stats = step_kernel(graphs.on(graph, devs[p]), states[p], batches[p], now)
            new_states.append(st)
            outs.append(out)
            processed.append(stats["processed"])
        sends_in = [[_to(sends[p][q], devs[q]) for p in range(nparts)] for q in range(nparts)]
        for q in range(nparts):
            pend.append(torch.sum(outs[q].valid, dtype=torch.int32)
                        + sum(torch.sum(b.valid, dtype=torch.int32) for b in sends_in[q]))
        total = sum(t.to(devs[0]) for t in processed)
        pending = sum(t.to(devs[0]) for t in pend)
        return (new_states, outs, sends_in,
                [total.to(d) for d in devs], [pending.to(d) for d in devs])

    return sharded_step, nparts


def build_frame_exchange(mesh: Mesh, slots: int, frame_bytes: int):
    """The serving plane's subscription-transport hop between devices:
    encoded record frames ride per-(source, destination) exchange slots as
    raw wire bytes, so the destination decodes exactly what the host
    transport would have carried (``scheduler/placement.MeshExchange``).

    Returns ``exchange(buf[D,D,S,B] u8, lens[D,D,S] i32, pids[D,D,S] i32)
    → (buf', lens', pids')``, where row ``d`` of each output holds the
    frames addressed TO device ``d``, indexed [source device, slot]. Each
    source's rows go to its device, each (source, destination) block is
    one copy to the destination's device, and the destinations' rows are
    read back to the host, where the caller decodes them."""
    n = mesh.size
    devs = mesh.devices

    def exchange(buf, lens, pids):
        # the built geometry IS the contract: a mismatched caller would
        # otherwise deliver garbage quietly
        if tuple(buf.shape) != (n, n, slots, frame_bytes):
            raise ValueError(
                f"frame exchange built for buf shape "
                f"{(n, n, slots, frame_bytes)}, got {tuple(buf.shape)}"
            )
        if tuple(lens.shape) != (n, n, slots) or tuple(pids.shape) != (n, n, slots):
            raise ValueError(
                f"frame exchange built for lane shape {(n, n, slots)}, "
                f"got {tuple(lens.shape)} / {tuple(pids.shape)}"
            )
        outs = []
        for arr in (buf, lens, pids):
            t = torch.as_tensor(np.asarray(arr))
            at_source = [t[s].to(devs[s]) for s in range(n)]
            at_dest = [torch.stack([at_source[s][d].to(devs[d]) for s in range(n)])
                       for d in range(n)]
            outs.append(torch.stack([a.cpu() for a in at_dest]))
        return tuple(outs)

    return exchange


def build_sharded_drive(mesh: Mesh, batch_size: int, synthetic_workers: bool = False,
                        max_rounds: int = 10_000, exchange_slots: int = 0):
    """The multi-partition drive to quiescence: ``drive(graph, states[P],
    queues[P], now) → (states', queues', totals[P])``, ``totals[p]`` the
    partition's processed / emitted / completed-root counts plus the shared
    round count and overflow flag (``zeebe_tpu.tpu.shard.build_sharded_drive``).

    With messages over two or more partitions every partition steps in
    lockstep: emissions routed to another partition (``correlation_route``)
    are bucketed into per-destination blocks of ``exchange_slots`` rows,
    delivered (one copy per pair) and enqueued after the destination's own
    emissions; a block overflow aborts the drive. Otherwise the partitions
    are independent and each drives on its own device through
    ``drive.run_to_quiescence(sync=False)``; the totals are read once.
    Records queued over a partition's whole drive are the JAX lockstep
    loop's, whose idle partitions step empty batches."""
    from zeebe_tpu_torch.tpu import drive as drive_mod

    nparts = mesh.size
    devs = mesh.devices
    exchange_slots = exchange_slots or batch_size
    graphs = _GraphCopies()

    def independent(graph, states, queues, now):
        totals = []
        for p in range(nparts):
            states[p], queues[p], t = drive_mod.run_to_quiescence(
                graphs.on(graph, devs[p]), states[p], queues[p], now, batch_size,
                synthetic_workers=synthetic_workers, max_rounds=max_rounds, sync=False,
                partition_id=p,
            )
            totals.append(t)
        rounds = max(int(t["rounds"]) for t in totals)
        overflow = any(bool(t["overflow"]) for t in totals)
        return states, queues, [
            {"processed": t["processed"], "emitted": t["emitted"],
             "completed_roots": t["completed_roots"],
             "rounds": torch.tensor(rounds, dtype=torch.int32, device=devs[p]),
             "overflow": torch.tensor(overflow, device=devs[p])}
            for p, t in enumerate(totals)
        ]

    def lockstep(graph, states, queues, now):
        zero64 = [torch.zeros((), dtype=torch.int64, device=d) for d in devs]
        totals = [{"processed": z.clone(), "emitted": z.clone(), "completed_roots": z.clone()}
                  for z in zero64]
        overflow = torch.zeros((), dtype=torch.bool, device=devs[0])
        rounds = 0
        ar = torch.arange(exchange_slots, dtype=torch.int32)
        while rounds < max_rounds:
            pending, flagged = torch.stack(
                [sum(q.count.to(devs[0], torch.int64) for q in queues),
                 overflow.to(torch.int64)]
            ).tolist()
            if pending <= 0 or flagged:
                break
            outs, blocks, flags = [], [], []
            for p in range(nparts):
                queues[p], batch = drive_mod.dequeue(queues[p], batch_size)
                states[p], out, stats = step_kernel(
                    graphs.on(graph, devs[p]), states[p], batch, now,
                    synthetic_workers=synthetic_workers, partition_id=p,
                )
                target = correlation_route(out, nparts, p)
                xover = torch.zeros((), dtype=torch.bool, device=devs[p])
                row = []
                for q in range(nparts):
                    m = out.valid & (target == q) & (target != p)
                    n_q = torch.sum(m, dtype=torch.int32)
                    xover = xover | (n_q > exchange_slots)
                    idx = _first_true_indices_local(m, exchange_slots).clamp(0, out.size - 1)
                    block = rb.take_rows(out, idx)
                    block.valid = ar.to(devs[p]) < n_q
                    # arrivals are fresh log entries at the destination
                    block.src = torch.full((exchange_slots,), -1, dtype=torch.int32,
                                           device=devs[p])
                    row.append(block)
                blocks.append(row)
                outs.append(dataclasses.replace(out, valid=out.valid & (target == p)))
                for k in ("processed", "emitted", "completed_roots"):
                    totals[p][k] += stats[k].to(torch.int64)
                flags.append(stats["overflow"] | xover)
            for q in range(nparts):
                arrivals = _cat_batches([blocks[p][q] for p in range(nparts)], devs[q])
                queues[q] = drive_mod.enqueue(queues[q], rb.compact(outs[q]))
                queues[q] = drive_mod.enqueue(queues[q], rb.compact(arrivals))
                flags[q] = flags[q] | queues[q].overflow
            overflow = overflow | torch.stack([f.to(devs[0]) for f in flags]).any()
            rounds += 1
        return states, queues, [
            {**t, "rounds": torch.tensor(rounds, dtype=torch.int32, device=d),
             "overflow": overflow.to(d)}
            for t, d in zip(totals, devs)
        ]

    def drive(graph, states, queues, now):
        states, queues = list(states), list(queues)
        if graph.has_messages and nparts > 1:
            return lockstep(graph, states, queues, now)
        return independent(graph, states, queues, now)

    return drive


# ---------------------------------------------------------------------------
# one partition's state sharded over the mesh
# ---------------------------------------------------------------------------
# The row tables block-shard on dim 0 (the rules below), so a partition's
# resident rows scale with the mesh. The gathered step gathers every
# sharded table each wave and runs the unmodified step kernel on the
# gathered view, which is what makes its log bit-identical to the
# single-device engine; it keeps each block's rows on write. The routed
# programs step only the owner shard: the engine stages a wave whose rows
# all belong to instances wholly resident in one block into that block's
# lane, and the shard rebuilds its lookup structures from its own rows and
# steps the unmodified kernel on them. Waves the policy cannot prove
# single-owner take the fallback, which gathers the row tables and
# rebuilds the lookup structures from them: in resident mode the lookup
# leaves are per-wave scratch in both legs, so the two interleave freely.

# (regex over the state leaf's dotted name, shard?): first match wins.
# Row tables (leading dim = a table capacity) shard on dim 0; worker
# subscriptions, ring cursors and key counters replicate (tiny, scalar, or
# written on the host between waves).
STATE_PARTITION_RULES = (
    (r"ei_(i32|i64|pay|index)$", True),
    (r"ei_map\.", True),
    (r"free_ei$", True),
    (r"job_(i32|i64|pay|index)$", True),
    (r"job_map\.", True),
    (r"free_job$", True),
    (r"join_(key|nin|arrived|pay|pos_stamp)$", True),
    (r"join_map\.", True),
    (r"timer_(key|due|aik|instance_key|elem|wf)$", True),
    (r"timer_map\.", True),
    (r"msub_(ckey|i32|i64)$", True),
    (r"msub_map\.", True),
    (r"msg_(key|ckey|i32|deadline|pay)$", True),
    (r"msg_map\.", True),
    (r".*", False),
)

# state leaves DERIVED from live rows (direct-mapped indexes, fallback
# hashmaps, free-slot rings and their cursors): in resident mode these are
# per-wave scratch, rebuilt inside the step programs, never gathered
LOOKUP_LEAF_PATTERNS = (
    r"ei_map\.", r"job_map\.", r"join_map\.", r"timer_map\.",
    r"msub_map\.", r"msg_map\.",
    r"ei_index$", r"job_index$",
    r"free_(ei|job)$", r"free_(ei|job)_(pop|push)$",
)

_CURSOR_RE = re.compile(r"free_(ei|job)_(pop|push)$")


def state_leaves(state: EngineState) -> List[Tuple[str, torch.Tensor]]:
    """The state's tensors as (dotted name, tensor), in field order; a
    hash table's as ``<field>.keys`` and ``<field>.vals`` (the key paths of
    the JAX state's leaves)."""
    out = []
    for name in state_mod.STATE_FIELDS:
        value = getattr(state, name)
        if isinstance(value, hashmap.HashTable):
            out.append((f"{name}.keys", value.keys))
            out.append((f"{name}.vals", value.vals))
        else:
            out.append((name, value))
    return out


def _state_from_leaves(leaves: Dict[str, torch.Tensor]) -> EngineState:
    fields = {}
    for name in state_mod.STATE_FIELDS:
        if name in state_mod.MAP_FIELDS:
            fields[name] = hashmap.HashTable(keys=leaves[f"{name}.keys"],
                                             vals=leaves[f"{name}.vals"])
        else:
            fields[name] = leaves[name]
    return EngineState(**fields)


def _named_shapes(tree) -> List[Tuple[str, tuple]]:
    if isinstance(tree, EngineState):
        return [(n, tuple(t.shape)) for n, t in state_leaves(tree)]
    return [(n, tuple(np.shape(a))) for n, a in tree.items()]


def match_partition_rules(rules, tree, num_shards: int, axis: str = STATE_AXIS) -> Dict[str, tuple]:
    """The partition spec of every leaf of ``tree`` (an ``EngineState``, or
    arrays keyed by dotted leaf name): ``(axis,)`` when the first rule its
    name matches shards it and its rows divide by ``num_shards``, else
    ``()`` (replicated)."""
    specs = {}
    for name, shape in _named_shapes(tree):
        spec = ()
        for pat, want in rules:
            if re.search(pat, name):
                if want and len(shape) >= 1 and shape[0] > 0 and shape[0] % num_shards == 0:
                    spec = (axis,)
                break
        specs[name] = spec
    return specs


def state_partition_specs(state, num_shards: int, axis: str = STATE_AXIS) -> Dict[str, tuple]:
    """The sharded-state spec of every leaf of an ``EngineState``."""
    return match_partition_rules(STATE_PARTITION_RULES, state, num_shards, axis)


def shard_of_key(key, num_shards: int) -> torch.Tensor:
    """Owning shard of an entity key: the Fibonacci multiplicative hash that
    ``correlation_route`` uses for message routing, in the key alone."""
    k = torch.as_tensor(key, dtype=torch.int64)
    h = ((k * _HASH_MUL) >> 33) & 0x7FFFFFFF
    return (h % num_shards).to(torch.int32)


def shard_row_counts(keys, valid, num_shards: int) -> torch.Tensor:
    """Rows per owning shard for one staged wave ([num_shards] int32)."""
    v = torch.as_tensor(valid, dtype=torch.bool)
    tgt = torch.where(v, shard_of_key(keys, num_shards).to(v.device), num_shards)
    counts = torch.zeros(num_shards + 1, dtype=torch.int32, device=v.device)
    counts.index_add_(0, tgt.to(torch.int64), torch.ones_like(tgt, dtype=torch.int32))
    return counts[:num_shards]


def shard_of_key_host(keys, num_shards: int) -> np.ndarray:
    """numpy twin of :func:`shard_of_key` for host-side wave staging."""
    k = np.asarray(keys, np.int64)
    with np.errstate(over="ignore"):
        h = ((k * np.int64(_HASH_MUL)) >> np.int64(33)) & np.int64(0x7FFFFFFF)
    return (h % num_shards).astype(np.int32)


def shard_row_counts_host(keys, valid, num_shards: int) -> np.ndarray:
    """Host twin of :func:`shard_row_counts` ([num_shards] counts)."""
    tgt = shard_of_key_host(keys, num_shards)
    v = np.asarray(valid, bool)
    return np.bincount(tgt[v], minlength=num_shards).astype(np.int64)


def is_lookup_leaf(name: str) -> bool:
    """True when a dotted state-leaf name is a row-derived lookup structure
    (rebuilt per wave by the resident-mode step programs)."""
    return any(re.search(p, name) for p in LOOKUP_LEAF_PATTERNS)


def _itemsize(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.element_size()
    return int(np.dtype(t.dtype).itemsize)


def state_exchange_bytes(state, num_shards: int, axis: str = STATE_AXIS,
                         include_lookup: bool = True) -> int:
    """Bytes ONE gathered wave's table gathers move between shards: each of
    the D shards receives the (D-1)/D of every sharded table it does not
    hold, so ``sharded_bytes * (D-1)`` a wave. ``include_lookup=False`` is
    the resident mode's fallback, which rebuilds the lookup structures
    instead of gathering them."""
    leaves = state_leaves(state) if isinstance(state, EngineState) else list(state.items())
    specs = state_partition_specs(state, num_shards, axis)
    total = 0
    for name, a in leaves:
        if specs[name] != (axis,):
            continue
        if not include_lookup and is_lookup_leaf(name):
            continue
        total += _itemsize(a) * int(np.prod(tuple(a.shape)))
    return total * (num_shards - 1)


def unshardable_state_leaves(state, num_shards: int) -> list:
    """Leaf names the rules want sharded whose leading dim does not divide
    by ``num_shards`` (they replicate in the gathered mode; the resident
    mode refuses them)."""
    bad = []
    for name, shape in _named_shapes(state):
        for pat, want in STATE_PARTITION_RULES:
            if re.search(pat, name):
                if want and not (len(shape) >= 1 and shape[0] > 0
                                 and shape[0] % num_shards == 0):
                    bad.append(name)
                break
    return bad


def routed_exchange_bytes(out: RecordBatch, num_shards: int) -> int:
    """Bytes ONE routed wave's reduction of the emission batch moves between
    shards in the JAX package's program (``psum``; bool and int8 reduce in
    int32): ``reduced_bytes * (D-1)``. The port takes the owner's batch
    and moves none of it, but keeps the JAX figure as the metric's model."""
    total = 0
    for name in rb.FIELDS:
        a = getattr(out, name)
        item = 4 if a.dtype in (torch.bool, torch.int8) else a.element_size()
        total += item * a.numel()
    return total * (num_shards - 1)


@dataclasses.dataclass
class ShardedState:
    """One partition's ``EngineState`` over a mesh. ``shards[d]`` lies on
    ``mesh.devices[d]``: a sharded leaf holds rows ``[d*R/D, (d+1)*R/D)``
    of the global table, a replicated leaf a whole copy. ``view`` is a
    gathered global state on the mesh's first device that a host reader
    holds (``gather_state`` fills it); it is the authority until a step
    writes it back (``settle``)."""

    mesh: Mesh
    shards: List[EngineState]
    specs: Dict[str, tuple]
    view: Optional[EngineState] = None

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def sharded(self, name: str) -> bool:
        return self.specs[name] == (self.mesh.axis_name,)

    def global_rows(self, name: str) -> int:
        """Rows of the global table ``name`` (no gather)."""
        t = dict(state_leaves(self.shards[0]))[name]
        return t.shape[0] * (self.mesh.size if self.sharded(name) else 1)


def shard_state(mesh: Mesh, state: EngineState, specs=None) -> ShardedState:
    """Split a global state over ``mesh``: each sharded leaf's row blocks
    and a copy of each replicated leaf go to their shard's device."""
    n = mesh.size
    specs = specs if specs is not None else state_partition_specs(state, n, mesh.axis_name)
    axis = (mesh.axis_name,)
    per_shard: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for name, a in state_leaves(state):
        if specs[name] == axis:
            rows = a.shape[0] // n
            for d, dev in enumerate(mesh.devices):
                per_shard[d][name] = a[d * rows:(d + 1) * rows].to(dev, copy=True)
        else:
            for d, dev in enumerate(mesh.devices):
                per_shard[d][name] = a.to(dev, copy=True)
    return ShardedState(mesh, [_state_from_leaves(x) for x in per_shard], specs)


def gather_state(state: ShardedState, skip_lookup: bool = False) -> EngineState:
    """The global state on the mesh's first device: the view when one is
    held, else the blocks copied there and concatenated, with a copy of
    each replicated leaf. ``skip_lookup`` leaves the sharded lookup leaves
    uninitialised at their global shape (the fallback rebuilds them)."""
    if state.view is not None:
        return state.view
    dev = state.device
    axis = (state.mesh.axis_name,)
    blocks = [dict(state_leaves(s)) for s in state.shards]
    out = {}
    for name, first in state_leaves(state.shards[0]):
        if state.specs[name] == axis:
            if skip_lookup and is_lookup_leaf(name):
                shape = (first.shape[0] * state.mesh.size,) + tuple(first.shape[1:])
                out[name] = torch.empty(shape, dtype=first.dtype, device=dev)
            else:
                out[name] = torch.cat([b[name].to(dev) for b in blocks])
        else:
            out[name] = first.to(dev, copy=True)
    return _state_from_leaves(out)


def keep_state(state: ShardedState, full: EngineState) -> ShardedState:
    """Write a global state back into the shards, in place: each block gets
    its rows of every sharded leaf, each shard the replicated leaves. Drops
    the view."""
    n = state.mesh.size
    axis = (state.mesh.axis_name,)
    src = dict(state_leaves(full))
    for d, shard in enumerate(state.shards):
        for name, dst in state_leaves(shard):
            a = src[name]
            if state.specs[name] == axis:
                rows = a.shape[0] // n
                dst.copy_(a[d * rows:(d + 1) * rows])
            else:
                dst.copy_(a)
    state.view = None
    return state


def settle(state: ShardedState) -> ShardedState:
    """Write a held view back into the shards (no-op without one)."""
    if state.view is not None:
        keep_state(state, state.view)
    return state


def build_state_step(mesh: Mesh, state_template: EngineState):
    """The gathered sharded-state step: ``(graph, state, batch, now,
    partition_id) → (state', out, stats)``. Every sharded table is gathered
    to the mesh's first device, the unmodified ``step_kernel`` runs on the
    gathered view (so the outputs are the single-device step's, bit for
    bit), and each block keeps its rows of the result. The batch lies on
    the first device."""
    graphs = _GraphCopies()

    def state_step(graph, state: ShardedState, batch, now, partition_id=0):
        full = gather_state(state)
        full, out, stats = step_kernel(
            graphs.on(graph, mesh.devices[0]), full, _to(batch, mesh.devices[0]), now,
            partition_id=partition_id,
        )
        return keep_state(state, full), out, stats

    return state_step


def build_state_step_routed(mesh: Mesh, state_template: EngineState):
    """The residency-routed step: ``(graph, state, batch, owner, now,
    partition_id) → (state', out, stats)``. Every row of ``batch`` belongs
    to an instance wholly resident in shard ``owner``'s block. That shard
    translates its parent-slot column into its local row space, rebuilds
    its lookup structures from its own rows, and steps the unmodified
    kernel on its block and the batch; no table crosses between devices.
    The outputs are the owner's (the JAX program reduces them with zeros
    over the mesh), the replicated leaves take the owner's new values on
    every shard, and the free-ring cursors, which each rebuild resets, keep
    their input. The other shards are not stepped: the JAX program steps
    them on empty batches, which leaves their blocks as they were but for
    their lookup scratch, which no step reads before rebuilding it."""
    graphs = _GraphCopies()
    cursors = [name for name, _ in state_leaves(state_template) if _CURSOR_RE.search(name)]

    def routed_step(graph, state: ShardedState, batch, owner: int, now, partition_id=0):
        settle(state)
        dev = mesh.devices[owner]
        local = state.shards[owner]
        lrows = local.ei_i32.shape[0]
        prev_scope = local.ei_i32[:, state_mod.EI_SCOPE].clone()
        kept = {name: getattr(local, name).clone() for name in cursors}
        scope_to_local(local.ei_i32, owner, lrows)
        local = state_mod.rebuild_lookup_state(local)
        local, out, stats = step_kernel(
            graphs.on(graph, dev), local, _to(batch, dev), now, partition_id=partition_id
        )
        scope_to_global(local.ei_i32, prev_scope, owner, lrows)
        for name, value in kept.items():
            setattr(local, name, value)
        state.shards[owner] = local
        new = dict(state_leaves(local))
        for d, shard in enumerate(state.shards):
            if d == owner:
                continue
            for name, dst in state_leaves(shard):
                if not state.sharded(name) and name not in kept:
                    dst.copy_(new[name])
        return state, out, stats

    return routed_step


def build_state_step_fallback(mesh: Mesh, state_template: EngineState):
    """The resident mode's gathered fallback (the signature of
    ``build_state_step``): the row tables are gathered, the lookup
    structures are rebuilt from them on the first device instead of being
    gathered, the kernel steps the global view, and each block keeps its
    rows of every sharded leaf, lookup leaves included."""
    graphs = _GraphCopies()

    def fallback_step(graph, state: ShardedState, batch, now, partition_id=0):
        full = gather_state(state, skip_lookup=True)
        full = state_mod.rebuild_lookup_state(full)
        full, out, stats = step_kernel(
            graphs.on(graph, mesh.devices[0]), full, _to(batch, mesh.devices[0]), now,
            partition_id=partition_id,
        )
        return keep_state(state, full), out, stats

    return fallback_step


