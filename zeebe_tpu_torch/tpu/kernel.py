"""THE step kernel: one application of all stream processors to a record
batch — PyTorch counterpart of ``zeebe_tpu.tpu.kernel``.

This replaces the reference's per-record hot loop
(``logstreams/.../processor/StreamProcessorController.java:296-399`` driving
``BpmnStepProcessor.processRecord`` and the job processors) with one SIMD
pass: every record in the batch is routed, guarded and stepped in
parallel; follow-up records are produced into fixed emission slots and
compacted; state lands via deterministic writes (conflicts resolved by
batch rank, never by scheduling). Feeding emissions back as the next batch
reproduces the oracle's serial log exactly.

Phases (as in the JAX kernel):
  A. lookups (record key / scope key / job aik → table slots)
  B. routing + step guards
  C. per-step compute (job state machine, output merge)
  D. key assignment (strided counters + prefix sums — KeyGenerator parity)
  E. emissions → compaction; table commits

The port runs every feature gate of the JAX kernel, each on or off:
``has_conditions`` (exclusive gateways with json-el conditions),
``has_mappings`` (input and output mappings), ``has_timers`` (timer catch
events and timer boundaries), ``has_parallel_joins`` (the fork/join path),
``has_messages`` (message catch events, receive tasks, message
boundaries and the message partition's store), ``has_boundaries`` (arm,
disarm, interrupt and continue) and ``has_multi_instance`` (cardinality
fan-out). Where a gate being off makes a JAX value constant (no timer
table lookup ⇒ no timer hit), the constant is used directly.

The table primitives go through ``ops``: one fused gather launch per read
stage (8 per step), one ``ops.fused_lookup`` for every index-miss
fallback (1 per step; the timer, subscription and stored-message maps'
probes share it) and one ``ops.fused_table_commit`` per table group (2
per step), which updates the element-instance and job tables IN PLACE.
The join path adds, per step, 2 lookups and 1 insert on the join map, 7
masked sets into the join tables and one ``ops.fused_accumulate`` for
their two row maxima; the timer path one more table commit (the six
timer tables) and 1 insert on the timer map; the message path one
commit per store (subscriptions, stored messages) and 1 insert on each
store's map; the boundary path one lookup of the job map (its keys are
the instances' gathered job keys). Every map delete of the step is one
``ops.fused_delete`` at its end — all IN PLACE as well. The condition
programs and the boundary disarm's timer scan run as plain PyTorch
(``conditions.eval_programs``, ``_armed_timer_slots``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from zeebe_tpu_torch.engine import keyspace
from zeebe_tpu_torch.models.transform.steps import BpmnStep as BS
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import (
    JobIntent as JI,
    MessageIntent as MI,
    MessageSubscriptionIntent as MS,
    TimerIntent as TI,
    WorkflowInstanceIntent as WI,
    WorkflowInstanceSubscriptionIntent as WS,
)
from zeebe_tpu_torch.tpu import batch as rb
from zeebe_tpu_torch.tpu import graph as graph_mod
from zeebe_tpu_torch.tpu import ops
from zeebe_tpu_torch.tpu.batch import RecordBatch
from zeebe_tpu_torch.tpu.conditions import ERROR as TRI_ERROR
from zeebe_tpu_torch.tpu.conditions import TRUE as TRI_TRUE
from zeebe_tpu_torch.tpu.conditions import (
    VT_ABSENT, VT_BOOL, VT_NUM, VT_STR, eval_programs,
)
from zeebe_tpu_torch.tpu.graph import DeviceGraph
from zeebe_tpu_torch.tpu.state import (
    EngineState,
    corr_composite,
    pack_payload, unpack_payload,
    EI_ELEM, EI_STATE, EI_WF, EI_SCOPE, EI_TOKENS, EI_PENDING_BD,
    EIL_KEY, EIL_IKEY, EIL_JOB_KEY,
    JB_STATE, JB_ELEM, JB_WF, JB_TYPE, JB_RETRIES, JB_WORKER,
    JBL_KEY, JBL_IKEY, JBL_AIK, JBL_DEADLINE,
    MS_PART, MSL_WIKEY, MSL_AIK, MG_MSGID,
)
from zeebe_tpu_torch.tracing import device as device_spans

RT_EVENT = int(RecordType.EVENT)
RT_CMD = int(RecordType.COMMAND)
RT_REJ = int(RecordType.COMMAND_REJECTION)
VT_WI = int(ValueType.WORKFLOW_INSTANCE)
VT_JOB = int(ValueType.JOB)
VT_INCIDENT = int(ValueType.INCIDENT)
VT_TIMER = int(ValueType.TIMER)
VT_MSG = int(ValueType.MESSAGE)
VT_MSUB = int(ValueType.MESSAGE_SUBSCRIPTION)
VT_WISUB = int(ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION)

_KEY_STEP = keyspace.STEP_SIZE
_I32, _I64, _BOOL = torch.int32, torch.int64, torch.bool


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 scan (the JAX kernel's MXU-matmul scan is a TPU
    device trick; its results are these exact integers)."""
    return torch.cumsum(x.to(_I32), 0, dtype=_I32)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    x = x.to(_I32)
    return _cumsum_i32(x) - x


def _first_true_indices(avail: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` True entries of ``avail`` (padded with
    ``len(avail)``). The targets are distinct ranks; every other row is
    parked on the dropped slot ``k``."""
    cap = avail.shape[0]
    rank = _excl_cumsum(avail)
    tgt = torch.where(avail & (rank < k), rank, k).to(_I64)
    out = torch.full((k + 1,), cap, dtype=_I32, device=avail.device)
    out[tgt] = torch.arange(cap, dtype=_I32, device=avail.device)
    return out[:k]


def _triangle(n: int, device, later: bool) -> torch.Tensor:
    """[n, n] bool: [i, j] is j > i (``later``) or j < i."""
    i = torch.arange(n, device=device)
    return (i[None, :] > i[:, None]) if later else (i[None, :] < i[:, None])


def _last_writer(slots: torch.Tensor, mask: torch.Tensor, size: int) -> torch.Tensor:
    """True for the highest-batch-rank writer per target slot. Small
    batches use the O(B²) comparison triangle, large ones a scatter-max of
    the rank and a read-back — the JAX kernel's split at 2048, kept so both
    branches stay pinned against it."""
    n = slots.shape[0]
    if n <= 2048:
        later_same = (
            (slots[:, None] == slots[None, :])
            & mask[None, :]
            & _triangle(n, slots.device, later=True)
        )
        return mask & ~torch.any(later_same, dim=1)
    rank = torch.arange(n, dtype=_I32, device=slots.device)
    tgt = torch.where(mask, slots.to(_I64), size)
    # .at[tgt].max(mode="drop") on a size+1 array: wrap once, and park what
    # is still out of range on an extra dropped slot (no boolean indexing:
    # that would sync the host with the device)
    wrapped = torch.where(tgt < 0, tgt + size + 1, tgt)
    ok = (wrapped >= 0) & (wrapped <= size)
    best = torch.full((size + 2,), -1, dtype=_I32, device=slots.device)
    best.scatter_reduce_(0, torch.where(ok, wrapped, size + 1),
                         torch.where(mask, rank, -1), reduce="amax",
                         include_self=True)
    return mask & (best[tgt.clamp(0, size)] == rank)


def _first_per_key(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B] bool: row i is the FIRST masked row carrying its key (row order =
    log order). Small batches: comparison triangle; large: a stable sort."""
    b = keys.shape[0]
    if b <= 2048:
        earlier_same = (
            (keys[:, None] == keys[None, :])
            & mask[None, :]
            & _triangle(b, keys.device, later=False)
        )
        return ~torch.any(earlier_same, dim=1)
    idx = torch.arange(b, dtype=_I64, device=keys.device)
    # unmasked rows get unique sentinels so they never collide
    k = torch.where(mask, keys.to(_I64), -1 - idx)
    k_sorted, order = torch.sort(k, stable=True)
    first_sorted = torch.cat(
        [torch.ones((1,), dtype=_BOOL, device=keys.device),
         k_sorted[1:] != k_sorted[:-1]]
    )
    out = torch.zeros((b,), dtype=_BOOL, device=keys.device)
    out[order] = first_sorted
    return out


def _indexed_lookup_multi(lookups, probes=()):
    """Parallel key → (found, slot) resolutions via the direct-mapped indexes
    with hashmap fallback; both paths verify against the table's own key
    column, so stale index/map entries resolve to not-found.

    Each lookup is ``(index, key_col, fallback_map, keys, want, cap)``;
    ``probes`` are further map probes ``(map, keys, valid)`` independent of
    these lookups, which share the fallbacks' launch. Returns
    ``([(found, slot), ...], [(found, vals), ...])``: the lookups' and the
    probes' results in input order. Each stage is one fused gather over
    all lookups (3 launches), plus ONE fused hash probe for every fallback
    and every further probe."""
    cands = ops.fused_gather_rows(
        [index for index, *_ in lookups],
        [
            ops.GatherOp(i, ((keys // 5) & (index.shape[0] - 1)).to(_I32))
            for i, (index, _kc, _fb, keys, _w, _c) in enumerate(lookups)
        ],
    )
    cand_clips = [cand.clamp(0, lk[5] - 1) for cand, lk in zip(cands, lookups)]
    key_cols = [kc for _i, kc, *_ in lookups]
    kc_hit = ops.fused_gather_rows(
        key_cols, [ops.GatherOp(i, cc) for i, cc in enumerate(cand_clips)]
    )
    hits = [
        lk[4] & (cand >= 0) & (kc == lk[3])
        for lk, cand, kc in zip(lookups, cands, kc_hit)
    ]
    misses = [lk[4] & ~hit for lk, hit in zip(lookups, hits)]
    maps = [lk[2] for lk in lookups] + [m for m, _k, _v in probes]
    keyed = ([(lk[3], miss) for lk, miss in zip(lookups, misses)]
             + [(k, v) for _m, k, v in probes])
    found = ops.fused_lookup(maps, [ops.LookupOp(i, k, v) for i, (k, v) in enumerate(keyed)])
    fbs, probed = found[: len(lookups)], found[len(lookups):]
    fb_clips = [fb_slot.clamp(0, lk[5] - 1) for (_f, fb_slot), lk in zip(fbs, lookups)]
    kc_fb = ops.fused_gather_rows(
        key_cols, [ops.GatherOp(i, fc) for i, fc in enumerate(fb_clips)]
    )
    out = []
    for lk, hit, miss, (fb_found, _s), fb_clip, kc, cand_clip in zip(
        lookups, hits, misses, fbs, fb_clips, kc_fb, cand_clips
    ):
        fb_ok = miss & fb_found & (kc == lk[3])
        out.append((hit | fb_ok, torch.where(hit, cand_clip, fb_clip)))
    return out, probed


def _planes(x: torch.Tensor) -> torch.Tensor:
    """[B, C] (or [B]) int64 → [B, 2C] int32 little-endian lo/hi planes —
    a bitcast, the layout ``x.view(torch.int32)`` gives a state table."""
    b = x.shape[0]
    return x.contiguous().view(_I32).reshape(b, -1)


def _put(em: Dict[str, torch.Tensor], mask: torch.Tensor, **kw) -> Dict[str, torch.Tensor]:
    """em[name] = where(mask, value, em[name]) in the column's own dtype."""
    for name, val in kw.items():
        col = em[name]
        m = mask if col.dim() == 1 else mask[:, None]
        if torch.is_tensor(val):
            val = val.to(col.dtype)
        em[name] = torch.where(m, val, col)
    return em


def _put_payload(em, mask, vt, num, sid):
    m = mask[:, None]
    em["v_vt"] = torch.where(m, vt.to(torch.int8), em["v_vt"])
    em["v_num"] = torch.where(m, num, em["v_num"])
    em["v_str"] = torch.where(m, sid.to(_I32), em["v_str"])
    return em


def _apply_mappings(m_src: torch.Tensor, m_dst: torch.Tensor, src_vt: torch.Tensor):
    """Vectorized MappingProcessor.extract source selection over the
    records' gathered mapping rows ``m_src``/``m_dst`` [B, K].

    Returns (dst_from [B, V]: the source column per target column, or -1;
    err [B]: a listed source is absent). The K mappings apply in order, so
    a later mapping to the same target wins; an inactive slot (src -1)
    writes nothing."""
    b, v = src_vt.shape
    cols = torch.arange(v, dtype=_I32, device=src_vt.device)
    dst_from = torch.full((b, v), -1, dtype=_I32, device=src_vt.device)
    err = torch.zeros((b,), dtype=_BOOL, device=src_vt.device)
    for k in range(m_src.shape[1]):
        src, dst = m_src[:, k], m_dst[:, k]
        active = src >= 0
        src_c = src.clamp(0, v - 1).to(_I64)
        err = err | (active & (torch.gather(src_vt, 1, src_c[:, None])[:, 0] == VT_ABSENT))
        hit = active[:, None] & (cols[None, :] == dst[:, None])
        dst_from = torch.where(hit, src[:, None], dst_from)
    return dst_from, err


def _select_by_map(dst_from, vt, num, sid):
    """payload'[v] = payload[dst_from[v]] (absent where dst_from = -1)."""
    c = dst_from.clamp(0, vt.shape[1] - 1).to(_I64)
    got = dst_from >= 0
    zero = torch.zeros((), dtype=vt.dtype, device=vt.device)
    return (
        torch.where(got, torch.gather(vt, 1, c), zero + VT_ABSENT),
        torch.where(got, torch.gather(num, 1, c), zero.to(num.dtype)),
        torch.where(got, torch.gather(sid, 1, c), zero.to(sid.dtype)),
    )


def _gather_named(reads: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """ONE fused gather of ``reads`` ({name: (table, slots)}; one more
    launch for every further ``ops._MAX_GATHER_OPS`` reads); returns
    {name: rows}. A table read twice is passed once."""
    names = list(reads)
    out: Dict[str, torch.Tensor] = {}
    for lo in range(0, len(names), ops._MAX_GATHER_OPS):
        tables: List[torch.Tensor] = []
        gops = []
        chunk = names[lo : lo + ops._MAX_GATHER_OPS]
        for name in chunk:
            table, slots = reads[name]
            i = next((j for j, t in enumerate(tables) if t is table), len(tables))
            if i == len(tables):
                tables.append(table)
            gops.append(ops.GatherOp(i, slots))
        out.update(zip(chunk, ops.fused_gather_rows(tables, gops)))
    return out


def _corr_cols(batch: RecordBatch, cvar: torch.Tensor):
    """The correlation key a record's payload column ``cvar`` holds: (value
    type, bits — the interned id of a string, the f32 bit pattern of a
    number or bool —, extractable). The accepted types mirror the oracle's
    ``isinstance(corr, (str, int))``: strings, numbers and bools."""
    v = batch.v_vt.shape[1]
    c = cvar.clamp(0, v - 1).to(_I64)[:, None]
    cvt = torch.gather(batch.v_vt, 1, c)[:, 0].to(_I32)
    bits = torch.where(
        cvt == VT_STR, torch.gather(batch.v_str, 1, c)[:, 0],
        torch.gather(batch.v_num, 1, c)[:, 0].contiguous().view(_I32),
    )
    ok = (cvar >= 0) & ((cvt == VT_STR) | (cvt == VT_NUM) | (cvt == VT_BOOL))
    return cvt, bits, ok


def _armed_timer_slots(state: EngineState, keys: torch.Tensor,
                       wants: List[torch.Tensor], n: int) -> List[List[torch.Tensor]]:
    """The oracle's scan of its timers by activity instance key: for each
    mask of ``wants`` and each row it sets, the slots of the first ``n``
    live timers (in slot order) whose ``timer_aik`` is the row's key, as
    ``n`` [B] int32 tensors, ``T`` where there are fewer.

    The JAX kernel builds a [B, T] mask and takes its row minimum ``n``
    times; the j-th minimum is the j-th matching slot. Here one stable sort
    of the timers by key (equal keys stay in slot order) and one binary
    search per row give the same slots without the [B, T] temporaries."""
    t_cap = state.timer_key.shape[0]
    live = state.timer_key >= 0
    sort_k = torch.where(live, state.timer_aik, torch.iinfo(torch.int64).max)
    sorted_k, order = torch.sort(sort_k, stable=True)
    keys = keys.to(_I64)
    first = torch.searchsorted(sorted_k, keys)
    nth = []
    for j in range(n):
        pos = first + j
        pos_c = pos.clamp(max=t_cap - 1)
        slot = order[pos_c]
        nth.append(((pos < t_cap) & (sorted_k[pos_c] == keys) & live[slot], slot))
    return [[torch.where(want & hit, slot, t_cap).to(_I32) for hit, slot in nth]
            for want in wants]


def scope_to_local(ei_i32: torch.Tensor, shard_index: int, local_rows: int) -> torch.Tensor:
    """Translate the EI_SCOPE parent-slot column of one shard's row block
    from the GLOBAL row space into the block's LOCAL row space (the
    residency-routed sharded state, ``tpu/shard.py``), IN PLACE; returns
    the table.

    At rest the sharded tables store parent slots globally, so host readers
    (the demotion's scope-tree walk, snapshots) see one row space. The
    routed step runs the kernel on one row block, whose slot arithmetic is
    local: in-block parents shift down by the block base, sentinels (< 0)
    pass through, and out-of-block parents become the POISON slot
    ``local_rows`` (one past the last local row, so no real slot equals
    it). A gather through the POISON slot clamps to the last local row and
    reads real, wrong-parent data; that is harmless only because the
    routing policy steps only instances wholly resident in the block, and
    ``scope_to_global`` restores the original slot afterwards."""
    base = shard_index * local_rows
    g = ei_i32[:, EI_SCOPE]
    inside = (g >= base) & (g < base + local_rows)
    local = torch.where(g < 0, g, torch.where(inside, g - base, local_rows))
    ei_i32[:, EI_SCOPE] = local.to(ei_i32.dtype)
    return ei_i32


def scope_to_global(ei_i32: torch.Tensor, prev_global_scope: torch.Tensor,
                    shard_index: int, local_rows: int) -> torch.Tensor:
    """Inverse of ``scope_to_local`` after the kernel ran on the block, IN
    PLACE: local slots shift up by the block base, sentinels pass through,
    and rows still holding the POISON slot (untouched by the wave) get
    their original global parent (``prev_global_scope``) back."""
    base = shard_index * local_rows
    loc = ei_i32[:, EI_SCOPE]
    back = torch.where(
        loc < 0, loc, torch.where(loc == local_rows, prev_global_scope, loc + base)
    )
    ei_i32[:, EI_SCOPE] = back.to(ei_i32.dtype)
    return ei_i32


@device_spans.traced("step", "step.lookups")
def step_kernel(
    graph: DeviceGraph, state: EngineState, batch: RecordBatch, now,
    synthetic_workers: bool = False, partition_id=0,
) -> Tuple[EngineState, RecordBatch, dict]:
    """Process one committed-record batch; returns (state', emissions, stats).

    Emissions are compacted in oracle append order; ``emissions.src``
    links each emission to its source row. The element-instance and job
    tables of ``state`` are updated in place and returned in ``state'``.

    ``synthetic_workers`` (bench-only): every ACTIVATED push also emits an
    instant COMPLETE command — the worker round trip without leaving the
    device.

    ``now`` is the clock in ms: an int, or an int64 scalar on the batch's
    device (what a CUDA graph of the step reads, ``tpu.capture``).
    """
    dev = batch.device
    b = batch.size
    v = state.num_vars
    e_w = graph.emit_width
    n_cap = state.capacity
    m_cap = state.job_i32.shape[0]
    s_cap = state.sub_key.shape[0]
    rows = torch.arange(b, dtype=_I32, device=dev)

    def zeros_b(dtype=_BOOL):
        return torch.zeros((b,), dtype=dtype, device=dev)

    def full_b(value, dtype):
        return torch.full((b,), value, dtype=dtype, device=dev)

    valid = batch.valid
    rt, vt_, it = batch.rtype, batch.vtype, batch.intent
    n_wfs, n_elems = graph.elem_type.shape
    wf_c = batch.wf.clamp(0, n_wfs - 1)
    el_c = batch.elem.clamp(0, n_elems - 1)
    # hot-path per-element graph reads: the meta row, the step row, the
    # parallel fork fan, the timer duration and, with their gates on, the
    # conditioned flows with their programs, the mapping columns and the
    # attached boundary events all index by (workflow, element) — one fused
    # gather over the flattened tables
    n_intents = graph.step_table.shape[2]
    fork_fan = graph.out_flows.shape[2]
    cond_fan = graph.cond_flows.shape[2]
    em_cols = graph.elem_meta.shape[2]
    bdw = graph.bd_elem.shape[2]
    g_idx = wf_c * n_elems + el_c
    g_reads = {
        "emeta": graph.elem_meta.reshape(-1, em_cols),
        "step": graph.step_table.reshape(-1, n_intents),
        "fork": graph.out_flows.reshape(-1, fork_fan),
        "timer_dur": graph.timer_dur.reshape(-1),
    }
    if graph.has_conditions:
        g_reads["cflow"] = graph.cond_flows.reshape(-1, cond_fan)
        g_reads["cprog"] = graph.cond_prog.reshape(-1, cond_fan)
    if graph.has_mappings:
        n_maps = graph.in_map_src.shape[2]
        for name in ("in_map_src", "in_map_dst", "out_map_src", "out_map_dst"):
            g_reads[name] = getattr(graph, name).reshape(-1, n_maps)
    if graph.has_boundaries:
        for name in ("bd_elem", "bd_timer", "bd_msg", "bd_corr"):
            g_reads[name] = getattr(graph, name).reshape(-1, bdw)
    g_rows = _gather_named({k: (t, g_idx) for k, t in g_reads.items()})
    emeta, step_row = g_rows["emeta"], g_rows["step"]
    fork_flows, timer_dur_rec = g_rows["fork"], g_rows["timer_dur"]
    if graph.has_conditions:
        cflow, cprog = g_rows["cflow"], g_rows["cprog"]
    if graph.has_mappings:
        in_src, in_dst = g_rows["in_map_src"], g_rows["in_map_dst"]
        out_src, out_dst = g_rows["out_map_src"], g_rows["out_map_dst"]

    # ---------------- A. lookups ----------------
    is_wi = valid & (vt_ == VT_WI)
    wi_ev = is_wi & (rt == RT_EVENT)
    wi_cmd = is_wi & (rt == RT_CMD)
    is_job = valid & (vt_ == VT_JOB)
    job_cmd = is_job & (rt == RT_CMD)
    job_ev = is_job & (rt == RT_EVENT)
    timer_cmd = valid & (vt_ == VT_TIMER) & (rt == RT_CMD)
    msg_pub = valid & (vt_ == VT_MSG) & (rt == RT_CMD) & (it == int(MI.PUBLISH))
    msg_del = valid & (vt_ == VT_MSG) & (rt == RT_CMD) & (it == int(MI.DELETE))
    ms_open = valid & (vt_ == VT_MSUB) & (rt == RT_CMD) & (it == int(MS.OPEN))
    ms_close = valid & (vt_ == VT_MSUB) & (rt == RT_CMD) & (it == int(MS.CLOSE))
    wisub_corr = (
        valid & (vt_ == VT_WISUB) & (rt == RT_CMD) & (it == int(WS.CORRELATE))
    )

    # the three element-instance lookups (record key / scope key / job
    # activity key) and the job lookup resolve through the direct-mapped
    # indexes, verified against the key columns, with hashmap fallback
    keys3 = torch.cat([batch.key, batch.scope_key, batch.aux_key])
    want3 = torch.cat(
        [wi_ev, wi_ev & (batch.scope_key >= 0), job_ev | timer_cmd | wisub_corr]
    )
    # The timer, subscription and stored-message maps' probes (as the maps
    # were before this step: their inserts and deletes come after every
    # read) share the fallbacks' launch
    probes = []
    if graph.has_timers:
        probes.append((state.timer_map, batch.key, timer_cmd & (batch.key >= 0)))
    if graph.has_messages:
        # composite (message name, correlation value): the store key of
        # both the subscription and the stored-message probes
        ckey = corr_composite(batch.type_id, batch.retries, batch.worker)
        probes.append((state.msub_map, ckey, msg_pub | ms_open | ms_close))
        probes.append((state.msg_map, ckey, msg_pub | ms_open | msg_del))
    ((ei3_found, ei3_slot), (jb_found, jb_slot)), probed = _indexed_lookup_multi([
        (state.ei_index, state.ei_key, state.ei_map, keys3, want3, n_cap),
        (state.job_index, state.job_key, state.job_map,
         batch.key, job_cmd & (batch.key >= 0), m_cap),
    ], probes)
    ei_found, ei_slot = ei3_found[:b], ei3_slot[:b]
    sc_found, sc_slot = ei3_found[b : 2 * b], ei3_slot[b : 2 * b]
    aik_found, aik_slot = ei3_found[2 * b :], ei3_slot[2 * b :]
    t_cap = state.timer_key.shape[0]
    if graph.has_timers:
        tm_found, tm_slot = probed.pop(0)
    else:
        tm_found, tm_slot = zeros_b(), zeros_b(_I32)
    ms_cap = state.msub_ckey.shape[0]
    mg_cap = state.msg_key.shape[0]
    if graph.has_messages:
        (msub_found, msub_slot), (mmsg_found, mmsg_slot) = probed
        msub_clip = msub_slot.clamp(0, ms_cap - 1)
        mmsg_clip = mmsg_slot.clamp(0, mg_cap - 1)
    ei_clip = ei_slot.clamp(0, n_cap - 1)
    sc_clip = sc_slot.clamp(0, n_cap - 1)
    aik_clip = aik_slot.clamp(0, n_cap - 1)
    jb_clip = jb_slot.clamp(0, m_cap - 1)
    tm_clip = tm_slot.clamp(0, t_cap - 1)

    # ONE fused gather feeds every phase-B/C state read (the timer and
    # message slices add the timer rows, the store rows and the named
    # instance's int64 and payload rows; the boundary slice the record's
    # own instance's)
    b_reads = {
        "ei": (state.ei_i32, ei_clip), "sc": (state.ei_i32, sc_clip),
        "aik": (state.ei_i32, aik_clip), "sc_pay": (state.ei_pay, sc_clip),
        "jb_i32": (state.job_i32, jb_clip), "jb_i64": (state.job_i64, jb_clip),
        "jb_pay": (state.job_pay, jb_clip),
    }
    if graph.has_timers:
        b_reads["tm_elem"] = (state.timer_elem, tm_clip)
        b_reads["tm_wf"] = (state.timer_wf, tm_clip)
    if graph.has_timers or graph.has_messages:
        b_reads["aik_i64"] = (state.ei_i64, aik_clip)
        b_reads["aik_pay"] = (state.ei_pay, aik_clip)
    if graph.has_boundaries:
        b_reads["ei_i64"] = (state.ei_i64, ei_clip)
        b_reads["ei_pay"] = (state.ei_pay, ei_clip)
    if graph.has_messages:
        b_reads["mmsg_i32"] = (state.msg_i32, mmsg_clip)
        b_reads["mmsg_key"] = (state.msg_key, mmsg_clip)
        b_reads["mmsg_pay"] = (state.msg_pay, mmsg_clip)
        b_reads["msub_i32"] = (state.msub_i32, msub_clip)
        b_reads["msub_i64"] = (state.msub_i64, msub_clip)
    rd = _gather_named(b_reads)
    ei_rows, sc_rows, aik_rows, sc_pay_rows = rd["ei"], rd["sc"], rd["aik"], rd["sc_pay"]
    jb_i32_rows, jb_i64_rows, jb_pay_rows = rd["jb_i32"], rd["jb_i64"], rd["jb_pay"]
    inst_state = torch.where(ei_found, ei_rows[:, EI_STATE], -1)
    scope_state = torch.where(sc_found, sc_rows[:, EI_STATE], -1)

    # the handler element of a timer comes from the timer table (a
    # host-staged TRIGGER command carries no element columns)
    if graph.has_timers:
        trig_elem = torch.where(tm_found, rd["tm_elem"], batch.elem)
        trig_wf = torch.where(tm_found, rd["tm_wf"], 0)

    # second-level reads through slots that exist only after the first pass
    # lands — one more fused gather: the scope-of-scope keys and, with
    # their gates on, the graph rows of the elements the gathered rows name
    # (a trigger's handler element, a correlated instance's boundaries, a
    # scope's cardinality)
    scope_parent = torch.where(sc_found, sc_rows[:, EI_SCOPE], -1)
    inst_scope_slot = aik_rows[:, EI_SCOPE]
    ei_key = state.ei_key
    l2_reads = {
        "sp_key": (ei_key, scope_parent.clamp(0, n_cap - 1)),
        "is_key": (ei_key, inst_scope_slot.clamp(0, n_cap - 1)),
    }
    if graph.has_timers and graph.has_boundaries:
        trig_idx = (trig_wf.clamp(0, n_wfs - 1) * n_elems
                    + trig_elem.clamp(0, n_elems - 1))
        l2_reads["trig_is_bd"] = (graph.bd_is_boundary.reshape(-1), trig_idx)
        l2_reads["trig_int"] = (graph.bd_host_interrupt.reshape(-1), trig_idx)
    if graph.has_messages and graph.has_boundaries:
        # the correlated instance's element (0 when it is not found)
        ci_idx = (torch.where(aik_found, aik_rows[:, EI_WF], 0).clamp(0, n_wfs - 1)
                  * n_elems
                  + torch.where(aik_found, aik_rows[:, EI_ELEM], 0).clamp(0, n_elems - 1))
        l2_reads["ci_bd_count"] = (graph.bd_count.reshape(-1), ci_idx)
        for name in ("bd_msg", "bd_elem", "bd_interrupt"):
            l2_reads["ci_" + name] = (getattr(graph, name).reshape(-1, bdw), ci_idx)
    if graph.has_multi_instance:
        # the scope's element (0 when it is not found)
        sc_idx = (torch.where(sc_found, sc_rows[:, EI_WF], 0).clamp(0, n_wfs - 1)
                  * n_elems
                  + torch.where(sc_found, sc_rows[:, EI_ELEM], 0).clamp(0, n_elems - 1))
        l2_reads["sc_mi_card"] = (graph.mi_cardinality.reshape(-1), sc_idx)
    l2 = _gather_named(l2_reads)
    scope_parent_key = torch.where(scope_parent >= 0, l2["sp_key"], -1)
    inst_scope_key = torch.where(inst_scope_slot >= 0, l2["is_key"], -1)

    # ---------------- B. routing + guards ----------------
    device_spans.phase("step.routing")
    m_create = wi_cmd & (it == int(WI.CREATE)) & (batch.wf >= 0)
    m_created_ev = wi_ev & (it == int(WI.CREATED))

    g_own = (
        (it == int(WI.ELEMENT_READY))
        | (it == int(WI.ELEMENT_ACTIVATED))
        | (it == int(WI.ELEMENT_COMPLETING))
    )
    g_flow = (
        (it == int(WI.END_EVENT_OCCURRED))
        | (it == int(WI.GATEWAY_ACTIVATED))
        | (it == int(WI.START_EVENT_OCCURRED))
        | (it == int(WI.SEQUENCE_FLOW_TAKEN))
        | (it == int(WI.BOUNDARY_EVENT_OCCURRED))
    )
    pending_bd = torch.where(ei_found, ei_rows[:, EI_PENDING_BD], -1)
    scope_activated = scope_state == int(WI.ELEMENT_ACTIVATED)
    scope_terminating = scope_state == int(WI.ELEMENT_TERMINATING)
    guard = torch.where(
        g_own,
        ei_found & (inst_state == it),
        torch.where(
            it == int(WI.ELEMENT_COMPLETED),
            sc_found & scope_activated,
            torch.where(
                it == int(WI.ELEMENT_TERMINATED),
                sc_found & torch.where(
                    pending_bd >= 0,
                    scope_activated | scope_terminating,
                    scope_terminating,
                ),
                torch.where(g_flow, sc_found & scope_activated, True),
            ),
        ),
    )
    shall = ei_found | sc_found
    stepped = (
        wi_ev & ~m_created_ev & shall & guard
        & (batch.wf >= 0) & (batch.elem >= 0)
    )
    # per-row intent select from the gathered step row
    it_c = it.clamp(0, n_intents - 1).to(_I64)
    step_id = torch.where(
        stepped, torch.gather(step_row, 1, it_c[:, None])[:, 0], int(BS.NONE)
    )

    def m_step(s):
        return stepped & (step_id == int(s))

    m_take = m_step(BS.TAKE_SEQUENCE_FLOW)
    m_consume = m_step(BS.CONSUME_TOKEN)
    m_xsplit = m_step(BS.EXCLUSIVE_SPLIT)
    m_createjob = m_step(BS.CREATE_JOB)
    m_inmap = m_step(BS.APPLY_INPUT_MAPPING)
    m_outmap = m_step(BS.APPLY_OUTPUT_MAPPING)
    m_actgw = m_step(BS.ACTIVATE_GATEWAY)
    m_startst = m_step(BS.START_STATEFUL_ELEMENT)
    m_trigend = m_step(BS.TRIGGER_END_EVENT)
    m_trigstart = m_step(BS.TRIGGER_START_EVENT)
    m_complete_proc = m_step(BS.COMPLETE_PROCESS)
    m_psplit = m_step(BS.PARALLEL_SPLIT)
    m_timer_step = m_step(BS.CREATE_TIMER)
    m_subscribe = m_step(BS.SUBSCRIBE_TO_INTERMEDIATE_MESSAGE)
    m_term_job = m_step(BS.TERMINATE_JOB_TASK)
    m_term_catch = m_step(BS.TERMINATE_CATCH_EVENT)
    m_term_elem = m_step(BS.TERMINATE_ELEMENT)
    m_mi = m_step(BS.MULTI_INSTANCE_SPLIT)

    # job commands
    job_state = torch.where(jb_found, jb_i32_rows[:, JB_STATE], -1)
    m_jcreate = job_cmd & (it == int(JI.CREATE))
    m_jactivate = job_cmd & (it == int(JI.ACTIVATE))
    m_jcomplete = job_cmd & (it == int(JI.COMPLETE))
    m_jfail = job_cmd & (it == int(JI.FAIL))
    m_jtimeout = job_cmd & (it == int(JI.TIME_OUT))
    m_jretries = job_cmd & (it == int(JI.UPDATE_RETRIES))
    m_jcancel = job_cmd & (it == int(JI.CANCEL))

    activatable = (
        (job_state == int(JI.CREATED))
        | (job_state == int(JI.FAILED))
        | (job_state == int(JI.TIMED_OUT))
    )
    completable = (job_state == int(JI.ACTIVATED)) | (job_state == int(JI.TIMED_OUT))
    is_activated = jb_found & (job_state == int(JI.ACTIVATED))
    is_failed = jb_found & (job_state == int(JI.FAILED))
    jact_ok = m_jactivate & jb_found & activatable
    jact_rej = m_jactivate & ~(jb_found & activatable)
    jcomp_ok = m_jcomplete & jb_found & completable
    jcomp_rej = m_jcomplete & ~(jb_found & completable)
    jfail_ok = m_jfail & is_activated
    jfail_rej = m_jfail & ~is_activated
    jtime_ok = m_jtimeout & is_activated
    jtime_rej = m_jtimeout & ~is_activated
    jret_ok = m_jretries & is_failed & (batch.retries > 0)
    jret_badv = m_jretries & is_failed & (batch.retries <= 0)
    jret_rej = m_jretries & ~is_failed
    jcan_ok = m_jcancel & jb_found
    jcan_rej = m_jcancel & ~jb_found

    # job events (workflow-side processors + activation pool + incidents)
    jev_created = job_ev & (it == int(JI.CREATED))
    jev_completed = job_ev & (it == int(JI.COMPLETED)) & aik_found
    m_actpool = job_ev & (
        (it == int(JI.CREATED))
        | (it == int(JI.TIMED_OUT))
        | (it == int(JI.FAILED))
        | (it == int(JI.RETRIES_UPDATED))
    ) & (batch.retries > 0)
    jev_fail_noretry = job_ev & (it == int(JI.FAILED)) & (batch.retries <= 0)

    # timer commands (with has_timers off there is no timer table: a
    # TRIGGER finds no timer and is rejected; TRIGGER-ok and CANCEL-ok
    # never fire)
    m_tcreate = timer_cmd & (it == int(TI.CREATE))
    m_ttrigger = timer_cmd & (it == int(TI.TRIGGER))
    ttrig_ok = m_ttrigger & tm_found
    ttrig_rej = m_ttrigger & ~tm_found
    zb = zeros_b()
    ttrig_catch = ttrig_bd_int = ttrig_bd_non = zb
    aik_active = aik_found & (
        torch.where(aik_found, aik_rows[:, EI_STATE], -1) == int(WI.ELEMENT_ACTIVATED)
    )
    if graph.has_timers:
        # two CANCELs for one timer key may share a batch; the oracle pops
        # the timer on the first and the second is a silent no-op, while
        # tm_found sees the pre-step table: only the FIRST cancel row per
        # key stays eligible
        m_tcancel = timer_cmd & (it == int(TI.CANCEL))
        tcan_ok = m_tcancel & tm_found & _first_per_key(batch.key, m_tcancel)
        # a trigger resumes its instance while it is still active
        ttrig_inst = ttrig_ok & aik_active
        ttrig_catch = ttrig_inst
        if graph.has_boundaries:
            # boundary-event triggers: the handler element is a BOUNDARY
            # event attached to the instance's element (oracle
            # _boundary_for + _fire_boundary_event); interrupting ones
            # terminate the host and continue at the boundary when
            # ELEMENT_TERMINATED processes
            trig_is_bd = l2["trig_is_bd"]
            ttrig_catch = ttrig_inst & ~trig_is_bd
            ttrig_bd = ttrig_inst & trig_is_bd
            ttrig_bd_int = ttrig_bd & l2["trig_int"]
            ttrig_bd_non = ttrig_bd & ~l2["trig_int"]
    # arming/disarming rides the host element's lifecycle events (oracle
    # _arm_boundary_events / _disarm_boundary_events); TERMINATED with a
    # pending boundary continues the token at the boundary element
    m_arm = m_disarm_bd = m_bd_continue = zb
    if graph.has_boundaries:
        bd_n = emeta[:, graph_mod.EM_BD_COUNT]
        has_bd = bd_n > 0
        m_arm = stepped & (it == int(WI.ELEMENT_ACTIVATED)) & has_bd
        m_disarm_bd = stepped & (
            (it == int(WI.ELEMENT_COMPLETING)) | (it == int(WI.ELEMENT_TERMINATING))
        ) & has_bd
        m_bd_continue = stepped & (it == int(WI.ELEMENT_TERMINATED)) & (pending_bd >= 0)

    # message correlation guards (oracle: _process_message_command /
    # _process_message_subscription / _process_wi_subscription)
    pub_ok = open_ok = corr_inst_ok = corr_bd_int = corr_bd_non = zb
    corr_bd_elem = full_b(-1, _I32)
    if graph.has_messages:
        msgid = batch.aux2_key.to(_I32)  # interned message id, 0 none
        pub_dup = (msg_pub & mmsg_found & (msgid > 0)
                   & (rd["mmsg_i32"][:, MG_MSGID] == msgid))
        # one live slot per composite (the store is hashmap-keyed): a
        # second TTL store or OPEN on an occupied composite is REJECTED
        with_ttl = batch.deadline > 0  # the TTL rides the deadline column
        pub_chain = msg_pub & ~pub_dup & with_ttl & mmsg_found
        pub_ok = msg_pub & ~pub_dup & ~pub_chain
        pub_store = pub_ok & with_ttl
        pub_nostore = pub_ok & ~with_ttl
        pub_corr = pub_ok & msub_found
        open_dup = ms_open & msub_found
        open_ok = ms_open & ~msub_found
        open_corr = open_ok & mmsg_found
        msub_i64_rows = rd["msub_i64"]
        close_ok = (
            ms_close & msub_found
            & (msub_i64_rows[:, MSL_AIK] == batch.aux_key)
            & (msub_i64_rows[:, MSL_WIKEY] == batch.instance_key)
        )
        del_ok = msg_del & mmsg_found & (rd["mmsg_key"] == batch.key)
        corr_live = wisub_corr & aik_active
        corr_rej = wisub_corr & ~corr_live
        corr_is_bd = zb
        if graph.has_boundaries:
            # a boundary-message correlate: the message name matches one of
            # the instance element's attached boundary events (the first)
            bd_cnt_i = l2["ci_bd_count"]
            ci_msg, ci_elem, ci_int = l2["ci_bd_msg"], l2["ci_bd_elem"], l2["ci_bd_interrupt"]
            corr_bd_interrupt = zb
            for bslot in range(bdw):
                match_b = (
                    (bslot < bd_cnt_i) & (ci_msg[:, bslot] == batch.type_id)
                    & (ci_msg[:, bslot] > 0) & (corr_bd_elem < 0)
                )
                corr_bd_elem = torch.where(match_b, ci_elem[:, bslot], corr_bd_elem)
                corr_bd_interrupt = torch.where(match_b, ci_int[:, bslot], corr_bd_interrupt)
            corr_is_bd = corr_live & (corr_bd_elem >= 0)
            corr_bd_int = corr_is_bd & corr_bd_interrupt
            corr_bd_non = corr_is_bd & ~corr_bd_interrupt
        corr_inst_ok = corr_live & ~corr_is_bd
        # the subscribe step's correlation key, from the payload column
        corr_vt_ext, corr_bits_ext, corr_extractable = _corr_cols(
            batch, emeta[:, graph_mod.EM_CORR_VAR]
        )
        sub_ok = m_subscribe & corr_extractable
        sub_err = m_subscribe & ~corr_extractable

    # ---------------- C. per-step compute ----------------
    device_spans.phase("step.compute")
    # exclusive split: the first conditioned flow whose program is TRUE,
    # else the default flow; an ERROR before the first TRUE is an incident
    default_f = emeta[:, graph_mod.EM_DEFAULT_FLOW]
    if graph.has_conditions:
        tri = eval_programs(
            graph.progs, graph.lit_nums, cprog,
            batch.v_vt[:, None, :].expand(b, cond_fan, v),
            batch.v_num[:, None, :].expand(b, cond_fan, v),
            batch.v_str[:, None, :].expand(b, cond_fan, v),
        )
        tri = torch.where(cprog >= 0, tri, -1)
        fidx = torch.arange(cond_fan, dtype=_I32, device=dev)
        first_true = torch.min(torch.where(tri == TRI_TRUE, fidx, cond_fan), dim=1).values
        first_err = torch.min(torch.where(tri == TRI_ERROR, fidx, cond_fan), dim=1).values
        cond_errored = first_err < first_true
        picked = torch.gather(
            cflow, 1, first_true.clamp(0, cond_fan - 1).to(_I64)[:, None]
        )[:, 0]
        taken_flow = torch.where(first_true < cond_fan, picked, default_f)
        xs_ok = m_xsplit & ~cond_errored & (taken_flow >= 0)
        xs_nofl = m_xsplit & ~cond_errored & (taken_flow < 0)
        xs_err = m_xsplit & cond_errored
    else:
        taken_flow = default_f
        xs_ok = m_xsplit & (taken_flow >= 0)
        xs_nofl = m_xsplit & (taken_flow < 0)
        xs_err = zeros_b()

    # input mapping (identity pass-through when none is deployed)
    if graph.has_mappings:
        in_from, in_err = _apply_mappings(in_src, in_dst, batch.v_vt)
        in_has = emeta[:, graph_mod.EM_IN_MAP_N] > 0
        in_root = emeta[:, graph_mod.EM_IN_ROOT] != 0
        im_vt, im_num, im_sid = _select_by_map(in_from, batch.v_vt, batch.v_num, batch.v_str)
        sel_in = (in_has & ~in_root)[:, None]
        in_vt = torch.where(sel_in, im_vt, batch.v_vt)
        in_num = torch.where(sel_in, im_num, batch.v_num)
        in_sid = torch.where(sel_in, im_sid, batch.v_str)
        inmap_ok = m_inmap & ~(in_has & in_err)
        inmap_err = m_inmap & in_has & in_err
    else:
        in_vt, in_num, in_sid = batch.v_vt, batch.v_num, batch.v_str
        inmap_ok = m_inmap
        inmap_err = zeros_b()

    # output mapping: merge record payload → scope payload
    scope_vt, scope_sid, scope_num = unpack_payload(sc_pay_rows)
    scope_vt = torch.where(sc_found[:, None], scope_vt.to(torch.int8), VT_ABSENT)
    behavior = emeta[:, graph_mod.EM_OUT_BEHAVIOR]
    B_OVERWRITE, B_NONE = 1, 2
    src_present = batch.v_vt != VT_ABSENT
    overwrite = (behavior == B_OVERWRITE)[:, None]
    keep_scope = (behavior == B_NONE)[:, None]
    if graph.has_mappings:
        out_from, out_err = _apply_mappings(out_src, out_dst, batch.v_vt)
        out_has = emeta[:, graph_mod.EM_OUT_MAP_N] > 0
        out_root = emeta[:, graph_mod.EM_OUT_ROOT] != 0
        om_vt, om_num, om_sid = _select_by_map(out_from, batch.v_vt, batch.v_num, batch.v_str)
        outmap_ok = m_outmap & ~(out_has & out_err)
        outmap_err = m_outmap & out_has & out_err
    else:
        om_vt = om_num = om_sid = None
        outmap_ok = m_outmap
        outmap_err = zeros_b()

    def _merge_one(scope_a, src_a, mapped_a, fill):
        without = torch.where(
            overwrite, src_a, torch.where(src_present, src_a, scope_a)
        )
        if graph.has_mappings:
            with_maps = torch.where(
                out_from >= 0, mapped_a, torch.where(overwrite, fill, scope_a)
            )
            without = torch.where(
                (out_has & ~out_root)[:, None], with_maps,
                torch.where(out_root[:, None], src_a, without),
            )
        return torch.where(keep_scope, scope_a, without)

    out_vt = _merge_one(scope_vt, batch.v_vt, om_vt, VT_ABSENT)
    out_num = _merge_one(scope_num, batch.v_num, om_num, 0.0)
    out_sid = _merge_one(scope_sid, batch.v_str, om_sid, 0)

    # parallel join: composite key (scope_key, gateway element); the join
    # tables and map are updated IN PLACE (no later read wants their old
    # values)
    if graph.has_parallel_joins:
        m_pmerge = m_step(BS.PARALLEL_MERGE)
        gw_elem = emeta[:, graph_mod.EM_FLOW_TGT]
        gw_clip = gw_elem.clamp(0, n_elems - 1)
        stamp, jmap = state.join_pos_stamp, state.join_map
        j_cap = state.join_key.shape[0]
        join_key = torch.where(m_pmerge, (batch.scope_key << 10) | gw_clip.to(_I64), -1)
        jn_found, _jn_slot = ops.lookup(jmap, join_key, m_pmerge)
        # leaders: first batch occurrence of each missing join key (sort-dedup)
        missing = m_pmerge & ~jn_found
        sort_k = torch.where(missing, join_key, 2**62)
        sorted_k, order = torch.sort(sort_k, stable=True)
        first_occ = torch.cat(
            [torch.ones((1,), dtype=_BOOL, device=dev), sorted_k[1:] != sorted_k[:-1]]
        )
        leader = zeros_b()
        leader[order] = first_occ
        leader = leader & missing
        # allocate join slots for leaders
        join_free = _first_true_indices(state.join_key < 0, b)
        l_rank = _excl_cumsum(leader)
        l_slot = join_free[l_rank.clamp(0, b - 1).to(_I64)]
        join_overflow = torch.any(leader & (l_slot >= j_cap))
        ops.masked_vec64_update(state.join_key, l_slot, leader, join_key)
        nin_here = graph.join_nin[wf_c.to(_I64), gw_clip.to(_I64)]
        ops.masked_lane_update(state.join_nin, l_slot, leader, nin_here)
        ops.insert(jmap, join_key, l_slot, leader)
        # re-lookup so every arrival sees its slot
        jn_found2, jn_slot2 = ops.lookup(jmap, join_key, m_pmerge)
        arr_slot = jn_slot2.clamp(0, j_cap - 1)
        arr_idx = arr_slot.to(_I64)
        my_pos = emeta[:, graph_mod.EM_JOIN_POS]
        arrival = m_pmerge & jn_found2
        aw = torch.where(arrival, arr_slot, j_cap)
        # dynamic column one-hot; arrivals are monotonic so a row MAX
        # composes concurrent arrivals at the same join slot (the flags stay
        # int32 until the cleanup below: JAX's bool round trips are exact)
        f_in = state.join_arrived.shape[1]
        fcols = torch.arange(f_in, dtype=_I32, device=dev)
        pos_hot = fcols[None, :] == my_pos.clamp(0, f_in - 1)[:, None]
        arrived = state.join_arrived.to(_I32)
        # with the flow-position-stamped payload merge (higher flow pos wins
        # per variable): two row maxima into two tables, neither reading
        # the other's result, so one launch takes both
        ops.fused_accumulate([arrived, stamp], [
            ops.TableOp(0, "max", arr_slot, arrival, pos_hot.to(_I32)),
            ops.TableOp(1, "max", arr_slot, arrival,
                        torch.where(src_present, my_pos[:, None], -1)),
        ])
        win_var = m_pmerge[:, None] & src_present & (
            stamp[aw.clamp(0, j_cap - 1).to(_I64)] == my_pos[:, None]
        )
        win3 = torch.cat([win_var, win_var, win_var], dim=1)
        b_pay_join = pack_payload(batch.v_vt, batch.v_str, batch.v_num)
        ops.masked_row_update(state.join_pay, arr_slot, arrival, b_pay_join, win3)
        # completion: all incoming arrived; completer = last arrival in batch
        arr_count = torch.sum(arrived != 0, dim=1, dtype=_I32)
        complete_slot = (state.join_nin > 0) & (arr_count >= state.join_nin)
        my_complete = m_pmerge & jn_found2 & complete_slot[arr_idx]
        completer = _last_writer(arr_slot, my_complete, j_cap)
        # merged payload for the completer
        mg_vt, mg_sid, mg_num = unpack_payload(state.join_pay[arr_idx])
        mg_vt = mg_vt.to(torch.int8)
    else:
        arr_slot = zeros_b(_I32)  # no joins: every record reads join slot 0

    # ---------------- D. key assignment ----------------
    device_spans.phase("step.keys")
    out_count = emeta[:, graph_mod.EM_OUT_COUNT]
    single_key = (
        m_create | m_take | xs_ok | m_actgw | m_startst | m_trigend
        | m_trigstart | m_tcreate
    )
    if graph.has_parallel_joins:
        single_key = single_key | completer
    if graph.has_messages:
        single_key = single_key | pub_ok | open_ok
    if graph.has_boundaries:
        single_key = single_key | ttrig_bd_non | m_bd_continue | corr_bd_non
    n_wf = torch.where(
        single_key, 1,
        torch.where(
            m_psplit, out_count,
            torch.where(m_mi, emeta[:, graph_mod.EM_MI_CARD], 0),
        ),
    ).to(_I32)
    wf_base = state.next_wf_key + _KEY_STEP * _excl_cumsum(n_wf).to(_I64)
    key0 = wf_base  # key for single-allocation steps
    n_job = m_jcreate.to(_I32)
    job_base = state.next_job_key + _KEY_STEP * _excl_cumsum(n_job).to(_I64)
    next_wf_key = state.next_wf_key + _KEY_STEP * torch.sum(n_wf, dtype=_I64)
    next_job_key = state.next_job_key + _KEY_STEP * torch.sum(n_job, dtype=_I64)

    # ---------------- job activation pool ----------------
    # candidate subscription: first valid sub of the job's type with credit
    sub_match = (
        state.sub_valid[None, :]
        & (state.sub_type[None, :] == batch.type_id[:, None])
        & (state.sub_credits[None, :] > 0)
    )  # [B, S]
    cand = torch.argmax(sub_match.to(_I32), dim=1).to(_I32)
    has_sub = torch.any(sub_match, dim=1)
    pool = m_actpool & has_sub
    # per subscription: the first `credits` pool rows (in batch order) win —
    # one rank scan per subscription, all subscriptions at once, laid out
    # [S, B] so each scan runs along the contiguous inner dimension
    s_iota = torch.arange(s_cap, dtype=_I32, device=dev)
    pool_oh = pool[None, :] & (cand[None, :] == s_iota[:, None])  # [S, B]
    pool_i = pool_oh.to(_I32)
    rank_s = torch.cumsum(pool_i, 1, dtype=_I32) - pool_i
    act_oh = pool_oh & (rank_s < state.sub_credits[:, None])
    activated = torch.any(act_oh, dim=0)
    sub_credits = state.sub_credits - torch.sum(act_oh, dim=1, dtype=_I32)
    cand_c = cand.clamp(0, s_cap - 1)
    cand_oh = s_iota[None, :] == cand_c[:, None]
    act_deadline = now + torch.sum(
        torch.where(cand_oh, state.sub_timeout[None, :], 0), dim=1
    )
    act_worker = torch.sum(torch.where(cand_oh, state.sub_worker[None, :], 0), dim=1)
    act_stream = torch.sum(
        torch.where(cand_oh, state.sub_key[None, :], 0), dim=1
    ).to(_I32)
    # credit return on activate rejection
    ret_match = state.sub_key[None, :] == batch.req_stream[:, None].to(_I64)
    ret_idx = torch.argmax(ret_match.to(_I32), dim=1).to(_I64)
    ret_has = torch.any(ret_match, dim=1)
    ret_w = torch.where(jact_rej & ret_has, ret_idx, s_cap)
    ret_add = torch.zeros((s_cap + 1,), dtype=_I32, device=dev)
    ret_add.index_add_(0, ret_w, torch.ones((b,), dtype=_I32, device=dev))
    sub_credits = sub_credits + ret_add[:s_cap]

    # ---------------- E. emissions ----------------
    device_spans.phase("step.emit")
    def blank() -> Dict[str, torch.Tensor]:
        return {
            "valid": zeros_b(),
            "rtype": zeros_b(_I32),
            "vtype": zeros_b(_I32),
            "intent": zeros_b(_I32),
            "key": full_b(-1, _I64),
            "elem": full_b(-1, _I32),
            "wf": batch.wf,
            "instance_key": batch.instance_key,
            "scope_key": batch.scope_key,
            "v_vt": batch.v_vt,
            "v_num": batch.v_num,
            "v_str": batch.v_str,
            "req": full_b(-1, _I64),
            "req_stream": full_b(-1, _I32),
            "aux_key": full_b(-1, _I64),
            "aux2_key": full_b(-1, _I64),
            "type_id": zeros_b(_I32),
            "retries": zeros_b(_I32),
            "deadline": full_b(-1, _I64),
            "worker": zeros_b(_I32),
            "src": rows,
            "resp": zeros_b(),
            "push": zeros_b(),
            "rej": zeros_b(_I32),
        }

    e0 = blank()
    e1 = blank()
    resp = batch.req >= 0
    # emission slots >= 2 materialize on first use (messages, boundary
    # arm/disarm); rows claiming one slot index have disjoint masks, so
    # compaction keeps slot order = the oracle's append order
    extra_slots: Dict[int, Dict[str, torch.Tensor]] = {}

    def eslot(i: int) -> Dict[str, torch.Tensor]:
        if i < 2:
            return (e0, e1)[i]
        if i not in extra_slots:
            extra_slots[i] = blank()
        return extra_slots[i]

    pid_col = full_b(partition_id, _I32)

    # --- slot 0: workflow-instance emissions
    scope_elem = torch.where(sc_found, sc_rows[:, EI_ELEM], -1)
    _put(
        e0, m_create,
        valid=True, rtype=RT_EVENT, vtype=VT_WI, intent=int(WI.CREATED),
        key=key0, elem=0, instance_key=key0, scope_key=-1,
        req=batch.req, req_stream=batch.req_stream, resp=resp,
    )
    _put(
        e1, m_create,
        valid=True, rtype=RT_EVENT, vtype=VT_WI, intent=int(WI.ELEMENT_READY),
        key=key0, elem=0, instance_key=key0, scope_key=-1,
    )
    first_out = emeta[:, graph_mod.EM_FIRST_OUT]
    _put(
        e0, m_take,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.SEQUENCE_FLOW_TAKEN), key=key0, elem=first_out,
    )
    # consume token: the last consumed token completes the scope
    tok_delta = torch.zeros((n_cap + 1,), dtype=_I32, device=dev)
    tok_delta.index_add_(
        0, torch.where(m_consume, sc_clip, n_cap).to(_I64),
        torch.full((b,), -1, dtype=_I32, device=dev),
    )
    tokens_after = tok_delta[:n_cap] + state.ei_tokens
    # the remaining 1D state reads — the post-consume token count per
    # scope, the join fan-in, the two free-slot ring pops — share ONE gather
    ins_replay = m_created_ev & ~ei_found
    ins = m_create | m_startst | ins_replay
    ins_rank = _excl_cumsum(ins)
    ei_pop_idx = state.free_ei_pop + ins_rank.to(_I64)
    ei_ring_ok = ei_pop_idx < state.free_ei_push
    job_ins = m_jcreate
    j_rank = _excl_cumsum(job_ins)
    job_pop_idx = state.free_job_pop + j_rank.to(_I64)
    job_ring_ok = job_pop_idx < state.free_job_push
    rp_reads = {
        "tok": (tokens_after, sc_clip),
        "nin": (state.join_nin, arr_slot),
        "ei_pop": (state.free_ei, (ei_pop_idx % n_cap).to(_I32)),
        "job_pop": (state.free_job, (job_pop_idx % m_cap).to(_I32)),
    }
    if graph.has_boundaries:
        # TERMINATE_JOB_TASK cancels the instance's job: its type through
        # the job map (the probe's keys are the gathered job keys, so it
        # cannot join the step's first lookup launch)
        job_key_inst = torch.where(ei_found, rd["ei_i64"][:, EIL_JOB_KEY], -1)
        mask_jcancel = m_term_job & (job_key_inst > 0)
        tj_found, tj_slot = ops.lookup(state.job_map, job_key_inst, mask_jcancel)
        rp_reads["tj_type"] = (state.job_type, tj_slot.clamp(0, m_cap - 1))
        # the disarm's and TERMINATE_CATCH_EVENT's scans of the armed
        # timers by activity instance key, and the found timers' columns
        disarm_idx, tcan_idx = _armed_timer_slots(
            state, batch.key, [m_disarm_bd, m_term_catch], bdw
        )
        timer_cols = {"key": state.timer_key, "due": state.timer_due,
                      "ik": state.timer_instance_key, "elem": state.timer_elem}
        for tag, idxs in (("c", disarm_idx), ("tc", tcan_idx)):
            for j, idx in enumerate(idxs):
                for col, table in timer_cols.items():
                    rp_reads[f"{tag}{j}_{col}"] = (table, idx.clamp(0, t_cap - 1))
    rp = _gather_named(rp_reads)
    tok_after_sc, nin_rec = rp["tok"], rp["nin"]
    ei_pop_slot, job_pop_slot = rp["ei_pop"], rp["job_pop"]
    consume_done = m_consume & (tok_after_sc <= 0)
    consume_completer = _last_writer(sc_clip, consume_done, n_cap)
    _put(
        e0, consume_completer,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.ELEMENT_COMPLETING), key=batch.scope_key, elem=scope_elem,
        scope_key=scope_parent_key,
    )
    if graph.has_multi_instance:
        # a completing multi-instance container keeps ITS OWN payload (the
        # oracle never copies iteration payloads into an MI scope)
        mi_scope = l2["sc_mi_card"] > 0
        sc_vt, sc_sid, sc_num = unpack_payload(sc_pay_rows)
        _put_payload(e0, consume_completer & mi_scope, sc_vt, sc_num, sc_sid)
    _put(
        e0, xs_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.SEQUENCE_FLOW_TAKEN), key=key0, elem=taken_flow,
    )
    _put(
        e0, xs_nofl | xs_err,
        valid=True, rtype=RT_CMD, vtype=VT_INCIDENT, intent=0,  # IncidentIntent.CREATE
        key=-1, elem=batch.elem, aux_key=batch.key,
        rej=torch.where(xs_nofl, rb.ERR_CONDITION_NO_FLOW, rb.ERR_CONDITION_EVAL),
    )
    # rows on boundary-carrying elements re-slot their own step output
    # AFTER the arm/disarm records (the oracle writes arms/cancels first)
    createjob_here, outmap_here = m_createjob, outmap_ok
    if graph.has_boundaries:
        createjob_here, outmap_here = m_createjob & ~has_bd, outmap_ok & ~has_bd
    _put(
        e0, createjob_here,
        valid=True, rtype=RT_CMD, vtype=VT_JOB, intent=int(JI.CREATE),
        key=-1, elem=batch.elem, aux_key=batch.key,
        type_id=emeta[:, graph_mod.EM_JOB_TYPE],
        retries=emeta[:, graph_mod.EM_JOB_RETRIES],
    )
    _put(
        e0, inmap_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.ELEMENT_ACTIVATED), key=batch.key, elem=batch.elem,
    )
    if graph.has_mappings:
        _put_payload(e0, inmap_ok, in_vt, in_num, in_sid)
    _put(
        e0, outmap_here,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.ELEMENT_COMPLETED), key=batch.key, elem=batch.elem,
    )
    _put_payload(e0, outmap_here, out_vt, out_num, out_sid)
    if graph.has_mappings:
        _put(
            e0, inmap_err | outmap_err,
            valid=True, rtype=RT_CMD, vtype=VT_INCIDENT, intent=0,
            key=-1, elem=batch.elem, aux_key=batch.key,
            rej=torch.where(inmap_err, rb.ERR_IO_MAPPING_IN, rb.ERR_IO_MAPPING_OUT),
        )
    ftarget = emeta[:, graph_mod.EM_FLOW_TGT]
    _put(
        e0, m_actgw,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.GATEWAY_ACTIVATED), key=key0, elem=ftarget,
    )
    _put(
        e0, m_startst,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.ELEMENT_READY), key=key0, elem=ftarget,
    )
    _put(
        e0, m_trigend,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.END_EVENT_OCCURRED), key=key0, elem=ftarget,
    )
    start_ev = emeta[:, graph_mod.EM_START_EV]
    _put(
        e0, m_trigstart,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.START_EVENT_OCCURRED), key=key0, elem=start_ev,
        scope_key=batch.key,
    )
    _put(
        e0, m_complete_proc,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.ELEMENT_COMPLETED), key=batch.key, elem=batch.elem,
    )
    if graph.has_parallel_joins:
        _put(
            e0, completer,
            valid=True, rtype=RT_EVENT, vtype=VT_WI,
            intent=int(WI.GATEWAY_ACTIVATED), key=key0, elem=gw_elem,
        )
        _put_payload(e0, completer, mg_vt, mg_num, mg_sid)
    _put(
        e0, m_timer_step,
        valid=True, rtype=RT_CMD, vtype=VT_TIMER, intent=int(TI.CREATE),
        key=-1, elem=batch.elem, aux_key=batch.key,
        deadline=now + timer_dur_rec,
    )

    # --- slot 0: job command results
    jrej = jact_rej | jcomp_rej | jfail_rej | jtime_rej | jret_rej | jret_badv | jcan_rej
    _put(
        e0, m_jcreate,
        valid=True, rtype=RT_EVENT, vtype=VT_JOB, intent=int(JI.CREATED),
        key=job_base, elem=batch.elem, aux_key=batch.aux_key,
        type_id=batch.type_id, retries=batch.retries,
        req=batch.req, req_stream=batch.req_stream, resp=resp,
    )
    _put(
        e0, jact_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_JOB, intent=int(JI.ACTIVATED),
        key=batch.key, elem=batch.elem, aux_key=batch.aux_key,
        type_id=batch.type_id, retries=batch.retries, deadline=batch.deadline,
        worker=batch.worker, push=True, req_stream=batch.req_stream,
    )
    if synthetic_workers:
        # bench-only instant worker: the COMPLETE lands in the slot right
        # after its ACTIVATED (e1 is never used by job-command rows)
        _put(
            e1, jact_ok,
            valid=True, rtype=RT_CMD, vtype=VT_JOB, intent=int(JI.COMPLETE),
            key=batch.key, elem=batch.elem, aux_key=batch.aux_key,
            type_id=batch.type_id, retries=batch.retries,
            worker=batch.worker, src=-1,
        )
    # completed value = stored job record + command payload
    st_elem = jb_i32_rows[:, JB_ELEM]
    st_wf = jb_i32_rows[:, JB_WF]
    st_ik = jb_i64_rows[:, JBL_IKEY]
    st_aik = jb_i64_rows[:, JBL_AIK]
    st_type = jb_i32_rows[:, JB_TYPE]
    st_retries = jb_i32_rows[:, JB_RETRIES]
    st_worker = jb_i32_rows[:, JB_WORKER]
    st_deadline = jb_i64_rows[:, JBL_DEADLINE]
    _put(
        e0, jcomp_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_JOB, intent=int(JI.COMPLETED),
        key=batch.key, elem=st_elem, wf=st_wf, instance_key=st_ik,
        aux_key=st_aik, type_id=st_type, retries=st_retries,
        worker=st_worker, deadline=st_deadline,
        req=batch.req, req_stream=batch.req_stream, resp=resp,
    )
    payload_nonempty = torch.any(batch.v_vt != VT_ABSENT, dim=1)[:, None]
    jb_vt, jb_sid, jb_num = unpack_payload(jb_pay_rows)
    jb_vt = jb_vt.to(torch.int8)
    fail_vt = torch.where(payload_nonempty, batch.v_vt, jb_vt)
    fail_num = torch.where(payload_nonempty, batch.v_num, jb_num)
    fail_sid = torch.where(payload_nonempty, batch.v_str, jb_sid)
    _put(
        e0, jfail_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_JOB, intent=int(JI.FAILED),
        key=batch.key, elem=st_elem, wf=st_wf, instance_key=st_ik,
        aux_key=st_aik, type_id=st_type, retries=batch.retries,
        worker=st_worker, deadline=st_deadline,
        req=batch.req, req_stream=batch.req_stream, resp=resp,
    )
    _put_payload(e0, jfail_ok, fail_vt, fail_num, fail_sid)
    _put(
        e0, jtime_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_JOB, intent=int(JI.TIMED_OUT),
        key=batch.key, elem=batch.elem, aux_key=batch.aux_key,
        type_id=batch.type_id, retries=batch.retries,
        deadline=batch.deadline, worker=batch.worker,
        req=batch.req, req_stream=batch.req_stream, resp=resp,
    )
    _put(
        e0, jret_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_JOB, intent=int(JI.RETRIES_UPDATED),
        key=batch.key, elem=st_elem, wf=st_wf, instance_key=st_ik,
        aux_key=st_aik, type_id=st_type, retries=batch.retries,
        worker=st_worker, deadline=st_deadline,
        req=batch.req, req_stream=batch.req_stream, resp=resp,
    )
    _put_payload(e0, jret_ok, jb_vt, jb_num, jb_sid)
    _put(
        e0, jcan_ok,
        valid=True, rtype=RT_EVENT, vtype=VT_JOB, intent=int(JI.CANCELED),
        key=batch.key, elem=batch.elem, aux_key=batch.aux_key,
        type_id=batch.type_id, retries=batch.retries,
        deadline=batch.deadline, worker=batch.worker,
        req=batch.req, req_stream=batch.req_stream, resp=resp,
    )
    # first matching code in this order (jnp.select)
    rej_code = zeros_b(_I32)
    for mask, code in reversed([
        (jact_rej, rb.REJ_JOB_NOT_ACTIVATABLE),
        (jcomp_rej, rb.REJ_JOB_NOT_COMPLETABLE),
        (jfail_rej, rb.REJ_JOB_NOT_ACTIVATED),
        (jtime_rej, rb.REJ_JOB_NOT_ACTIVATED),
        (jret_badv, rb.REJ_RETRIES_NOT_POSITIVE),
        (jret_rej, rb.REJ_JOB_NOT_FAILED),
        (jcan_rej, rb.REJ_JOB_NOT_EXIST),
    ]):
        rej_code = torch.where(mask, code, rej_code)
    _put(
        e0, jrej,
        valid=True, rtype=RT_REJ, vtype=vt_, intent=it, key=batch.key,
        elem=batch.elem, aux_key=batch.aux_key, type_id=batch.type_id,
        retries=batch.retries, deadline=batch.deadline, worker=batch.worker,
        rej=rej_code, req=batch.req, req_stream=batch.req_stream, resp=resp,
    )

    # --- slot 0: job events → workflow / activation / incident
    inst_elem = aik_rows[:, EI_ELEM]
    inst_wf = aik_rows[:, EI_WF]
    _put(
        e0, jev_completed,
        valid=True, rtype=RT_EVENT, vtype=VT_WI,
        intent=int(WI.ELEMENT_COMPLETING), key=batch.aux_key,
        elem=inst_elem, wf=inst_wf, scope_key=inst_scope_key,
    )
    _put(
        e0, activated,
        valid=True, rtype=RT_CMD, vtype=VT_JOB, intent=int(JI.ACTIVATE),
        key=batch.key, elem=batch.elem, aux_key=batch.aux_key,
        type_id=batch.type_id, retries=batch.retries,
        deadline=act_deadline, worker=act_worker, req_stream=act_stream,
    )
    # job-no-retries uses a dedicated code so the host maps the error type
    _put(
        e0, jev_fail_noretry,
        valid=True, rtype=RT_CMD, vtype=VT_INCIDENT, intent=0,
        key=-1, elem=batch.elem, aux_key=batch.aux_key,
        aux2_key=batch.key, rej=rb.ERR_JOB_NO_RETRIES,
    )

    # --- slot 0/1: timer commands
    _put(
        e0, m_tcreate,
        valid=True, rtype=RT_EVENT, vtype=VT_TIMER, intent=int(TI.CREATED),
        key=key0, elem=batch.elem, aux_key=batch.aux_key, deadline=batch.deadline,
    )
    inst_elem_wf = dict(elem=inst_elem, wf=inst_wf, scope_key=inst_scope_key)
    if graph.has_timers or graph.has_messages:
        # the named instance's own payload and workflow-instance key
        inst_vt, inst_sid, inst_num = unpack_payload(rd["aik_pay"])
        inst_ikey = rd["aik_i64"][:, EIL_IKEY]
    if graph.has_timers:
        _put(
            e0, ttrig_ok,
            valid=True, rtype=RT_EVENT, vtype=VT_TIMER, intent=int(TI.TRIGGERED),
            key=batch.key, elem=trig_elem, wf=trig_wf, aux_key=batch.aux_key,
            deadline=batch.deadline,
        )
        # the catch event completes; an interrupting boundary terminates
        # the host (the continuation fires at ELEMENT_TERMINATED); a
        # non-interrupting one puts a token on the boundary event while the
        # host keeps running (oracle _fire_boundary_event) — each with the
        # instance's own payload
        _put(
            e1, ttrig_catch,
            valid=True, rtype=RT_EVENT, vtype=VT_WI,
            intent=int(WI.ELEMENT_COMPLETING), key=batch.aux_key, **inst_elem_wf,
        )
        ttrig_any_inst = ttrig_catch
        if graph.has_boundaries:
            _put(
                e1, ttrig_bd_int,
                valid=True, rtype=RT_EVENT, vtype=VT_WI,
                intent=int(WI.ELEMENT_TERMINATING), key=batch.aux_key, **inst_elem_wf,
            )
            _put(
                e1, ttrig_bd_non,
                valid=True, rtype=RT_EVENT, vtype=VT_WI,
                intent=int(WI.BOUNDARY_EVENT_OCCURRED), key=key0,
                elem=trig_elem, wf=inst_wf, scope_key=inst_scope_key,
            )
            ttrig_any_inst = ttrig_catch | ttrig_bd_int | ttrig_bd_non
        _put_payload(e1, ttrig_any_inst, inst_vt, inst_num, inst_sid)
        _put(e1, ttrig_any_inst, instance_key=inst_ikey)
    _put(
        e0, ttrig_rej,
        valid=True, rtype=RT_REJ, vtype=vt_, intent=it, key=batch.key,
        rej=rb.REJ_TIMER_NOT_EXIST, req=batch.req, req_stream=batch.req_stream,
        resp=resp,
    )
    if graph.has_timers:
        _put(
            e0, tcan_ok,
            valid=True, rtype=RT_EVENT, vtype=VT_TIMER, intent=int(TI.CANCELED),
            key=batch.key, elem=batch.elem, aux_key=batch.aux_key,
            deadline=batch.deadline,
        )

    # --- message correlation emissions
    if graph.has_messages:
        e2 = eslot(2)
        msg_name = emeta[:, graph_mod.EM_MSG_NAME]
        corr = dict(type_id=batch.type_id, retries=batch.retries, worker=batch.worker)
        sub_open = dict(
            valid=True, rtype=RT_CMD, vtype=VT_MSUB, intent=int(MS.OPEN),
            key=-1, elem=batch.elem, type_id=msg_name,
            retries=corr_vt_ext, worker=corr_bits_ext,
            instance_key=batch.instance_key, aux_key=batch.key, wf=pid_col,
        )
        sub_incident = dict(
            valid=True, rtype=RT_CMD, vtype=VT_INCIDENT, intent=0,
            key=-1, elem=batch.elem, aux_key=batch.key, rej=rb.ERR_CORRELATION_KEY,
        )
        # subscribe step → OPEN sent to the message partition (oracle
        # _h_subscribe_to_message); a correlation-key failure → incident
        sub_ok_here, sub_err_here = sub_ok, sub_err
        if graph.has_boundaries:
            sub_ok_here, sub_err_here = sub_ok & ~has_bd, sub_err & ~has_bd
        _put(e0, sub_ok_here, **sub_open)
        _put(e0, sub_err_here, **sub_incident)
        # message partition: PUBLISH
        _put(
            e0, pub_dup | pub_chain | open_dup,
            valid=True, rtype=RT_REJ, vtype=vt_, intent=it, key=batch.key, **corr,
            instance_key=batch.instance_key, aux_key=batch.aux_key,
            aux2_key=batch.aux2_key,
            rej=torch.where(pub_dup, rb.REJ_MSG_DUP,
                            torch.where(pub_chain, rb.REJ_MSG_STORE_OCCUPIED,
                                        rb.REJ_SUB_OCCUPIED)),
            req=batch.req, req_stream=batch.req_stream, resp=resp,
        )
        _put(
            e0, pub_ok,
            valid=True, rtype=RT_EVENT, vtype=VT_MSG, intent=int(MI.PUBLISHED),
            key=key0, **corr, deadline=batch.deadline, aux2_key=batch.aux2_key,
            req=batch.req, req_stream=batch.req_stream, resp=resp,
        )
        _put(
            e1, pub_nostore,
            valid=True, rtype=RT_EVENT, vtype=VT_MSG, intent=int(MI.DELETED),
            key=key0, **corr, aux2_key=batch.aux2_key,
        )
        msub_i32_rows = rd["msub_i32"]
        _put(
            e2, pub_corr,
            valid=True, rtype=RT_CMD, vtype=VT_WISUB, intent=int(WS.CORRELATE),
            key=-1, wf=msub_i32_rows[:, MS_PART],
            instance_key=msub_i64_rows[:, MSL_WIKEY],
            aux_key=msub_i64_rows[:, MSL_AIK], **corr,
            aux2_key=pid_col,  # the message partition's id
        )
        # message partition: OPEN / CLOSE
        _put(
            e0, open_ok,
            valid=True, rtype=RT_EVENT, vtype=VT_MSUB, intent=int(MS.OPENED),
            key=key0, **corr, instance_key=batch.instance_key, aux_key=batch.aux_key,
        )
        _put(
            e1, open_corr,
            valid=True, rtype=RT_CMD, vtype=VT_WISUB, intent=int(WS.CORRELATE),
            key=-1, wf=batch.wf, instance_key=batch.instance_key,
            aux_key=batch.aux_key, **corr, aux2_key=pid_col,
        )
        stored_vt, stored_sid, stored_num = unpack_payload(rd["mmsg_pay"])
        _put_payload(e1, open_corr, stored_vt, stored_num, stored_sid)
        _put(
            e0, close_ok,
            valid=True, rtype=RT_EVENT, vtype=VT_MSUB, intent=int(MS.CLOSED),
            key=batch.key, **corr, instance_key=batch.instance_key,
            aux_key=batch.aux_key,
        )
        _put(
            e0, del_ok,
            valid=True, rtype=RT_EVENT, vtype=VT_MSG, intent=int(MI.DELETED),
            key=batch.key, **corr, aux2_key=batch.aux2_key,
        )
        # workflow partition: CORRELATE arrival (oracle
        # _process_wi_subscription) — CORRELATED, then the element completes
        # with the message payload (own catch), a boundary event fires
        # (non-interrupting keeps the subscription open), or the host
        # terminates (interrupting, with the INSTANCE payload); CLOSE goes
        # back to the message partition but for non-interrupting boundaries
        _put(
            e0, corr_live,
            valid=True, rtype=RT_EVENT, vtype=VT_WISUB, intent=int(WS.CORRELATED),
            key=batch.key, **corr, instance_key=batch.instance_key,
            aux_key=batch.aux_key,
        )
        _put(
            e1, corr_inst_ok,
            valid=True, rtype=RT_EVENT, vtype=VT_WI,
            intent=int(WI.ELEMENT_COMPLETING), key=batch.aux_key, **inst_elem_wf,
        )
        corr_any_inst = corr_inst_ok
        if graph.has_boundaries:
            _put(
                e1, corr_bd_non,
                valid=True, rtype=RT_EVENT, vtype=VT_WI,
                intent=int(WI.BOUNDARY_EVENT_OCCURRED), key=key0,
                elem=corr_bd_elem, wf=inst_wf, scope_key=inst_scope_key,
            )
            _put(
                e1, corr_bd_int,
                valid=True, rtype=RT_EVENT, vtype=VT_WI,
                intent=int(WI.ELEMENT_TERMINATING), key=batch.aux_key, **inst_elem_wf,
            )
            _put_payload(e1, corr_bd_int, inst_vt, inst_num, inst_sid)
            corr_any_inst = corr_inst_ok | corr_bd_non | corr_bd_int
        _put(e1, corr_any_inst, instance_key=inst_ikey)
        _put(
            e2, corr_inst_ok | corr_bd_int,
            valid=True, rtype=RT_CMD, vtype=VT_MSUB, intent=int(MS.CLOSE),
            key=-1, wf=pid_col, **corr, instance_key=batch.instance_key,
            aux_key=batch.aux_key,
        )
        _put(
            e0, corr_rej,
            valid=True, rtype=RT_REJ, vtype=vt_, intent=it, key=batch.key, **corr,
            instance_key=batch.instance_key, aux_key=batch.aux_key,
            rej=rb.REJ_SUB_NOT_ACTIVE,
            req=batch.req, req_stream=batch.req_stream, resp=resp,
        )

    # --- boundary events: arm / disarm / terminate / continue. Slots of a
    # row on a boundary-carrying element (the oracle writes arms and
    # cancels BEFORE the row's own step output):
    #   0..BD-1    arm records (ELEMENT_ACTIVATED) / timer cancels (disarm)
    #   BD..2BD-1  the disarm's subscription closes (sends)
    #   2BD        the row's own step output (job CREATE / OPEN / COMPLETED
    #              / job CANCEL / own CLOSE)
    #   2BD+1..3BD TERMINATE_CATCH_EVENT's own timer cancels
    #   3BD+1      ELEMENT_TERMINATED (terminating rows)
    if graph.has_boundaries:
        step_slot = eslot(2 * bdw)
        bd_elem_r, bd_timer_r = g_rows["bd_elem"], g_rows["bd_timer"]
        bd_msg_r, bd_corr_r = g_rows["bd_msg"], g_rows["bd_corr"]

        def timer_cancel(es, tag, j, idx):
            # the j-th armed timer the scan ``tag`` found (oracle: its
            # self.timers scan writes TimerIntent.CANCEL)
            _put(
                es, idx < t_cap,
                valid=True, rtype=RT_CMD, vtype=VT_TIMER, intent=int(TI.CANCEL),
                key=rp[f"{tag}{j}_key"], elem=rp[f"{tag}{j}_elem"],
                aux_key=batch.key, deadline=rp[f"{tag}{j}_due"],
                instance_key=rp[f"{tag}{j}_ik"],
            )

        for bslot in range(bdw):
            arm_b = m_arm & (bslot < bd_n)
            b_elem, b_tdur = bd_elem_r[:, bslot], bd_timer_r[:, bslot]
            b_mname = bd_msg_r[:, bslot]
            es = eslot(bslot)
            # timer boundary arm (oracle writes TimerIntent.CREATE)
            _put(
                es, arm_b & (b_tdur >= 0),
                valid=True, rtype=RT_CMD, vtype=VT_TIMER, intent=int(TI.CREATE),
                key=-1, elem=b_elem, aux_key=batch.key,
                deadline=now + b_tdur.clamp(min=0),
            )
            # message boundary arm: correlation key from this row's payload
            b_cvt, b_cbits, b_extractable = _corr_cols(batch, bd_corr_r[:, bslot])
            b_sub = dict(type_id=b_mname, retries=b_cvt, worker=b_cbits,
                         instance_key=batch.instance_key, aux_key=batch.key, wf=pid_col)
            _put(
                es, arm_b & (b_mname > 0) & b_extractable,
                valid=True, rtype=RT_CMD, vtype=VT_MSUB, intent=int(MS.OPEN),
                key=-1, elem=b_elem, **b_sub,
            )
            _put(
                es, arm_b & (b_mname > 0) & ~b_extractable,
                valid=True, rtype=RT_CMD, vtype=VT_INCIDENT, intent=0,
                key=-1, elem=b_elem, aux_key=batch.key, rej=rb.ERR_CORRELATION_KEY,
            )
            # disarm: the bslot-th armed timer's cancel, and the message
            # boundary's subscription close (sends)
            timer_cancel(es, "c", bslot, disarm_idx[bslot])
            _put(
                eslot(bdw + bslot),
                m_disarm_bd & (bslot < bd_n) & (b_mname > 0) & b_extractable,
                valid=True, rtype=RT_CMD, vtype=VT_MSUB, intent=int(MS.CLOSE),
                key=-1, **b_sub,
            )

        # re-slotted step outputs of boundary-carrying rows
        _put(
            step_slot, m_createjob & has_bd,
            valid=True, rtype=RT_CMD, vtype=VT_JOB, intent=int(JI.CREATE),
            key=-1, elem=batch.elem, aux_key=batch.key,
            type_id=emeta[:, graph_mod.EM_JOB_TYPE],
            retries=emeta[:, graph_mod.EM_JOB_RETRIES],
        )
        _put(
            step_slot, outmap_ok & has_bd,
            valid=True, rtype=RT_EVENT, vtype=VT_WI,
            intent=int(WI.ELEMENT_COMPLETED), key=batch.key, elem=batch.elem,
        )
        _put_payload(step_slot, outmap_ok & has_bd, out_vt, out_num, out_sid)
        if graph.has_messages:
            _put(step_slot, sub_ok & has_bd, **sub_open)
            _put(step_slot, sub_err & has_bd, **sub_incident)
            # TERMINATE_CATCH_EVENT: close the element's own subscription
            _put(
                step_slot, m_term_catch & (msg_name > 0) & corr_extractable,
                valid=True, rtype=RT_CMD, vtype=VT_MSUB, intent=int(MS.CLOSE),
                key=-1, type_id=msg_name, retries=corr_vt_ext, worker=corr_bits_ext,
                instance_key=batch.instance_key, aux_key=batch.key, wf=pid_col,
            )
        # TERMINATE_JOB_TASK: cancel the instance's job (the oracle sends a
        # bare record: type and headers, no payload), then TERMINATED
        _put(
            step_slot, mask_jcancel,
            valid=True, rtype=RT_CMD, vtype=VT_JOB, intent=int(JI.CANCEL),
            key=job_key_inst, elem=batch.elem, aux_key=batch.key,
            type_id=torch.where(tj_found, rp["tj_type"], 0),
            retries=-1,  # the JobRecord default
            v_vt=0, v_num=0.0, v_str=0,
        )
        # TERMINATE_CATCH_EVENT's own timer scan: the oracle writes these
        # cancels between the step output and TERMINATED; a timer both
        # disarmed and terminate-scanned cancels TWICE, like the oracle's
        # two passes over self.timers
        for t in range(bdw):
            timer_cancel(eslot(2 * bdw + 1 + t), "tc", t, tcan_idx[t])
        _put(
            eslot(3 * bdw + 1), m_term_job | m_term_catch,
            valid=True, rtype=RT_EVENT, vtype=VT_WI,
            intent=int(WI.ELEMENT_TERMINATED), key=batch.key, elem=batch.elem,
        )
        _put(
            e0, m_term_elem,
            valid=True, rtype=RT_EVENT, vtype=VT_WI,
            intent=int(WI.ELEMENT_TERMINATED), key=batch.key, elem=batch.elem,
        )
        # ELEMENT_TERMINATED with a pending boundary: the token continues
        # at the boundary event with the stored trigger payload
        _put(
            e0, m_bd_continue,
            valid=True, rtype=RT_EVENT, vtype=VT_WI,
            intent=int(WI.BOUNDARY_EVENT_OCCURRED), key=key0, elem=pending_bd,
        )
        cont_vt, cont_sid, cont_num = unpack_payload(rd["ei_pay"])
        _put_payload(e0, m_bd_continue, cont_vt, cont_num, cont_sid)

    # --- assemble [B, E] (a slot no record wrote is all-zero rows) +
    # parallel-split and multi-instance fork slots
    em: Dict[str, torch.Tensor] = {}
    for name in e0:
        parts = [e0[name], e1[name]] + [
            extra_slots[i][name] if i in extra_slots else torch.zeros_like(e0[name])
            for i in range(2, e_w)
        ]
        em[name] = torch.stack(parts, dim=1)  # [B, E] or [B, E, V]
    for f in range(min(fork_fan, e_w)):
        mask_f = m_psplit & (f < out_count)
        mf = mask_f[:, None]
        em["valid"][:, f] = mask_f | em["valid"][:, f]
        em["rtype"][:, f] = torch.where(mask_f, RT_EVENT, em["rtype"][:, f])
        em["vtype"][:, f] = torch.where(mask_f, VT_WI, em["vtype"][:, f])
        em["intent"][:, f] = torch.where(
            mask_f, int(WI.SEQUENCE_FLOW_TAKEN), em["intent"][:, f]
        )
        em["key"][:, f] = torch.where(mask_f, wf_base + _KEY_STEP * f, em["key"][:, f])
        em["elem"][:, f] = torch.where(mask_f, fork_flows[:, f], em["elem"][:, f])
        for name in ("wf", "instance_key", "scope_key"):
            em[name][:, f] = torch.where(mask_f, getattr(batch, name), em[name][:, f])
        for name in ("v_vt", "v_num", "v_str"):
            em[name][:, f] = torch.where(mf, getattr(batch, name), em[name][:, f])
        em["src"][:, f] = rows
    if graph.has_multi_instance:
        # multi-instance fan-out (oracle _h_multi_instance_split, the
        # cardinality form): one body token per iteration, each carrying
        # loopCounter = f + 1; the container completes when its last body
        # token is consumed (token counting, as at a parallel join).
        # emit_width covers the largest cardinality
        mi_card = emeta[:, graph_mod.EM_MI_CARD]
        lv = graph.mi_loop_var
        mi_vt = batch.v_vt.clone()
        mi_vt[:, lv] = VT_NUM
        for f in range(e_w):
            mask_f = m_mi & (f < mi_card)
            mf = mask_f[:, None]
            em["valid"][:, f] = mask_f | em["valid"][:, f]
            em["rtype"][:, f] = torch.where(mask_f, RT_EVENT, em["rtype"][:, f])
            em["vtype"][:, f] = torch.where(mask_f, VT_WI, em["vtype"][:, f])
            em["intent"][:, f] = torch.where(
                mask_f, int(WI.START_EVENT_OCCURRED), em["intent"][:, f]
            )
            em["key"][:, f] = torch.where(mask_f, wf_base + _KEY_STEP * f, em["key"][:, f])
            em["elem"][:, f] = torch.where(mask_f, start_ev, em["elem"][:, f])
            em["wf"][:, f] = torch.where(mask_f, batch.wf, em["wf"][:, f])
            em["instance_key"][:, f] = torch.where(
                mask_f, batch.instance_key, em["instance_key"][:, f]
            )
            em["scope_key"][:, f] = torch.where(mask_f, batch.key, em["scope_key"][:, f])
            mi_num = batch.v_num.clone()
            mi_num[:, lv] = float(f + 1)
            em["v_vt"][:, f] = torch.where(mf, mi_vt, em["v_vt"][:, f])
            em["v_num"][:, f] = torch.where(mf, mi_num, em["v_num"][:, f])
            em["v_str"][:, f] = torch.where(mf, batch.v_str, em["v_str"][:, f])
            em["src"][:, f] = rows

    # -------- state writes: fused commits, in place --------
    device_spans.phase("step.commit")
    ei_i64_pl = state.ei_i64.view(_I32)  # [N, 6] planes of the [N, 3] keys
    ei_k32 = state.ei_i32.shape[1]
    T_EI32, T_EI64, T_EIPAY, T_EIFREE, T_EIIDX = range(5)
    ei_ops: List[ops.TableOp] = []

    def _col_op(k, col, val):
        """([B, k] vals, [B, k] mask) pair writing ``val`` into one column."""
        vals = torch.zeros((b, k), dtype=_I32, device=dev)
        vals[:, col] = val
        mask = torch.zeros((b, k), dtype=_BOOL, device=dev)
        mask[:, col] = True
        return vals, mask

    # token counters: one select-by-kind accumulate on the scope row
    tok_m = m_consume | m_psplit
    if graph.has_parallel_joins:
        tok_m = tok_m | completer
    tok_v = torch.where(
        m_consume, -1, torch.where(m_psplit, out_count - 1, -(nin_rec - 1))
    )
    tok_vals, tok_mask = _col_op(ei_k32, EI_TOKENS, tok_v)
    ei_ops.append(ops.TableOp(T_EI32, "add", sc_clip, tok_m, tok_vals, tok_mask))
    if graph.has_boundaries:
        # a non-interrupting boundary fires: the host's scope gains a token
        # for the boundary path (oracle: scope.active_tokens += 1)
        bd_vals, bd_mask = _col_op(ei_k32, EI_TOKENS, 1)
        ei_ops.append(ops.TableOp(
            T_EI32, "add", inst_scope_slot.clamp(0, n_cap - 1),
            ttrig_bd_non | corr_bd_non, bd_vals, bd_mask,
        ))
    # start-trigger / multi-instance container token counts (own row; the
    # container holds one token per body iteration — disjoint step kinds)
    tokset_m, tokset_v = m_trigstart, 1
    if graph.has_multi_instance:
        tokset_m = m_trigstart | m_mi
        tokset_v = torch.where(m_mi, emeta[:, graph_mod.EM_MI_CARD], 1)
    ts_vals, ts_mask = _col_op(ei_k32, EI_TOKENS, tokset_v)
    ei_ops.append(ops.TableOp(T_EI32, "set", ei_clip, tokset_m, ts_vals, ts_mask))

    # scope payload on consume: scope value.payload = record payload, but
    # for multi-instance containers, whose iteration-local variables must
    # not leak into the container payload
    b_pay = pack_payload(batch.v_vt, batch.v_str, batch.v_num)
    consume_pay_m = m_consume & ~mi_scope if graph.has_multi_instance else m_consume
    ei_ops.append(ops.TableOp(
        T_EIPAY, "set", sc_clip, _last_writer(sc_clip, consume_pay_m, n_cap), b_pay,
    ))
    # scope state transition by consume completer
    cc_vals, cc_mask = _col_op(ei_k32, EI_STATE, int(WI.ELEMENT_COMPLETING))
    ei_ops.append(ops.TableOp(
        T_EI32, "set", sc_clip, consume_completer, cc_vals, cc_mask
    ))
    # own-row transitions, ONE composed write per dtype family (every record
    # is exactly one step kind; the guards exclude two records transitioning
    # one instance row in a round)
    ei_remove = outmap_ok | m_complete_proc
    # a job completion or a timer trigger completes the instance it names;
    # an interrupting boundary terminates it
    completing = jev_completed
    if graph.has_timers:
        completing = completing | ttrig_catch
    own_is_aik, own_state_m = completing, inmap_ok | completing
    if graph.has_boundaries:
        bd_int_any = ttrig_bd_int | corr_bd_int
        term_all = m_term_job | m_term_catch | m_term_elem
        ei_remove = ei_remove | m_bd_continue
        own_is_aik = own_is_aik | bd_int_any
        own_state_m = own_state_m | bd_int_any | term_all
    own_state_m = own_state_m | ei_remove
    own_slot = torch.where(own_is_aik, aik_clip, ei_clip)
    own_state_v = torch.where(completing, int(WI.ELEMENT_COMPLETING),
                              int(WI.ELEMENT_ACTIVATED))
    if graph.has_boundaries:
        own_state_v = torch.where(
            term_all, int(WI.ELEMENT_TERMINATED),
            torch.where(bd_int_any, int(WI.ELEMENT_TERMINATING), own_state_v),
        )
    own_state_v = torch.where(ei_remove, -1, own_state_v)  # removal wins last
    own_vals, own_mask = _col_op(ei_k32, EI_STATE, own_state_v)
    own_mask[:, EI_STATE] = own_state_m
    if graph.has_boundaries:
        # the pending boundary element, recorded with the TERMINATING write
        pending_v = corr_bd_elem
        if graph.has_timers:
            pending_v = torch.where(ttrig_bd_int, trig_elem, corr_bd_elem)
        own_vals[:, EI_PENDING_BD] = pending_v
        own_mask[:, EI_PENDING_BD] = bd_int_any
    ei_ops.append(ops.TableOp(
        T_EI32, "set", own_slot, own_state_m, own_vals, own_mask
    ))
    # own-row payloads: input mapping writes the mapped document, job
    # completion and a message boundary's interruption the record payload
    own_pay_m = inmap_ok | jev_completed
    if graph.has_messages and graph.has_boundaries:
        own_pay_m = own_pay_m | corr_bd_int
    own_pay = b_pay
    if graph.has_mappings:
        own_pay = torch.where(
            inmap_ok[:, None], pack_payload(in_vt, in_sid, in_num), b_pay
        )
    ei_ops.append(ops.TableOp(
        T_EIPAY, "set", own_slot, _last_writer(own_slot, own_pay_m, n_cap), own_pay,
    ))

    # own-row int64 columns (job-key attach/detach, removal key clear)
    jobkey_m = jev_completed | (jev_created & aik_found)
    jobkey_v = torch.where(jev_completed, -1, batch.key)
    ei64_slot = torch.where(jobkey_m, aik_clip, ei_clip)
    n64 = ei_i64_pl.shape[1]
    ei64_vals = torch.zeros((b, n64), dtype=_I32, device=dev)
    ei64_mask = torch.zeros((b, n64), dtype=_BOOL, device=dev)
    ei64_vals[:, 2 * EIL_JOB_KEY : 2 * EIL_JOB_KEY + 2] = _planes(jobkey_v)
    ei64_mask[:, 2 * EIL_JOB_KEY] = jobkey_m
    ei64_mask[:, 2 * EIL_JOB_KEY + 1] = jobkey_m
    clear_key = (ei_remove & ~jobkey_m)[:, None]
    neg_vals = torch.zeros((b, n64), dtype=_I32, device=dev)
    neg_vals[:, 2 * EIL_KEY : 2 * EIL_KEY + 2] = -1  # planes of int64 -1
    neg_mask = torch.zeros((b, n64), dtype=_BOOL, device=dev)
    neg_mask[:, 2 * EIL_KEY : 2 * EIL_KEY + 2] = True
    ei64_vals = torch.where(clear_key, neg_vals, ei64_vals)
    ei64_mask = torch.where(clear_key, neg_mask, ei64_mask)
    ei_ops.append(ops.TableOp(
        T_EI64, "set", ei64_slot, jobkey_m | ei_remove, ei64_vals, ei64_mask
    ))

    # inserts: CREATE command roots + START_STATEFUL children (+ replayed
    # CREATED events whose instance is missing)
    ins_key = torch.where(m_create | m_startst, key0, batch.key)
    ins_elem = torch.where(m_create, 0, torch.where(m_startst, ftarget, batch.elem))
    ins_parent = torch.where(m_startst, sc_slot, -1)
    ins_ikey = torch.where(m_create, key0, batch.instance_key)
    # free-slot ring pop: slots freed this round enter at push and are
    # never re-allocated in the same round
    ins_slot = torch.where(ins & ei_ring_ok, ei_pop_slot, n_cap).to(_I32)
    ei_overflow = torch.any(ins & ~ei_ring_ok)
    free_ei_pop_new = state.free_ei_pop + torch.sum(ins, dtype=_I64)
    # dedup pushes per slot: two removals of one row free it ONCE
    ei_push_m = _last_writer(ei_clip, ei_remove, n_cap)
    ei_push_idx = state.free_ei_push + _excl_cumsum(ei_push_m).to(_I64)
    ei_ops.append(ops.TableOp(
        T_EIFREE, "set", (ei_push_idx % n_cap).to(_I32), ei_push_m, ei_clip,
    ))
    free_ei_push_new = state.free_ei_push + torch.sum(ei_push_m, dtype=_I64)
    ei_i32_rows = torch.stack(
        [ins_elem, full_b(int(WI.ELEMENT_READY), _I32), batch.wf, ins_parent,
         zeros_b(_I32), full_b(-1, _I32)], dim=-1,  # no pending boundary
    )
    ei_ops.append(ops.TableOp(T_EI32, "set", ins_slot, ins, ei_i32_rows))
    ei_i64_rows = torch.stack([ins_key, ins_ikey, full_b(-1, _I64)], dim=-1)
    ei_ops.append(ops.TableOp(T_EI64, "set", ins_slot, ins, _planes(ei_i64_rows)))
    ei_ops.append(ops.TableOp(T_EIPAY, "set", ins_slot, ins, b_pay))
    ei_icap = state.ei_index.shape[0]
    ei_ops.append(ops.TableOp(
        T_EIIDX, "set", ((ins_key // 5) & (ei_icap - 1)).to(_I32), ins, ins_slot,
    ))
    if graph.has_messages:
        # a correlate arrival: the instance completes with the message payload
        corr_vals, corr_mask = _col_op(ei_k32, EI_STATE, int(WI.ELEMENT_COMPLETING))
        ei_ops.append(ops.TableOp(
            T_EI32, "set", aik_clip, corr_inst_ok, corr_vals, corr_mask
        ))
        ei_ops.append(ops.TableOp(
            T_EIPAY, "set", aik_clip, _last_writer(aik_clip, corr_inst_ok, n_cap), b_pay,
        ))
    ops.fused_table_commit(
        [state.ei_i32, ei_i64_pl, state.ei_pay, state.free_ei, state.ei_index],
        ei_ops,
    )

    # ---------------- job table (fused commit, in place) ----------------
    T_J32, T_J64, T_JPAY, T_JFREE, T_JIDX = range(5)
    job_i64_pl = state.job_i64.view(_I32)
    job_k32 = state.job_i32.shape[1]
    job_ops: List[ops.TableOp] = []
    j_slot = torch.where(job_ins & job_ring_ok, job_pop_slot, m_cap).to(_I32)
    job_overflow = torch.any(job_ins & ~job_ring_ok)
    free_job_pop_new = state.free_job_pop + torch.sum(job_ins, dtype=_I64)
    job_i32_rows = torch.stack(
        [full_b(int(JI.CREATED), _I32), batch.elem, batch.wf, batch.type_id,
         batch.retries, zeros_b(_I32)], dim=-1,
    )
    job_ops.append(ops.TableOp(T_J32, "set", j_slot, job_ins, job_i32_rows))
    job_i64_rows = torch.stack(
        [job_base, batch.instance_key, batch.aux_key, full_b(-1, _I64)], dim=-1,
    )
    job_ops.append(ops.TableOp(T_J64, "set", j_slot, job_ins, _planes(job_i64_rows)))
    job_ops.append(ops.TableOp(T_JPAY, "set", j_slot, job_ins, b_pay))
    job_icap = state.job_index.shape[0]
    job_ops.append(ops.TableOp(
        T_JIDX, "set", ((job_base // 5) & (job_icap - 1)).to(_I32), job_ins, j_slot,
    ))

    # transitions: every record is one job step kind, all targeting jb_clip
    job_rm = jcomp_ok | jcan_ok
    jstate_m = jact_ok | jfail_ok | jtime_ok | job_rm
    jstate_v = torch.where(
        job_rm, -1,
        torch.where(
            jtime_ok, int(JI.TIMED_OUT),
            torch.where(jfail_ok, int(JI.FAILED), int(JI.ACTIVATED)),
        ),
    )
    jretries_m = jact_ok | jfail_ok | jret_ok
    jb_vals = torch.zeros((b, job_k32), dtype=_I32, device=dev)
    jb_mask = torch.zeros((b, job_k32), dtype=_BOOL, device=dev)
    jb_vals[:, JB_STATE] = jstate_v
    jb_mask[:, JB_STATE] = jstate_m
    jb_vals[:, JB_RETRIES] = batch.retries
    jb_mask[:, JB_RETRIES] = jretries_m
    jb_vals[:, JB_WORKER] = batch.worker
    jb_mask[:, JB_WORKER] = jact_ok
    job_ops.append(ops.TableOp(
        T_J32, "set", jb_clip, jstate_m | jret_ok, jb_vals, jb_mask
    ))

    j64 = job_i64_pl.shape[1]
    j64_vals = torch.zeros((b, j64), dtype=_I32, device=dev)
    j64_mask = torch.zeros((b, j64), dtype=_BOOL, device=dev)
    j64_vals[:, 2 * JBL_DEADLINE : 2 * JBL_DEADLINE + 2] = _planes(batch.deadline)
    j64_mask[:, 2 * JBL_DEADLINE] = jact_ok
    j64_mask[:, 2 * JBL_DEADLINE + 1] = jact_ok
    jneg_vals = torch.zeros((b, j64), dtype=_I32, device=dev)
    jneg_vals[:, 2 * JBL_KEY : 2 * JBL_KEY + 2] = -1
    jneg_mask = torch.zeros((b, j64), dtype=_BOOL, device=dev)
    jneg_mask[:, 2 * JBL_KEY : 2 * JBL_KEY + 2] = True
    j64_vals = torch.where(job_rm[:, None], jneg_vals, j64_vals)
    j64_mask = torch.where(job_rm[:, None], jneg_mask, j64_mask)
    job_ops.append(ops.TableOp(
        T_J64, "set", jb_clip, jact_ok | job_rm, j64_vals, j64_mask
    ))

    jpay = torch.where(
        jfail_ok[:, None], pack_payload(fail_vt, fail_sid, fail_num), b_pay
    )
    job_ops.append(ops.TableOp(T_JPAY, "set", jb_clip, jact_ok | jfail_ok, jpay))
    # dedup per slot (see the ei ring push)
    job_push_m = _last_writer(jb_clip, job_rm, m_cap)
    job_push_idx = state.free_job_push + _excl_cumsum(job_push_m).to(_I64)
    job_ops.append(ops.TableOp(
        T_JFREE, "set", (job_push_idx % m_cap).to(_I32), job_push_m, jb_clip,
    ))
    free_job_push_new = state.free_job_push + torch.sum(job_push_m, dtype=_I64)
    ops.fused_table_commit(
        [state.job_i32, job_i64_pl, state.job_pay, state.free_job,
         state.job_index],
        job_ops,
    )

    # ---------------- timer table (fused commit, in place) ----------------
    overflow = ei_overflow | job_overflow
    # the maps whose deletes the step issues as one fused delete, at its end
    map_tables: List[ops.HashTable] = []
    map_deletes: List[ops.DeleteOp] = []
    if graph.has_timers:
        # the six timer tables as one group: the int64 columns as [TM, 2]
        # int32 planes, elem/wf as 1D lanes; a slot past the table (t_cap,
        # the free-slot scan's overflow answer) is dropped by the commit
        t_ins = m_tcreate
        tfree = _first_true_indices(state.timer_key < 0, b)
        t_rank = _excl_cumsum(t_ins)
        t_slot = tfree[t_rank.clamp(0, b - 1).to(_I64)]
        timer_overflow = torch.any(t_ins & (t_slot >= t_cap))
        t_rm = ttrig_ok | tcan_ok
        tneg = _planes(full_b(-1, _I64))
        T_TK, T_TD, T_TA, T_TIK, T_TE, T_TW = range(6)
        ops.fused_table_commit(
            [state.timer_key.view(_I32).view(t_cap, 2),
             state.timer_due.view(_I32).view(t_cap, 2),
             state.timer_aik.view(_I32).view(t_cap, 2),
             state.timer_instance_key.view(_I32).view(t_cap, 2),
             state.timer_elem, state.timer_wf],
            [
                ops.TableOp(T_TK, "set", t_slot, t_ins, _planes(key0)),
                ops.TableOp(T_TD, "set", t_slot, t_ins, _planes(batch.deadline)),
                ops.TableOp(T_TA, "set", t_slot, t_ins, _planes(batch.aux_key)),
                ops.TableOp(T_TIK, "set", t_slot, t_ins, _planes(batch.instance_key)),
                ops.TableOp(T_TE, "set", t_slot, t_ins, batch.elem),
                ops.TableOp(T_TW, "set", t_slot, t_ins, batch.wf),
                ops.TableOp(T_TK, "set", tm_clip, t_rm, tneg),
                ops.TableOp(T_TD, "set", tm_clip, t_rm, tneg),
            ],
        )
        # the insert precedes the delete (below, with the join map's), both
        # on the map in place
        ops.insert(state.timer_map, key0, t_slot, t_ins)
        map_tables.append(state.timer_map)
        map_deletes.append(ops.DeleteOp(len(map_deletes), batch.key, t_rm))
        overflow = overflow | timer_overflow

    # ---------------- join cleanup ----------------
    join_arrived = state.join_arrived
    if graph.has_parallel_joins:
        ops.masked_vec64_update(state.join_key, arr_slot, completer, full_b(-1, _I64))
        ops.masked_lane_update(state.join_nin, arr_slot, completer, zeros_b(_I32))
        ops.masked_row_update(arrived, arr_slot, completer,
                              torch.zeros((b, f_in), dtype=_I32, device=dev))
        ops.masked_row_update(stamp, arr_slot, completer,
                              torch.full((b, stamp.shape[1]), -1, dtype=_I32, device=dev))
        map_tables.append(jmap)
        map_deletes.append(ops.DeleteOp(len(map_deletes), join_key, completer))
        join_arrived = arrived != 0
        overflow = overflow | join_overflow

    # ---------------- message stores (fused commits, in place) ----------------
    if graph.has_messages:
        neg = _planes(full_b(-1, _I64))
        # subscriptions: OPEN inserts, CLOSE clears the composite; the
        # int64 columns as int32 planes, bit for bit
        msfree = _first_true_indices(state.msub_ckey < 0, b)
        ms_slot_new = msfree[_excl_cumsum(open_ok).clamp(0, b - 1).to(_I64)]
        msub_overflow = torch.any(open_ok & (ms_slot_new >= ms_cap))
        T_MCK, T_M32, T_M64 = range(3)
        ops.fused_table_commit(
            [state.msub_ckey.view(_I32).view(ms_cap, 2), state.msub_i32,
             state.msub_i64.view(_I32)],
            [
                ops.TableOp(T_MCK, "set", ms_slot_new, open_ok, _planes(ckey)),
                ops.TableOp(T_M32, "set", ms_slot_new, open_ok, torch.stack(
                    [batch.type_id, batch.retries, batch.worker, batch.wf], dim=-1)),
                ops.TableOp(T_M64, "set", ms_slot_new, open_ok, _planes(
                    torch.stack([batch.instance_key, batch.aux_key], dim=-1))),
                ops.TableOp(T_MCK, "set", msub_clip, close_ok, neg),
            ],
        )
        _m, msub_ins_ok = ops.insert(state.msub_map, ckey, ms_slot_new, open_ok)
        # stored messages: a PUBLISH with a TTL stores, DELETE clears
        mgfree = _first_true_indices(state.msg_key < 0, b)
        mg_slot_new = mgfree[_excl_cumsum(pub_store).clamp(0, b - 1).to(_I64)]
        msg_overflow = torch.any(pub_store & (mg_slot_new >= mg_cap))
        T_GK, T_GCK, T_G32, T_GDL, T_GPAY = range(5)
        ops.fused_table_commit(
            [state.msg_key.view(_I32).view(mg_cap, 2),
             state.msg_ckey.view(_I32).view(mg_cap, 2), state.msg_i32,
             state.msg_deadline.view(_I32).view(mg_cap, 2), state.msg_pay],
            [
                ops.TableOp(T_GK, "set", mg_slot_new, pub_store, _planes(key0)),
                ops.TableOp(T_GCK, "set", mg_slot_new, pub_store, _planes(ckey)),
                ops.TableOp(T_G32, "set", mg_slot_new, pub_store, torch.stack(
                    [batch.type_id, batch.retries, batch.worker,
                     batch.aux2_key.to(_I32)], dim=-1)),
                ops.TableOp(T_GDL, "set", mg_slot_new, pub_store,
                            _planes(now + batch.deadline)),
                ops.TableOp(T_GPAY, "set", mg_slot_new, pub_store, b_pay),
                ops.TableOp(T_GK, "set", mmsg_clip, del_ok, neg),
                ops.TableOp(T_GDL, "set", mmsg_clip, del_ok, neg),
            ],
        )
        _m, msg_ins_ok = ops.insert(state.msg_map, ckey, mg_slot_new, pub_store)
        # each insert precedes its delete (in the fused delete below), as
        # in the JAX kernel; nothing between them reads either map
        map_tables += [state.msub_map, state.msg_map]
        map_deletes.append(ops.DeleteOp(len(map_deletes), ckey, close_ok))
        map_deletes.append(ops.DeleteOp(len(map_deletes), ckey, del_ok))
        overflow = (
            overflow | msub_overflow | msg_overflow
            | ~torch.all(msub_ins_ok == open_ok) | ~torch.all(msg_ins_ok == pub_store)
        )
    # the step's map deletes (timers, joins, the message stores) in one
    # launch: nothing later in the step reads any of the maps
    ops.fused_delete(map_tables, map_deletes)

    # ---------------- output compaction ----------------
    device_spans.phase("step.compact")
    be = b * e_w
    flat_valid = em["valid"].reshape(-1)
    take_idx = _first_true_indices(flat_valid, be)
    count = torch.sum(flat_valid, dtype=_I32)
    idx = take_idx.clamp(0, be - 1)
    # ONE gather launch takes every emission column (raw bytes: bit-exact)
    names = [n for n in rb.FIELDS if n != "valid"]
    taken = ops.fused_gather_rows(
        [em[n].reshape((be,) + tuple(em[n].shape[2:])) for n in names],
        [ops.GatherOp(i, idx) for i in range(len(names))],
    )
    out = RecordBatch(
        valid=torch.arange(be, dtype=_I32, device=dev) < count,
        **dict(zip(names, taken)),
    )

    # the committed tables were updated in place; the rest is carried over
    new_state = dataclasses.replace(
        state, join_arrived=join_arrived, sub_credits=sub_credits,
        free_ei_pop=free_ei_pop_new, free_ei_push=free_ei_push_new,
        free_job_pop=free_job_pop_new, free_job_push=free_job_push_new,
        next_wf_key=next_wf_key, next_job_key=next_job_key,
    )
    stats = {
        "processed": torch.sum(valid, dtype=_I32),
        "stepped": torch.sum(stepped, dtype=_I32)
        + torch.sum(job_cmd | job_ev | timer_cmd | m_create | m_created_ev
                    | msg_pub | msg_del | ms_open | ms_close | wisub_corr,
                    dtype=_I32),
        "emitted": count,
        "completed_roots": torch.sum(
            m_complete_proc & (batch.elem == 0), dtype=_I32
        ),
        "overflow": overflow,
    }
    # what follows, the frame's teardown, is the step span's own time
    device_spans.phase(None)
    return new_state, out, stats



@device_spans.traced("tick")
def tick_kernel(state: EngineState, now) -> Tuple[RecordBatch, torch.Tensor]:
    """Due-timer and job-deadline scan → a batch of TRIGGER / TIME_OUT
    commands and their count (reference JobTimeOutStreamProcessor and the
    oracle's check_*_deadlines), ordered by key like the oracle's sorted
    iteration. Reads the state only; one fused gather takes the due rows."""
    t_cap = state.timer_key.shape[0]
    m_cap = state.job_i32.shape[0]
    size = t_cap + m_cap
    dev = state.timer_key.device
    timer_due = (state.timer_key >= 0) & (state.timer_due <= now)
    job_due = (
        (state.job_state == int(JI.ACTIVATED))
        & (state.job_deadline >= 0)
        & (state.job_deadline <= now)
    )
    keys = torch.cat([state.timer_key, state.job_key])
    due = torch.cat([timer_due, job_due])
    order = torch.argsort(torch.where(due, keys, 2**62), stable=True)
    count = torch.sum(due, dtype=_I32)
    is_timer = order < t_cap
    tidx = order.clamp(max=t_cap - 1)
    jidx = (order - t_cap).clamp(0, m_cap - 1)
    rows = _gather_named({
        "key": (keys, order),
        "t_elem": (state.timer_elem, tidx), "t_wf": (state.timer_wf, tidx),
        "t_ik": (state.timer_instance_key, tidx), "t_aik": (state.timer_aik, tidx),
        "t_due": (state.timer_due, tidx),
        "j_i32": (state.job_i32, jidx), "j_i64": (state.job_i64, jidx),
        "j_pay": (state.job_pay, jidx),
    })
    j32, j64 = rows["j_i32"], rows["j_i64"]
    jb_vt, jb_sid, jb_num = unpack_payload(rows["j_pay"])
    t_col = is_timer[:, None]

    def pick(timer, job):
        return torch.where(is_timer, timer, job)

    def full(value, dtype):
        return torch.full((size,), value, dtype=dtype, device=dev)

    out = RecordBatch(
        valid=torch.arange(size, dtype=_I32, device=dev) < count,
        rtype=full(RT_CMD, _I32),
        vtype=pick(VT_TIMER, VT_JOB).to(_I32),
        intent=pick(int(TI.TRIGGER), int(JI.TIME_OUT)).to(_I32),
        key=rows["key"],
        elem=pick(rows["t_elem"], j32[:, JB_ELEM]),
        wf=pick(rows["t_wf"], j32[:, JB_WF]),
        instance_key=pick(rows["t_ik"], j64[:, JBL_IKEY]),
        scope_key=full(-1, _I64),
        v_vt=torch.where(t_col, 0, jb_vt).to(torch.int8),
        v_num=torch.where(t_col, 0.0, jb_num),
        v_str=torch.where(t_col, 0, jb_sid),
        req=full(-1, _I64),
        req_stream=full(-1, _I32),
        aux_key=pick(rows["t_aik"], j64[:, JBL_AIK]),
        aux2_key=full(-1, _I64),
        type_id=pick(0, j32[:, JB_TYPE]),
        retries=pick(0, j32[:, JB_RETRIES]),
        deadline=pick(rows["t_due"], j64[:, JBL_DEADLINE]),
        worker=pick(0, j32[:, JB_WORKER]),
        src=full(-1, _I32),
        resp=torch.zeros((size,), dtype=_BOOL, device=dev),
        push=torch.zeros((size,), dtype=_BOOL, device=dev),
        rej=torch.zeros((size,), dtype=_I32, device=dev),
    )
    return out, count
