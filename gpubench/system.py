"""The system under test: ``zeebe_tpu_torch``'s device step, driven through
its own entry points (``tpu.drive.run_to_quiescence`` for one partition,
``tpu.shard.build_sharded_drive`` for several, ``tpu.kernel.tick_kernel``,
``tpu.state.rebuild_lookup_state``), and the taps that read what it produces.

Everything here that builds inputs follows what ``chip_smoke.py`` does for
configs 1 and 4 (``config_graph``, ``config_state``, ``config_creates``,
``c4_setup``, ``c4_publishes``), from the benchmark's own configuration
files instead of fixed models.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gpubench import reference as ref

# record columns in the order the taps copy them
TAP_FIELDS = ref.FIELDS + ref.PAYLOAD


def build_model(graph: dict):
    """The configuration's graph as a BPMN model of the engine's builder: the
    start event, then each flow in the file's order, an element added where
    the flow first reaches it, with its boundary events right after it."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    els = {e["id"]: e for e in graph["elements"]}
    b = Bpmn.create_process(graph["process"])
    start = [e for e in graph["elements"] if e["type"] == "startEvent"][0]
    b.start_event(start["id"])
    made = {start["id"]}

    def add(eid):
        e = els[eid]
        kind = e["type"]
        if kind == "endEvent":
            b.end_event(eid)
        elif kind == "serviceTask":
            b.service_task(eid, type=e["jobType"], retries=int(e.get("retries", 3)))
        elif kind == "receiveTask":
            b.receive_task(eid, message_name=e["message"],
                           correlation_key="$." + e["correlationKey"])
        else:
            raise ValueError(f"{eid}: element type {kind} has no builder here")
        made.add(eid)
        for bd in graph["elements"]:
            if bd["type"] == "boundaryEvent" and bd["attachedTo"] == eid:
                b.boundary_event(bd["id"], attached_to=eid, duration_ms=int(bd["durationMs"]))
                made.add(bd["id"])

    for src, dst in graph["flows"]:
        b.move_to(src)
        if dst in made:
            b.connect_to(dst)
        else:
            add(dst)
    return b.done()


def compile_config(config: dict, device):
    """The configuration's graph compiled for the engine on ``device``, its
    metadata and the engine's encodings of the inputs (``ref.Encoding``)."""
    from zeebe_tpu_torch.models.transform.transformer import transform_model
    from zeebe_tpu_torch.tpu import graph as graph_mod

    model = build_model(config["graph"])
    workflows = transform_model(model)
    for wf in workflows:
        wf.key = 9
        wf.version = 1
    graph, meta = graph_mod.compile_graph(workflows, device=device)
    columns = {name: meta.varspace.column(name) for name in config["variables"]}
    num_vars = max(graph.num_vars, int(config["num_vars"]))
    graph = dataclasses.replace(graph, num_vars=num_vars)
    strings = [e[k] for e in config["graph"]["elements"] for k in ("jobType", "message")
               if k in e]
    if "worker" in config:
        strings.append(config["worker"]["name"])
    interns = {s: meta.interns.intern(s) for s in strings}
    elem = {}
    for slot, ids in enumerate(meta.elem_ids):
        for i, eid in enumerate(ids):
            node = model.element(eid)
            if hasattr(node, "source_id") and hasattr(node, "target_id"):
                eid = ref.Semantics.flow_name((node.source_id, node.target_id))
            elem[eid] = i
    enc = ref.Encoding(elem=elem, interns=interns, columns=columns, num_vars=num_vars)
    return graph, meta, enc


def state_sizes(config: dict, instances: int) -> Tuple[dict, int]:
    """``make_state``'s table capacities, and its instance capacity, for
    ``instances`` instances a unit, as the configuration's factors say."""
    cap = {k: v * instances for k, v in config["capacity"].items() if k != "subscriptions"}
    return dict(job_capacity=cap["jobs"], join_capacity=cap.get("joins", 0),
                timer_capacity=cap.get("timers", 0),
                msub_capacity=cap.get("message_subscriptions", 0),
                msg_capacity=cap.get("messages", 0),
                sub_capacity=int(config["capacity"].get("subscriptions", 64))), cap["instances"]


def subscribe_worker(st, config: dict, interns: Dict[str, int]):
    """The configuration's one job worker, subscribed in slot 0."""
    if "worker" in config:
        w = config["worker"]
        st.sub_key[0] = int(w["subscriberKey"])
        st.sub_type[0] = interns[w["jobType"]]
        st.sub_worker[0] = interns[w["name"]]
        st.sub_credits[0] = int(w["credits"])
        st.sub_timeout[0] = int(w["timeout_ms"])
        st.sub_valid[0] = True


def queue_rows(graph, state, batch_size: int) -> int:
    """A partition's queue: a drive's backlog and the block a round appends
    (chip_smoke.config_setup: 4 batches of max(2, emit width) rows), and the
    tick's whole batch (timers and jobs)."""
    tick_rows = state.timer_key.shape[0] + state.job_i32.shape[0]
    return max(4 * batch_size * max(2, graph.emit_width), 2 * tick_rows)


class Engine:
    """One partition of the engine on ``device``, sized for units of
    ``unit_size`` instances as the configuration says."""

    def __init__(self, config: dict, unit_size: int, batch_size: int, device):
        import zeebe_tpu_torch.tpu.drive as drive
        from zeebe_tpu_torch.tpu import state as state_mod

        self.config = config
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.drive_mod = drive
        self.graph, self.meta, self.enc = compile_config(config, self.device)
        sizes, instances = state_sizes(config, unit_size)
        self.state = state_mod.make_state(capacity=instances, num_vars=self.graph.num_vars,
                                          device=self.device, **sizes)
        subscribe_worker(self.state, config, self.enc.interns)
        self.queue = drive.make_queue(queue_rows(self.graph, self.state, batch_size),
                                      self.graph.num_vars, device=self.device)

    # -- inputs (chip_smoke.config_creates, c4_creates, c4_publishes) ---------------
    def creates(self, variables: Dict[str, torch.Tensor]):
        return make_creates(self.graph.num_vars, self.enc, variables, self.device)

    def publishes(self, message: str, corr: torch.Tensor, variables: Dict[str, bool]):
        return make_publishes(self.graph.num_vars, self.enc, message, corr, variables,
                              self.device)

    # -- the entry points ----------------------------------------------------------------
    def drive(self, batch, now: int, synthetic_workers: bool) -> Dict[str, int]:
        drive = self.drive_mod
        self.queue = drive.enqueue(self.queue, batch)
        self.state, self.queue, totals = drive.run_to_quiescence(
            self.graph, self.state, self.queue, now, self.batch_size,
            synthetic_workers=synthetic_workers)
        return totals

    def tick(self, now: int):
        from zeebe_tpu_torch.tpu import kernel

        return kernel.tick_kernel(self.state, now)

    def rebuild(self):
        from zeebe_tpu_torch.tpu import state as state_mod

        self.state = state_mod.rebuild_lookup_state(self.state)

    # -- what the state holds ---------------------------------------------------------------
    def state_digest(self, tables) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return state_digest(self.state, tables)

    def scalars(self) -> torch.Tensor:
        return scalars(self.state)


def make_creates(num_vars: int, enc, variables: Dict[str, torch.Tensor], device):
    """A CREATE command per row, with the numeric variables given."""
    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.tpu import batch as rb
    from zeebe_tpu_torch.tpu.conditions import VT_NUM

    n = next(iter(variables.values())).shape[0]
    b = rb.empty(n, num_vars, device=device)
    b.valid.fill_(True)
    b.rtype.fill_(int(RecordType.COMMAND))
    b.vtype.fill_(int(ValueType.WORKFLOW_INSTANCE))
    b.intent.fill_(int(WI.CREATE))
    b.wf.fill_(0)
    for name, vals in variables.items():
        col = enc.columns[name]
        b.v_vt[:, col] = VT_NUM
        b.v_num[:, col] = vals
    return b


def make_publishes(num_vars: int, enc, message: str, corr: torch.Tensor,
                   variables: Dict[str, bool], device):
    """A PUBLISH of ``message`` per value of ``corr`` (numeric correlation
    values), with boolean ``variables`` and no time to live."""
    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import MessageIntent as MI
    from zeebe_tpu_torch.tpu import batch as rb
    from zeebe_tpu_torch.tpu.conditions import VT_BOOL, VT_NUM

    n = corr.shape[0]
    b = rb.empty(n, num_vars, device=device)
    b.valid.fill_(True)
    b.rtype.fill_(int(RecordType.COMMAND))
    b.vtype.fill_(int(ValueType.MESSAGE))
    b.intent.fill_(int(MI.PUBLISH))
    b.type_id.fill_(enc.interns[message])
    b.retries.fill_(int(VT_NUM))
    b.worker.copy_(corr.to(torch.float32).view(torch.int32))
    for name, v in variables.items():
        col = enc.columns[name]
        b.v_vt[:, col] = VT_BOOL
        b.v_num[:, col] = 1.0 if v else 0.0
    return b


class ShardedEngine:
    """``len(devices)`` partitions of the engine, partition ``p`` on
    ``devices[p]``, driven by the port's multi-partition drive
    (``tpu.shard.build_sharded_drive``): each partition sized for its share
    of units of ``unit_size`` instances, reading ``batch_size`` records a
    round. Inputs are routed as Zeebe's gateway routes them: CREATE ``i``
    to partition ``i % P``, a PUBLISH to the partition of its correlation
    key's hash, where its subscription opens. Every method returns one
    entry a partition."""

    def __init__(self, config: dict, unit_size: int, batch_size: int, devices,
                 synthetic_workers: bool):
        from zeebe_tpu_torch.tpu import shard

        self.config = config
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.batch_size = batch_size
        self.shard = shard
        self.graph, self.meta, self.enc = compile_config(config, self.devices[0])
        sizes, instances = state_sizes(config, -(-unit_size // self.size))
        self.states = shard.make_partitioned_state(
            self.size, instances, self.graph.num_vars, devices=self.devices, **sizes)
        for st in self.states:
            subscribe_worker(st, config, self.enc.interns)
        # the lockstep drive appends a round's own emissions and then a
        # block of batch_size rows from every other partition
        rows = queue_rows(self.graph, self.states[0], batch_size) + self.size * batch_size
        self.queues = shard.make_partitioned_queue(self.size, rows, self.graph.num_vars,
                                                   devices=self.devices)
        self.drive_fn = shard.build_sharded_drive(shard.Mesh(self.devices), batch_size,
                                                  synthetic_workers=synthetic_workers)

    # -- inputs, routed ----------------------------------------------------------------
    def creates(self, variables: Dict[str, torch.Tensor]):
        return [make_creates(self.graph.num_vars, self.enc,
                             {k: v[p::self.size].to(d) for k, v in variables.items()}, d)
                for p, d in enumerate(self.devices)]

    def publishes(self, message: str, corr: torch.Tensor, variables: Dict[str, bool]):
        from zeebe_tpu_torch.tpu.conditions import VT_NUM
        from zeebe_tpu_torch.tpu.state import corr_composite

        name = torch.full_like(corr, self.enc.interns[message], dtype=torch.int32)
        bits = corr.to(torch.float32).view(torch.int32)
        to = self.shard.shard_of_key(
            corr_composite(name, torch.full_like(name, int(VT_NUM)), bits), self.size)
        return [make_publishes(self.graph.num_vars, self.enc, message, corr[to == p].to(d),
                               variables, d) for p, d in enumerate(self.devices)]

    # -- the entry points ----------------------------------------------------------------
    def drive(self, batches, now: int, synthetic_workers: bool) -> List[Dict[str, int]]:
        """Each partition's batch enqueued on its queue, then the sharded
        drive to quiescence (``synthetic_workers`` is the drive's, fixed
        when it was built). Raises, as ``run_to_quiescence`` does, on an
        overflow or a drive that did not quiesce."""
        from zeebe_tpu_torch.tpu import drive

        for p, batch in enumerate(batches):
            self.queues[p] = drive.enqueue(self.queues[p], batch)
        self.states, self.queues, totals = self.drive_fn(self.graph, self.states, self.queues,
                                                         now)
        out = [{k: int(v) for k, v in t.items()} for t in totals]
        if any(t["overflow"] for t in out):
            raise RuntimeError("device table, queue or exchange overflow during the drive")
        if any(int(q.count) for q in self.queues):
            raise RuntimeError("the sharded drive did not quiesce")
        return out

    def tick(self, now: int):
        from zeebe_tpu_torch.tpu import kernel

        return [kernel.tick_kernel(st, now) for st in self.states]

    def rebuild(self):
        from zeebe_tpu_torch.tpu import state as state_mod

        self.states = [state_mod.rebuild_lookup_state(st) for st in self.states]

    # -- what the state holds ---------------------------------------------------------------
    def state_digest(self, tables) -> List[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
        return [state_digest(st, tables) for st in self.states]

    def scalars(self) -> torch.Tensor:
        """[partition, 3], on the first partition's device."""
        return torch.stack([scalars(st).to(self.devices[0]) for st in self.states])


def state_digest(st, tables) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """(live rows, digest) of each of ``tables`` as device scalars, the
    columns in ``reference.STATE_COLUMNS`` order (``reference.digest``)."""
    out = {}
    for name in tables:
        live, cols = _state_columns(st, name)
        out[name] = (live.sum(), _digest(cols, live))
    return out


def scalars(st) -> torch.Tensor:
    """The key counters and the worker's credits, as one device tensor."""
    return torch.stack([st.next_wf_key, st.next_job_key, st.sub_credits[0].to(torch.int64)])


def _state_columns(st, name):
    i64 = torch.int64
    if name == "ei":
        scope = st.ei_i32[:, 3].to(i64)
        scope_key = torch.where(scope >= 0, st.ei_i64[:, 0][scope.clamp(min=0)], -1)
        cols = [st.ei_i64[:, 0], st.ei_i64[:, 1], st.ei_i64[:, 2], st.ei_i32[:, 0], st.ei_i32[:, 1],
                st.ei_i32[:, 2], scope_key, st.ei_i32[:, 4], st.ei_i32[:, 5]]
        return st.ei_i64[:, 0] >= 0, torch.cat([torch.stack([c.to(i64) for c in cols], 1),
                                                 st.ei_pay.to(i64)], 1)
    if name == "job":
        cols = torch.cat([st.job_i64, st.job_i32.to(i64), st.job_pay.to(i64)], 1)
        return st.job_i64[:, 0] >= 0, cols
    if name == "timer":
        cols = [st.timer_key, st.timer_due, st.timer_aik, st.timer_instance_key, st.timer_elem,
                st.timer_wf]
        return st.timer_key >= 0, torch.stack([c.to(i64) for c in cols], 1)
    if name == "msub":
        return st.msub_ckey >= 0, torch.cat([st.msub_ckey[:, None], st.msub_i32.to(i64),
                                             st.msub_i64], 1)
    if name == "msg":
        return st.msg_key >= 0, torch.cat([st.msg_key[:, None], st.msg_ckey[:, None],
                                           st.msg_i32.to(i64), st.msg_deadline[:, None],
                                           st.msg_pay.to(i64)], 1)
    raise ValueError(name)


def digest_powers(n: int) -> List[int]:
    """MUL^(n-1-i) modulo 2^64, as signed int64: Horner's fold of a row,
    ``reference.digest``'s, as one weighted sum."""
    out, p = [], 1
    for _ in range(n):
        out.append(p)
        p = (p * ref.DIGEST_MUL) % (1 << 64)
    return [(v - (1 << 64)) if v >= (1 << 63) else v for v in reversed(out)]


def _digest(cols: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    pw = torch.tensor(digest_powers(cols.shape[1]), dtype=torch.int64, device=cols.device)
    h = (cols * pw).sum(1)
    h = h ^ (h >> 33)
    h = h * ref.DIGEST_MIX
    h = h ^ (h >> 29)
    return torch.where(live, h, 0).sum()


class RoundTap:
    """Copies rows of what each drive round emits, while the drive runs:
    wraps the step that ``tpu.drive`` calls and the one that
    ``tpu.shard``'s lockstep drive calls, and after each step copies
    ``rows`` consecutive records of its output batch, from a row drawn from
    the seed, into one byte buffer (one copy launch a round). Rounds are
    counted by the step's ``partition_id``. Nothing is read back."""

    def __init__(self, rows: int, batch_size: int, seed: int):
        import zeebe_tpu_torch.tpu.drive as drive
        from zeebe_tpu_torch.tpu import shard

        self.rows, self.batch_size = rows, batch_size
        self.rng = np.random.default_rng([seed, 7])
        self.modules = (drive, shard)
        self.steps = tuple(m.step_kernel for m in self.modules)
        self.where: Optional[Tuple[int, int]] = None
        self.round: Dict[int, int] = {}
        # (unit, drive, partition, round, row, copied rows)
        self.taken: List[Tuple[int, int, int, int, int, torch.Tensor]] = []
        for m, step in zip(self.modules, self.steps):
            m.step_kernel = self._wrap(step)

    def close(self):
        for m, step in zip(self.modules, self.steps):
            m.step_kernel = step

    def begin(self, unit: int, drive_no: int):
        self.where, self.round = (unit, drive_no), {}

    def _wrap(self, step):
        def tapped(*args, **kwargs):
            with torch.profiler.record_function("tpu.kernel.step_kernel"):
                state, out, stats = step(*args, **kwargs)
            pid = int(kwargs.get("partition_id", 0))
            self.round[pid] = self.round.get(pid, 0) + 1
            if self.where is not None:
                row = int(self.rng.integers(0, max(1, self.batch_size - self.rows + 1)))
                self.taken.append((*self.where, pid, self.round[pid], row,
                                   copy_rows(out, row, self.rows)))
            return state, out, stats
        return tapped


def copy_rows(batch, row: int, rows: int) -> torch.Tensor:
    """Records [row, row + rows) of a batch, every column, as one [rows, bytes]
    uint8 tensor (one launch)."""
    parts = []
    for f in TAP_FIELDS:
        col = getattr(batch, f).narrow(0, row, rows)
        parts.append(col.contiguous().view(torch.uint8).reshape(rows, -1))
    return torch.cat(parts, 1)


def split_rows(buf: torch.Tensor) -> Dict[str, np.ndarray]:
    """``copy_rows`` back into columns (numpy)."""
    from zeebe_tpu_torch.tpu import batch as rb

    a = buf.cpu().numpy()
    rows = a.shape[0]
    out, at = {}, 0
    widths = {}
    probe = rb.empty(1, 1, device="cpu")
    for f in TAP_FIELDS:
        widths[f] = getattr(probe, f).element_size()
    num_vars = (a.shape[1] - sum(widths[f] for f in ref.FIELDS)) // sum(
        widths[f] for f in ref.PAYLOAD)
    for f in TAP_FIELDS:
        dtype = getattr(probe, f).numpy().dtype
        n = widths[f] * (num_vars if f in ref.PAYLOAD else 1)
        col = np.ascontiguousarray(a[:, at:at + n]).view(dtype)
        out[f] = col.reshape(rows, -1) if f in ref.PAYLOAD else col.reshape(rows)
        at += n
    return out
