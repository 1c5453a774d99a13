"""The plain reference: the serial record log of a BPMN graph, in NumPy.

A Zeebe partition processes its log one record at a time: each record it
reads is stepped by the processor of its value type, which appends its
follow-up records to the log and draws new keys from the partition's
strided key counters (workflow keys = 1 mod 5, job keys = 2 mod 5). This
module computes that log for the benchmark's graphs, for many instances at
once, from the graph as the configuration file states it. It knows the
element kinds the configurations use (start and end events, sequence
flows, service tasks served by one synthetic worker, receive tasks with an
interrupting timer boundary) and the message and timer processors they
need, as Zeebe's 0.x processors define them.

The engine under test reads its log in batches of ``batch_size`` records:
round r dequeues the first ``batch_size`` records of the log that are not
processed yet and emits their follow-ups in log order, which the next
rounds read. The reference keeps the same queue, so it can say which
record the engine emits at any row of any round (``src`` is the row of the
record that caused it in that round's batch), and what the partition's
state holds once the queue has drained.

A configuration of several partitions is a ``Cluster``: each partition
has a log and key counters of its own (keys drawn from base ``p << 51``),
and the instances' values are shared, each written by the partition that
draws or sets it. The cluster reads its logs in lockstep rounds, the
published semantics of a partitioned log read in batches: in each round
every partition reads up to ``batch_size`` records of its log (an idle one
reads nothing), appends its own emissions first, then the records the
other partitions routed to it, by source partition in order. Routing is
Zeebe 0.x's: a ``MESSAGE_SUBSCRIPTION`` command (OPEN, CLOSE) goes to the
partition of its correlation key's hash, a ``WORKFLOW_INSTANCE_SUBSCRIPTION``
CORRELATE to the instance's partition, everything else stays. A graph with
no message step keeps the partitions independent, each read to its own
quiescence.

Where the engine's records differ from Zeebe 0.x's processors, the
reference follows the engine, since its records are what is compared:

- the partition of a correlation key: Zeebe 0.x hashes the key's string
  (``SubscriptionUtil.getSubscriptionHashCode``); the engine hashes the
  composite of (message name, value type, value bits) with a Fibonacci
  multiplicative hash (``HASH_MUL`` below), and so does the reference;
- the instance's partition rides the ``wf`` column of every message and
  workflow-instance subscription record (``workflowInstancePartitionId``
  in Zeebe 0.x), which the records emitted from them inherit;
- CORRELATE names the message's partition in ``aux2_key``
  (``subscriptionPartitionId`` in Zeebe 0.x);
- Zeebe 0.x acknowledges an opened message subscription with a
  WORKFLOW_INSTANCE_SUBSCRIPTION OPEN / OPENED round trip and resends
  unacknowledged commands on a timer; the engine opens with one command
  and sends each once, and so does the reference;
- Zeebe 0.x delivers a routed command whenever its transport does; the
  engine, and the reference, deliver it at the end of the round that
  emitted it.

Nothing here imports the engine under test or JAX: numbers of the Zeebe
protocol are copied below, and the engine's own encodings (element
indices, interned strings, payload columns) come in as plain tables that
the harness builds from its inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# -- the Zeebe protocol (protocol/enums and intents) -------------------------
RT_EVENT, RT_CMD = 0, 1
VT_JOB, VT_WI, VT_MSG, VT_MSUB, VT_WISUB, VT_TIMER = 0, 5, 11, 12, 13, 14
WI = dict(CREATE=0, CREATED=1, START_EVENT_OCCURRED=2, END_EVENT_OCCURRED=3,
          SEQUENCE_FLOW_TAKEN=4, ELEMENT_READY=6, ELEMENT_ACTIVATED=7,
          ELEMENT_COMPLETING=8, ELEMENT_COMPLETED=9, ELEMENT_TERMINATING=10,
          ELEMENT_TERMINATED=11, BOUNDARY_EVENT_OCCURRED=16)
JOB = dict(CREATE=0, CREATED=1, ACTIVATE=2, ACTIVATED=3, COMPLETE=4, COMPLETED=5)
TIMER = dict(CREATE=0, CREATED=1, TRIGGER=2, TRIGGERED=3, CANCEL=4, CANCELED=5)
MSG = dict(PUBLISH=0, PUBLISHED=1, DELETED=3)
MSUB = dict(OPEN=0, OPENED=1, CLOSE=4, CLOSED=5)
WISUB = dict(CORRELATE=0, CORRELATED=1)
# payload value types of the columnar payload
VT_ABSENT, VT_BOOL, VT_NUM = 0, 2, 3
KEY_STEP, WF_KEY0, JOB_KEY0 = 5, 1, 2
# a partition's keys start at its id in the high bits: 13 bits of
# partition, 51 of counter
PARTITION_SHIFT = 51
# the correlation key's hash: ((composite * HASH_MUL) >> 33) & 0x7FFFFFFF,
# wrapping modulo 2^64, taken modulo the partition count
HASH_MUL = -7046029254386353131
# where a processed record's emission goes: its own partition, the
# message partition of its correlation key, or its instance's partition
STAY, TO_MSG, TO_INST = 0, 1, 2

# the columns of a record, in the engine's batch order, without the payload
FIELDS = ("valid", "rtype", "vtype", "intent", "key", "elem", "wf", "instance_key",
          "scope_key", "req", "req_stream", "aux_key", "aux2_key", "type_id",
          "retries", "deadline", "worker", "src", "resp", "push", "rej")
PAYLOAD = ("v_vt", "v_num", "v_str")
_DEFAULTS = dict(key=-1, elem=-1, wf=0, instance_key=-1, scope_key=-1, req=-1,
                 req_stream=-1, aux_key=-1, aux2_key=-1, type_id=0, retries=0,
                 deadline=-1, worker=0, resp=0, push=0, rej=0)


@dataclasses.dataclass
class Kind:
    """One kind of record: its columns and what processing it does.

    A column is an int, or the name of a per-instance value (a key drawn
    earlier, a due date, an interned id). ``payload`` is "scope" (the
    instance's variables, with a correlated message's merged in), "msg"
    (the message's variables) or "none". Processing draws ``alloc`` keys
    ((value, "wf"|"job") in order), sets ``sets`` values to now + a
    constant, then emits ``children`` in order."""

    name: str
    rtype: int
    vtype: int
    intent: int
    cols: Dict[str, object]
    payload: str = "scope"
    alloc: Tuple[Tuple[str, str], ...] = ()
    sets: Tuple[Tuple[str, int], ...] = ()
    children: Tuple[str, ...] = ()
    completes_root: bool = False
    waits: bool = False        # the instance now waits for a message or its timer
    correlates: bool = False   # a message reaches the waiting instance
    fires: bool = False        # the waiting instance's timer fires


class Semantics:
    """The record kinds of one graph (``config["graph"]``) with its worker
    (``config.get("worker")``)."""

    def __init__(self, graph: dict, worker: Optional[dict] = None):
        self.process = graph["process"]
        self.elements = {e["id"]: e for e in graph["elements"]}
        self.flows = [tuple(f) for f in graph["flows"]]
        self.worker = worker
        self.kinds: Dict[str, Kind] = {}
        self._build()
        self.names = list(self.kinds)
        self.index = {n: i for i, n in enumerate(self.names)}
        self.has_messages = any(e["type"] == "receiveTask" for e in self.elements.values())
        self.route = np.array([route_of(self.kinds[n]) for n in self.names], np.int8)

    # -- the graph ------------------------------------------------------------
    def out_flow(self, src: str) -> Tuple[str, str]:
        out = [f for f in self.flows if f[0] == src]
        if len(out) != 1:
            raise ValueError(f"{src}: the reference follows exactly one outgoing flow")
        return out[0]

    def boundaries(self, task: str) -> List[str]:
        return [e["id"] for e in self.elements.values()
                if e["type"] == "boundaryEvent" and e["attachedTo"] == task]

    @staticmethod
    def flow_name(flow: Tuple[str, str]) -> str:
        return f"{flow[0]}->{flow[1]}"

    # -- the kinds --------------------------------------------------------------
    def _add(self, kind: Kind) -> str:
        self.kinds.setdefault(kind.name, kind)
        return kind.name

    def _wi(self, intent: str, elem: str, key: str, **kw) -> Kind:
        scope = -1 if elem == self.process else "k_inst"
        name = kw.pop("name", f"{intent}@{elem}")
        return Kind(name, RT_EVENT, VT_WI, WI[intent],
                    dict(key=key, elem=elem, instance_key="k_inst", scope_key=scope), **kw)

    def _after_flow(self, flow: Tuple[str, str]) -> str:
        """The record the engine writes when it takes ``flow``."""
        target = self.elements[flow[1]]
        key = "k:" + target["id"]
        if target["type"] == "endEvent":
            end = self._add(self._wi("END_EVENT_OCCURRED", target["id"], key,
                                     children=(self._process_completing(),)))
            return end
        return self._activity(target["id"])

    def _take(self, src: str) -> str:
        """The SEQUENCE_FLOW_TAKEN that leaves ``src``; processing the
        record that leads to it draws the flow's key."""
        flow = self.out_flow(src)
        name = "k:" + self.flow_name(flow)
        self._add(self._wi("SEQUENCE_FLOW_TAKEN", self.flow_name(flow), name,
                           alloc=(("k:" + flow[1], "wf"),),
                           children=(self._after_flow(flow),)))
        return f"SEQUENCE_FLOW_TAKEN@{self.flow_name(flow)}"

    def _process_completing(self) -> str:
        p = self.process
        done = self._add(self._wi("ELEMENT_COMPLETED", p, "k_inst"))
        return self._add(self._wi("ELEMENT_COMPLETING", p, "k_inst",
                                  children=(done,), completes_root=True))

    def _activity(self, eid: str) -> str:
        """ELEMENT_READY of an activity, and everything it leads to."""
        e = self.elements[eid]
        key = "k:" + eid
        flow = self.out_flow(eid)
        completed = self._add(self._wi("ELEMENT_COMPLETED", eid, key,
                                       alloc=(("k:" + self.flow_name(flow), "wf"),),
                                       children=(self._take(eid),)))
        if e["type"] == "serviceTask":
            activated_children = (self._job(eid, e, completed),)
        elif e["type"] == "receiveTask":
            activated_children = self._receive(eid, e, completed)
        else:
            raise ValueError(f"{eid}: element type {e['type']} is not in the reference")
        activated = self._add(self._wi("ELEMENT_ACTIVATED", eid, key,
                                       sets=self._receive_sets(eid, e),
                                       waits=e["type"] == "receiveTask",
                                       children=activated_children))
        return self._add(self._wi("ELEMENT_READY", eid, key, children=(activated,)))

    def _receive_sets(self, eid, e):
        if e["type"] != "receiveTask":
            return ()
        return tuple(("due:" + b, int(self.elements[b]["durationMs"]))
                     for b in self.boundaries(eid))

    def _job(self, eid: str, e: dict, completed: str) -> str:
        """A service task's job, served by one synthetic worker: activated
        as soon as it is created and completed inside the step."""
        w = self.worker
        if w is None or w["jobType"] != e["jobType"]:
            raise ValueError(f"{eid}: no worker for job type {e['jobType']}")
        cols = dict(elem=eid, instance_key="k_inst", scope_key="k_inst", aux_key="k:" + eid,
                    type_id="id:" + e["jobType"], retries=int(e.get("retries", 3)))
        worker = "id:" + w["name"]
        completing = self._add(self._wi("ELEMENT_COMPLETING", eid, "k:" + eid,
                                        children=(completed,)))
        job_completed = self._add(Kind(
            "JOB_COMPLETED", RT_EVENT, VT_JOB, JOB["COMPLETED"],
            dict(cols, key="job", deadline="act_deadline", worker=worker),
            children=(completing,)))
        complete = self._add(Kind(
            "JOB_COMPLETE", RT_CMD, VT_JOB, JOB["COMPLETE"],
            dict(cols, key="job", worker=worker), children=(job_completed,)))
        activated = self._add(Kind(
            "JOB_ACTIVATED", RT_EVENT, VT_JOB, JOB["ACTIVATED"],
            dict(cols, key="job", deadline="act_deadline", worker=worker,
                 req_stream=int(w["subscriberKey"]), push=1)))
        activate = self._add(Kind(
            "JOB_ACTIVATE", RT_CMD, VT_JOB, JOB["ACTIVATE"],
            dict(cols, key="job", deadline="act_deadline", worker=worker,
                 req_stream=int(w["subscriberKey"])),
            children=(activated, complete)))
        created = self._add(Kind(
            "JOB_CREATED", RT_EVENT, VT_JOB, JOB["CREATED"], dict(cols, key="job"),
            sets=(("act_deadline", int(w["timeout_ms"])),), children=(activate,)))
        return self._add(Kind("JOB_CREATE", RT_CMD, VT_JOB, JOB["CREATE"], dict(cols),
                              alloc=(("job", "job"),), children=(created,)))

    def _receive(self, eid: str, e: dict, completed: str) -> Tuple[str, ...]:
        """A receive task: a timer per boundary and a message subscription
        when activated; completed by a correlated message, or terminated by
        its boundary's timer."""
        bds = self.boundaries(eid)
        if len(bds) != 1:
            raise ValueError(f"{eid}: the reference models exactly one timer boundary")
        bd = bds[0]
        msg = dict(type_id="id:" + e["message"], retries=VT_NUM,
                   worker="bits:" + e["correlationKey"])
        # the subscription records carry the instance's partition in wf
        sub = dict(msg, instance_key="k_inst", aux_key="k:" + eid, wf="part:inst")
        timer = dict(elem=bd, instance_key="k_inst", scope_key="k_inst", aux_key="k:" + eid,
                     deadline="due:" + bd)
        timer_created = self._add(Kind("TIMER_CREATED", RT_EVENT, VT_TIMER, TIMER["CREATED"],
                                       dict(timer, key="timer")))
        timer_create = self._add(Kind("TIMER_CREATE", RT_CMD, VT_TIMER, TIMER["CREATE"],
                                      dict(timer), alloc=(("timer", "wf"),),
                                      children=(timer_created,)))
        opened = self._add(Kind("MSUB_OPENED", RT_EVENT, VT_MSUB, MSUB["OPENED"],
                                dict(sub, key="msub", scope_key="k_inst")))
        sub_open = self._add(Kind("MSUB_OPEN", RT_CMD, VT_MSUB, MSUB["OPEN"],
                                  dict(sub, elem=eid, scope_key="k_inst"),
                                  alloc=(("msub", "wf"),), children=(opened,)))
        # correlation: the message's payload travels on to the completion,
        # where it is merged into the instance's
        closed_c = self._add(Kind("MSUB_CLOSED@correlated", RT_EVENT, VT_MSUB, MSUB["CLOSED"],
                                  dict(sub), payload="msg"))
        close_c = self._add(Kind("MSUB_CLOSE@correlated", RT_CMD, VT_MSUB, MSUB["CLOSE"],
                                 dict(sub), payload="msg", children=(closed_c,)))
        canceled = self._add(Kind("TIMER_CANCELED", RT_EVENT, VT_TIMER, TIMER["CANCELED"],
                                  dict(timer, key="timer"), payload="msg"))
        cancel = self._add(Kind("TIMER_CANCEL", RT_CMD, VT_TIMER, TIMER["CANCEL"],
                                dict(timer, key="timer"), payload="msg", children=(canceled,)))
        completing = self._add(self._wi("ELEMENT_COMPLETING", eid, "k:" + eid, payload="msg",
                                        children=(cancel, completed)))
        correlated = self._add(Kind("WISUB_CORRELATED", RT_EVENT, VT_WISUB,
                                    WISUB["CORRELATED"], dict(sub), payload="msg"))
        correlate = self._add(Kind("WISUB_CORRELATE", RT_CMD, VT_WISUB, WISUB["CORRELATE"],
                                   dict(sub, aux2_key="part:msg"), payload="msg",
                                   children=(correlated, completing, close_c),
                                   correlates=True))
        message = dict(msg, wf=-1)
        published = self._add(Kind("MSG_PUBLISHED", RT_EVENT, VT_MSG, MSG["PUBLISHED"],
                                   dict(message, key="msg"), payload="msg"))
        deleted = self._add(Kind("MSG_DELETED", RT_EVENT, VT_MSG, MSG["DELETED"],
                                 dict(message, key="msg"), payload="msg"))
        self._add(Kind("PUBLISH", RT_CMD, VT_MSG, MSG["PUBLISH"], dict(message),
                       payload="msg", alloc=(("msg", "wf"),),
                       children=(published, deleted, correlate)))
        # the timer fires: the task is terminated, its boundary occurs
        occurred = self._add(self._wi("BOUNDARY_EVENT_OCCURRED", bd, "k:" + bd,
                                      alloc=(("k:" + self.flow_name(self.out_flow(bd)), "wf"),),
                                      children=(self._take(bd),)))
        closed_t = self._add(Kind("MSUB_CLOSED@terminated", RT_EVENT, VT_MSUB, MSUB["CLOSED"],
                                  dict(sub, scope_key="k_inst")))
        close_t = self._add(Kind("MSUB_CLOSE@terminated", RT_CMD, VT_MSUB, MSUB["CLOSE"],
                                 dict(sub, scope_key="k_inst"), children=(closed_t,)))
        terminated = self._add(self._wi("ELEMENT_TERMINATED", eid, "k:" + eid,
                                        alloc=(("k:" + bd, "wf"),), children=(occurred,)))
        terminating = self._add(self._wi("ELEMENT_TERMINATING", eid, "k:" + eid,
                                         children=(close_t, terminated)))
        fired = dict(timer, key="timer", scope_key=-1)
        triggered = self._add(Kind("TIMER_TRIGGERED", RT_EVENT, VT_TIMER, TIMER["TRIGGERED"],
                                   fired, payload="none"))
        self._add(Kind("TRIGGER", RT_CMD, VT_TIMER, TIMER["TRIGGER"], fired, payload="none",
                       children=(triggered, terminating), fires=True))
        return timer_create, sub_open

    def _build(self):
        p = self.process
        start = [e["id"] for e in self.elements.values() if e["type"] == "startEvent"]
        if len(start) != 1:
            raise ValueError("the reference starts an instance at exactly one start event")
        flow = self.out_flow(start[0])
        occurred = self._add(self._wi("START_EVENT_OCCURRED", start[0], "k:" + start[0],
                                      alloc=(("k:" + self.flow_name(flow), "wf"),),
                                      children=(self._take(start[0]),)))
        activated = self._add(self._wi("ELEMENT_ACTIVATED", p, "k_inst",
                                       alloc=(("k:" + start[0], "wf"),), children=(occurred,)))
        ready = self._add(self._wi("ELEMENT_READY", p, "k_inst", children=(activated,)))
        created = self._add(self._wi("CREATED", p, "k_inst", name="CREATED"))
        self._add(Kind("CREATE", RT_CMD, VT_WI, WI["CREATE"], dict(), alloc=(("k_inst", "wf"),),
                       children=(created, ready)))


def route_of(kind: Kind) -> int:
    """Where the records of ``kind`` are processed, relative to the
    partition that emitted them (Zeebe 0.x's subscription command
    senders)."""
    if kind.rtype == RT_CMD and kind.vtype == VT_MSUB:
        return TO_MSG
    if kind.rtype == RT_CMD and kind.vtype == VT_WISUB:
        return TO_INST
    return STAY


def hash_partition(composite: np.ndarray, partitions: int) -> np.ndarray:
    """The partition of each correlation composite (int64)."""
    with np.errstate(over="ignore"):
        h = ((np.asarray(composite, np.int64) * np.int64(HASH_MUL)) >> np.int64(33)) \
            & np.int64(0x7FFFFFFF)
    return (h % partitions).astype(np.int64)


def composite(name_id: int, bits: np.ndarray) -> np.ndarray:
    """The correlation composite of a numeric correlation value: the
    message name's id, the value type and the value's float32 bits."""
    return (np.int64(name_id) << 35) | (np.int64(VT_NUM) << 32) \
        | (np.asarray(bits, np.int64) & 0xFFFFFFFF)


@dataclasses.dataclass
class Rows:
    """Captured rows of a round: the instance and kind of each record, the
    row of the record that caused it, whether the row holds a record, and
    whether its instance's payload held a message then."""

    inst: np.ndarray
    kind: np.ndarray
    src: np.ndarray
    ok: np.ndarray
    merged: np.ndarray


@dataclasses.dataclass
class Rest:
    waiting: np.ndarray
    merged: np.ndarray


@dataclasses.dataclass
class Encoding:
    """The engine's encodings of the inputs, as the harness made them:
    element id → index, string → interned id, variable → payload column."""

    elem: Dict[str, int]
    interns: Dict[str, int]
    columns: Dict[str, int]
    num_vars: int
    wf_slot: int = 0


def f32_bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


class Partition:
    """One partition's log and state, driven as the engine is: host records
    are appended, then ``drive`` reads the log in rounds until it drains.
    Partition ``pid`` of a ``Cluster`` shares the instances' values with the
    cluster's first partition (``shared``)."""

    def __init__(self, sem: Semantics, enc: Encoding, n: int,
                 wf_key: int = WF_KEY0, job_key: int = JOB_KEY0, pid: int = 0,
                 shared: Optional["Partition"] = None):
        self.sem, self.enc, self.n, self.pid = sem, enc, n, pid
        self.counters = {"wf": wf_key, "job": job_key}
        if shared is None:
            self.values: Dict[str, np.ndarray] = {
                "part:inst": np.zeros(n, np.int64), "part:msg": np.zeros(n, np.int64)}
            # variables of each instance and of its message: name → (vt, num)
            self.inst_vars: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            self.msg_vars: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            self.merged = np.zeros(n, bool)
            self.waiting = np.zeros(n, bool)
        else:
            self.values, self.inst_vars, self.msg_vars = (shared.values, shared.inst_vars,
                                                          shared.msg_vars)
            self.merged, self.waiting = shared.merged, shared.waiting
        self.q_inst = np.zeros(0, np.int64)
        self.q_kind = np.zeros(0, np.int32)
        k = len(sem.names)
        self.kind_counts = np.zeros(k, np.int64)
        self._nchild = np.array([len(sem.kinds[nm].children) for nm in sem.names], np.int64)
        width = max(1, int(self._nchild.max()))
        self._child = np.full((k, width), -1, np.int32)
        for i, nm in enumerate(sem.names):
            for j, c in enumerate(sem.kinds[nm].children):
                self._child[i, j] = sem.index[c]
        self._alloc = {fam: np.array([sum(f == fam for _, f in sem.kinds[nm].alloc)
                                      for nm in sem.names], np.int64) for fam in ("wf", "job")}

    def value(self, name: str) -> np.ndarray:
        if name not in self.values:
            self.values[name] = np.full(self.n, -1, np.int64)
        return self.values[name]

    # -- inputs -------------------------------------------------------------------
    def create(self, variables: Dict[str, np.ndarray], inst: Optional[np.ndarray] = None):
        """A CREATE command for every instance (or those of ``inst``), in
        instance order, with its numeric variables (f32)."""
        for name, vals in variables.items():
            vals = np.asarray(vals, np.float32)
            self.inst_vars[name] = (np.full(self.n, VT_NUM, np.int64), vals)
            self.values["bits:" + name] = f32_bits(vals)
        self._append(np.arange(self.n) if inst is None else inst, "CREATE")

    def publish(self, order: np.ndarray, variables: Dict[str, object]):
        """PUBLISH commands for the instances in ``order``, each keyed by its
        instance's correlation value, with the message's variables."""
        for name, v in variables.items():
            if not isinstance(v, bool):
                raise ValueError("the reference publishes boolean message variables")
            self.msg_vars[name] = (np.full(self.n, VT_BOOL, np.int64),
                                   np.full(self.n, float(v), np.float32))
        self._append(np.asarray(order, np.int64), "PUBLISH")

    def tick(self, now: int) -> np.ndarray:
        """The instances of this partition whose timer is due at ``now``, in
        the order of the timers' keys: the TRIGGER commands its tick writes."""
        due = [v for v in self.values if v.startswith("due:")]
        if not due:
            return np.zeros(0, np.int64)
        when = self.values[due[0]]
        fire = np.nonzero(self.waiting & (when >= 0) & (when <= now)
                          & (self.values["part:inst"] == self.pid))[0]
        return fire[np.argsort(self.values["timer"][fire], kind="stable")]

    def trigger(self, fire: np.ndarray):
        self._append(fire, "TRIGGER")

    def _append(self, inst: np.ndarray, kind: str):
        self._enqueue(inst.astype(np.int64), np.full(len(inst), self.sem.index[kind], np.int32))

    def _enqueue(self, inst: np.ndarray, kind: np.ndarray):
        self.q_inst = np.concatenate([self.q_inst, inst])
        self.q_kind = np.concatenate([self.q_kind, kind])

    # -- the drive ------------------------------------------------------------------
    def drive(self, batch_size: int, now: int,
              capture: Optional[Dict[int, Tuple[int, int]]] = None):
        """Read the log in rounds of ``batch_size`` until it drains. Returns
        the totals (processed, emitted, completed_roots, rounds) and, for
        each round r in ``capture`` ({r: (row, count)}), the records the
        round emits at rows [row, row + count) (round numbers from 1), as
        ``Rows`` for ``records``."""
        totals = dict(processed=0, emitted=0, completed_roots=0, rounds=0)
        captured = {}
        while len(self.q_inst):
            ci, ck, src = self.round(batch_size, now, totals)
            if capture and totals["rounds"] in capture:
                row, count = capture[totals["rounds"]]
                captured[totals["rounds"]] = self._rows(ci, ck, src, row, count)
            self._enqueue(ci, ck)
        return totals, captured

    def round(self, batch_size: int, now: int, totals: Dict[str, int]):
        """Read up to ``batch_size`` records off the log and process them:
        keys drawn, values set, flags moved, ``totals`` counted. Returns the
        emissions in log order: (instance, kind, row of the record that
        caused it)."""
        sem = self.sem
        kinds_of = [sem.kinds[nm] for nm in sem.names]
        take = min(batch_size, len(self.q_inst))
        bi, bk = self.q_inst[:take], self.q_kind[:take]
        self.q_inst, self.q_kind = self.q_inst[take:], self.q_kind[take:]
        present = np.unique(bk)
        for fam in ("wf", "job"):
            n = self._alloc[fam][bk]
            total = int(n.sum())
            if not total:
                continue
            base = self.counters[fam] + KEY_STEP * (np.cumsum(n) - n)
            for k in present:
                fam_slots = [s for s, f in kinds_of[k].alloc if f == fam]
                if not fam_slots:
                    continue
                m = bk == k
                for j, slot in enumerate(fam_slots):
                    self.value(slot)[bi[m]] = base[m] + KEY_STEP * j
            self.counters[fam] += KEY_STEP * total
        for k in present:
            kind = kinds_of[k]
            if not (kind.sets or kind.completes_root or kind.waits or kind.correlates
                    or kind.fires):
                continue
            m = bk == k
            for slot, delta in kind.sets:
                self.value(slot)[bi[m]] = now + delta
            totals["completed_roots"] += int(m.sum()) if kind.completes_root else 0
            if kind.waits:
                self.waiting[bi[m]] = True
            if kind.correlates:
                self.merged[bi[m]] = True
            if kind.correlates or kind.fires:
                self.waiting[bi[m]] = False
        nch = self._nchild[bk]
        rep = np.repeat(np.arange(take), nch)
        pos = np.arange(len(rep)) - (np.cumsum(nch) - nch)[rep]
        totals["rounds"] += 1
        totals["processed"] += take
        self.kind_counts += np.bincount(bk, minlength=len(sem.names))
        totals["emitted"] += len(rep)
        return bi[rep], self._child[bk[rep], pos], rep

    # -- what the records and the state hold ----------------------------------------------
    def _payload(self, inst: np.ndarray, mode: np.ndarray, merged: np.ndarray):
        """Payload columns of records of ``inst`` by ``mode``: 0 the
        instance's variables (with its message's where ``merged``), 1 the
        message's, 2 none."""
        enc = self.enc
        rows = len(inst)
        vt = np.zeros((rows, enc.num_vars), np.int8)
        num = np.zeros((rows, enc.num_vars), np.float32)
        for variables, m in ((self.inst_vars, mode == 0),
                             (self.msg_vars, (mode == 1) | ((mode == 0) & merged))):
            for name, (t, v) in variables.items():
                col = enc.columns[name]
                vt[m, col] = t[inst[m]]
                num[m, col] = v[inst[m]]
        return vt, num, np.zeros((rows, enc.num_vars), np.int32)

    def _rows(self, inst, kind, src, row, count) -> "Rows":
        """Rows [row, row + count) of a round whose emissions are (inst,
        kind, src); rows past the last emission are invalid."""
        sel = np.arange(row, row + count)
        ok = sel < len(inst)
        if not len(inst):
            return Rows(sel * 0, np.zeros(count, np.int32), sel * 0, ok, np.zeros(count, bool))
        sel = np.where(ok, sel, 0)
        return Rows(inst[sel], kind[sel], src[sel], ok, self.merged[inst[sel]])

    def records(self, rows: "Rows") -> Dict[str, np.ndarray]:
        """The columns of captured rows, with the keys as they stand now."""
        return self._columns(rows)

    def _columns(self, r: "Rows") -> Dict[str, np.ndarray]:
        sem = self.sem
        inst, kind, src, ok = r.inst, r.kind, r.src, r.ok
        rows = len(inst)
        out = {f: np.full(rows, _DEFAULTS.get(f, 0), np.int64) for f in FIELDS}
        out["valid"] = ok.astype(np.int64)
        out["src"] = np.where(ok, src, -1).astype(np.int64)
        mode = np.full(rows, 2, np.int64)
        for k in np.unique(kind[ok]):
            kd = sem.kinds[sem.names[k]]
            m = ok & (kind == k)
            out["rtype"][m], out["vtype"][m], out["intent"][m] = kd.rtype, kd.vtype, kd.intent
            mode[m] = {"scope": 0, "msg": 1, "none": 2}[kd.payload]
            for col, spec in kd.cols.items():
                out[col][m] = self._col(col, spec, inst[m])
        vt, num, sid = self._payload(inst, mode, r.merged)
        out["v_vt"], out["v_num"], out["v_str"] = vt, num, sid
        return out

    def _col(self, col, spec, inst):
        enc = self.enc
        if isinstance(spec, int):
            return spec
        if col == "elem":
            return enc.elem[spec]
        if spec.startswith("id:"):
            return enc.interns[spec[3:]]
        return self.values[spec][inst]

    def trigger_rows(self, fire: np.ndarray, row: int, count: int) -> "Rows":
        """Rows [row, row + count) of the tick's TRIGGER batch (``tick``)."""
        sel = np.arange(row, row + count)
        ok = sel < len(fire)
        inst = fire[np.where(ok, sel, 0)] if len(fire) else np.zeros(count, np.int64)
        return Rows(inst, np.full(count, self.sem.index["TRIGGER"], np.int32),
                    np.full(count, -1), ok, np.zeros(count, bool))

    def shift_keys(self, wf: int, job: int):
        """Move every key this partition drew, and its counters, by ``wf``
        and ``job``: a unit that the engine ran after others draws the
        same keys as one run first, moved by what those drew."""
        delta = {"wf": wf, "job": job}
        drawn = {slot: fam for kd in self.sem.kinds.values() for slot, fam in kd.alloc}
        for slot, fam in drawn.items():
            v = self.values.get(slot)
            if v is not None:
                v[v >= 0] += delta[fam]
        self.counters = {f: c + delta[f] for f, c in self.counters.items()}

    def snapshot(self) -> "Rest":
        """Who waits, and whose payload holds a message, once a drive has
        drained: what ``state_rows`` reads."""
        return Rest(self.waiting.copy(), self.merged.copy())

    def state_rows(self, rest: "Rest") -> Dict[str, np.ndarray]:
        """The partition's tables once its log has drained, as rows of int64
        columns in ``STATE_COLUMNS`` order: the instances that wait at a
        receive task hold their process and task element instances, the
        boundary's timer and the message subscription; nothing else is
        left (a service task's job completes inside its drive, a message
        without time to live is deleted when published)."""
        enc, sem = self.enc, self.sem
        w = np.nonzero(rest.waiting)[0]
        tables = {name: np.zeros((0, len(cols) + (3 * enc.num_vars if pay else 0)), np.int64)
                  for name, (cols, pay) in STATE_COLUMNS.items()}
        if not len(w):
            return tables
        task = [e["id"] for e in sem.elements.values() if e["type"] == "receiveTask"][0]
        bd = sem.boundaries(task)[0]
        msg = sem.elements[task]
        vt, num, sid = self._payload(w, np.zeros(len(w), np.int64), rest.merged[w])
        pay = np.concatenate([vt.astype(np.int64), sid.astype(np.int64),
                              num.view(np.int32).astype(np.int64)], axis=1)
        k_inst, k_task = self.values["k_inst"][w], self.values["k:" + task][w]
        one = np.ones(len(w), np.int64)

        def rows(*cols):
            return np.stack([np.broadcast_to(np.asarray(c, np.int64), (len(w),)) for c in cols],
                            axis=1)

        proc = rows(k_inst, k_inst, -one, enc.elem[sem.process] * one,
                    WI["ELEMENT_ACTIVATED"] * one,
                    enc.wf_slot * one, -one, one, -one)
        act = rows(k_task, k_inst, -one, enc.elem[task] * one, WI["ELEMENT_ACTIVATED"] * one,
                   enc.wf_slot * one, k_inst, 0 * one, -one)
        tables["ei"] = np.concatenate([np.concatenate([proc, pay], 1),
                                       np.concatenate([act, pay], 1)])
        tables["timer"] = rows(self.values["timer"][w], self.values["due:" + bd][w], k_task,
                               k_inst, enc.elem[bd] * one, enc.wf_slot * one)
        name_id = enc.interns[msg["message"]]
        bits = self.values["bits:" + msg["correlationKey"]][w] & 0xFFFFFFFF
        tables["msub"] = rows(composite(name_id, bits), name_id * one, VT_NUM * one,
                              np.asarray(bits, np.uint32).view(np.int32).astype(np.int64),
                              self.values["part:inst"][w], k_inst, k_task)
        # each table's rows on this partition: the instance's own, and the
        # subscriptions whose correlation key hashes here
        for name, at in (("ei", "part:inst"), ("timer", "part:inst"), ("msub", "part:msg")):
            mine = self.values[at][w] == self.pid
            tables[name] = tables[name][np.tile(mine, len(tables[name]) // len(w))]
        return tables


class Cluster:
    """``partitions`` partitions of one configuration: their logs, key
    counters and state (see the module's docstring). With one partition it
    is that ``Partition``, call for call. Inputs are routed as Zeebe's
    gateway routes them: CREATE ``i`` to partition ``i % partitions``, a
    PUBLISH to the partition of its correlation key's hash; each partition
    ticks its own timers."""

    def __init__(self, sem: Semantics, enc: Encoding, n: int, partitions: int = 1):
        self.sem, self.enc, self.n, self.size = sem, enc, n, partitions
        first = Partition(sem, enc, n)
        self.parts = [first] + [
            Partition(sem, enc, n, (p << PARTITION_SHIFT) + WF_KEY0,
                      (p << PARTITION_SHIFT) + JOB_KEY0, pid=p, shared=first)
            for p in range(1, partitions)]
        self.values = first.values
        self.values["part:inst"][:] = np.arange(n) % partitions
        self.lockstep = sem.has_messages and partitions > 1
        # per drive, the rounds each partition read
        self.read: List[List[int]] = []

    @property
    def counters(self) -> List[Dict[str, int]]:
        return [p.counters for p in self.parts]

    @property
    def kind_counts(self) -> np.ndarray:
        """[partition, kind]: the records each partition processed."""
        return np.stack([p.kind_counts for p in self.parts])

    # -- inputs ---------------------------------------------------------------------
    def create(self, variables: Dict[str, np.ndarray]):
        own = self.values["part:inst"]
        for p in self.parts:
            p.create(variables, np.nonzero(own == p.pid)[0])
        receive = [e for e in self.sem.elements.values() if e["type"] == "receiveTask"]
        if receive:
            e = receive[0]
            self.values["part:msg"][:] = hash_partition(
                composite(self.enc.interns[e["message"]],
                          self.values["bits:" + e["correlationKey"]]), self.size)

    def publish(self, order: np.ndarray, variables: Dict[str, object]):
        order = np.asarray(order, np.int64)
        to = self.values["part:msg"][order]
        for p in self.parts:
            p.publish(order[to == p.pid], variables)

    def tick(self, now: int) -> List[np.ndarray]:
        return [p.tick(now) for p in self.parts]

    def trigger(self, fires: List[np.ndarray]):
        for p, fire in zip(self.parts, fires):
            p.trigger(fire)

    # -- the drive ----------------------------------------------------------------------
    def drive(self, batch_size: int, now: int,
              capture: Optional[Dict[Tuple[int, int], Tuple[int, int]]] = None):
        """Every partition's log read until all drain. Returns each
        partition's totals, the rounds being the drive's (the most any
        partition read), and the ``Rows`` of each (partition, round) in
        ``capture`` ({(partition, round): (row, count)})."""
        capture = capture or {}
        if not self.lockstep:
            out = [p.drive(batch_size, now, {r: v for (q, r), v in capture.items()
                                             if q == p.pid}) for p in self.parts]
            self.read.append([t["rounds"] for t, _ in out])
            rounds = max(self.read[-1])
            captured = {(p, r): rows for p, (_, caps) in enumerate(out)
                        for r, rows in caps.items()}
            return [dict(t, rounds=rounds) for t, _ in out], captured
        totals = [dict(processed=0, emitted=0, completed_roots=0, rounds=0) for _ in self.parts]
        captured = {}
        while any(len(p.q_inst) for p in self.parts):
            sends = []
            for p, t in zip(self.parts, totals):
                ci, ck, src = p.round(batch_size, now, t)
                if (p.pid, t["rounds"]) in capture:
                    row, count = capture[(p.pid, t["rounds"])]
                    captured[(p.pid, t["rounds"])] = p._rows(ci, ck, src, row, count)
                rt = self.sem.route[ck]
                to = np.where(rt == TO_MSG, self.values["part:msg"][ci],
                              np.where(rt == TO_INST, self.values["part:inst"][ci], p.pid))
                sends.append([(ci[to == q], ck[to == q]) for q in range(self.size)])
            for q in self.parts:
                q._enqueue(*sends[q.pid][q.pid])
                for p in range(self.size):
                    if p != q.pid:
                        q._enqueue(*sends[p][q.pid])
        self.read.append([t["rounds"] for t in totals])
        return totals, captured

    # -- what the records and the state hold ------------------------------------------------
    def records(self, rows: "Rows") -> Dict[str, np.ndarray]:
        return self.parts[0].records(rows)

    def trigger_rows(self, fire: np.ndarray, row: int, count: int) -> "Rows":
        return self.parts[0].trigger_rows(fire, row, count)

    def snapshot(self) -> "Rest":
        return self.parts[0].snapshot()

    def state_rows(self, rest: "Rest") -> List[Dict[str, np.ndarray]]:
        return [p.state_rows(rest) for p in self.parts]

    def shift_keys(self, deltas: List[Dict[str, int]]):
        """Move every key partition p drew, and its counters, by
        ``deltas[p]`` ({"wf": .., "job": ..}): a unit that the engine ran
        after others draws the same keys as one run first, moved by what
        those drew on each partition. A key's high bits name the partition
        that drew it."""
        drawn = {slot: fam for kd in self.sem.kinds.values() for slot, fam in kd.alloc}
        for slot, fam in drawn.items():
            v = self.values.get(slot)
            if v is not None:
                by = np.where(v >= 0, v >> PARTITION_SHIFT, 0)
                shift = np.array([d[fam] for d in deltas], np.int64)[by]
                v[v >= 0] += shift[v >= 0]
        for p, d in zip(self.parts, deltas):
            p.counters = {f: c + d[f] for f, c in p.counters.items()}

    def draws(self, kind_counts: np.ndarray) -> List[Dict[str, int]]:
        """The keys of each family that partitions drew for ``kind_counts``
        ([partition, kind] records processed), in key steps."""
        alloc = self.parts[0]._alloc
        return [{fam: int(KEY_STEP * (c @ alloc[fam])) for fam in ("wf", "job")}
                for c in kind_counts]


def unit_kind_counts(sem: Semantics, enc: Encoding, n: int, partitions: int,
                     steps) -> np.ndarray:
    """[partition, kind]: the records each partition processes over one
    unit, without reading its logs: every input record leads to the same
    records whatever the rounds, each processed on its instance's partition
    or its correlation key's, so the counts follow from the instances'
    partitions. ``steps`` is the unit's inputs in order: ("create",
    {variable: values}, at), ("publish", order, at) or ("tick", None, at).
    The keys a unit draws on each partition are these counts through
    ``Cluster.draws``."""
    cl = Cluster(sem, enc, n, partitions)
    k = len(sem.names)
    # each input kind's records by where they are processed: on the
    # instance's partition (0) or the message's (1); and what they leave
    tree = {}
    for root, at_msg in (("CREATE", 0), ("PUBLISH", 1), ("TRIGGER", 0)):
        if root not in sem.index:
            continue
        counts = np.zeros((2, k), np.int64)
        due, waits = [], None
        stack = [(sem.index[root], at_msg)]
        while stack:
            i, where = stack.pop()
            counts[where, i] += 1
            kd = sem.kinds[sem.names[i]]
            due += [(slot, d) for slot, d in kd.sets if slot.startswith("due:")]
            if kd.waits and waits is None:
                waits = True
            if kd.correlates or kd.fires:
                waits = False
            for c in kd.children:
                rt = sem.route[sem.index[c]]
                stack.append((sem.index[c], where if rt == STAY else int(rt == TO_MSG)))
        tree[root] = (counts, due[:1], waits)
    out = np.zeros((partitions, k), np.int64)
    waiting = np.zeros(n, bool)
    when = np.full(n, -1, np.int64)
    for op, arg, at in steps:
        if op == "create":
            cl.create(arg)
            root, inst = "CREATE", np.arange(n)
        elif op == "publish":
            root, inst = "PUBLISH", np.asarray(arg, np.int64)
        else:
            root, inst = "TRIGGER", np.nonzero(waiting & (when >= 0) & (when <= at))[0]
        counts, due, waits = tree[root]
        for where, part in enumerate(("part:inst", "part:msg")):
            out += np.outer(np.bincount(cl.values[part][inst], minlength=partitions), counts[where])
        for _slot, d in due:
            when[inst] = at + d
        if waits is not None:
            waiting[inst] = waits
    return out


# each table's digest columns: (names, with the packed payload after them)
STATE_COLUMNS = {
    "ei": (("key", "instance_key", "job_key", "elem", "state", "wf", "scope_key", "tokens",
            "pending_boundary"), True),
    "job": (("key", "instance_key", "aik", "deadline", "state", "elem", "wf", "type",
             "retries", "worker"), True),
    "timer": (("key", "due", "aik", "instance_key", "elem", "wf"), False),
    "msub": (("ckey", "name", "cvt", "cbits", "partition", "wikey", "aik"), False),
    "msg": (("key", "ckey", "name", "cvt", "cbits", "msgid", "deadline"), True),
}


def digest(rows: np.ndarray) -> int:
    """An order-free digest of a table's rows (int64 columns): each row is
    folded into one int64 and the rows are summed, all modulo 2^64. The
    harness computes the same on the device."""
    if rows.shape[0] == 0:
        return 0
    with np.errstate(over="ignore"):
        h = np.zeros(rows.shape[0], np.int64)
        for c in range(rows.shape[1]):
            h = h * np.int64(DIGEST_MUL) + rows[:, c]
        h = h ^ (h >> np.int64(33))
        h = h * np.int64(DIGEST_MIX)
        h = h ^ (h >> np.int64(29))
        return int(h.sum(dtype=np.int64))


DIGEST_MUL = 0x100000001B3
DIGEST_MIX = 0x62A9D9ED799705F5


def compare_records(got: Dict[str, np.ndarray],
                    want: Dict[str, np.ndarray]) -> Tuple[int, int, Optional[str]]:
    """(rows compared, rows that differ, the first difference). A row the
    reference has no record for has to be invalid; a valid row has to
    agree in every column, payload numbers bit for bit."""
    rows = len(want["valid"])
    bad = np.zeros(rows, bool)
    first = None
    valid = want["valid"].astype(bool)
    for f in FIELDS + PAYLOAD:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if f == "v_num":
            g = g.astype(np.float32).view(np.int32)
            w = w.astype(np.float32).view(np.int32)
        g = g.astype(np.int64).reshape(rows, -1)
        w = w.astype(np.int64).reshape(rows, -1)
        diff = (g != w).any(axis=1)
        if f != "valid":
            diff &= valid
        if diff.any() and first is None:
            r = int(np.nonzero(diff)[0][0])
            first = f"row {r} column {f}: got {g[r].tolist()}, want {w[r].tolist()}"
        bad |= diff
    return rows, int(bad.sum()), first
