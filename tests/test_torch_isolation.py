"""zeebe_tpu_torch stands alone: no JAX, nothing of zeebe_tpu, its copied
modules unchanged but for their imports, and no quiet CPU fallback."""

import ast
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "zeebe_tpu_torch")

# (copy in zeebe_tpu_torch, source in zeebe_tpu): verbatim but for imports
COPIED = [
    "protocol/enums.py", "protocol/intents.py", "engine/keyspace.py",
    "models/bpmn/model.py", "models/bpmn/builder.py", "models/el/ast.py",
    "models/el/parser.py", "protocol/jsonpath.py", "models/transform/steps.py",
    "models/transform/executable.py", "models/transform/transformer.py",
    "tpu/intern.py",
    # the engine's host oracle and its record model
    "protocol/__init__.py", "protocol/metadata.py", "protocol/msgpack.py",
    "protocol/records.py", "protocol/codec.py", "protocol/columnar.py",
    "engine/mappings.py", "models/el/interpreter.py", "models/bpmn/xml.py",
    "models/bpmn/validation.py", "models/bpmn/yaml_front.py",
    "engine/interpreter.py",
    # the log and snapshots
    "_events.py", "log/__init__.py", "log/storage.py", "log/logstream.py",
    "log/snapshot.py", "log/stateser.py",
    # the in-process broker, its drain and its client
    "tracing/__init__.py", "tracing/recorder.py", "tracing/spans.py",
    "runtime/__init__.py", "runtime/clock.py", "runtime/actors.py",
    "runtime/metrics.py", "runtime/broker.py",
    "scheduler/__init__.py", "scheduler/admission.py",
    "scheduler/placement.py", "scheduler/wave.py",
    "exporter/__init__.py", "exporter/base.py", "exporter/director.py",
    "exporter/jsonl.py", "exporter/memory.py", "exporter/metrics_exporter.py",
    "gateway/__init__.py", "gateway/client.py", "gateway/workers.py",
    # the cluster node: config, transport, gossip and raft, the native
    # layer, the raft-replicated broker, its TCP client, the gRPC gateway
    # and the test harnesses
    "runtime/config.py", "transport/__init__.py", "transport/transport.py",
    "runtime/services.py", "cluster/__init__.py", "cluster/gossip.py",
    "cluster/raft.py", "native/__init__.py", "runtime/cluster_broker.py",
    "gateway/cluster_client.py", "gateway/proto/__init__.py",
    "gateway/proto/gateway_pb2.py", "gateway/grpc_gateway.py",
    "testing/__init__.py", "testing/stub_broker.py", "testing/chaos.py",
]
# top-level functions and classes a copy leaves out:
# - jsonpath's msgpack traverser lazily imports zeebe_tpu.protocol.msgpack;
#   it is off the compile path
DROPPED = {
    "protocol/jsonpath.py": ("traverse",),
}
# (source text, copy text) pairs a copy replaces, each found exactly once
REPLACED = {
    # DevicePlan's default device list: the visible CUDA cards, not jax's
    "scheduler/placement.py": [(
        "            import jax\n\n            devices = jax.devices()\n",
        "            import torch\n\n            devices = [\n"
        "                torch.device(\"cuda\", i)\n"
        "                for i in range(torch.cuda.device_count())\n"
        "            ]\n",
    ), (
        # MeshExchange's devices form the port's Mesh (tpu/shard.py), whose
        # frame exchange copies each (source, destination) block once
        "        from jax.sharding import Mesh\n\n",
        "",
    ), (
        "        import numpy as _np\n\n"
        "        mesh = Mesh(_np.asarray(self.devices), (\"exchange\",))\n",
        "        mesh = shard.Mesh(self.devices, \"exchange\")\n",
    )],
    # after the replay, the engine counts the job records of the tail the
    # last leader appended and never processed (CudaPartitionEngine's
    # note_unprocessed): its tick leaves those jobs out of the backlog
    "runtime/broker.py": [(
        "            partition.next_read_position = record.position + 1\n",
        "            partition.next_read_position = record.position + 1\n"
        "        # the tail is written and not processed: an engine that gates the\n"
        "        # tick's job backlog on activations in flight counts it before the\n"
        "        # first tick\n"
        '        note_unprocessed = getattr(partition.engine, "note_unprocessed", None)\n'
        "        if note_unprocessed is not None:\n"
        "            note_unprocessed(partition.log.reader(partition.next_read_position))\n",
    )],
    "runtime/cluster_broker.py": [(
        # a partition moved off an excluded device by a same-term reinstall
        # (always so for a sharded engine) keeps its workers' subscriptions:
        # a worker sees the same address and term and does not subscribe again
        "                    term = server.raft.term\n"
        "                    # same-node reinstall: leadership stays here, so the\n"
        "                    # partition's live spans are NOT orphaned\n"
        "                    server._uninstall_leader(orphan_spans=False)\n"
        "                    server._install_leader(term)\n",
        "                    term = server.raft.term\n"
        "                    # job subscriptions are the live engine's session state,\n"
        "                    # and a worker sees the same leader address and term, so\n"
        "                    # it never subscribes again: the reinstalled engine takes\n"
        "                    # them over (a sharded engine, pinned to its span, always\n"
        "                    # moves this way)\n"
        "                    try:\n"
        "                        subs = server.engine.job_subscriptions()\n"
        "                    except Exception:  # noqa: BLE001 - unreadable tables\n"
        "                        subs = []\n"
        "                    # same-node reinstall: leadership stays here, so the\n"
        "                    # partition's live spans are NOT orphaned\n"
        "                    server._uninstall_leader(orphan_spans=False)\n"
        "                    server._install_leader(term)\n"
        "                    for sub in subs if server.engine is not None else ():\n"
        "                        backlog = server.engine.add_job_subscription(sub)\n"
        "                        if backlog:\n"
        "                            observe_append(\n"
        "                                server.raft.append(backlog),\n"
        "                                \"job-subscription backlog\", pid,\n"
        "                            )\n",
    ), (
        "            self.engine.process(record)\n"
        "            self.next_read_position = record.position + 1\n"
        "        self.is_leader = True\n",
        "            self.engine.process(record)\n"
        "            self.next_read_position = record.position + 1\n"
        "        # the tail is written and not processed: an engine that gates the\n"
        "        # tick's job backlog on activations in flight counts it before the\n"
        "        # first tick\n"
        '        note_unprocessed = getattr(self.engine, "note_unprocessed", None)\n'
        "        if note_unprocessed is not None:\n"
        "            note_unprocessed(self.log.reader(self.next_read_position))\n"
        "        self.is_leader = True\n",
    ), (
        # a step-down that arrives while the leader install is still running
        # (the install checked the term before it) must uninstall after it:
        # the CUDA engine's install is long enough that a follower kept serving
        "        elif self.is_leader:\n"
        "            self.broker.actor_control.run(self._uninstall_leader)\n",
        "        else:\n"
        "            # decided on the actor, behind an install that may still be\n"
        "            # running for the term just left: it checked the term before\n"
        "            # this step-down and would otherwise leave a follower serving\n"
        "            self.broker.actor_control.run(\n"
        "                lambda: self.is_leader and self._uninstall_leader()\n"
        "            )\n",
    ), (
        # the tick armed anew when it ends, not at a fixed rate: ticks slower
        # than their period (a device engine's probe on a loaded host) piled
        # up in the broker actor's mailbox ahead of the drain
        "        self.actor.run_at_fixed_rate(100, self._tick_engines)\n",
        "        self._tick_due = self.scheduler.now_ms() + 100\n"
        "        self.actor.run_delayed(100, self._tick_and_rearm)\n",
    ), (
        "    def _tick_engines(self) -> None:\n",
        "    def _tick_and_rearm(self) -> None:\n"
        '        """The engines\' tick every 100 ms, armed anew when it ends: a fixed\n'
        "        rate enqueues a tick every period whatever a tick takes, so ticks\n"
        "        slower than that (a device engine's probe on a loaded host) pile up\n"
        "        in this actor's mailbox ahead of the drain and the client requests,\n"
        "        and processing falls seconds behind the commits. One tick at most is\n"
        "        ever queued. The next is due a period after this one was, or at once\n"
        "        when that has passed, so the rate stays the period's while ticks\n"
        "        keep up (a credit drought's device backlog is served on the tick\n"
        "        after the one that launched the due probe); a tick that itself\n"
        '        outlasted the period leaves the actor a period for the rest."""\n'
        "        start = self.scheduler.now_ms()\n"
        "        try:\n"
        "            self._tick_engines()\n"
        "        finally:\n"
        "            if not self._closing:\n"
        "                now = self.scheduler.now_ms()\n"
        "                if now - start >= 100:\n"
        "                    self._tick_due = now + 100\n"
        "                else:\n"
        "                    self._tick_due = max(self._tick_due + 100, now)\n"
        "                self.actor.run_delayed(self._tick_due - now, self._tick_and_rearm)\n"
        "\n"
        "    def _tick_engines(self) -> None:\n",
    )],
    # instance and job keys carry the partition in their high bits, as the
    # reference's do: a message partition told subscriptions of two
    # partitions' instances with equal keys apart by nothing
    "engine/interpreter.py": [(
        "        self.job_keys = keyspace.job_keys()\n",
        "        self.job_keys = keyspace.job_keys()\n"
        "        # instance and job keys carry the partition in their high bits\n"
        "        # (reference Protocol.encodePartitionId): a message partition holds\n"
        "        # subscriptions of several partitions' instances, and tells them\n"
        "        # apart by their keys\n"
        "        for keys in (self.wf_keys, self.job_keys):\n"
        "            keys.set_key(keys.peek + (partition_id << 51) - keyspace.STEP_SIZE)\n",
    )],
    # the port's engine is the CUDA one: a node started with no [engine]
    # type serves on the card, and only an explicit "host" picks the oracle
    "runtime/config.py": [(
        '    type: str = "host"  # "host" | "tpu"\n',
        "    # the port serves on the card unless a config asks for the oracle\n"
        '    type: str = "cuda"  # "host" | "cuda"\n',
    )],
    # a broker re-elected at a higher term keeps its address and installs a
    # new engine without the job subscriptions: the worker's monitor reads
    # the leader's term from the topology and subscribes again when it moves
    "gateway/cluster_client.py": [(
        "        self._leaders: Dict[int, RemoteAddress] = {}\n",
        "        self._leaders: Dict[int, RemoteAddress] = {}\n"
        "        # partition id → the raft term of that leader, as the topology says\n"
        "        self._leader_terms: Dict[int, int] = {}\n",
    ), (
        "            leaders = {}\n",
        "            leaders, terms = {}, {}\n",
    ), (
        "                leaders[int(pid)] = RemoteAddress(a[0], int(a[1]))\n",
        "                leaders[int(pid)] = RemoteAddress(a[0], int(a[1]))\n"
        '                terms[int(pid)] = int(entry.get("term", -1))\n',
    ), (
        "                    self._leaders = leaders\n",
        "                    self._leaders = leaders\n"
        "                    self._leader_terms = terms\n",
    ), (
        "        self._subscribed_addr: Dict[int, RemoteAddress] = {}\n",
        "        self._subscribed_addr: Dict[int, RemoteAddress] = {}\n"
        "        self._subscribed_term: Dict[int, Optional[int]] = {}\n",
    ), (
        "                if self._subscribed_addr.get(pid) != addr:\n",
        "                # a broker re-elected at a higher term keeps its address\n"
        "                # but installs a new engine, which holds no subscription\n"
        "                with self.client._lock:\n"
        "                    term = self.client._leader_terms.get(pid)\n"
        "                if (\n"
        "                    self._subscribed_addr.get(pid) != addr\n"
        "                    or self._subscribed_term.get(pid) != term\n"
        "                ):\n",
    ), (
        "                backoff.sleep()\n"
        "                continue\n"
        "            try:\n"
        "                payload = self.client.transport.send_request(\n"
        "                    addr, request, timeout_ms=2000\n",
        "                backoff.sleep()\n"
        "                continue\n"
        "            # the term is read before the request: an engine installed\n"
        "            # after it shows a higher term, which the monitor resubscribes\n"
        "            with self.client._lock:\n"
        "                term = self.client._leader_terms.get(partition)\n"
        "            try:\n"
        "                payload = self.client.transport.send_request(\n"
        "                    addr, request, timeout_ms=2000\n",
    ), (
        "                    self._subscribed_addr[partition] = addr\n"
        "                    return\n",
        "                    self._subscribed_addr[partition] = addr\n"
        "                    self._subscribed_term[partition] = term\n"
        "                    return\n",
    ), (
        # a job pushed twice for one activation (the leader that stepped
        # down pushed it before its ACTIVATED event committed, the next one
        # pushes it again) is handled once, unless its completion was lost
        "    def __init__(self, client, job_type, handler, worker_name, credits, timeout_ms, partitions):\n"
        "        self.handler = handler\n"
        "        self.handled: List[Record] = []\n",
        "    def __init__(self, client, job_type, handler, worker_name, credits, timeout_ms, partitions):\n"
        "        self.handler = handler\n"
        "        self.handled: List[Record] = []\n"
        "        # activations taken, (partition, job key, deadline) → whether the\n"
        "        # completion reached a leader (None while it is on its way, or the\n"
        "        # activation's second push, kept until it is known)\n"
        "        self._taken: Dict[tuple, Any] = {}\n"
        "        self._taken_lock = threading.Lock()\n",
    ), (
        "    def _on_record(self, partition: int, record: Record, epoch: int = -1) -> None:\n"
        "        self.handled.append(record)\n"
        "        try:\n"
        "            result = self.handler(partition, record)\n",
        "    def _on_record(self, partition: int, record: Record, epoch: int = -1) -> None:\n"
        "        # one activation can be pushed twice: a leader that steps down\n"
        "        # pushes the job before its ACTIVATED event commits, and the next\n"
        "        # leader, processing the same ACTIVATE command, pushes it again\n"
        "        # with the same deadline. It is handled once: a second push that\n"
        "        # comes while the first completion is on its way is kept, and\n"
        "        # handled only if that completion never reaches a leader\n"
        "        taken = (partition, record.key, record.value.deadline)\n"
        "        with self._taken_lock:\n"
        "            state = self._taken.get(taken, False)\n"
        "            if state is not False:\n"
        "                if state is None:\n"
        "                    self._taken[taken] = record\n"
        "                return\n"
        "            self._taken[taken] = None\n"
        "            while len(self._taken) > 4096:\n"
        "                self._taken.pop(next(iter(self._taken)))\n"
        "        self.handled.append(record)\n"
        "        try:\n"
        "            result = self.handler(partition, record)\n",
    ), (
        "    def _finish(self, partition: int, record: Record, result, failed: bool) -> None:\n"
        "        try:\n"
        "            if failed:\n"
        "                try:\n"
        "                    self.client.fail_job(\n"
        "                        partition, record.key, record.value.retries - 1\n"
        "                    )\n"
        "                except (ClientException, TransportError, TimeoutError):\n"
        "                    pass  # job already final or broker unreachable\n"
        "                return\n",
        "    def _finish(self, partition: int, record: Record, result, failed: bool) -> None:\n"
        "        reached = True\n"
        "        try:\n"
        "            if failed:\n"
        "                try:\n"
        "                    self.client.fail_job(\n"
        "                        partition, record.key, record.value.retries - 1\n"
        "                    )\n"
        "                except ClientException:\n"
        "                    pass  # job already final\n"
        "                except (TransportError, TimeoutError):\n"
        "                    reached = False  # broker unreachable\n"
        "                return\n",
    ), (
        "            except (TransportError, TimeoutError):\n"
        "                # broker unreachable: the job times out server-side and\n"
        "                # re-activates; this worker keeps its credit flowing\n"
        "                pass\n"
        "        finally:\n"
        "            self._return_credit(partition)\n",
        "            except (TransportError, TimeoutError):\n"
        "                # broker unreachable: the job times out server-side and\n"
        "                # re-activates; this worker keeps its credit flowing\n"
        "                reached = False\n"
        "        finally:\n"
        "            taken = (partition, record.key, record.value.deadline)\n"
        "            with self._taken_lock:\n"
        "                again = self._taken.get(taken)\n"
        "                if taken in self._taken:\n"
        "                    self._taken[taken] = reached\n"
        "            self._return_credit(partition)\n"
        "            if not reached and isinstance(again, Record):\n"
        "                self._on_record(partition, again)\n",
    )],
    # native/Makefile writes the JAX package's library; a TARGET on make's
    # command line overrides it, so the port's copy builds beside itself
    "native/__init__.py": [(
        '            ["make", "-C", os.path.abspath(_SRC_DIR)],\n',
        "            # the Makefile's TARGET names the JAX package's copy; a\n"
        "            # variable given on make's command line overrides it\n"
        '            ["make", "-C", os.path.abspath(_SRC_DIR),\n'
        '             "TARGET=" + os.path.abspath(_LIB_PATH)],\n',
    )],
}
# lazy imports of modules the port does not copy, each off the served path
UNRESOLVED: set = set()
_IMPORT = re.compile(r"^(\s*)(from|import) zeebe_tpu(?=[. ])")


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PORT):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_modules(tree):
    for node in ast.walk(tree):  # every depth: functions, branches, classes
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "id", getattr(node.func, "attr", "")) in
              ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_jax_and_no_zeebe_tpu_imports_at_any_depth():
    sources = _port_sources()
    assert len(sources) >= 90  # the 89 modules of the port and chip_smoke.py
    offenders = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imported_modules(tree):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "zeebe_tpu"):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {mod}")
    assert offenders == []


def test_the_probe_benchmark_imports_no_jax_and_nothing_of_zeebe_tpu():
    """``zeebe_tpu_torch/probe.py``, the counterpart of
    ``benchmarks/pallas_probe.py``, is its own copy: no JAX, nothing of
    the JAX package or of ``benchmarks``, at any depth."""
    path = os.path.join(PORT, "probe.py")
    assert path in _port_sources()
    with open(path) as f:
        mods = {m.split(".")[0] for m in _imported_modules(ast.parse(f.read(), path))}
    assert mods & {"jax", "jaxlib", "zeebe_tpu", "benchmarks"} == set()
    assert "zeebe_tpu_torch" in mods


def test_the_mesh_modules_import_no_jax_and_nothing_of_zeebe_tpu():
    """``tpu/shard.py`` (the mesh's state steps and exchanges) and the
    copied ``scheduler/placement.py`` (``MeshExchange``) run on torch alone,
    at any depth."""
    for rel in ("tpu/shard.py", "scheduler/placement.py"):
        path = os.path.join(PORT, rel)
        assert path in _port_sources()
        with open(path) as f:
            mods = {m.split(".")[0] for m in _imported_modules(ast.parse(f.read(), path))}
        assert mods & {"jax", "jaxlib", "zeebe_tpu"} == set(), rel
        assert "zeebe_tpu_torch" in mods, rel
    from zeebe_tpu_torch.scheduler import MeshExchange
    from zeebe_tpu_torch.tpu import shard

    assert MeshExchange.__module__ == "zeebe_tpu_torch.scheduler.placement"
    assert shard.build_frame_exchange.__module__ == "zeebe_tpu_torch.tpu.shard"


def _module_file(parts):
    """The file of module ``zeebe_tpu_torch.<...>``, or None."""
    base = os.path.join(ROOT, *parts)
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def _defines(path, name):
    """True when the module at ``path`` binds ``name`` at its top level."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name:
            return True
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if any((a.asname or a.name.split(".")[0]) == name for a in node.names):
                return True
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        for target in targets:
            elts = target.elts if isinstance(target, ast.Tuple) else [target]
            if any(isinstance(t, ast.Name) and t.id == name for t in elts):
                return True
    return False


def test_every_port_import_resolves_to_a_module_of_the_port():
    """A missing copy would show only at run time on the card: every
    ``zeebe_tpu_torch`` import, at any depth, names a module of the port or
    a name its module binds, but for the listed lazy imports of modules the
    port leaves out."""
    missing = set()
    for path in _port_sources():
        rel = os.path.relpath(path, PORT)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                wanted = [(a.name.split("."), None) for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                wanted = [(node.module.split("."), a.name) for a in node.names]
            else:
                continue
            for parts, name in wanted:
                if parts[0] != "zeebe_tpu_torch":
                    continue
                module = _module_file(parts)
                if module is not None and (
                    name is None or _module_file(parts + [name]) is not None
                    or _defines(module, name)
                ):
                    continue
                missing.add((rel, ".".join(parts + ([name] if name else []))))
    assert missing == UNRESOLVED


def test_probe_bits_are_the_ones_the_broker_reads():
    """The copied broker's tick imports PROBE_JOB_BACKLOG from the port's
    engine module; the bits are the JAX engine's (1 and 2)."""
    from zeebe_tpu_torch.runtime import broker
    from zeebe_tpu_torch.tpu import engine

    assert (engine.PROBE_DEADLINES, engine.PROBE_JOB_BACKLOG) == (1, 2)
    with open(broker.__file__) as f:
        assert "from zeebe_tpu_torch.tpu.engine import PROBE_JOB_BACKLOG" in f.read()


def _expected_copy(rel):
    with open(os.path.join(ROOT, "zeebe_tpu", rel)) as f:
        src = f.read()
    for old, new in REPLACED.get(rel, ()):
        assert src.count(old) == 1, (rel, old)
        src = src.replace(old, new)
    if rel in DROPPED:
        tree = ast.parse(src)
        lines = src.splitlines(keepends=True)
        spans = [
            (n.lineno - 1 - len(n.decorator_list), n.end_lineno)
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in DROPPED[rel]
        ]
        assert len(spans) == len(DROPPED[rel]), rel
        for start, end in sorted(spans, reverse=True):
            lines[start:end] = []
        src = "".join(lines).rstrip() + "\n"
    return "".join(
        _IMPORT.sub(r"\1\2 zeebe_tpu_torch", line)
        for line in src.splitlines(keepends=True)
    )


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_its_source_but_imports(rel):
    with open(os.path.join(PORT, rel)) as f:
        assert f.read() == _expected_copy(rel)


def _entry_points():
    from zeebe_tpu_torch import probe
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn
    from zeebe_tpu_torch.models.transform.transformer import transform_model
    from zeebe_tpu_torch.tpu import batch, drive, graph, state
    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    workflows = transform_model(
        Bpmn.create_process("p").start_event().service_task("t", type="x")
        .end_event().done()
    )
    cpu_state = state.state_to_numpy(state.make_state(capacity=16, device="cpu"))
    return {
        "make_state": lambda: state.make_state(capacity=16),
        "compile_graph": lambda: graph.compile_graph(workflows),
        "empty": lambda: batch.empty(4, 2),
        "make_queue": lambda: drive.make_queue(8, 2),
        "state_from_numpy": lambda: state.state_from_numpy(cpu_state),
        "engine": lambda: CudaPartitionEngine(0, 1, capacity=16),
        "probe": lambda: probe.main(),
    }


@pytest.mark.parametrize("name", ["make_state", "compile_graph", "empty",
                                  "make_queue", "state_from_numpy", "engine",
                                  "probe"])
def test_entry_point_without_device_raises_on_a_host_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_explicit_cpu_device_is_honoured():
    from zeebe_tpu_torch.tpu import drive

    q = drive.make_queue(8, 2, device="cpu")
    assert q.rows.key.device.type == "cpu" and q.count.dtype == torch.int32


def test_importing_the_package_needs_no_nvcc_or_gpu():
    """The kernels build at their first launch, never at import."""
    import importlib

    from zeebe_tpu_torch import _build

    for mod in ("zeebe_tpu_torch.tpu.ops", "zeebe_tpu_torch.tpu.kernel",
                "zeebe_tpu_torch.tpu.drive", "zeebe_tpu_torch.probe"):
        importlib.import_module(mod)
    assert _build._libs == {}
    assert sorted(os.listdir(os.path.join(PORT, "csrc"))) == [
        "gather_rows.cu", "hash_lookup.cu", "hash_update.cu", "probe.cu",
        "scatter_accum.cu", "table_commit.cu", "zb_hash.cuh",
    ]
    assert sorted(_build.SOURCES) == [
        "gather_rows", "hash_lookup", "hash_update", "probe", "scatter_accum",
        "table_commit",
    ]
