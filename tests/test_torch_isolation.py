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
]
# jsonpath's msgpack traverser lazily imports zeebe_tpu.protocol.msgpack;
# it is off the compile path and the copy drops it
DROPPED = {"protocol/jsonpath.py": "traverse"}
_IMPORT = re.compile(r"^(\s*)(from|import) zeebe_tpu\.")


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
    assert len(sources) > 20
    offenders = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imported_modules(tree):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "zeebe_tpu"):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {mod}")
    assert offenders == []


def _expected_copy(rel):
    with open(os.path.join(ROOT, "zeebe_tpu", rel)) as f:
        src = f.read()
    if rel in DROPPED:
        tree = ast.parse(src)
        fn = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == DROPPED[rel])
        lines = src.splitlines(keepends=True)
        src = "".join(lines[: fn.lineno - 1] + lines[fn.end_lineno:]).rstrip() + "\n"
    return "".join(
        _IMPORT.sub(r"\1\2 zeebe_tpu_torch.", line)
        for line in src.splitlines(keepends=True)
    )


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_its_source_but_imports(rel):
    with open(os.path.join(PORT, rel)) as f:
        assert f.read() == _expected_copy(rel)


def _entry_points():
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn
    from zeebe_tpu_torch.models.transform.transformer import transform_model
    from zeebe_tpu_torch.tpu import batch, drive, graph, state

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
    }


@pytest.mark.parametrize("name", ["make_state", "compile_graph", "empty",
                                  "make_queue", "state_from_numpy"])
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
                "zeebe_tpu_torch.tpu.drive"):
        importlib.import_module(mod)
    assert _build._libs == {}
    assert sorted(os.listdir(os.path.join(PORT, "csrc"))) == [
        "gather_rows.cu", "hash_lookup.cu", "hash_update.cu", "table_commit.cu",
        "zb_hash.cuh",
    ]
    assert sorted(_build.SOURCES) == [
        "gather_rows", "hash_lookup", "hash_update", "table_commit",
    ]
