"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds, not minutes). Libraries go to
``build/zeebe_tpu_torch/`` at the root of the checkout, named by a hash of
their source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is loaded as it is.
All sources compile in parallel, one ``nvcc`` each.

Nothing here runs at import: the first kernel launch builds. Importing
the package therefore needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "zeebe_tpu_torch"
SOURCES = ("gather_rows", "table_commit", "scatter_accum", "hash_lookup", "hash_update",
           "probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# wall seconds of the last build_all() that compiled anything (0.0 when
# every library was already built), and nvcc's -Xptxas=-v report per source
last_build_seconds = 0.0
ptxas_reports: Dict[str, str] = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (in parallel) and load all of them."""
    global last_build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SOURCES:
            target = _target(name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ), tmp, target)
        errors = []
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            ptxas_reports[name] = out
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
                continue
            os.replace(tmp, target)
        if errors:
            raise RuntimeError("\n".join(errors))
        last_build_seconds = time.perf_counter() - t0 if procs else 0.0
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs


def library(name: str) -> ctypes.CDLL:
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
