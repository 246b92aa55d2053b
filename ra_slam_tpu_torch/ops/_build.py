"""Build the package's CUDA sources with nvcc at first use and load them
with ctypes.

Each `csrc/<name>.cu` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
`build/ra_slam_tpu_torch/<hash>/` at the root of the checkout, where
`<hash>` covers the source and the flags: a changed source builds anew,
an unchanged one loads the library already there. Nothing is built
when a module is imported.
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

from ra_slam_tpu_torch.utils.profiling import TRACE

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "ra_slam_tpu_torch"

# sm_90a: Hopper. No --use_fast_math and no FMA contraction, so the
# kernels round as their plain PyTorch versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict = {}
BUILD_SECONDS: dict = {}  # name -> seconds nvcc took in this process
TRACE.expose("build.seconds", lambda: dict(BUILD_SECONDS))
_LOCKS = {}  # name -> lock: threads of one process build a library once
_LOCKS_LOCK = threading.Lock()


def _nvcc() -> str:
    """nvcc from $CUDA_HOME or $CUDA_PATH, else on $PATH, else under the
    toolkit's default prefix /usr/local/cuda (torch's own search order)."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            return str(Path(os.environ[var]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build the CUDA kernels")


def library_dir(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest


def load_library(name: str) -> ctypes.CDLL:
    """The loaded `csrc/<name>.cu` library, building it if needed. nvcc's
    report (registers, spills, shared memory per kernel) is kept in
    `build.log` beside the library."""
    if name in _LIBS:
        return _LIBS[name]
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LIBS:
            _LIBS[name] = _build(name)
    return _LIBS[name]


def _build(name: str) -> ctypes.CDLL:
    out_dir = library_dir(name)
    so = out_dir / f"lib{name}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        t0 = time.perf_counter()
        with TRACE.span(f"build.{name}"):
            r = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
                capture_output=True, text=True,
            )
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n{r.stdout}\n{r.stderr}")
        (out_dir / "build.log").write_text(r.stdout + r.stderr)
        os.replace(tmp, so)  # atomic: a concurrent process sees a whole file
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(so))
