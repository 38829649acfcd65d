"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
library's file name carries a hash of the source, of every ``csrc/*.cuh``
header and of the nvcc flags, so a changed source or header is rebuilt and
an unchanged tree is reused.  Libraries go to
``rollingdepth_torch/build/`` (listed in ``.gitignore``), or to
``$ROLLINGDEPTH_TORCH_BUILD`` when that is set.  ``build_all`` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("flash_attn", "conv3x3", "group_norm", "coalign")
# --split-compile=0 compiles a source's kernels on every core: flash_attn.cu
# in 34 s instead of 70, to the same SASS (nvcc 12.9, the 8 cores beside an
# NVIDIA H100 80GB HBM3)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # name -> seconds nvcc took in this process


def build_dir() -> str:
    return os.environ.get("ROLLINGDEPTH_TORCH_BUILD", os.path.join(_PKG, "build"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(_CSRC, fname), "rb") as f:
            h.update(b"\0" + fname.encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    with open(out + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log[-8000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees a whole file or none


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every source not yet built, one nvcc each, all in parallel."""
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build_all([name])
        with _LOCK:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return _LIBS[name]
