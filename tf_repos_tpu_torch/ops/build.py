"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``tf_repos_tpu_torch/_build/lib<name>-<hash>.so``, a shared library with a
plain C interface, and loaded with ctypes. The build happens at first
use (or all at once through ``build_all``, one nvcc per source started
together); the hash of the source and of the headers in ``csrc/`` names
the file, so an edited source or header is rebuilt. Nothing here runs at
import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

MAX_K = 4096  # the kernels' in-tile row arithmetic is exact below this

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def check_k(what: str, k: int) -> None:
    """Row width limit shared by every kernel wrapper."""
    if not 0 < k < MAX_K:
        raise ValueError(f"{what}: K={k} outside (0, {MAX_K})")


def check_index(what: str, name: str, idx: torch.Tensor, device: torch.device) -> None:
    """An index argument of a kernel: a contiguous 1-D int32 tensor on
    the kernel's device."""
    if idx.device != device:
        raise ValueError(f"{what}: {name} on {idx.device}, expected {device}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous 1-D int32 tensor (got {idx.dtype}, "
            f"shape {tuple(idx.shape)})"
        )


def check_rc(what: str, rc: int) -> None:
    """A kernel entry point returns cudaGetLastError(); raise on non-zero."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed (cudaError {rc})")


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


def _target(name: str) -> str:
    """The library's path, named by the hash of its source and of every
    header in csrc/ (a source may include any of them)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if built."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for nvcc; returns its output (the ptxas register and shared-
    memory report), "" if the library was already built."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source in parallel; returns {name: nvcc output}."""
    with _lock:
        names = sources()
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(_target(name))
        return _libs[name]
