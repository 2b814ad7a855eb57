"""ctypes bridge to the port's C++ host input (the libsvm and Ali-CCP
parsers and the per-row duplicate combine of the COO packer).

The sources in ``data/native_src/`` are compiled by ``g++ -O3 -shared
-fPIC -std=c++17`` at first use into
``tf_repos_tpu_torch/_build/libnative_parsers-<hash>.so``, named by the
hash of the sources, so an edited source is rebuilt. Concurrent builders
(test workers, the map-worker threads of one process) serialise on an
flock and build to a temporary name that is renamed into place, so no
process loads a torn library. A failed build raises with the compiler's
output: there is no quiet fallback. The plain Python versions live beside
their callers (``data/libsvm.parse_libsvm_lines``,
``data/ragged.parse_aliccp_lines``, ``data/sparse_batch.combine_dups``
with ``use_native=False``).

Every entry point is a plain C function; ctypes releases the GIL for the
duration of the call, so parses on a thread pool overlap. Nothing here
runs at import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native_src")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
SOURCES = ("libsvm_parser.cpp", "aliccp_parser.cpp", "coo_combine.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR) -> str:
    """The library's path, named by the hash of every source."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(src_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(build_dir, f"libnative_parsers-{h.hexdigest()[:12]}.so")


def build(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR) -> str:
    """Compile the sources of ``src_dir`` unless a library of their hash
    exists; returns its path. Raises RuntimeError naming g++'s output if
    the compile fails."""
    import fcntl

    out = library_path(src_dir, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(out + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # another process built it meanwhile
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", *GXX_FLAGS, *(os.path.join(src_dir, s) for s in SOURCES), "-o", tmp]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError(f"g++ not found: cannot build the native host input ({e})") from e
            if r.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"g++ failed building the native host input (exit {r.returncode}):\n"
                    f"{r.stderr}{r.stdout}"
                )
            os.replace(tmp, out)
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built if needed (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.parse_libsvm.restype = ctypes.c_int64
        lib.parse_libsvm.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _I64P, ctypes.c_int64, ctypes.c_int32,
            _I32P, _F32P, _F32P,
        ]
        lib.split_lines.restype = ctypes.c_int64
        lib.split_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I64P, ctypes.c_int64]
        lib.parse_aliccp.restype = ctypes.c_int64
        lib.parse_aliccp.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _I64P, ctypes.c_int64, ctypes.c_int32,
            _F32P, _F32P, _F32P, _I32P, _I32P, _F32P, _I32P, _I32P,
        ]
        lib.combine_dups.restype = ctypes.c_int64
        lib.combine_dups.argtypes = [
            _I32P, _F32P, ctypes.c_int64, ctypes.c_int64, _I32P, _F32P, _I32P,
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _join_lines(lines: Sequence[bytes]) -> Tuple[bytes, np.ndarray]:
    """Lines -> one newline-terminated blob and its n+1 line offsets."""
    n = len(lines)
    offsets = np.zeros((n + 1,), np.int64)
    if n:
        np.cumsum([len(ln) + 1 for ln in lines], out=offsets[1:])
        return b"\n".join(lines) + b"\n", offsets
    return b"", offsets


def split_lines(blob: bytes, max_lines: Optional[int] = None) -> np.ndarray:
    """Offsets of the non-blank lines of ``blob``: int64[n + 1], line i is
    blob[offsets[i]:offsets[i + 1]] (its newline included)."""
    lib = load()
    cap = max_lines if max_lines is not None else blob.count(b"\n") + 1
    offsets = np.empty((cap + 1,), np.int64)
    n = lib.split_lines(blob, len(blob), _ptr(offsets, _I64P), cap)
    return offsets[: n + 1]


def _parse_libsvm(lib, blob: bytes, offsets: np.ndarray, n: int, field_size: int):
    ids = np.zeros((n, field_size), np.int32)
    vals = np.zeros((n, field_size), np.float32)
    labels = np.zeros((n,), np.float32)
    if n:
        lib.parse_libsvm(blob, len(blob), _ptr(offsets, _I64P), n, field_size,
                         _ptr(ids, _I32P), _ptr(vals, _F32P), _ptr(labels, _F32P))
    return ids, vals, labels


def parse_libsvm_lines(
    lines: Sequence[bytes], field_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Same contract as data/libsvm.parse_libsvm_lines, C++-parsed."""
    lib = load()
    blob, offsets = _join_lines(lines)
    return _parse_libsvm(lib, blob, offsets, len(lines), field_size)


def parse_libsvm_blob(
    blob: bytes, field_size: int, max_lines: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a whole line-aligned blob in C++ (split + parse, one pass
    each); blank lines are skipped."""
    lib = load()
    offsets = split_lines(blob, max_lines)
    return _parse_libsvm(lib, blob, offsets, len(offsets) - 1, field_size)


def _parse_aliccp(lib, blob: bytes, offsets: np.ndarray, n: int, p: int):
    y = np.zeros((n,), np.float32)
    z = np.zeros((n,), np.float32)
    mask = np.zeros((n,), np.float32)
    feat_ids = np.zeros((n, 11), np.int32)
    u_ids = np.zeros((n, 4, p), np.int32)
    u_vals = np.zeros((n, 4, p), np.float32)
    a_scalar = np.zeros((n, 3), np.int32)
    a_int = np.zeros((n, p), np.int32)
    if n:
        lib.parse_aliccp(
            blob, len(blob), _ptr(offsets, _I64P), n, p,
            _ptr(y, _F32P), _ptr(z, _F32P), _ptr(mask, _F32P), _ptr(feat_ids, _I32P),
            _ptr(u_ids, _I32P), _ptr(u_vals, _F32P), _ptr(a_scalar, _I32P), _ptr(a_int, _I32P),
        )
    out = {
        "y": y, "z": z, "label": y, "mask": mask, "feat_ids": feat_ids,
        "a_catids": a_scalar[:, 0].copy(),
        "a_shopids": a_scalar[:, 1].copy(),
        "a_brandids": a_scalar[:, 2].copy(),
        "a_intids": a_int,
    }
    for i, f in enumerate(("u_cat", "u_shop", "u_brand", "u_int")):
        out[f"{f}ids"] = u_ids[:, i]
        out[f"{f}vals"] = u_vals[:, i]
    return out


def parse_aliccp_lines(lines: Sequence[bytes], multi_hot_pad: int):
    """Same batch contract as data/ragged.parse_aliccp_lines, C++-parsed."""
    lib = load()
    blob, offsets = _join_lines(lines)
    return _parse_aliccp(lib, blob, offsets, len(lines), multi_hot_pad)


def parse_aliccp_blob(blob: bytes, multi_hot_pad: int):
    """Parse a whole line-aligned Ali-CCP blob in C++ (split + parse)."""
    lib = load()
    offsets = split_lines(blob)
    return _parse_aliccp(lib, blob, offsets, len(offsets) - 1, multi_hot_pad)


def combine_dups(
    ids: np.ndarray, vals: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row duplicate-id combine of a padded multi-hot field.

    ids [b, p] (id <= 0 dead); vals [b, p] or None (each occurrence
    weighs 1.0). Returns (flat combined ids int32, flat combined weights
    f32, per-row combined counts int32): row-major, first-seen order
    inside a row, the weights of a repeated id summed in f32 in slot
    order."""
    if ids.ndim != 2:
        raise ValueError(f"combine_dups: ids must be [b, p], got shape {ids.shape}")
    lib = load()
    b, p = ids.shape
    ids_c = np.ascontiguousarray(ids, np.int32)
    out_ids = np.empty(b * p, np.int32)
    out_w = np.empty(b * p, np.float32)
    out_cnt = np.empty(b, np.int32)
    vals_c = None
    vp = _F32P()
    if vals is not None:
        if vals.shape != ids.shape:
            raise ValueError(f"combine_dups: vals {vals.shape} differ from ids {ids.shape}")
        vals_c = np.ascontiguousarray(vals, np.float32)
        vp = _ptr(vals_c, _F32P)
    m = lib.combine_dups(_ptr(ids_c, _I32P), vp, b, p, _ptr(out_ids, _I32P),
                         _ptr(out_w, _F32P), _ptr(out_cnt, _I32P))
    return out_ids[:m], out_w[:m], out_cnt
