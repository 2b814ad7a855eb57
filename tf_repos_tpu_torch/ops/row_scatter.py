"""Row scatter for the fused w|m|v write-back under --dma_scatter
(counterpart of dma_row_scatter in the JAX package's ops/pallas_sparse.py).

  dma_row_scatter(store[R,L], u[S], rows[S,L], n_valid)
      store[u[r],:] = rows[r,:] in place, for every r with 0 <= u[r] < n_valid

Every other r is dropped, as JAX's ``.at[u].set(rows, mode="drop")`` drops
the sentinel. The caller's u is the dedup mapper's ``__uids_<table>``:
unique and ascending, padded with the sentinel V. Unique u make the
scatter S independent row copies, so the kernel has no collision
handling.

The wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain PyTorch version beside it (the CPU tests use that), a CUDA
tensor to the hand-written kernel in ``csrc/row_scatter.cu`` (built with
nvcc for sm_90a, loaded with ctypes). There is no fallback: a CUDA tensor
the kernel does not take raises. The wrapper counts its kernel launches
in its ``launches`` attribute; the plain version never counts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tf_repos_tpu_torch.ops import build


# ------------------------------------------------------------ plain version
def dma_row_scatter_plain(
    store: torch.Tensor, u: torch.Tensor, rows: torch.Tensor, n_valid: int
) -> torch.Tensor:
    keep = (u >= 0) & (u < n_valid)
    store[u[keep].long()] = rows[keep].to(store.dtype)
    return store


# ------------------------------------------------------------------- kernel
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("row_scatter")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tr_row_scatter.argtypes = [p, ll, p, ll, p, ll, i, i, i, p]
    lib.tr_row_scatter.restype = i
    return lib


def dma_row_scatter(
    store: torch.Tensor, u: torch.Tensor, rows: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """store[u[r],:] = rows[r,:] in place where 0 <= u[r] < n_valid;
    returns the store. store [R,L] f32 or bf16 and rows [S,L], each with
    unit column stride (any row stride); u int32 [S], unique among the
    kept rows. rows is cast to the store's dtype. Bit-exact against the
    masked index assignment."""
    if store.device.type == "cpu":
        return dma_row_scatter_plain(store, u, rows, n_valid)
    if store.device.type != "cuda":
        raise ValueError(f"dma_row_scatter: unsupported device {store.device}")
    build.check_index("dma_row_scatter", "u", u, store.device)
    if store.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dma_row_scatter: store dtype {store.dtype} (f32 or bf16)")
    if rows.device != store.device:
        raise ValueError(f"dma_row_scatter: rows on {rows.device}, expected {store.device}")
    if rows.dtype != store.dtype:
        rows = rows.to(store.dtype)
    for name, x in (("store", store), ("rows", rows)):
        if x.dim() != 2 or x.stride(1) != 1:
            raise ValueError(f"dma_row_scatter: {name} must be 2-D with unit column stride")
    s, width = u.shape[0], store.shape[1]
    if tuple(rows.shape) != (s, width):
        raise ValueError(
            f"dma_row_scatter: rows {tuple(rows.shape)}, expected ({s}, {width}) for {s} indices"
        )
    build.check_k("dma_row_scatter", width)
    if not 0 <= n_valid <= store.shape[0]:
        raise ValueError(f"dma_row_scatter: n_valid={n_valid} outside [0, {store.shape[0]}]")
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_row_scatter(
            store.data_ptr(), store.stride(0), rows.data_ptr(), rows.stride(0), u.data_ptr(),
            s, width, store.element_size(), n_valid, stream,
        )
    build.check_rc("dma_row_scatter", rc)
    dma_row_scatter.launches += 1
    return store


dma_row_scatter.launches = 0


def reset_launches() -> None:
    dma_row_scatter.launches = 0
