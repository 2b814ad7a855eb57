"""COO segment pool for multi-hot groups (--mh_coo) and its transpose
(counterpart of the COO-pool part of the JAX package's
ops/pallas_sparse.py).

  coo_pool_rows(table[S,K], idx, dest, w, n_out)  -> f32 [n_out,K]
      out[dest[i]] += w[i] * table[idx[i]]
  coo_accumulate_rows(dp[n_out,K], idx, dest, w, S) -> f32 [S,K]
      d[idx[i]] += w[i] * dp[dest[i]]

Each wrapper dispatches on the device of its tensors: a CPU tensor goes
to the plain PyTorch version beside it, a CUDA tensor to the hand-written
kernel in ``csrc/coo_pool.cu`` (built with nvcc for sm_90a, loaded with
ctypes). There is no fallback: a CUDA tensor the kernel does not take
raises. Each wrapper counts its kernel launches in its ``launches``
attribute; the plain versions never count.

The TPU had capacity tiers here too (VMEM-pinned kernels up to a row
cap, lane-packed accumulates above it, XLA beyond). On the GPU the
compact table and the pooled output live in device memory and stay in
L2, so one kernel of each kind serves every S.

Contract (built by data/sparse_batch.MhCooPacker and SparseBatchMapper):
idx in [0, S), dest in [0, n_out). The kernels do not check it, since a
check would force a device-to-host sync on every step. The kernels skip
slots with w == 0 (exact for finite table values; see the source)."""

from __future__ import annotations

import ctypes
import functools

import torch

from tf_repos_tpu_torch.ops import build
from tf_repos_tpu_torch.ops.embedding import coo_pool as coo_pool_rows_plain
from tf_repos_tpu_torch.ops.sparse_rows import accumulate_rows_plain


# ------------------------------------------------------------ plain versions
def coo_accumulate_rows_plain(dp: torch.Tensor, idx: torch.Tensor, dest: torch.Tensor,
                              w: torch.Tensor, s: int) -> torch.Tensor:
    """The transpose of coo_pool_rows_plain with respect to the table: the
    plain accumulate of the gathered, weighted rows."""
    return accumulate_rows_plain(dp[dest].float() * w.float()[:, None], idx, s)


# ------------------------------------------------------------------ kernels
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("coo_pool")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tr_coo_pool_rows.argtypes = [p, ll, p, p, p, ll, i, i, p, p]
    lib.tr_coo_pool_rows.restype = i
    lib.tr_coo_accumulate_rows.argtypes = [p, p, p, p, ll, i, ll, p, p]
    lib.tr_coo_accumulate_rows.restype = i
    lib.tr_coo_accumulate_rows_tile.argtypes = []
    lib.tr_coo_accumulate_rows_tile.restype = i
    return lib


def _check_slots(what: str, idx, dest, w, device) -> int:
    """The COO triplet must be contiguous 1-D int32/int32/f32 tensors of
    one length on ``device``; returns that length."""
    for name, t, dtype in (("idx", idx, torch.int32), ("dest", dest, torch.int32),
                           ("w", w, torch.float32)):
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, expected {device}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous 1-D {dtype} tensor "
                f"(got {t.dtype}, shape {tuple(t.shape)})"
            )
    m = idx.shape[0]
    if dest.shape[0] != m or w.shape[0] != m:
        raise ValueError(f"{what}: idx, dest and w lengths differ "
                         f"({m}, {dest.shape[0]}, {w.shape[0]})")
    return m


def coo_pool_rows(table: torch.Tensor, idx: torch.Tensor, dest: torch.Tensor,
                  w: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[d,:] = sum over {i: dest[i] == d} of w[i] * table[idx[i],:],
    f32 [n_out,K]. table [S,K] f32 or bf16 with unit column stride (any
    row stride, e.g. the w columns of the [S,3K] w|m|v rows); idx, dest
    int32 [M], w f32 [M]. The kernel adds with atomics in no fixed order."""
    if table.device.type == "cpu":
        return coo_pool_rows_plain(table, idx, dest, w, n_out)
    if table.device.type != "cuda":
        raise ValueError(f"coo_pool_rows: unsupported device {table.device}")
    m = _check_slots("coo_pool_rows", idx, dest, w, table.device)
    if table.dim() != 2 or table.stride(1) != 1:
        raise ValueError("coo_pool_rows: table must be 2-D with unit column stride")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"coo_pool_rows: table dtype {table.dtype} (f32 or bf16)")
    k = table.shape[1]
    build.check_k("coo_pool_rows", k)
    out = torch.zeros((n_out, k), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_coo_pool_rows(
            table.data_ptr(), table.stride(0), idx.data_ptr(), dest.data_ptr(),
            w.data_ptr(), m, k, int(table.dtype == torch.bfloat16), out.data_ptr(), stream,
        )
    build.check_rc("coo_pool_rows", rc)
    coo_pool_rows.launches += 1
    return out


def coo_accumulate_rows(dp: torch.Tensor, idx: torch.Tensor, dest: torch.Tensor,
                        w: torch.Tensor, s: int) -> torch.Tensor:
    """d[r,:] = sum over {i: idx[i] == r} of w[i] * dp[dest[i],:], f32
    [s,K]: the transpose of coo_pool_rows with respect to the table. dp
    f32 [n_out,K] contiguous; idx, dest int32 [M], w f32 [M]. The kernel
    sums each tile's runs of equal idx, then adds them with atomics in no
    fixed order (csrc/sort_reduce.cuh)."""
    if dp.device.type == "cpu":
        return coo_accumulate_rows_plain(dp, idx, dest, w, s)
    if dp.device.type != "cuda":
        raise ValueError(f"coo_accumulate_rows: unsupported device {dp.device}")
    m = _check_slots("coo_accumulate_rows", idx, dest, w, dp.device)
    if dp.dim() != 2 or not dp.is_contiguous() or dp.dtype != torch.float32:
        raise ValueError("coo_accumulate_rows: dp must be a contiguous 2-D float32 tensor")
    k = dp.shape[1]
    build.check_k("coo_accumulate_rows", k)
    out = torch.zeros((s, k), dtype=torch.float32, device=dp.device)
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_coo_accumulate_rows(
            dp.data_ptr(), idx.data_ptr(), dest.data_ptr(), w.data_ptr(), m, k, s,
            out.data_ptr(), stream,
        )
    build.check_rc("coo_accumulate_rows", rc)
    coo_accumulate_rows.launches += 1
    return out


coo_pool_rows.launches = 0
coo_accumulate_rows.launches = 0


def reset_launches() -> None:
    coo_pool_rows.launches = 0
    coo_accumulate_rows.launches = 0


# --------------------------------------------------------------------- pool
class _CooPool(torch.autograd.Function):
    """Forward: coo_pool_rows. Backward: coo_accumulate_rows into the
    rows; idx, dest and w (batch data, never a differentiation target)
    get no gradient."""

    @staticmethod
    def forward(ctx, rows, idx, dest, w, n_out):
        ctx.save_for_backward(idx, dest, w)
        ctx.s, ctx.dtype = rows.shape[0], rows.dtype
        return coo_pool_rows(rows, idx, dest, w, n_out)

    @staticmethod
    def backward(ctx, ct):
        idx, dest, w = ctx.saved_tensors
        d_rows = coo_accumulate_rows(ct.float().contiguous(), idx, dest, w, ctx.s)
        return d_rows.to(ctx.dtype), None, None, None, None


def make_coo_pool():
    """pool(rows, idx, dest, w, n_out) -> f32 [n_out,K], the counterpart
    of pallas_sparse.make_coo_pool: the models reach it as the
    ``coo_pool`` attribute of the sparse path's lookup
    (ops/sparse_rows.make_expand_lookup)."""

    def pool(rows, idx, dest, w, n_out: int):
        return _CooPool.apply(rows, idx, dest, w, n_out)

    return pool
