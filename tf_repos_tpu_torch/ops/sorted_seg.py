"""Segment sum and segment select over a sorted slot stream, for DIN's
attention over the live COO slots (counterpart of the sorted-window part
of the JAX package's ops/pallas_sparse.py).

  sorted_segsum(vals[M,K], cdest[M], n_out) -> f32 [n_out,K]
      out[j] = sum over {i: cdest[i] == j} of vals[i]
  sorted_expand(src[n_src,K], cdest[M])     -> [M,K], src's dtype
      out[i] = src[cdest[i]]

The stream (data/sparse_batch.MhCooPacker): over the live prefix cdest
is nondecreasing with steps of at most 1; bucket padding after it
carries cdest = 0 and zero values. The kernels use the sort for speed
only and are right for any cdest in [0, n_out), so padding adds zeros
into row 0 (sum) or copies row 0 (select). They do not check the range,
since a check would force a device-to-host sync on every step.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes
to the plain PyTorch version beside it, a CUDA tensor to the hand-written
kernel in ``csrc/sorted_seg.cu`` (built with nvcc for sm_90a, loaded with
ctypes). There is no fallback: a CUDA tensor the kernel does not take
raises. Each wrapper counts its kernel launches in its ``launches``
attribute; the plain versions never count.

The TPU had dtype and capacity tiers here (XLA's gather for an f32
selection, whose one-hot matmul needed six MXU passes; a VMEM cap on the
pinned output; a lane-packed accumulator above it). None of them is a
GPU constraint: one K5 and one K6 kernel serve every dtype and n_out,
and K5 at n_out = Su stands in for the lane-packed sorted_segsum_packed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tf_repos_tpu_torch.ops import build
from tf_repos_tpu_torch.ops.sparse_rows import expand_rows


# ------------------------------------------------------------ plain versions
def sorted_segsum_plain(vals: torch.Tensor, cdest: torch.Tensor, n_out: int) -> torch.Tensor:
    return torch.zeros((n_out, vals.shape[-1]), dtype=torch.float32, device=vals.device).index_add_(
        0, cdest, vals.float()
    )


def sorted_expand_plain(src: torch.Tensor, cdest: torch.Tensor) -> torch.Tensor:
    return src[cdest]


# ------------------------------------------------------------------ kernels
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sorted_seg")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tr_sorted_segsum.argtypes = [p, p, ll, i, i, p, p]
    lib.tr_sorted_segsum.restype = i
    lib.tr_sorted_expand.argtypes = [p, p, ll, i, i, p, p]
    lib.tr_sorted_expand.restype = i
    return lib


def _check(what: str, x: torch.Tensor, cdest: torch.Tensor) -> int:
    """x a contiguous 2-D f32 or bf16 tensor on the card, cdest a
    contiguous 1-D int32 tensor beside it; returns K."""
    build.check_index(what, "cdest", cdest, x.device)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 2-D tensor, got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {x.dtype} (f32 or bf16)")
    build.check_k(what, x.shape[1])
    return x.shape[1]


def sorted_segsum(vals: torch.Tensor, cdest: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[j,:] = sum over {i: cdest[i] == j} of vals[i,:], f32 [n_out,K].
    vals [M,K] f32 or bf16, contiguous; cdest int32 [M]. The kernel adds
    each run of a strip with vector atomics, in no fixed order, and skips
    sums of exactly 0."""
    if vals.device.type == "cpu":
        return sorted_segsum_plain(vals, cdest, n_out)
    if vals.device.type != "cuda":
        raise ValueError(f"sorted_segsum: unsupported device {vals.device}")
    k = _check("sorted_segsum", vals, cdest)
    m = vals.shape[0]
    if cdest.shape[0] != m:
        raise ValueError(f"sorted_segsum: {m} rows of vals but {cdest.shape[0]} cdest")
    out = torch.zeros((n_out, k), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_sorted_segsum(
            vals.data_ptr(), cdest.data_ptr(), m, k, int(vals.dtype == torch.bfloat16),
            out.data_ptr(), stream,
        )
    build.check_rc("sorted_segsum", rc)
    sorted_segsum.launches += 1
    return out


def sorted_expand(src: torch.Tensor, cdest: torch.Tensor) -> torch.Tensor:
    """out[i,:] = src[cdest[i],:], [M,K] in src's dtype. src [n_src,K] f32
    or bf16, contiguous; cdest int32 [M]. Bit-exact against src[cdest]."""
    if src.device.type == "cpu":
        return sorted_expand_plain(src, cdest)
    if src.device.type != "cuda":
        raise ValueError(f"sorted_expand: unsupported device {src.device}")
    k = _check("sorted_expand", src, cdest)
    m = cdest.shape[0]
    out = torch.empty((m, k), dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_sorted_expand(
            src.data_ptr(), cdest.data_ptr(), m, k, src.element_size(), out.data_ptr(), stream,
        )
    build.check_rc("sorted_expand", rc)
    sorted_expand.launches += 1
    return out


sorted_segsum.launches = 0
sorted_expand.launches = 0


def reset_launches() -> None:
    sorted_segsum.launches = 0
    sorted_expand.launches = 0


# ---------------------------------------------------- differentiable pair
class _SegPool(torch.autograd.Function):
    """Forward K5 into n_out rows; backward K6 of the cotangent, in the
    values' dtype (the selection is 1:1, so casting first is exact)."""

    @staticmethod
    def forward(ctx, vals, cdest, n_out):
        ctx.save_for_backward(cdest)
        ctx.dtype = vals.dtype
        return sorted_segsum(vals, cdest, n_out)

    @staticmethod
    def backward(ctx, ct):
        (cdest,) = ctx.saved_tensors
        return sorted_expand(ct.to(ctx.dtype).contiguous(), cdest), None, None


class _SegSelect(torch.autograd.Function):
    """Forward K6; backward K5 of the cotangent into the source's rows."""

    @staticmethod
    def forward(ctx, src, cdest):
        ctx.save_for_backward(cdest)
        ctx.n_src, ctx.dtype = src.shape[0], src.dtype
        return sorted_expand(src, cdest)

    @staticmethod
    def backward(ctx, ct):
        (cdest,) = ctx.saved_tensors
        return sorted_segsum(ct.contiguous(), cdest, ctx.n_src).to(ctx.dtype), None


def make_sorted_seg():
    """(seg_pool, seg_select), the counterpart of
    pallas_sparse.make_sorted_seg; each is the other's autograd transpose:

      seg_pool(vals, cdest, n_out) -> f32 [n_out,K]   segment sum (K5)
      seg_select(src, cdest)       -> [M,K]           src[cdest]  (K6)

    The models reach them as the ``seg_pool`` and ``seg_select``
    attributes of the sparse path's lookup (ops/sparse_rows.
    make_expand_lookup). cdest gets no gradient."""

    def seg_pool(vals, cdest, n_out: int):
        return _SegPool.apply(vals, cdest, n_out)

    def seg_select(src, cdest):
        return _SegSelect.apply(src, cdest)

    return seg_pool, seg_select


class _SortedBwdExpand(torch.autograd.Function):
    """Forward: K1 expand_rows(rows, ids). Backward over the packer's
    idx-sorted aux stream: the cotangent gathered into idx-sorted order
    (ct[perm], K1 again: torch's own [M,K] gather took 20 times longer
    on an H100 at the DIN point, PERF.md), zeroed at sorted positions
    >= m_live (the 0-padded tails), summed per run of equal id by K5
    into Su rows, then added into [S,K] at the runs' rows srows (a plain
    scatter of Su rows)."""

    @staticmethod
    def forward(ctx, rows, ids, perm, cidx, srows, m_live):
        ctx.save_for_backward(perm, cidx, srows, m_live)
        ctx.s = rows.shape[0]
        return expand_rows(rows, ids)

    @staticmethod
    def backward(ctx, ct):
        perm, cidx, srows, m_live = ctx.saved_tensors
        sct = expand_rows(ct.float().contiguous(), perm)
        live = torch.arange(sct.shape[0], device=sct.device) < m_live
        sct = torch.where(live[:, None], sct, torch.zeros((), device=sct.device))
        seg = sorted_segsum(sct, cidx, srows.shape[0])
        d_rows = torch.zeros((ctx.s, ct.shape[-1]), dtype=torch.float32,
                             device=ct.device).index_add_(0, srows, seg)
        return d_rows, None, None, None, None, None


def make_sorted_bwd_expand():
    """expand(rows, ids, perm, cidx, srows, m_live) -> rows[ids], the
    counterpart of pallas_sparse.make_sorted_bwd_expand (without the TPU's
    VMEM-cap fallback): the COO lookup whose backward rides the packer's
    idx-sorted aux stream (--coo_sorted_bwd) through K5 instead of K2's
    per-slot atomics. ids int32 [M] (the COO idx); perm, cidx int32 [M]
    and srows int32 [Su] from the packer and mapper; m_live the live slot
    count as a 0-d device tensor (no host sync)."""

    def expand(rows, ids, perm, cidx, srows, m_live):
        return _SortedBwdExpand.apply(rows, ids, perm, cidx, srows, m_live)

    return expand
