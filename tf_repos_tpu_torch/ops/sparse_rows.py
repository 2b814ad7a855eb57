"""Row expand / row accumulate for the lazy sparse path's inner lookup
(counterpart of the expand/accumulate part of
the JAX package's ops/pallas_sparse.py).

  expand_rows(table[S,K], idx[N])     -> table[idx]            [N,K]
  accumulate_rows(g[N,K], idx[N], S)  -> f32 segment sum       [S,K]

Each wrapper dispatches on the device of its tensors: a CPU tensor goes
to the plain PyTorch version beside it (the CPU tests use that), a CUDA
tensor to the hand-written kernel in ``csrc/sparse_rows.cu`` (built with
nvcc for sm_90a, loaded with ctypes). There is no fallback: a CUDA
tensor the kernel does not take raises. Each wrapper counts its kernel
launches in its ``launches`` attribute; the plain versions never count.

The TPU needed capacity tiers (the compact table pinned in VMEM up to a
row cap, a lane-packed accumulator above it, XLA beyond). On the GPU the
compact table lives in device memory and stays in L2, so one kernel of
each kind serves every S.

Contract (built by data/sparse_batch.SparseBatchMapper): idx values lie
in [0, S). The kernels do not check it, since a check would force a
device-to-host sync on every step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tf_repos_tpu_torch.ops import build


# ------------------------------------------------------------ plain versions
def expand_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]


def accumulate_rows_plain(g: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
    return torch.zeros((s, g.shape[-1]), dtype=torch.float32, device=g.device).index_add_(
        0, idx, g.float()
    )


# ------------------------------------------------------------------ kernels
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sparse_rows")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tr_expand_rows.argtypes = [p, ll, p, ll, i, i, p, p]
    lib.tr_expand_rows.restype = i
    lib.tr_accumulate_rows.argtypes = [p, p, ll, i, ll, i, p, p]
    lib.tr_accumulate_rows.restype = i
    lib.tr_accumulate_rows_tile.argtypes = []
    lib.tr_accumulate_rows_tile.restype = i
    return lib


def expand_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i,:] = table[idx[i],:]. table [S,K] f32 or bf16 with unit
    column stride (any row stride, e.g. a column slice of a wider row
    store); idx int32 [N]. Bit-exact against table[idx]."""
    if table.device.type == "cpu":
        return expand_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"expand_rows: unsupported device {table.device}")
    build.check_index("expand_rows", "idx", idx, table.device)
    if table.dim() != 2 or table.stride(1) != 1:
        raise ValueError("expand_rows: table must be 2-D with unit column stride")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expand_rows: table dtype {table.dtype} (f32 or bf16)")
    k = table.shape[1]
    build.check_k("expand_rows", k)
    n = idx.shape[0]
    out = torch.empty((n, k), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_expand_rows(
            table.data_ptr(), table.stride(0), idx.data_ptr(), n, k,
            table.element_size(), out.data_ptr(), stream,
        )
    build.check_rc("expand_rows", rc)
    expand_rows.launches += 1
    return out


def accumulate_rows(g: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
    """out[r,:] = sum of g[i,:] over {i: idx[i] == r}, f32 [s,K]. g [N,K]
    f32 or bf16, contiguous; idx int32 [N]; duplicates allowed. The
    kernel sums each tile's runs of equal idx, then adds them with
    atomics in no fixed order (csrc/sort_reduce.cuh)."""
    if g.device.type == "cpu":
        return accumulate_rows_plain(g, idx, s)
    if g.device.type != "cuda":
        raise ValueError(f"accumulate_rows: unsupported device {g.device}")
    build.check_index("accumulate_rows", "idx", idx, g.device)
    if g.dim() != 2 or not g.is_contiguous():
        raise ValueError("accumulate_rows: g must be a contiguous 2-D tensor")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"accumulate_rows: g dtype {g.dtype} (f32 or bf16)")
    n, k = g.shape
    if idx.shape[0] != n:
        raise ValueError(f"accumulate_rows: {n} rows of g but {idx.shape[0]} indices")
    build.check_k("accumulate_rows", k)
    out = torch.zeros((s, k), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_accumulate_rows(
            g.data_ptr(), idx.data_ptr(), n, k, s, int(g.dtype == torch.bfloat16),
            out.data_ptr(), stream,
        )
    build.check_rc("accumulate_rows", rc)
    accumulate_rows.launches += 1
    return out


expand_rows.launches = 0
accumulate_rows.launches = 0


def reset_launches() -> None:
    expand_rows.launches = 0
    accumulate_rows.launches = 0


# ------------------------------------------------------------------- lookup
class _ExpandLookup(torch.autograd.Function):
    """Forward: expand_rows on the flattened ids, reshaped to
    ids.shape + (K,). Backward: accumulate_rows into [S,K]; the ids get
    no gradient."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        flat = ids.reshape(-1)
        if flat.dtype != torch.int32:
            flat = flat.to(torch.int32)
        ctx.save_for_backward(flat)
        ctx.s = rows.shape[0]
        ctx.ids_shape = ids.shape
        return expand_rows(rows, flat.contiguous()).reshape(
            tuple(ids.shape) + (rows.shape[-1],)
        )

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (flat,) = ctx.saved_tensors
        k = ct.shape[-1]
        d_rows = accumulate_rows(ct.reshape(-1, k).contiguous(), flat, ctx.s)
        return d_rows, None


def make_expand_lookup():
    """lookup(rows, ids) for the sparse path's inner (remapped-id) lookup:
    the counterpart of pallas_sparse.make_vmem_expand_lookup. ``rows`` is
    the compact [S,K] block of the batch's unique rows and ``ids`` the
    remapped positions into it. Marked ``static_slice_ok``: the table is
    positionally addressed, so models may serve static-id fields from a
    slice (models/deepfm.py). Its ``coo_pool`` attribute is the COO
    multi-hot pool on the same compact rows (ops/coo_pool.py); its
    ``seg_pool``, ``seg_select`` and ``sorted_bwd_expand`` attributes are
    the sorted-stream segment pair and the idx-sorted-backward lookup
    (ops/sorted_seg.py). The models reach each through ``getattr``."""
    # here, not at the top: ops/coo_pool.py and ops/sorted_seg.py build on
    # the functions above
    from tf_repos_tpu_torch.ops.coo_pool import make_coo_pool
    from tf_repos_tpu_torch.ops.sorted_seg import make_sorted_bwd_expand, make_sorted_seg

    def lookup(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return _ExpandLookup.apply(rows, ids)

    lookup.static_slice_ok = True
    lookup.coo_pool = make_coo_pool()
    lookup.seg_pool, lookup.seg_select = make_sorted_seg()
    lookup.sorted_bwd_expand = make_sorted_bwd_expand()
    return lookup


# ------------------------------------------------------------ serving lookup
def normalize_ids(ids: torch.Tensor, v: int) -> torch.Tensor:
    """The row a gather ``table[ids]`` of a [v, ...] table reads in JAX,
    which never fails on an id: a negative id gets v added once, then the
    id is clamped to [0, v-1] (v = 5: ids 4, 5, 99, -1, -6, -100 read
    rows 4, 4, 4, 4, 0, 0). Same dtype and shape as ids."""
    return torch.where(ids < 0, ids + v, ids).clamp_(0, v - 1)


def make_serving_lookup():
    """lookup(table, ids) for scoring over a WHOLE [V, C] table: the
    scorer's and task_type=infer's gather, through K1 expand_rows.
    Request ids are untrusted and K1 checks no bounds, so the ids are
    first normalised as JAX's gather treats them (normalize_ids; V is
    table.shape[0] of the table passed in, the [V, K] view under
    --fused_table), then flattened to contiguous int32. Only the gather
    sees the normalised ids; a model's other uses of its ids (masks) see
    them as sent. No autograd: forward only. Marked ``static_slice_ok``:
    a whole table is addressed by position, so DeepFM's static fields
    still come from the row slice."""

    @torch.no_grad()
    def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        flat = normalize_ids(ids.reshape(-1), table.shape[0]).to(torch.int32).contiguous()
        return expand_rows(table, flat).reshape(tuple(ids.shape) + (table.shape[-1],))

    lookup.static_slice_ok = True
    return lookup
