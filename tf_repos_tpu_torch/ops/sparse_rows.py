"""Row expand / row accumulate for the lazy sparse path's inner lookup
(counterpart of the expand/accumulate part of
the JAX package's ops/pallas_sparse.py).

  expand_rows(table[S,K], idx[N])     -> table[idx]            [N,K]
  expand_rows_clamped(table[V,K], ids) -> table[JAX's rule(ids)] ids.shape+[K]
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
device-to-host sync on every step. The serving gather's ids are
untrusted; expand_rows_clamped reads them as JAX's gather does, inside
the same K1 launch.
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
    lib.tr_expand_rows_clamped.argtypes = [p, ll, p, i, ll, ll, ll, i, ll, i, p, p]
    lib.tr_expand_rows_clamped.restype = i
    lib.tr_accumulate_rows.argtypes = [p, p, ll, i, ll, i, p, p]
    lib.tr_accumulate_rows.restype = i
    lib.tr_accumulate_rows_tile.argtypes = []
    lib.tr_accumulate_rows_tile.restype = i
    return lib


def _check_table(what: str, table: torch.Tensor) -> None:
    if table.dim() != 2 or table.stride(1) != 1:
        raise ValueError(f"{what}: table must be 2-D with unit column stride")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: table dtype {table.dtype} (f32 or bf16)")
    build.check_k(what, table.shape[1])


def expand_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i,:] = table[idx[i],:]. table [S,K] f32 or bf16 with unit
    column stride (any row stride, e.g. a column slice of a wider row
    store); idx int32 [N] in [0, S). Bit-exact against table[idx]."""
    if table.device.type == "cpu":
        return expand_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"expand_rows: unsupported device {table.device}")
    build.check_index("expand_rows", "idx", idx, table.device)
    _check_table("expand_rows", table)
    n, k = idx.shape[0], table.shape[1]
    out = torch.empty((n, k), dtype=table.dtype, device=table.device)
    if n:
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib().tr_expand_rows(
                table.data_ptr(), table.stride(0), idx.data_ptr(), n, k,
                table.element_size(), out.data_ptr(), stream,
            )
        build.check_rc("expand_rows", rc)
        expand_rows.launches += 1
    return out


def id_rows(ids: torch.Tensor) -> tuple[int, int]:
    """(cols, ld): ids, in row-major order, as rows of ``cols`` adjacent
    ids whose starts lie ``ld`` elements apart, the layout the clamped
    kernel reads in place. A contiguous tensor is one row; a view whose
    leading dimensions collapse and whose last stride is 1 (DeepFM's
    dynamic fields, ids[:, 13:]) is rows of its last dimension. Raises
    for any other layout."""
    if ids.is_contiguous():
        return ids.numel(), ids.numel()
    try:
        rows = ids.view(-1, ids.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"expand_rows_clamped: ids of shape {tuple(ids.shape)} and strides "
                         f"{ids.stride()} are not rows of adjacent ids") from e
    if rows.shape[1] == 1:
        return 1, rows.stride(0)
    if rows.stride(1) != 1 or rows.stride(0) < rows.shape[1]:
        raise ValueError(f"expand_rows_clamped: ids of strides {ids.stride()} are not rows of "
                         "adjacent ids")
    return rows.shape[1], rows.stride(0)


def expand_rows_clamped(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[normalize_ids(ids, V)] reshaped to ids.shape + (K,), V =
    table.shape[0]: the gather JAX's table[ids] is, for any int32 or
    int64 id. On the card one K1 launch reads the ids in place (any
    layout id_rows takes) and applies the rule to each; nothing else
    touches them. table as for expand_rows. Bit-exact."""
    v, k = table.shape[0], table.shape[-1]
    if table.device.type == "cpu":
        return expand_rows_plain(table, normalize_ids(ids.reshape(-1), v)).reshape(
            tuple(ids.shape) + (k,))
    if table.device.type != "cuda":
        raise ValueError(f"expand_rows_clamped: unsupported device {table.device}")
    if ids.device != table.device:
        raise ValueError(f"expand_rows_clamped: ids on {ids.device}, expected {table.device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"expand_rows_clamped: ids dtype {ids.dtype} (int32 or int64)")
    _check_table("expand_rows_clamped", table)
    n = ids.numel()
    out = torch.empty(tuple(ids.shape) + (k,), dtype=table.dtype, device=table.device)
    if n:
        if v == 0:
            raise ValueError("expand_rows_clamped: a table of 0 rows has no row to read")
        cols, ld = id_rows(ids)
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib().tr_expand_rows_clamped(
                table.data_ptr(), table.stride(0), ids.data_ptr(), ids.element_size(), cols, ld,
                n, k, v, table.element_size(), out.data_ptr(), stream,
            )
        build.check_rc("expand_rows_clamped", rc)
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
    scorer's and task_type=infer's gather, one K1 launch
    (expand_rows_clamped). Request ids are untrusted, so each is read as
    JAX's gather reads it (normalize_ids; V is table.shape[0] of the
    table passed in, the [V, K] view under --fused_table), inside the
    kernel: no device operation touches the ids before it. Only the
    gather sees the normalised ids; a model's other uses of its ids
    (masks) see them as sent. No autograd: forward only. Marked
    ``static_slice_ok``: a whole table is addressed by position, so
    DeepFM's static fields still come from the row slice. A 1-D [V]
    table (LR's) is gathered as its [V, 1] view and the last axis
    dropped, which is what JAX's table[ids] returns."""

    @torch.no_grad()
    def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if table.dim() == 1:
            return expand_rows_clamped(table[:, None], ids)[..., 0]
        return expand_rows_clamped(table, ids)

    lookup.static_slice_ok = True
    return lookup
