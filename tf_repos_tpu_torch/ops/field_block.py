"""Field-block table-gradient scatter for the dense step under
--field_blocks (counterpart of the JAX package's ops/pallas_embedding.py).

  field_block_scatter(ids[B,F], g[B,F,W], vocab, offsets, sizes, use_bf16)
      -> dtable f32 [vocab, W]: each (b, f) adds g[b,f,:] at row ids[b,f]
         only if offsets[f] <= ids[b,f] < offsets[f] + sizes[f]

Ids outside their field's block, and the -1 padding, add nothing: this is
what the TPU kernel computes, and it is not a plain scatter-add. Blocks
that overlap add up. With use_bf16 each g element is rounded to bf16
(nearest even) before an f32 sum, as the TPU kernel's one-pass bf16 MXU
product does.

The wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain PyTorch version beside it (the CPU tests use that), a CUDA
tensor to the hand-written kernel in ``csrc/field_block.cu`` (built with
nvcc for sm_90a, loaded with ctypes). There is no fallback: a CUDA tensor
the kernel does not take raises. The wrapper counts its kernel launches
in its ``launches`` attribute; the plain version never counts.

``make_field_block_lookup`` ties it to the plain gather forward, as the
JAX package ties the kernel to XLA's gather with ``custom_vjp``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from tf_repos_tpu_torch.ops import build

PAIRS = 2048  # (b, f) pairs one kernel block sums before it flushes (as in csrc/field_block.cu)
MAX_W = 1024  # a kernel warp stages the W floats of at least one pair in its 4 KB
ACC_FLOATS = 8192  # shared-memory accumulator (32 KB) beside the staged g
HOT_HITS = 4  # a field sums in shared memory if a block's pairs hit each row this often


# ------------------------------------------------------------ plain versions
def scatter_reference(ids: torch.Tensor, g: torch.Tensor, vocab: int) -> torch.Tensor:
    """The plain scatter-add of g's rows at ids into f32 [vocab, W], as the
    JAX package's scatter_reference: negative ids count from the end, ids
    still outside [0, vocab) are dropped."""
    w = g.shape[-1]
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + vocab, flat)
    keep = (flat >= 0) & (flat < vocab)
    rows = torch.where(keep[:, None], g.reshape(-1, w).float(), 0.0)
    return torch.zeros((vocab, w), dtype=torch.float32, device=g.device).index_add_(
        0, torch.where(keep, flat, 0), rows
    )


def field_block_scatter_plain(
    ids: torch.Tensor, g: torch.Tensor, vocab: int, offsets: Sequence[int],
    sizes: Sequence[int], use_bf16: bool = True,
) -> torch.Tensor:
    """The scatter-add with the field mask and the bf16 rounding."""
    off = torch.tensor(tuple(offsets), dtype=torch.int64, device=ids.device)
    end = off + torch.tensor(tuple(sizes), dtype=torch.int64, device=ids.device)
    i64 = ids.long()
    keep = (i64 >= off) & (i64 < end) & (i64 < vocab)
    gg = g.float()
    if use_bf16:
        gg = gg.to(torch.bfloat16).float()
    w = g.shape[-1]
    rows = torch.where(keep[..., None], gg, 0.0).reshape(-1, w)
    return torch.zeros((vocab, w), dtype=torch.float32, device=g.device).index_add_(
        0, torch.where(keep, i64, 0).reshape(-1), rows
    )


# ------------------------------------------------------------------- kernel
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("field_block")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tr_field_block_scatter.argtypes = [p, p, ll, i, i, p, i, i, i, p, p]
    lib.tr_field_block_scatter.restype = i
    return lib


def field_plan(offsets: Tuple[int, ...], sizes: Tuple[int, ...], w: int) -> Tuple[list, int]:
    """The kernel's field table, offsets + sizes + the shared-memory base of
    each field's accumulator (-1: the field adds straight into device
    memory), and the accumulator's size in floats. A field takes an
    accumulator when a block's PAIRS pairs are expected to hit each of its
    rows at least HOT_HITS times, while the accumulators fit ACC_FLOATS."""
    per_field = PAIRS / len(offsets)
    base, n_acc = [], 0
    for size in sizes:
        if size * HOT_HITS <= per_field and n_acc + size * w <= ACC_FLOATS:
            base.append(n_acc)
            n_acc += size * w
        else:
            base.append(-1)
    return [*offsets, *sizes, *base], n_acc


@functools.lru_cache(maxsize=64)
def _device_plan(offsets, sizes, w, device):
    table, n_acc = field_plan(offsets, sizes, w)
    return torch.tensor(table, dtype=torch.int32, device=device), n_acc


def field_block_scatter(
    ids: torch.Tensor, g: torch.Tensor, vocab: int, offsets: Sequence[int],
    sizes: Sequence[int], use_bf16: bool = True,
) -> torch.Tensor:
    """dtable f32 [vocab, W] = the field-masked (and, with use_bf16,
    bf16-rounded) scatter-add of g at ids. ids int32 [B, F] and g f32
    [B, F, W], both contiguous; offsets and sizes one per field. The
    kernel adds with vector atomics in no fixed order."""
    offsets, sizes = tuple(int(o) for o in offsets), tuple(int(s) for s in sizes)
    if ids.device.type == "cpu":
        return field_block_scatter_plain(ids, g, vocab, offsets, sizes, use_bf16)
    if ids.device.type != "cuda":
        raise ValueError(f"field_block_scatter: unsupported device {ids.device}")
    if ids.dim() != 2 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(
            f"field_block_scatter: ids must be a contiguous [B, F] int32 tensor (got {ids.dtype}, "
            f"shape {tuple(ids.shape)})"
        )
    b, f = ids.shape
    if g.device != ids.device or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"field_block_scatter: g must be a contiguous float32 tensor on {ids.device}")
    if g.dim() != 3 or tuple(g.shape[:2]) != (b, f):
        raise ValueError(f"field_block_scatter: g {tuple(g.shape)} for ids {(b, f)}")
    if len(offsets) != f or len(sizes) != f:
        raise ValueError(f"field_block_scatter: {len(offsets)} offsets, {len(sizes)} sizes for F={f}")
    if min(offsets) < 0 or min(sizes) < 0 or not 0 < vocab < 2**31:
        raise ValueError("field_block_scatter: negative offsets or sizes, or vocab outside int32")
    w = g.shape[2]
    if not 0 < w <= MAX_W:
        raise ValueError(f"field_block_scatter: W={w} outside (0, {MAX_W}]")
    fields, n_acc = _device_plan(offsets, sizes, w, ids.device)
    out = torch.zeros((vocab, w), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_field_block_scatter(
            ids.data_ptr(), g.data_ptr(), b * f, f, w, fields.data_ptr(), n_acc, vocab,
            int(use_bf16), out.data_ptr(), stream,
        )
    build.check_rc("field_block_scatter", rc)
    field_block_scatter.launches += 1
    return out


field_block_scatter.launches = 0


def reset_launches() -> None:
    field_block_scatter.launches = 0


# ------------------------------------------------------------------- lookup
class _FieldBlockLookup(torch.autograd.Function):
    """Forward: the plain gather table[ids] (JAX's forward is XLA's gather,
    outside any kernel). Backward: field_block_scatter for [B,F] ids; the
    plain scatter_reference for any other shape, as the JAX package does;
    the ids get no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor, spec) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.spec = spec
        ctx.vocab = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (ids,) = ctx.saved_tensors
        offsets, sizes, use_bf16 = ctx.spec
        if ids.dim() == 2 and ct.dim() == 3:
            dtable = field_block_scatter(
                ids.to(torch.int32).contiguous(), ct.float().contiguous(), ctx.vocab,
                offsets, sizes, use_bf16,
            )
        else:
            dtable = scatter_reference(ids, ct, ctx.vocab)
        return dtable, None, None


def make_field_block_lookup(
    vocab: int, offsets: Sequence[int], sizes: Sequence[int], use_bf16: bool = True
):
    """lookup(table, ids) -> table[ids], whose table gradient is the
    field-block scatter: a drop-in for ops/embedding.dense_lookup on
    field-partitioned id spaces (the dense step). It carries no
    ``static_slice_ok``, so DeepFM sends every field, the static ones
    too, through it, as the JAX package does. ``vocab`` keeps the JAX
    signature; the gradient takes the table's own row count."""
    del vocab
    spec = (tuple(int(o) for o in offsets), tuple(int(s) for s in sizes), bool(use_bf16))
    if len(spec[0]) != len(spec[1]):
        raise ValueError(f"--field_blocks: {len(spec[0])} offsets but {len(spec[1])} sizes")

    def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return _FieldBlockLookup.apply(table, ids, spec)

    return lookup
