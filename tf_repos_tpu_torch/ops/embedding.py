"""Embedding-table creation and lookup (counterpart of
the JAX package's ops/embedding.py, single-device part).

Initializers draw on the CPU from an explicit ``torch.Generator`` and the
caller moves the result to its device, so one seed gives the same
weights on the CPU and on the GPU."""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

LookupFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_SQRT2 = math.sqrt(2.0)


def truncated_normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverse-CDF sampling."""
    lo, hi = math.erf(-2.0 / _SQRT2), math.erf(2.0 / _SQRT2)
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = _SQRT2 * torch.erfinv(lo + (hi - lo) * u)
    return x.clamp_(-2.0, 2.0).to(torch.float32)


def glorot_normal_init(generator: Optional[torch.Generator], shape) -> torch.Tensor:
    """tf.glorot_normal_initializer: truncated normal (2 sigma) with
    stddev sqrt(2/(fan_in+fan_out)), rescaled by 1/0.87962566 as TF does;
    1-D shapes use fan_in = fan_out = shape[0]."""
    if len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return truncated_normal(tuple(shape), generator) * (std / 0.87962566)


def dense_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table:[V,...], ids:int[...] -> [..., ...]."""
    return table[ids]


def coo_pool(table: torch.Tensor, idx: torch.Tensor, dest: torch.Tensor,
             w: torch.Tensor, n_out: int) -> torch.Tensor:
    """COO multi-hot segment pool, plain form: out[d] = sum over
    {i: dest[i] == d} of w[i] * table[idx[i]], f32 [n_out, K]. The
    models' default combiner for --mh_coo batches; a lookup may carry a
    kernel drop-in as its ``coo_pool`` attribute (ops/coo_pool.py).
    Padding entries (idx = dest = 0, w = 0) add zero into row 0."""
    rows = table[idx].float() * w.float()[:, None]
    return torch.zeros((n_out, table.shape[-1]), dtype=torch.float32, device=table.device).index_add_(
        0, dest, rows
    )


def fused_linear_table_init(
    generator: Optional[torch.Generator], feature_size: int, k: int
) -> torch.Tensor:
    """One [V, 1+K] table: column 0 is the first-order weight, columns
    1..K the embedding; column 0 uses the 1-D glorot fan, the rest 2-D."""
    w = glorot_normal_init(generator, (feature_size,))
    v = glorot_normal_init(generator, (feature_size, k))
    return torch.cat([w[:, None], v], dim=1)


def fused_linear_lookup(
    table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
    lookup: LookupFn = dense_lookup,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_linear [B], scaled emb [B,F,K]) from one lookup of a fused
    [V,1+K] table: y_linear = sum_f w[id_f]*val_f; emb = V[id]*val."""
    rows = lookup(table, ids)  # [B,F,1+K]
    y_lin = torch.sum(rows[..., 0] * vals, dim=1)
    emb = rows[..., 1:] * vals[..., None]
    return y_lin, emb
