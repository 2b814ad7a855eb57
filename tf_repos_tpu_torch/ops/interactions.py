"""Feature interactions (counterpart of the JAX package's ops/interactions.py):
the distinctive math of each CTR model, as plain functions on tensors."""

from __future__ import annotations

from typing import Tuple

import torch


def scaled_embeddings(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """emb[b,f,:] = table[ids[b,f]] * vals[b,f]. table:[V,K], ids:[B,F],
    vals:[B,F] -> [B,F,K]."""
    return table[ids] * vals[..., None]


def first_order(weights: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """y_w[b] = sum_f w[ids[b,f]] * vals[b,f]."""
    return torch.sum(weights[ids] * vals, dim=1)


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """0.5 * sum_k((sum_f emb)^2 - sum_f emb^2), the FM sum-square trick.
    emb:[B,F,K] -> [B]."""
    sum_sq = torch.square(torch.sum(emb, dim=1))
    sq_sum = torch.sum(torch.square(emb), dim=1)
    return 0.5 * torch.sum(sum_sq - sq_sum, dim=1)


def bi_interaction(emb: torch.Tensor) -> torch.Tensor:
    """NFM's Bi-Interaction pooling: the sum-square trick kept as a
    K-vector. emb:[B,F,K] -> [B,K]."""
    sum_sq = torch.square(torch.sum(emb, dim=1))
    sq_sum = torch.sum(torch.square(emb), dim=1)
    return 0.5 * (sum_sq - sq_sum)


def _pair_indices(field_size: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The upper-triangle (i < j) field pairs, in np.triu_indices(F, k=1)'s
    row-major order, as int64 tensors on ``device`` (made there: no
    host-to-device copy in the step)."""
    row, col = torch.triu_indices(field_size, field_size, offset=1, device=device)
    return row, col


def pairwise_inner(emb: torch.Tensor) -> torch.Tensor:
    """IPNN: the inner products of all F(F-1)/2 embedding pairs, the strict
    upper triangle of the field Gram matrix emb @ emb^T. emb:[B,F,K] ->
    [B,P]. The triangle is taken with index_select, whose backward adds
    each pair's gradient back with index_add_; advanced indexing
    (gram[:, row, col]) would sort the indices in its backward, 2.9 of
    IPNN's 6.0 ms step at B=16,384 on an NVIDIA H100."""
    b, f, _ = emb.shape
    gram = torch.bmm(emb, emb.transpose(1, 2))
    row, col = _pair_indices(f, emb.device)
    return gram.reshape(b, f * f).index_select(1, row * f + col)


def pairwise_outer(emb: torch.Tensor) -> torch.Tensor:
    """OPNN: the outer product of each pair, flattened. emb:[B,F,K] ->
    [B, P*K*K]."""
    row, col = _pair_indices(emb.shape[1], emb.device)
    outer = emb[:, row, :, None] * emb[:, col, None, :]  # [B,P,K,K]
    return outer.reshape(emb.shape[0], -1)


def pairwise_elementwise(emb: torch.Tensor) -> torch.Tensor:
    """AFM: the element-wise products of all pairs. emb:[B,F,K] -> [B,P,K]."""
    row, col = _pair_indices(emb.shape[1], emb.device)
    return emb[:, row, :] * emb[:, col, :]


def cross_network(x0: torch.Tensor, cross_w: torch.Tensor, cross_b: torch.Tensor) -> torch.Tensor:
    """DCN's cross layers, x_{l+1} = x0 * (x_l . w_l) + x_l + b_l, a loop
    over the L layers (JAX scans them). x0:[B,D], cross_w/cross_b:[L,D]
    -> [B,D]."""
    xl = x0
    for w, b in zip(cross_w, cross_b):
        xlw = torch.sum(xl * w, dim=1, keepdim=True)  # [B,1]
        xl = x0 * xlw + xl + b
    return xl


def mvm(emb: torch.Tensor, field_bias: torch.Tensor) -> torch.Tensor:
    """DeepMVM's multi-view machine: the element-wise product over all
    fields of (emb + per-field bias). emb:[B,F,K], field_bias:[F,K] ->
    [B,K]."""
    return torch.prod(emb + field_bias[None], dim=1)


def attention_pool(
    interactions: torch.Tensor, att_logits: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention-weighted sum-pool: softmax of the per-pair logits over the
    pair axis, then the weighted sum. interactions:[B,P,K],
    att_logits:[B,P,1] -> (pooled [B,K], weights [B,P,1]). AFM keeps the
    same steps inline, with its dropout between them."""
    aij = torch.softmax(att_logits, dim=1)
    return torch.sum(aij * interactions, dim=1), aij
