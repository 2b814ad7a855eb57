"""Losses and the streaming AUC (counterpart of the JAX package's ops/metrics.py):
tf.metrics.auc's 200-threshold confusion counts, accumulated on the
device, the per-example losses, and exact_auc (the Mann-Whitney
statistic, for a run's whole prediction set)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NUM_THRESHOLDS = 200  # tf.metrics.auc default
_KEPS = 1e-7


def _thresholds(device) -> torch.Tensor:
    """[-eps, 1/199, 2/199, ..., 198/199, 1+eps] (tf.metrics.auc layout)."""
    inner = torch.arange(1, NUM_THRESHOLDS - 1, dtype=torch.float32, device=device)
    inner = inner / (NUM_THRESHOLDS - 1)
    return torch.cat([
        torch.tensor([-_KEPS], dtype=torch.float32, device=device),
        inner,
        torch.tensor([1.0 + _KEPS], dtype=torch.float32, device=device),
    ])


class AucState(NamedTuple):
    """Confusion-matrix counts per threshold, [T] each."""

    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor

    @classmethod
    def init(cls, device="cpu") -> "AucState":
        return cls(*(torch.zeros(NUM_THRESHOLDS, device=device) for _ in range(4)))


def auc_update(
    state: AucState,
    labels: torch.Tensor,
    preds: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> AucState:
    """Accumulate one batch. labels/preds/weights: [B]."""
    if weights is None:
        weights = torch.ones_like(preds)
    t = _thresholds(preds.device)
    above = (preds[:, None] > t[None, :]).to(torch.float32)  # [B,T]
    pos = (labels * weights)[:, None]
    neg = ((1.0 - labels) * weights)[:, None]
    return AucState(
        tp=state.tp + torch.sum(above * pos, dim=0),
        fp=state.fp + torch.sum(above * neg, dim=0),
        tn=state.tn + torch.sum((1.0 - above) * neg, dim=0),
        fn=state.fn + torch.sum((1.0 - above) * pos, dim=0),
    )


def auc_finalize(state: AucState) -> torch.Tensor:
    """Trapezoidal ROC-AUC over the accumulated counts."""
    eps = 1e-7
    tpr = state.tp / (state.tp + state.fn + eps)
    fpr = state.fp / (state.fp + state.tn + eps)
    return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) * 0.5)


def log_loss(
    labels: torch.Tensor, preds: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities (eps-clipped)."""
    eps = 1e-7
    p = torch.clamp(preds, eps, 1.0 - eps)
    ll = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    if weights is None:
        return torch.mean(ll)
    return torch.sum(ll * weights) / torch.clamp(torch.sum(weights), min=1.0)


def sigmoid_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits, numerically stable. At a
    logit of exactly 0 (a tower whose last ReLU layer is all zero, with a
    zero bias) the gradient is -label, the subgradient the JAX package's
    jnp.maximum / jnp.abs give: torch.maximum splits a tie as jnp.maximum
    does, and the where() takes |x|' = 1 at 0 as jnp.abs does."""
    return torch.maximum(logits, torch.zeros_like(logits)) - logits * labels + torch.log1p(
        torch.exp(-torch.where(logits >= 0, logits, -logits))
    )


def squared_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's square_loss option on the sigmoid output."""
    return torch.square(torch.sigmoid(logits) - labels)


def exact_auc(labels: torch.Tensor, preds: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact ROC-AUC (the weighted Mann-Whitney U with tie correction),
    O(n log n), in float32 as the JAX package computes it. Ranks are
    cumulative weights, not indices, so zero-weight rows (batch padding)
    take no rank mass:

        U = sum_{i in pos} w_i * r_i - (W_pos^2 + sum_{i in pos} w_i^2) / 2
        r_i = A_i + (E_i + w_i) / 2

    with A_i the weight strictly below p_i and E_i the weight tied at p_i
    (itself included). Unit weights give the midrank formula
    U = sum(rank) - n_pos (n_pos + 1) / 2."""
    if weights is None:
        weights = torch.ones_like(preds)
    order = torch.argsort(preds, stable=True)
    p = preds[order]
    w = weights[order].to(torch.float32)
    y = labels[order].to(torch.float32)
    n = p.shape[0]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=p.device), p[1:] != p[:-1]])
    grp = torch.cumsum(is_new.to(torch.int64), 0) - 1
    grp_w = torch.zeros(n, dtype=torch.float32, device=p.device).index_add_(0, grp, w)
    below = torch.cumsum(grp_w, 0) - grp_w  # the weight strictly below each group
    r = below[grp] + (grp_w[grp] + w) / 2.0
    wpos = w * y
    w_pos = torch.sum(wpos)
    w_neg = torch.sum(w) - w_pos
    u = torch.sum(wpos * r) - (w_pos * w_pos + torch.sum(wpos * wpos)) / 2.0
    return u / (w_pos * w_neg + 1e-12)
