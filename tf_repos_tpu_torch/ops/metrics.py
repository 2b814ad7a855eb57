"""Losses and the streaming AUC (counterpart of the JAX package's ops/metrics.py):
tf.metrics.auc's 200-threshold confusion counts, accumulated on the
device, and the per-example losses."""

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
