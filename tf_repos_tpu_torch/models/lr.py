"""LR (counterpart of the JAX package's models/lr.py): logistic regression
over the unified libsvm id space, logit = b + sum_f w[id_f] * val_f, with
a 1-D [V] weight table and l2_reg * l2_loss(w).

The 1-D table takes the lazy sparse step's unfused row forms
(train/sparse.py: Adam, Adagrad, FTRL, Momentum, GD) and the dense step;
it has no fused w|m|v row store and no
[S, K] row kernels, so the harness refuses --fused_table and
--pallas_expand for it, as the JAX package cannot run it there either.
Serving gathers it through K1 as a [V, 1] table
(ops/sparse_rows.make_serving_lookup)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tf_repos_tpu_torch.models.base import (
    Batch,
    CtrModel,
    Outputs,
    Params,
    SparseSlot,
    State,
)
from tf_repos_tpu_torch.ops.embedding import dense_lookup


class LR(CtrModel):
    name = "LR"
    flat_table = True

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        return {"bias": torch.zeros(1), "w": torch.zeros(self.cfg.feature_size)}, {}

    def apply(
        self,
        params: Params,
        state: State,
        batch: Batch,
        *,
        train: bool,
        generator: Optional[torch.Generator] = None,
        lookup=dense_lookup,
    ) -> Tuple[Outputs, State]:
        cfg = self.cfg
        ids = batch["feat_ids"].reshape(-1, cfg.field_size)
        vals = batch["feat_vals"].reshape(-1, cfg.field_size)
        logits = params["bias"][0] + torch.sum(lookup(params["w"], ids) * vals, dim=1)
        return {"logits": logits, "prob": torch.sigmoid(logits)}, state

    def l2_loss(self, params: Params) -> torch.Tensor:
        return self.cfg.l2_reg * 0.5 * torch.sum(torch.square(params["w"]))

    def sparse_slots(self):
        return {"w": SparseSlot(("feat_ids",), self.cfg.feature_size)}
