"""PNN family (counterpart of the JAX package's models/pnn.py): FNN,
Inner-PNN and Outer-PNN by model_type. A fused [V,1+K] table gives the
linear part and the scaled embeddings; the deep input is the flat
embeddings (FNN), with the pairwise inner products (Inner) or the
flattened pairwise outer products (Outer); MLP -> 1 unit; logit = bias +
linear + deep; the loss adds l2_reg * l2_loss of the fused table."""

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
from tf_repos_tpu_torch.ops import interactions as I
from tf_repos_tpu_torch.ops import towers as T
from tf_repos_tpu_torch.ops.embedding import (
    dense_lookup,
    fused_linear_lookup,
    fused_linear_table_init,
)


class PNN(CtrModel):
    name = "PNN"

    def __init__(self, cfg, model_type: Optional[str] = None):
        super().__init__(cfg)
        self.model_type = model_type or cfg.model_type or "Inner"
        if self.model_type not in ("FNN", "Inner", "Outer"):
            raise ValueError(f"PNN model_type must be FNN/Inner/Outer, got {self.model_type}")

    def _deep_in_dim(self) -> int:
        f, k = self.cfg.field_size, self.cfg.embedding_size
        num_pairs = f * (f - 1) // 2
        if self.model_type == "FNN":
            return f * k
        if self.model_type == "Inner":
            return f * k + num_pairs
        return f * k + num_pairs * k * k

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        layers = cfg.deep_layers_list
        wv = fused_linear_table_init(generator, cfg.feature_size, cfg.embedding_size)
        mlp_params, mlp_state = T.init_mlp(
            generator, self._deep_in_dim(), layers, batch_norm=cfg.batch_norm
        )
        params = {
            "bias": torch.zeros(1),
            "wv": wv,
            "mlp": mlp_params,
            "out": T.init_dense(generator, layers[-1], 1),
        }
        return params, {"mlp": mlp_state}

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

        y_linear, emb = fused_linear_lookup(params["wv"], ids, vals, lookup)
        flat = emb.reshape(emb.shape[0], -1)
        if self.model_type == "FNN":
            deep_in = flat
        elif self.model_type == "Inner":
            deep_in = torch.cat([flat, I.pairwise_inner(emb)], dim=1)
        else:
            deep_in = torch.cat([flat, I.pairwise_outer(emb)], dim=1)

        h, mlp_state = T.apply_mlp(
            params["mlp"],
            state["mlp"],
            deep_in,
            keep_probs=cfg.dropout_list,
            train=train,
            generator=generator,
            batch_norm=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay,
            compute_dtype=cfg.tower_dtype,
        )
        y_d = T.dense(params["out"], h)[:, 0]
        logits = params["bias"][0] + y_linear + y_d
        return {"logits": logits, "prob": torch.sigmoid(logits)}, {"mlp": mlp_state}

    def l2_loss(self, params: Params) -> torch.Tensor:
        return self.cfg.l2_reg * 0.5 * torch.sum(torch.square(params["wv"]))

    def sparse_slots(self):
        return {"wv": SparseSlot(("feat_ids",), self.cfg.feature_size)}
