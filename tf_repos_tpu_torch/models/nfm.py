"""NFM (counterpart of the JAX package's models/nfm.py): a fused [V,1+K]
table gives the linear part and the scaled embeddings, Bi-Interaction
pooling keeps a K-vector, dropout (keep dropout_list[0]) in front of the
MLP as well as inside it, MLP -> 1 unit; logit = bias + linear + deep;
the loss adds l2_reg * l2_loss of the fused table."""

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


class NFM(CtrModel):
    name = "NFM"

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        layers = cfg.deep_layers_list
        wv = fused_linear_table_init(generator, cfg.feature_size, cfg.embedding_size)
        mlp_params, mlp_state = T.init_mlp(
            generator, cfg.embedding_size, layers, batch_norm=cfg.batch_norm
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
        deep_in = I.bi_interaction(emb)  # [B,K]
        if train:
            deep_in = T.dropout(deep_in, cfg.dropout_list[0], generator)

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
