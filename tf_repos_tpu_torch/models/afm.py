"""AFM (counterpart of the JAX package's models/afm.py): a fused [V,1+K]
table gives the linear part and the scaled embeddings; the element-wise
products of all F(F-1)/2 pairs go through an attention MLP (ReLU stack,
no dropout, no batch norm) to one logit a pair, softmaxed over the pair
axis; dropout (keep dropout_list[0]) on the attention weights, the
weighted sum-pool, dropout (keep dropout_list[1]) on the pooled vector,
a 1-unit projection; logit = bias + linear + deep; the loss adds
l2_reg * l2_loss of the fused table."""

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


class AFM(CtrModel):
    name = "AFM"

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        att_layers = cfg.attention_layers_list
        wv = fused_linear_table_init(generator, cfg.feature_size, cfg.embedding_size)
        att_params, att_state = T.init_mlp(generator, cfg.embedding_size, att_layers)
        params = {
            "bias": torch.zeros(1),
            "wv": wv,
            "att_mlp": att_params,
            "att_out": T.init_dense(generator, att_layers[-1], 1),
            "out": T.init_dense(generator, cfg.embedding_size, 1),
        }
        return params, {"att_mlp": att_state}

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
        b = ids.shape[0]
        num_pairs = cfg.field_size * (cfg.field_size - 1) // 2

        y_linear, emb = fused_linear_lookup(params["wv"], ids, vals, lookup)
        pairs = I.pairwise_elementwise(emb)  # [B,P,K]

        # the attention net runs per pair: the pairs flattened into the
        # batch axis
        att_in = pairs.reshape(b * num_pairs, cfg.embedding_size)
        h, att_state = T.apply_mlp(
            params["att_mlp"], state["att_mlp"], att_in, keep_probs=[1.0], train=train,
            generator=None, compute_dtype=cfg.tower_dtype,
        )
        att_logits = T.dense(params["att_out"], h).reshape(b, num_pairs, 1)
        aij = torch.softmax(att_logits, dim=1)
        if train:
            aij = T.dropout(aij, cfg.dropout_list[0], generator)

        y_emb = torch.sum(aij * pairs, dim=1)  # [B,K]
        if train:
            y_emb = T.dropout(y_emb, cfg.dropout_list[1], generator)
        y_d = T.dense(params["out"], y_emb)[:, 0]

        logits = params["bias"][0] + y_linear + y_d
        return {"logits": logits, "prob": torch.sigmoid(logits)}, {"att_mlp": att_state}

    def l2_loss(self, params: Params) -> torch.Tensor:
        return self.cfg.l2_reg * 0.5 * torch.sum(torch.square(params["wv"]))

    def sparse_slots(self):
        return {"wv": SparseSlot(("feat_ids",), self.cfg.feature_size)}
