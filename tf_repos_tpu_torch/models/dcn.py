"""DCN (counterpart of the JAX package's models/dcn.py): x0 = the
flattened scaled embeddings of an [V,K] table; cross layers x_{l+1} =
x0 * (x_l . w_l) + x_l + b_l beside a deep MLP from x0; the two
concatenated -> 1 unit; the loss adds l2_reg * l2_loss of cross_b,
cross_w and the table (on the sparse path, of the batch's rows)."""

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
from tf_repos_tpu_torch.ops.embedding import dense_lookup, glorot_normal_init


class DCN(CtrModel):
    name = "DCN"

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        d = cfg.field_size * cfg.embedding_size
        layers = cfg.deep_layers_list
        cross_b = glorot_normal_init(generator, (cfg.cross_layers, d))
        cross_w = glorot_normal_init(generator, (cfg.cross_layers, d))
        emb = glorot_normal_init(generator, (cfg.feature_size, cfg.embedding_size))
        mlp_params, mlp_state = T.init_mlp(generator, d, layers, batch_norm=cfg.batch_norm)
        params = {
            "cross_b": cross_b,
            "cross_w": cross_w,
            "emb": emb,
            "mlp": mlp_params,
            "out": T.init_dense(generator, d + layers[-1], 1),
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

        emb = lookup(params["emb"], ids) * vals[..., None]
        x0 = emb.reshape(emb.shape[0], -1)  # [B, F*K]

        xl = I.cross_network(x0, params["cross_w"], params["cross_b"])
        h, mlp_state = T.apply_mlp(
            params["mlp"],
            state["mlp"],
            x0,
            keep_probs=cfg.dropout_list,
            train=train,
            generator=generator,
            batch_norm=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay,
            compute_dtype=cfg.tower_dtype,
        )
        logits = T.dense(params["out"], torch.cat([xl, h], dim=1))[:, 0]
        return {"logits": logits, "prob": torch.sigmoid(logits)}, {"mlp": mlp_state}

    def l2_loss(self, params: Params) -> torch.Tensor:
        l2 = self.cfg.l2_reg
        return (
            l2 * 0.5 * torch.sum(torch.square(params["cross_b"]))
            + l2 * 0.5 * torch.sum(torch.square(params["cross_w"]))
            + l2 * 0.5 * torch.sum(torch.square(params["emb"]))
        )

    def sparse_slots(self):
        return {"emb": SparseSlot(("feat_ids",), self.cfg.feature_size)}
