"""DeepMVM (counterpart of the JAX package's models/deepmvm.py): scaled
embeddings of an [V,K] table; the multi-view machine, the element-wise
product over all fields of (emb + a per-field bias [F,K]), beside a deep
MLP from the flattened embeddings; the two concatenated -> 1 unit; the
loss adds l2_reg * l2_loss of the table and of the field bias."""

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


class DeepMVM(CtrModel):
    name = "DeepMVM"

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        layers = cfg.deep_layers_list
        mvm_w = glorot_normal_init(generator, (cfg.feature_size, cfg.embedding_size))
        mvm_b = glorot_normal_init(generator, (cfg.field_size, cfg.embedding_size))
        mlp_params, mlp_state = T.init_mlp(
            generator, cfg.field_size * cfg.embedding_size, layers, batch_norm=cfg.batch_norm
        )
        params = {
            "mvm_w": mvm_w,
            "mvm_b": mvm_b,
            "mlp": mlp_params,
            "out": T.init_dense(generator, cfg.embedding_size + layers[-1], 1),
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

        emb = lookup(params["mvm_w"], ids) * vals[..., None]  # [B,F,K]
        x_mvm = I.mvm(emb, params["mvm_b"])  # [B,K]
        h, mlp_state = T.apply_mlp(
            params["mlp"],
            state["mlp"],
            emb.reshape(emb.shape[0], -1),
            keep_probs=cfg.dropout_list,
            train=train,
            generator=generator,
            batch_norm=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay,
            compute_dtype=cfg.tower_dtype,
        )
        logits = T.dense(params["out"], torch.cat([x_mvm, h], dim=1))[:, 0]
        return {"logits": logits, "prob": torch.sigmoid(logits)}, {"mlp": mlp_state}

    def l2_loss(self, params: Params) -> torch.Tensor:
        l2 = self.cfg.l2_reg
        return l2 * 0.5 * torch.sum(torch.square(params["mvm_w"])) + l2 * 0.5 * torch.sum(
            torch.square(params["mvm_b"])
        )

    def sparse_slots(self):
        return {"mvm_w": SparseSlot(("feat_ids",), self.cfg.feature_size)}
