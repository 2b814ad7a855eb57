"""DeepFM (counterpart of the JAX package's models/deepfm.py): FM bias +
first order + second order (sum-square trick) + deep MLP over the
concatenated embeddings; the loss adds l2_reg * l2_loss of the fused
[V,1+K] table."""

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
from tf_repos_tpu_torch.utils.observability import span


class DeepFM(CtrModel):
    name = "DeepFM"

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        layers = cfg.deep_layers_list
        fm_wv = fused_linear_table_init(generator, cfg.feature_size, cfg.embedding_size)
        mlp_params, mlp_state = T.init_mlp(
            generator, cfg.field_size * cfg.embedding_size, layers,
            batch_norm=cfg.batch_norm,
        )
        params = {
            "fm_b": torch.zeros(1),
            "fm_wv": fm_wv,
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

        sf = cfg.static_fields
        with span("model.embed") as s:
            if sf > 0 and (
                lookup is dense_lookup or getattr(lookup, "static_slice_ok", False)
            ):
                # Criteo layout: fields 0..sf-1 carry constant ids 1..sf, so
                # their rows come from a slice and only B*(F-sf) rows go
                # through the lookup
                table = params["fm_wv"]
                srows = table[1 : 1 + sf]  # [sf,1+K]
                y_w_s = vals[:, :sf] @ srows[:, 0]
                emb_s = srows[None, :, 1:] * vals[:, :sf, None]  # [B,sf,K]
                y_w_d, emb_d = fused_linear_lookup(table, ids[:, sf:], vals[:, sf:], lookup)
                y_w = y_w_s + y_w_d
                emb = torch.cat([emb_s, emb_d], dim=1)
            else:
                y_w, emb = fused_linear_lookup(params["fm_wv"], ids, vals, lookup)
        s.backward_half((y_w, emb), params["fm_wv"])
        with span("model.fm", adjacent=True) as s:
            y_v = I.fm_second_order(emb)
        s.backward_half(y_v, emb)

        with span("model.towers", adjacent=True) as s:
            deep_in = emb.reshape(emb.shape[0], -1)
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
        s.backward_half(y_d, (deep_in, params["mlp"], params["out"]))

        logits = params["fm_b"][0] + y_w + y_v + y_d
        return {"logits": logits, "prob": torch.sigmoid(logits)}, {"mlp": mlp_state}

    def l2_loss(self, params: Params) -> torch.Tensor:
        return self.cfg.l2_reg * 0.5 * torch.sum(torch.square(params["fm_wv"]))

    def sparse_slots(self):
        return {
            "fm_wv": SparseSlot(
                ("feat_ids",), self.cfg.feature_size, static=self.cfg.static_fields
            )
        }
