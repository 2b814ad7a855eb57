"""ESMM (DeepCvrMTL): joint CTR and CVR over the whole impression space
(counterpart of the JAX package's models/esmm.py).

One shared embedding table over the common, multi-hot and ad fields
(common embeddings are not value-scaled); two parallel MLP towers, CVR
and CTR; pCTCVR = pCTR * pCVR; loss = ctr_task_wgt * sigmoid_CE(y_ctr; y)
+ (1 - wgt) * log_loss(pctcvr; z) + l2_reg * l2_loss(emb); metrics
CTR_AUC (y, pctr), CVR_AUC (z, pcvr), CTCVR_AUC (z, pctcvr).

Batches are the padded Ali-CCP layout of data/ragged.py with labels y
(click) and z (conversion). Under --mh_coo the host has replaced the
five multi-hot fields by a COO triplet of their live slots
(data/sparse_batch.MhCooPacker) and one segment pool computes the five
sum-pools."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tf_repos_tpu_torch.data.sparse_batch import MHC_DEST, MHC_IDX, MHC_W
from tf_repos_tpu_torch.models.base import (
    Batch,
    CtrModel,
    Outputs,
    Params,
    SparseSlot,
    State,
)
from tf_repos_tpu_torch.ops import metrics as M
from tf_repos_tpu_torch.ops import towers as T
from tf_repos_tpu_torch.ops.embedding import coo_pool, dense_lookup, glorot_normal_init

USER_FIELDS = ("u_cat", "u_shop", "u_brand", "u_int")

# --mh_coo group order: the 4 val-weighted user behaviour fields, then the
# mask-only ad intention field; the COO dest is b * len(groups) + group
MH_COO_GROUPS = (
    ("u_cat", True), ("u_shop", True), ("u_brand", True), ("u_int", True),
    ("a_int", False),
)


class ESMM(CtrModel):
    name = "ESMM"

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        k = cfg.embedding_size
        layers = cfg.deep_layers_list
        mlp_in = cfg.field_size * k + 8 * k
        emb = glorot_normal_init(generator, (cfg.feature_size, k))
        cvr_mlp, cvr_state = T.init_mlp(generator, mlp_in, layers, batch_norm=cfg.batch_norm)
        ctr_mlp, ctr_state = T.init_mlp(generator, mlp_in, layers, batch_norm=cfg.batch_norm)
        params = {
            "emb": emb,
            "cvr_mlp": cvr_mlp,
            "cvr_out": T.init_dense(generator, layers[-1], 1),
            "ctr_mlp": ctr_mlp,
            "ctr_out": T.init_dense(generator, layers[-1], 1),
        }
        return params, {"cvr_mlp": cvr_state, "ctr_mlp": ctr_state}

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
        emb_t = params["emb"]
        b, fc = batch["feat_ids"].shape
        ads = [batch[f][:, None] for f in ("a_catids", "a_shopids", "a_brandids")]
        if MHC_IDX in batch:
            # --mh_coo: one lookup for the single-valued fields, one
            # segment pool over the live multi-hot slots
            rows = lookup(emb_t, torch.cat([batch["feat_ids"], *ads], dim=1))  # [B, fc+3, K]
            common = rows[:, :fc]  # unscaled
            a_cat, a_shop, a_brand = rows[:, fc], rows[:, fc + 1], rows[:, fc + 2]
            ng = len(MH_COO_GROUPS)
            pool = getattr(lookup, "coo_pool", coo_pool)
            pooled_all = pool(
                emb_t, batch[MHC_IDX].reshape(-1), batch[MHC_DEST].reshape(-1),
                batch[MHC_W].reshape(-1), b * ng,
            ).reshape(b, ng, -1).to(rows.dtype)
            pooled = [pooled_all[:, i] for i in range(len(USER_FIELDS))]
            a_int = pooled_all[:, len(USER_FIELDS)]
        else:
            # one gather for every field; per-field widths may differ
            all_ids = torch.cat(
                [batch["feat_ids"], *[batch[f"{f}ids"] for f in USER_FIELDS], *ads,
                 batch["a_intids"]],
                dim=1,
            )
            rows = lookup(emb_t, all_ids)
            common = rows[:, :fc]  # unscaled
            off = fc
            pooled = []
            for f in USER_FIELDS:
                ids, vals = batch[f"{f}ids"], batch[f"{f}vals"]
                mask = (ids > 0).to(rows.dtype)
                demb = rows[:, off : off + ids.shape[1]]
                off += ids.shape[1]
                pooled.append(torch.einsum("bpk,bp->bk", demb, mask * vals))  # sum combiner
            a_cat, a_shop, a_brand = rows[:, off], rows[:, off + 1], rows[:, off + 2]
            off += 3
            int_mask = (batch["a_intids"] > 0).to(rows.dtype)
            a_int = torch.einsum("bpk,bp->bk", rows[:, off:], int_mask)

        x = torch.cat(
            [common.reshape(b, -1), *pooled, a_cat, a_shop, a_brand, a_int], dim=1
        )
        new_state: State = {}
        logits = {}
        for head in ("cvr", "ctr"):
            h, new_state[f"{head}_mlp"] = T.apply_mlp(
                params[f"{head}_mlp"], state[f"{head}_mlp"], x,
                keep_probs=cfg.dropout_list, train=train, generator=generator,
                batch_norm=cfg.batch_norm, bn_decay=cfg.batch_norm_decay,
                compute_dtype=cfg.tower_dtype,
            )
            logits[head] = T.dense(params[f"{head}_out"], h)[:, 0]
        pctr = torch.sigmoid(logits["ctr"])
        pcvr = torch.sigmoid(logits["cvr"])
        pctcvr = pctr * pcvr
        return {
            "logits": logits["ctr"],
            "logits_cvr": logits["cvr"],
            "pctr": pctr,
            "pcvr": pcvr,
            "pctcvr": pctcvr,
            "prob": pctcvr,
        }, new_state

    def loss(self, params, state, batch, *, train, generator=None, lookup=dense_lookup):
        out, new_state = self.apply(
            params, state, batch, train=train, generator=generator, lookup=lookup
        )
        y, z = batch["y"], batch["z"]
        mask = batch.get("mask")
        ctr_per = M.sigmoid_xent(out["logits"], y)
        if mask is None:
            ctr_loss = torch.mean(ctr_per)
            cvr_loss = M.log_loss(z, out["pctcvr"])
        else:
            ctr_loss = torch.sum(ctr_per * mask) / torch.clamp(torch.sum(mask), min=1.0)
            cvr_loss = M.log_loss(z, out["pctcvr"], mask)
        w = self.cfg.ctr_task_wgt
        loss = w * ctr_loss + (1.0 - w) * cvr_loss + self.l2_loss(params)
        return loss, (out, new_state)

    def per_example_loss(self, out: Outputs, batch: Batch) -> torch.Tensor:
        """[B] joint loss per example, without L2: its masked mean is
        loss() minus the L2 term."""
        y, z = batch["y"], batch["z"]
        ctr_per = M.sigmoid_xent(out["logits"], y)
        eps = 1e-7
        p = torch.clamp(out["pctcvr"], eps, 1.0 - eps)
        cvr_per = -(z * torch.log(p) + (1.0 - z) * torch.log(1.0 - p))
        w = self.cfg.ctr_task_wgt
        return w * ctr_per + (1.0 - w) * cvr_per

    def l2_loss(self, params: Params) -> torch.Tensor:
        return self.cfg.l2_reg * 0.5 * torch.sum(torch.square(params["emb"]))

    def eval_metrics(self, out: Outputs, batch: Batch):
        return {
            "CTR_AUC": (batch["y"], out["pctr"]),
            "CVR_AUC": (batch["z"], out["pcvr"]),
            "CTCVR_AUC": (batch["z"], out["pctcvr"]),
        }

    @property
    def prediction_keys(self):
        return ["pctcvr", "pctr", "pcvr"]

    def sparse_slots(self):
        return {"emb": SparseSlot(
            ("feat_ids", "u_catids", "u_shopids", "u_brandids", "u_intids",
             "a_catids", "a_shopids", "a_brandids", "a_intids"),
            self.cfg.feature_size,
        )}

    def mh_coo_groups(self):
        return MH_COO_GROUPS

    def coo_combine_ok(self) -> bool:
        """Every ESMM pool is a sum combiner, linear in w."""
        return True
