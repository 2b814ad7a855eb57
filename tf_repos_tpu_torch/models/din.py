"""DIN, the Deep Interest Network over Ali-CCP records (counterpart of the
JAX package's models/din.py).

One shared embedding table; four user behaviour multi-hot fields (u_cat,
u_shop, u_brand, u_int), each pooled against its ad-side embedding
(a_cat, a_shop, a_brand, and a_int, the sum of the a_int multi-hot
field) by an attention unit: an MLP over [u, u - a, a] gives a sigmoid
weight per slot, and the pool is the weighted sum over the live slots.
With --attention_pooling=false each field is a plain weighted sum-pool.
Then concat(common embeddings, 4 pools, 4 ad embeddings) -> MLP -> logit;
L2 on the embedding table only.

The reference's quirk is kept: the attention MLP has
len(attention_layers) layers but takes their widths from deep_layers
(``_att_widths``).

Batches are the padded Ali-CCP layout of data/ragged.py, label = y. Under
--mh_coo the host has replaced the four user fields by a COO triplet of
their live slots (data/sparse_batch.MhCooPacker; a_int stays padded and
rides the shared gather). The sum-pools then run on the COO pool, and the
attention MLP runs over the live slots only: the same function, since a
dead slot adds 0 to the masked weighted sum. With a lookup that carries
the sorted-stream pair (ops/sorted_seg.py) and the packer's counts, the
per-slot query select and the segment sum run over the compact segment
stream (K6 and K5); otherwise over ``dest`` with a plain gather and
scatter."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tf_repos_tpu_torch.data.sparse_batch import (
    MHC_CDEST,
    MHC_CIDX,
    MHC_CNT,
    MHC_DEST,
    MHC_IDX,
    MHC_PERM,
    MHC_SROWS,
    MHC_W,
)
from tf_repos_tpu_torch.models.base import (
    Batch,
    CtrModel,
    Outputs,
    Params,
    SparseSlot,
    State,
)
from tf_repos_tpu_torch.ops import att_unit
from tf_repos_tpu_torch.ops import towers as T
from tf_repos_tpu_torch.ops.embedding import coo_pool, dense_lookup, glorot_normal_init
from tf_repos_tpu_torch.utils.observability import span

USER_FIELDS = ("u_cat", "u_shop", "u_brand", "u_int")

# --mh_coo groups: the four user fields; the COO dest is b * 4 + group
MH_COO_GROUPS = (
    ("u_cat", True), ("u_shop", True), ("u_brand", True), ("u_int", True),
)


class DIN(CtrModel):
    name = "DIN"

    def _att_widths(self):
        """len(attention_layers) layers, widths from deep_layers."""
        cfg = self.cfg
        return [cfg.deep_layers_list[i] for i in range(len(cfg.attention_layers_list))]

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        k = cfg.embedding_size
        layers = cfg.deep_layers_list
        # concat: common + 4 user pools + a_cat + a_shop + a_brand + a_int
        mlp_in = cfg.field_size * k + 8 * k
        params: Params = {"emb": glorot_normal_init(generator, (cfg.feature_size, k))}
        state: State = {}
        if cfg.attention_pooling:
            params["att_mlp"], state["att_mlp"] = T.init_mlp(
                generator, 3 * k, self._att_widths(), batch_norm=cfg.batch_norm
            )
            params["att_out"] = T.init_dense(generator, self._att_widths()[-1], 1)
        params["mlp"], state["mlp"] = T.init_mlp(
            generator, mlp_in, layers, batch_norm=cfg.batch_norm
        )
        params["out"] = T.init_dense(generator, layers[-1], 1)
        return params, state

    def _att_mlp(self, params, state, u, a, *, train, generator):
        """Attention weight per row from the MLP over [u, u - a, a]: [N].
        ops/att_unit.py takes the fused kernels where the configuration
        and tensors allow, else the ATen composition."""
        cfg = self.cfg
        return att_unit.apply(
            params["att_mlp"], state, params["att_out"], u, a, keep_probs=cfg.dropout_list,
            train=train, generator=generator, batch_norm=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay, compute_dtype=cfg.tower_dtype,
        )

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
        coo = MHC_IDX in batch
        # one gather for every padded field (per-field widths may differ
        # under --mh_bucket); the packed user fields are absent under
        # --mh_coo
        parts = [batch["feat_ids"]]
        user_off = {}
        off = fc
        for f in USER_FIELDS:
            if f"{f}ids" in batch:
                w = batch[f"{f}ids"].shape[1]
                parts.append(batch[f"{f}ids"])
                user_off[f] = (off, w)
                off += w
        parts += [batch[f][:, None] for f in ("a_catids", "a_shopids", "a_brandids")]
        scalar_off = off
        off += 3
        parts.append(batch["a_intids"])
        with span("model.embed") as s:
            rows = lookup(emb_t, torch.cat(parts, dim=1))
            common = rows[:, :fc]
            a_cat, a_shop, a_brand = (rows[:, scalar_off + i] for i in range(3))
            int_mask = (batch["a_intids"] > 0).to(common.dtype)
            a_int = torch.einsum("bpk,bp->bk", rows[:, off:], int_mask)  # sum combiner
        s.backward_half((rows, common, a_cat, a_shop, a_brand, a_int), emb_t)
        new_state: State = {}

        if coo:
            ng = len(MH_COO_GROUPS)
            idxf = batch[MHC_IDX].reshape(-1)
            destf = batch[MHC_DEST].reshape(-1)
            wf = batch[MHC_W].reshape(-1)
            if cfg.attention_pooling:
                pooled, new_state["att_mlp"] = self._coo_attention(
                    params, state, batch, lookup, emb_t, idxf, destf, wf,
                    torch.stack([a_cat, a_shop, a_brand, a_int], dim=1), b,
                    train=train, generator=generator, dtype=common.dtype,
                )
            else:
                pool = getattr(lookup, "coo_pool", coo_pool)
                sums = pool(emb_t, idxf, destf, wf, b * ng).reshape(b, ng, -1).to(common.dtype)
                pooled = [sums[:, i] for i in range(len(USER_FIELDS))]
        else:
            ad_emb = {"u_cat": a_cat, "u_shop": a_shop, "u_brand": a_brand, "u_int": a_int}
            pooled = []
            att_state = state.get("att_mlp")
            for f in USER_FIELDS:
                ids, vals = batch[f"{f}ids"], batch[f"{f}vals"]
                o, w = user_off[f]
                mask = (ids > 0).to(common.dtype)
                demb = rows[:, o : o + w] * vals[..., None]  # [B,P,K]
                if cfg.attention_pooling:
                    p = demb.shape[1]
                    # the width spelled out: a pad of 0 (the servable
                    # signature of a --multi_hot_pad=0 run) leaves -1 undefined
                    k = demb.shape[-1]
                    ub = demb.reshape(b * p, k)
                    ax = ad_emb[f][:, None, :].expand(b, p, k).reshape(b * p, k)
                    wgt, att_state = self._att_mlp(
                        params, att_state, ub, ax, train=train, generator=generator,
                    )
                    pooled.append(torch.sum(demb * wgt.reshape(b, p, 1) * mask[..., None], dim=1))
                else:  # plain weighted sum-pool
                    pooled.append(torch.einsum("bpk,bp->bk", demb, mask))
            if cfg.attention_pooling:
                new_state["att_mlp"] = att_state

        with span("model.towers", adjacent=coo and cfg.attention_pooling) as s:
            x = torch.cat([common.reshape(b, -1), *pooled, a_cat, a_shop, a_brand, a_int], dim=1)
            h, new_state["mlp"] = T.apply_mlp(
                params["mlp"], state["mlp"], x, keep_probs=cfg.dropout_list, train=train,
                generator=generator, batch_norm=cfg.batch_norm, bn_decay=cfg.batch_norm_decay,
                compute_dtype=cfg.tower_dtype,
            )
            logits = T.dense(params["out"], h)[:, 0]
        s.backward_half(logits, (common, pooled, a_cat, a_shop, a_brand, a_int,
                                 params["mlp"], params["out"]))
        return {"logits": logits, "prob": torch.sigmoid(logits)}, new_state

    def _coo_attention(self, params, state, batch, lookup, emb_t, idxf, destf, wf, ad_all, b,
                       *, train, generator, dtype):
        """Attention pools over the live COO slots: slot j of group g
        scores MLP([d, d - a_g, a_g]) with d = w[j] * emb[idx[j]]; one
        gather of the slots' rows feeds the MLP input and the pool."""
        ng = len(MH_COO_GROUPS)
        seg_pool = getattr(lookup, "seg_pool", None)
        use_sorted = seg_pool is not None and MHC_CNT in batch
        sbe = getattr(lookup, "sorted_bwd_expand", None)
        with span("model.embed") as s:
            if use_sorted and sbe is not None and MHC_PERM in batch:
                # --coo_sorted_bwd: the lookup's backward rides the idx-sorted
                # stream (K5 per run of equal id instead of K2's atomics)
                raw = sbe(emb_t, idxf, batch[MHC_PERM].reshape(-1), batch[MHC_CIDX].reshape(-1),
                          batch[MHC_SROWS].reshape(-1), batch[MHC_CNT].sum())
            else:
                raw = lookup(emb_t, idxf)
            d_rows = raw.to(dtype) * wf[:, None].to(dtype)
        s.backward_half(d_rows, emb_t)
        gc = b * ng
        with span("model.attention", count=lambda: idxf.shape[0], adjacent=True) as s:
            if use_sorted:
                # the compact segment stream: one compact row per non-empty
                # (group, row) bag, in the packer's group-major order
                cnt = batch[MHC_CNT].reshape(-1)
                nz = cnt > 0
                c_ix = torch.clamp(torch.cumsum(nz.to(torch.int32), 0, dtype=torch.int32) - 1, min=0)
                if MHC_CDEST in batch:
                    cdest = batch[MHC_CDEST].reshape(-1)
                else:
                    # rebuilt on the device, padded with 0 as the packer pads;
                    # output_size keeps it free of a host sync
                    m = idxf.shape[0]
                    cdest = torch.repeat_interleave(
                        torch.cat([c_ix, c_ix.new_zeros(1)]),
                        torch.cat([cnt, (m - cnt.sum()).to(cnt.dtype).reshape(1)]),
                        output_size=m,
                    )
                # queries in compact rows: each bag's ad embedding at its
                # compact row; empty bags land in the spare row gc, cut off
                q_fm = ad_all.transpose(0, 1).reshape(gc, -1)  # group-major
                tgt = torch.where(nz, c_ix, torch.full_like(c_ix, gc))
                q_c = q_fm.new_zeros((gc + 1, q_fm.shape[1])).index_put((tgt,), q_fm)[:gc]
                a_sel = lookup.seg_select(q_c, cdest)
            else:
                a_sel = ad_all.reshape(gc, -1)[destf]
            wgt, att_state = self._att_mlp(
                params, state["att_mlp"], d_rows, a_sel, train=train, generator=generator,
            )
            weighted = d_rows * wgt.to(d_rows.dtype)[:, None]
            # f32 accumulation in both forms
            if use_sorted:
                pooled_c = seg_pool(weighted, cdest, gc)  # [gc, K] f32, compact rows
                att_pooled = torch.where(nz[:, None], pooled_c[c_ix], 0.0).reshape(ng, b, -1).to(dtype)
            else:
                att_pooled = torch.zeros((gc, d_rows.shape[-1]), dtype=torch.float32,
                                         device=d_rows.device).index_add(0, destf, weighted.float())
                att_pooled = att_pooled.reshape(b, ng, -1).to(dtype)
        s.backward_half(att_pooled, (d_rows, ad_all, params["att_mlp"], params["att_out"]))
        if use_sorted:
            return [att_pooled[i] for i in range(ng)], att_state
        return [att_pooled[:, i] for i in range(ng)], att_state

    def l2_loss(self, params: Params) -> torch.Tensor:
        return self.cfg.l2_reg * 0.5 * torch.sum(torch.square(params["emb"]))

    def sparse_slots(self):
        return {"emb": SparseSlot(
            ("feat_ids", "u_catids", "u_shopids", "u_brandids", "u_intids",
             "a_catids", "a_shopids", "a_brandids", "a_intids"),
            self.cfg.feature_size,
        )}

    def mh_coo_groups(self):
        return MH_COO_GROUPS

    def coo_combine_ok(self) -> bool:
        """Only without attention: the attention MLP scores each slot from
        w * emb nonlinearly, so summing duplicate weights would change
        it; the sum-pools are linear in w."""
        return not self.cfg.attention_pooling

    def wants_sorted_seg(self) -> bool:
        return bool(self.cfg.attention_pooling)

    def wants_sorted_aux(self) -> bool:
        return bool(self.cfg.attention_pooling)
