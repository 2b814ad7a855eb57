"""Plain DIN (Zhou et al. 2018; the reference's deep_ctr DIN.py) on
Ali-CCP records: one shared embedding table; each user behaviour field
(u_cat, u_shop, u_brand, u_int) is pooled against its ad-side embedding
(a_cat, a_shop, a_brand, and a_int, the sum over the a_int multi-hot
field) by an attention unit: an MLP over [d, d - a, a] gives a sigmoid
weight for each live slot (id > 0, d = val * emb[id]), and the pool is
the weighted sum over the live slots. Then concat(common embeddings,
the 4 pools, the 4 ad embeddings) -> MLP -> logit; log loss plus
l2 / 2 * the squared norm of the table rows the batch touches. The
attention MLP has len(attention_layers) layers with widths taken from
deep_layers (the reference's quirk, kept). No packing, no dedup, no
kernels: slots are found with nonzero, pooled with index_add."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import common as C

TABLE = "emb"
USER_FIELDS = ("u_cat", "u_shop", "u_brand", "u_int")
KEYS = ("feat_ids", "a_catids", "a_shopids", "a_brandids", "a_intids", "label", "mask",
        *(f"{f}{s}" for f in USER_FIELDS for s in ("ids", "vals")))


def widths(cfg: Dict) -> List[int]:
    return [int(w) for w in str(cfg["deep_layers"]).split(",")]


def att_widths(cfg: Dict) -> List[int]:
    n = len(str(cfg["attention_layers"]).split(","))
    return widths(cfg)[:n]


def init_params(cfg: Dict, seed: int, device):
    """(params, model state) in the port's layout, drawn on ``device``."""
    gen = C.generator(seed, device)
    v, k, f = cfg["feature_size"], cfg["embedding_size"], cfg["field_size"]
    params = {
        "emb": C.glorot_normal(gen, (v, k), device),
        "att_mlp": C.mlp_init(gen, 3 * k, att_widths(cfg), device),
        "att_out": C.dense_init(gen, att_widths(cfg)[-1], 1, device),
        "mlp": C.mlp_init(gen, f * k + 8 * k, widths(cfg), device),
        "out": C.dense_init(gen, widths(cfg)[-1], 1, device),
    }
    state = {"att_mlp": {"layers": [{} for _ in att_widths(cfg)]},
             "mlp": {"layers": [{} for _ in widths(cfg)]}}
    return params, state


def to_device(raw: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device) for k in KEYS}


def touched(cfg: Dict):
    """Rows a batch touches: every id of its fields (dead slots carry id
    0), with row 0 always among them."""
    def rows(batch):
        ids = [batch[k].reshape(-1).long() for k in KEYS if k.endswith("ids")]
        return torch.unique(torch.cat([*ids, torch.zeros(1, dtype=torch.long, device=ids[0].device)]))
    return rows


def loss_fn(cfg: Dict, precision: str, pool_dtype=torch.float32):
    """The loss; ``pool_dtype`` is the type the attention pools are summed
    in (float64 for the witness of the checked numbers' own swing)."""
    def loss(params, batch, rows):
        emb = params[TABLE]
        b = batch["feat_ids"].shape[0]
        common = emb[batch["feat_ids"].long()]
        ads = [emb[batch[k].long()] for k in ("a_catids", "a_shopids", "a_brandids")]
        a_ids = batch["a_intids"].long()
        a_int = torch.sum(emb[a_ids] * (a_ids > 0).float()[..., None], dim=1)
        query = [*ads, a_int]
        pooled = []
        for g, f in enumerate(USER_FIELDS):
            ids, vals = batch[f"{f}ids"].long(), batch[f"{f}vals"]
            bi, ci = torch.nonzero(ids > 0, as_tuple=True)
            d = emb[ids[bi, ci]] * vals[bi, ci][:, None]
            a = query[g][bi]
            h = C.mlp(params["att_mlp"], torch.cat([d, d - a, a], dim=1), precision)
            s = torch.sigmoid(C.dense_f32(params["att_out"], h))
            pooled.append(torch.zeros((b, d.shape[1]), device=d.device, dtype=pool_dtype)
                          .index_add(0, bi, (d * s).to(pool_dtype)).float())
        x = torch.cat([common.reshape(b, -1), *pooled, *query], dim=1)
        logits = C.dense_f32(params["out"], C.mlp(params["mlp"], x, precision))[:, 0]
        l2 = cfg["l2_reg"] * 0.5 * torch.sum(torch.square(emb[rows]))
        return C.log_loss(logits, batch["label"], batch["mask"]) + l2
    return loss


def train(cfg: Dict, seed: int, raw: List[Dict], device, precision: str = "bfloat16",
          pool_dtype=torch.float32) -> Dict:
    """The reference's steps over ``raw`` from the seed's weights."""
    params, _ = init_params(cfg, seed, device)
    batches = [to_device(b, device) for b in raw]
    return C.train(params, TABLE, cfg["learning_rate"], batches, loss_fn(cfg, precision, pool_dtype),
                   touched(cfg))


def step_flops(cfg: Dict, raw: Dict[str, np.ndarray]) -> float:
    """Model FLOPs of one training step on ``raw``, forward once and
    backward twice: the towers' GEMMs for every example, the attention
    MLP's GEMMs and its elementwise work (d - a, the sigmoid, the
    weighting and the pool's add) for every live user slot, and a_int's
    masked sum for every live a_int slot; gathers count 0."""
    b = raw["feat_ids"].shape[0]
    f, k = cfg["field_size"], cfg["embedding_size"]
    tower = [f * k + 8 * k, *widths(cfg), 1]
    att = [3 * k, *att_widths(cfg), 1]
    gemm = lambda dims: sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))  # noqa: E731
    live = sum(int(np.count_nonzero(raw[f"{u}ids"])) for u in USER_FIELDS)
    live_a = int(np.count_nonzero(raw["a_intids"]))
    per_slot = gemm(att) + 3 * k + 1
    return float(3 * (b * gemm(tower) + live * per_slot + live_a * 2 * k))
