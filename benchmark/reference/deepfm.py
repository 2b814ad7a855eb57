"""Plain DeepFM (Guo et al. 2017; the reference's deep_ctr DeepFM.py):
logit = b + sum_f w[id_f] val_f + FM second order (sum-square trick) +
MLP over the concatenated scaled embeddings; log loss over the batch
plus l2 / 2 * the squared norm of the table rows the batch touches. One
[V, 1 + K] table: column 0 is the first-order weight, columns 1..K the
embedding. No dedup, no row kernels: the gather and its gradient are
plain indexing on the whole table."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import common as C

TABLE = "fm_wv"


def widths(cfg: Dict) -> List[int]:
    return [int(w) for w in str(cfg["deep_layers"]).split(",")]


def init_params(cfg: Dict, seed: int, device):
    """(params, model state) in the port's layout, drawn on ``device``."""
    gen = C.generator(seed, device)
    v, k, f = cfg["feature_size"], cfg["embedding_size"], cfg["field_size"]
    table = torch.cat([C.glorot_normal(gen, (v,), device)[:, None],
                       C.glorot_normal(gen, (v, k), device)], dim=1)
    params = {
        "fm_b": torch.zeros(1, device=device),
        "fm_wv": table,
        "mlp": C.mlp_init(gen, f * k, widths(cfg), device),
        "out": C.dense_init(gen, widths(cfg)[-1], 1, device),
    }
    return params, {"mlp": {"layers": [{} for _ in widths(cfg)]}}


def to_device(raw: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
            for k in ("feat_ids", "feat_vals", "label", "mask")}


def touched(cfg: Dict):
    """Rows a batch touches: its ids, with row 0 and the static ids
    1..static always among them."""
    def rows(batch):
        seed_rows = torch.arange(cfg.get("static_fields", 0) + 1, device=batch["feat_ids"].device)
        return torch.unique(torch.cat([batch["feat_ids"].reshape(-1).long(), seed_rows]))
    return rows


def loss_fn(cfg: Dict, precision: str):
    def loss(params, batch, rows):
        ids, vals = batch["feat_ids"].long(), batch["feat_vals"]
        r = params[TABLE][ids]  # [B, F, 1+K]
        y_w = torch.sum(r[..., 0] * vals, dim=1)
        emb = r[..., 1:] * vals[..., None]
        y_v = 0.5 * torch.sum(torch.square(emb.sum(1)) - torch.square(emb).sum(1), dim=1)
        h = C.mlp(params["mlp"], emb.reshape(emb.shape[0], -1), precision)
        y_d = C.dense_f32(params["out"], h)[:, 0]
        logits = params["fm_b"][0] + y_w + y_v + y_d
        l2 = cfg["l2_reg"] * 0.5 * torch.sum(torch.square(params[TABLE][rows]))
        return C.log_loss(logits, batch["label"], batch["mask"]) + l2
    return loss


def train(cfg: Dict, seed: int, raw: List[Dict], device, precision: str = "bfloat16") -> Dict:
    """The reference's steps over ``raw`` from the seed's weights."""
    params, _ = init_params(cfg, seed, device)
    batches = [to_device(b, device) for b in raw]
    return C.train(params, TABLE, cfg["learning_rate"], batches, loss_fn(cfg, precision), touched(cfg))


def step_flops(cfg: Dict, raw: Dict[str, np.ndarray]) -> float:
    """Model FLOPs of one training step on ``raw``: the towers' GEMMs
    (bf16 layers and the f32 output layer) and the FM terms, forward
    once and backward twice (the input's and the weights' gradients);
    gathers and scatters count 0."""
    b = raw["feat_ids"].shape[0]
    f, k = cfg["field_size"], cfg["embedding_size"]
    dims = [f * k, *widths(cfg), 1]
    gemm = sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
    # first order: f products and f adds; second order: f*k scalings, f*k
    # adds over fields, k squares of the sum, f*k squares, f*k adds, k
    # differences and k adds
    fm = 2 * f + 4 * f * k + 3 * k
    return float(3 * b * (gemm + fm))
