"""Criteo-shaped DeepFM batches, drawn on the device: rows as the reference
preprocessing (tf_repos_tpu_torch/features/criteo.py) emits them for
the port's statistics-faithful Criteo surrogate
(tf_repos_tpu_torch/data/criteo_surrogate.py), whose per-field laws the
mix file holds as a frozen copy.

Each row has 39 (id, value) slots:

- 13 continuous fields with the static ids 1..13 and the value
  round(u * clip) / clip, u = U(0, 1) ** skew (the surrogate's
  ``_draw_cont``);
- 26 categorical fields with value 1.0. Field f draws a frequency rank r
  from Zipf(s_f) over 1..raw_vocab_f (the surrogate's law, solved there
  so that a 45,840,617-line run at cutoff 200 keeps ``kept_f`` ids).
  Ranks past ``kept_f`` fall under the cutoff and become the field's
  ``<unk>`` (dictionary id 0). The row's id is offset_f + the dictionary
  id, the offsets starting at 13 and each field taking kept_f + 1 ids,
  so the id space is 13 + sum(kept_f + 1) = 117,581 at the published
  point.

Labels are Bernoulli(ctr), the surrogate's CTR: they set no shape and
no cost. Every seed gives every batch the same shapes."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

NUM_CONTINUOUS = 13
SEED_SALT = 0x7AFF1C  # keeps the traffic's stream apart from the weights'


def feature_size(params: Dict) -> int:
    return NUM_CONTINUOUS + sum(int(f["kept"]) + 1 for f in params["fields"])


def make_batches(seed: int, params: Dict, vocab: int, count: int, device) -> List[Dict[str, np.ndarray]]:
    """``count`` batches from the seed, on ``device``, returned as host
    arrays (the port's host chain maps them)."""
    if vocab != feature_size(params):
        raise ValueError(f"the mix's fields make {feature_size(params)} ids, the config {vocab}")
    b = int(params["batch_size"])
    fields = params["fields"]
    gen = torch.Generator(device=device).manual_seed((int(seed) % (1 << 63)) ^ SEED_SALT)
    cdfs, offsets, off = [], [], NUM_CONTINUOUS
    for f in fields:
        w = torch.arange(1, int(f["raw_vocab"]) + 1, dtype=torch.float64, device=device) ** -float(f["zipf_s"])
        cdfs.append(torch.cumsum(w / w.sum(), 0))
        offsets.append(off)
        off += int(f["kept"]) + 1
    kept = torch.tensor([int(f["kept"]) for f in fields], device=device)
    offsets = torch.tensor(offsets, device=device)
    clip = torch.tensor([float(c) for c in params["continuous_clip"]], device=device)
    out = []
    for _ in range(count):
        u = torch.rand((len(fields), b), generator=gen, dtype=torch.float64, device=device)
        ranks = torch.stack([torch.searchsorted(c, x, right=True) for c, x in zip(cdfs, u)], 1) + 1
        dict_id = torch.where(ranks <= kept, ranks, torch.zeros_like(ranks))
        cont = torch.rand((b, NUM_CONTINUOUS), generator=gen, device=device) ** float(params["continuous_skew"])
        ids = torch.cat([torch.arange(1, NUM_CONTINUOUS + 1, device=device).expand(b, -1),
                         dict_id + offsets], 1).to(torch.int32)
        vals = torch.cat([torch.round(cont * clip) / clip,
                          torch.ones((b, len(fields)), device=device)], 1)
        label = (torch.rand(b, generator=gen, device=device) < float(params["ctr"])).float()
        out.append({"feat_ids": ids.cpu().numpy(), "feat_vals": vals.cpu().numpy(),
                    "label": label.cpu().numpy(), "mask": np.ones((b,), np.float32)})
    return out
