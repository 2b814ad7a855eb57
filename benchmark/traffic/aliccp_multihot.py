"""Ali-CCP-shaped DIN batches: the benchmark's frozen copy of
``synthetic_aliccp_batch`` (tf_repos_tpu_torch/data/synthetic.py), in the
padded layout of tf_repos_tpu_torch/data/ragged.py: 11 common fields,
four user multi-hot fields (u_cat, u_shop, u_brand, u_int) with values
1.0 on the live slots, three scalar ad fields, the ad multi-hot field
a_int, labels y (click) and z (conversion, only where y = 1). The mix
file gives each multi-hot field's mean length (``mean_lens``).

Three departures from the original:

- A field's lengths are lognormal(sigma) rounded and clipped to
  [1, multi_hot_pad], with the draw's mean solved so that the mean
  after the clip is the mix's mean (the original states the mean before
  its clip, and a pad cuts the tail: u_shop's 250 would average ~204 at
  a pad of 512).
- Lengths come from a generator seeded by ``shape_seed + index``, not by
  the run's seed, which only permutes the rows. So every seed sends the
  same multiset of lengths in each batch of the pool, in another order,
  and the packed slot count (the attention's work) is the same on every
  seed.
- Ids are drawn for the live slots only (the original draws a whole
  [B, pad] array and masks it): the same Zipf(a) ranks, clipped to
  [1, vocab - 2], at a seventh of the cost."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

USER_FIELDS = ("u_cat", "u_shop", "u_brand", "u_int")


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def clipped_mean(mu: float, sigma: float, cap: float) -> float:
    """E[clip(X, 1, cap)] for X = lognormal(mu, sigma)."""
    lo, hi, s2 = 0.0, math.log(cap), sigma * sigma
    inside = math.exp(mu + s2 / 2.0) * (_phi((hi - mu - s2) / sigma) - _phi((lo - mu - s2) / sigma))
    return _phi((lo - mu) / sigma) + inside + cap * (1.0 - _phi((hi - mu) / sigma))


def draw_mu(mean: float, sigma: float, cap: int) -> float:
    """The lognormal's mu whose draws, clipped to [1, cap], average
    ``mean`` (bisection; the clipped mean rises with mu)."""
    if not 1.0 <= mean < cap:
        raise ValueError(f"a mean length of {mean} cannot be reached in [1, {cap}]")
    lo, hi = -20.0, math.log(cap) + 20.0
    for _ in range(100):
        mid = (lo + hi) / 2.0
        lo, hi = (mid, hi) if clipped_mean(mid, sigma, cap) < mean else (lo, mid)
    return (lo + hi) / 2.0


def make_batches(seed: int, params: Dict, vocab: int, count: int, device=None) -> List[Dict[str, np.ndarray]]:
    """``count`` batches from the seed (on the host: the ids are Zipf
    draws, which torch has no sampler for)."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    b, p = int(params["batch_size"]), int(params["multi_hot_pad"])
    sigma = float(params["len_sigma"])
    mus = {f: draw_mu(float(m), sigma, p) for f, m in params["mean_lens"].items()}
    return [_batch(rng, params, vocab, i, mus) for i in range(count)]


def _batch(rng: np.random.Generator, params: Dict, vocab: int, index: int, mus: Dict) -> Dict[str, np.ndarray]:
    b, p = int(params["batch_size"]), int(params["multi_hot_pad"])
    a, sigma = float(params["zipf_a"]), float(params["len_sigma"])
    hi = max(vocab - 1, 2)
    shape_rng = np.random.default_rng(int(params["shape_seed"]) + index)
    lens = {f: np.clip(np.rint(shape_rng.lognormal(mus[f], sigma, size=b)), 1, p).astype(np.int64)
            for f in (*USER_FIELDS, "a_int")}
    order = rng.permutation(b)

    def draw_ids(size):
        z = rng.zipf(a, size=size)
        return (1 + np.minimum(z - 1, hi - 2)).astype(np.int32)

    def padded(n):
        keep = np.arange(p)[None, :] < n[order][:, None]
        ids = np.zeros((b, p), np.int32)
        ids[keep] = draw_ids(int(keep.sum()))
        return ids, keep

    out: Dict[str, np.ndarray] = {
        "feat_ids": draw_ids((b, 11)),
        "a_catids": draw_ids((b,)),
        "a_shopids": draw_ids((b,)),
        "a_brandids": draw_ids((b,)),
        "mask": np.ones((b,), np.float32),
    }
    for f in USER_FIELDS:
        ids, keep = padded(lens[f])
        out[f"{f}ids"] = ids
        out[f"{f}vals"] = keep.astype(np.float32)
    out["a_intids"], _ = padded(lens["a_int"])
    y = (rng.random(b) < 0.5).astype(np.float32)
    z = ((rng.random(b) < 0.3) & (y > 0)).astype(np.float32)
    out["y"], out["z"], out["label"] = y, z, y
    return out
