"""Synthetic Criteo-shaped libsvm and CSV data and Ali-CCP-shaped sample
lines (the port's own copy of those parts of the JAX package's
data/synthetic.py; from the same seed the libsvm writer with zipf_a=0,
the CSV writer, and the Ali-CCP batch and line writers draw the same
numbers and give the same arrays and files).

39 fields per sample: 13 continuous fields with ids 1..13 and values in
[0,1), then 26 categorical fields with value 1.0. Labels follow a planted
logistic model so AUC is learnable. ``zipf_a > 0`` draws the categorical
ids as Zipf(zipf_a) popularity ranks over the whole id space instead of
uniform ids in per-field blocks: the frequency-sorted id distribution the
Criteo preprocessor emits, which sets how many unique rows a batch
touches on the sparse path.

Ali-CCP lines (``sample_id,y,z,field:fid:val ...``, read by
data/ragged.py) carry 11 common fields, four user multi-hot fields, three
scalar ad fields and one ad multi-hot field. ``--mh_lens published``
draws the multi-hot lengths of the published Ali-CCP regime
(PUBLISHED_MH_AVG_LENS: the largest field averages 250 ids per sample).

    python -m tf_repos_tpu_torch.data.synthetic --out_dir d [--zipf_a 1.2]
    python -m tf_repos_tpu_torch.data.synthetic --out_dir d --format csv
    python -m tf_repos_tpu_torch.data.synthetic --out_dir d --format aliccp \
        --feature_size 4500000 --mh_lens published --zipf_a 1.2
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def synthetic_criteo_batch(
    rng: np.random.Generator,
    batch_size: int,
    feature_size: int = 117_581,
    num_continuous: int = 13,
    num_categorical: int = 26,
    planted_dim: int = 8,
    zipf_a: float = 0.0,
) -> Dict[str, np.ndarray]:
    """One batch with a planted low-rank logistic structure."""
    field_size = num_continuous + num_categorical
    ids = np.zeros((batch_size, field_size), np.int32)
    vals = np.ones((batch_size, field_size), np.float32)

    ids[:, :num_continuous] = np.arange(1, num_continuous + 1)
    vals[:, :num_continuous] = rng.random((batch_size, num_continuous), dtype=np.float32)

    if zipf_a > 0.0:
        z = rng.zipf(zipf_a, size=(batch_size, num_categorical))
        ids[:, num_continuous:] = np.minimum(z, feature_size - 1)
    else:
        # the remaining id space in equal per-field vocab blocks
        cat_space = feature_size - (num_continuous + 1)
        block = max(cat_space // num_categorical, 1)
        for j in range(num_categorical):
            lo = num_continuous + 1 + j * block
            ids[:, num_continuous + j] = lo + rng.integers(0, block, size=batch_size)

    # planted ground truth: score = sum_f <e[id_f], w_f> * val_f
    plant = np.random.default_rng(0)
    emb = plant.normal(size=(1, planted_dim)).astype(np.float32)
    proj = plant.normal(size=(field_size, planted_dim)).astype(np.float32)
    id_emb = np.sin(ids[..., None] * 0.37 + np.arange(planted_dim) * 1.7).astype(np.float32)
    score = np.einsum("bfd,fd->bf", id_emb, proj * emb) * vals
    logit = score.sum(-1) * 0.5
    prob = 1.0 / (1.0 + np.exp(-logit))
    label = (rng.random(batch_size) < prob).astype(np.float32)
    return {
        "feat_ids": ids,
        "feat_vals": vals,
        "label": label,
        "mask": np.ones((batch_size,), np.float32),
    }


def _fmt_val(v: float) -> str:
    return f"{v:.6f}".rstrip("0").rstrip(".") if v != 1.0 else "1"


def write_synthetic_libsvm(
    path: str,
    num_samples: int,
    feature_size: int = 117_581,
    seed: int = 0,
    zipf_a: float = 0.0,
) -> Tuple[int, int]:
    """Write a synthetic libsvm file; returns (feature_size, field_size)."""
    rng = np.random.default_rng(seed)
    batch = synthetic_criteo_batch(rng, num_samples, feature_size, zipf_a=zipf_a)
    ids = batch["feat_ids"].tolist()
    vals = batch["feat_vals"].tolist()
    labels = batch["label"].astype(np.int64).tolist()
    with open(path, "w") as f:
        for i in range(num_samples):
            parts = [str(labels[i])]
            parts += [f"{fid}:{_fmt_val(v)}" for fid, v in zip(ids[i], vals[i])]
            f.write(" ".join(parts) + "\n")
    return feature_size, len(ids[0]) if ids else 0


def write_synthetic_csv(path: str, num_samples: int, cat_buckets: int = 100, seed: int = 0) -> None:
    """Criteo CSV lines for Wide&Deep (data/csv.py): label, 13 numeric
    columns in [0, 1) with four decimals, 26 categorical ids in
    [0, cat_buckets). A scalar draw at a time, in the JAX writer's order,
    so the same seed writes the same bytes."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(num_samples):
            label = int(rng.random() < 0.5)
            ints = [f"{rng.random():.4f}" for _ in range(13)]
            cats = [str(int(rng.integers(0, cat_buckets))) for _ in range(26)]
            f.write(",".join([str(label)] + ints + cats) + "\n")


# The published Ali-CCP multi-hot length point: the largest user-behaviour
# field (110_14, shop/item history) averages 250 ids per sample. The other
# fields' means are not published; these keep 110_14 dominant. The u_shop
# draw mean is 254 so that the mean after the 2048 tail clip is ~250.
PUBLISHED_MH_AVG_LENS: Dict[str, float] = {
    "u_cat": 30.0,
    "u_shop": 254.0,
    "u_brand": 40.0,
    "u_int": 10.0,
    "a_int": 5.0,
}

# file-format field tag -> batch field prefix (data/ragged.py schema)
_MH_TAG_TO_PREFIX = {
    "109_14": "u_cat", "110_14": "u_shop", "127_14": "u_brand",
    "150_14": "u_int", "210": "a_int",
}


def _lognormal_lengths(
    rng: np.random.Generator, mean: float, sigma: float, size, cap: int
) -> np.ndarray:
    """Long-tailed per-row multi-hot lengths with the requested mean
    (before clipping to [1, cap]): lognormal(mu, sigma) with
    mu = ln(mean) - sigma^2/2."""
    mu = np.log(max(mean, 1.0)) - sigma * sigma / 2.0
    ln = rng.lognormal(mu, sigma, size=size)
    return np.clip(np.rint(ln), 1, max(cap, 1)).astype(np.int64)


def synthetic_aliccp_batch(
    rng: np.random.Generator,
    batch_size: int,
    feature_size: int,
    multi_hot_pad: int = 64,
    avg_lens: Optional[Dict[str, float]] = None,
    zipf_a: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Ali-CCP-shaped padded batch (layout of data/ragged.py): 11 common
    fields, 4 user multi-hot id/val fields, 3 scalar ad fields, 1 ad
    multi-hot field, labels y (click) and z (conversion, only when y=1).
    avg_lens: per-field mean lengths (see PUBLISHED_MH_AVG_LENS), drawn
    lognormal (sigma 1) and clipped at the pad; None draws uniform
    lengths, 1..8 for the user fields and 1..4 for a_int. zipf_a > 0
    draws ids as Zipf popularity ranks."""
    b, p = batch_size, multi_hot_pad
    hi = max(feature_size - 1, 2)

    def draw_ids(size):
        if zipf_a <= 0.0:
            return rng.integers(1, hi, size=size).astype(np.int32)
        z = rng.zipf(zipf_a, size=size)
        return (1 + np.minimum(z - 1, hi - 2)).astype(np.int32)

    def draw_lens(field, light_cap):
        if avg_lens is None:
            return rng.integers(1, min(light_cap, p) + 1, size=(b, 1))
        return _lognormal_lengths(rng, avg_lens[field], 1.0, (b, 1), p)

    out: Dict[str, np.ndarray] = {
        "feat_ids": draw_ids((b, 11)),
        "a_catids": draw_ids((b,)),
        "a_shopids": draw_ids((b,)),
        "a_brandids": draw_ids((b,)),
        "mask": np.ones((b,), np.float32),
    }
    for f in ("u_cat", "u_shop", "u_brand", "u_int"):
        ids = draw_ids((b, p))
        keep = np.arange(p)[None, :] < draw_lens(f, 8)
        out[f"{f}ids"] = np.where(keep, ids, 0).astype(np.int32)
        out[f"{f}vals"] = keep.astype(np.float32)
    a_ids = draw_ids((b, p))
    a_keep = np.arange(p)[None, :] < draw_lens("a_int", 4)
    out["a_intids"] = np.where(a_keep, a_ids, 0).astype(np.int32)
    y = (rng.random(b) < 0.5).astype(np.float32)
    z = ((rng.random(b) < 0.3) & (y > 0)).astype(np.float32)
    out["y"], out["z"], out["label"] = y, z, y
    return out


def write_synthetic_aliccp(
    path: str,
    num_samples: int,
    feature_size: int = 5000,
    multi_hot: int = 4,
    seed: int = 0,
    zipf_a: float = 0.0,
    mh_avg_lens: Optional[Dict[str, float]] = None,
) -> None:
    """Ali-CCP sample lines ``sample_id,y,z,field:fid:val ...`` with
    labels y ~ Bernoulli(0.5) and z ~ y * Bernoulli(0.3) (z=1 only when
    y=1). zipf_a > 0 draws ids as Zipf(zipf_a) popularity ranks
    (id = rank + 19). mh_avg_lens maps field prefixes to mean multi-hot
    lengths, drawn lognormal (sigma 1) and clipped to [1, 2048]; the file
    carries every drawn id (truncation is the reader's multi_hot_pad).
    None keeps the uniform 1..multi_hot draw."""
    rng = np.random.default_rng(seed)
    hi = max(feature_size - 1, 21)

    def draw_ids(size):
        if zipf_a <= 0.0:
            return rng.integers(20, hi, size=size)
        z = rng.zipf(zipf_a, size=size)
        return 20 + np.minimum(z - 1, hi - 21)

    common_fields = ["101", "121", "122", "124", "125", "126", "127", "128", "129", "205", "301"]
    ad_fields = ("206", "207", "216")
    mh_fields = ("109_14", "110_14", "127_14", "150_14", "210")
    n_single = len(common_fields) + len(ad_fields)
    # heavy lengths: smaller chunks (per-field arrays are up to n x 2048)
    chunk_rows = 200_000
    if mh_avg_lens is not None:
        chunk_rows = max(2_000, int(2e6 / max(sum(mh_avg_lens.values()), 1.0)))
    with open(path, "w") as f:
        for chunk_lo in range(0, num_samples, chunk_rows):
            n = min(chunk_rows, num_samples - chunk_lo)
            singles = draw_ids((n, n_single))
            if mh_avg_lens is None:
                mh_cnt = rng.integers(1, multi_hot + 1, size=(n, len(mh_fields)))
                mh_ids = draw_ids((n, len(mh_fields), multi_hot))
                cnt_pf = [mh_cnt[:, j] for j in range(len(mh_fields))]
                ids_pf = [mh_ids[:, j, :] for j in range(len(mh_fields))]
            else:
                cnt_pf, ids_pf = [], []
                for mh in mh_fields:
                    mean = mh_avg_lens[_MH_TAG_TO_PREFIX[mh]]
                    c = _lognormal_lengths(rng, mean, 1.0, (n,), 2048)
                    cnt_pf.append(c)
                    ids_pf.append(draw_ids((n, int(c.max()))))
            y = (rng.random(n) < 0.5).astype(np.int64)
            z = y * (rng.random(n) < 0.3).astype(np.int64)
            # formatting Python ints is ~5x faster than np.int64 scalars
            singles_l = singles.tolist()
            ids_l = [a.tolist() for a in ids_pf]
            cnt_l = [c.tolist() for c in cnt_pf]
            y_l, z_l = y.tolist(), z.tolist()
            nc = len(common_fields)
            for r in range(n):
                srow = singles_l[r]
                feats = [f"{c}:{v}:1.0" for c, v in zip(common_fields, srow)]
                for j, mh in enumerate(mh_fields):
                    feats += [f"{mh}:{v}:1.0" for v in ids_l[j][r][: cnt_l[j][r]]]
                feats += [f"{c}:{v}:1.0" for c, v in zip(ad_fields, srow[nc:])]
                f.write(f"s{chunk_lo + r},{y_l[r]},{z_l[r]},{' '.join(feats)}\n")


def main(argv=None):
    """CLI: synthetic tr/va/te files (libsvm, csv or Ali-CCP lines) for smoke runs."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--format", default="libsvm", choices=["libsvm", "csv", "aliccp"])
    p.add_argument("--feature_size", type=int, default=117_581)
    p.add_argument("--train", type=int, default=2000)
    p.add_argument("--valid", type=int, default=500)
    p.add_argument("--test", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zipf_a", type=float, default=0.0,
                   help="id skew (0: uniform ids; libsvm: per-field blocks)")
    p.add_argument("--mh_lens", default="legacy", choices=["legacy", "published"],
                   help="aliccp multi-hot lengths: 'published' = largest field "
                        "averages 250 ids per sample, lognormal tail")
    a = p.parse_args(argv)
    os.makedirs(a.out_dir, exist_ok=True)
    sizes = {"tr": a.train, "va": a.valid, "te": a.test}
    for i, (split, n) in enumerate(sizes.items()):
        if a.format == "libsvm":
            path = os.path.join(a.out_dir, f"{split}.libsvm")
            write_synthetic_libsvm(path, n, a.feature_size, seed=a.seed + i, zipf_a=a.zipf_a)
        elif a.format == "csv":
            path = os.path.join(a.out_dir, f"{split}.csv")
            write_synthetic_csv(path, n, seed=a.seed + i)
        else:
            path = os.path.join(a.out_dir, f"{split}.samples.txt")
            write_synthetic_aliccp(
                path, n, a.feature_size, seed=a.seed + i, zipf_a=a.zipf_a,
                mh_avg_lens=PUBLISHED_MH_AVG_LENS if a.mh_lens == "published" else None,
            )
        print(path)


if __name__ == "__main__":
    main()
