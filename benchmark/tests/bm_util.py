"""Helpers of the benchmark's tests: tiny cells beside the real ones
(the real cells' models and flags at small widths, for the CPU)."""

from __future__ import annotations

import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the Criteo mix at a small id space: 26 fields of 40 kept ids each
TINY_FIELDS = [{"kept": 40, "raw_vocab": 120, "zipf_s": 1.2}] * 26

# the real cells at small sizes: widths and batch cut, every flag kept
TINY = {
    "deepfm.train.b128k": ({"feature_size": 13 + 26 * 41, "embedding_size": 4, "deep_layers": "16,8,4"},
                           {"batch_size": 512, "pool": 4, "fields": TINY_FIELDS}),
    "din.train.aliccp": ({"feature_size": 20000, "embedding_size": 4, "deep_layers": "32,32",
                          "attention_layers": "16"},
                         {"batch_size": 64, "pool": 4, "multi_hot_pad": 128,
                          "mean_lens": {"u_cat": 8, "u_shop": 40, "u_brand": 10, "u_int": 3, "a_int": 2}}),
}


def tiny_cell(name: str, limits=None):
    """The real cell ``name`` at its tiny size, as a spec.Cell."""
    from benchmark import spec

    cell = spec.load_cell(name)
    over_c, over_t = TINY[name]
    return spec.Cell(name=name + ".tiny", config=dict(cell.config, **over_c),
                     traffic=dict(cell.traffic, **over_t), chips=1,
                     limits=cell.limits if limits is None else limits)


def write_json(path, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
