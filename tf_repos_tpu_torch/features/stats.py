"""Feature statistics tools for libsvm / aliccp sample files.
(The port's own copy of the JAX package's features/stats.py: host code,
no torch; the same output bytes for the same input.)


Parity with the reference's local stats utilities
(the reference's deep_ctr/Feature_pipeline/get_feat_cnts.py — frequency
histograms — and DeepMTL/Feature_pipeline/get_ai_fmap.py, whose body
references undefined variables and is dead code; the intended behavior,
feature-map coverage stats, is implemented working here).
"""

from __future__ import annotations

import argparse
import collections
import glob
from typing import Dict, Iterable, Tuple


def feat_counts_libsvm(lines: Iterable[str]) -> Dict[int, int]:
    """feat_id -> occurrence count over libsvm lines."""
    cnts: Dict[int, int] = collections.defaultdict(int)
    for line in lines:
        parts = line.strip().split(" ")
        for tok in parts[1:]:
            if ":" in tok:
                cnts[int(tok.split(":", 1)[0])] += 1
    return dict(cnts)


def feat_counts_aliccp(lines: Iterable[str]) -> Dict[str, int]:
    """'field:fid' -> count over joined sample lines (stat_map semantics)."""
    cnts: Dict[str, int] = collections.defaultdict(int)
    for line in lines:
        splits = line.strip().split(",")
        if len(splits) < 4:
            continue
        for tok in splits[3].split(" "):
            if tok.count(":") == 2:
                f, fid, _ = tok.split(":")
                cnts[f"{f}:{fid}"] += 1
    return dict(cnts)


def histogram(cnts: Dict, buckets=(1, 2, 5, 10, 20, 50, 100, 1000)) -> Dict[str, int]:
    """How many distinct features fall in each occurrence bucket — the
    long-tail profile that motivates the cutoff filters (cutoff 200 for
    Criteo, 20 for Ali-CCP)."""
    hist: Dict[str, int] = collections.OrderedDict()
    edges = list(buckets) + [float("inf")]
    labels = [f"<{b}" for b in buckets] + [f">={buckets[-1]}"]
    for lbl in labels:
        hist[lbl] = 0
    for c in cnts.values():
        for lbl, hi in zip(labels, edges):
            if c < hi:
                hist[lbl] += 1
                break
        else:
            hist[labels[-1]] += 1
    return hist


def summarize(cnts: Dict) -> Dict[str, float]:
    n = len(cnts)
    total = sum(cnts.values())
    return {
        "distinct_features": n,
        "total_occurrences": total,
        "mean_occurrences": total / max(n, 1),
        "max_feature_id": max(
            (int(str(k).rsplit(":", 1)[-1]) for k in cnts), default=0
        ),
    }


def main(argv=None) -> Tuple[Dict, Dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_glob", required=True)
    p.add_argument("--format", default="libsvm", choices=["libsvm", "aliccp"])
    a = p.parse_args(argv)

    def lines():
        for path in sorted(glob.glob(a.input_glob)):
            with open(path) as f:
                yield from f

    cnts = (
        feat_counts_libsvm(lines()) if a.format == "libsvm" else feat_counts_aliccp(lines())
    )
    summary = summarize(cnts)
    hist = histogram(cnts)
    for k, v in summary.items():
        print(f"{k} {v}")
    for k, v in hist.items():
        print(f"occurrences {k}: {v} features")
    return summary, hist


if __name__ == "__main__":
    main()
