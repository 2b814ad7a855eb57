"""Frappe libsvm label fixer: map label -1 -> 0, threadpooled over files.
(The port's own copy of the JAX package's features/frappe.py: host code,
no torch; the same output bytes for the same input.)


Behavioral parity with the reference's deep_ctr/Feature_pipeline/
get_frape_feature.py:16-29 (each ``X.libsvm`` becomes ``X_.libsvm`` with
labels in {0,1}; malformed lines dropped).
"""

from __future__ import annotations

import argparse
import glob
import os
from multiprocessing.pool import ThreadPool
from typing import List


def fix_file(path: str) -> str:
    root, ext = os.path.splitext(path)
    out_path = f"{root}_{ext}"
    with open(path) as f, open(out_path, "w") as out:
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) != 2:
                continue
            label, feats = parts
            if label == "-1":
                label = "0"
            out.write(f"{label} {feats}\n")
    return out_path


def fix_dir(input_dir: str, threads: int = 10) -> List[str]:
    files = sorted(glob.glob(os.path.join(input_dir, "*libsvm")))
    with ThreadPool(threads) as pool:
        return pool.map(fix_file, files)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--threads", type=int, default=10)
    a = p.parse_args(argv)
    for out in fix_dir(a.input_dir, a.threads):
        print(out)


if __name__ == "__main__":
    main()
