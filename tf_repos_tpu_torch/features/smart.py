"""Production CSV -> libsvm converter (the "smart" dataset with GBDT-leaf
(The port's own copy of the JAX package's features/smart.py: host code,
no torch; the same output bytes for the same input.)

features).

Behavioral parity with the reference's deep_ctr/Feature_pipeline/
get_smart_feature.py: 28 base columns (label + 10 categorical + 17 CTR
statistics) + 100 XGBoost leaf-id columns (:19-25); two passes:

  1. build_feature_map: ids 1..N; every column first gets a ``col|UNK``
     entry, then values seen in the data are added; the 17 continuous CTR
     columns (index 11..27) are keyed by COLUMN name only (:28-52).
  2. convert: continuous columns emit ``fid:value``, categorical/leaf
     columns emit ``fid:1`` with fallback to the column's UNK id (:55-89).

DEVIATION (documented): the reference's feature_map loop has two latent
bugs — it iterates ``for fname in CSV_COLUMNS`` but indexes with a stale
``i`` (:33-35, NameError on first run), and ``range(1, len(splits[1:]))``
skips the final column. Here all value columns 1..128 are processed.
"""

from __future__ import annotations

import argparse
import glob
import os
from multiprocessing.pool import ThreadPool
from typing import Dict, List, Sequence

XGB_TREES = 100
BASE_COLUMNS = [
    "is_click", "u_pl", "u_ppvn", "u_de", "u_os", "u_t", "a_m_w", "a_b_w",
    "c_h", "c_w", "c_al",
    "u_ctr", "a_a_ctr", "a_t_ctr", "c_q_ctr", "c_al_ctr", "c_n_ctr",
    "c_t_ctr", "c_t_n_ctr", "u_a_city_ctr", "u_a_age_ctr", "u_a_x_ctr",
    "u_a_g_ctr", "u_a_c_ctr", "c_q_a_ctr", "c_q_t_sim", "c_q_adtype_ctr",
    "c_mw_a_ctr",
]
CSV_COLUMNS = BASE_COLUMNS + [f"xgbf_{i}" for i in range(XGB_TREES)]
# value columns carrying raw continuous values (CTR statistics), 1-based
CONTINUOUS_RANGE = range(11, 28)


def _is_continuous(i: int) -> bool:
    return i in CONTINUOUS_RANGE


def build_feature_map(file_list: Sequence[str]) -> Dict[str, int]:
    fmap: Dict[str, int] = {}
    fid = 1
    for name in CSV_COLUMNS:
        fmap[f"{name}|UNK"] = fid
        fid += 1
    for path in file_list:
        with open(path) as f:
            for line in f:
                splits = line.strip().split(",")
                if len(splits) != len(CSV_COLUMNS):
                    continue
                for i in range(1, len(CSV_COLUMNS)):
                    key = CSV_COLUMNS[i] if _is_continuous(i) else f"{CSV_COLUMNS[i]}|{splits[i]}"
                    if key not in fmap:
                        fmap[key] = fid
                        fid += 1
    return fmap


def write_feature_map(fmap: Dict[str, int], path: str) -> None:
    with open(path, "w") as out:
        for k, v in fmap.items():
            out.write(f"{k} {v}\n")


def load_feature_map(path: str) -> Dict[str, int]:
    fmap: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) == 2:
                fmap[parts[0]] = int(parts[1])
    return fmap


def convert_file(path: str, fmap: Dict[str, int], out_path: str) -> str:
    with open(path) as f, open(out_path, "w") as out:
        for line in f:
            splits = line.strip().split(",")
            if len(splits) != len(CSV_COLUMNS):
                continue
            feats: List[str] = []
            for i in range(1, len(CSV_COLUMNS)):
                if _is_continuous(i):
                    fid = fmap.get(CSV_COLUMNS[i])
                    feats.append(f"{fid}:{splits[i]}")
                else:
                    fid = fmap.get(f"{CSV_COLUMNS[i]}|{splits[i]}")
                    if fid is None:
                        fid = fmap.get(f"{CSV_COLUMNS[i]}|UNK")
                    feats.append(f"{fid}:1")
            out.write(f"{splits[0]} {' '.join(feats)}\n")
    return out_path


def run(input_dir: str, output_dir: str, task_type: str = "tr", threads: int = 10):
    os.makedirs(output_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(input_dir, "*")))
    fmap_path = os.path.join(output_dir, "feature_map")
    if task_type == "map" or not os.path.exists(fmap_path):
        write_feature_map(build_feature_map(files), fmap_path)
        if task_type == "map":
            return [fmap_path]
    fmap = load_feature_map(fmap_path)
    jobs = [
        (p, fmap, os.path.join(output_dir, f"{task_type}_{i}.libsvm"))
        for i, p in enumerate(files)
    ]
    with ThreadPool(threads) as pool:
        return pool.starmap(convert_file, jobs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--task_type", default="tr", choices=["map", "tr", "va", "te"])
    p.add_argument("--threads", type=int, default=10)
    a = p.parse_args(argv)
    for out in run(a.input_dir, a.output_dir, a.task_type, a.threads):
        print(out)


if __name__ == "__main__":
    main()
