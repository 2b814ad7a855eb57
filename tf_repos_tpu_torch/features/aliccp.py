"""Ali-CCP feature pipeline: join -> stat -> remap -> sample lines.
(The port's own copy of the JAX package's features/aliccp.py: host code,
no torch; the same output bytes for the same input.)


Portable re-implementation of the reference's Hadoop-streaming jobs
(the reference's DeepMTL/Feature_pipeline/): the mapper/reducer pairs are
pure functions over line iterators, so the same code runs locally
(multiprocessing over file shards) or under any streaming-MR runner.

Stages (matching the reference's scripts):
  1. join:   raw Ali-CCP is two tables — sample skeleton
             ``sample_id,y,z,common_feature_index,feat_num,feat_list`` and
             common features ``common_feature_index,feat_num,feat_list``
             with feat_list ``field\\x02feat\\x03val`` joined by \\x01.
             join_map normalizes both to ``key\\ttype\\tpayload`` and drops
             illegal y=0∧z=1 rows (get_join_mapper.py:30-31); join_reduce
             attaches each key's common features to its samples
             (get_join_reducer.py:13-33). Output sample lines:
             ``sample_id,y,z,field:feat:val field:feat:val ...``
  2. stat:   word-count over ``field:feat`` occurrences
             (get_stat_mapper.py:14-20, get_stat_reducer.py).
  3. remap:  keep feat_ids with count >= cutoff(20), densely renumber from
             20 (ids 0..19 reserved for padding + per-field defaults, see
             data/ragged.py), drop y=0∧z=1 again, emit with a random sort
             key for a global shuffle (get_remap_mapper.py:10-42).

The final sample lines are consumed directly by data/ragged.AliccpDataset
(the TPU-native replacement for get_aliccp_tfrecord.py's VarLen TFRecords:
static-shape padded arrays instead of sparse tensors).
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import random
from multiprocessing.pool import ThreadPool
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

CUTOFF = 20
REMAP_BASE = 20  # first remapped id (get_remap_mapper.py:10)


# ------------------------------------------------------------------- join
def _parse_feat_list(feat_strs: str) -> List[str]:
    out = []
    for fstr in feat_strs.split("\x01"):
        if not fstr:
            continue
        try:
            field, feat_val = fstr.split("\x02")
            feat, val = feat_val.split("\x03")
        except ValueError:
            continue
        out.append(f"{field}:{feat}:{val}")
    return out


def join_map(lines: Iterable[str]) -> Iterator[str]:
    """Normalize skeleton/common rows to ``key\\ttype\\tpayload``."""
    for line in lines:
        splits = line.strip().split(",")
        if len(splits) == 3:  # common_feature_index|feat_num|feat_list
            feats = _parse_feat_list(splits[2])
            yield f"{splits[0]}\tcommon\t{' '.join(feats)}"
        elif len(splits) == 6:  # sample_id|y|z|common_feature_index|feat_num|feat_list
            if splits[1] == "0" and splits[2] == "1":
                continue  # illegal click=0 & conversion=1
            feats = _parse_feat_list(splits[5])
            yield (
                f"{splits[3]}\tsample\t{splits[0]},{splits[1]},{splits[2]},"
                f"{' '.join(feats)}"
            )


def join_reduce(lines: Iterable[str]) -> Iterator[str]:
    """Group by key; emit each sample with its common features appended."""
    common: Dict[str, str] = {}
    samples: List[Tuple[str, str]] = []
    for line in lines:
        try:
            key, log_type, payload = line.rstrip("\n").split("\t")
        except ValueError:
            continue
        if log_type == "sample":
            samples.append((key, payload))
        elif log_type == "common":
            common[key] = payload
    for key, payload in samples:
        c = common.get(key)
        yield f"{payload} {c}" if c else payload


# ------------------------------------------------------------------- stat
def stat_map(sample_lines: Iterable[str]) -> Iterator[str]:
    cnts: Dict[str, int] = collections.defaultdict(int)
    for line in sample_lines:
        splits = line.strip().split(",")
        if len(splits) < 4:
            continue
        for fstr in splits[3].split(" "):
            if ":" not in fstr:
                continue
            feat, _ = fstr.rsplit(":", 1)
            cnts[feat] += 1
    for key, val in cnts.items():
        yield f"{key}\t{val}"


def stat_reduce(count_lines: Iterable[str]) -> Iterator[str]:
    cnts: Dict[str, int] = collections.defaultdict(int)
    for line in count_lines:
        try:
            key, val = line.strip().split("\t")
            cnts[key] += int(val)
        except ValueError:
            continue
    for key, val in cnts.items():
        yield f"{key}\t{val}"


# ------------------------------------------------------------------ remap
def load_remap(count_lines: Iterable[str], cutoff: int = CUTOFF) -> Dict[str, int]:
    """feat_id -> dense new id (>= REMAP_BASE) for ids with count >= cutoff.
    Keys are the RAW feat ids (the part after ``field:``),
    get_remap_mapper.py:14-21."""
    remap: Dict[str, int] = {}
    new_id = REMAP_BASE
    for line in count_lines:
        try:
            key, cnts = line.strip().split("\t")
        except ValueError:
            continue
        fid = key.rsplit(":", 1)[1] if ":" in key else key
        if fid in remap:
            continue
        if int(cnts) >= cutoff:
            remap[fid] = new_id
            new_id += 1
    return remap


def remap_map(
    sample_lines: Iterable[str],
    remap: Dict[str, int],
    rng: random.Random,
) -> Iterator[str]:
    """Apply the id remap; emit ``sort_key\\tsample`` for global shuffle."""
    for line in sample_lines:
        splits = line.strip().split(",")
        if len(splits) < 4:
            continue
        if splits[1] == "0" and splits[2] == "1":
            continue
        feats = []
        for fstr in splits[3].split(" "):
            parts = fstr.split(":")
            if len(parts) != 3:
                continue
            f, fid, val = parts
            new_id = remap.get(fid)
            if new_id:
                feats.append(f"{f}:{new_id}:{val}")
        ri = rng.randint(0, 2147483647)
        yield f"{ri}\t{splits[0]},{splits[1]},{splits[2]},{' '.join(feats)}"


def shuffle_reduce(keyed_lines: Iterable[str]) -> Iterator[str]:
    """Sort by the random key and strip it (the MR identity-reducer-with-
    sort analog, get_remap_fid.sh)."""
    rows = []
    for line in keyed_lines:
        try:
            key, payload = line.rstrip("\n").split("\t", 1)
            rows.append((int(key), payload))
        except ValueError:
            continue
    rows.sort()
    for _, payload in rows:
        yield payload


# ---------------------------------------------------------- local pipeline
def _read_lines(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        with open(p) as f:
            yield from f


def run_pipeline(
    skeleton_glob: str,
    common_glob: str,
    output_dir: str,
    cutoff: int = CUTOFF,
    seed: int = 0,
    threads: int = 8,
) -> Dict[str, int]:
    """Local end-to-end run: join + stat + remap + shuffle.

    Returns {"num_samples": N, "num_features": V} where V counts remapped
    ids (feature_size for training = REMAP_BASE + V)."""
    os.makedirs(output_dir, exist_ok=True)
    skel = sorted(glob.glob(skeleton_glob))
    comm = sorted(glob.glob(common_glob))

    with ThreadPool(threads) as pool:
        mapped_chunks = pool.map(
            lambda p: list(join_map(_read_lines([p]))), skel + comm
        )
    joined = list(join_reduce(line for chunk in mapped_chunks for line in chunk))

    counts = list(stat_reduce(stat_map(joined)))
    with open(os.path.join(output_dir, "feat_cnts"), "w") as f:
        f.write("\n".join(counts) + ("\n" if counts else ""))

    remap = load_remap(counts, cutoff)
    rng = random.Random(seed)
    shuffled = list(shuffle_reduce(remap_map(joined, remap, rng)))
    out_path = os.path.join(output_dir, "samples.txt")
    with open(out_path, "w") as f:
        f.write("\n".join(shuffled) + ("\n" if shuffled else ""))

    return {"num_samples": len(shuffled), "num_features": len(remap)}


def main(argv=None):
    """Two modes:

    local pipeline:  --skeleton_glob ... --common_glob ... --output_dir ...
    streaming stage: --mode {join_map,join_reduce,stat_map,stat_reduce,
                     remap_map,shuffle_reduce} reads stdin, writes stdout —
                     drop-in for the reference's Hadoop-streaming jobs
                     (get_join_sample.sh / get_stat_feat.sh /
                     get_remap_fid.sh mapper/reducer slots).
                     remap_map needs --feat_cnts_file (the distributed-
                     cache file of get_remap_fid.sh:27).
    """
    import sys

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="pipeline")
    p.add_argument("--skeleton_glob")
    p.add_argument("--common_glob")
    p.add_argument("--output_dir")
    p.add_argument("--feat_cnts_file")
    p.add_argument("--cutoff", type=int, default=CUTOFF)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=8)
    a = p.parse_args(argv)

    if a.mode != "pipeline":
        stages = {
            "join_map": join_map,
            "join_reduce": join_reduce,
            "stat_map": stat_map,
            "stat_reduce": stat_reduce,
            "shuffle_reduce": shuffle_reduce,
        }
        if a.mode == "remap_map":
            remap = load_remap(open(a.feat_cnts_file), a.cutoff)
            out = remap_map(sys.stdin, remap, random.Random(a.seed))
        elif a.mode in stages:
            out = stages[a.mode](sys.stdin)
        else:
            p.error(f"unknown --mode {a.mode}")
        for line in out:
            sys.stdout.write(line + "\n")
        return

    info = run_pipeline(
        a.skeleton_glob, a.common_glob, a.output_dir, a.cutoff, a.seed, a.threads
    )
    print(
        f"num_samples {info['num_samples']} num_features {info['num_features']} "
        f"feature_size {REMAP_BASE + info['num_features']}"
    )


if __name__ == "__main__":
    main()
