"""Criteo log preprocessor: raw tab-separated logs -> libsvm + feature_map.
(The port's own copy of the JAX package's features/criteo.py: host code,
no torch; the same output bytes for the same input. field_blocks_from_feature_map
feeds --field_blocks=auto:<feature_map>, the K8 field-block scatter.)


Behavioral spec from the reference's deep_ctr/Feature_pipeline/
get_criteo_feature.py ("approach 3" in deep_ctr/README.md:24-31):

  * 13 integer features I1..I13 (:20), clipped at a fixed per-feature 95th
    percentile list (:25), min-max normalized to [0,1] from the CLIPPED
    train-set range (:63-90); empty -> 0.0 (:87-88). Emitted as
    ``<field_index>:<val>`` with val %.6f, trailing zeros stripped
    (:139-141).
  * 26 categorical features C1..C26 (:21): per-feature frequency dict over
    train.txt, values with count < cutoff (default 200) dropped, remaining
    sorted by (-count, key), ids 1..V, '<unk>' -> 0 (:38-50). Emitted as
    ``<dict_id + field_offset>:1`` with offsets starting at 13 (:120-123,
    :143-145) — one dataset-wide id space.
  * feature_map lines ``I<i> <i>`` and ``C<i>|<key> <id>`` (:116-125).
    DEVIATION (documented): the reference writes ``offset + id + 1`` into
    feature_map but emits ``offset + id`` into the libsvm data (:125 vs
    :144) — an internal off-by-one. Here feature_map matches the EMITTED
    ids, so the map can actually be used to decode the data.
  * 90/10 train/valid split by random.randint(0,9999) % 10 with seed 0
    (:127-151); test.txt (no label column) -> te.libsvm.
    DEVIATION (documented): the reference labels every te.libsvm row with
    the LAST train label left in scope (:148-167, stale variable — a
    latent bug); here test rows get label 0.

feature_size for training = 13 + sum(len(dict)+1 per categorical) — the
published 117,581 for the full dataset (deep_ctr/README.md:51).
"""

from __future__ import annotations

import argparse
import collections
import os
import random
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

NUM_CONTINUOUS = 13
NUM_CATEGORICAL = 26
# 95th-percentile clip points (get_criteo_feature.py:25)
CONTINUOUS_CLIP = [20, 600, 100, 50, 64000, 500, 100, 50, 500, 10, 10, 10, 50]


class CategoryDictGenerator:
    """Per-categorical-feature frequency dict -> dense ids (cutoff filter,
    frequency-sorted, <unk>=0). get_criteo_feature.py:28-61."""

    def __init__(self, num_feature: int = NUM_CATEGORICAL):
        self.num_feature = num_feature
        self.counts = [collections.defaultdict(int) for _ in range(num_feature)]
        self.dicts: List[Dict[str, int]] = []

    def accumulate(self, fields: Sequence[str], base: int) -> None:
        for i in range(self.num_feature):
            v = fields[base + i]
            if v != "":
                self.counts[i][v] += 1

    def build(self, cutoff: int = 200) -> None:
        self.dicts = []
        for i in range(self.num_feature):
            kept = [(k, c) for k, c in self.counts[i].items() if c >= cutoff]
            kept.sort(key=lambda kv: (-kv[1], kv[0]))
            d = {k: j + 1 for j, (k, _) in enumerate(kept)}
            d["<unk>"] = 0
            self.dicts.append(d)

    def gen(self, idx: int, key: str) -> int:
        return self.dicts[idx].get(key, 0)

    def dict_sizes(self) -> List[int]:
        return [len(d) for d in self.dicts]


class ContinuousFeatureGenerator:
    """Clip-then-min-max normalizer for the integer features.
    get_criteo_feature.py:64-91."""

    def __init__(self, num_feature: int = NUM_CONTINUOUS, clip=None):
        self.num_feature = num_feature
        self.clip = list(clip if clip is not None else CONTINUOUS_CLIP)
        self.min = [float("inf")] * num_feature
        self.max = [float("-inf")] * num_feature

    def accumulate(self, fields: Sequence[str], base: int) -> None:
        for i in range(self.num_feature):
            v = fields[base + i]
            if v != "":
                val = min(int(v), self.clip[i])
                self.min[i] = min(self.min[i], val)
                self.max[i] = max(self.max[i], val)

    def gen(self, idx: int, val: str) -> float:
        if val == "":
            return 0.0
        span = self.max[idx] - self.min[idx]
        if span <= 0:
            return 0.0
        return (min(float(val), self.clip[idx]) - self.min[idx]) / span


def _emit_line(
    fields: Sequence[str],
    label: str,
    cont: ContinuousFeatureGenerator,
    cats: CategoryDictGenerator,
    offsets: Sequence[int],
    base: int,
    out: TextIO,
) -> None:
    parts = [label]
    for i in range(cont.num_feature):
        v = cont.gen(i, fields[base + i])
        s = f"{v:.6f}".rstrip("0").rstrip(".")
        parts.append(f"{i + 1}:{s if s else '0'}")
    for i in range(cats.num_feature):
        fid = cats.gen(i, fields[base + cont.num_feature + i]) + offsets[i]
        parts.append(f"{fid}:1")
    out.write(" ".join(parts) + "\n")


def _chunk_boundaries(path: str, workers: int) -> List[Tuple[int, int]]:
    """Split a file into `workers` byte ranges aligned to line starts."""
    size = os.path.getsize(path)
    cuts = [0]
    with open(path, "rb") as f:
        for k in range(1, workers):
            f.seek(size * k // workers)
            f.readline()  # advance to the next line start
            cuts.append(min(f.tell(), size))
    cuts.append(size)
    # collapse degenerate (empty) ranges from tiny files
    return [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


def _count_chunk(args) -> Tuple[List[Dict[str, int]], List[float], List[float], int]:
    """Pass-1 worker: frequency dicts + min/max + line count over one
    byte range. Counting is order-independent, so the merged result is
    exactly the sequential one."""
    path, start, end = args
    cont = ContinuousFeatureGenerator()
    cats = CategoryDictGenerator()
    n = 0
    with open(path) as f:
        f.seek(start)
        while f.tell() < end:
            line = f.readline()
            if not line:
                break
            fields = line.rstrip("\n").split("\t")
            cont.accumulate(fields, 1)
            cats.accumulate(fields, 1 + NUM_CONTINUOUS)
            n += 1
    return [dict(c) for c in cats.counts], cont.min, cont.max, n


def _emit_chunk(args) -> None:
    """Pass-2 worker: emit one byte range to tr/va (or te) part files.

    The 90/10 split consumes one Random(seed).randint per TRAIN line in
    file order; fast-forwarding the generator by this chunk's starting
    line index reproduces the sequential assignment exactly, so the
    concatenated part files are byte-identical to workers=1 output."""
    (path, start, end, base, label_from_row, tr_part, va_part,
     cont_state, dicts, offsets, seed, skip) = args
    cont = ContinuousFeatureGenerator()
    cont.min, cont.max = cont_state
    cats = CategoryDictGenerator()
    cats.dicts = dicts
    rng = None
    if va_part is not None:
        rng = random.Random(seed)
        for _ in range(skip):
            rng.randint(0, 9999)
    va = open(va_part, "w") if va_part else None
    with open(tr_part, "w") as tr, open(path) as f:
        f.seek(start)
        while f.tell() < end:
            line = f.readline()
            if not line:
                break
            fields = line.rstrip("\n").split("\t")
            if rng is not None:
                out = tr if rng.randint(0, 9999) % 10 != 0 else va
                _emit_line(fields, fields[0], cont, cats, offsets, base, out)
            else:
                _emit_line(fields, "0", cont, cats, offsets, base, tr)
    if va is not None:
        va.close()


def _concat(parts: List[str], dest: str) -> None:
    with open(dest, "wb") as out:
        for p in parts:
            with open(p, "rb") as f:
                while True:
                    buf = f.read(1 << 24)
                    if not buf:
                        break
                    out.write(buf)
            os.remove(p)


def preprocess(
    input_dir: str,
    output_dir: str,
    cutoff: int = 200,
    train_file: str = "train.txt",
    test_file: Optional[str] = "test.txt",
    seed: int = 0,
    workers: int = 1,
) -> Dict[str, int]:
    """Run the full pipeline; returns {"feature_size": ..., "field_size": ...}.

    workers > 1 chunk-parallelizes both passes with BYTE-IDENTICAL
    output (pass 1 merges order-independent counts; pass 2 fast-forwards
    the split rng to each chunk's line index) — the full 45.84M-line run
    is ~1.5h single-core otherwise."""
    os.makedirs(output_dir, exist_ok=True)
    train_path = os.path.join(input_dir, train_file)

    cont = ContinuousFeatureGenerator()
    cats = CategoryDictGenerator()
    chunk_lines: List[int] = []
    train_bounds: List[Tuple[int, int]] = []
    pool = None
    if workers > 1:
        import multiprocessing as mp

        pool = mp.get_context("spawn").Pool(workers)
        train_bounds = _chunk_boundaries(train_path, workers)
        results = pool.map(
            _count_chunk, [(train_path, a, b) for a, b in train_bounds]
        )
        for counts, mins, maxs, n in results:
            for i in range(NUM_CATEGORICAL):
                for k, c in counts[i].items():
                    cats.counts[i][k] += c
            for i in range(NUM_CONTINUOUS):
                cont.min[i] = min(cont.min[i], mins[i])
                cont.max[i] = max(cont.max[i], maxs[i])
            chunk_lines.append(n)
    else:
        with open(train_path) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                cont.accumulate(fields, 1)
                cats.accumulate(fields, 1 + NUM_CONTINUOUS)
    cats.build(cutoff)

    sizes = cats.dict_sizes()
    offsets = [NUM_CONTINUOUS]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    feature_size = NUM_CONTINUOUS + sum(sizes)

    with open(os.path.join(output_dir, "feature_map"), "w") as fm:
        for i in range(1, NUM_CONTINUOUS + 1):
            fm.write(f"I{i} {i}\n")
        for i in range(NUM_CATEGORICAL):
            for key, vid in cats.dicts[i].items():
                fm.write(f"C{i + 1}|{key} {offsets[i] + vid}\n")

    tr_path = os.path.join(output_dir, "tr.libsvm")
    va_path = os.path.join(output_dir, "va.libsvm")
    test_path = os.path.join(input_dir, test_file) if test_file else None
    if pool is not None:
        cont_state = (cont.min, cont.max)
        skips = [0]
        for n in chunk_lines[:-1]:
            skips.append(skips[-1] + n)
        jobs = [
            (train_path, a, b, 1, True, f"{tr_path}.{k}", f"{va_path}.{k}",
             cont_state, cats.dicts, offsets, seed, skips[k])
            for k, (a, b) in enumerate(train_bounds)
        ]
        pool.map(_emit_chunk, jobs)
        _concat([j[5] for j in jobs], tr_path)
        _concat([j[6] for j in jobs], va_path)
        if test_path and os.path.exists(test_path):
            te_path = os.path.join(output_dir, "te.libsvm")
            te_bounds = _chunk_boundaries(test_path, workers)
            jobs = [
                (test_path, a, b, 0, False, f"{te_path}.{k}", None,
                 cont_state, cats.dicts, offsets, seed, 0)
                for k, (a, b) in enumerate(te_bounds)
            ]
            pool.map(_emit_chunk, jobs)
            _concat([j[5] for j in jobs], te_path)
        pool.close()
        pool.join()
        return {
            "feature_size": feature_size,
            "field_size": NUM_CONTINUOUS + NUM_CATEGORICAL,
        }

    rng = random.Random(seed)
    with open(tr_path, "w") as tr, open(va_path, "w") as va, open(train_path) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            out = tr if rng.randint(0, 9999) % 10 != 0 else va
            _emit_line(fields, fields[0], cont, cats, offsets, 1, out)

    if test_path and os.path.exists(test_path):
        with open(os.path.join(output_dir, "te.libsvm"), "w") as te, open(
            test_path
        ) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                _emit_line(fields, "0", cont, cats, offsets, 0, te)

    return {"feature_size": feature_size, "field_size": NUM_CONTINUOUS + NUM_CATEGORICAL}


def field_blocks_from_feature_map(path: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offsets, sizes) of each field's contiguous id block, derived from
    a feature_map produced by preprocess(). Continuous field i occupies the
    single id i; categorical C<j> spans [min id, max id] of its values.
    Feeds the field-block scatter (ops/field_block.py)."""
    cat_ids: Dict[int, List[int]] = {}
    with open(path) as f:
        for line in f:
            key, vid = line.rsplit(" ", 1)
            if key.startswith("C") and "|" in key:
                j = int(key.split("|")[0][1:])
                cat_ids.setdefault(j, []).append(int(vid))
    offsets = list(range(1, NUM_CONTINUOUS + 1))
    sizes = [1] * NUM_CONTINUOUS
    for j in sorted(cat_ids):
        lo, hi = min(cat_ids[j]), max(cat_ids[j])
        offsets.append(lo)
        sizes.append(hi - lo + 1)
    return tuple(offsets), tuple(sizes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--cutoff", type=int, default=200)
    p.add_argument("--workers", type=int, default=1)
    a = p.parse_args(argv)
    info = preprocess(a.input_dir, a.output_dir, a.cutoff, workers=a.workers)
    print(f"feature_size {info['feature_size']} field_size {info['field_size']}")


if __name__ == "__main__":
    main()
