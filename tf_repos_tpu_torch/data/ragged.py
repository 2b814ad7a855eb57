"""Ali-CCP sample lines -> fixed-shape padded batches for ESMM and DIN (the
port's own copy of the JAX package's data/ragged.py, sample-line input
only).

A line is ``sample_id,y,z,field:fid:val field:fid:val ...``. Multi-hot
fields are padded or truncated to ``multi_hot_pad`` with padding id 0
(liveness is id > 0). ``parse_aliccp_lines`` gives the same arrays, bit
for bit, as the JAX package's function of that name.

Field schema:
  Common:   11 single-valued fields -> feat_ids int32[B,11]
            (default id = field's 1-based position when absent)
  User MH:  109_14->u_cat, 110_14->u_shop, 127_14->u_brand, 150_14->u_int
            ids+vals, defaults (12..15, val 1.0)
  Ad:       206->a_cat, 207->a_shop, 216->a_brand (scalar; defaults
            16,17,19), 210->a_int (multi-hot; default 18)

``AliccpDataset`` reads sample-line files into batches. Its shuffle
permutes the lines of each read chunk (and the file order per epoch), so
shuffled batches differ from the JAX package's window shuffle; unshuffled
batches are the same. ``.tfrecord`` input, the packed cache and the pad
derived from the data (multi_hot_pad=0) are not ported and raise."""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]

COMMON_FIELDS = {
    "101": 1, "121": 2, "122": 3, "124": 4, "125": 5, "126": 6,
    "127": 7, "128": 8, "129": 9, "205": 10, "301": 11,
}
UMH_FIELDS = {"109_14": ("u_cat", 12), "110_14": ("u_shop", 13),
              "127_14": ("u_brand", 14), "150_14": ("u_int", 15)}
AD_SCALAR_FIELDS = {"206": ("a_cat", 16), "207": ("a_shop", 17), "216": ("a_brand", 19)}
AD_MH_FIELD = ("210", "a_int", 18)

NUM_COMMON = len(COMMON_FIELDS)

# the padded multi-hot (ids, vals) field pairs of this layout, which
# --mh_bucket slices (data/sparse_batch.MhPadBucketer); a_int has no vals
MH_PAIRS = (
    ("u_catids", "u_catvals"),
    ("u_shopids", "u_shopvals"),
    ("u_brandids", "u_brandvals"),
    ("u_intids", "u_intvals"),
    ("a_intids", None),
)


def parse_aliccp_lines(lines: Sequence[bytes], multi_hot_pad: int = 64) -> Batch:
    """Sample lines (bytes) -> padded batch arrays. A line without exactly
    four comma-separated parts gets mask 0 and all-zero ids; a token that
    is not ``field:fid:val`` is skipped."""
    n = len(lines)
    p = multi_hot_pad
    out: Batch = {
        "y": np.zeros((n,), np.float32),
        "z": np.zeros((n,), np.float32),
        "feat_ids": np.zeros((n, NUM_COMMON), np.int32),
        "a_catids": np.full((n,), 16, np.int32),
        "a_shopids": np.full((n,), 17, np.int32),
        "a_brandids": np.full((n,), 19, np.int32),
        "a_intids": np.zeros((n, p), np.int32),
        "mask": np.ones((n,), np.float32),
    }
    for fname, _ in UMH_FIELDS.values():
        out[f"{fname}ids"] = np.zeros((n, p), np.int32)
        out[f"{fname}vals"] = np.zeros((n, p), np.float32)
    mh_ids = {fname: out[f"{fname}ids"] for fname, _ in UMH_FIELDS.values()}
    mh_vals = {fname: out[f"{fname}vals"] for fname, _ in UMH_FIELDS.values()}
    ad_ids = {fname: out[f"{fname}ids"] for fname, _ in AD_SCALAR_FIELDS.values()}
    feat_ids, a_intids = out["feat_ids"], out["a_intids"]
    common_default = np.arange(1, NUM_COMMON + 1)

    for r, line in enumerate(lines):
        parts = line.strip().split(b",")
        if len(parts) != 4:
            out["mask"][r] = 0.0
            continue
        out["y"][r] = float(parts[1])
        out["z"][r] = float(parts[2])
        feat_ids[r] = common_default
        mh_count = {fname: 0 for fname, _ in UMH_FIELDS.values()}
        pending_defaults = {fname: dv for fname, dv in UMH_FIELDS.values()}
        a_int_count = 0
        for tok in parts[3].split():
            fv = tok.split(b":")
            if len(fv) != 3:
                continue
            field = fv[0].decode()
            fid = int(fv[1])
            if field in COMMON_FIELDS:
                feat_ids[r, COMMON_FIELDS[field] - 1] = fid
            elif field in UMH_FIELDS:
                fname, _ = UMH_FIELDS[field]
                pending_defaults.pop(fname, None)
                c = mh_count[fname]
                if c < p:
                    mh_ids[fname][r, c] = fid
                    mh_vals[fname][r, c] = float(fv[2])
                    mh_count[fname] = c + 1
            elif field in AD_SCALAR_FIELDS:
                ad_ids[AD_SCALAR_FIELDS[field][0]][r] = fid
            elif field == AD_MH_FIELD[0]:
                if a_int_count < p:
                    a_intids[r, a_int_count] = fid
                    a_int_count += 1
        for fname, def_id in pending_defaults.items():
            mh_ids[fname][r, 0] = def_id
            mh_vals[fname][r, 0] = 1.0
        if a_int_count == 0:
            a_intids[r, 0] = AD_MH_FIELD[2]
    out["label"] = out["y"]
    return out


class AliccpDataset:
    """Iterates ``num_epochs`` passes over sample-line files, yielding
    padded batches of ``batch_size`` lines (blank lines skipped). The last
    partial batch is zero-padded to ``batch_size``; its padded rows carry
    mask 0."""

    def __init__(
        self,
        filenames: Sequence[str],
        batch_size: int = 32,
        num_epochs: int = 1,
        perform_shuffle: bool = False,
        multi_hot_pad: int = 64,
        seed: Optional[int] = None,
    ):
        self.filenames = [filenames] if isinstance(filenames, str) else list(filenames)
        tfrecords = [f for f in self.filenames if f.endswith(".tfrecord")]
        if tfrecords:
            raise NotImplementedError(
                f".tfrecord input ({tfrecords[0]}): not implemented in "
                "tf_repos_tpu_torch yet (sample-line files only)"
            )
        if multi_hot_pad <= 0:
            raise NotImplementedError(
                "--multi_hot_pad=0 (the pad derived from the data): not "
                "implemented in tf_repos_tpu_torch yet"
            )
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.perform_shuffle = perform_shuffle
        self.chunk_lines = max(65536, batch_size)  # lines read (and shuffled) at a time
        self.multi_hot_pad = multi_hot_pad
        self.rng = random.Random(seed)
        self._nprng = np.random.default_rng(seed)

    def _iter_chunks(self) -> Iterator[List[bytes]]:
        for _ in range(self.num_epochs):
            files = list(self.filenames)
            if self.perform_shuffle:
                self.rng.shuffle(files)
            for path in files:
                pending: List[bytes] = []
                with open(path, "rb") as f:
                    for ln in f:
                        if ln.strip():
                            pending.append(ln)
                        if len(pending) == self.chunk_lines:
                            yield pending
                            pending = []
                if pending:
                    yield pending

    def __iter__(self) -> Iterator[Batch]:
        B = self.batch_size
        carry: List[bytes] = []
        for chunk in self._iter_chunks():
            if self.perform_shuffle:
                chunk = [chunk[i] for i in self._nprng.permutation(len(chunk))]
            lines = carry + chunk
            n_full = len(lines) // B
            for i in range(n_full):
                yield parse_aliccp_lines(lines[i * B : (i + 1) * B], self.multi_hot_pad)
            carry = lines[n_full * B :]
        if carry:
            batch = parse_aliccp_lines(carry, self.multi_hot_pad)
            pad = B - len(carry)
            yield {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1)) for k, v in batch.items()}
