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

``AliccpDataset`` reads sample-line files, or ``.tfrecord`` stores of
the reference's layout (data/tfrecord.py), into batches with the JAX
package's semantics and random streams, so the same files and seed give
the same batches, shuffled or not: a window shuffle of ``shuffle_buffer``
lines (or records) after a per-epoch file shuffle, the C++ line parse
(data/native.py; ``use_native=False`` takes the plain Python parser),
and under ``packed_cache`` the parsed arrays cached beside each file
(data/cache.py) and shuffled a chunk at a time. ``multi_hot_pad=0``
derives the pad from the data (``auto_multi_hot_pad``)."""

from __future__ import annotations

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


def auto_multi_hot_pad(
    filenames: Sequence[str], sample_lines: int = 2000, pct: float = 99.0
) -> int:
    """The static pad length derived from the data: the largest over the
    multi-hot fields of the per-field ``pct`` percentile length over the
    first ``sample_lines`` well-formed lines, rounded up to a multiple of
    8 (at least 8); 64 when there is no line. Per field, not pooled: the
    published Ali-CCP lengths are skewed per field (the largest field
    averages 250 ids a sample, the others ~5-40), so a pooled percentile
    would truncate most of the heavy field's history."""
    per_field: Dict[str, List[int]] = {m: [] for m in set(UMH_FIELDS) | {AD_MH_FIELD[0]}}
    seen = 0
    for path in filenames:
        if seen >= sample_lines:
            break
        with open(path, "rb") as f:
            for line in f:
                if seen >= sample_lines:
                    break
                parts = line.strip().split(b",")
                if len(parts) != 4:
                    continue
                counts = {m: 0 for m in per_field}
                for tok in parts[3].split():
                    fv = tok.split(b":")
                    if len(fv) == 3 and fv[0].decode() in counts:
                        counts[fv[0].decode()] += 1
                for m, c in counts.items():
                    per_field[m].append(c)
                seen += 1
    if not seen:
        return 64
    p = max(int(np.percentile(np.asarray(v), pct)) for v in per_field.values() if v)
    return max(8, ((p + 7) // 8) * 8)


def _pad_rows(batch: Batch, n: int, size: int) -> Batch:
    """A batch of n < size rows zero-padded to size rows (mask rows 0)."""
    pad = size - n
    return {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1)) for k, v in batch.items()}


class AliccpDataset:
    """Iterates ``num_epochs`` passes over sample-line files or over
    ``.tfrecord`` stores (not both: mixed inputs raise), yielding padded
    batches of ``batch_size`` samples. The last partial batch is
    zero-padded to ``batch_size`` (its padded rows carry mask 0).
    ``multi_hot_pad=0`` derives the pad from the
    sample lines (``auto_multi_hot_pad``)."""

    def __init__(
        self,
        filenames: Sequence[str],
        batch_size: int = 32,
        num_epochs: int = 1,
        perform_shuffle: bool = False,
        shuffle_buffer: int = 256,
        multi_hot_pad: int = 64,
        seed: Optional[int] = None,
        packed_cache: bool = False,
        use_native: bool = True,
    ):
        from tf_repos_tpu_torch.data.libsvm import LibsvmDataset
        from tf_repos_tpu_torch.data.tfrecord import is_tfrecord_file

        # the line reader: file shuffle, window shuffle and their random
        # stream, and the line-aligned blobs of the packed-cache path
        self._inner = LibsvmDataset(
            filenames, field_size=1, batch_size=batch_size, num_epochs=num_epochs,
            perform_shuffle=perform_shuffle, shuffle_buffer=shuffle_buffer,
            seed=seed, use_native=False,
        )
        self.batch_size = batch_size
        self.packed_cache = packed_cache
        n_rec = sum(is_tfrecord_file(f) for f in self._inner.filenames)
        if 0 < n_rec < len(self._inner.filenames):
            raise ValueError(
                "AliccpDataset: mixed sample-line and .tfrecord inputs; "
                "convert one side (data/tfrecord.py convert_sample_file)"
            )
        self.tfrecord = n_rec > 0
        if multi_hot_pad <= 0:
            if self.tfrecord:
                raise ValueError("multi_hot_pad=0 (auto) requires sample-line inputs")
            multi_hot_pad = auto_multi_hot_pad(self._inner.filenames)
        self.multi_hot_pad = multi_hot_pad
        self._native = None
        if use_native:
            from tf_repos_tpu_torch.data import native

            native.load()  # builds the library now; raises if it cannot
            self._native = native

    def _parse_lines(self, lines: List[bytes]) -> Batch:
        if self._native is not None:
            return self._native.parse_aliccp_lines(lines, self.multi_hot_pad)
        return parse_aliccp_lines(lines, self.multi_hot_pad)

    def _parse_records(self, payloads: List[bytes]) -> Batch:
        from tf_repos_tpu_torch.data.tfrecord import parse_aliccp_examples

        return parse_aliccp_examples(payloads, self.multi_hot_pad)

    def __iter__(self) -> Iterator[Batch]:
        if self.packed_cache:
            # tfrecord inputs cache the same way: _parse_file_chunks
            # dispatches per file
            yield from self._iter_dict_batches(self._iter_cached_chunks())
            return
        if self.tfrecord:
            items, parse = self._iter_record_payloads(), self._parse_records
        else:
            items, parse = self._inner._iter_shuffled_lines(), self._parse_lines
        pending: List[bytes] = []
        for item in items:
            pending.append(item)
            if len(pending) == self.batch_size:
                yield parse(pending)
                pending = []
        if pending:
            yield _pad_rows(parse(pending), len(pending), self.batch_size)

    # ----------------------------------------------------- tfrecord path
    def _iter_record_payloads(self) -> Iterator[bytes]:
        """Record payloads with the line path's epoch, file-shuffle and
        window-shuffle semantics (the same random stream)."""
        from tf_repos_tpu_torch.data.libsvm import window_shuffle
        from tf_repos_tpu_torch.data.tfrecord import iter_records

        inner = self._inner

        def raw():
            for _ in range(inner.num_epochs):
                for path in inner._epoch_files():
                    yield from iter_records(path)

        if not inner.perform_shuffle:
            return raw()
        return window_shuffle(raw(), inner.rng, inner.shuffle_buffer)

    # -------------------------------------------------- packed-cache path
    def _parse_file_chunks(self, path: str) -> Iterator[Batch]:
        """In-order parsed dict chunks of one file: the native blob parse
        on 2 threads (the plain line parse with use_native=False), or
        chunks of 65,536 records for a .tfrecord file. The 'label' alias
        is dropped; it is put back per batch."""
        from tf_repos_tpu_torch.data.libsvm import BLOB_BYTES, blobs_for_file
        from tf_repos_tpu_torch.data.pipeline import ordered_map
        from tf_repos_tpu_torch.data.tfrecord import (
            is_tfrecord_file,
            iter_records,
            parse_aliccp_examples,
        )

        def strip(d: Batch) -> Batch:
            d = dict(d)
            d.pop("label", None)
            return d

        if is_tfrecord_file(path):
            pend: List[bytes] = []
            for payload in iter_records(path):
                pend.append(payload)
                if len(pend) == 65536:
                    yield strip(parse_aliccp_examples(pend, self.multi_hot_pad))
                    pend = []
            if pend:
                yield strip(parse_aliccp_examples(pend, self.multi_hot_pad))
            return
        if self._native is None:
            for blob in blobs_for_file(path, BLOB_BYTES):
                lines = [ln for ln in blob.split(b"\n") if ln.strip()]
                yield strip(parse_aliccp_lines(lines, self.multi_hot_pad))
            return
        native, p = self._native, self.multi_hot_pad
        yield from ordered_map(lambda blob: strip(native.parse_aliccp_blob(blob, p)),
                               blobs_for_file(path, BLOB_BYTES), 2)

    def _iter_cached_chunks(self) -> Iterator[Batch]:
        from tf_repos_tpu_torch.data.cache import cached_chunks

        for _ in range(self._inner.num_epochs):
            for path in self._inner._epoch_files():
                yield from cached_chunks(path, f"p{self.multi_hot_pad}", self._parse_file_chunks)

    def _iter_dict_batches(self, chunks: Iterator[Batch]) -> Iterator[Batch]:
        from tf_repos_tpu_torch.data.pipeline import iter_dict_batches

        def emit(d: Batch) -> Batch:
            d = dict(d)
            d["label"] = d["y"]  # the alias dropped from the packed cache
            return d

        yield from iter_dict_batches(
            chunks, batch_size=self.batch_size, row_key="y", nprng=self._inner._nprng,
            shuffle=self._inner.perform_shuffle, emit=emit,
        )
