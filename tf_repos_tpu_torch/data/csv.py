"""Criteo CSV input for Wide&Deep (the port's own copy of the JAX
package's data/csv.py).

Each line is ``label,I1..I13,C14..C39``: 13 numeric columns (default
0.0) and 26 categorical ones (default 0; a value is read as
``int(float(token))``); empty tokens keep the default, missing trailing
columns too. A batch is {"cont": f32[B,13], "cat": int32[B,26],
"label": f32[B], "mask": f32[B]}; the last partial batch is zero-padded
to B and its mask marks the live rows.

The lines stream through the libsvm reader's plain path (its window
shuffle of ``shuffle_buffer`` lines, per-epoch file shuffle and random
streams), so the same files and seed give the JAX reader's batches. The
parse is a Python loop over tokens: the JAX package has no native csv
parser, and neither has the port. ``packed_cache`` parses each file once
into a ``csv40`` sidecar (data/cache.py) and memmaps it afterwards,
batched as the libsvm reader's cached chunks are."""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from tf_repos_tpu_torch.data.libsvm import BLOB_BYTES, Batch, LibsvmDataset, blobs_for_file
from tf_repos_tpu_torch.data.pipeline import iter_dict_batches

NUM_CONT = 13
NUM_CAT = 26
CACHE_TAG = "csv40"


def parse_csv_lines(lines: Sequence[bytes]) -> Batch:
    n = len(lines)
    cont = np.zeros((n, NUM_CONT), np.float32)
    cat = np.zeros((n, NUM_CAT), np.int32)
    label = np.zeros((n,), np.float32)
    ncols = 1 + NUM_CONT + NUM_CAT
    for r, line in enumerate(lines):
        toks = line.strip().split(b",")
        for c in range(min(len(toks), ncols)):
            t = toks[c]
            if not t:
                continue
            if c == 0:
                label[r] = float(t)
            elif c <= NUM_CONT:
                cont[r, c - 1] = float(t)
            else:
                cat[r, c - 1 - NUM_CONT] = int(float(t))
    return {"cont": cont, "cat": cat, "label": label, "mask": np.ones((n,), np.float32)}


class CsvDataset:
    """Iterates ``num_epochs`` passes over ``filenames`` yielding
    fixed-shape batches of the 40-column Criteo CSV layout."""

    def __init__(
        self,
        filenames: Sequence[str],
        batch_size: int = 32,
        num_epochs: int = 1,
        perform_shuffle: bool = False,
        shuffle_buffer: int = 256,
        seed: Optional[int] = None,
        packed_cache: bool = False,
    ):
        # the line streaming, shuffles and random streams of the libsvm
        # reader's plain path
        self._lines = LibsvmDataset(
            filenames, field_size=1, batch_size=batch_size, num_epochs=num_epochs,
            perform_shuffle=perform_shuffle, shuffle_buffer=shuffle_buffer, seed=seed,
            use_native=False,
        )
        self.batch_size = batch_size
        self.packed_cache = packed_cache

    def __iter__(self) -> Iterator[Batch]:
        inner = self._lines
        if self.packed_cache:
            yield from iter_dict_batches(self._iter_cached_chunks(), batch_size=self.batch_size,
                                         row_key="label", nprng=inner._nprng,
                                         shuffle=inner.perform_shuffle)
            return
        pending: List[bytes] = []
        for ln in inner._iter_shuffled_lines():
            pending.append(ln)
            if len(pending) == self.batch_size:
                yield parse_csv_lines(pending)
                pending = []
        if pending:
            batch = parse_csv_lines(pending)
            pad = self.batch_size - len(pending)
            yield {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1)) for k, v in batch.items()}

    def _iter_cached_chunks(self) -> Iterator[Batch]:
        from tf_repos_tpu_torch.data.cache import cached_chunks

        def parse(path):
            for blob in blobs_for_file(path, BLOB_BYTES):
                yield parse_csv_lines([ln for ln in blob.split(b"\n") if ln.strip()])

        for _ in range(self._lines.num_epochs):
            for path in self._lines._epoch_files():
                yield from cached_chunks(path, CACHE_TAG, parse)
