"""libsvm text input -> fixed-shape numpy batches (the port's own copy of
the JAX package's data/libsvm.py).

Each line is ``label id:val id:val ...`` with field_size fields; a batch
is {feat_ids int32[B,F], feat_vals f32[B,F], label f32[B], mask f32[B]}.
The last partial batch is zero-padded to B and its mask marks the live
rows.

Three paths, with the JAX reader's semantics and random streams, so the
same files and seed give the same batches:
  * native (default): line-aligned blobs of 16 MiB parsed in C++
    (data/native.py) on a pool of ``parse_workers`` threads, yielded in
    order; shuffling permutes the rows of each blob;
  * packed cache (``packed_cache=True``): the parsed arrays of each file
    are written once beside it (data/cache.py) and memmapped on every
    later pass, in chunks of 65,536 rows; shuffling permutes each chunk;
  * plain (``use_native=False``): the Python parser, a line at a time,
    with a window shuffle of ``shuffle_buffer`` lines.
The file order is shuffled per epoch on every path."""

from __future__ import annotations

import glob
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tf_repos_tpu_torch.data.pipeline import iter_dict_batches, ordered_map

Batch = Dict[str, np.ndarray]
Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray]

READ_BYTES = 8 << 20  # the plain path's file reads
BLOB_BYTES = 16 << 20  # the line-aligned blobs of the native and packed-cache paths


def parse_libsvm_lines(
    lines: Sequence[bytes], field_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse libsvm lines (bytes) into (ids int32, vals f32, labels f32).

    Fast path: when every line has exactly 1 + 2*field_size tokens, the
    whole chunk is parsed by numpy's C text parser in one call. Ragged
    lines fall back to a per-line parse with zero padding / truncation."""
    n = len(lines)
    if n == 0:
        z = np.zeros((0, field_size))
        return z.astype(np.int32), z.astype(np.float32), np.zeros((0,), np.float32)
    blob = b" ".join(line.strip() for line in lines).replace(b":", b" ")
    width = 1 + 2 * field_size
    if blob.count(b" ") + 1 == n * width:
        arr = np.fromstring(blob.decode("ascii"), dtype=np.float64, sep=" ")
        if arr.size == n * width:
            arr = arr.reshape(n, width)
            return (
                arr[:, 1::2].astype(np.int32),
                arr[:, 2::2].astype(np.float32),
                arr[:, 0].astype(np.float32),
            )
    return _parse_ragged(lines, field_size)


def _parse_ragged(
    lines: Sequence[bytes], field_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = len(lines)
    ids = np.zeros((n, field_size), np.int32)
    vals = np.zeros((n, field_size), np.float32)
    labels = np.zeros((n,), np.float32)
    for r, line in enumerate(lines):
        toks = line.split()
        if not toks:
            continue
        labels[r] = float(toks[0])
        for c in range(min(len(toks) - 1, field_size)):
            fid, _, fval = toks[1 + c].partition(b":")
            ids[r, c] = int(fid)
            vals[r, c] = float(fval) if fval else 1.0
    return ids, vals, labels


def parse_libsvm_bytes(data: bytes, field_size: int) -> Chunk:
    """The plain parse of a whole text blob (blank lines skipped)."""
    return parse_libsvm_lines([ln for ln in data.split(b"\n") if ln.strip()], field_size)


def window_shuffle(items, rng: random.Random, size: int) -> Iterator:
    """The reference's shuffle(buffer_size) on ``rng``: once ``size`` items
    are held, each new one swaps a random held item out; the rest come
    out shuffled at the end."""
    buf: List = []
    for x in items:
        buf.append(x)
        if len(buf) >= size:
            i = rng.randrange(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def blobs_for_file(path: str, chunk_bytes: int) -> Iterator[bytes]:
    """Line-aligned byte chunks of one file (the last may lack its final
    newline)."""
    with open(path, "rb") as f:
        carry = b""
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                if carry.strip():
                    yield carry
                break
            chunk = carry + chunk
            cut = chunk.rfind(b"\n")
            if cut == -1:
                carry = chunk
                continue
            yield chunk[: cut + 1]
            carry = chunk[cut + 1:]


class LibsvmDataset:
    """Iterates ``num_epochs`` passes over ``filenames`` yielding fixed-shape
    batches (see the module docstring for the three paths)."""

    def __init__(
        self,
        filenames: Sequence[str],
        field_size: int,
        batch_size: int = 32,
        num_epochs: int = 1,
        perform_shuffle: bool = False,
        shuffle_buffer: int = 256,
        seed: Optional[int] = None,
        use_native: bool = True,
        parse_workers: int = 2,
        packed_cache: bool = False,
    ):
        self.filenames = [filenames] if isinstance(filenames, str) else list(filenames)
        self.field_size = field_size
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.perform_shuffle = perform_shuffle
        self.shuffle_buffer = max(shuffle_buffer, batch_size)
        self.parse_workers = max(parse_workers, 1)
        self.packed_cache = packed_cache
        self.rng = random.Random(seed)
        self._nprng = np.random.default_rng(seed)
        self._native = None
        if use_native:
            from tf_repos_tpu_torch.data import native

            native.load()  # builds the library now; raises if it cannot
            self._native = native

    def _epoch_files(self) -> List[str]:
        files = list(self.filenames)
        if self.perform_shuffle:
            self.rng.shuffle(files)
        return files

    # ------------------------------------------------------- the plain path
    def _iter_lines(self) -> Iterator[bytes]:
        for _ in range(self.num_epochs):
            for path in self._epoch_files():
                with open(path, "rb") as f:
                    tail = b""
                    while True:
                        chunk = f.read(READ_BYTES)
                        if not chunk:
                            if tail.strip():
                                yield tail
                            break
                        lines = (tail + chunk).split(b"\n")
                        tail = lines.pop()
                        for ln in lines:
                            if ln.strip():
                                yield ln

    def _iter_shuffled_lines(self) -> Iterator[bytes]:
        """The lines of every epoch, through a window shuffle of
        ``shuffle_buffer`` lines when shuffling (the reference's
        shuffle(256))."""
        if not self.perform_shuffle:
            return self._iter_lines()
        return window_shuffle(self._iter_lines(), self.rng, self.shuffle_buffer)

    def __iter__(self) -> Iterator[Batch]:
        if self.packed_cache:
            yield from self._iter_array_batches(self._iter_cached_chunks())
            return
        if self._native is not None:
            yield from self._iter_array_batches(self._iter_parsed_chunks())
            return
        pending: List[bytes] = []
        for ln in self._iter_shuffled_lines():
            pending.append(ln)
            if len(pending) == self.batch_size:
                yield self._make_batch(pending)
                pending = []
        if pending:
            yield self._make_batch(pending)

    def _make_batch(self, lines: List[bytes]) -> Batch:
        ids, vals, labels = parse_libsvm_lines(lines, self.field_size)
        pad = self.batch_size - len(lines)
        return {
            "feat_ids": np.pad(ids, ((0, pad), (0, 0))),
            "feat_vals": np.pad(vals, ((0, pad), (0, 0))),
            "label": np.pad(labels, (0, pad)),
            "mask": np.pad(np.ones((len(lines),), np.float32), (0, pad)),
        }

    # ----------------------------------------------------- the native path
    def _parse_blob(self, blob: bytes) -> Chunk:
        return self._native.parse_libsvm_blob(blob, self.field_size)

    def _iter_parsed_chunks(self) -> Iterator[Chunk]:
        """Parsed blobs of every epoch, parsed on the thread pool (the C
        parser releases the GIL, so parses overlap the file reads and the
        batching), in order."""

        def blobs():
            for _ in range(self.num_epochs):
                for path in self._epoch_files():
                    yield from blobs_for_file(path, BLOB_BYTES)

        yield from ordered_map(self._parse_blob, blobs(), self.parse_workers)

    def _parse_file_chunks(self, path: str) -> Iterator[Chunk]:
        """In-order parsed chunks of one file: on the thread pool with the
        native parser, inline with the plain one."""
        if self._native is None:
            for blob in blobs_for_file(path, BLOB_BYTES):
                yield parse_libsvm_bytes(blob, self.field_size)
            return
        yield from ordered_map(self._parse_blob, blobs_for_file(path, BLOB_BYTES),
                               self.parse_workers)

    # ------------------------------------------------ the packed-cache path
    def _iter_cached_chunks(self) -> Iterator[Chunk]:
        """Memmap slices of each file's packed cache when it is valid;
        otherwise the parsed text, streamed into a new cache as it goes."""
        from tf_repos_tpu_torch.data.cache import cached_chunks

        def parse(path):
            for ids, vals, labels in self._parse_file_chunks(path):
                yield {"ids": ids, "vals": vals, "labels": labels}

        for _ in range(self.num_epochs):
            for path in self._epoch_files():
                for c in cached_chunks(path, f"f{self.field_size}", parse):
                    yield c["ids"], c["vals"], c["labels"]

    def _iter_array_batches(self, chunks: Iterator[Chunk]) -> Iterator[Batch]:
        """Batches from (ids, vals, labels) chunks through
        iter_dict_batches: each chunk's rows permuted when shuffling,
        zero-copy batch views, the remainder carried into the next
        chunk."""

        def dicts():
            for ids, vals, labels in chunks:
                yield {"feat_ids": ids, "feat_vals": vals, "label": labels,
                       "mask": np.ones((len(labels),), np.float32)}

        yield from iter_dict_batches(dicts(), batch_size=self.batch_size, row_key="label",
                                     nprng=self._nprng, shuffle=self.perform_shuffle)


def glob_input_files(data_dir: str, pattern: str, shuffle: bool = False, seed: int = 0) -> List[str]:
    """tr*/va*/te* file lists; the training list is shuffled."""
    files = sorted(glob.glob(f"{data_dir.rstrip('/')}/{pattern}"))
    if shuffle:
        random.Random(seed).shuffle(files)
    return files
