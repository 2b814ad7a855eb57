"""Packed binary cache for text inputs (--packed_cache); the port's own
copy of the JAX package's data/cache.py, in the same on-disk layout and
format version, so a cache written by either package reads in the other.

Parsing text is the host input's largest cost, and a multi-epoch run
pays it every pass. A cache is a named set of row-major arrays sharing a
leading row count, keyed by the source file and a reader ``tag`` (the
parse parameters: ``f<field_size>`` for libsvm, ``p<multi_hot_pad>`` for
Ali-CCP):

  <dir>/.packed_cache/<basename>.<tag>.<name>.bin   raw C-order data
  <dir>/.packed_cache/<basename>.<tag>.meta.json    dtypes/shapes + validation

The first pass parses and streams the arrays to disk; every later epoch
and run over the same file memmaps them. Validation is by the source's
size and ``mtime_ns``, the tag, the array schema and the format version;
a stale or partial cache is rebuilt.

Concurrency: writers build under a temporary name and os.rename() into
place (atomic on one filesystem; the meta file is renamed last, so a
reader never sees meta without complete data). Concurrent builders of
the same file write identical bytes; the last rename wins.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional

import numpy as np

FORMAT_VERSION = 2
CACHE_DIRNAME = ".packed_cache"
ROWS_PER_CHUNK = 65536  # rows of each memmap slice a cached file is read in

Arrays = Dict[str, np.ndarray]


def _cache_paths(path: str, tag: str, names):
    d = os.path.join(os.path.dirname(os.path.abspath(path)), CACHE_DIRNAME)
    stem = f"{os.path.basename(path)}.{tag}"
    p = {name: os.path.join(d, f"{stem}.{name}.bin") for name in names}
    p["__meta__"] = os.path.join(d, f"{stem}.meta.json")
    return d, p


class PackedCache:
    """Read side: validated memmap views of one cached source file."""

    def __init__(self, arrays: Arrays, rows: int):
        self.arrays = arrays
        self.rows = rows

    @staticmethod
    def open(path: str, tag: str) -> Optional["PackedCache"]:
        """Memmaps over a valid cache of `path`, or None (absent/stale)."""
        _, p = _cache_paths(path, tag, [])
        try:
            with open(p["__meta__"]) as f:
                meta = json.load(f)
            st = os.stat(path)
            if (
                meta.get("version") != FORMAT_VERSION
                or meta.get("tag") != tag
                or meta.get("src_size") != st.st_size
                or meta.get("src_mtime_ns") != st.st_mtime_ns
            ):
                return None
            n = int(meta["rows"])
            _, p = _cache_paths(path, tag, meta["arrays"].keys())
            arrays = {}
            for name, spec in meta["arrays"].items():
                shape = (n, *spec["shape_tail"])
                arrays[name] = np.memmap(p[name], np.dtype(spec["dtype"]), "r", shape=shape)
            return PackedCache(arrays, n)
        except (OSError, ValueError, KeyError):
            return None

    def iter_chunks(self, rows_per_chunk: int) -> Iterator[Arrays]:
        """Sequential row-chunk views (no copy; downstream batching slices
        them and the shuffle permutation makes its own chunk-local copy,
        exactly like the text path's parsed chunks)."""
        for s in range(0, self.rows, rows_per_chunk):
            e = min(s + rows_per_chunk, self.rows)
            yield {k: a[s:e] for k, a in self.arrays.items()}


class PackedCacheWriter:
    """Write side: stream parsed chunks to temp files; commit() renames
    them into place (data files first, meta last). The array schema is
    fixed by the first append."""

    def __init__(self, path: str, tag: str):
        self.src = path
        self.tag = tag
        self.rows = 0
        self._files: Dict[str, object] = {}
        self._schema: Dict[str, dict] = {}
        self._tmp: Dict[str, str] = {}
        self._paths: Dict[str, str] = {}
        self._failed = False

    def append(self, arrays: Arrays) -> None:
        if self._failed:
            return
        try:
            if not self._files:
                d, self._paths = _cache_paths(self.src, self.tag, arrays.keys())
                os.makedirs(d, exist_ok=True)
                self._tmp = {
                    k: f"{v}.tmp.{os.getpid()}" for k, v in self._paths.items()
                }
                for name, a in arrays.items():
                    a = np.asarray(a)
                    self._schema[name] = {
                        "dtype": a.dtype.str,
                        "shape_tail": list(a.shape[1:]),
                    }
                    self._files[name] = open(self._tmp[name], "wb")
            n = None
            for name, spec in self._schema.items():
                a = np.asarray(arrays[name])
                if list(a.shape[1:]) != spec["shape_tail"]:
                    raise ValueError(f"shape drift for {name}: {a.shape}")
                n = a.shape[0] if n is None else n
                self._files[name].write(
                    np.ascontiguousarray(a, np.dtype(spec["dtype"])).tobytes()
                )
            self.rows += int(n or 0)
        except (OSError, ValueError):  # disk full etc. — training survives
            self._failed = True

    def commit(self) -> bool:
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                self._failed = True
        if self._failed or not self._files:
            self.abort()
            return False
        try:
            st = os.stat(self.src)
            for name in self._schema:
                os.rename(self._tmp[name], self._paths[name])
            meta = {
                "version": FORMAT_VERSION,
                "tag": self.tag,
                "rows": self.rows,
                "arrays": self._schema,
                "src_size": st.st_size,
                "src_mtime_ns": st.st_mtime_ns,
            }
            with open(self._tmp["__meta__"], "w") as f:
                json.dump(meta, f)
            os.rename(self._tmp["__meta__"], self._paths["__meta__"])
            return True
        except OSError:
            self.abort()
            return False

    def abort(self) -> None:
        self._failed = True
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        for t in self._tmp.values():
            try:
                os.remove(t)
            except OSError:
                pass


def cached_chunks(path: str, tag: str, parse_chunks) -> Iterator[Arrays]:
    """The chunks of one source file: memmap slices of ``ROWS_PER_CHUNK``
    rows of its cache when that is valid; otherwise ``parse_chunks(path)``
    (dicts of arrays), each streamed into a new cache as it is yielded.
    A parse that fails or is abandoned leaves no cache behind."""
    cached = PackedCache.open(path, tag)
    if cached is not None:
        yield from cached.iter_chunks(ROWS_PER_CHUNK)
        return
    writer = PackedCacheWriter(path, tag)
    try:
        for d in parse_chunks(path):
            writer.append(d)
            yield d
    except BaseException:
        writer.abort()
        raise
    writer.commit()
