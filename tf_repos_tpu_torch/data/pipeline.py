"""Host-side input pipeline utilities (the port's own copy of the JAX
package's data/pipeline.py).

``Prefetcher`` runs an iterator on a daemon thread a bounded number of
items ahead; ``ordered_map`` is the ordered thread pool of the blob
parses and of ``parallel_mapped_batches``, which applies the host map
chain (bucketer, packer, dedup mapper) on --map_workers threads;
``iter_dict_batches`` assembles fixed-shape batches from dict-of-array
chunks (the parsed or cached chunks of both readers). Across hosts
(--dist_mode=2), ``shard_files_for_host`` splits a split's files round
robin and ``synchronized_iterator`` keeps every host's stream to the
same number of batches.
"""

from __future__ import annotations

import queue
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Sequence, TypeVar

import numpy as np

T = TypeVar("T")

_STOP = object()


class Prefetcher(Iterable[T]):
    """Wrap an iterator; a daemon thread keeps ``size`` items ready. An
    exception of the iterator is raised in the consumer; a consumer that
    stops early (graceful shutdown) stops the thread."""

    def __init__(self, it: Iterable[T], size: int = 8):
        self._it = it
        self._size = max(size, 1)

    def __iter__(self) -> Iterator[T]:
        q: "queue.Queue" = queue.Queue(maxsize=self._size)
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> None:
            # a bounded put that notices abandonment: a plain q.put would
            # block forever once the consumer is gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for item in self._it:
                    put(item)
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                put(_STOP)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()


# results held beyond one a worker by an ordered pool map
AHEAD = 2


def ordered_map(fn, items: Iterable, workers: int) -> Iterator:
    """``fn`` over ``items`` on a pool of ``workers`` threads, results in
    order, at most ``workers`` + ``AHEAD`` in flight; inline for one
    worker. A worker's exception is raised in the consumer; a consumer
    that stops early cancels queued work and joins the pool."""
    if workers <= 1:
        for x in items:
            yield fn(x)
        return
    ex = ThreadPoolExecutor(max_workers=workers)
    try:
        pending: deque = deque()
        for x in items:
            pending.append(ex.submit(fn, x))
            if len(pending) > workers + AHEAD:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def parallel_mapped_batches(it: Iterable[T], make_chain, workers: int = 2, pad_rules=None) -> Iterator[T]:
    """Ordered thread-pool map over a batch iterator (--map_workers).

    ``make_chain()`` builds one chain instance (callable batch -> batch)
    per worker slot; batches are mapped on ``ordered_map`` and yielded
    in stream order. The numpy work of the chain and the C++ combine
    release the GIL, so the workers overlap.

    Why this is exact: the chain's content is a function of each batch
    alone (the mapper's positions depend only on that batch's ids); only
    the quarter-pow2 pad widths are stateful, and each worker's chain
    keeps its own ladder. At the ordered output every ``pad_rules`` key
    ({key: sentinel}) is padded on its last axis to the running maximum
    width with its sentinel (vocab for uids, which the device scatter
    drops; 0 for COO and multi-hot arrays, the dead-slot convention), so
    widths never shrink. Widths may differ from a sequential run, the
    function each batch computes does not. Keys absent from a batch are
    skipped."""
    chains: "queue.SimpleQueue" = queue.SimpleQueue()
    for _ in range(max(workers, 1)):
        chains.put(make_chain())

    def apply(b):
        c = chains.get()
        try:
            return c(b)
        finally:
            chains.put(c)

    maxes: dict = {}

    def repad(b):
        if not pad_rules:
            return b
        out = None
        for k, sent in pad_rules.items():
            if k not in b:
                continue
            a = np.asarray(b[k])
            w = a.shape[-1]
            m = maxes[k] = max(maxes.get(k, 0), w)
            if w < m:
                if out is None:
                    out = dict(b)
                out[k] = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, m - w)], constant_values=sent)
        return out if out is not None else b

    for b in ordered_map(apply, it, workers):
        yield repad(b)


def synchronized_iterator(it: Iterable[T], sync_every: int = 16, agree_min=None) -> Iterator[T]:
    """Multi-host-safe batch iterator: every host yields exactly the same
    number of items, so every host dispatches the same number of
    (collective) train steps.

    Without it, unequal per-host shards deadlock: the host with more
    batches dispatches another collective step while the others have
    moved on to the final checkpoint. Hosts agree on min(items buffered)
    every ``sync_every`` items (``agree_min``, by default the host-group
    MIN of parallel/distributed.py).

    Coverage: the stream stops for all hosts when the shortest host's
    whole multi-epoch stream runs out, so the longer hosts lose their
    surplus once over the run, not once an epoch; the dropped buffered
    batches are logged. One host: a plain passthrough."""
    if agree_min is None:
        from tf_repos_tpu_torch.parallel.distributed import host_count, host_min

        if host_count() == 1:
            yield from it
            return

        def agree_min(n: int) -> int:
            return int(host_min(np.int32(n)))

    src = iter(it)
    while True:
        buf: List[T] = []
        exhausted = False
        while len(buf) < sync_every:
            try:
                buf.append(next(src))
            except StopIteration:
                exhausted = True
                break
        # the signal carries both the count and can-continue, so every
        # host makes the same number of agreements (a host exhausted
        # exactly on a window boundary must still stop everyone):
        #   can continue -> sync_every + 1;  exhausted -> len(buf)
        signal = len(buf) if exhausted else sync_every + 1
        agreed = agree_min(signal)
        if agreed > sync_every:  # every host has a full window and more
            yield from buf
            continue
        if len(buf) > agreed:
            print(
                f"INFO: synchronized_iterator: dropping {len(buf) - agreed} "
                f"buffered batch(es) — another host's stream is exhausted "
                f"(coverage = shortest host's stream)"
            )
        yield from buf[:agreed]
        return


def shard_files_for_host(files: Sequence[str], process_index: int, process_count: int) -> List[str]:
    """Round-robin file split over hosts. With fewer files than hosts
    every host reads everything (with a warning): split the data into at
    least as many files as hosts for a true shard."""
    if len(files) < process_count:
        warnings.warn(
            f"shard_files_for_host: only {len(files)} input file(s) for "
            f"{process_count} hosts — every host will read ALL files, so "
            f"each example is trained on {process_count}x per epoch. Split "
            f"the data into >= {process_count} files for a true shard.",
            stacklevel=2,
        )
        return list(files)
    return [f for i, f in enumerate(files) if i % process_count == process_index]


# full-row shuffle permutation cap: below this chunk size the gather is
# cheap (every libsvm chunk is below it: a 16 MiB blob parses to less
# than 3x its bytes, and [64k, 39] cached chunks are ~20 MB, so libsvm
# always takes the JAX LibsvmDataset's one row permutation); above it (padded Ali-CCP
# [64k, 512] x 5 ~ 700 MB) the block shuffle of iter_dict_batches avoids
# copying the dead padding
_FULL_SHUFFLE_CHUNK_BYTES = 128 << 20


def iter_dict_batches(
    chunks,
    *,
    batch_size: int,
    row_key: str,
    nprng=None,
    shuffle: bool = False,
    emit=None,
):
    """Fixed-shape dict batches from dict-of-array chunks (every value has
    the leading row axis; ``row_key`` counts rows). Shuffle: a row
    permutation of each chunk, or for chunks above
    ``_FULL_SHUFFLE_CHUNK_BYTES`` a permutation of batch-aligned row
    blocks after a random phase (the blocks stay zero-copy views; the
    phase is clamped so that at least one full block exists). The
    remainder carries across chunks; the final partial batch is
    zero-padded (mask rows 0). ``emit``
    post-processes each finished batch."""
    B = batch_size
    emit = emit or (lambda d: d)
    pend = None
    for d in chunks:
        n = len(d[row_key])
        row_bytes = sum(
            int(np.asarray(v).dtype.itemsize) * int(np.prod(np.asarray(v).shape[1:], dtype=np.int64))
            for v in d.values()
        )
        if shuffle and n > 1 and n * row_bytes <= _FULL_SHUFFLE_CHUNK_BYTES:
            perm = nprng.permutation(n)
            # mode="clip" selects numpy's unchecked fast gather
            d = {k: np.take(v, perm, axis=0, mode="clip") for k, v in d.items()}
        elif shuffle and n > B:
            phase = int(nprng.integers(0, min(B, n - B + 1)))
            nb = (n - phase) // B
            if nb > 0:
                order = nprng.permutation(nb)
                head = {k: v[:phase] for k, v in d.items()}
                blocks = [{k: v[phase + i * B: phase + (i + 1) * B] for k, v in d.items()}
                          for i in order]
                tail = {k: v[phase + nb * B:] for k, v in d.items()}
                for piece in [head] + blocks + [tail]:
                    m = len(piece[row_key])
                    if m == 0:
                        continue
                    if pend is not None and len(pend[row_key]):
                        take = min(B - len(pend[row_key]), m)
                        pend = {k: np.concatenate([pend[k], piece[k][:take]]) for k in piece}
                        if len(pend[row_key]) == B:
                            yield emit(pend)
                            pend = None
                        piece = {k: v[take:] for k, v in piece.items()}
                        m -= take
                        if m == 0:
                            continue
                    nf = m // B
                    for i in range(nf):
                        yield emit({k: v[i * B: (i + 1) * B] for k, v in piece.items()})
                    if m % B:
                        pend = {k: v[nf * B:] for k, v in piece.items()}
                continue
        start = 0
        if pend is not None and len(pend[row_key]):
            take = min(B - len(pend[row_key]), n)
            merged = {k: np.concatenate([pend[k], d[k][:take]]) for k in d}
            start = take
            pend = None
            if len(merged[row_key]) == B:
                yield emit(merged)
            else:  # a chunk smaller than one batch: keep accumulating
                pend = merged
                continue
        n_full = (n - start) // B
        for i in range(n_full):
            s = slice(start + i * B, start + (i + 1) * B)
            yield emit({k: v[s] for k, v in d.items()})
        rest = slice(start + n_full * B, None)
        pend = {k: v[rest] for k, v in d.items()}
    if pend is not None and len(pend[row_key]):
        pad = B - len(pend[row_key])
        yield emit({
            k: np.pad(np.asarray(v), [(0, pad)] + [(0, 0)] * (np.asarray(v).ndim - 1))
            for k, v in pend.items()
        })
