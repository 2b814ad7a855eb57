"""Host-side batch preparation for the lazy sparse-table path (the port's
own copy of the JAX package's data/sparse_batch.py: the dedup mapper,
the multi-hot COO packer, the multi-hot width bucketer and
quarter_pow2). Host numpy, and the C++ duplicate combine of
data/native.py under --mh_coo_combine.

For each sparse table (model.sparse_slots()) the mapper computes the
batch's unique id set and rewrites the batch:

  batch["__uids_<table>"]  int32[S_pad]  unique ids, ascending, padded
                                         with the sentinel `vocab`
  batch[<id field>]        remapped to positions into __uids_<table>

The dedup is an O(V + N) flag array, not a sort; the scratch arrays are
allocated once and reused.

Under --mh_coo, MhCooPacker runs first: it replaces the padded
multi-hot fields by a COO triplet of their live slots (``__mhc_idx``,
``__mhc_dest``, ``__mhc_w``, see the class), and the mapper then remaps
``__mhc_idx`` (and the run rows ``__mhc_srows``) with the table's other
id fields. Under --mh_bucket, MhPadBucketer slices the padded multi-hot
fields to the batch's live width before either runs. Across hosts
(--dist_mode=2), GlobalUidsUnion turns each host's mapped batch into
the global one's positions (a host collective, on the main thread)."""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np

UIDS_PREFIX = "__uids_"

MHC_IDX = "__mhc_idx"
MHC_DEST = "__mhc_dest"
MHC_W = "__mhc_w"
# live slots per (group, row), int32[1, n_groups, B], in the packer's
# group-major emission order
MHC_CNT = "__mhc_cnt"
# compact segment of each live slot (the running count of non-empty
# (group, row) bags), int32[1, M_pad]: nondecreasing with steps <= 1 over
# the live prefix, 0 on the padding -- the sorted-stream kernels' index
# stream (ops/sorted_seg.py; DIN attention)
MHC_CDEST = "__mhc_cdest"
# the idx-sorted auxiliary stream (DIN's --coo_sorted_bwd): perm, the
# stable idx-ascending order of the live slots, int32[1, M_pad]; cidx,
# the run (distinct idx) of each sorted position, nondecreasing with
# steps <= 1, int32[1, M_pad]; srows, the table id of each run,
# int32[1, Su_pad] (the mapper remaps it like __mhc_idx; the remap is
# monotonic, so order and runs survive). All pad with 0; the device
# masks sorted positions >= the live count.
MHC_PERM = "__mhc_perm"
MHC_CIDX = "__mhc_cidx"
MHC_SROWS = "__mhc_srows"


class SparseBatchMapper:
    """pad_mode:
      "pow2" (default): S_pad on the quarter-pow2 ladder holding the
        batch's actual unique count, growing monotonically across batches;
      "pow2:<floor>": the same, starting every bucket at <floor>;
      "max": the static worst case (total id slots + 1)."""

    def __init__(self, slots: Dict[str, "SparseSlot"], pad_mode: str = "pow2"):
        floor = 0
        if pad_mode.startswith("pow2:"):
            pad_mode, floor = "pow2", int(pad_mode.split(":", 1)[1])
        if pad_mode not in ("pow2", "max"):
            raise ValueError(f"pad_mode {pad_mode!r} not in ('pow2', 'max', 'pow2:<floor>')")
        self.slots = slots
        self.pad_mode = pad_mode
        self._seen: Dict[str, np.ndarray] = {}
        self._remap: Dict[str, np.ndarray] = {}
        self._bucket: Dict[str, int] = {n: floor for n in slots} if floor else {}

    def _s_pad(self, name: str, vocab: int, total_slots: int, uniq: int) -> int:
        if self.pad_mode == "max":
            return min(max(total_slots + 1, uniq), vocab)
        bucket = max(self._bucket.get(name, 0), quarter_pow2(uniq))
        bucket = min(bucket, vocab)
        bucket = max(bucket, uniq)  # a vocab-capped bucket must still fit
        self._bucket[name] = bucket
        return bucket

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        batch = dict(batch)
        for name, slot in self.slots.items():
            vocab = slot.vocab
            seen = self._seen.get(name)
            if seen is None:
                seen = self._seen.setdefault(name, np.zeros(vocab, np.bool_))
                self._remap.setdefault(name, np.zeros(vocab, np.int32))
            remap = self._remap[name]
            seen.fill(False)

            # fields the packer consumed are absent; their live ids ride
            # the COO idx stream, which joins this slot's remap set (dead
            # padding slots carry id 0, which is always seeded, so the
            # unique set is the same either way)
            present = [f for f in slot.fields if f in batch]
            fields = [np.asarray(batch[f]) for f in present]
            coo_owned = MHC_IDX in batch and len(present) < len(slot.fields)
            if coo_owned:
                present.append(MHC_IDX)
                fields.append(np.asarray(batch[MHC_IDX]))
            ids = np.concatenate([a.ravel() for a in fields])
            # id 0 (padding) and ids 1..static are always in the set, so
            # position == id for the whole static block
            seen[: slot.static + 1] = True
            seen[ids] = True
            u = np.flatnonzero(seen)  # ascending unique
            remap[u] = np.arange(u.size, dtype=np.int32)

            total_slots = sum(int(a.size) for a in fields) + 1
            s_pad = self._s_pad(name, vocab, total_slots, int(u.size))
            uids = np.full(s_pad, vocab, np.int32)
            uids[: u.size] = u
            batch[UIDS_PREFIX + name] = uids
            for f, arr in zip(present, fields):
                batch[f] = np.take(remap, arr, mode="clip")
            if coo_owned and MHC_SROWS in batch:
                # the run rows hold raw ids of the COO idx stream (padding
                # 0 -> row 0, masked off on the device)
                batch[MHC_SROWS] = np.take(remap, batch[MHC_SROWS], mode="clip")
        return batch


def mapped_batches(it: Iterable, mapper) -> Iterator:
    for b in it:
        yield mapper(b)


def quarter_pow2(m: int) -> int:
    """Smallest value >= m on the quarter-pow2 ladder {h, 1.25h, 1.5h,
    1.75h, 2h} (h a power of two): padding waste is at most 25%."""
    m = int(m)
    if m <= 1:
        return 1
    p = 1 << (m - 1).bit_length()
    q = p >> 3  # h/4
    if q:
        h = p >> 1
        for c in (h + q, h + 2 * q, h + 3 * q):
            if m <= c:
                return c
    return p


def combine_dups(a: np.ndarray, v: Optional[np.ndarray] = None, use_native: bool = True):
    """Combine duplicate ids within each row of a padded multi-hot field
    [B, P] (live slots: id > 0). Returns (ids int32, weights f32, counts
    per row int32), rows ascending and ids in first-seen order within a
    row, as the JAX package's native combine emits them. v=None weighs
    each occurrence 1.0; otherwise the weights of duplicate (row, id)
    pairs are summed, which is exact for sum combiners up to float
    summation order.

    use_native=True runs the C++ per-row hash (data/native.py; it adds in
    f32 in slot order, rounding once an addend); use_native=False the
    plain numpy version, which sums in f64 and rounds once, so the two
    weights may differ in their last bits."""
    if use_native:
        from tf_repos_tpu_torch.data import native

        return native.combine_dups(a, v)
    b, p = a.shape
    fa = a.reshape(-1)
    lv = np.flatnonzero(fa > 0)
    w = v.reshape(-1)[lv].astype(np.float32) if v is not None else np.ones(lv.size, np.float32)
    key = ((lv // p).astype(np.int64) << 32) | fa[lv].astype(np.int64)
    uk, first, inv = np.unique(key, return_index=True, return_inverse=True)
    wc = np.bincount(inv.reshape(-1), weights=w, minlength=uk.size).astype(np.float32)
    # the slots are row-major, so the order of first occurrence is rows
    # ascending, then first-seen within a row
    order = np.argsort(first, kind="stable")
    ids_c = (uk[order] & 0xFFFFFFFF).astype(np.int32)
    cnt = np.bincount((uk >> 32).astype(np.int64), minlength=b).astype(np.int32)
    return ids_c, wc[order], cnt


class MhPadBucketer:
    """Slice padded multi-hot fields to the batch's live width (--mh_bucket).

    The reader pads every multi-hot field to --multi_hot_pad, while true
    Ali-CCP lengths are mostly far shorter; everything downstream of a
    padded field (its embedding expand, DIN's attention MLP over
    [B, pad, 3K]) costs in proportion to the padded width. This bucketer
    slices each field to a per-field quarter-pow2 bucket of the batch's
    last live column (growing monotonically across batches;
    "pow2:<floor>" starts every bucket at <floor>).

    Exact: a column is dropped only where every row has id 0, and id-0
    slots are dead (the models mask ids > 0). The live width comes from
    id positions (the last nonzero column), so right-padded and
    interleaved layouts are both safe.

    pairs: ((ids_field, vals_field | None), ...); vals are sliced with
    their ids."""

    def __init__(self, pairs, mode: str = "pow2"):
        floor = 0
        if mode.startswith("pow2:"):
            mode, floor = "pow2", int(mode.split(":", 1)[1])
        if mode != "pow2":
            raise ValueError(f"--mh_bucket {mode!r} not in ('off', 'pow2', 'pow2:<floor>')")
        self.pairs = tuple(pairs)
        self._bucket: Dict[str, int] = {ids: max(floor, 1) for ids, _ in self.pairs}

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        batch = dict(batch)
        for ids_f, vals_f in self.pairs:
            if ids_f not in batch:
                continue
            a = np.asarray(batch[ids_f])
            p = a.shape[-1]
            live_cols = (a != 0).any(axis=tuple(range(a.ndim - 1)))
            width = int(p - np.argmax(live_cols[::-1])) if live_cols.any() else 0
            bucket = min(max(self._bucket[ids_f], quarter_pow2(width)), p)
            self._bucket[ids_f] = bucket
            if bucket < p:
                batch[ids_f] = a[..., :bucket]
                if vals_f and vals_f in batch:
                    batch[vals_f] = np.asarray(batch[vals_f])[..., :bucket]
        return batch


class MhCooPacker:
    """Padded multi-hot groups -> COO triplet of their live slots (--mh_coo).

    groups: ((field, has_vals), ...) in pooled-output order. The packer
    pops each group's padded ``<field>ids`` (and ``<field>vals``) and adds

      __mhc_idx  int32[D, M_pad]  table id of the slot (the mapper remaps
                                  it to a position into __uids_<table>)
      __mhc_dest int32[D, M_pad]  pooled row = b_local * n_groups + g
      __mhc_w    f32[D, M_pad]    vals (val-bearing groups) or 1.0
      __mhc_cnt  int32[D, n_groups, B/D]  live slots per (group, row)

    Slots are emitted group-major, rows ascending, so each (group, row)
    bag is contiguous. Groups may have different widths (--mh_bucket
    slices each field on its own). M_pad grows monotonically over the
    quarter-pow2 ladder from ``floor``; padding entries are idx = dest =
    0, w = 0 and add zero into pooled row 0. The leading axis is the
    JAX package's data-shard axis: D = n_data = 1 on one device; under a
    mesh each data shard gets its own COO row over its B/D batch rows
    (dest local to them), M_pad shared across shards.

    combine=True sums the weights of duplicate (row, id) pairs per group
    first (combine_dups, the C++ combine unless use_native=False), exact
    for sum-pooling consumers only (the harness gates it on
    model.coo_combine_ok()).

    cdest_aux=True adds __mhc_cdest, the compact segment stream of the
    sorted-stream kernels (DIN attention); sorted_aux=True adds the
    idx-sorted stream __mhc_perm, __mhc_cidx, __mhc_srows (DIN's
    --coo_sorted_bwd), whose Su_pad grows monotonically over the
    quarter-pow2 ladder from 512. Both default to off (the JAX package
    defaults cdest_aux on; its harness, like the port's, passes both)."""

    def __init__(self, groups, floor: int = 1024, combine: bool = False,
                 cdest_aux: bool = False, sorted_aux: bool = False, use_native: bool = True,
                 n_data: int = 1):
        if not groups:
            raise ValueError("--mh_coo: model declares no multi-hot groups")
        self.groups = tuple(groups)
        self.n_data = max(int(n_data), 1)
        self.combine = bool(combine)
        self.use_native = use_native
        self.cdest_aux = bool(cdest_aux)
        self.sorted_aux = bool(sorted_aux)
        self._bucket = max(int(floor), 1)
        self._sbucket = 512

    def _pack(self, parts):
        """One data shard's live slots: (idx, dest, w, cnt[n_groups, b])."""
        ngr = len(self.groups)
        idx_parts, dest_parts, w_parts = [], [], []
        cnt = None
        for g, ((f, has_vals), (a, v)) in enumerate(zip(self.groups, parts)):
            b, p = a.shape
            if cnt is None:
                cnt = np.zeros((ngr, b), np.int32)
            if self.combine:
                ic, wc, cr = combine_dups(a, v, use_native=self.use_native)
                rows = np.repeat(np.arange(b, dtype=np.int64), cr)
            else:
                fa = a.reshape(-1)
                lv = np.flatnonzero(fa > 0)
                ic = fa[lv]
                wc = (v.reshape(-1)[lv].astype(np.float32) if has_vals
                      else np.ones(lv.size, np.float32))
                rows = lv // p
                cr = np.bincount(rows, minlength=b)
            idx_parts.append(ic)
            dest_parts.append((rows * ngr + g).astype(np.int32))
            w_parts.append(wc)
            cnt[g] = cr
        return (np.concatenate(idx_parts), np.concatenate(dest_parts),
                np.concatenate(w_parts), cnt)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        batch = dict(batch)
        groups = []
        for f, has_vals in self.groups:
            a = np.asarray(batch.pop(f + "ids"))
            groups.append((a, np.asarray(batch.pop(f + "vals")) if has_vals else None))
        b, nd = groups[0][0].shape[0], self.n_data
        if b % nd:
            raise ValueError(
                f"--mh_coo: batch size {b} not divisible by the data-mesh size {nd}"
            )
        bs = b // nd
        packed = [self._pack([(a[s * bs:(s + 1) * bs], None if v is None else v[s * bs:(s + 1) * bs])
                              for a, v in groups]) for s in range(nd)]
        self._bucket = max(self._bucket, quarter_pow2(max(x[0].size for x in packed)))
        idx = np.zeros((nd, self._bucket), np.int32)
        dest = np.zeros((nd, self._bucket), np.int32)
        w = np.zeros((nd, self._bucket), np.float32)
        for s, (ic, dc, wc, _) in enumerate(packed):
            idx[s, : ic.size], dest[s, : ic.size], w[s, : ic.size] = ic, dc, wc
        cnt = np.stack([x[3] for x in packed])
        batch[MHC_IDX], batch[MHC_DEST], batch[MHC_W], batch[MHC_CNT] = idx, dest, w, cnt
        if self.cdest_aux:
            cdest = np.zeros((nd, self._bucket), np.int32)
            for s in range(nd):
                cf = cnt[s].reshape(-1)
                c_of = (np.cumsum(cf > 0) - 1).astype(np.int32)
                live = np.repeat(np.maximum(c_of, 0), cf)
                cdest[s, : live.size] = live
            batch[MHC_CDEST] = cdest
        if self.sorted_aux:
            perm = np.zeros((nd, self._bucket), np.int32)
            cidx = np.zeros((nd, self._bucket), np.int32)
            runs_per = []
            for s, (ic, _, _, _) in enumerate(packed):
                m = ic.size
                order = np.argsort(idx[s, :m], kind="stable").astype(np.int32)
                si = idx[s, :m][order]
                runs = np.zeros(0, np.int32)
                if m:
                    starts = np.empty(m, np.bool_)
                    starts[0] = True
                    starts[1:] = si[1:] != si[:-1]
                    cidx[s, :m] = (np.cumsum(starts) - 1).astype(np.int32)
                    runs = si[starts]
                perm[s, :m] = order
                runs_per.append(runs)
            self._sbucket = max(self._sbucket, quarter_pow2(max(r.size for r in runs_per)))
            srows = np.zeros((nd, self._sbucket), np.int32)
            for s, runs in enumerate(runs_per):
                srows[s, : runs.size] = runs
            batch[MHC_PERM], batch[MHC_CIDX], batch[MHC_SROWS] = perm, cidx, srows
        return batch


class GlobalUidsUnion:
    """The cross-host uid union (--dist_mode=2): each host's mapper dedups
    only its own batch, but the sharded lazy step replicates the global
    unique-id set on every rank (parallel/sparse_step.py). The union
    exchanges the local sets (two host all-gathers a table: the counts,
    then the sentinel-padded arrays), takes their union with the mapper's
    O(V) flag array, and rewrites the already-remapped id fields from
    local positions to global ones (both sets ascending: a searchsorted
    over the local real uids gives the translation). Under the slim wire
    that includes its cat-id block (the static prefix keeps position ==
    id: every local set holds it), and under --mh_coo the COO idx of the
    table that owns the packed fields. The idx-sorted aux stream is
    dropped (its run rows would need the same rewrite and a cross-host
    bucket), so --coo_sorted_bwd takes the plain packed accumulate across
    hosts. The COO arrays are re-padded with zeros to the cross-host
    bucket (monotonic), and the --mh_bucket widths (``bucketed_pairs``)
    to theirs with one vector all-gather.

    It issues collectives, so it runs on the main thread, in the same
    batch order on every rank (the harness's _place), never on a
    prefetch or --map_workers thread, whose calls would interleave with
    the step's collectives. Every bucket is a function of the (same)
    global counts and the (same) history, so every host gets the same
    shapes. ``allgather`` (x -> [H, *x.shape]) defaults to
    parallel/distributed.host_allgather."""

    def __init__(self, slots: Dict[str, "SparseSlot"], bucketed_pairs=(), allgather=None):
        if allgather is None:
            from tf_repos_tpu_torch.parallel.distributed import host_allgather as allgather
        self.slots = slots
        self._allgather = allgather
        self._bucket: Dict[str, int] = {}
        self._seen: Dict[str, np.ndarray] = {}
        self._coo_bucket = 0
        self.bucketed_pairs = tuple(bucketed_pairs)
        self._mh_width: Dict[str, int] = {ids: 0 for ids, _ in self.bucketed_pairs}

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        from tf_repos_tpu_torch.data.slim_wire import CAT_IDS

        gather = self._allgather
        batch = dict(batch)
        for name, slot in self.slots.items():
            key = UIDS_PREFIX + name
            local = np.asarray(batch[key])
            m = int(np.asarray(gather(np.int32(local.shape[0]))).max())
            padded = np.full(m, slot.vocab, np.int32)
            padded[: local.shape[0]] = local
            all_u = np.asarray(gather(padded)).ravel()

            seen = self._seen.get(name)
            if seen is None:
                seen = self._seen.setdefault(name, np.zeros(slot.vocab, np.bool_))
            seen.fill(False)
            seen[all_u[all_u < slot.vocab]] = True
            g = np.flatnonzero(seen).astype(np.int32)

            # the mapper's quarter-pow2 ladder on the global count
            bucket = max(self._bucket.get(name, 0), quarter_pow2(int(g.size)))
            bucket = min(bucket, slot.vocab)
            bucket = max(bucket, int(g.size))
            self._bucket[name] = bucket

            guids = np.full(bucket, slot.vocab, np.int32)
            guids[: g.size] = g
            n_real = int((local < slot.vocab).sum())
            lp2gp = np.zeros(max(local.shape[0], 1), np.int32)
            lp2gp[:n_real] = np.searchsorted(g, local[:n_real]).astype(np.int32)
            coo_owned = False
            for f in slot.fields:
                if f in batch:
                    batch[f] = np.take(lp2gp, batch[f], mode="clip")
                elif f == "feat_ids" and CAT_IDS in batch:
                    batch[CAT_IDS] = np.take(lp2gp, batch[CAT_IDS], mode="clip")
                elif MHC_IDX in batch:
                    # --mh_coo popped the padded multi-hot fields: their
                    # live slots are the COO idx (remapped once, for the
                    # table that owns the packed fields)
                    coo_owned = True
            if coo_owned:
                batch[MHC_IDX] = np.take(lp2gp, batch[MHC_IDX], mode="clip")
                for k in (MHC_PERM, MHC_CIDX, MHC_SROWS):
                    batch.pop(k, None)
            batch[key] = guids
        if MHC_IDX in batch:
            # the cross-host COO bucket: zero padding (idx = dest = 0,
            # w = 0) adds exactly zero into pooled row 0
            sizes = np.asarray(gather(np.int32(batch[MHC_IDX].shape[-1])))
            self._coo_bucket = max(self._coo_bucket, int(sizes.max()))
            target = self._coo_bucket
            for k in (MHC_IDX, MHC_DEST, MHC_W, MHC_CDEST, MHC_PERM, MHC_CIDX):
                if k in batch and batch[k].shape[-1] < target:
                    a = np.asarray(batch[k])
                    batch[k] = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, target - a.shape[-1])])
        present = [(ids_f, vals_f) for ids_f, vals_f in self.bucketed_pairs if ids_f in batch]
        if present:
            # the --mh_bucket widths (absent under --mh_coo, which popped
            # the padded fields): one vector all-gather for every field
            local_w = np.asarray([batch[ids_f].shape[-1] for ids_f, _ in present], np.int32)
            widths = np.asarray(gather(local_w)).reshape(-1, local_w.size)
            for (ids_f, vals_f), wmax in zip(present, widths.max(axis=0)):
                self._mh_width[ids_f] = max(self._mh_width[ids_f], int(wmax))
                target = self._mh_width[ids_f]
                for k in (ids_f, vals_f):
                    if k and k in batch and batch[k].shape[-1] < target:
                        a = np.asarray(batch[k])
                        batch[k] = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, target - a.shape[-1])])
        return batch
