"""Slim host->device wire format (--slim_transfer): the port's own copy of
the JAX package's data/slim_wire.py. The host side (the encoders) is the
same numpy code and gives the same arrays; the device side (the
decoders) is torch on the batch's device, inside the step.

Criteo libsvm layout. A batch moves feat_ids int32[B,F] + feat_vals
f32[B,F] + label + mask, 320 B an example at F = 39. Under the Criteo
layout most of it is constant: the first ``static_fields`` id columns
are always 1..sf (the continuous fields' fixed ids) and the categorical
vals are always exactly 1.0. The wire carries cont_vals f32[B,sf] and
cat_ids int32[B,F-sf] (+ label, mask): 164 B an example. Padding rows
(mask 0) decode to the zeros the reader emits. The encoder checks the
contract on every batch and raises on a file that breaks it. It composes
with --sparse_table_update: it runs after the dedup mapper, whose remap
keeps position == id for the static prefix and leaves vals alone.

Ali-CCP layout (AliccpSlimEncoder, after the mapper and the --mh_coo
packer). Three kinds of bytes are rebuilt on the device:
  * multi-hot vals that are exactly the live mask (vals == ids > 0),
    committed per field on the first batch and checked on every later
    one; under --mh_coo the COO w likewise, as (idx > 0) (id 0 keeps
    position 0), unless duplicates were combined (w is then a count);
  * id widths: remapped positions are below the uids bucket (raw ids
    below the vocab on unmapped batches), so id fields narrow to uint16
    when that bound fits; the COO idx splits into __mhc_lo (u16 low
    bits) and __mhc_hi (the 17th bit packed by np.packbits, 1 bit a slot,
    while the bound is <= 2^17; a u8 high byte up to 2^24);
  * the COO dest, which the packer's group-major, rows-ascending order
    determines from the live counts per (group, row): the wire carries
    __mhc_cnt u16[nd, G, B] instead, and the dest rebuilt from it is
    checked against the real one on the host for every batch; the label
    alias of y.

    encode_batch / AliccpSlimEncoder   host, numpy (the map chain or the
                                       prefetch thread)
    decode_batch / decode_aliccp_batch device, torch (SlimWireModel)

On a mesh every wire array keeps the example (or, for the COO arrays,
the data-shard) axis first, so each rank takes its slice of the host's
encoded batch (parallel/step.slice_batch) and decodes only that on its
device. Across hosts the Ali-CCP encoder runs uncompressed (no lo/hi
idx split, no dest counts; compress_coo=False) on the prefetch thread,
ahead of the cross-host uid union, which rewrites the idx and re-pads
the dest.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from tf_repos_tpu_torch.data.sparse_batch import (
    MHC_CDEST,
    MHC_CNT,
    MHC_DEST,
    MHC_IDX,
    MHC_W,
    UIDS_PREFIX,
)
from tf_repos_tpu_torch.models.base import Batch, CtrModel
from tf_repos_tpu_torch.ops.embedding import dense_lookup

CONT_VALS = "__slim_cont_vals"
CAT_IDS = "__slim_cat_ids"
MHC_LO = "__mhc_lo"
MHC_HI = "__mhc_hi"

ALICCP_VAL_GROUPS = ("u_cat", "u_shop", "u_brand", "u_int")
ALICCP_ID_FIELDS = (
    "feat_ids", "a_catids", "a_shopids", "a_brandids", "a_intids",
    "u_catids", "u_shopids", "u_brandids", "u_intids",
)
_U16_MAX = np.iinfo(np.uint16).max


# ------------------------------------------------------------ Criteo wire
def encode_batch(batch: Dict[str, np.ndarray], sf: int) -> Dict[str, np.ndarray]:
    """Full libsvm batch -> slim wire batch (host side), checking the
    Criteo layout row by row against the mask."""
    ids = np.asarray(batch["feat_ids"])
    vals = np.asarray(batch["feat_vals"])
    mask = np.asarray(batch["mask"]) if "mask" in batch else np.ones(ids.shape[0], np.float32)
    valid = mask > 0

    static_ids = np.arange(1, sf + 1, dtype=ids.dtype)
    want_ids = np.where(valid[:, None], static_ids[None, :], 0)
    if not np.array_equal(ids[:, :sf], want_ids):
        raise ValueError(
            "--slim_transfer: feat_ids[:, :static_fields] are not the "
            "constant 1..sf Criteo continuous-field ids (see "
            "features/criteo.py layout); this input file does not match "
            "the --static_fields contract"
        )
    want_vals = valid.astype(vals.dtype)[:, None]
    if not np.array_equal(vals[:, sf:], np.broadcast_to(want_vals, vals[:, sf:].shape)):
        raise ValueError(
            "--slim_transfer: feat_vals[:, static_fields:] are not all "
            "exactly 1.0 (categorical '<id>:1' emission); this input "
            "file does not match the Criteo layout"
        )

    out = {k: v for k, v in batch.items() if k not in ("feat_ids", "feat_vals")}
    out[CONT_VALS] = np.ascontiguousarray(vals[:, :sf])
    out[CAT_IDS] = np.ascontiguousarray(ids[:, sf:])
    return out


def decode_batch(batch: Batch, sf: int) -> Batch:
    """Slim wire batch -> full batch, on the batch's device; a full batch
    passes through."""
    if CONT_VALS not in batch:
        return batch
    cont_vals, cat_ids = batch[CONT_VALS], batch[CAT_IDS]
    b = cat_ids.shape[0]
    mask = batch.get("mask")
    valid = (mask > 0) if mask is not None else torch.ones(b, dtype=torch.bool, device=cat_ids.device)
    static_ids = torch.arange(1, sf + 1, dtype=cat_ids.dtype, device=cat_ids.device)
    static_ids = torch.where(valid[:, None], static_ids[None, :], 0)
    cat_vals = valid.to(cont_vals.dtype)[:, None].expand(b, cat_ids.shape[1])
    out = {k: v for k, v in batch.items() if k not in (CONT_VALS, CAT_IDS)}
    out["feat_ids"] = torch.cat([static_ids, cat_ids], dim=1)
    out["feat_vals"] = torch.cat([cont_vals, cat_vals], dim=1)
    return out


def encoding_batches(it, sf: int):
    """A batch iterator through the Criteo encoder."""
    for b in it:
        yield encode_batch(b, sf)


# ----------------------------------------------------------- Ali-CCP wire
class SharedWireState:
    """The first-batch wire decisions, shared by the encoders of one
    stream's --map_workers pool. Without it each worker commits its own
    first batch (a droppable verdict one worker contradicts later fails
    the run) and picks the idx form from its own mapper's bucket (the key
    set would alternate between batches). The committing batch is
    whichever worker takes the lock first; either verdict stays correct."""

    def __init__(self):
        self.lock = threading.Lock()
        self.drop: Optional[Dict[str, bool]] = None
        self.drop_w: Optional[bool] = None
        self.cnt_ok: Optional[bool] = None
        self.bound: int = 0  # the running max id bound (sets the idx form)


class AliccpSlimEncoder:
    """The Ali-CCP encoder (host side; after the dedup mapper and the
    --mh_coo packer, whose outputs it narrows).

    vocab: the id bound of unmapped batches (cfg.feature_size).
    compress_coo: the lo/hi idx split and the dest counts (single process).
    n_groups: the packer's group count (0: no COO stream).
    shared: one SharedWireState for the encoders of a --map_workers pool.
    drop_w_ok: False under --mh_coo_combine, where w is a count: the COO w
    is then committed as non-droppable up front."""

    def __init__(self, vocab: int, compress_coo: bool = True, n_groups: int = 0,
                 shared: Optional[SharedWireState] = None, drop_w_ok: bool = True):
        self.vocab = int(vocab)
        self.compress_coo = bool(compress_coo)
        self.n_groups = int(n_groups)
        self._shared = shared if shared is not None else SharedWireState()
        self._narrow_dest: Optional[bool] = None
        if not drop_w_ok:
            self._shared.drop_w = False

    def _commit(self, attr: str, value_fn):
        """The shared first-batch decision ``attr``, made once under the lock."""
        if getattr(self._shared, attr) is None:
            with self._shared.lock:
                if getattr(self._shared, attr) is None:
                    setattr(self._shared, attr, value_fn())
        return getattr(self._shared, attr)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        batch = dict(batch)
        batch.pop("label", None)  # alias of y, rebuilt on the device

        # ---- multi-hot vals (padded layout): drop the binary ones
        present = [f for f in ALICCP_VAL_GROUPS if f + "vals" in batch]
        drop = self._commit("drop", lambda: {
            f: bool(np.array_equal(np.asarray(batch[f + "vals"]),
                                   (np.asarray(batch[f + "ids"]) > 0).astype(np.float32)))
            for f in present
        })
        for f in present:
            if not drop.get(f, False):
                continue
            ids = np.asarray(batch[f + "ids"])
            vals = np.asarray(batch.pop(f + "vals"))
            if not np.array_equal(vals, (ids > 0).astype(np.float32)):
                raise ValueError(
                    f"--slim_transfer: {f}vals stopped being the binary "
                    "live mask mid-run (first batch committed it as "
                    "droppable); this input mixes real-valued and binary "
                    "batches for the field — disable --slim_transfer"
                )

        # ---- COO w (--mh_coo): rebuilt on the device as (idx > 0)
        if MHC_W in batch:
            w = np.asarray(batch[MHC_W])
            live = (np.asarray(batch[MHC_IDX]) > 0).astype(np.float32)
            if self._commit("drop_w", lambda: bool(np.array_equal(w, live))):
                if not np.array_equal(w, live):
                    raise ValueError(
                        "--slim_transfer: __mhc_w stopped being the binary "
                        "live mask mid-run; disable --slim_transfer"
                    )
                del batch[MHC_W]

        # ---- id narrowing: positions < the uids bucket (mapped batches)
        # or raw ids < vocab; the form follows the pool's running max bound
        uids_keys = [k for k in batch if k.startswith(UIDS_PREFIX)]
        bound = min(batch[k].shape[-1] for k in uids_keys) if uids_keys else self.vocab
        with self._shared.lock:
            self._shared.bound = max(self._shared.bound, int(bound))
            bound = self._shared.bound

        # ---- dest -> live counts per (group, row), before the idx split
        # (the raw idx's nonzero prefix is the live extent)
        if (self.compress_coo and self.n_groups > 0 and MHC_DEST in batch
                and MHC_IDX in batch and "y" in batch):
            self._counts(batch)

        if bound <= _U16_MAX:
            for f in ALICCP_ID_FIELDS:
                if f in batch:
                    batch[f] = np.asarray(batch[f]).astype(np.uint16)
            if MHC_IDX in batch:
                batch[MHC_IDX] = np.asarray(batch[MHC_IDX]).astype(np.uint16)
        elif self.compress_coo and MHC_IDX in batch:
            idx = np.asarray(batch[MHC_IDX])
            if bound <= (1 << 17):
                batch[MHC_LO] = (idx & 0xFFFF).astype(np.uint16)
                batch[MHC_HI] = np.packbits((idx >> 16).astype(np.uint8), axis=-1)
                del batch[MHC_IDX]
            elif bound <= (1 << 24):
                batch[MHC_LO] = (idx & 0xFFFF).astype(np.uint16)
                batch[MHC_HI] = (idx >> 16).astype(np.uint8)
                del batch[MHC_IDX]
        if MHC_DEST in batch:
            dest = np.asarray(batch[MHC_DEST])
            if self._narrow_dest is None:
                # dest < B * n_groups, fixed for a run
                self._narrow_dest = bool(dest.max(initial=0) <= _U16_MAX)
            if self._narrow_dest:
                batch[MHC_DEST] = dest.astype(np.uint16)
        return batch

    def _counts(self, batch: Dict[str, np.ndarray]) -> None:
        """Replace dest by the live counts when it is the packer's
        group-major order (checked per batch; the first batch commits the
        form), else drop the packer's counts and compact stream so the
        model keeps the dest formulation."""
        dest = np.asarray(batch[MHC_DEST])
        idx_raw = np.asarray(batch[MHC_IDX])
        ngr = self.n_groups
        nd = dest.shape[0]
        n = int(np.asarray(batch["y"]).shape[0])
        bs = n // max(nd, 1)
        ok = bs * nd == n
        cnts = np.zeros((nd, ngr, bs), np.uint16)
        dv = (np.arange(bs, dtype=np.int64)[None, :] * ngr
              + np.arange(ngr, dtype=np.int64)[:, None]).reshape(-1)
        for s in range(nd if ok else 0):
            nlive = int(np.flatnonzero(idx_raw[s]).max(initial=-1)) + 1
            d = dest[s, :nlive].astype(np.int64)
            key = (d % ngr) * bs + d // ngr
            c = np.bincount(key, minlength=ngr * bs)
            if (np.any(np.diff(key) < 0) or c.max(initial=0) > _U16_MAX or c.size != ngr * bs
                    or not np.array_equal(np.repeat(dv, c), d) or np.any(dest[s, nlive:])):
                ok = False
                break
            cnts[s] = c.astype(np.uint16).reshape(ngr, bs)
        if self._commit("cnt_ok", lambda: ok):
            if not ok:
                raise ValueError(
                    "--slim_transfer: the COO dest stream stopped "
                    "matching the packer's field-major order mid-run "
                    "(first batch committed the counts form); "
                    "disable --slim_transfer"
                )
            batch[MHC_CNT] = cnts
            del batch[MHC_DEST]
            batch.pop(MHC_CDEST, None)  # DIN rebuilds it from the counts
        else:
            batch.pop(MHC_CNT, None)
            batch.pop(MHC_CDEST, None)


def _unpack_bits(packed: torch.Tensor, count: int) -> torch.Tensor:
    """np.unpackbits(packed, axis=-1, count=count): big-endian bits."""
    shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :count]


def _dest_from_counts(cnt: torch.Tensor, m: int) -> torch.Tensor:
    """[nd, G, B] live counts -> int32[nd, m] dest (b * G + g per slot, in
    the packer's group-major order; 0 past the live count). The tail
    takes the remaining count, so the output size is known without a
    host sync."""
    nd, ngr, bs = cnt.shape
    dv = (torch.arange(bs, dtype=torch.int32, device=cnt.device)[None, :] * ngr
          + torch.arange(ngr, dtype=torch.int32, device=cnt.device)[:, None]).reshape(-1)
    dv = torch.cat([dv, dv.new_zeros(1)])
    out = []
    for s in range(nd):
        cf = cnt[s].reshape(-1)
        reps = torch.cat([cf, (m - cf.sum()).reshape(1).to(cf.dtype)])
        out.append(torch.repeat_interleave(dv, reps, output_size=m))
    return torch.stack(out)


def decode_aliccp_batch(batch: Batch) -> Batch:
    """Ali-CCP slim wire -> full batch, keyed off the batch's structure:
    uint16 tensors widen to int32, the split idx joins, absent vals and
    w rebuild from the live mask, dest from the counts (which stay in the
    batch for DIN's compact segment stream), the label alias from y. A
    full batch passes through."""
    out = {k: (v.to(torch.int32) if v.dtype == torch.uint16 else v) for k, v in batch.items()}
    if MHC_LO in out:
        lo, hi = out.pop(MHC_LO), out.pop(MHC_HI)
        m = lo.shape[-1]
        if hi.shape[-1] != m:  # the bit-packed 17th bit
            hi = _unpack_bits(hi, m)
        out[MHC_IDX] = lo | (hi.to(torch.int32) << 16)
    if MHC_CNT in out and MHC_DEST not in out:
        out[MHC_CNT] = out[MHC_CNT].to(torch.int32)
        out[MHC_DEST] = _dest_from_counts(out[MHC_CNT], out[MHC_IDX].shape[-1])
    for f in ALICCP_VAL_GROUPS:
        if f + "ids" in out and f + "vals" not in out:
            out[f + "vals"] = (out[f + "ids"] > 0).to(torch.float32)
    if MHC_IDX in out and MHC_W not in out:
        out[MHC_W] = (out[MHC_IDX] > 0).to(torch.float32)
    if "label" not in out and "y" in out:
        out["label"] = out["y"]
    return out


def aliccp_encoding_batches(it, vocab: int, compress_coo: bool = True, n_groups: int = 0,
                            drop_w_ok: bool = True):
    """A batch iterator through one Ali-CCP encoder (its first batch
    commits the wire contract for the stream)."""
    enc = AliccpSlimEncoder(vocab, compress_coo=compress_coo, n_groups=n_groups,
                            drop_w_ok=drop_w_ok)
    for b in it:
        yield enc(b)


class SlimWireModel(CtrModel):
    """Decodes the slim wire batch on the device, then runs the wrapped
    model: apply, loss, per_example_loss and eval_metrics see the full
    batch (the eval and predict steps hand the latter two the raw wire
    batch; decoding a full batch is the identity). Everything else is the
    wrapped model's."""

    def __init__(self, inner: CtrModel, decode=None):
        super().__init__(inner.cfg)
        self.inner = inner
        self.name = inner.name
        self.flat_table = inner.flat_table
        sf = inner.cfg.static_fields
        self._decode = decode if decode is not None else (lambda b: decode_batch(b, sf))

    def apply(self, params, state, batch, *, train, generator=None, lookup=dense_lookup):
        return self.inner.apply(params, state, self._decode(batch), train=train,
                                generator=generator, lookup=lookup)

    def loss(self, params, state, batch, *, train, generator=None, lookup=dense_lookup):
        # the wrapped model's own loss (ESMM's joint loss, for one)
        return self.inner.loss(params, state, self._decode(batch), train=train,
                               generator=generator, lookup=lookup)

    def per_example_loss(self, out, batch):
        return self.inner.per_example_loss(out, self._decode(batch))

    def eval_metrics(self, out, batch):
        return self.inner.eval_metrics(out, self._decode(batch))

    def init(self, generator):
        return self.inner.init(generator)

    def l2_loss(self, params):
        return self.inner.l2_loss(params)

    def sparse_slots(self):
        return self.inner.sparse_slots()

    def mh_coo_groups(self):
        return self.inner.mh_coo_groups()

    def coo_combine_ok(self) -> bool:
        return self.inner.coo_combine_ok()

    def wants_sorted_seg(self) -> bool:
        return self.inner.wants_sorted_seg()

    def wants_sorted_aux(self) -> bool:
        return self.inner.wants_sorted_aux()

    @property
    def prediction_keys(self):
        return self.inner.prediction_keys
