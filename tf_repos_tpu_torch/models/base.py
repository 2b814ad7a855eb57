"""Model protocol (counterpart of the JAX package's models/base.py).

A model is a small config-bound object with functions on plain dicts of
tensors in the JAX package's layout:

  init(generator)                      -> (params, state)   on the CPU
  apply(params, state, batch, train,
        generator, lookup)             -> (outputs, new_state)
  loss(params, state, batch, train,
       generator, lookup)              -> (scalar, (outputs, new_state))

``lookup`` is the embedding lookup: a plain gather by default, the
hand-written expand/accumulate pair (ops/sparse_rows.make_expand_lookup)
on the sparse path. ``generator`` drives dropout and must live on the
batch's device.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.ops import metrics as M
from tf_repos_tpu_torch.ops.embedding import dense_lookup

Params = Any
State = Any
Batch = Dict[str, torch.Tensor]
Outputs = Dict[str, torch.Tensor]


class SparseSlot(NamedTuple):
    """One embedding table eligible for lazy touched-rows updates
    (train/sparse.py): the batch fields holding ids into it, its vocab
    size, and the count of constant-id static fields (ids 1..static),
    whose rows the host mapper seeds into every unique set so that
    position == id for the whole static block."""

    fields: Tuple[str, ...]
    vocab: int
    static: int = 0


class CtrModel:
    """Base for single-task CTR models (sigmoid over one logit)."""

    name: str = "base"

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        raise NotImplementedError

    def apply(
        self,
        params: Params,
        state: State,
        batch: Batch,
        *,
        train: bool,
        generator: Optional[torch.Generator] = None,
        lookup=dense_lookup,
    ) -> Tuple[Outputs, State]:
        raise NotImplementedError

    def l2_loss(self, params: Params) -> torch.Tensor:
        """Explicit L2 terms added to the loss (embedding tables only)."""
        return torch.zeros(())

    def sparse_slots(self) -> Dict[str, SparseSlot]:
        return {}

    def mh_coo_groups(self):
        """Multi-hot groups the host may pack as a COO triplet (--mh_coo;
        data/sparse_batch.MhCooPacker): ((field, has_vals), ...) in
        pooled-output order. Empty: the model keeps padded batches."""
        return ()

    def coo_combine_ok(self) -> bool:
        """True when every consumer of the COO (idx, dest, w) stream is
        linear in w, so the host may sum the weights of duplicate
        (row, id) pairs first (--mh_coo_combine)."""
        return False

    def wants_sorted_seg(self) -> bool:
        """True when the model pools its COO slots with the sorted-stream
        segment kernels (ops/sorted_seg.py), so the packer should emit
        the compact segment stream __mhc_cdest (4 B per slot)."""
        return False

    def wants_sorted_aux(self) -> bool:
        """True when the model's COO lookup can take its backward over the
        packer's idx-sorted stream (--coo_sorted_bwd: __mhc_perm,
        __mhc_cidx, __mhc_srows; an O(M) host sort per batch)."""
        return False

    def loss(
        self,
        params: Params,
        state: State,
        batch: Batch,
        *,
        train: bool,
        generator: Optional[torch.Generator] = None,
        lookup=dense_lookup,
    ) -> Tuple[torch.Tensor, Tuple[Outputs, State]]:
        """Masked mean loss + explicit L2."""
        out, new_state = self.apply(
            params, state, batch, train=train, generator=generator, lookup=lookup
        )
        per = self.per_example_loss(out, batch)
        mask = batch.get("mask")
        if mask is None:
            data_loss = torch.mean(per)
        else:
            data_loss = torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return data_loss + self.l2_loss(params), (out, new_state)

    def per_example_loss(self, out: Outputs, batch: Batch) -> torch.Tensor:
        if self.cfg.loss_type == "square_loss":
            return M.squared_loss(out["logits"], batch["label"])
        return M.sigmoid_xent(out["logits"], batch["label"])

    def eval_metrics(self, out: Outputs, batch: Batch) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return {"auc": (batch["label"], out["prob"])}

    @property
    def prediction_keys(self):
        return ["prob"]
