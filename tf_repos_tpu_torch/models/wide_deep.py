"""Wide & Deep over Criteo CSV features (counterpart of the JAX package's
models/wide_deep.py), by model_type: wide, deep or wide_n_deep.

13 numeric columns and 26 categorical identity columns of 10,000
buckets each (the reference's wide_n_deep.py:92-107), an id outside
[0, 10,000) read as bucket 0. The 26 columns share one id space of
26 * 10,000 rows, column c at rows [c * 10,000, (c+1) * 10,000). Wide: a
linear model over the numerics (``wide_cont [13]``) and the one-hot
categoricals (the 1-D ``wide_cat [260,000]``); deep: the numerics and
the 26 embeddings of ``emb [260,000, K]`` into the MLP; wide_n_deep sums
the two logits with ``bias``. Both tables are read through ``lookup``:
the plain gather when training (the model declares no sparse slots, so
it always trains on the dense step), the serving lookup's K1 when
scoring (``wide_cat`` through its [V, 1] view).

Batch contract (data/csv.py): {"cont": f32[B,13], "cat": int32[B,26],
"label": f32[B], "mask": f32[B]}."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tf_repos_tpu_torch.models.base import Batch, CtrModel, Outputs, Params, State
from tf_repos_tpu_torch.ops import towers as T
from tf_repos_tpu_torch.ops.embedding import dense_lookup, glorot_normal_init

NUM_CONT = 13
NUM_CAT = 26
NUM_BUCKETS = 10_000  # wide_n_deep.py:98


class WideDeep(CtrModel):
    name = "wide_n_deep"

    def __init__(self, cfg, model_type: Optional[str] = None):
        super().__init__(cfg)
        self.model_type = model_type or cfg.model_type or "wide_n_deep"
        if self.model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"bad model_type {self.model_type}")

    @property
    def has_wide(self) -> bool:
        return self.model_type in ("wide", "wide_n_deep")

    @property
    def has_deep(self) -> bool:
        return self.model_type in ("deep", "wide_n_deep")

    def init(self, generator: Optional[torch.Generator]) -> Tuple[Params, State]:
        cfg = self.cfg
        params: Params = {"bias": torch.zeros(1)}
        state: State = {}
        if self.has_wide:
            params["wide_cont"] = torch.zeros(NUM_CONT)
            params["wide_cat"] = torch.zeros(NUM_CAT * NUM_BUCKETS)
        if self.has_deep:
            layers = cfg.deep_layers_list
            params["emb"] = glorot_normal_init(generator, (NUM_CAT * NUM_BUCKETS, cfg.embedding_size))
            params["mlp"], state["mlp"] = T.init_mlp(
                generator, NUM_CONT + NUM_CAT * cfg.embedding_size, layers,
                batch_norm=cfg.batch_norm,
            )
            params["out"] = T.init_dense(generator, layers[-1], 1)
        return params, state

    @staticmethod
    def _offset_ids(cat: torch.Tensor) -> torch.Tensor:
        """Identity-column semantics: an id outside [0, 10,000) reads bucket
        0; then column c is offset by c * 10,000."""
        safe = torch.where((cat >= 0) & (cat < NUM_BUCKETS), cat, torch.zeros_like(cat))
        offsets = torch.arange(NUM_CAT, dtype=safe.dtype, device=safe.device) * NUM_BUCKETS
        return safe + offsets[None, :]

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
        cfg = self.cfg
        cont = batch["cont"]
        ids = self._offset_ids(batch["cat"])
        logits = params["bias"][0]
        new_state: State = {}
        if self.has_wide:
            logits = logits + cont @ params["wide_cont"] + torch.sum(
                lookup(params["wide_cat"], ids), dim=1
            )
        if self.has_deep:
            emb = lookup(params["emb"], ids)  # [B,26,K]
            deep_in = torch.cat([cont, emb.reshape(emb.shape[0], -1)], dim=1)
            h, new_state["mlp"] = T.apply_mlp(
                params["mlp"],
                state["mlp"],
                deep_in,
                keep_probs=cfg.dropout_list,
                train=train,
                generator=generator,
                batch_norm=cfg.batch_norm,
                bn_decay=cfg.batch_norm_decay,
                compute_dtype=cfg.tower_dtype,
            )
            logits = logits + T.dense(params["out"], h)[:, 0]
        return {"logits": logits, "prob": torch.sigmoid(logits)}, new_state
