"""Step builders: dense train / eval / predict (counterpart of
the JAX package's train/loop.py). PyTorch runs eagerly, so a "step" is a
plain function; the train step updates params and optimizer state in
place and returns them for the same contract as the JAX package."""

from __future__ import annotations

from typing import Any, Dict

import torch

from tf_repos_tpu_torch.models.base import CtrModel
from tf_repos_tpu_torch.ops import metrics as M
from tf_repos_tpu_torch.ops.embedding import dense_lookup
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def build_train_step(model: CtrModel, tx, lookup=None):
    """(params, opt_state, mstate, batch, generator) -> (params,
    opt_state, mstate, loss)."""
    lookup = lookup or dense_lookup

    def step(params, opt_state, mstate, batch, generator=None):
        leaves = tree_leaves(params)
        alias = [p.detach().requires_grad_(True) for p in leaves]
        loss, (_, new_mstate) = model.loss(
            tree_unflatten(params, alias), mstate, batch, train=True,
            generator=generator, lookup=lookup,
        )
        grads = torch.autograd.grad(loss, alias)
        tx.update_(leaves, list(grads), opt_state)
        return params, opt_state, new_mstate, loss.detach()

    return step


def build_eval_step(model: CtrModel):
    """Accumulates loss and per-metric streaming-AUC counts on the device:
    acc = {"loss_sum", "weight_sum", "auc": {name: AucState}}."""

    @torch.no_grad()
    def step(params, mstate, acc, batch):
        loss, (out, _) = model.loss(params, mstate, batch, train=False)
        w = batch.get("mask")
        wsum = torch.sum(w) if w is not None else torch.tensor(
            float(batch["label"].shape[0]), device=loss.device
        )
        new_auc = {}
        for name, (labels, preds) in model.eval_metrics(out, batch).items():
            new_auc[name] = M.auc_update(acc["auc"][name], labels, preds, w)
        return {
            "loss_sum": acc["loss_sum"] + loss * wsum,
            "weight_sum": acc["weight_sum"] + wsum,
            "auc": new_auc,
        }

    return step


def init_eval_acc(model: CtrModel, device) -> Dict[str, Any]:
    return {
        "loss_sum": torch.zeros((), device=device),
        "weight_sum": torch.zeros((), device=device),
        "auc": {name: M.AucState.init(device) for name in model_metric_names(model)},
    }


def model_metric_names(model: CtrModel):
    """The model's metric names, without running it: eval_metrics only
    builds a dict of (labels, preds) pairs, so dummy tensors serve."""
    dummy_out = {k: torch.zeros(1) for k in ("prob", "logits", "pctr", "pcvr", "pctcvr")}
    dummy_batch = {k: torch.zeros(1) for k in ("label", "y", "z", "mask")}
    return list(model.eval_metrics(dummy_out, dummy_batch))


def finalize_eval(acc) -> Dict[str, float]:
    res = {"loss": float(acc["loss_sum"] / torch.clamp(acc["weight_sum"], min=1.0))}
    for name, st in acc["auc"].items():
        res[name] = float(M.auc_finalize(st))
    return res


def build_predict_step(model: CtrModel, lookup=None):
    """(params, mstate, batch) -> {prediction key: [B]}; ``lookup``
    defaults to the plain gather (ops/sparse_rows.make_serving_lookup()
    is the scorer's and infer's)."""
    lookup = lookup or dense_lookup

    @torch.no_grad()
    def step(params, mstate, batch):
        out, _ = model.apply(params, mstate, batch, train=False, lookup=lookup)
        return {k: out[k] for k in model.prediction_keys}

    return step
