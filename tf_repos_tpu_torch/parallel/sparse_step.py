"""Mesh-sharded lazy (touched-rows) table updates (counterpart of the JAX
package's parallel/sparse_step.py): the row-sharded tables of
parallel/step.py under the touched-rows optimizers of train/sparse.py.

Data flow of a step on rank (d, m):
  * every rank reads the same global batch, so the host dedup gives the
    same ``__uids_<table>`` (ascending, padded with the sentinel V) on
    every rank; the rank keeps its data slice of the example-indexed
    arrays (parallel/step.slice_batch);
  * the replicated [S_pad, W] working set is a masked gather of the
    rank's shard of the row store (the fused w|m|v store under
    --fused_table, the table's otherwise), summed over "model"; the
    sentinel and padding uids read zeros. No gradient flows through it:
    the loss is differentiated with respect to the gathered rows;
  * the forward runs on the data slice through the inner lookup into
    those rows (K1/K2 under --pallas_expand, K3/K4 for the COO pool
    under --mh_coo); the row and dense gradients are SUM all-reduced
    over "data"; the touched-rows L2 is differentiated separately, with
    no collective (its inputs are replicated);
  * each rank applies the row optimizer to the replicated rows: the uids
    of its row range update there, every other uid (other shards'
    rows, the sentinel, the padding rows past V) goes to the shard
    store's spare row V_local, where the plain put wipes it and K7's
    n_valid = V_local drops it (--dma_scatter). The JAX package sends
    them to V_local + slot, which its scatter drops; the spare row is
    the port's row-store convention (train/sparse.py).
  * stochastic rounding (--param_dtype=bfloat16) draws from a generator
    seeded alike on every rank and not folded by the data rank, so every
    rank draws the whole [S, W] noise and keeps its own rows: the same
    noise a single device draws (JAX splits the rounding key before the
    data fold for the same reason)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from tf_repos_tpu_torch.data.sparse_batch import UIDS_PREFIX
from tf_repos_tpu_torch.models.base import CtrModel
from tf_repos_tpu_torch.ops.embedding import dense_lookup
from tf_repos_tpu_torch.parallel.mesh import Mesh
from tf_repos_tpu_torch.parallel.step import (
    ShardedState,
    gather_rows,
    grads_or_zeros,
    mean_data,
    per_example_loss,
    shard_rows,
    sum_data_,
)
from tf_repos_tpu_torch.train.sparse import SparseRowOpt, split_params
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _row_store(aux: Dict[str, Any]) -> torch.Tensor:
    """The store the step gathers the working set from."""
    return aux["wmv"] if "wmv" in aux else aux["w"]


class ShardedSparseState(ShardedState):
    """Shards the lazy step's state: every row store of a table (the
    table's ``w`` or the fused ``wmv``, and the optimizer's stores, ``last``
    included) becomes the rank's [V_local + 1, ...] shard with a zero
    spare row, and params[table] is rebound to the shard's table view;
    the dense rest and its optimizer state are replicated."""

    def __init__(self, model: CtrModel, sopt: SparseRowOpt, mesh: Mesh):
        super().__init__(model, mesh)
        self.sopt = sopt

    def _map(self, state, fn) -> Dict[str, Any]:
        params = dict(state["params"])
        sparse = {}
        for t, aux in state["opt_state"]["sparse"].items():
            sparse[t] = {k: fn(t, v) if isinstance(v, torch.Tensor) and v.dim() else v
                         for k, v in aux.items()}
            params[t] = self.sopt.table(sparse[t])
        return {"params": params, "opt_state": {"dense": state["opt_state"]["dense"],
                                                "sparse": sparse},
                "mstate": state["mstate"]}

    def shard(self, state: Dict[str, Any]) -> Dict[str, Any]:
        mesh = self.mesh
        to_dev = lambda x: x.to(mesh.device) if isinstance(x, torch.Tensor) else x  # noqa: E731
        for t, aux in state["opt_state"]["sparse"].items():
            self.vocab[t] = _row_store(aux).shape[0] - 1
        out = self._map(state, lambda t, v: shard_rows(v, mesh, spare=True))
        out["params"] = {k: v if k in out["opt_state"]["sparse"] else tree_map(to_dev, v)
                         for k, v in out["params"].items()}
        out["opt_state"]["dense"] = tree_map(to_dev, out["opt_state"]["dense"])
        out["mstate"] = tree_map(to_dev, out["mstate"])
        return out

    def assemble(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return self._map(state, lambda t, v: gather_rows(v, self.mesh, self.vocab[t], spare=True))


def gather_working_set(store: torch.Tensor, u: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The f32 rows of the global uids ``u`` from every model rank's
    [V_local + 1, ...] store shard: the masked local gather (uids outside
    the shard read zeros) summed over "model"."""
    vl = store.shape[0] - 1
    local = u - mesh.m * vl
    ok = (local >= 0) & (local < vl)
    rows = store.index_select(0, local.clamp(0, vl - 1)).float()
    rows = rows * (ok[:, None] if rows.dim() > 1 else ok).to(rows.dtype)
    return mesh.sum_model(rows)


def local_uids(u: torch.Tensor, vocab: int, vl: int, m: int) -> torch.Tensor:
    """Positions of the global uids in shard m's store: the uid's row for
    the real rows of the shard's range, the spare row V_local for the
    rest (other shards' rows, the sentinel V, padding rows past V)."""
    lo = m * vl
    keep = (u >= lo) & (u < lo + vl) & (u < vocab)
    return torch.where(keep, u - lo, torch.full_like(u, vl))


def build_sharded_sparse_train_step(model: CtrModel, tx_dense, sopt: SparseRowOpt, mesh: Mesh,
                                    vocab: Dict[str, int], inner_lookup=None):
    """(params, opt_state, mstate, batch, generator, sr_generator) ->
    (params, opt_state, mstate, loss) on the rank's shards and data slice
    (batches through data/sparse_batch.SparseBatchMapper, sliced by
    parallel/step.slice_batch, on the device). ``inner_lookup`` is the
    lookup into the replicated rows (ops/sparse_rows.make_expand_lookup
    under --pallas_expand): each rank runs it on its own data slice; no
    collective crosses it."""
    names = list(model.sparse_slots())
    row_lookup = inner_lookup or dense_lookup

    def step(params, opt_state, mstate, batch, generator=None, sr_generator=None):
        tables, rest = split_params(params, names)
        u = {t: batch[UIDS_PREFIX + t] for t in names}
        su = {t: gather_working_set(_row_store(opt_state["sparse"][t]), u[t], mesh) for t in names}
        rows = {t: (su[t][:, : tables[t].shape[-1]] if sopt.fused else su[t])
                .detach().requires_grad_(True) for t in names}
        rest_leaves = tree_leaves(rest)
        alias = [x.detach().requires_grad_(True) for x in rest_leaves]
        p = tree_unflatten(rest, alias)
        p.update(rows)
        out, new_ms = model.apply(p, mstate, batch, train=True, generator=generator,
                                  lookup=row_lookup)
        per, w = per_example_loss(model, out, batch)
        tot_w = mesh.sum_data(torch.sum(w).detach().clone())
        local = torch.sum(per * w) / torch.clamp(tot_w, min=1.0)
        xs = [rows[t] for t in names] + alias
        dgrads = sum_data_(mesh, grads_or_zeros(local, xs))
        l2 = torch.as_tensor(model.l2_loss(p), device=local.device)
        grads = [a + b for a, b in zip(dgrads, grads_or_zeros(l2, xs))]
        g_rows, g_rest = grads[: len(names)], grads[len(names):]
        tx_dense.update_(rest_leaves, g_rest, opt_state["dense"])
        for i, t in enumerate(names):
            aux = opt_state["sparse"][t]
            vl = _row_store(aux).shape[0] - 1
            u_loc = local_uids(u[t], vocab[t], vl, mesh.m)
            params[t] = sopt.apply(aux, su[t], u_loc, g_rows[i], sr_generator)
        loss = mesh.sum_data(local.detach().clone()) + l2.detach()
        return params, opt_state, mean_data(mesh, new_ms), loss

    return step
