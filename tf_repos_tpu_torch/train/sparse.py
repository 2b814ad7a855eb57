"""Touched-rows-only ("lazy") Adam for the embedding table (counterpart of
the JAX package's train/sparse.py, Adam part).

The host mapper (data/sparse_batch.py) ships the batch's unique ids
``__uids_<table>`` (ascending, padded with the sentinel V) and remaps the
id fields to positions into them. The step gathers those S rows once,
differentiates the loss with respect to the small [S,K] block, and
updates only those rows of the table and its Adam moments. Untouched rows
keep stale moments (TF LazyAdam semantics); bias correction uses the
global step count; L2 reaches only the touched rows.

Row stores. JAX reads the sentinel with ``.at[u].get(mode="fill")`` and
drops its write with ``.at[u].set(mode="drop")``. Indexing row V of a
[V,...] tensor asserts on the GPU, and masking on ``u < V`` must not
force a host sync each step. So every array the rows are gathered from
and written to is a row store with one spare row V, held at zero: the
sentinel reads zeros from it, its write lands there and is wiped right
after. The [V,K] table the model and eval see is a view of the store's
first V rows. The port updates the stores in place."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from tf_repos_tpu_torch.data.sparse_batch import UIDS_PREFIX
from tf_repos_tpu_torch.ops.embedding import dense_lookup
from tf_repos_tpu_torch.ops.row_scatter import dma_row_scatter
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def row_store(a: torch.Tensor) -> torch.Tensor:
    """[V,...] -> [V+1,...] with a zero spare row V for the sentinel."""
    return torch.cat([a, torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)])


def take_rows(store: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Rows of a row store at u (values in [0, V]); the sentinel u == V
    reads zeros."""
    return store.index_select(0, u)


def take_rows_f32(store: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return take_rows(store, u).float()


@torch.no_grad()
def put_rows(store: torch.Tensor, u: torch.Tensor, rows: torch.Tensor) -> None:
    """Write rows at u in place (u unique apart from sentinels); the
    sentinel's write is dropped: it lands in the spare row, which is then
    zeroed again."""
    store[u] = rows.to(store.dtype)
    store[-1].zero_()


class SparseRowOpt:
    """A lazy row-wise optimizer for one [V,K] table.

    init(table) -> aux          row stores (and the step count)
    gather(aux, u) -> su        the f32 rows one gather brings in; the
                                model's rows are su[:, :K]
    apply(aux, su, u, g)        in-place update of the touched rows;
                                returns table(aux)
    table(aux)                  the [V,K] table view of the store
    """

    fused = False

    def __init__(self, learning_rate: float, catchup: bool):
        self.lr = learning_rate
        self.catchup = catchup
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    def _decays(self, aux, u, t: int):
        if not self.catchup:
            return self.b1, self.b2
        delta = (t - take_rows(aux["last"], u)).float()
        return torch.pow(self.b1, delta)[:, None], torch.pow(self.b2, delta)[:, None]

    def _adam(self, w0, m0, v0, g, d1, d2, t: int):
        b1, b2 = self.b1, self.b2
        m1 = d1 * m0 + (1.0 - b1) * g
        v1 = d2 * v0 + (1.0 - b2) * torch.square(g)
        m_hat = m1 / (1.0 - b1 ** t)
        v_hat = v1 / (1.0 - b2 ** t)
        w1 = w0 - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return w1, m1, v1

    def _touch(self, aux, u, t: int) -> None:
        aux["t"] = t
        if self.catchup:
            put_rows(aux["last"], u, torch.full_like(u, t))


class AdamRowOpt(SparseRowOpt):
    """Plain lazy Adam: table, m and v in three row stores (three gathers
    and three write-backs per step)."""

    def init(self, table: torch.Tensor) -> Dict[str, Any]:
        aux = {
            "w": row_store(table),
            "m": row_store(torch.zeros_like(table)),
            "v": row_store(torch.zeros_like(table)),
            "t": 0,
        }
        if self.catchup:
            aux["last"] = torch.zeros(table.shape[0] + 1, dtype=torch.int32, device=table.device)
        return aux

    def table(self, aux) -> torch.Tensor:
        return aux["w"][:-1]

    def gather(self, aux, u: torch.Tensor) -> torch.Tensor:
        return take_rows_f32(aux["w"], u)

    @torch.no_grad()
    def apply(self, aux, su, u, g) -> torch.Tensor:
        t = aux["t"] + 1
        d1, d2 = self._decays(aux, u, t)
        w1, m1, v1 = self._adam(
            su, take_rows_f32(aux["m"], u), take_rows_f32(aux["v"], u), g, d1, d2, t
        )
        put_rows(aux["m"], u, m1)
        put_rows(aux["v"], u, v1)
        put_rows(aux["w"], u, w1)
        self._touch(aux, u, t)
        return self.table(aux)


class FusedTableRowOpt(SparseRowOpt):
    """Lazy Adam over one [V+1, 3K] row store of w | m | v: one row
    gather serves the forward and the moments, one row write-back stores
    all three.

    dma_scatter (--dma_scatter): the store is lane-padded to [V+1, L],
    L = 3K rounded up to 128 (the JAX package's layout, so the state
    compares whole with its), the lanes past 3K held at zero, and the
    write-back is K7 dma_row_scatter (ops/row_scatter.py) of the 3K
    live lanes with n_valid = V: the sentinel's row is dropped in the
    kernel, so the spare row V is never written and needs no
    re-zeroing."""

    fused = True

    def __init__(self, learning_rate: float, catchup: bool, dma_scatter: bool = False):
        super().__init__(learning_rate, catchup)
        self.dma_scatter = dma_scatter

    def init(self, table: torch.Tensor) -> Dict[str, Any]:
        k = table.shape[-1]
        if self.dma_scatter:
            if table.dtype != torch.float32:
                raise ValueError(
                    "--dma_scatter requires f32 tables (the JAX package's lane-padded "
                    "layout is f32 only): drop --param_dtype=bfloat16"
                )
            width = -(-3 * k // 128) * 128
        else:
            width = 3 * k
        wmv = torch.cat(
            [table, torch.zeros(table.shape[:-1] + (width - k,), dtype=table.dtype, device=table.device)],
            dim=-1,
        )
        aux = {"wmv": row_store(wmv), "k": k, "t": 0}
        if self.catchup:
            aux["last"] = torch.zeros(table.shape[0] + 1, dtype=torch.int32, device=table.device)
        return aux

    def table(self, aux) -> torch.Tensor:
        return aux["wmv"][:-1, : aux["k"]]

    def gather(self, aux, u: torch.Tensor) -> torch.Tensor:
        return take_rows_f32(aux["wmv"], u)

    @torch.no_grad()
    def apply(self, aux, su, u, g) -> torch.Tensor:
        t = aux["t"] + 1
        k = aux["k"]
        d1, d2 = self._decays(aux, u, t)
        w1, m1, v1 = self._adam(
            su[:, :k], su[:, k : 2 * k], su[:, 2 * k : 3 * k], g, d1, d2, t
        )
        store, rows = aux["wmv"], torch.cat([w1, m1, v1], dim=-1)
        if self.dma_scatter:
            # only the 3K live lanes: the pad lanes are zero from init and
            # nothing writes them
            dma_row_scatter(store[:, : 3 * k], u, rows, n_valid=store.shape[0] - 1)
        else:
            put_rows(store, u, rows)
        self._touch(aux, u, t)
        return self.table(aux)


def make_sparse_row_optimizer(
    name: str,
    learning_rate: float,
    fused_table: bool = False,
    catchup: bool = False,
    dma_scatter: bool = False,
) -> SparseRowOpt:
    """Adam only in this slice (plain or fused [V,3K] storage, with or
    without per-row moment catch-up; with dma_scatter the fused store is
    lane-padded and written back by K7)."""
    if name.lower() != "adam":
        raise NotImplementedError(
            f"sparse-row optimizer {name!r}: not ported to tf_repos_tpu_torch yet (Adam only)"
        )
    if dma_scatter and not fused_table:
        raise ValueError(
            "--dma_scatter requires --fused_table (the row scatter replaces the "
            "fused [V,L] store's one write-back; the unfused layouts keep theirs)"
        )
    if fused_table:
        return FusedTableRowOpt(learning_rate, catchup, dma_scatter)
    return AdamRowOpt(learning_rate, catchup)


def split_params(params: Dict[str, Any], slot_names) -> Tuple[Dict, Dict]:
    tables = {t: params[t] for t in slot_names}
    rest = {k: v for k, v in params.items() if k not in tables}
    return tables, rest


def init_opt_state(model, tx_dense, sopt: SparseRowOpt, params) -> Dict[str, Any]:
    """Adam state for the dense part, row stores for each sparse table.
    Rebinds params[table] to the store's [V,K] view, so the table exists
    once in memory."""
    names = list(model.sparse_slots().keys())
    tables, rest = split_params(params, names)
    sparse = {t: sopt.init(tab) for t, tab in tables.items()}
    for t in names:
        params[t] = sopt.table(sparse[t])
    return {"dense": tx_dense.init(rest), "sparse": sparse}


def build_sparse_train_step(model, tx_dense, sopt: SparseRowOpt, lookup=None):
    """(params, opt_state, mstate, batch, generator) -> (params, opt_state,
    mstate, loss), updating params and opt_state in place. Batches must
    have passed through data/sparse_batch.SparseBatchMapper and live on
    the device. ``lookup`` overrides the model's inner (remapped-id)
    lookup, e.g. ops/sparse_rows.make_expand_lookup()."""
    slot_names = list(model.sparse_slots().keys())
    lookup = lookup or dense_lookup

    def step(params, opt_state, mstate, batch, generator=None):
        tables, rest = split_params(params, slot_names)
        u = {t: batch[UIDS_PREFIX + t] for t in slot_names}
        su = {t: sopt.gather(opt_state["sparse"][t], u[t]) for t in slot_names}
        # the fused store's rows carry m and v beside w; a plain store's
        # are the table's rows as they are (LR's 1-D table gives [S])
        rows = {
            t: (su[t][:, : tables[t].shape[-1]] if sopt.fused else su[t])
            .detach().requires_grad_(True)
            for t in slot_names
        }
        rest_leaves = tree_leaves(rest)
        alias = [p.detach().requires_grad_(True) for p in rest_leaves]
        p = tree_unflatten(rest, alias)
        p.update(rows)  # the model sees a small [S,K] "table"
        loss, (_, new_mstate) = model.loss(
            p, mstate, batch, train=True, generator=generator, lookup=lookup
        )
        grads = torch.autograd.grad(loss, [rows[t] for t in slot_names] + alias)
        g_rows, g_rest = grads[: len(slot_names)], list(grads[len(slot_names):])
        tx_dense.update_(rest_leaves, g_rest, opt_state["dense"])
        for i, t in enumerate(slot_names):
            params[t] = sopt.apply(opt_state["sparse"][t], su[t], u[t], g_rows[i])
        return params, opt_state, new_mstate, loss.detach()

    return step
