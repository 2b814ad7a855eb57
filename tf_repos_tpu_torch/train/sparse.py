"""Touched-rows-only ("lazy") optimizers for the embedding tables
(counterpart of the JAX package's train/sparse.py): Adam, Adagrad, FTRL,
Momentum and GD/SGD.

The host mapper (data/sparse_batch.py) ships the batch's unique ids
``__uids_<table>`` (ascending, padded with the sentinel V) and remaps the
id fields to positions into them. The step gathers those S rows once,
differentiates the loss with respect to the small [S,K] block, and
updates only those rows of the table and of its optimizer state.
Untouched rows keep stale state (TF LazyAdam semantics); Adam's bias
correction uses the global step count; L2 reaches only the touched rows.

Row stores. JAX reads the sentinel with ``.at[u].get(mode="fill")`` and
drops its write with ``.at[u].set(mode="drop")``. Indexing row V of a
[V,...] tensor asserts on the GPU, and masking on ``u < V`` must not
force a host sync each step. So every array the rows are gathered from
and written to is a row store with one spare row V, held at zero: the
sentinel reads zeros from it, its write lands there and is wiped right
after. The [V,K] table the model and eval see is a view of the store's
first V rows. The port updates the stores in place.

Storage dtype (--param_dtype=bfloat16): the tables, and so every store
made from them, may be bf16. Rows are gathered as f32, the row math is
f32, and every write-back goes through ops/rounding.maybe_round:
stochastic rounding from the step's rounding generator for bf16 (each
store its own draw, in the order of the JAX package's key splits: the
table's row first, then the state stores in the order it names them),
a plain cast otherwise, which draws nothing."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from tf_repos_tpu_torch.data.sparse_batch import UIDS_PREFIX
from tf_repos_tpu_torch.ops.embedding import dense_lookup
from tf_repos_tpu_torch.ops.rounding import maybe_round
from tf_repos_tpu_torch.ops.row_scatter import dma_row_scatter
from tf_repos_tpu_torch.train.optimizers import BiasCorrections
from tf_repos_tpu_torch.train.step_graph import GraphedStep
from tf_repos_tpu_torch.utils.observability import span
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
    """Write rows, already in the store's dtype, at u in place (u unique
    apart from sentinels); the sentinel's write is dropped: it lands in
    the spare row, which is then zeroed again."""
    store[u] = rows
    store[-1].zero_()


@torch.no_grad()
def write_rows(store: torch.Tensor, u: torch.Tensor, rows: torch.Tensor, generator) -> None:
    """put_rows of f32 rows rounded to the store's dtype (maybe_round)."""
    put_rows(store, u, maybe_round(rows, generator, store.dtype))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a true division on every device: the card's kernel
    multiplies by the reciprocal of a host scalar (a last bit off the
    CPU's and the JAX package's quotient, which a rounding to bf16 or an
    update that cancels can carry into the stores), not of a tensor."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


class SparseRowOpt:
    """A lazy row-wise optimizer for one [V,K] (or 1-D [V]) table.

    init(table) -> aux          row stores (and, for Adam, the step count)
    gather(aux, u) -> su        the f32 rows one gather brings in; the
                                model's rows are su[:, :K]
    apply(aux, su, u, g, generator)
                                in-place update of the touched rows,
                                rounded with noise from ``generator``
                                where a store is bf16; returns table(aux)
    table(aux)                  the [V,K] table view of the store

    The unfused optimizers keep the table in the row store ``w`` and each
    state array in a row store of its own, named as in the JAX package and
    started at ``STORES``' value (the spare row at zero like every other:
    the guards below keep the sentinel's math finite, and its write lands
    in the spare row, which is wiped). ``rows`` gives the new rows of each
    store, the table's ``w`` first and then the others in the JAX
    package's key order, which is the order they are rounded in."""

    fused = False
    STORES: Dict[str, float] = {}

    def __init__(self, learning_rate: float):
        self.lr = learning_rate

    def init(self, table: torch.Tensor) -> Dict[str, Any]:
        aux = {"w": row_store(table)}
        for name, fill in self.STORES.items():
            aux[name] = row_store(torch.full_like(table, fill))
        return aux

    def table(self, aux) -> torch.Tensor:
        return aux["w"][:-1]

    def gather(self, aux, u: torch.Tensor) -> torch.Tensor:
        return take_rows_f32(aux["w"], u)

    def rows(self, aux, su, u, g) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, aux, su, u, g, generator=None) -> torch.Tensor:
        for name, new in self.rows(aux, su, u, g).items():
            write_rows(aux[name], u, new, generator)
        return self.table(aux)


class GdRowOpt(SparseRowOpt):
    """Lazy GD/SGD: w -= lr * g on the touched rows; no state."""

    def rows(self, aux, su, u, g):
        return {"w": su - self.lr * g}


class MomentumRowOpt(SparseRowOpt):
    """Lazy momentum (0.95): mo = 0.95 * mo + g; w -= lr * mo."""

    STORES = {"mo": 0.0}

    def rows(self, aux, su, u, g):
        mo = 0.95 * take_rows_f32(aux["mo"], u) + g
        return {"w": su - self.lr * mo, "mo": mo}


class AdagradRowOpt(SparseRowOpt):
    """Lazy TF Adagrad: a += g^2; w -= lr * g * rsqrt(a), accumulator from
    1e-8. The sentinel reads a = 0 from the spare row: rsqrt(0) times its
    zero cotangent would be NaN, so a is floored at 1e-11 for the step."""

    INIT = 1e-8
    STORES = {"a": INIT}

    def rows(self, aux, su, u, g):
        a = take_rows_f32(aux["a"], u) + torch.square(g)
        step = self.lr * g * torch.rsqrt(torch.clamp(a, min=self.INIT * 1e-3))
        return {"w": su - step, "a": a}


class FtrlRowOpt(SparseRowOpt):
    """Lazy FTRL with TF's defaults (lr_power -0.5, n from 0.1, l1 = l2 = 0):
    n1 = n0 + g^2; z1 = z0 + g - ((sqrt(n1) - sqrt(n0)) / lr) * w;
    w = -z1 / (sqrt(n1) / lr). n0 is floored at 1e-4 (the sentinel reads
    n = 0). Untouched rows keep their values: the dense form rebuilds
    every w from (z, n), which zeroes rows no step has touched."""

    INIT = 0.1
    STORES = {"n": INIT, "z": 0.0}

    def _ftrl(self, n0, z0, w, g):
        n0 = torch.clamp(n0, min=self.INIT * 1e-3)
        n1 = n0 + torch.square(g)
        z1 = z0 + g - _div(torch.pow(n1, 0.5) - torch.pow(n0, 0.5), self.lr) * w
        return -z1 / _div(torch.pow(n1, 0.5), self.lr), n1, z1

    def rows(self, aux, su, u, g):
        w1, n1, z1 = self._ftrl(take_rows_f32(aux["n"], u), take_rows_f32(aux["z"], u), su, g)
        return {"w": w1, "n": n1, "z": z1}


class FusedFtrlRowOpt(FtrlRowOpt):
    """Lazy FTRL with --fused_moments: n and z interleaved by row in one
    [V+1, 2K] store ``nz`` (n in the first K columns, from 0.1; z in the
    last K), one gather and one write-back of it per step."""

    def init(self, table: torch.Tensor) -> Dict[str, Any]:
        nz = torch.zeros(table.shape[:-1] + (2 * table.shape[-1],), dtype=table.dtype,
                         device=table.device)
        nz[..., : table.shape[-1]] = self.INIT
        return {"w": row_store(table), "nz": row_store(nz)}

    def rows(self, aux, su, u, g):
        k = su.shape[-1]
        nz = take_rows_f32(aux["nz"], u)
        w1, n1, z1 = self._ftrl(nz[:, :k], nz[:, k:], su, g)
        return {"w": w1, "nz": torch.cat([n1, z1], dim=-1)}


class _LazyAdam(SparseRowOpt):
    """Adam's row math, shared by the plain and the fused store."""

    def __init__(self, learning_rate: float, catchup: bool):
        super().__init__(learning_rate)
        self.catchup = catchup
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self._powers: Dict[Any, torch.Tensor] = {}
        # 1 - b^t in f32, as the JAX package computes it (the double power
        # cast to f32 differs from it by up to ~100 f32 ulps at b = 0.999,
        # which would move bf16 roundings)
        self.steps = BiasCorrections(self.b1, self.b2, torch.float32)

    def _power_table(self, t: int, device) -> torch.Tensor:
        """[2, n > t] f32: b1^k and b2^k for k < n, computed on the CPU
        (powf, as the JAX package computes the decays) and kept on
        ``device``, regrown to twice the step when the step outgrows it:
        the card's own powf differs from it by an ulp at some k, which an
        update that cancels (m = d m + 0.1 g) would carry to the stores."""
        table = self._powers.get(device)
        if table is None or table.shape[1] <= t:
            k = torch.arange(max(2 * t, 1024), dtype=torch.float32)
            b = torch.tensor([[self.b1], [self.b2]], dtype=torch.float32)
            table = self._powers[device] = torch.pow(b, k).to(device)
        return table

    def _decays(self, aux, u, t: int):
        if not self.catchup:
            return self.b1, self.b2
        delta = t - take_rows(aux["last"], u)
        d = self._power_table(t, delta.device).index_select(1, delta)
        return d[0][:, None], d[1][:, None]

    def _adam(self, w0, m0, v0, g, d1, d2, c):
        """The row update; ``c``: the step's bias corrections, a device
        tensor (self.steps), so the division is a true one (_div)."""
        b1, b2 = self.b1, self.b2
        m1 = d1 * m0 + (1.0 - b1) * g
        v1 = d2 * v0 + (1.0 - b2) * torch.square(g)
        m_hat = m1 / c[0]
        v_hat = v1 / c[1]
        w1 = w0 - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return w1, m1, v1

    def _touch(self, aux, u, t: int) -> None:
        if self.catchup:
            put_rows(aux["last"], u, torch.full_like(u, t, dtype=aux["last"].dtype))


    def _step_state(self, aux, table: torch.Tensor) -> Dict[str, Any]:
        aux["t"] = 0
        if self.catchup:
            aux["last"] = torch.zeros(table.shape[0] + 1, dtype=torch.int32, device=table.device)
        return aux

    def moments(self, aux, su, u):
        """(w0, m0, v0) of the touched rows."""
        raise NotImplementedError

    def new_rows(self, w1, m1, v1) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, aux, su, u, g, generator=None) -> torch.Tensor:
        t, c = self.steps.advance(aux, "t", g.device)
        d1, d2 = self._decays(aux, u, t)
        w1, m1, v1 = self._adam(*self.moments(aux, su, u), g, d1, d2, c)
        for name, new in self.new_rows(w1, m1, v1).items():
            write_rows(aux[name], u, new, generator)
        self._touch(aux, u, t)
        return self.table(aux)


class AdamRowOpt(_LazyAdam):
    """Plain lazy Adam: table, m and v in three row stores (three gathers
    and three write-backs per step)."""

    STORES = {"m": 0.0, "v": 0.0}

    def init(self, table: torch.Tensor) -> Dict[str, Any]:
        return self._step_state(super().init(table), table)

    def moments(self, aux, su, u):
        return su, take_rows_f32(aux["m"], u), take_rows_f32(aux["v"], u)

    def new_rows(self, w1, m1, v1):
        return {"w": w1, "m": m1, "v": v1}


class FusedMomentsRowOpt(_LazyAdam):
    """Lazy Adam with --fused_moments: m and v interleaved by row in one
    [V+1, 2K] store ``mv`` (m in the first K columns, v in the last K):
    per step one gather and one write-back of ``w`` and of ``mv``."""

    def init(self, table: torch.Tensor) -> Dict[str, Any]:
        mv = torch.zeros(table.shape[:-1] + (2 * table.shape[-1],), dtype=table.dtype,
                         device=table.device)
        return self._step_state({"w": row_store(table), "mv": row_store(mv)}, table)

    def moments(self, aux, su, u):
        k = su.shape[-1]
        mv = take_rows_f32(aux["mv"], u)
        return su, mv[:, :k], mv[:, k:]

    def new_rows(self, w1, m1, v1):
        return {"w": w1, "mv": torch.cat([m1, v1], dim=-1)}


class FusedTableRowOpt(_LazyAdam):
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
        return self._step_state({"wmv": row_store(wmv), "k": k}, table)

    def table(self, aux) -> torch.Tensor:
        return aux["wmv"][:-1, : aux["k"]]

    def gather(self, aux, u: torch.Tensor) -> torch.Tensor:
        return take_rows_f32(aux["wmv"], u)

    @torch.no_grad()
    def apply(self, aux, su, u, g, generator=None) -> torch.Tensor:
        t, c = self.steps.advance(aux, "t", g.device)
        k = aux["k"]
        d1, d2 = self._decays(aux, u, t)
        w1, m1, v1 = self._adam(
            su[:, :k], su[:, k : 2 * k], su[:, 2 * k : 3 * k], g, d1, d2, c
        )
        store, rows = aux["wmv"], torch.cat([w1, m1, v1], dim=-1)
        if self.dma_scatter:
            # only the 3K live lanes: the pad lanes are zero from init and
            # nothing writes them (the store is f32: init refuses bf16)
            dma_row_scatter(store[:, : 3 * k], u, rows, n_valid=store.shape[0] - 1)
        else:
            # one draw over the whole [S, 3K] row, as the JAX package's
            write_rows(store, u, rows, generator)
        self._touch(aux, u, t)
        return self.table(aux)


def make_sparse_row_optimizer(
    name: str,
    learning_rate: float,
    fused_moments: bool = False,
    fused_table: bool = False,
    catchup: bool = False,
    dma_scatter: bool = False,
) -> SparseRowOpt:
    """The lazy form of make_optimizer's optimizer ``name``, with the same
    hyperparameters: Adam (plain, with fused_moments on the [V,2K] m|v
    store, or on the fused [V,3K] w|m|v store; with or without per-row
    moment catch-up; with dma_scatter the fused store is lane-padded and
    written back by K7), Adagrad, FTRL (with fused_moments on the [V,2K]
    n|z store), Momentum and GD/SGD; fused_moments is ignored by the
    one-state optimizers, as in the JAX package. The JAX package's
    errors: catch-up and the fused store are Adam's, the fused store
    supersedes fused_moments; wdl has no row form."""
    key = name.lower()
    if catchup and key != "adam":
        raise ValueError(
            f"--sparse_catchup applies to Adam (got {name!r}): the other "
            "sparse-row optimizers are already exact fixed points of the "
            "dense update on untouched rows"
        )
    if dma_scatter and not fused_table:
        raise ValueError(
            "--dma_scatter requires --fused_table (the row scatter replaces the "
            "fused [V,L] store's one write-back; the unfused layouts keep theirs)"
        )
    if fused_table:
        if key != "adam":
            raise ValueError(
                f"--fused_table supports Adam (got {name!r}); use "
                "--fused_moments for the other optimizers"
            )
        if fused_moments:
            raise ValueError(
                "--fused_table supersedes --fused_moments (the moments "
                "already live in the fused [V,3K] storage); set only one"
            )
        return FusedTableRowOpt(learning_rate, catchup, dma_scatter)
    if key == "adam":
        return (FusedMomentsRowOpt if fused_moments else AdamRowOpt)(learning_rate, catchup)
    rows = {"adagrad": AdagradRowOpt, "ftrl": FusedFtrlRowOpt if fused_moments else FtrlRowOpt,
            "gd": GdRowOpt, "sgd": GdRowOpt, "momentum": MomentumRowOpt}
    if key not in rows:
        raise ValueError(f"no sparse-row variant for optimizer {name!r}")
    return rows[key](learning_rate)


def split_params(params: Dict[str, Any], slot_names) -> Tuple[Dict, Dict]:
    tables = {t: params[t] for t in slot_names}
    rest = {k: v for k, v in params.items() if k not in tables}
    return tables, rest


def init_opt_state(model, tx_dense, sopt: SparseRowOpt, params) -> Dict[str, Any]:
    """The dense optimizer's state for the rest, row stores for each sparse table.
    Rebinds params[table] to the store's [V,K] view, so the table exists
    once in memory."""
    names = list(model.sparse_slots().keys())
    tables, rest = split_params(params, names)
    sparse = {t: sopt.init(tab) for t, tab in tables.items()}
    for t in names:
        params[t] = sopt.table(sparse[t])
    return {"dense": tx_dense.init(rest), "sparse": sparse}


def batch_rows(batch) -> int:
    """A device batch's rows (its label; y where the slim wire dropped
    the alias)."""
    return (batch["label"] if "label" in batch else batch["y"]).shape[0]


def build_sparse_train_step(model, tx_dense, sopt: SparseRowOpt, lookup=None):
    """(params, opt_state, mstate, batch, generator, sr_generator) ->
    (params, opt_state, mstate, loss), updating params and opt_state in
    place. Batches must have passed through
    data/sparse_batch.SparseBatchMapper and live on the device. ``lookup``
    overrides the model's inner (remapped-id) lookup, e.g.
    ops/sparse_rows.make_expand_lookup(). ``generator`` drives dropout,
    ``sr_generator`` the stochastic rounding of bf16 stores (tables in
    slot order, each store's draw in the JAX package's order); an f32
    step draws nothing from it. The step is a train/step_graph.GraphedStep:
    replayed from a CUDA graph a batch signature where nothing draws and
    every batch tensor is on a card, else run as it is (always under
    per-row catch-up)."""
    slot_names = list(model.sparse_slots().keys())
    lookup = lookup or dense_lookup

    def step(params, opt_state, mstate, batch, generator=None, sr_generator=None):
        with span("step", count=lambda: batch_rows(batch)):
            tables, rest = split_params(params, slot_names)
            u = {t: batch[UIDS_PREFIX + t] for t in slot_names}
            with span("step.gather"):
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
            with span("step.forward", adjacent=True):
                loss, (_, new_mstate) = model.loss(
                    p, mstate, batch, train=True, generator=generator, lookup=lookup
                )
            with span("step.backward", adjacent=True):
                grads = torch.autograd.grad(loss, [rows[t] for t in slot_names] + alias)
            g_rows, g_rest = grads[: len(slot_names)], list(grads[len(slot_names):])
            with span("step.update", adjacent=True,
                      count=lambda: {t: u[t].shape[0] for t in slot_names}):
                tx_dense.update_(rest_leaves, g_rest, opt_state["dense"])
                for i, t in enumerate(slot_names):
                    params[t] = sopt.apply(opt_state["sparse"][t], su[t], u[t], g_rows[i], sr_generator)
        return params, opt_state, new_mstate, loss.detach()

    return GraphedStep(step, "catch-up" if getattr(sopt, "catchup", False) else None)


def cast_tables(model, params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """The sparse-slot tables cast to ``dtype`` (round-to-nearest: used
    once at init; training writes round stochastically)."""
    out = dict(params)
    for t in model.sparse_slots():
        out[t] = params[t].to(dtype)
    return out


def upcast_tables_f32(model, params: Dict[str, Any]) -> Dict[str, Any]:
    """An f32 copy of bf16-stored tables for eval, infer and export."""
    out = dict(params)
    for t in model.sparse_slots():
        if out[t].dtype != torch.float32:
            out[t] = out[t].float()
    return out
