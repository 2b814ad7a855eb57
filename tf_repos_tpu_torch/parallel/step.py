"""Mesh-sharded train / eval / predict steps over torch.distributed ranks
(counterpart of the JAX package's parallel/step.py, whose shard_map steps
these mirror rank by rank).

State layout. Every rank holds the replicated params whole and its row
shard of each model-sharded table (model.sharded_params()): the table is
zero-padded to pad_vocab(V, M) rows and rank (d, m) keeps rows
[m * V_local, (m + 1) * V_local), JAX's layout, so a global row lives on
the same shard as in JAX. Padding rows are never gathered with a nonzero
weight, get zero gradients and stay exactly zero under every optimizer.
A dense optimizer's state follows its param: a leaf shaped like a
sharded table is sharded with it (the JAX package's opt_state_spec).
ShardedState.shard / .assemble convert between the single-device layout
(what checkpoints hold, on every mesh) and a rank's shards.

Gradient math (what shard_map's check_vma inserts in JAX, written out):
  * the data loss is  sum_d local_sum_d / sum_d weight_d: tot_w is a SUM
    all-reduce over "data", and every gradient, of replicated and of
    model-sharded leaves alike, is SUM all-reduced over "data" (not
    DDP's average);
  * the table lookup sums the masked local gathers over "model" with an
    identity backward (ops/embedding.make_sharded_lookup), so a table
    shard's gradient stays local;
  * the explicit L2 is differentiated separately from the data loss (it
    is data-invariant: summing its gradient over "data" would scale it
    by D); its value sums the shards' table L2 over "model" and adds the
    replicated params' L2 once (the JAX package's _split_l2);
  * the model state (batch-norm moving stats, from the local slice) is
    averaged over "data";
  * dropout's generator is seeded per data rank (fold_seed), as JAX
    folds its key with the data index.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from tf_repos_tpu_torch.data.sparse_batch import UIDS_PREFIX
from tf_repos_tpu_torch.models.base import CtrModel
from tf_repos_tpu_torch.ops import metrics as M
from tf_repos_tpu_torch.ops.embedding import make_sharded_lookup, pad_vocab
from tf_repos_tpu_torch.parallel.mesh import Mesh
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

COO_PREFIX = "__mhc_"


def fold_seed(seed: int, d: int) -> int:
    """The data rank's seed for a per-example random stream (dropout):
    ``seed`` itself at d = 0, so a 1-row mesh draws as one device does."""
    return seed + 1_000_003 * d


# ------------------------------------------------------------ opt state
def opt_state_spec(opt_state: Any, params: Dict[str, Any], names) -> Any:
    """A tree like ``opt_state``: the sharded param's name where a leaf has
    the shape of a model-sharded param (Adam's mu/nu, Adagrad's
    accumulator, FTRL's n/z), None where it is replicated (counts,
    scalars, the other leaves)."""
    by_shape = {tuple(params[t].shape): t for t in names}

    def leaf(x):
        return by_shape.get(tuple(x.shape)) if isinstance(x, torch.Tensor) else None

    return tree_map(leaf, opt_state)


# ----------------------------------------------------------- row shards
def shard_rows(x: torch.Tensor, mesh: Mesh, spare: bool = False) -> torch.Tensor:
    """Rank m's rows of the [V, ...] array ``x`` zero-padded to
    pad_vocab(V, M), on the mesh's device. spare=True: ``x`` is a row store
    [V + 1, ...] (train/sparse.py) and so is the shard, [V_local + 1, ...]
    with its spare row at zero."""
    if spare:
        x = x[:-1]
    v = x.shape[0]
    vl = pad_vocab(v, mesh.model) // mesh.model
    lo = mesh.m * vl
    part = x[lo: min(lo + vl, v)]
    out = torch.zeros((vl + int(spare),) + tuple(x.shape[1:]), dtype=x.dtype, device=mesh.device)
    out[: part.shape[0]] = part.to(mesh.device)
    return out


def gather_rows(x: torch.Tensor, mesh: Mesh, v: int, spare: bool = False) -> torch.Tensor:
    """The whole [V, ...] array (or row store) from every model rank's
    shard ``x``, on every rank of the model group: each rank writes its
    rows into zeros and the group sums the bytes (an all-reduce: gloo has
    no gather for CUDA tensors). Summing each byte with zeros is exact,
    so the array comes back bit for bit, -0.0 and NaN payloads included.
    Under gloo the sum runs on host tensors, and the array comes back on
    the host; under NCCL on the device."""
    if spare:
        x = x[:-1]
    vl = x.shape[0]
    dev = x.device if mesh.backend == "nccl" else torch.device("cpu")
    full = torch.zeros((vl * mesh.model,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    full[mesh.m * vl: (mesh.m + 1) * vl] = x
    if mesh.model > 1:
        mesh.sum_model(full.view(torch.uint8) if full.dim() else full)
    full = full[:v]
    if spare:
        full = torch.cat([full, full.new_zeros((1,) + tuple(full.shape[1:]))])
    return full


def slice_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The data rank's part of its host's batch (the JAX package's
    place_batch): with n = D/H data coordinates a host (D on one host)
    and the rank's host-local coordinate d, rows [d*B/n, (d+1)*B/n) of
    every example-indexed array, the __uids_* arrays whole (replicated),
    and row d of the COO arrays, whose leading axis is the host's data
    shard (data/sparse_batch.MhCooPacker with n_data = n)."""
    d, n = mesh.d_local, mesh.local_data
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if k.startswith(UIDS_PREFIX):
            out[k] = v
        elif k.startswith(COO_PREFIX):
            if v.shape[0] != n:
                raise ValueError(f"{k}: {v.shape[0]} COO shards for {n} data coordinates a host")
            out[k] = v[d: d + 1]
        else:
            b = v.shape[0]
            if b % n:
                raise ValueError(f"batch size {b} not divisible by {n} data coordinates a host")
            out[k] = v[d * (b // n): (d + 1) * (b // n)]
    return out


# ----------------------------------------------------------- sharded state
class ShardedState:
    """Shards a single-device train state onto the calling rank and
    assembles it back (dense step: params, the dense optimizer's state
    and the model state). ``vocab`` holds each sharded table's row count:
    the sparse slots' vocab, and the rows of every state shard() cuts
    (Wide&Deep's tables are no slots)."""

    def __init__(self, model: CtrModel, mesh: Mesh):
        self.model, self.mesh = model, mesh
        self.names = tuple(model.sharded_params())
        self.vocab: Dict[str, int] = {t: s.vocab for t, s in model.sparse_slots().items()}

    def shard(self, state: Dict[str, Any]) -> Dict[str, Any]:
        mesh = self.mesh
        params = state["params"]
        for t in self.names:
            self.vocab[t] = params[t].shape[0]
        spec = opt_state_spec(state["opt_state"], params, self.names)
        to_dev = lambda x: x.to(mesh.device) if isinstance(x, torch.Tensor) else x  # noqa: E731
        return {
            "params": {k: shard_rows(v, mesh) if k in self.names else tree_map(to_dev, v)
                       for k, v in params.items()},
            "opt_state": tree_map(lambda x, s: shard_rows(x, mesh) if s else to_dev(x),
                                  state["opt_state"], spec),
            "mstate": tree_map(to_dev, state["mstate"]),
        }

    def assemble(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The single-device state from the shards, on every rank (a
        collective: every rank calls it)."""
        mesh = self.mesh
        params = state["params"]
        full = {k: gather_rows(v, mesh, self.vocab[k]) if k in self.names else v
                for k, v in params.items()}
        spec = opt_state_spec(state["opt_state"], params, self.names)
        opt = tree_map(lambda x, s: gather_rows(x, mesh, self.vocab[s]) if s else x,
                       state["opt_state"], spec)
        return {"params": full, "opt_state": opt, "mstate": state["mstate"]}


# ------------------------------------------------------------- step pieces
def per_example_loss(model: CtrModel, out, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    per = model.per_example_loss(out, batch)
    w = batch.get("mask")
    return per, (torch.ones_like(per) if w is None else w)


def grads_or_zeros(y: torch.Tensor, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """d y / d xs, zeros for the leaves y does not reach."""
    if not y.requires_grad:
        return [torch.zeros_like(x) for x in xs]
    gs = torch.autograd.grad(y, xs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]


def sum_data_(mesh: Mesh, ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """SUM all-reduce of a list of tensors over "data", one collective a
    dtype (the list flattened into one buffer), the dtypes in one order
    on every rank."""
    if mesh.data == 1 or not ts:
        return ts
    out = list(ts)
    for dtype in sorted({t.dtype for t in ts}, key=str):
        idx = [i for i, t in enumerate(ts) if t.dtype == dtype]
        flat = torch.cat([ts[i].reshape(-1) for i in idx])
        mesh.sum_data(flat)
        off = 0
        for i in idx:
            n = ts[i].numel()
            out[i] = flat[off: off + n].view_as(ts[i])
            off += n
    return out


def mean_data(mesh: Mesh, tree: Any) -> Any:
    """The data-axis mean of every tensor of ``tree`` (batch-norm stats)."""
    if mesh.data == 1:
        return tree
    leaves = tree_leaves(tree)
    summed = sum_data_(mesh, [x.detach().clone() for x in leaves])
    return tree_unflatten(tree, [x / mesh.data for x in summed])


def split_l2(model: CtrModel, p: Dict[str, Any], names, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L2 of the local table shards, L2 of the replicated params), each
    differentiable: the model's l2_loss with the complementary params
    zeroed (zeros that carry no gradient)."""
    zeros = lambda v: tree_map(lambda x: torch.zeros_like(x).detach(), v)  # noqa: E731
    sharded_only = {k: (v if k in names else zeros(v)) for k, v in p.items()}
    repl_only = {k: (zeros(v) if k in names else v) for k, v in p.items()}
    return (torch.as_tensor(model.l2_loss(sharded_only), device=device),
            torch.as_tensor(model.l2_loss(repl_only), device=device))


def global_l2(model: CtrModel, params, mesh: Mesh, names) -> torch.Tensor:
    """The L2 term's value over the whole (sharded) params."""
    with torch.no_grad():
        l2s, l2r = split_l2(model, params, names, mesh.device)
        return mesh.sum_model(l2s.detach().clone()) + l2r


# ------------------------------------------------------------------ steps
def build_sharded_train_step(model: CtrModel, tx, mesh: Mesh):
    """(params, opt_state, mstate, batch, generator) -> (params, opt_state,
    mstate, loss) on the rank's shards and data slice; params and
    opt_state are updated in place. ``loss`` is the global loss, the same
    on every rank."""
    names = tuple(model.sharded_params())
    lookup = make_sharded_lookup(mesh.m, mesh.model, mesh.model_group)

    def step(params, opt_state, mstate, batch, generator=None):
        leaves = tree_leaves(params)
        alias = [x.detach().requires_grad_(True) for x in leaves]
        p = tree_unflatten(params, alias)
        out, new_ms = model.apply(p, mstate, batch, train=True, generator=generator, lookup=lookup)
        per, w = per_example_loss(model, out, batch)
        tot_w = mesh.sum_data(torch.sum(w).detach().clone())
        local = torch.sum(per * w) / torch.clamp(tot_w, min=1.0)
        dgrads = sum_data_(mesh, grads_or_zeros(local, alias))
        l2s, l2r = split_l2(model, p, names, mesh.device)
        l2grads = grads_or_zeros(l2s + l2r, alias)
        tx.update_(leaves, [a + b for a, b in zip(dgrads, l2grads)], opt_state)
        loss = (mesh.sum_data(local.detach().clone()) + mesh.sum_model(l2s.detach().clone())
                + l2r.detach())
        return params, opt_state, mean_data(mesh, new_ms), loss

    return step


def build_sharded_eval_step(model: CtrModel, mesh: Mesh):
    """(params, mstate, acc, batch) -> acc, the loss (with the global L2,
    weight-proportionally, as the single-device eval reports it) and the
    AUC counts summed over "data" every batch, so every rank holds the
    global accumulators."""
    names = tuple(model.sharded_params())
    lookup = make_sharded_lookup(mesh.m, mesh.model, mesh.model_group)
    # the global L2 is constant over an eval pass: computed once for the
    # params object it was computed for (held, not keyed by id())
    l2_cache: List[Any] = [None, None]

    @torch.no_grad()
    def step(params, mstate, acc, batch):
        if l2_cache[0] is not params:
            l2_cache[:] = [params, global_l2(model, params, mesh, names)]
        out, _ = model.apply(params, mstate, batch, train=False, lookup=lookup)
        per, w = per_example_loss(model, out, batch)
        parts = [torch.sum((per + l2_cache[1]) * w), torch.sum(w)]
        metrics = model.eval_metrics(out, batch)
        for name, (labels, preds) in metrics.items():
            parts += list(M.auc_update(M.AucState.init(preds.device), labels, preds, w))
        parts = sum_data_(mesh, parts)
        new_auc, i = {}, 2
        for name in metrics:
            upd = M.AucState(*parts[i: i + 4])
            new_auc[name] = M.AucState(*(a + b for a, b in zip(acc["auc"][name], upd)))
            i += 4
        return {"loss_sum": acc["loss_sum"] + parts[0],
                "weight_sum": acc["weight_sum"] + parts[1], "auc": new_auc}

    return step


def build_sharded_predict_step(model: CtrModel, mesh: Mesh):
    """(params, mstate, local batch) -> {prediction key: [B]} in global
    batch order on every rank: each data rank's predictions go into its
    rows of zeros and "data" sums them."""
    lookup = make_sharded_lookup(mesh.m, mesh.model, mesh.model_group)
    keys = list(model.prediction_keys)

    @torch.no_grad()
    def step(params, mstate, batch):
        out, _ = model.apply(params, mstate, batch, train=False, lookup=lookup)
        res = {}
        for k in keys:
            local = out[k]
            b = local.shape[0]
            full = torch.zeros((b * mesh.data,) + tuple(local.shape[1:]), dtype=local.dtype,
                               device=local.device)
            full[mesh.d * b: (mesh.d + 1) * b] = local
            res[k] = full
        for k, v in zip(keys, sum_data_(mesh, [res[k] for k in keys])):
            res[k] = v
        return res

    return step

