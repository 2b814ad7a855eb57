"""Rank programs of the port's mesh tests, and the launcher's own tests.

The mesh tests (test_torch_mesh.py, test_torch_parallel.py,
test_torch_sparse_mesh.py, test_torch_cross_topology.py) spawn gloo ranks
on the CPU through parallel/launch.run_on_mesh; the functions here are
what each rank runs. A spawned rank imports this module by name, so it
imports neither JAX nor the JAX package: the tests hand it numpy
weights and batches and compare rank 0's results with the JAX
package's sharded steps. Each spawn is joined within JOIN_S seconds, then
killed, so a hung collective fails its test instead of stalling the run."""

import os

import numpy as np
import pytest
import torch

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.parallel.launch import run_on_mesh
from tf_repos_tpu_torch.parallel.sparse_step import build_sharded_sparse_train_step
from tf_repos_tpu_torch.parallel.step import (
    build_sharded_eval_step,
    build_sharded_predict_step,
    build_sharded_train_step,
    gather_rows,
    slice_batch,
)
from tf_repos_tpu_torch.train import loop as L
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax, sparse_state_from_jax
from tf_repos_tpu_torch.utils.tree import tree_map

JOIN_S = 120


def shared(tmp_path_factory, key, compute):
    """compute() once a test session, whatever the pytest-xdist worker
    that asks first (the others wait on a file lock and read its pickled
    result from the session's shared temporary directory), so a spawned
    scenario and its JAX reference run once however the tests of a module
    are spread over the workers."""
    import fcntl
    import pickle

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"mesh-{key}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = compute()
        with open(path, "wb") as f:
            pickle.dump(out, f)
        return out


def spawn(fn, *args, mesh):
    """rank 0's result of fn(mesh, *args) on a gloo CPU mesh."""
    d, m = mesh
    return run_on_mesh(fn, args, data=d, model=m, devices=["cpu"] * (d * m), timeout=JOIN_S)


def _np(x):
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _tensors(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def padded_tables(params, names, mesh):
    """The whole pad_vocab-padded tables from the shards."""
    return {t: _np(gather_rows(params[t], mesh, params[t].shape[0] * mesh.model))
            for t in names}


# ------------------------------------------------------------ rank programs
def rank_layout(mesh):
    """(rank, d, m, backend, the data group's and the model group's sums of
    rank + 1)."""
    a = torch.tensor([float(mesh.rank + 1)])
    b = torch.tensor([float(mesh.rank + 1)])
    mesh.sum_data(a)
    mesh.sum_model(b)
    out = [(mesh.rank, mesh.d, mesh.m, mesh.backend, a.item(), b.item())]
    # every rank's row, through the model and data sums
    rows = torch.zeros(mesh.size, 6, dtype=torch.float64)
    rows[mesh.rank] = torch.tensor([mesh.rank, mesh.d, mesh.m, 0, a.item(), b.item()],
                                   dtype=torch.float64)
    mesh.sum_model(rows)
    mesh.sum_data(rows)
    return out + [tuple(r) for r in rows.tolist()]


def rank_lookup(mesh, table_np, ids_np, cot_np):
    """The sharded lookup of the padded table at ids, and the gradient of
    sum(out * cot) with respect to each rank's shard, as the whole
    padded gradient."""
    from tf_repos_tpu_torch.ops.embedding import make_sharded_lookup
    from tf_repos_tpu_torch.utils.convert import shard_of

    shard = torch.from_numpy(shard_of(table_np, (mesh.m, mesh.model)).copy()).requires_grad_(True)
    lookup = make_sharded_lookup(mesh.m, mesh.model, mesh.model_group)
    out = lookup(shard, torch.from_numpy(ids_np))
    (g,) = torch.autograd.grad((out * torch.from_numpy(cot_np)).sum(), [shard])
    return _np(out), _np(gather_rows(g, mesh, table_np.shape[0]))


def rank_raises(mesh):
    if mesh.rank == mesh.size - 1:
        raise ValueError("rank fails on purpose")
    mesh.barrier()


def rank_dense(mesh, cfg_kw, params_np, mstate_np, batches, eval_batches=(), eval_params=None):
    """Steps of the dense sharded step from a JAX mesh state (tables padded
    by pad_vocab); then, from ``eval_params``, the sharded eval over
    ``eval_batches`` and the sharded predict of the first of them."""
    cfg = Config(**cfg_kw)
    model = create_model(cfg)
    tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
    names = model.sharded_params()
    shard = (mesh.m, mesh.model)
    params, mstate = params_from_jax(params_np, mstate_np, shard=shard, sharded=names)
    opt = tx.init(params)
    step = build_sharded_train_step(model, tx, mesh)
    losses = []
    for b in batches:
        params, opt, mstate, loss = step(params, opt, mstate, _tensors(slice_batch(b, mesh)))
        losses.append(float(loss))
    out = {"losses": losses, "tables": padded_tables(params, names, mesh),
           "params": tree_map(_np, {k: v for k, v in params.items() if k not in names}),
           "mstate": tree_map(_np, mstate)}
    if eval_batches:
        ep, em = params_from_jax(eval_params, mstate_np, shard=shard, sharded=names)
        estep = build_sharded_eval_step(model, mesh)
        acc = L.init_eval_acc(model, "cpu")
        for b in eval_batches:
            acc = estep(ep, em, acc, _tensors(slice_batch(b, mesh)))
        out["eval"] = L.finalize_eval(acc)
        out["auc_state"] = {k: [_np(x) for x in v] for k, v in acc["auc"].items()}
        pstep = build_sharded_predict_step(model, mesh)
        out["pred"] = _np(pstep(ep, em, _tensors(slice_batch(eval_batches[0], mesh)))["prob"])
    return out


def rank_sparse(mesh, cfg_kw, params_np, mstate_np, aux_np, batches, pallas=True):
    """Steps of the sharded lazy step from a JAX mesh state (params and
    the row-optimizer state padded by pad_vocab) on mapped batches; the
    stores come back whole and padded, their spare rows dropped."""
    from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup

    cfg = Config(**cfg_kw)
    model = create_model(cfg)
    tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
    sopt = SP.make_sparse_row_optimizer(cfg.optimizer, cfg.learning_rate,
                                        fused_table=cfg.fused_table, catchup=cfg.sparse_catchup,
                                        dma_scatter=cfg.dma_scatter)
    slots = model.sparse_slots()
    names = list(slots)
    shard = (mesh.m, mesh.model)
    params, mstate = params_from_jax(params_np, mstate_np, shard=shard, sharded=names)
    sparse = {t: sparse_state_from_jax(aux_np[t], params_np[t], shard=shard) for t in names}
    for t in names:
        params[t] = sopt.table(sparse[t])
    opt = {"dense": tx.init({k: v for k, v in params.items() if k not in names}),
           "sparse": sparse}
    step = build_sharded_sparse_train_step(
        model, tx, sopt, mesh, {t: s.vocab for t, s in slots.items()},
        inner_lookup=make_expand_lookup() if pallas else None)
    losses = []
    for b in batches:
        params, opt, mstate, loss = step(params, opt, mstate, _tensors(slice_batch(b, mesh)))
        losses.append(float(loss))
    stores = {}
    for t in names:
        aux = opt["sparse"][t]
        for k, v in aux.items():
            if isinstance(v, torch.Tensor) and v.dim():
                vl = v.shape[0] - 1
                stores[f"{t}/{k}"] = _np(gather_rows(v, mesh, vl * mesh.model, spare=True)[:-1])
    return {"losses": losses, "stores": stores,
            "params": tree_map(_np, {k: v for k, v in params.items() if k not in names})}


def rank_harness_state(mesh, cfg_kw):
    """The harness's restore_or_init under this mesh, assembled back into
    the single-device state (what a checkpoint holds)."""
    from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
    from tf_repos_tpu_torch.train.harness import Harness

    h = Harness(Config(**cfg_kw), mesh)
    ts = h.restore_or_init(CheckpointManager(h.model_dir))
    step = ts.pop("step")
    full = h._sharded.assemble(ts)
    return {"step": step, "state": tree_map(_np, full)}


# ------------------------------------------------------------------ tests
def test_rank_that_raises_ends_the_run():
    """One rank's exception ends the whole run with an error, and no rank
    is left running."""
    import multiprocessing

    before = set(multiprocessing.active_children())
    with pytest.raises(Exception) as e:
        spawn(rank_raises, mesh=(2, 1))
    assert "rank fails on purpose" in str(e.value) or "terminated" in str(e.value)
    assert set(multiprocessing.active_children()) <= before


def test_cli_mesh_rank_failure_exits_nonzero(tmp_path):
    """The CLI on a 1x2 mesh whose ranks raise (no input files) exits
    nonzero."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "tf_repos_tpu_torch.main", "--model=DeepFM", "--feature_size=100",
         "--field_size=4", "--batch_size=8", f"--data_dir={tmp_path}", f"--model_dir={tmp_path}/m",
         "--device=cpu", "--mesh_model=2"],
        cwd=repo, capture_output=True, text=True, timeout=JOIN_S)
    assert r.returncode != 0
    assert "FileNotFoundError" in r.stderr


def rank_jobs(mesh, jobs):
    """Several rank programs in one spawn: [(name, args), ...] -> results."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def rank_restore_then_train(mesh, cfg_kw):
    """The state this mesh restores (assembled back into the single-device
    state), then one more train run under the mesh from it."""
    from tf_repos_tpu_torch.train.harness import Harness

    out = rank_harness_state(mesh, cfg_kw)
    out["metrics"] = Harness(Config(**cfg_kw), mesh).train()
    return out


def rank_port_sparse(mesh, cfg_kw, batches):
    """The port's own init (seeded, on the CPU) cut into this rank's
    shards, then steps of the sharded lazy step on this rank's device
    with the kernels there (their plain versions on the CPU): the losses,
    the assembled fused store and every rank's launch counts of K1-K4
    and K7."""
    import torch.distributed as dist

    from tf_repos_tpu_torch.ops import coo_pool as CP
    from tf_repos_tpu_torch.ops import row_scatter as RS
    from tf_repos_tpu_torch.ops import sparse_rows as SR
    from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
    from tf_repos_tpu_torch.parallel.sparse_step import ShardedSparseState

    cfg = Config(**cfg_kw)
    model = create_model(cfg)
    tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
    sopt = SP.make_sparse_row_optimizer(cfg.optimizer, cfg.learning_rate, fused_table=True,
                                        dma_scatter=cfg.dma_scatter)
    params, mstate = model.init(torch.Generator().manual_seed(9))
    if cfg.param_dtype == "bfloat16":
        params = SP.cast_tables(model, params, torch.bfloat16)
    opt = SP.init_opt_state(model, tx, sopt, params)
    st = ShardedSparseState(model, sopt, mesh)
    state = st.shard({"params": params, "opt_state": opt, "mstate": mstate})
    params, opt, mstate = state["params"], state["opt_state"], state["mstate"]
    step = build_sharded_sparse_train_step(model, tx, sopt, mesh, st.vocab,
                                           inner_lookup=make_expand_lookup())
    kernels = (SR.expand_rows, SR.accumulate_rows, CP.coo_pool_rows, CP.coo_accumulate_rows,
               RS.dma_row_scatter)
    for mod in (SR, CP, RS):
        mod.reset_launches()
    losses = []
    # the rounding's generator alike on every rank (a bf16 store draws)
    sr = torch.Generator(device=mesh.device).manual_seed(5)
    for b in batches:
        b = {k: v.to(mesh.device) for k, v in _tensors(slice_batch(b, mesh)).items()}
        params, opt, mstate, loss = step(params, opt, mstate, b, None, sr)
        losses.append(float(loss))
    counts = torch.zeros(mesh.size, len(kernels), dtype=torch.int64)
    counts[mesh.rank] = torch.tensor([f.launches for f in kernels])
    dist.all_reduce(counts)
    full = st.assemble({"params": params, "opt_state": opt, "mstate": mstate})
    (t,) = model.sparse_slots()
    store = full["opt_state"]["sparse"][t]["wmv"]
    return {"losses": losses, "store": _np(store), "counts": counts.tolist(),
            "store_bits": store.view(torch.int16).numpy() if store.dtype == torch.bfloat16 else None}


def rank_uids_union(mesh, cfg_kw, host_batches, bucket):
    """Each rank one "host" (the world its host group): the port's host
    map chain (the width bucketer under ``bucket``, the COO packer over
    one local data shard under --mh_coo, the dedup mapper) on its own
    batches, then GlobalUidsUnion; every rank's unioned batches."""
    import torch.distributed as dist

    from tf_repos_tpu_torch.data.ragged import MH_PAIRS
    from tf_repos_tpu_torch.data.sparse_batch import (
        GlobalUidsUnion,
        MhCooPacker,
        MhPadBucketer,
        SparseBatchMapper,
    )
    from tf_repos_tpu_torch.parallel.distributed import set_host_group

    set_host_group(mesh.size, mesh.rank, None)
    cfg = Config(**cfg_kw)
    model = create_model(cfg)
    slots = model.sparse_slots()
    chain = []
    if bucket:
        chain.append(MhPadBucketer(MH_PAIRS, "pow2"))
    if cfg.mh_coo:
        chain.append(MhCooPacker(model.mh_coo_groups(), floor=8, n_data=1))
    chain.append(SparseBatchMapper(slots))
    union = GlobalUidsUnion(slots, bucketed_pairs=MH_PAIRS if bucket else ())
    out = []
    for b in host_batches[mesh.rank]:
        b = dict(b)
        for stage in chain:
            b = stage(b)
        out.append(union(b))
    every = [None] * mesh.size
    dist.all_gather_object(every, out)
    return every
