"""The port's dense sharded steps (parallel/step.py) on gloo CPU ranks
against the JAX package's shard_map steps on the 8-virtual-device rig,
from the same weights (the JAX mesh state, padded by pad_vocab, converted
into each rank's shard) on the same batches, at tests/test_parallel.py's
configuration: DeepFM and DCN under GD on meshes (2, 1), (1, 2) and
(2, 2) with losses to rtol 2e-4 / atol 2e-5 and tables to rtol 2e-3 /
atol 2e-5 (the JAX package's sharded-vs-single bar), padding rows exactly
0; on (2, 2) the Adam loss trace, eval, predict and batch norm. One
spawn a mesh shape serves each group of tests, once a session
(test_torch_mesh_ranks.shared)."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data.synthetic import synthetic_criteo_batch
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.parallel import step as S
from tf_repos_tpu.parallel.mesh import make_mesh
from tf_repos_tpu.train import loop as JL
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from test_torch_mesh_ranks import rank_jobs, shared, spawn

KW = dict(model="DeepFM", feature_size=1000, field_size=39, embedding_size=8,
          deep_layers="16,8", dropout="1.0,1.0", batch_size=64, learning_rate=0.01,
          l2_reg=0.001, optimizer="Adam")
TABLE = {"DeepFM": "fm_wv", "dcn": "emb"}
MESHES = [(2, 1), (1, 2), (2, 2)]


def _batches(cfg, n, seed0=0):
    return [synthetic_criteo_batch(np.random.default_rng(seed0 + s), cfg.batch_size,
                                   cfg.feature_size) for s in range(n)]


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def jax_sharded_run(kw, mesh_shape, n_steps):
    """The JAX package's sharded train step from its ShardedState init:
    (initial params and mstate, batches, losses, final state), numpy."""
    cfg = JaxConfig(**kw)
    model = jax_create_model(cfg)
    tx = jax_make_optimizer(cfg.optimizer, cfg.learning_rate)
    mesh = make_mesh(data=mesh_shape[0], model=mesh_shape[1])
    ss = S.ShardedState(model, tx, mesh)
    state, specs = ss.init(jax.random.PRNGKey(cfg.seed))
    init = _np_tree(state)
    step = S.build_sharded_train_step(model, tx, mesh, specs)
    batches = _batches(cfg, n_steps)
    losses = []
    rng = jax.random.PRNGKey(123)
    for b in batches:
        state, loss = step(state, ss.place_batch(b), rng)
        losses.append(float(loss))
    return init, batches, losses, _np_tree(state)


def _job(kw, init, batches, **extra):
    return ("rank_dense", (kw, init["params"], init["mstate"], batches) + tuple(extra.values()))


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def gd_runs(request, tmp_path_factory):
    mesh_shape = request.param
    return shared(tmp_path_factory, f"gd-{mesh_shape[0]}x{mesh_shape[1]}",
                  lambda: _gd_runs(mesh_shape))


def _gd_runs(mesh_shape):
    runs, jobs = {}, []
    for name in TABLE:
        kw = dict(KW, model=name, optimizer="GD", learning_rate=0.1)
        init, batches, losses, state = jax_sharded_run(kw, mesh_shape, 3)
        runs[name] = (losses, state)
        jobs.append(_job(kw, init, batches))
    got = spawn(rank_jobs, jobs, mesh=mesh_shape)
    return {name: (runs[name], g) for name, g in zip(TABLE, got)}


@pytest.mark.parametrize("name", list(TABLE))
def test_dense_gd_matches_jax_sharded(gd_runs, name):
    (jl, jstate), got = gd_runs[name]
    np.testing.assert_allclose(got["losses"], jl, rtol=2e-4, atol=2e-5)
    key = TABLE[name]
    want = jstate["params"][key]
    tab = got["tables"][key]
    assert tab.shape == want.shape  # the same pad_vocab padding
    v = 1000
    np.testing.assert_allclose(tab[:v], want[:v], rtol=2e-3, atol=2e-5)
    assert np.all(tab[v:] == 0.0)
    # the replicated params too
    for k in (k for k in jstate["params"] if k != key):
        for a, b in zip(jax.tree.leaves(jstate["params"][k]), jax.tree.leaves(got["params"][k])):
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-5)


@pytest.fixture(scope="module")
def adam_runs(tmp_path_factory):
    return shared(tmp_path_factory, "adam", _adam_runs)


def _adam_runs():
    """(2, 2): the Adam trace with eval and predict from the initial
    weights, and DeepFM with batch norm."""
    mesh_shape = (2, 2)
    init, batches, losses, _ = jax_sharded_run(KW, mesh_shape, 4)
    bn_kw = dict(KW, batch_norm=True)
    bn_init, bn_batches, bn_losses, bn_state = jax_sharded_run(bn_kw, mesh_shape, 2)

    cfg = JaxConfig(**KW)
    model = jax_create_model(cfg)
    mesh = make_mesh(data=2, model=2)
    params, mstate = init["params"], init["mstate"]
    pspec = S._spec_tree_like(params, model.param_spec())
    placed = jax.device_put(params, S.make_shardings(mesh, pspec))
    specs = {"params": pspec, "mstate": jax.tree.map(lambda _: P(), mstate)}
    evb = _batches(cfg, 3, seed0=50)
    estep = S.build_sharded_eval_step(model, mesh, specs)
    acc = JL.init_eval_acc(model)
    for b in evb:
        acc = estep(placed, mstate, acc, b)
    ev = JL.finalize_eval(acc)
    auc = {k: [np.asarray(x) for x in v] for k, v in acc["auc"].items()}
    pred = np.asarray(S.build_sharded_predict_step(model, mesh, specs)(placed, mstate, evb[0])["prob"])

    got, got_bn = spawn(rank_jobs, [
        ("rank_dense", (KW, params, mstate, batches, evb, params)),
        ("rank_dense", (bn_kw, bn_init["params"], bn_init["mstate"], bn_batches)),
    ], mesh=mesh_shape)
    return {"adam": (losses, got), "eval": (ev, auc, pred, got),
            "bn": (bn_losses, bn_state, got_bn)}


def test_adam_loss_trace_matches_jax_sharded(adam_runs):
    jl, got = adam_runs["adam"]
    np.testing.assert_allclose(got["losses"], jl, rtol=2e-4, atol=2e-5)


def test_sharded_eval_matches_jax(adam_runs):
    ev, auc, _, got = adam_runs["eval"]
    for k in ev:
        np.testing.assert_allclose(got["eval"][k], ev[k], rtol=1e-4, atol=1e-5)
    # the streaming AUC counts, summed over "data"
    for name, parts in auc.items():
        for a, b in zip(parts, got["auc_state"][name]):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_sharded_predict_matches_jax_in_global_order(adam_runs):
    _, _, pred, got = adam_runs["eval"]
    assert got["pred"].shape == pred.shape
    np.testing.assert_allclose(got["pred"], pred, rtol=1e-5, atol=1e-6)


def test_batch_norm_under_mesh_matches_jax(adam_runs):
    """Batch statistics from each data slice, moving stats averaged over
    "data": the losses and the carried state equal the JAX package's."""
    jl, jstate, got = adam_runs["bn"]
    np.testing.assert_allclose(got["losses"], jl, rtol=2e-4, atol=2e-5)
    want = jax.tree.leaves(jstate["mstate"])
    have = jax.tree.leaves(got["mstate"])
    assert len(want) == len(have) and want
    for a, b in zip(want, have):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-6)
    mean0 = got["mstate"]["mlp"]["layers"][0]["bn"]["mean"]
    assert np.abs(mean0).sum() > 0
