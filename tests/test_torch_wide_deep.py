"""The port's Wide&Deep (tf_repos_tpu_torch/models/wide_deep.py) against
the JAX package's, on converted weights (utils/convert.params_from_jax,
which carries its tree, the 1-D wide_cat included) and the same numpy
batches, f32, dropout keep 1.0: the forward and every gradient leaf for
each model_type, 3-step dense trajectories under wdl, Adagrad and FTRL,
the id rule, the registry's names, the harness's dense fallback under
--sparse_table_update, --field_blocks (raising where JAX raises, running
where it runs), and the CLI lifecycle on csv files.

Tolerances: logits 1e-5; gradient leaves 1e-5 relative to each leaf's
largest entry plus 1e-7; trajectories: loss 2e-5 relative (the JAX
package's bar between two formulations of one step), tables 1e-5, the
other weights 1e-4 (Adagrad normalises its first steps, so a weight whose
gradient is mostly cancellation steps by its round-off, as
tests/test_torch_zoo.py says)."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.models.wide_deep import WideDeep as JaxWideDeep
from tf_repos_tpu.ops import pallas_embedding as PE
from tf_repos_tpu.train.harness import Harness as JaxHarness
from tf_repos_tpu.train.loop import build_train_step as jax_build_train_step
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch import main as M
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.synthetic import write_synthetic_csv
from tf_repos_tpu_torch.models import create_model, input_format
from tf_repos_tpu_torch.models.wide_deep import WideDeep
from tf_repos_tpu_torch.ops import field_block as FB
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.train.loop import build_train_step
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten

B = 16
BASE = dict(embedding_size=4, deep_layers="8,4", dropout="1.0,1.0", batch_size=B,
            feature_size=0, field_size=39)
TABLES = ("wide_cat", "emb")


def _batches(n, seed=3):
    """cont in [0, 1), ids over [-5, 10010): a few outside the buckets."""
    rng = np.random.default_rng(seed)
    return [{"cont": rng.random((B, 13)).astype(np.float32),
             "cat": rng.integers(-5, 10_010, (B, 26)).astype(np.int32),
             "label": (rng.random(B) < 0.5).astype(np.float32),
             "mask": np.concatenate([np.ones(B - 3), np.zeros(3)]).astype(np.float32)}
            for _ in range(n)]


def _setup(model, randomize=False, **over):
    """JAX and port models from one Config; the JAX init weights (random
    normal ones with ``randomize``: wide_n_deep starts its wide part at 0)
    on both sides."""
    kw = dict(BASE, model=model, **over)
    jm = jax_create_model(JaxConfig(**kw))
    jp, js = jm.init(jax.random.PRNGKey(0))
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    if randomize:
        rng = np.random.default_rng(1)
        jp = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32), jp)
    tp, ts = params_from_jax(jp, js)
    tm = create_model(Config(**kw, device="cpu"))
    return jm, jax.tree.map(jnp.array, jp), jax.tree.map(jnp.array, js), tm, tp, ts


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("model", ["wide", "deep", "wide_n_deep"])
def test_forward_and_grads_match_jax(model):
    jm, jp, js, tm, tp, ts = _setup(model, randomize=True)
    assert [tuple(a.shape) for a in tree_leaves(tp)] == [a.shape for a in jax.tree.leaves(jp)]
    b = _batches(1)[0]
    oj, _ = jm.apply(jp, js, _jb(b), train=False)
    ot, _ = tm.apply(tp, ts, _tb(b), train=False)
    np.testing.assert_allclose(ot["logits"].numpy(), np.asarray(oj["logits"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ot["prob"].numpy(), np.asarray(oj["prob"]), rtol=1e-5, atol=1e-6)
    gj = jax.grad(lambda p: jm.loss(p, js, _jb(b), train=True,
                                    rng=jax.random.PRNGKey(0))[0])(jp)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tp)]
    loss, _ = tm.loss(tree_unflatten(tp, leaves), ts, _tb(b), train=True)
    gt = torch.autograd.grad(loss, leaves)
    for a, w in zip(gt, jax.tree.leaves(gj)):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-7 + 1e-5 * np.abs(w).max())


CASES = [("wdl", "wide"), ("wdl", "deep"), ("wdl", "wide_n_deep"), ("Adagrad", "wide_n_deep"),
         ("ftrl", "wide_n_deep")]


@pytest.mark.parametrize("opt,model", CASES)
def test_dense_trajectory_matches_jax(opt, model):
    lr = 0.0005 if opt == "wdl" else 0.05  # wdl: the default rate, which it ignores silently
    jm, jp, js, tm, tp, ts = _setup(model, learning_rate=lr)
    jtx, ttx = jax_make_optimizer(opt, lr, model), make_optimizer(opt, lr, model)
    jo, to = jtx.init(jp), ttx.init(tp)
    jstep, tstep = jax_build_train_step(jm, jtx), build_train_step(tm, ttx)
    key = jax.random.PRNGKey(1)
    for i, b in enumerate(_batches(3, seed=5)):
        jp, jo, js, lj = jstep(jp, jo, js, _jb(b), key)
        tp, to, ts, lt = tstep(tp, to, ts, _tb(b))
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
    for k in sorted(jp):
        tol = 1e-5 if k in TABLES else 1e-4
        for a, w in zip(tree_leaves(tp[k]), jax.tree.leaves(jp[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=tol, err_msg=k)


def test_offset_ids_match_jax():
    cat = np.zeros((2, 26), np.int32)
    cat[0, :6] = [-1, 0, 9_999, 10_000, 123_456, -10_000]
    cat[1] = np.arange(26) * 300 + 7
    got = WideDeep._offset_ids(torch.from_numpy(cat)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JaxWideDeep._offset_ids(jnp.asarray(cat))))
    assert got[0, :6].tolist() == [0, 10_000, 29_999, 30_000, 40_000, 50_000]
    assert got[1, 25] == 25 * 10_000 + 25 * 300 + 7


@pytest.mark.parametrize("alias,model_type", [("wide_n_deep", "wide_n_deep"),
                                              ("widedeep", "wide_n_deep"), ("wdl", "wide_n_deep"),
                                              ("wide", "wide"), ("deep", "deep")])
def test_registry_aliases(alias, model_type):
    tm = create_model(Config(model=alias, device="cpu"))
    jm = jax_create_model(JaxConfig(model=alias))
    assert isinstance(tm, WideDeep) and tm.model_type == jm.model_type == model_type
    assert tm.name == jm.name == "wide_n_deep" and input_format(tm) == "csv"
    assert tm.sparse_slots() == {} and jm.sparse_slots() == {}


def test_sparse_table_update_without_slots_takes_the_dense_step(capsys):
    """Both packages print the same warning and build the dense step."""
    kw = dict(BASE, model="wide_n_deep", sparse_table_update=True, optimizer="Adagrad",
              learning_rate=0.05)
    JaxHarness(JaxConfig(**kw))
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("WARNING")]
    h = Harness(Config(**kw, device="cpu"))
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("WARNING")]
    assert got == want == ["WARNING: --sparse_table_update: wide_n_deep declares no sparse "
                           "tables; using the dense path"]
    assert h._sopt is None and h.inner_lookup() is None
    state = h.init_train_state()
    assert "sparse" not in state["opt_state"]
    state, loss = h._get_train_step()(
        {k: state[k] for k in ("params", "opt_state", "mstate")}, _tb(_batches(1)[0]), None)
    assert np.isfinite(float(loss))


FB_CASES = [("wide_n_deep", 26), ("wide", 26), ("deep", 26), ("deep", 39)]


@pytest.mark.parametrize("model,nblocks", FB_CASES)
def test_field_blocks_as_jax(model, nblocks):
    """The JAX package's field-block backward fails on the 1-D wide_cat
    (a shape error) and on a block count other than the 26 fields (an
    assertion); the port refuses both with a ValueError. deep over the 26
    column blocks runs in both, with the same loss and table."""
    if nblocks == 26:
        offsets, sizes = tuple(range(0, 260_000, 10_000)), (10_000,) * 26
    else:
        offsets, sizes = tuple(range(nblocks)), (1,) * nblocks
    jm, jp, js, tm, tp, ts = _setup(model, learning_rate=0.05)
    jtx, ttx = jax_make_optimizer("Adagrad", 0.05), make_optimizer("Adagrad", 0.05)
    jstep = jax_build_train_step(jm, jtx, lookup=PE.make_field_block_lookup(0, offsets, sizes))
    tstep = build_train_step(tm, ttx, lookup=FB.make_field_block_lookup(0, offsets, sizes))
    b = _batches(1, seed=8)[0]
    jo, to = jtx.init(jp), ttx.init(tp)
    if model != "deep" or nblocks != 26:
        with pytest.raises((ValueError, AssertionError)):
            jstep(jp, jo, js, _jb(b), jax.random.PRNGKey(1))
        with pytest.raises(ValueError, match="--field_blocks"):
            tstep(tp, to, ts, _tb(b))
        return
    jp, jo, js, lj = jstep(jp, jo, js, _jb(b), jax.random.PRNGKey(1))
    tp, to, ts, lt = tstep(tp, to, ts, _tb(b))
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
    np.testing.assert_allclose(tp["emb"].numpy(), np.asarray(jp["emb"]), rtol=1e-5, atol=1e-5)


def test_cli_lifecycle(tmp_path, capsys):
    """train (wdl, with --sparse_table_update's dense fallback), eval,
    eval_loop, infer and export through the CLI on the port's csv files;
    then the servable's signature is the csv one."""
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_csv(str(d / "tr.csv"), 120, seed=0)
    write_synthetic_csv(str(d / "va.csv"), 60, seed=1)
    write_synthetic_csv(str(d / "te.csv"), 30, seed=2)
    flags = ["--model=wide_n_deep", "--embedding_size=4", "--deep_layers=8,4",
             "--dropout=1.0,1.0", "--batch_size=16", "--num_epochs=1", "--log_steps=5",
             f"--data_dir={d}", f"--model_dir={tmp_path}/model/", "--dt_dir=x",
             "--eval_throttle_secs=0", "--optimizer=wdl", "--sparse_table_update=true",
             "--eval_loop_secs=1", "--eval_loop_timeout=1", "--device=cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # wdl at the default rate: silent
        res = M.main(["--task_type=train", *flags])
    assert res["step"] == 8 and np.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0
    assert "using the dense path" in capsys.readouterr().out
    for task in ("eval", "eval_loop"):
        ev = M.main([f"--task_type={task}", *flags])
        assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
        assert ev["auc"] == pytest.approx(res["auc"], rel=1e-6)
    out = M.main(["--task_type=infer", *flags])
    preds = [float(x) for x in open(out).read().split()]
    assert len(preds) == 30 and all(0.0 <= p <= 1.0 for p in preds)
    version = M.main(["--task_type=export", *flags])
    with open(os.path.join(version, "saved_model.json")) as f:
        sig = json.load(f)
    assert sig["inputs"] == {"cont": {"dtype": "float32", "shape": [None, 13]},
                             "cat": {"dtype": "int32", "shape": [None, 26]}}
    assert sig["model"] == "wide_n_deep" and sig["config"]["optimizer"] == "wdl"
