"""The port's dense optimizers (tf_repos_tpu_torch/train/optimizers.py)
against the JAX package's make_optimizer (optax's sgd and momentum, its
adagrad_tf, ftrl and the canned wdl composite) on one parameter tree with
Wide&Deep's top-level names, 5 steps of the same seeded gradients.

Held to 1e-6 relative and absolute: the same f32 formulas, where only
``rsqrt`` and ``power(n, 0.5)`` may round differently in the last ulp
(the Adam test of tests/test_torch_ops.py holds the same bar)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_repos_tpu.train import optimizers as JO
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.train import optimizers as TO
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_map


def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.1  # noqa: E731
    return {"bias": f(1), "wide_cont": f(13), "wide_cat": f(50), "emb": f(50, 4),
            "mlp": {"layers": [{"dense": {"w": f(6, 3), "b": f(3)}}]}, "out": {"w": f(3, 1)}}


CASES = [("GD", "wide_n_deep"), ("SGD", "wide_n_deep"), ("Momentum", "wide_n_deep"),
         ("Adagrad", "wide_n_deep"), ("ftrl", "wide_n_deep"), ("wdl", "wide"), ("wdl", "deep"),
         ("wdl", "wide_n_deep")]


@pytest.mark.parametrize("name,model_type", CASES)
def test_dense_optimizer_matches_jax(name, model_type):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    lr = 0.05
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # wdl at a non-default rate warns; tested below
        jtx = JO.make_optimizer(name, lr, model_type)
        ttx = TO.make_optimizer(name, lr, model_type)
    pj = jax.tree.map(jnp.asarray, params)
    sj = jtx.init(pj)
    pt = tree_map(torch.from_numpy, jax.tree.map(np.copy, params))
    st = ttx.init(pt)
    for _ in range(5):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.3, params)
        g["wide_cat"][:10] = 0.0  # untouched entries: FTRL rebuilds them from (z, n)
        upd, sj = jtx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        ttx.update_(tree_leaves(pt), [torch.from_numpy(x) for x in jax.tree.leaves(g)], st)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_canned_wdl_rates_match_jax(model_type):
    assert TO.canned_wdl_rates(model_type) == JO.canned_wdl_rates(model_type)


def test_wdl_composite_splits_on_top_level_wide_keys():
    """FTRL on the wide* leaves (bias is deep), Adagrad from 0.1 on the
    rest, at wide_n_deep's canned rates."""
    params = tree_map(torch.from_numpy, _tree(np.random.default_rng(0)))
    tx = TO.make_optimizer("wdl", TO._DEFAULT_CLI_LR, "wide_n_deep")
    st = tx.init(params)
    # leaves in tree_leaves order: bias, emb, mlp b and w, out w, wide_cat, wide_cont
    assert st["labels"] == ["deep"] * 5 + ["wide"] * 2
    assert sorted(st["deep"]["accum"]) == ["bias", "emb", "mlp", "out"]
    assert sorted(st["wide"]["n"]) == ["wide_cat", "wide_cont"]
    assert float(st["deep"]["accum"]["bias"][0]) == pytest.approx(0.1)
    assert (tx.parts["wide"].lr, tx.parts["deep"].lr) == (0.005, 0.001)


@pytest.mark.parametrize("lr,warns", [(TO._DEFAULT_CLI_LR, False), (0.01, True)])
def test_wdl_lr_warning(lr, warns):
    assert TO._DEFAULT_CLI_LR == Config().learning_rate
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        TO.make_optimizer("wdl", lr, "wide")
    msgs = [str(x.message) for x in w if "ignores --learning_rate" in str(x.message)]
    assert bool(msgs) == warns
    if warns:
        assert "model_type='wide'" in msgs[0]


@pytest.mark.parametrize("name", ["adamw", "rmsprop", ""])
def test_unknown_optimizer_raises(name):
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.make_optimizer(name, 1e-3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        JO.make_optimizer(name, 1e-3)
