"""The port's DeepFM against the JAX package's on converted weights
(utils/convert.params_from_jax) and the same numpy batch, in f32.
Logits are held to 1e-5 (float32 sums in another order); gradients to
1e-5 relative / 1e-7 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.train import loop as JL
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.train import loop as TL
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten

KW = dict(
    model="DeepFM", feature_size=300, field_size=10, embedding_size=4,
    deep_layers="16,8", dropout="1.0,1.0", batch_size=24, l2_reg=1e-3,
)


def _setup(static=3, **over):
    kw = dict(KW, static_fields=static, **over)
    jm, tm = jax_create_model(JaxConfig(**kw)), create_model(Config(**kw))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    rng = np.random.default_rng(1)
    b = 24
    ids = rng.integers(1, 300, size=(b, 10)).astype(np.int32)
    ids[:, :3] = np.arange(1, 4)  # the Criteo static layout
    batch = {
        "feat_ids": ids,
        "feat_vals": rng.random((b, 10)).astype(np.float32),
        "label": (rng.random(b) < 0.5).astype(np.float32),
        "mask": np.concatenate([np.ones(b - 4), np.zeros(4)]).astype(np.float32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jm, tm, jp, js, tp, ts, jb, tb


@pytest.mark.parametrize("static", [0, 3])
def test_forward_logits_match(static):
    jm, tm, jp, js, tp, ts, jb, tb = _setup(static)
    oj, _ = jm.apply(jp, js, jb, train=False)
    ot, _ = tm.apply(tp, ts, tb, train=False)
    np.testing.assert_allclose(ot["logits"].numpy(), np.asarray(oj["logits"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ot["prob"].numpy(), np.asarray(oj["prob"]), rtol=1e-5, atol=1e-6)


def test_static_path_equals_dynamic_path():
    _, tm3, _, _, tp, ts, _, tb = _setup(3)
    tm0 = create_model(Config(**dict(KW, static_fields=0)))
    l3 = tm3.apply(tp, ts, tb, train=False)[0]["logits"]
    l0 = tm0.apply(tp, ts, tb, train=False)[0]["logits"]
    np.testing.assert_allclose(l3.numpy(), l0.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("static", [0, 3])
def test_gradients_match(static):
    jm, tm, jp, js, tp, ts, jb, tb = _setup(static)
    (lj, _), gj = jax.value_and_grad(
        lambda p: jm.loss(p, js, jb, train=True), has_aux=True
    )(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    lt, _ = tm.loss(tree_unflatten(tp, leaves), ts, tb, train=True)
    gt = tree_unflatten(tp, list(torch.autograd.grad(lt, leaves)))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    # the table gradient first: the scatter-add of the lookup's backward
    np.testing.assert_allclose(gt["fm_wv"].numpy(), np.asarray(gj["fm_wv"]), rtol=1e-5, atol=1e-7)
    for a, b in zip(tree_leaves(gt), jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_bf16_towers_forward_close():
    jm, tm, jp, js, tp, ts, jb, tb = _setup(3, compute_dtype="bfloat16")
    oj, _ = jm.apply(jp, js, jb, train=False)
    ot, _ = tm.apply(tp, ts, tb, train=False)
    # one extra bf16 rounding per GEMM result (ops/towers.py)
    np.testing.assert_allclose(ot["logits"].numpy(), np.asarray(oj["logits"]), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", ["wide_n_deep", "widedeep", "wdl", "wide", "deep"])
def test_unported_models_raise(name):
    with pytest.raises(NotImplementedError, match=name):
        create_model(Config(model=name))


def test_predict_and_eval_steps_match_jax():
    jm, tm, jp, js, tp, ts, jb, tb = _setup(3)
    pj = JL.build_predict_step(jm)(jp, js, jb)
    pt = TL.build_predict_step(tm)(tp, ts, tb)
    np.testing.assert_allclose(pt["prob"].numpy(), np.asarray(pj["prob"]), rtol=1e-5, atol=1e-6)
    rj = JL.finalize_eval(JL.build_eval_step(jm)(jp, js, JL.init_eval_acc(jm), jb))
    rt = TL.finalize_eval(TL.build_eval_step(tm)(tp, ts, TL.init_eval_acc(tm, "cpu"), tb))
    assert rt.keys() == rj.keys()
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5)
