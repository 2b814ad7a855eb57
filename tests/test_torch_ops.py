"""The port's kernel-free ops and Adam against the JAX package on the same
inputs (numpy, seeded). f32 paths are held to float32 round-off
(rtol 1e-6..1e-5: the two frameworks sum in different orders); the bf16
MLP is held to 2e-2, since torch rounds each bf16 GEMM result to bf16
before the cast to f32 (up to 2^-8 relative per activation) where JAX
returns it in f32 (ops/towers.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_repos_tpu.ops import embedding as JE
from tf_repos_tpu.ops import interactions as JI
from tf_repos_tpu.ops import metrics as JM
from tf_repos_tpu.ops import towers as JT
from tf_repos_tpu_torch.ops import embedding as E
from tf_repos_tpu_torch.ops import interactions as I
from tf_repos_tpu_torch.ops import metrics as M
from tf_repos_tpu_torch.ops import towers as T
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_map


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def test_fused_linear_lookup_matches():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 5)).astype(np.float32)
    ids = rng.integers(0, 50, size=(8, 6)).astype(np.int32)
    vals = rng.random((8, 6)).astype(np.float32)
    yj, ej = JE.fused_linear_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals))
    yt, et = E.fused_linear_lookup(*(torch.from_numpy(a) for a in (table, ids, vals)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6)


def test_fm_second_order_matches():
    emb = np.random.default_rng(1).standard_normal((16, 9, 4)).astype(np.float32)
    np.testing.assert_allclose(
        I.fm_second_order(torch.from_numpy(emb)).numpy(),
        np.asarray(JI.fm_second_order(jnp.asarray(emb))),
        rtol=1e-5, atol=1e-5,
    )


def test_glorot_normal_init_statistics():
    # different generator from jax.random: compare the distribution
    g = torch.Generator().manual_seed(0)
    w = E.glorot_normal_init(g, (400, 600)).numpy()
    std = np.sqrt(2.0 / 1000) / 0.87962566
    assert np.abs(w).max() <= 2 * std + 1e-6
    j = np.asarray(JE.glorot_normal_init(jax.random.PRNGKey(0), (400, 600)))
    np.testing.assert_allclose(w.std(), j.std(), rtol=0.01)
    t = E.fused_linear_table_init(g, 300, 4)
    assert t.shape == (300, 5) and t.dtype == torch.float32


def _mlp(batch_norm, seed=2, in_dim=12, layers=(16, 8, 4)):
    jp, js = JT.init_mlp(jax.random.PRNGKey(seed), in_dim, list(layers), batch_norm=batch_norm)
    if batch_norm:  # non-trivial BN params and moving statistics
        rng = np.random.default_rng(seed)
        for lp, ls in zip(jp["layers"], js["layers"]):
            d = lp["bn"]["scale"].shape[0]
            lp["bn"] = {"scale": jnp.asarray(rng.random(d) + 0.5, jnp.float32),
                        "bias": jnp.asarray(rng.standard_normal(d), jnp.float32)}
            ls["bn"] = {"mean": jnp.asarray(rng.random(d), jnp.float32),
                        "var": jnp.asarray(rng.random(d) + 0.5, jnp.float32)}
    tp, ts = params_from_jax(_np_tree(jp), _np_tree(js))
    x = np.random.default_rng(seed + 1).standard_normal((32, in_dim)).astype(np.float32)
    return jp, js, tp, ts, x


@pytest.mark.parametrize(
    "compute_dtype,batch_norm,train,tol",
    [(None, False, False, 1e-5), (None, True, True, 1e-5), (None, True, False, 1e-5),
     ("bfloat16", False, True, 2e-2)],
)
def test_mlp_matches(compute_dtype, batch_norm, train, tol):
    jp, js, tp, ts, x = _mlp(batch_norm)
    kw = dict(keep_probs=[1.0], train=train, batch_norm=batch_norm, bn_decay=0.9,
              compute_dtype=compute_dtype)
    yj, sj = JT.apply_mlp(jp, js, jnp.asarray(x), rng=None, **kw)
    yt, st = T.apply_mlp(tp, ts, torch.from_numpy(x), generator=None, **kw)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=tol, atol=tol)
    for a, b in zip(tree_leaves(st), jax.tree.leaves(sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches(train):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 6)).astype(np.float32) * 3 + 1
    p = {"scale": rng.random(6).astype(np.float32) + 0.5, "bias": rng.standard_normal(6).astype(np.float32)}
    s = {"mean": rng.random(6).astype(np.float32), "var": rng.random(6).astype(np.float32) + 0.5}
    yj, sj = JT.apply_bn(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                         jnp.asarray(x), train=train, decay=0.9)
    tp, ts = params_from_jax(p, s)
    yt, st = T.apply_bn(tp, ts, torch.from_numpy(x), train=train, decay=0.9)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-6, atol=1e-6)


def test_dropout_keep_prob_semantics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = T.dropout(x, 0.8, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.8)
    assert T.dropout(x, 1.0, g) is x and T.dropout(x, 0.5, None) is x


def test_losses_match():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal(64) * 4).astype(np.float32)
    labels = (rng.random(64) < 0.4).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    lt, yt, wt = (torch.from_numpy(a) for a in (logits, labels, w))
    np.testing.assert_allclose(M.sigmoid_xent(lt, yt).numpy(),
                               np.asarray(JM.sigmoid_xent(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(M.squared_loss(lt, yt).numpy(),
                               np.asarray(JM.squared_loss(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6, atol=1e-7)
    probs = 1 / (1 + np.exp(-logits))
    for weights in (None, w):
        j = JM.log_loss(jnp.asarray(labels), jnp.asarray(probs),
                        None if weights is None else jnp.asarray(weights))
        t = M.log_loss(yt, torch.from_numpy(probs), None if weights is None else wt)
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


def test_streaming_auc_matches():
    rng = np.random.default_rng(6)
    sj, st = JM.AucState.init(), M.AucState.init()
    for _ in range(3):
        labels = (rng.random(100) < 0.3).astype(np.float32)
        preds = np.clip(labels * 0.3 + rng.random(100) * 0.7, 0, 1).astype(np.float32)
        mask = (rng.random(100) < 0.9).astype(np.float32)
        sj = JM.auc_update(sj, jnp.asarray(labels), jnp.asarray(preds), jnp.asarray(mask))
        st = M.auc_update(st, *(torch.from_numpy(a) for a in (labels, preds, mask)))
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    auc = float(M.auc_finalize(st))
    np.testing.assert_allclose(auc, float(JM.auc_finalize(sj)), rtol=1e-6)
    assert 0.5 < auc <= 1.0


def test_adam_matches_optax():
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]}
    tx = optax.adam(1e-2, b1=0.9, b2=0.999, eps=1e-8)
    pj = jax.tree.map(jnp.asarray, params)
    sj = tx.init(pj)
    pt = tree_map(torch.from_numpy, jax.tree.map(np.copy, params))
    opt = make_optimizer("Adam", 1e-2)
    st = opt.init(pt)
    for _ in range(5):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 1e-2, params)
        upd, sj = tx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        opt.update_(tree_leaves(pt), [torch.from_numpy(x) for x in jax.tree.leaves(g)], st)
    # bias correction is computed in double on the host, in f32 by optax:
    # a few ulps of the parameters after 5 steps (1e-4 of one step's lr)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["Adagrad", "ftrl", "Momentum", "GD"])
def test_unported_optimizers_raise(name):
    """Ported since: the dense optimizer builds (tests/test_torch_optimizers.py
    holds it to the JAX package); what still raises is the fused [V, 3K]
    row store, which is Adam's in both packages."""
    from tf_repos_tpu_torch.train.sparse import make_sparse_row_optimizer

    assert make_optimizer(name, 1e-3).init({"w": torch.zeros(2)}) is not None
    with pytest.raises(ValueError, match=f"--fused_table supports Adam \\(got '{name}'\\)"):
        make_sparse_row_optimizer(name, 1e-3, fused_table=True)
