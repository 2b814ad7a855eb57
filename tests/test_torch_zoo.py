"""The port's libsvm zoo (LR, FNN, IPNN, OPNN, NFM, AFM, DCN, DeepMVM)
against the JAX package's, on converted weights (utils/convert.
params_from_jax) and the same numpy batches, dropout keep 1.0, f32
unless said.

Tolerances: logits and prob 1e-5 (f32 sums in another order); every
gradient leaf 1e-5 relative to the leaf's largest entry, plus 1e-7
(AFM's att_out bias has a gradient that is exactly 0 in exact
arithmetic, since the softmax over the pairs ignores a shift, and is f32
round-off of ~1e-11 on both sides; behind NFM's training-mode batch
norm an entry 25x smaller than its leaf's largest carries that
largest's round-off, 1.6e-7 of 0.1); 5-step trajectories: loss 2e-5 relative, the JAX package's own
bar between two formulations of one step, final tables and w|m|v rows
1e-5, dense weights 1e-4 (_close_after_steps says why); bf16 towers 2e-2 (one extra bf16 rounding per GEMM
result, ops/towers.py).

DeepMVM's product over all 39 fields: torch.prod and jnp.prod reduce in
other orders and differentiate by other formulas (torch divides the
product by each factor unless a factor is exactly 0, where it takes the
product of the others; JAX forms the exclusive products). Both agree to
f32 round-off of the product, a few ulps per factor: 1e-5 relative to
each leaf's scale holds for factors near 1 (test_mvm_and_its_gradient_match_jax, a zero
factor included). With the model's glorot init the 39 factors are ~0.1
and the product underflows to ~0 on both sides, so the model-level
checks see it through the 1e-7 absolute bound."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data.sparse_batch import SparseBatchMapper as JaxMapper
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.ops import interactions as JI
from tf_repos_tpu.ops.pallas_sparse import make_vmem_expand_lookup
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu.train.loop import build_train_step as jax_build_train_step
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.sparse_batch import SparseBatchMapper
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import interactions as TI
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.train.loop import build_train_step
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten

LR_RATE = 1e-2
V, F, B, STEPS = 300, 39, 16, 5
BASE = dict(feature_size=V, field_size=F, embedding_size=4, deep_layers="8,4",
            dropout="1.0,1.0", l2_reg=1e-3, learning_rate=LR_RATE, batch_size=B)
# each model's registry name and its own flags (NFM's published dropout
# has one entry more than deep_layers, and it sets batch_norm)
ZOO = {
    "LR": dict(model="lr"),
    "FNN": dict(model="fnn"),
    "IPNN": dict(model="ipnn"),
    "OPNN": dict(model="opnn"),
    "NFM": dict(model="nfm", batch_norm=True, dropout="1.0,1.0,1.0"),
    "AFM": dict(model="afm", attention_layers="8"),
    "DCN": dict(model="dcn", cross_layers=3),
    "DeepMVM": dict(model="deepmvm"),
}
TABLE = {"LR": "w", "DCN": "emb", "DeepMVM": "mvm_w"}  # the others: "wv"


def _kw(name, **over):
    return dict(BASE, **ZOO[name], **over)


@functools.cache
def _jax_init(name, compute_dtype="float32"):
    """The JAX model and its init params as numpy (a fresh device copy per
    use: the JAX steps donate their arguments)."""
    jm = jax_create_model(JaxConfig(**_kw(name, compute_dtype=compute_dtype)))
    jp, js = jm.init(jax.random.PRNGKey(0))
    return jm, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)


def _setup(name, **over):
    jm, jp_np, js_np = _jax_init(name, **over)
    tm = create_model(Config(**_kw(name, **over), device="cpu"))
    tp, ts = params_from_jax(jp_np, js_np)
    return jm, jax.tree.map(jnp.array, jp_np), jax.tree.map(jnp.array, js_np), tm, tp, ts


def _batches(n=STEPS, seed=3):
    rng = np.random.default_rng(seed)
    return [{
        "feat_ids": np.minimum(rng.zipf(1.2, size=(B, F)), V - 1).astype(np.int32),
        "feat_vals": (rng.random((B, F)) + 0.5).astype(np.float32),
        "label": (rng.random(B) < 0.5).astype(np.float32),
        "mask": np.concatenate([np.ones(B - 3), np.zeros(3)]).astype(np.float32),
    } for _ in range(n)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close_trees(t, j, rtol=1e-5, atol=1e-5, leaf_scale=False):
    """leaf_scale: atol grows by rtol times the leaf's largest |entry|."""
    lt, lj = tree_leaves(t), jax.tree.leaves(j)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        b = np.asarray(b)
        tol = atol + (rtol * float(np.abs(b).max()) if leaf_scale and b.size else 0.0)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=rtol, atol=tol)


def _close_after_steps(name, tp, jp, ts, js):
    """After 5 Adam steps: the table within 1e-5; every other weight
    within 1e-4, a hundredth of one Adam step at lr 1e-2 (a weight whose
    gradient is mostly cancellation takes a step whose size follows that
    gradient's round-off: entries of OPNN's first layer end 1.7e-5 apart
    on the dense step); the model state within 1e-5. AFM's att_out bias
    is held apart: its gradient is 0 in exact arithmetic (the softmax
    over the pairs ignores a shift), so Adam, which normalises each
    step, moves it by steps of f32 round-off's sign on each side. No
    output depends on it; it is held to Adam's bound on 5 steps from 0
    (3.2 lr a step at these betas) on both sides."""
    t = TABLE.get(name, "wv")
    np.testing.assert_allclose(tp[t].numpy(), np.asarray(jp[t]), rtol=1e-5, atol=1e-5)
    rest_t = {k: v for k, v in tp.items() if k != t}
    rest_j = {k: v for k, v in jp.items() if k != t}
    if name == "AFM":
        for p in (tp, jp):
            assert abs(float(p["att_out"]["b"][0])) <= STEPS * 3.2 * LR_RATE
        rest_t["att_out"] = {"w": tp["att_out"]["w"]}
        rest_j["att_out"] = {"w": jp["att_out"]["w"]}
    _close_trees(rest_t, rest_j, rtol=1e-5, atol=1e-4)
    _close_trees(ts, js)


@pytest.mark.parametrize("name", list(ZOO))
def test_forward_matches_jax(name):
    jm, jp, js, tm, tp, ts = _setup(name)
    b = _batches(1)[0]
    oj, _ = jm.apply(jp, js, _jb(b), train=False)
    ot, _ = tm.apply(tp, ts, _tb(b), train=False)
    np.testing.assert_allclose(ot["logits"].numpy(), np.asarray(oj["logits"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ot["prob"].numpy(), np.asarray(oj["prob"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(ZOO))
def test_gradients_match_jax(name):
    jm, jp, js, tm, tp, ts = _setup(name)
    b = _batches(1, seed=4)[0]
    (lj, (_, sj)), gj = jax.value_and_grad(
        lambda p: jm.loss(p, js, _jb(b), train=True), has_aux=True
    )(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    lt, (_, st) = tm.loss(tree_unflatten(tp, leaves), ts, _tb(b), train=True)
    gt = tree_unflatten(tp, list(torch.autograd.grad(lt, leaves)))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    _close_trees(gt, gj, rtol=1e-5, atol=1e-7, leaf_scale=True)
    _close_trees(st, sj)  # NFM's batch-norm statistics; {} or empty layers elsewhere


def _sparse_steps(name, jm, jp, js, tm, tp, ts):
    """JAX's and the port's lazy-sparse Adam step: LR on the plain row
    store and the plain gather; the others on the fused w|m|v store with
    JAX's Pallas lookup (interpret mode here) and the port's
    make_expand_lookup (its plain versions here)."""
    fused = name != "LR"
    jtx, ttx = jax_make_optimizer("Adam", LR_RATE), make_optimizer("Adam", LR_RATE)
    jsopt = JSP.make_sparse_row_optimizer("Adam", LR_RATE, fused_table=fused)
    tsopt = SP.make_sparse_row_optimizer("Adam", LR_RATE, fused_table=fused)
    jopt = JSP.init_opt_state(jm, jtx, jsopt, jp)
    topt = SP.init_opt_state(tm, ttx, tsopt, tp)
    jstep = JSP.build_sparse_train_step(jm, jtx, jsopt,
                                        lookup=make_vmem_expand_lookup() if fused else None)
    tstep = SP.build_sparse_train_step(tm, ttx, tsopt, lookup=make_expand_lookup() if fused else None)
    return jopt, topt, jstep, tstep


@pytest.mark.parametrize("name", list(ZOO))
def test_sparse_step_trajectory_matches_jax(name):
    jm, jp, js, tm, tp, ts = _setup(name)
    jopt, topt, jstep, tstep = _sparse_steps(name, jm, jp, js, tm, tp, ts)
    jmap, tmap = JaxMapper(jm.sparse_slots()), SparseBatchMapper(tm.sparse_slots())
    key = jax.random.PRNGKey(1)
    for i, b in enumerate(_batches()):
        jp, jopt, js, lj = jstep(jp, jopt, js, _jb(jmap(dict(b))), key)
        tp, topt, ts, lt = tstep(tp, topt, ts, _tb(tmap(dict(b))))
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
    t = TABLE.get(name, "wv")
    st, sj = topt["sparse"][t], jopt["sparse"][t]
    if name == "LR":
        for store in ("m", "v"):
            np.testing.assert_allclose(st[store][:-1].numpy(), np.asarray(sj[store]),
                                       rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(st["wmv"][:-1].numpy(), np.asarray(sj["wmv"]), rtol=1e-5, atol=1e-5)
    _close_after_steps(name, tp, jp, ts, js)


@pytest.mark.parametrize("name", list(ZOO))
def test_dense_step_trajectory_matches_jax(name):
    jm, jp, js, tm, tp, ts = _setup(name)
    jtx, ttx = jax_make_optimizer("Adam", LR_RATE), make_optimizer("Adam", LR_RATE)
    jo, to = jtx.init(jp), ttx.init(tp)
    jstep, tstep = jax_build_train_step(jm, jtx), build_train_step(tm, ttx)
    key = jax.random.PRNGKey(1)
    for i, b in enumerate(_batches(seed=5)):
        jp, jo, js, lj = jstep(jp, jo, js, _jb(b), key)
        tp, to, ts, lt = tstep(tp, to, ts, _tb(b))
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
    _close_after_steps(name, tp, jp, ts, js)


@pytest.mark.parametrize("name", list(ZOO))
def test_bf16_towers_forward_close(name):
    jm, jp, js, tm, tp, ts = _setup(name, compute_dtype="bfloat16")
    b = _batches(1, seed=6)[0]
    oj, _ = jm.apply(jp, js, _jb(b), train=False)
    ot, _ = tm.apply(tp, ts, _tb(b), train=False)
    np.testing.assert_allclose(ot["logits"].numpy(), np.asarray(oj["logits"]), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("alias", ["lr", "pnn", "fnn", "ipnn", "inner", "opnn", "outer", "nfm",
                                   "afm", "dcn", "deepmvm"])
def test_registry_aliases_match_jax(alias):
    jm = jax_create_model(JaxConfig(**dict(BASE, model=alias)))
    tm = create_model(Config(**dict(BASE, model=alias)))
    assert type(tm).__name__ == type(jm).__name__ and tm.name == jm.name
    assert getattr(tm, "model_type", None) == getattr(jm, "model_type", None)
    assert list(tm.sparse_slots()) == list(jm.sparse_slots())


@pytest.mark.parametrize("model_type", ["FNN", "Inner", "Outer", "", "Bogus"])
def test_pnn_reads_cfg_model_type(model_type):
    kw = dict(BASE, model="pnn", model_type=model_type)
    if model_type == "Bogus":
        with pytest.raises(ValueError, match="FNN/Inner/Outer, got Bogus") as jerr:
            jax_create_model(JaxConfig(**kw))
        with pytest.raises(ValueError, match="FNN/Inner/Outer, got Bogus") as terr:
            create_model(Config(**kw))
        assert str(terr.value) == str(jerr.value)
        return
    assert create_model(Config(**kw)).model_type == jax_create_model(JaxConfig(**kw)).model_type


@pytest.mark.parametrize("flag", ["fused_table", "pallas_expand"])
def test_lr_refused_where_jax_cannot_run_it(tmp_path, flag):
    cfg = Config(**_kw("LR"), sparse_table_update=True, device="cpu",
                 model_dir=str(tmp_path / "m"), **{flag: True})
    with pytest.raises(ValueError, match=f"--{flag}: LR's table is 1-D"):
        Harness(cfg)
    Harness(cfg.replace(**{flag: False}))  # plain lazy Adam is taken


@pytest.mark.parametrize("fields", [2, 8, 39])
def test_pair_order_and_pairwise_products_match_jax(fields):
    row, col = TI._pair_indices(fields)
    jrow, jcol = JI._pair_indices(fields)
    np.testing.assert_array_equal(row.numpy(), jrow)
    np.testing.assert_array_equal(col.numpy(), jcol)
    emb = np.random.default_rng(fields).standard_normal((3, fields, 5)).astype(np.float32)
    te, je = torch.from_numpy(emb), jnp.asarray(emb)
    for fn in ("pairwise_inner", "pairwise_outer", "pairwise_elementwise", "bi_interaction",
               "fm_second_order"):
        np.testing.assert_allclose(getattr(TI, fn)(te).numpy(), np.asarray(getattr(JI, fn)(je)),
                                   rtol=1e-5, atol=1e-6, err_msg=fn)


def test_cross_network_attention_pool_and_lookups_match_jax():
    rng = np.random.default_rng(0)
    table, w = rng.standard_normal((30, 5)).astype(np.float32), rng.standard_normal(30).astype(np.float32)
    ids = rng.integers(0, 30, size=(4, 7)).astype(np.int32)
    vals = rng.random((4, 7)).astype(np.float32)
    np.testing.assert_allclose(
        TI.scaled_embeddings(*map(torch.from_numpy, (table, ids, vals))).numpy(),
        np.asarray(JI.scaled_embeddings(*map(jnp.asarray, (table, ids, vals)))), rtol=1e-6)
    np.testing.assert_allclose(
        TI.first_order(*map(torch.from_numpy, (w, ids, vals))).numpy(),
        np.asarray(JI.first_order(*map(jnp.asarray, (w, ids, vals)))), rtol=1e-5, atol=1e-6)
    x0, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((4, 12), (3, 12), (3, 12)))
    np.testing.assert_allclose(
        TI.cross_network(*map(torch.from_numpy, (x0, w, b))).numpy(),
        np.asarray(JI.cross_network(*map(jnp.asarray, (x0, w, b)))), rtol=1e-5, atol=1e-5)
    inter, logit = (rng.standard_normal(s).astype(np.float32) for s in ((4, 6, 3), (4, 6, 1)))
    for a, c in zip(TI.attention_pool(torch.from_numpy(inter), torch.from_numpy(logit)),
                    JI.attention_pool(jnp.asarray(inter), jnp.asarray(logit))):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=1e-6)


def test_mvm_and_its_gradient_match_jax():
    """Factors near 1 (the product is O(1)), one of them exactly 0: the
    route torch.prod's backward takes for a zero factor."""
    rng = np.random.default_rng(1)
    emb = (rng.random((4, F, 6)) * 0.4 + 0.8).astype(np.float32)
    bias = (rng.random((F, 6)) * 0.1 - 0.05).astype(np.float32)
    emb[1, 7, 2] = -bias[7, 2]  # emb + bias == 0 exactly
    gout = rng.standard_normal((4, 6)).astype(np.float32)
    yj, vjp = jax.vjp(JI.mvm, jnp.asarray(emb), jnp.asarray(bias))
    ge_j, gb_j = vjp(jnp.asarray(gout))
    te = torch.from_numpy(emb).requires_grad_(True)
    tbias = torch.from_numpy(bias).requires_grad_(True)
    yt = TI.mvm(te, tbias)
    ge_t, gb_t = torch.autograd.grad(yt, (te, tbias), torch.from_numpy(gout))
    assert float(yt.detach()[1, 2]) == 0.0 and float(ge_t[1, 7, 2]) != 0.0
    # the bias gradient sums the batch's terms, which may cancel: held to
    # the leaf's scale as the model gradients are
    _close_trees([yt, ge_t, gb_t], [yj, ge_j, gb_j], rtol=1e-5, atol=1e-7, leaf_scale=True)
