"""The lazy row forms of Adagrad, FTRL, Momentum and GD
(tf_repos_tpu_torch/train/sparse.py) against the JAX package's
build_sparse_train_step, from converted weights on the same mapped
batches, in f32: DeepFM under all four (Adam as a control), FNN and NFM
under Adagrad and FTRL, LR's 1-D table under FTRL and GD. The port's
lookup is make_expand_lookup (its plain versions on the CPU) for the
models with [V, K] rows; JAX's is its plain gather, or, for DeepFM under
FTRL, the Pallas make_vmem_expand_lookup in interpret mode.

Held: the loss at every step to 2e-5 relative (the JAX package's bar
between two formulations of one step); the table and every row store
(the sentinel's spare row aside) to 1e-5; the dense weights to 1e-4, as
tests/test_torch_zoo.py holds them after 5 steps of a normalising
optimizer (a weight whose gradient is mostly cancellation steps by its
round-off). Also: GD and Adagrad on the lazy step equal the dense step
(untouched rows are fixed points of both), the JAX package's refusals,
and a checkpoint resume that continues the same trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data.sparse_batch import SparseBatchMapper as JaxMapper
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.ops.pallas_sparse import make_vmem_expand_lookup
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.sparse_batch import SparseBatchMapper
from tf_repos_tpu_torch.data.synthetic import synthetic_criteo_batch
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.loop import build_train_step
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves

LR_RATE = 1e-2
STEPS = 4
B = 16
MODELS = {
    "DeepFM": dict(model="DeepFM", feature_size=400, field_size=10, embedding_size=4,
                   deep_layers="16,8", dropout="1.0,1.0", static_fields=3),
    "FNN": dict(model="fnn", feature_size=300, field_size=39, embedding_size=4,
                deep_layers="8,4", dropout="1.0,1.0"),
    "NFM": dict(model="nfm", feature_size=300, field_size=39, embedding_size=4,
                deep_layers="8,4", dropout="1.0,1.0,1.0", batch_norm=True),
    "LR": dict(model="lr", feature_size=300, field_size=39),
}
TABLE = {"DeepFM": "fm_wv", "FNN": "wv", "NFM": "wv", "LR": "w"}
STORES = {"Adam": ("m", "v"), "Adagrad": ("a",), "ftrl": ("n", "z"), "Momentum": ("mo",),
          "GD": ()}


def _kw(name, **over):
    return dict(MODELS[name], batch_size=B, l2_reg=1e-4, learning_rate=LR_RATE, **over)


def _batches(name, seed=3):
    """Zipf(1.2) ids (repeats within a batch, most rows untouched); DeepFM's
    static fields at ids 1..3."""
    cfg = MODELS[name]
    v, f = cfg["feature_size"], cfg["field_size"]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        z = np.minimum(rng.zipf(1.2, size=(B, f)), v - 1).astype(np.int32)
        if cfg.get("static_fields"):
            z[:, :cfg["static_fields"]] = np.arange(1, cfg["static_fields"] + 1)
        out.append({"feat_ids": z, "feat_vals": (rng.random((B, f)) + 0.5).astype(np.float32),
                    "label": (rng.random(B) < 0.5).astype(np.float32),
                    "mask": np.concatenate([np.ones(B - 3), np.zeros(3)]).astype(np.float32)})
    return out


CASES = [("DeepFM", "Adam", False), ("DeepFM", "Adagrad", False), ("DeepFM", "ftrl", True),
         ("DeepFM", "Momentum", False), ("DeepFM", "GD", False),
         ("FNN", "Adagrad", False), ("FNN", "ftrl", False),
         ("NFM", "Adagrad", False), ("NFM", "ftrl", False),
         ("LR", "ftrl", False), ("LR", "GD", False)]


@pytest.mark.parametrize("name,opt,pallas", CASES)
def test_lazy_optimizer_trajectory_matches_jax(name, opt, pallas):
    jm = jax_create_model(JaxConfig(**_kw(name)))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    tm = create_model(Config(**_kw(name), device="cpu"))
    jtx = jax_make_optimizer(opt, LR_RATE)
    jsopt = JSP.make_sparse_row_optimizer(opt, LR_RATE)
    jopt = JSP.init_opt_state(jm, jtx, jsopt, jp)
    jstep = JSP.build_sparse_train_step(jm, jtx, jsopt,
                                        lookup=make_vmem_expand_lookup() if pallas else None)
    ttx = make_optimizer(opt, LR_RATE)
    tsopt = SP.make_sparse_row_optimizer(opt, LR_RATE)
    topt = SP.init_opt_state(tm, ttx, tsopt, tp)
    tstep = SP.build_sparse_train_step(tm, ttx, tsopt,
                                       lookup=None if name == "LR" else make_expand_lookup())
    jmap, tmap = JaxMapper(jm.sparse_slots()), SparseBatchMapper(tm.sparse_slots())
    key = jax.random.PRNGKey(1)
    for i, b in enumerate(_batches(name)):
        jb = {k: jnp.asarray(v) for k, v in jmap(dict(b)).items()}
        tb = {k: torch.from_numpy(v) for k, v in tmap(dict(b)).items()}
        jp, jopt, js, lj = jstep(jp, jopt, js, jb, key)
        tp, topt, ts, lt = tstep(tp, topt, ts, tb)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
    t = TABLE[name]
    np.testing.assert_allclose(tp[t].numpy(), np.asarray(jp[t]), rtol=1e-5, atol=1e-5)
    assert set(topt["sparse"][t]) - {"t"} == {"w", *STORES[opt]}
    for store in STORES[opt]:
        got = topt["sparse"][t][store]
        assert not got[-1].any(), f"the spare row of {store} is not zero"
        np.testing.assert_allclose(got[:-1].numpy(), np.asarray(jopt["sparse"][t][store]),
                                   rtol=1e-5, atol=1e-5, err_msg=store)
    rest_t = [v for k, v in sorted(tp.items()) if k != t]
    rest_j = [v for k, v in sorted(jp.items()) if k != t]
    for a, b in zip(tree_leaves(rest_t), jax.tree.leaves(rest_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


def _fixed_point_batches(cfg, n):
    """The synthetic writer's per-field blocks: each batch touches a strict
    subset of the vocab."""
    return [synthetic_criteo_batch(np.random.default_rng(i), cfg.batch_size, cfg.feature_size)
            for i in range(n)]


@pytest.mark.parametrize("opt", ["GD", "Adagrad"])
def test_lazy_matches_dense_fixed_point_optimizers(opt):
    """With l2 = 0 an untouched row has a zero gradient, and GD and Adagrad
    leave it where it is: the lazy step equals the dense one. Not FTRL:
    the dense form rebuilds every weight from (z, n) and zeroes the
    untouched rows at its first step.

    The untouched rows are held bit for bit (both runs leave them at
    their init). The rest is held as the JAX package's tests/test_sparse.py
    holds its own, loss 1e-6 and weights 2e-6 relative, but 1e-5 absolute
    where it has 1e-7: the two XLA paths there sum a row's cotangents in
    one order, while here the lazy step sums them with index_add_ into
    [S, K] and the dense step with the gather's index backward into
    [V, K], and Adagrad's first steps from an accumulator of 1e-8 are
    about lr * sign(g): a row whose gradient is ~1e-4 of cancellation
    moves by round-off times lr (7.9e-7 seen at lr 0.05)."""
    cfg = Config(model="DeepFM", feature_size=2000, field_size=39, embedding_size=4,
                 deep_layers="8,4", dropout="1.0,1.0", batch_size=16, learning_rate=0.05,
                 l2_reg=0.0, optimizer=opt, device="cpu")
    model = create_model(cfg)
    batches = _fixed_point_batches(cfg, 3)
    runs = []
    for lazy in (True, False):
        params, mstate = model.init(torch.Generator().manual_seed(0))
        tx = make_optimizer(opt, cfg.learning_rate)
        if lazy:
            sopt = SP.make_sparse_row_optimizer(opt, cfg.learning_rate)
            state = SP.init_opt_state(model, tx, sopt, params)
            step = SP.build_sparse_train_step(model, tx, sopt, lookup=make_expand_lookup())
            mapper = SparseBatchMapper(model.sparse_slots())
            feed = [{k: torch.from_numpy(v) for k, v in mapper(dict(b)).items()} for b in batches]
        else:
            state = tx.init(params)
            step = build_train_step(model, tx)
            feed = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
        losses = []
        for b in feed:
            params, state, mstate, loss = step(params, state, mstate, b)
            losses.append(float(loss))
        runs.append((params, losses))
    (p_lazy, l_lazy), (p_dense, l_dense) = runs
    np.testing.assert_allclose(l_lazy, l_dense, rtol=1e-6)
    init, _ = model.init(torch.Generator().manual_seed(0))
    untouched = np.setdiff1d(np.arange(cfg.feature_size),
                             np.concatenate([b["feat_ids"].ravel() for b in batches]))
    assert untouched.size > 100
    for p in (p_lazy, p_dense):
        assert torch.equal(p["fm_wv"][untouched], init["fm_wv"][untouched])
    for a, b in zip(tree_leaves(p_lazy), tree_leaves(p_dense)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("opt", ["Adagrad", "ftrl", "Momentum", "GD", "SGD"])
def test_fused_table_and_catchup_are_adams(opt):
    for fn in (SP.make_sparse_row_optimizer, JSP.make_sparse_row_optimizer):
        with pytest.raises(ValueError, match="--fused_table supports Adam"):
            fn(opt, LR_RATE, fused_table=True)
        with pytest.raises(ValueError, match="--sparse_catchup applies to Adam"):
            fn(opt, LR_RATE, catchup=True)


def test_wdl_has_no_row_form():
    for fn in (SP.make_sparse_row_optimizer, JSP.make_sparse_row_optimizer):
        with pytest.raises(ValueError, match="no sparse-row variant for optimizer 'wdl'"):
            fn("wdl", LR_RATE)


@pytest.mark.parametrize("opt", ["Adagrad", "ftrl", "Momentum", "GD"])
def test_checkpoint_resume_continues_the_trajectory(tmp_path, opt):
    """Two steps, a checkpoint (torch.save of params, row stores and dense
    state), a restore, two more steps: the same losses, table and row
    stores as four steps in one go, bit for bit."""
    cfg = Config(**_kw("DeepFM"), device="cpu")
    model = create_model(cfg)
    mapper = SparseBatchMapper(model.sparse_slots())
    batches = [{k: torch.from_numpy(v) for k, v in mapper(dict(b)).items()}
               for b in _batches("DeepFM", seed=9)]

    def fresh():
        params, mstate = model.init(torch.Generator().manual_seed(0))
        tx = make_optimizer(opt, LR_RATE)
        sopt = SP.make_sparse_row_optimizer(opt, LR_RATE)
        return {"params": params, "opt_state": SP.init_opt_state(model, tx, sopt, params),
                "mstate": mstate}, SP.build_sparse_train_step(model, tx, sopt,
                                                              lookup=make_expand_lookup())

    def run(state, step, bs):
        losses = []
        for b in bs:
            p, o, m, loss = step(state["params"], state["opt_state"], state["mstate"], b)
            state = {"params": p, "opt_state": o, "mstate": m}
            losses.append(float(loss))
        return state, losses

    whole, l_whole = run(*fresh(), batches)
    first, l_first = run(*fresh(), batches[:2])
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(2, dict(first, step=2))
    restored = ckpt.restore("cpu")
    assert restored["step"] == 2
    state = {k: restored[k] for k in ("params", "opt_state", "mstate")}
    t = TABLE["DeepFM"]
    # the restored table is still the view of its row store
    assert state["params"][t].data_ptr() == state["opt_state"]["sparse"][t]["w"].data_ptr()
    _, step = fresh()
    resumed, l_rest = run(state, step, batches[2:])
    assert l_first + l_rest == l_whole
    for store in ("w", *STORES[opt]):
        assert torch.equal(resumed["opt_state"]["sparse"][t][store],
                           whole["opt_state"]["sparse"][t][store]), store
    for a, b in zip(tree_leaves(resumed["params"]), tree_leaves(whole["params"])):
        assert torch.equal(a, b)
