"""bf16 row stores with stochastic rounding and --fused_moments in the
port's lazy optimizers (tf_repos_tpu_torch/train/sparse.py), against the
JAX package's train/sparse.py on the CPU.

- One apply of every lazy optimizer on bf16 stores started from the same
  JAX state (utils/convert.sparse_state_from_jax), the port fed the bits
  JAX drew for each store through the noise seam (ops/rounding.sr_noise):
  every store equal to JAX's bit for bit, but at most 1e-4 of its
  elements, each one bf16 ulp apart (the f32 row math may differ in its
  last bit, which moves a rounding only when the noise lands exactly
  there).
- 4-step --fused_moments trajectories (Adam, FTRL) in f32 against JAX's:
  loss 2e-5 relative (the JAX package's bar between two formulations of
  one step), the m|v and n|z stores 1e-5; the port's fused layout
  against its unfused one (the JAX package's tests/test_sparse.py
  test_fused_moments_matches_unfused bars: loss 1e-6, weights 2e-6
  relative + 1e-7).
- 5-step bf16 DeepFM trajectories through the lazy step with JAX's noise
  replayed: loss 2e-5 relative, tables within one bf16 ulp; bf16 against
  f32 within the JAX package's own bars (loss 2e-2, table 0.05;
  tests/test_sparse.py test_bf16_sparse_training_tracks_f32).
- sparse_state_from_jax round trips, the JAX package's refusals, and the
  harness: --param_dtype's ValueErrors, bf16 stores, f32 eval, checkpoint
  dtype kept."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data.sparse_batch import SparseBatchMapper as JaxMapper
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.sparse_batch import SparseBatchMapper
from tf_repos_tpu_torch.data.synthetic import write_synthetic_libsvm
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import rounding as R
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax, sparse_state_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves

LR_RATE = 1e-2
V, K = 3000, 8

# (optimizer, options) -> the JAX package's key splits: (store, width in K) in draw order
OPTS = {
    "adam": ("Adam", {}, [("w", 1), ("m", 1), ("v", 1)]),
    "adam_catchup": ("Adam", {"catchup": True}, [("w", 1), ("m", 1), ("v", 1)]),
    "adam_fused_moments": ("Adam", {"fused_moments": True}, [("w", 1), ("mv", 2)]),
    "adam_fused_moments_catchup": ("Adam", {"fused_moments": True, "catchup": True},
                                   [("w", 1), ("mv", 2)]),
    "adam_fused_table": ("Adam", {"fused_table": True}, [("wmv", 3)]),
    "adam_fused_table_catchup": ("Adam", {"fused_table": True, "catchup": True}, [("wmv", 3)]),
    "adagrad": ("Adagrad", {}, [("w", 1), ("a", 1)]),
    "ftrl": ("ftrl", {}, [("w", 1), ("n", 1), ("z", 1)]),
    "ftrl_fused_moments": ("ftrl", {"fused_moments": True}, [("w", 1), ("nz", 2)]),
    "momentum": ("Momentum", {}, [("w", 1), ("mo", 1)]),
    "gd": ("GD", {}, [("w", 1)]),
}


def jax_noise(key, draws, s, k=K):
    """The bits JAX's apply draws for [s, k] rows, in its order: one key,
    or the key split into as many as there are stores."""
    keys = [key] if len(draws) == 1 else list(jax.random.split(key, len(draws)))
    return [np.asarray(jax.random.bits(kk, (s, w * k), jnp.uint32) & jnp.uint32(0xFFFF))
            .astype(np.int32) for kk, (_, w) in zip(keys, draws)]


class Replay:
    """Stands in for rounding.sr_noise: hands out queued bits in order,
    each of the shape asked for."""

    def __init__(self):
        self.queue = []
        self.drawn = 0

    def __call__(self, shape, generator, device):
        assert self.queue, f"an unexpected draw of shape {tuple(shape)}"
        bits = self.queue.pop(0)
        assert tuple(bits.shape) == tuple(shape), (bits.shape, shape)
        self.drawn += 1
        return torch.from_numpy(bits).to(device)


def _uids(rng, n):
    u = np.sort(rng.choice(V, n, replace=False)).astype(np.int32)
    return np.concatenate([u, np.full(n // 4, V, np.int32)])  # sentinel padding


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _hold_bf16(name, got: torch.Tensor, want, frac=1e-4):
    """Equal bits, but at most ``frac`` of the elements, each one ulp apart."""
    g = got.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    w = np.asarray(want).view(np.uint16).astype(np.int64)
    assert g.shape == w.shape, name
    diff = np.abs(g - w)
    apart = int((diff != 0).sum())
    assert diff.max(initial=0) <= 1, f"{name}: {diff.max()} ulps apart"
    assert apart <= frac * diff.size, f"{name}: {apart} of {diff.size} elements one ulp apart"
    return apart


@pytest.mark.parametrize("case", list(OPTS))
def test_one_apply_on_bf16_stores_matches_jax(case, monkeypatch):
    name, opts, draws = OPTS[case]
    rng = np.random.default_rng(0)
    table = jnp.asarray((rng.standard_normal((V, K)) * 0.1).astype(np.float32)).astype(jnp.bfloat16)
    jsopt = JSP.make_sparse_row_optimizer(name, LR_RATE, **opts)
    fused = isinstance(jsopt, JSP.FusedTableRowOpt)
    aux = jsopt.init(table)

    def jax_apply(aux, table, u, g, key):
        u = jnp.asarray(u)
        rows = JSP.take_rows_f32(aux["wmv"], u) if fused else table
        return jsopt.apply(aux, rows, u, jnp.asarray(g), key)

    # two JAX steps first, so the state holds moments, a step count and
    # staggered last-touched steps
    for i in range(2):
        u = _uids(rng, 700)
        g = rng.standard_normal((u.size, K)).astype(np.float32)
        table, aux = jax_apply(aux, table, u, g, jax.random.PRNGKey(10 + i))
    aux_np = jax.tree.map(np.asarray, aux)

    sopt = SP.make_sparse_row_optimizer(name, LR_RATE, **opts)
    taux = sparse_state_from_jax(aux_np, np.asarray(table))
    u = _uids(rng, 900)
    g = rng.standard_normal((u.size, K)).astype(np.float32)
    key = jax.random.PRNGKey(77)
    replay = Replay()
    replay.queue = jax_noise(key, draws, u.size)
    monkeypatch.setattr(R, "sr_noise", replay)
    tu = torch.from_numpy(u)
    out = sopt.apply(taux, sopt.gather(taux, tu), tu, torch.from_numpy(g), torch.Generator())
    assert replay.drawn == len(draws) and not replay.queue

    new_table, new_aux = jax_apply(aux, table, u, g, key)
    for store, _ in draws:
        want = new_aux[store] if store != "w" else new_table
        assert taux[store].dtype == torch.bfloat16
        assert not taux[store][-1].view(torch.int16).any(), f"spare row of {store}"
        _hold_bf16(store, taux[store][:-1], want)
    want_table = new_table if not fused else new_aux["wmv"][:, :K]
    _hold_bf16("table", out, want_table)
    if "t" in new_aux:
        assert taux["t"] == int(new_aux["t"])
    if opts.get("catchup"):
        np.testing.assert_array_equal(taux["last"][:-1].numpy(), np.asarray(new_aux["last"]))


# ---------------------------------------------------------------- trajectories
MODEL = dict(model="DeepFM", feature_size=400, field_size=10, embedding_size=4,
             deep_layers="16,8", dropout="1.0,1.0", static_fields=3, batch_size=16, l2_reg=1e-4)


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        z = np.minimum(rng.zipf(1.2, size=(16, 10)), 399).astype(np.int32)
        z[:, :3] = np.arange(1, 4)
        out.append({"feat_ids": z, "feat_vals": (rng.random((16, 10)) + 0.5).astype(np.float32),
                    "label": (rng.random(16) < 0.5).astype(np.float32),
                    "mask": np.concatenate([np.ones(13), np.zeros(3)]).astype(np.float32)})
    return out


def _jax_run(opt, batches, opts, dtype=jnp.float32, lr=LR_RATE):
    jm = jax_create_model(JaxConfig(**MODEL, learning_rate=lr))
    jp, js = jm.init(jax.random.PRNGKey(0))
    p0 = (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    jp = JSP.cast_tables(jm, jp, dtype)
    jtx = jax_make_optimizer(opt, lr)
    jsopt = JSP.make_sparse_row_optimizer(opt, lr, **opts)
    jopt = JSP.init_opt_state(jm, jtx, jsopt, jp)
    jstep = JSP.build_sparse_train_step(jm, jtx, jsopt)
    jmap = JaxMapper(jm.sparse_slots())
    losses, mapped = [], []
    for i, b in enumerate(batches):
        mb = jmap(dict(b))
        mapped.append(mb)
        jp, jopt, js, loss = jstep(jp, jopt, js, {k: jnp.asarray(v) for k, v in mb.items()},
                                   jax.random.PRNGKey(100 + i))
        losses.append(float(loss))
    return p0, jp, jopt, losses, mapped


def _port_run(opt, batches, opts, p0, dtype=torch.float32, lr=LR_RATE, replay=None, draws=None):
    tm = create_model(Config(**MODEL, learning_rate=lr, device="cpu"))
    tp, ts = params_from_jax(*p0)
    tp = SP.cast_tables(tm, tp, dtype)
    ttx = make_optimizer(opt, lr)
    tsopt = SP.make_sparse_row_optimizer(opt, lr, **opts)
    topt = SP.init_opt_state(tm, ttx, tsopt, tp)
    tstep = SP.build_sparse_train_step(tm, ttx, tsopt, lookup=make_expand_lookup())
    tmap = SparseBatchMapper(tm.sparse_slots())
    gen = torch.Generator().manual_seed(5)
    losses = []
    for i, b in enumerate(batches):
        mb = tmap(dict(b))
        if replay is not None:
            # JAX's step: rng, sr_key = split(rng); table 0 rounds with fold_in(sr_key, 0)
            sr_key = jax.random.split(jax.random.PRNGKey(100 + i))[1]
            s = mb[SP.UIDS_PREFIX + "fm_wv"].size
            replay.queue = jax_noise(jax.random.fold_in(sr_key, 0), draws, s, k=5)
        tb = {k: torch.from_numpy(v) for k, v in mb.items()}
        tp, topt, ts, loss = tstep(tp, topt, ts, tb, None, gen)
        losses.append(float(loss))
        assert replay is None or not replay.queue
    return tp, topt, losses


@pytest.mark.parametrize("opt", ["Adam", "ftrl"])
def test_fused_moments_trajectory_matches_jax(opt):
    batches = _batches(4)
    opts = {"fused_moments": True}
    p0, jp, jopt, jl, _ = _jax_run(opt, batches, opts)
    tp, topt, tl = _port_run(opt, batches, opts, p0)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    store = "mv" if opt == "Adam" else "nz"
    got = topt["sparse"]["fm_wv"]
    assert got[store].shape == (401, 10) and not got[store][-1].any()
    assert set(got) - {"t"} == {"w", store}
    np.testing.assert_allclose(got[store][:-1].numpy(), np.asarray(jopt["sparse"]["fm_wv"][store]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp["fm_wv"].numpy(), np.asarray(jp["fm_wv"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", ["Adam", "ftrl"])
def test_fused_moments_matches_unfused(opt):
    batches = _batches(4, seed=8)
    p0 = _jax_run(opt, batches[:1], {})[0]
    runs = [_port_run(opt, batches, {"fused_moments": fm}, p0) for fm in (True, False)]
    (pf, of, lf), (pu, ou, lu) = runs
    np.testing.assert_allclose(lf, lu, rtol=1e-6)
    for a, b in zip(tree_leaves(pf), tree_leaves(pu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6, atol=1e-7)
    key = "mv" if opt == "Adam" else "nz"
    assert of["sparse"]["fm_wv"][key].shape[-1] == 2 * pf["fm_wv"].shape[-1]
    assert "m" not in of["sparse"]["fm_wv"] and "n" not in of["sparse"]["fm_wv"]


BF16_CASES = {
    "fused_table_catchup": ("Adam", {"fused_table": True, "catchup": True}, [("wmv", 3)], "wmv"),
    "adam_fused_moments": ("Adam", {"fused_moments": True}, [("w", 1), ("mv", 2)], "mv"),
    "ftrl_fused_moments": ("ftrl", {"fused_moments": True}, [("w", 1), ("nz", 2)], "nz"),
}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_trajectory_matches_jax_with_its_noise(case, monkeypatch):
    opt, opts, draws, store = BF16_CASES[case]
    batches = _batches(5, seed=11)
    p0, jp, jopt, jl, _ = _jax_run(opt, batches, opts, dtype=jnp.bfloat16)
    replay = Replay()
    monkeypatch.setattr(R, "sr_noise", replay)
    tp, topt, tl = _port_run(opt, batches, opts, p0, dtype=torch.bfloat16, replay=replay,
                             draws=draws)
    assert replay.drawn == 5 * len(draws)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    aux = topt["sparse"]["fm_wv"]
    assert tp["fm_wv"].dtype == torch.bfloat16 and aux[store].dtype == torch.bfloat16
    # a rounding moved by the f32 math's last bit moves a row by one ulp,
    # and later steps carry it: held to one ulp, at most 1% of elements
    _hold_bf16("table", tp["fm_wv"], jp["fm_wv"], frac=1e-2)
    _hold_bf16(store, aux[store][:-1], jopt["sparse"]["fm_wv"][store], frac=1e-2)


def test_bf16_tracks_f32():
    """The JAX package's own bars for bf16 storage against f32, on the
    port alone (its test_bf16_sparse_training_tracks_f32 setup: plain lazy
    Adam, lr 0.05, no L2, 5 steps)."""
    kw = dict(MODEL, l2_reg=0.0)
    batches = _batches(5, seed=2)
    p0 = _jax_run("Adam", batches[:1], {})[0]
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tm = create_model(Config(**kw, learning_rate=0.05, device="cpu"))
        tp, ts = params_from_jax(*p0)
        tp = SP.cast_tables(tm, tp, dtype)
        tx = make_optimizer("Adam", 0.05)
        sopt = SP.make_sparse_row_optimizer("Adam", 0.05)
        opt_state = SP.init_opt_state(tm, tx, sopt, tp)
        step = SP.build_sparse_train_step(tm, tx, sopt)
        mapper = SparseBatchMapper(tm.sparse_slots())
        gen = torch.Generator().manual_seed(0)
        losses = []
        for b in batches:
            mb = {k: torch.from_numpy(v) for k, v in mapper(dict(b)).items()}
            tp, opt_state, ts, loss = step(tp, opt_state, ts, mb, None, gen)
            losses.append(float(loss))
        assert tp["fm_wv"].dtype == dtype and opt_state["sparse"]["fm_wv"]["m"].dtype == dtype
        res[dtype] = (losses, tp["fm_wv"].float().numpy())
    (l32, t32), (l16, t16) = res[torch.float32], res[torch.bfloat16]
    np.testing.assert_allclose(l16, l32, rtol=0.02)
    assert float(np.max(np.abs(t16 - t32))) < 0.05


def test_f32_steps_draw_no_noise(monkeypatch):
    def boom(*a):
        raise AssertionError("an f32 store drew rounding noise")

    monkeypatch.setattr(R, "sr_noise", boom)
    batches = _batches(2)
    p0 = _jax_run("Adam", batches[:1], {})[0]
    for opt, opts in (("Adam", {"fused_table": True, "catchup": True}), ("ftrl", {"fused_moments": True})):
        _port_run(opt, batches, opts, p0)


# ------------------------------------------------------------ state and errors
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["adam_catchup", "adam_fused_moments", "adam_fused_table_catchup",
                                  "adagrad", "ftrl", "ftrl_fused_moments", "momentum", "gd"])
def test_sparse_state_from_jax_round_trips(case, dtype):
    name, opts, _ = OPTS[case]
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.standard_normal((50, K)).astype(np.float32)).astype(getattr(jnp, dtype))
    jsopt = JSP.make_sparse_row_optimizer(name, LR_RATE, **opts)
    aux = jax.tree.map(np.asarray, jsopt.init(table))
    if "last" in aux:
        aux["last"] = rng.integers(0, 9, 50).astype(np.int32)
        aux["t"] = np.int32(9)
    got = sparse_state_from_jax(aux, np.asarray(table))
    for store, x in aux.items():
        if store == "t":
            assert got["t"] == int(x) and isinstance(got["t"], int)
            continue
        t = got[store]
        assert tuple(t.shape) == (51,) + x.shape[1:], store
        want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}
        assert t.dtype == want_dtype[x.dtype.name], store
        np.testing.assert_array_equal(_bits(t[:-1].view(torch.int16).numpy().view(np.uint16)
                                            if t.dtype == torch.bfloat16 else t[:-1].numpy()),
                                      _bits(x))
        assert not t[-1].any(), f"spare row of {store}"
    sopt = SP.make_sparse_row_optimizer(name, LR_RATE, **opts)
    view = sopt.table(got)
    np.testing.assert_array_equal(_bits(view.view(torch.int16).numpy().view(np.uint16)
                                        if view.dtype == torch.bfloat16 else view.numpy()),
                                  _bits(np.asarray(table)))
    assert set(got) == set(sopt.init(torch.zeros((50, K), dtype=view.dtype)))


def test_fused_table_supersedes_fused_moments():
    for fn in (SP.make_sparse_row_optimizer, JSP.make_sparse_row_optimizer):
        with pytest.raises(ValueError, match="--fused_table supersedes --fused_moments"):
            fn("Adam", LR_RATE, fused_table=True, fused_moments=True)


@pytest.mark.parametrize("opt", ["Adagrad", "Momentum", "GD", "SGD"])
def test_fused_moments_ignored_by_one_state_optimizers(opt):
    """As in the JAX package, whose branches for them never read it."""
    a = SP.make_sparse_row_optimizer(opt, LR_RATE, fused_moments=True)
    b = SP.make_sparse_row_optimizer(opt, LR_RATE)
    assert type(a) is type(b)
    ja = JSP.make_sparse_row_optimizer(opt, LR_RATE, fused_moments=True)
    assert set(ja.init(jnp.zeros((4, 2)))) == set(b.init(torch.zeros(4, 2))) - {"w"}


# ------------------------------------------------------------------ harness
HFLAGS = dict(model="DeepFM", feature_size=400, field_size=39, embedding_size=4,
              deep_layers="8,4", dropout="1.0,1.0", batch_size=32, device="cpu")


def test_param_dtype_errors_as_jax():
    with pytest.raises(ValueError, match="requires --sparse_table_update"):
        Harness(Config(**HFLAGS, param_dtype="bfloat16"))
    with pytest.raises(ValueError, match="unsupported param_dtype 'float16'"):
        Harness(Config(**HFLAGS, param_dtype="float16", sparse_table_update=True))
    h = Harness(Config(**HFLAGS, param_dtype="bf16", sparse_table_update=True, fused_table=True,
                       dma_scatter=True))
    with pytest.raises(ValueError, match="--dma_scatter requires f32 tables"):
        h.init_train_state()


def test_harness_bf16_state_eval_and_checkpoint(tmp_path):
    d = tmp_path / "d"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 96, feature_size=400, seed=0)
    write_synthetic_libsvm(str(d / "va.libsvm"), 32, feature_size=400, seed=1)
    cfg = Config(**HFLAGS, param_dtype="bfloat16", sparse_table_update=True, fused_moments=True,
                 optimizer="ftrl", data_dir=str(d), model_dir=f"{tmp_path}/m/", dt_dir="x",
                 num_epochs=1, eval_throttle_secs=0, log_steps=1)
    h = Harness(cfg)
    ts = h.init_train_state()
    aux = ts["opt_state"]["sparse"]["fm_wv"]
    assert ts["params"]["fm_wv"].dtype == torch.bfloat16
    assert aux["w"].dtype == aux["nz"].dtype == torch.bfloat16
    # the n half starts at 0.1 in bf16, the spare row at 0
    assert float(aux["nz"][0, 0]) == float(torch.tensor(0.1).to(torch.bfloat16))
    assert not aux["nz"][-1].any()
    res = h.train()
    assert res["step"] == 3 and np.isfinite(res["loss"])
    restored = CheckpointManager(h.model_dir).restore("cpu")
    raux = restored["opt_state"]["sparse"]["fm_wv"]
    assert raux["nz"].dtype == torch.bfloat16 and restored["params"]["fm_wv"].dtype == torch.bfloat16
    # the params' table is still a view of the restored store
    assert restored["params"]["fm_wv"].data_ptr() == raux["w"].data_ptr()
    f32 = h._f32_params(restored["params"])
    assert f32["fm_wv"].dtype == torch.float32
    assert torch.equal(f32["fm_wv"], restored["params"]["fm_wv"].float())
    ev = h.evaluate()
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
