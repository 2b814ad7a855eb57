"""K7 dma_row_scatter and the --dma_scatter path of the port against the
JAX package's, on the CPU.

The plain K7 is held bit-exact to pallas_sparse.dma_row_scatter (interpret
mode on the CPU, as tests/test_sparse.py runs it): both are row copies.
The --dma_scatter trajectories (DeepFM sparse, ESMM --mh_coo) run the
port's lane-padded fused store through its plain K7 against JAX's
build_sparse_train_step with the Pallas lookups (interpret mode): loss
within 2e-5 relative (the JAX package's own bar between two formulations
of one step), the whole [V, L] store, zero pad lanes included, within
1e-6 for DeepFM and 1e-5 for ESMM (f32 sums in another order over 5
steps; ESMM's COO pool sums hundreds of slots a row, and one moment of a
hot row lands 1.4e-6 away, the reason tests/test_torch_esmm.py holds its
fused store to 1e-5 too); the pad lanes exactly zero. The port's padded
store is also held bit-exact to its unpadded fused store over the same
steps: the same arithmetic on a wider row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data import sparse_batch as JSB
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.ops import pallas_sparse as PS
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch import main as CLI
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data import sparse_batch as TSB
from tf_repos_tpu_torch.data import synthetic as TS
from tf_repos_tpu_torch.data.synthetic import write_synthetic_libsvm
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import row_scatter as RS
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves

LR = 1e-2


# ------------------------------------------------------------------ kernel
def _case(v, width, s, live, extra_beyond=(), seed=0):
    """A store, u (``live`` unique ascending ids below v, then the given
    ids >= v, then the sentinel v up to s) and rows."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.choice(v, size=live, replace=False))
    u = np.concatenate([u, np.asarray(extra_beyond, np.int64), np.full(s - live - len(extra_beyond), v)])
    store = rng.standard_normal((v, width)).astype(np.float32)
    rows = rng.standard_normal((s, width)).astype(np.float32)
    return store, u.astype(np.int32), rows


@pytest.mark.parametrize("v,width,s,live,beyond,rows_dtype", [
    (50, 12, 40, 30, (), "float32"),  # sentinel u = V padding
    (64, 48, 40, 20, (65, 70, 1000), "float32"),  # u > V dropped too
    (1000, 48, 300, 280, (), "float32"),  # S not a multiple of the interpret chunk (256)
    (200, 128, 64, 60, (), "bfloat16"),  # rows cast to the store's dtype
], ids=["sentinel", "beyond_v", "ragged_s", "rows_cast"])
def test_plain_matches_pallas_bit_exact(v, width, s, live, beyond, rows_dtype):
    store, u, rows = _case(v, width, s, live, beyond)
    jrows = jnp.asarray(rows).astype(rows_dtype)
    want = np.asarray(PS.dma_row_scatter(jnp.asarray(store), jnp.asarray(u), jrows))
    trows = torch.from_numpy(rows).to(getattr(torch, rows_dtype))
    got = RS.dma_row_scatter(torch.from_numpy(store.copy()), torch.from_numpy(u), trows, v)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's row store: one spare row V, never written with n_valid = V
    st = torch.from_numpy(np.concatenate([store, np.zeros((1, width), np.float32)]))
    RS.dma_row_scatter(st, torch.from_numpy(u), trows, n_valid=v)
    np.testing.assert_array_equal(st[:-1].numpy(), want)
    assert float(st[-1].abs().max()) == 0.0


def test_plain_runs_in_place_and_counts_no_launch():
    store, u, rows = _case(30, 8, 20, 15)
    st = torch.from_numpy(store)
    before = RS.dma_row_scatter.launches
    assert RS.dma_row_scatter(st, torch.from_numpy(u), torch.from_numpy(rows), 30) is st
    assert RS.dma_row_scatter.launches == before
    np.testing.assert_array_equal(st[torch.from_numpy(u[:15]).long()].numpy(), rows[:15])


# --------------------------------------------------------------- optimizer
DFM = dict(
    model="DeepFM", feature_size=400, field_size=10, embedding_size=4,
    deep_layers="16,8", dropout="1.0,1.0", batch_size=32, l2_reg=1e-4,
    learning_rate=LR, static_fields=3,
)


def test_init_opt_state_store_matches_jax_lane_padded_wmv():
    jm = jax_create_model(JaxConfig(**DFM))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, _ = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    tm = create_model(Config(**DFM))
    jsopt = JSP.make_sparse_row_optimizer("Adam", LR, fused_table=True, dma_scatter=True)
    tsopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True, dma_scatter=True)
    jopt = JSP.init_opt_state(jm, jax_make_optimizer("Adam", LR), jsopt, jp)
    topt = SP.init_opt_state(tm, make_optimizer("Adam", LR), tsopt, tp)
    want = np.asarray(jopt["sparse"]["fm_wv"]["wmv"])
    store = topt["sparse"]["fm_wv"]["wmv"]
    assert want.shape == (400, 128) and tuple(store.shape) == (401, 128)  # L = round_up(3 * 5, 128)
    np.testing.assert_array_equal(store[:-1].numpy(), want)
    assert float(store[-1].abs().max()) == 0.0
    # the table is the w columns of the store, found from the carried K
    assert tuple(tp["fm_wv"].shape) == (400, 5) and tp["fm_wv"].data_ptr() == store.data_ptr()


@pytest.mark.parametrize("dma_scatter,width", [(False, 15), (True, 128)])
def test_table_view_for_both_fused_layouts(dma_scatter, width):
    sopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True, dma_scatter=dma_scatter)
    table = torch.randn((30, 5))
    aux = sopt.init(table)
    assert tuple(aux["wmv"].shape) == (31, width)
    np.testing.assert_array_equal(sopt.table(aux).numpy(), table.numpy())


def _dfm_batches(seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        z = np.minimum(rng.zipf(1.2, size=(32, 10)), 399).astype(np.int32)
        z[:, :3] = np.arange(1, 4)
        out.append({"feat_ids": z, "feat_vals": rng.random((32, 10)).astype(np.float32),
                    "label": (rng.random(32) < 0.5).astype(np.float32),
                    "mask": np.ones(32, np.float32)})
    return out


ESMM = dict(
    model="ESMM", feature_size=400, field_size=11, embedding_size=4,
    deep_layers="8,4", dropout="1.0,1.0", batch_size=16, l2_reg=1e-4,
    learning_rate=LR, multi_hot_pad=8, compute_dtype="float32",
)


def _esmm_batches(seed=12):
    rng = np.random.default_rng(seed)
    lens = {k: v / 25 for k, v in TS.PUBLISHED_MH_AVG_LENS.items()}
    return [TS.synthetic_aliccp_batch(rng, 16, 400, multi_hot_pad=8, avg_lens=lens, zipf_a=1.2)
            for _ in range(5)]


@pytest.mark.parametrize("model", ["DeepFM", "ESMM"])
def test_dma_scatter_trajectory_matches_jax(model):
    """5 --dma_scatter steps (DeepFM sparse; ESMM --mh_coo with combine)
    against the JAX package's."""
    kw = DFM if model == "DeepFM" else ESMM
    jm, tm = jax_create_model(JaxConfig(**kw)), create_model(Config(**kw))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    jtx, ttx = jax_make_optimizer("Adam", LR), make_optimizer("Adam", LR)
    jsopt = JSP.make_sparse_row_optimizer("Adam", LR, fused_table=True, dma_scatter=True)
    tsopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True, dma_scatter=True)
    jopt, topt = JSP.init_opt_state(jm, jtx, jsopt, jp), SP.init_opt_state(tm, ttx, tsopt, tp)
    if model == "DeepFM":
        jlookup, raw = PS.make_vmem_expand_lookup(), _dfm_batches()
        jchain = [JSB.SparseBatchMapper(jm.sparse_slots())]
        tchain = [TSB.SparseBatchMapper(tm.sparse_slots())]
    else:
        jlookup, raw = PS.make_vmem_expand_lookup(chunk=128, unroll=8), _esmm_batches()
        groups = tm.mh_coo_groups()
        jchain = [JSB.MhCooPacker(groups, combine=True, cdest_aux=False),
                  JSB.SparseBatchMapper(jm.sparse_slots(), pad_mode="pow2:400")]
        tchain = [TSB.MhCooPacker(groups, combine=True),
                  TSB.SparseBatchMapper(tm.sparse_slots(), pad_mode="pow2:400")]
    jstep = JSP.build_sparse_train_step(jm, jtx, jsopt, lookup=jlookup)
    tstep = SP.build_sparse_train_step(tm, ttx, tsopt, lookup=make_expand_lookup())
    # the port's unpadded fused store, from the same weights
    fp, fs = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    fsopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True)
    fopt = SP.init_opt_state(tm, make_optimizer("Adam", LR), fsopt, fp)
    fstep = SP.build_sparse_train_step(tm, make_optimizer("Adam", LR), fsopt, lookup=make_expand_lookup())
    key = jax.random.PRNGKey(1)
    RS.reset_launches()
    for i, b in enumerate(raw):
        jb, tb = dict(b), dict(b)
        for jc, tc in zip(jchain, tchain):
            jb, tb = jc(jb), tc(tb)
        jp, jopt, js, lj = jstep(jp, jopt, js, {k: jnp.asarray(v) for k, v in jb.items()}, key)
        tb = {k: torch.from_numpy(v) for k, v in tb.items()}
        tp, topt, ts, lt = tstep(tp, topt, ts, tb)
        fp, fopt, fs, lf = fstep(fp, fopt, fs, tb)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
        assert float(lt) == float(lf)
    assert RS.dma_row_scatter.launches == 0  # CPU tensors: the plain version
    (table,) = tm.sparse_slots()
    store = topt["sparse"][table]["wmv"]
    want = np.asarray(jopt["sparse"][table]["wmv"])
    k3 = 3 * tp[table].shape[-1]
    tol = 1e-6 if model == "DeepFM" else 1e-5
    np.testing.assert_allclose(store[:-1].numpy(), want, rtol=tol, atol=tol)
    assert float(store[:, k3:].abs().max()) == 0.0 and float(store[-1].abs().max()) == 0.0
    np.testing.assert_array_equal(store[:, :k3].numpy(), fopt["sparse"][table]["wmv"].numpy())
    dense_t = {k: v for k, v in tp.items() if k != table}
    dense_j = {k: v for k, v in jp.items() if k != table}
    for a, b in zip(tree_leaves(dense_t), jax.tree.leaves(dense_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_dma_scatter_validation():
    with pytest.raises(ValueError, match="dma_scatter"):
        SP.make_sparse_row_optimizer("Adam", 0.01, dma_scatter=True)
    sopt = SP.make_sparse_row_optimizer("Adam", 0.01, fused_table=True, dma_scatter=True)
    with pytest.raises(ValueError, match="f32"):
        sopt.init(torch.zeros((8, 4), dtype=torch.bfloat16))


def test_cli_train_then_eval_with_dma_scatter(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 160, feature_size=400, seed=0, zipf_a=1.2)
    write_synthetic_libsvm(str(d / "va.libsvm"), 64, feature_size=400, seed=1, zipf_a=1.2)
    common = ["--model=DeepFM", "--feature_size=400", "--field_size=39", "--embedding_size=4",
              "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--num_epochs=1",
              "--log_steps=2", "--eval_throttle_secs=0", f"--data_dir={d}",
              f"--model_dir={tmp_path}/m/", "--dt_dir=x", "--device=cpu", "--static_fields=13",
              "--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true",
              "--dma_scatter=true"]
    res = CLI.main(["--task_type=train", *common])
    assert res["step"] == 5 and np.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0
    ev = CLI.main(["--task_type=eval", *common])
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
