"""The port's DIN slice against the JAX package's, on the CPU: the
--mh_bucket width bucketer; the COO packer's DIN streams (compact segment
stream, idx-sorted stream) and the dedup mapper's run-row remap; the DIN
forward in every branch on converted weights (utils/convert.
params_from_jax); its loss and gradients; 5-step --mh_coo lazy-sparse
trajectories with and without --coo_sorted_bwd; and the CLI.

Tolerances: host arrays bit-identical; the forward 1e-5 relative and
1e-6 absolute, as tests/test_mh_coo.py holds its sorted-window DIN to
the padded one (f32 sums in another order); loss and gradients 2e-5
relative; the trajectories 2e-5 relative on the loss and 1e-5 on the
w|m|v rows, as tests/test_torch_esmm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data import ragged as JR
from tf_repos_tpu.data import sparse_batch as JSB
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.ops import pallas_sparse as PS
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch import main as CLI
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data import ragged as TR
from tf_repos_tpu_torch.data import sparse_batch as TSB
from tf_repos_tpu_torch.data import synthetic as TS
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import sorted_seg as SG
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten

LR = 1e-2
PAD = 8
KW = dict(
    model="DIN", feature_size=400, field_size=11, embedding_size=4, deep_layers="8,4",
    attention_layers="8", dropout="1.0,1.0", batch_size=16, l2_reg=1e-4, learning_rate=LR,
    multi_hot_pad=PAD,
)
LENS = {k: v / 25 for k, v in TS.PUBLISHED_MH_AVG_LENS.items()}  # ~10 for u_shop


def _batches(n, seed=0, b=16, pad=PAD, vocab=400, lens=LENS):
    rng = np.random.default_rng(seed)
    return [TS.synthetic_aliccp_batch(rng, b, vocab, multi_hot_pad=pad, avg_lens=lens, zipf_a=1.2)
            for _ in range(n)]


def _empty_user_fields(batch):
    """Every user multi-hot field empty: a COO stream of padding only."""
    batch = dict(batch)
    for f in ("u_cat", "u_shop", "u_brand", "u_int"):
        batch[f + "ids"] = np.zeros_like(batch[f + "ids"])
        batch[f + "vals"] = np.zeros_like(batch[f + "vals"])
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ host
@pytest.mark.parametrize("mode", ["pow2", "pow2:4"])
def test_mh_bucketer_matches_jax(mode):
    assert TR.MH_PAIRS == JR.MH_PAIRS
    tb, jb = TSB.MhPadBucketer(TR.MH_PAIRS, mode), JSB.MhPadBucketer(JR.MH_PAIRS, mode)
    short = {k: v / 8 for k, v in LENS.items()}
    raws = (_batches(2, seed=1, pad=32, lens=short) + _batches(1, seed=2, pad=32)
            + [_empty_user_fields(_batches(1, seed=3, pad=32)[0])])
    widths = []
    for raw in raws:
        got, want = tb(dict(raw)), jb(dict(raw))
        _same(got, want)
        widths.append(got["u_shopids"].shape[1])
    assert widths == sorted(widths) and widths[0] < 32  # monotonic, and it slices


def test_mh_bucketer_refuses_a_bad_mode():
    with pytest.raises(ValueError) as got:
        TSB.MhPadBucketer(TR.MH_PAIRS, "max")
    with pytest.raises(ValueError) as want:
        JSB.MhPadBucketer(JR.MH_PAIRS, "max")
    assert str(got.value) == str(want.value)


def test_packer_streams_and_mapper_match_jax():
    """MHC_CNT, MHC_CDEST, MHC_PERM, MHC_CIDX and MHC_SROWS, and the whole
    batch, bit-identical to the JAX packer followed by the JAX mapper, as
    the M and Su buckets grow and on an all-empty batch."""
    kw = dict(KW, feature_size=3000)
    tm, jm = create_model(Config(**kw)), jax_create_model(JaxConfig(**kw))
    groups = tm.mh_coo_groups()
    assert groups == jm.mh_coo_groups() and not tm.coo_combine_ok()
    assert tm.wants_sorted_seg() and tm.wants_sorted_aux()
    tchain = [TSB.MhCooPacker(groups, floor=64, cdest_aux=True, sorted_aux=True),
              TSB.SparseBatchMapper(tm.sparse_slots())]
    jchain = [JSB.MhCooPacker(groups, floor=64, cdest_aux=True, sorted_aux=True),
              JSB.SparseBatchMapper(jm.sparse_slots())]
    raws = (_batches(1, seed=4, b=8) + [_empty_user_fields(_batches(1, seed=5)[0])]
            + _batches(2, seed=6, b=32, pad=64, vocab=3000, lens=TS.PUBLISHED_MH_AVG_LENS))
    m_buckets, su_buckets = [], []
    for raw in raws:
        got, want = dict(raw), dict(raw)
        for ts, js in zip(tchain, jchain):
            got, want = ts(got), js(want)
        _same(got, want)
        m_buckets.append(got[TSB.MHC_IDX].shape[1])
        su_buckets.append(got[TSB.MHC_SROWS].shape[1])
    assert m_buckets == sorted(m_buckets) and m_buckets[0] < m_buckets[-1]
    assert su_buckets == sorted(su_buckets) and su_buckets[0] == 512 < su_buckets[-1]


def test_packer_leaves_the_din_streams_out_unless_asked():
    raw = _batches(1, seed=7)[0]
    groups = create_model(Config(**KW)).mh_coo_groups()
    got = TSB.MhCooPacker(groups)(dict(raw))
    want = JSB.MhCooPacker(groups, cdest_aux=False)(dict(raw))
    _same(got, want)
    assert TSB.MHC_CDEST not in got and TSB.MHC_PERM not in got


# ----------------------------------------------------------------- model
def _models(**over):
    kw = dict(KW, **over)
    jm, tm = jax_create_model(JaxConfig(**kw)), create_model(Config(**kw))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    return jm, tm, jp, js, tp, ts


def test_params_from_jax_carries_the_din_tree():
    jm, tm, jp, js, tp, ts = _models()
    assert sorted(tp) == sorted(jp) == ["att_mlp", "att_out", "emb", "mlp", "out"]
    assert sorted(ts) == sorted(js) == ["att_mlp", "mlp"]
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's own init gives the same tree
    p0, s0 = tm.init(torch.Generator().manual_seed(0))
    assert [x.shape for x in tree_leaves(p0)] == [x.shape for x in tl]
    assert jax.tree.structure(jax.tree.map(np.asarray, js)) == jax.tree.structure(
        jax.tree.map(lambda x: np.asarray(x), s0))


FORWARD_CASES = {
    # (attention_pooling, packed, lookup, batch edit)
    "padded_attention": (True, False, None, None),
    "padded_sum": (False, False, None, None),
    "coo_sum_plain": (False, True, None, None),
    "coo_sum_kernel_lookup": (False, True, "kernels", None),
    "coo_attention_destf": (True, True, None, None),
    "coo_attention_sorted": (True, True, "kernels", None),
    "coo_attention_sorted_no_cdest": (True, True, "kernels", "drop_cdest"),
    "coo_attention_sorted_bwd_stream": (True, True, "kernels", "sorted_aux"),
    "coo_attention_sorted_empty": (True, True, "kernels", "empty"),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case):
    attention, packed, lk, edit = FORWARD_CASES[case]
    jm, tm, jp, js, tp, ts = _models(attention_pooling=attention)
    raw = _batches(1, seed=9)[0]
    if edit == "empty":
        raw = _empty_user_fields(raw)
    want, _ = jm.apply(jp, js, _j(raw), train=False)  # the padded JAX forward
    batch = raw
    if packed:
        batch = TSB.MhCooPacker(tm.mh_coo_groups(), combine=tm.coo_combine_ok(),
                                cdest_aux=True, sorted_aux=edit == "sorted_aux")(dict(raw))
        if edit == "empty":
            assert int(batch[TSB.MHC_CNT].sum()) == 0
        if edit == "drop_cdest":
            del batch[TSB.MHC_CDEST]
        # and JAX's own COO forward on the same packed batch
        jlookup = PS.make_vmem_expand_lookup(chunk=128, unroll=8) if lk else None
        jcoo, _ = jm.apply(jp, js, _j(batch), train=False,
                           **({"lookup": jlookup} if jlookup else {}))
        np.testing.assert_allclose(np.asarray(jcoo["logits"]), np.asarray(want["logits"]),
                                   rtol=1e-5, atol=1e-6)
    got, _ = tm.apply(tp, ts, _t(batch), train=False,
                      **({"lookup": make_expand_lookup()} if lk else {}))
    for k in ("logits", "prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "coo_sorted"])
def test_loss_and_gradients_match_jax(packed):
    jm, tm, jp, js, tp, ts = _models(compute_dtype="float32")
    raw = _batches(1, seed=10)[0]
    raw["mask"][-3:] = 0.0
    lookups = {}
    if packed:
        raw = TSB.MhCooPacker(tm.mh_coo_groups(), cdest_aux=True, sorted_aux=True)(raw)
        lookups = {"jax": PS.make_vmem_expand_lookup(chunk=128, unroll=8),
                   "torch": make_expand_lookup()}
    jkw = {"lookup": lookups["jax"]} if packed else {}
    tkw = {"lookup": lookups["torch"]} if packed else {}
    (lj, _), gj = jax.value_and_grad(lambda p: jm.loss(p, js, _j(raw), train=True, **jkw),
                                     has_aux=True)(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    lt, _ = tm.loss(tree_unflatten(tp, leaves), ts, _t(raw), train=True, **tkw)
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-5)
    for a, b in zip(gt, jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("sorted_bwd", [False, True], ids=["k2_backward", "coo_sorted_bwd"])
def test_coo_sparse_trajectory_matches_jax(sorted_bwd):
    """5 --mh_coo --pallas_expand lazy-sparse Adam steps (fused w|m|v)
    against the JAX package's build_sparse_train_step with the Pallas
    lookup (sorted-window kernels, interpret mode); the port runs
    make_expand_lookup, whose plain versions serve CPU tensors."""
    jm, tm, jp, js, tp, ts = _models(compute_dtype="float32")
    jtx, ttx = jax_make_optimizer("Adam", LR), make_optimizer("Adam", LR)
    jsopt = JSP.make_sparse_row_optimizer("Adam", LR, fused_table=True)
    tsopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True)
    jopt, topt = JSP.init_opt_state(jm, jtx, jsopt, jp), SP.init_opt_state(tm, ttx, tsopt, tp)
    jstep = JSP.build_sparse_train_step(jm, jtx, jsopt,
                                        lookup=PS.make_vmem_expand_lookup(chunk=128, unroll=8))
    tstep = SP.build_sparse_train_step(tm, ttx, tsopt, lookup=make_expand_lookup())
    # fixed buckets (uids at the vocab, COO at 1024, Su at 512): one JAX compile
    groups = tm.mh_coo_groups()
    aux = dict(cdest_aux=True, sorted_aux=sorted_bwd)
    jchain = [JSB.MhCooPacker(groups, **aux), JSB.SparseBatchMapper(jm.sparse_slots(), "pow2:400")]
    tchain = [TSB.MhCooPacker(groups, **aux), TSB.SparseBatchMapper(tm.sparse_slots(), "pow2:400")]
    key = jax.random.PRNGKey(1)
    SG.reset_launches()
    for i, raw in enumerate(_batches(5, seed=12)):
        jb, tb = dict(raw), dict(raw)
        for js_, ts_ in zip(jchain, tchain):
            jb, tb = js_(jb), ts_(tb)
        assert (TSB.MHC_PERM in tb) == sorted_bwd
        jp, jopt, js, lj = jstep(jp, jopt, js, _j(jb), key)
        tp, topt, ts, lt = tstep(tp, topt, ts, _t(tb))
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
    assert SG.sorted_segsum.launches == 0  # CPU tensors: the plain versions
    np.testing.assert_allclose(topt["sparse"]["emb"]["wmv"][:-1].numpy(),
                               np.asarray(jopt["sparse"]["emb"]["wmv"]), rtol=1e-5, atol=1e-5)
    dense_t = {k: v for k, v in tp.items() if k != "emb"}
    dense_j = {k: v for k, v in jp.items() if k != "emb"}
    for a, b in zip(tree_leaves(dense_t), jax.tree.leaves(dense_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("sorted_bwd", [False, True], ids=["k2_backward", "coo_sorted_bwd"])
def test_cli_train_then_eval(tmp_path, capsys, sorted_bwd):
    d = tmp_path / "data"
    TS.main(["--out_dir", str(d), "--format", "aliccp", "--feature_size", "3000",
             "--train", "70", "--valid", "40", "--test", "5", "--mh_lens", "published",
             "--zipf_a", "1.2"])
    common = ["--model=DIN", "--feature_size=3000", "--field_size=11", "--embedding_size=4",
              "--deep_layers=8,4", "--attention_layers=8", "--dropout=1.0,1.0",
              "--batch_size=16", "--num_epochs=1", "--log_steps=2", "--eval_throttle_secs=0",
              f"--data_dir={d}", f"--model_dir={tmp_path}/m/", "--dt_dir=x", "--device=cpu",
              "--multi_hot_pad=32", "--sparse_table_update=true", "--fused_table=true",
              "--pallas_expand=true", "--mh_coo=true", "--mh_bucket=pow2",
              f"--coo_sorted_bwd={str(sorted_bwd).lower()}", "--compute_dtype=bfloat16"]
    res = CLI.main(["--task_type=train", *common])
    assert res["step"] == 5 and np.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0
    out = capsys.readouterr().out
    assert "WARNING: --mh_coo_combine disabled: DIN" in out
    assert "INFO: step = 2, loss = " in out and "RESULT:" in out
    ev = CLI.main(["--task_type=eval", *common])
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
    assert ev["auc"] == pytest.approx(res["auc"], rel=1e-6)


def test_mh_bucket_needs_the_aliccp_layout(tmp_path):
    with pytest.raises(ValueError, match="--mh_bucket"):
        CLI.main(["--model=DeepFM", "--feature_size=400", "--field_size=39", "--mh_bucket=pow2",
                  f"--model_dir={tmp_path}/m/", f"--data_dir={tmp_path}", "--device=cpu"])
