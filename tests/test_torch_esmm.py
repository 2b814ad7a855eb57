"""The port's ESMM slice against the JAX package's, on the CPU: the
Ali-CCP parser, reader and synthetic writers; the COO packer and dedup
mapper; the ESMM forward on converted weights (utils/convert.
params_from_jax), COO branch and padded branch; a 5-step --mh_coo sparse
trajectory; the eval metrics; and the CLI.

Tolerances: host arrays are held bit-exact, the COO triplet in order
(both packages' native combines emit first-seen order; the port's plain
numpy combine the same order, its weights within k_max * 2**-24
relative, k_max the most copies of one id in a row, since it sums in f64
and the native combine in f32); the forward to 1e-5 (f32 sums in another order);
the trajectory to 2e-5 relative on the loss and 1e-5 on the w|m|v rows,
as tests/test_torch_sparse_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data import ragged as JR
from tf_repos_tpu.data import sparse_batch as JSB
from tf_repos_tpu.data import synthetic as JS
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.ops.pallas_sparse import make_vmem_expand_lookup
from tf_repos_tpu.train import loop as JL
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch import main as CLI
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data import ragged as TR
from tf_repos_tpu_torch.data import sparse_batch as TSB
from tf_repos_tpu_torch.data import synthetic as TS
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import coo_pool as CP
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import loop as TL
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten

LR = 1e-2
PAD = 8
KW = dict(
    model="ESMM", feature_size=400, field_size=11, embedding_size=4,
    deep_layers="8,4", dropout="1.0,1.0", batch_size=16, l2_reg=1e-4,
    learning_rate=LR, multi_hot_pad=PAD,
)
LENS = {k: v / 25 for k, v in TS.PUBLISHED_MH_AVG_LENS.items()}  # ~10 for u_shop


def _batches(n, seed=0, b=16):
    rng = np.random.default_rng(seed)
    return [TS.synthetic_aliccp_batch(rng, b, 400, multi_hot_pad=PAD, avg_lens=LENS, zipf_a=1.2)
            for _ in range(n)]


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ host
MALFORMED = [
    b"s1,1,0,101:5:1.0 110_14:7:0.5 110_14:8:2.0 210:9:1.0 206:11:1.0",
    b"s2,0,0,",  # no features: every default
    b"not a sample line",  # wrong part count: mask 0
    b"s3,1,1,101:3:1.0,extra",  # five parts: mask 0
    b"s4,1,0,109_14:4 bad 127_14:6:1.5:9 301:12:1.0 999:5:1.0 216:3:1.0 207:2:1.0",
    b"s5,0,0," + b" ".join(b"110_14:%d:0.25" % i for i in range(20, 40)),  # truncated at the pad
    b"s6,1,0," + b" ".join(b"210:%d:1.0" % i for i in range(50, 70)),
    b"  s7,1,1,150_14:13:3.0 101:1:1.0 101:2:1.0  \n",
]


def test_parse_aliccp_lines_bit_identical():
    got, want = TR.parse_aliccp_lines(MALFORMED, PAD), JR.parse_aliccp_lines(MALFORMED, PAD)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert list(got["mask"]) == [1, 1, 0, 0, 1, 1, 1, 1]


def test_synthetic_aliccp_matches_jax(tmp_path):
    for i, kw in enumerate([dict(), dict(zipf_a=1.2, mh_avg_lens=LENS)]):
        a, b = tmp_path / f"a{i}.txt", tmp_path / f"b{i}.txt"
        JS.write_synthetic_aliccp(str(a), 60, feature_size=3000, seed=4, **kw)
        TS.write_synthetic_aliccp(str(b), 60, feature_size=3000, seed=4, **kw)
        assert a.read_bytes() == b.read_bytes()
    for kw in (dict(), dict(avg_lens=LENS, zipf_a=1.2)):
        want = JS.synthetic_aliccp_batch(np.random.default_rng(2), 8, 500, multi_hot_pad=PAD, **kw)
        got = TS.synthetic_aliccp_batch(np.random.default_rng(2), 8, 500, multi_hot_pad=PAD, **kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reader_matches_jax(tmp_path):
    path = str(tmp_path / "tr.samples.txt")
    TS.write_synthetic_aliccp(path, 37, feature_size=2000, seed=5, mh_avg_lens=LENS)
    got = list(TR.AliccpDataset([path], batch_size=16, multi_hot_pad=PAD))
    want = list(JR.AliccpDataset([path], batch_size=16, multi_hot_pad=PAD))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[-1]["mask"].sum() == 5  # the zero-padded tail batch
    # shuffled: the same window shuffle on the same random stream
    kw = dict(batch_size=16, multi_hot_pad=PAD, perform_shuffle=True, seed=1, num_epochs=2)
    shuffled = list(TR.AliccpDataset([path], **kw))
    want = list(JR.AliccpDataset([path], **kw))
    assert len(shuffled) == len(want) == 5
    for g, w in zip(shuffled, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_combine_dups_matches_jax():
    rng = np.random.default_rng(7)
    a = np.where(rng.random((12, 10)) < 0.7, rng.integers(1, 6, size=(12, 10)), 0).astype(np.int32)
    v = rng.random((12, 10)).astype(np.float32)
    for vals in (None, v):
        jids, jw, jcnt = JSB.combine_dups(a, vals)
        for got in (TSB.combine_dups(a, vals), TSB.combine_dups(a, vals, use_native=False)):
            np.testing.assert_array_equal(got[2], jcnt)
            np.testing.assert_array_equal(got[0], jids)  # first-seen order within a row
        np.testing.assert_array_equal(TSB.combine_dups(a, vals)[1], jw)
        # the plain version sums in f64 and rounds once, the native one in
        # f32 in slot order: k_max - 1 roundings, k_max the most copies of
        # one id in a row
        k_max = max(np.unique(r[r > 0], return_counts=True)[1].max(initial=1) for r in a)
        np.testing.assert_allclose(TSB.combine_dups(a, vals, use_native=False)[1], jw,
                                   rtol=k_max * 2 ** -24)


def _triples(batch):
    return [batch[k].reshape(-1).tolist() for k in (TSB.MHC_IDX, TSB.MHC_DEST, TSB.MHC_W)]


@pytest.mark.parametrize("combine", [False, True])
def test_packer_then_mapper_matches_jax(combine):
    tm, jm = create_model(Config(**KW)), jax_create_model(JaxConfig(**KW))
    groups = tm.mh_coo_groups()
    assert groups == jm.mh_coo_groups() and tm.coo_combine_ok()
    tchain = [TSB.MhCooPacker(groups, floor=64, combine=combine),
              TSB.SparseBatchMapper(tm.sparse_slots())]
    jchain = [JSB.MhCooPacker(groups, floor=64, combine=combine, cdest_aux=False),
              JSB.SparseBatchMapper(jm.sparse_slots())]
    for raw in _batches(3, seed=8):
        got, want = dict(raw), dict(raw)
        for ts, js in zip(tchain, jchain):
            got, want = ts(got), js(want)
        assert got.keys() == want.keys()
        assert _triples(got) == _triples(want)
        for k in want:
            if k not in (TSB.MHC_IDX, TSB.MHC_DEST, TSB.MHC_W):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # group-major emission, rows ascending: every (group, row) bag is
        # one contiguous run of equal dest
        live = got[TSB.MHC_CNT].sum()
        d = got[TSB.MHC_DEST][0, :live]
        assert np.all(np.diff(d % len(groups)) >= 0)
        assert np.all(got[TSB.MHC_W][0, live:] == 0)


# ----------------------------------------------------------------- model
def _models(**over):
    kw = dict(KW, **over)
    jm, tm = jax_create_model(JaxConfig(**kw)), create_model(Config(**kw))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    return jm, tm, jp, js, tp, ts


def test_forward_coo_and_padded_match_jax():
    jm, tm, jp, js, tp, ts = _models()
    raw = _batches(1, seed=9)[0]
    packed = TSB.MhCooPacker(tm.mh_coo_groups(), combine=True)(dict(raw))
    outs = {}
    for name, b in (("padded", raw), ("coo", packed)):
        oj, _ = jm.apply(jp, js, _j(b), train=False)
        ot, _ = tm.apply(tp, ts, _t(b), train=False)
        for k in ("logits", "logits_cvr", "pctcvr"):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {k}")
        outs[name] = ot
    for k in ("logits", "logits_cvr", "pctr", "pcvr", "pctcvr"):
        np.testing.assert_allclose(outs["coo"][k].numpy(), outs["padded"][k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_loss_and_gradients_match_jax():
    jm, tm, jp, js, tp, ts = _models(compute_dtype="float32")
    raw = _batches(1, seed=10)[0]
    raw["mask"][-3:] = 0.0
    (lj, _), gj = jax.value_and_grad(lambda p: jm.loss(p, js, _j(raw), train=True),
                                     has_aux=True)(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    lt, (out, _) = tm.loss(tree_unflatten(tp, leaves), ts, _t(raw), train=True)
    gt = list(torch.autograd.grad(lt, leaves))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    for a, b in zip(gt, jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    per_t = tm.per_example_loss(out, _t(raw)).detach().numpy()
    oj, _ = jm.apply(jp, js, _j(raw), train=False)
    np.testing.assert_allclose(per_t, np.asarray(jm.per_example_loss(oj, _j(raw))), rtol=1e-5)
    assert tm.prediction_keys == jm.prediction_keys


@pytest.mark.parametrize("model", ["ESMM", "DeepFM"])
def test_eval_metric_names_and_values_match_jax(model):
    if model == "ESMM":
        jm, tm, jp, js, tp, ts = _models()
        b = _batches(1, seed=11)[0]
    else:
        kw = dict(model="DeepFM", feature_size=300, field_size=10, embedding_size=4,
                  deep_layers="8,4", dropout="1.0,1.0")
        jm, tm = jax_create_model(JaxConfig(**kw)), create_model(Config(**kw))
        jp, js = jm.init(jax.random.PRNGKey(0))
        tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
        rng = np.random.default_rng(11)
        b = {"feat_ids": rng.integers(1, 300, size=(16, 10)).astype(np.int32),
             "feat_vals": rng.random((16, 10)).astype(np.float32),
             "label": (rng.random(16) < 0.5).astype(np.float32),
             "mask": np.ones(16, np.float32)}
    want = JL.finalize_eval(JL.build_eval_step(jm)(jp, js, JL.init_eval_acc(jm), _j(b)))
    got = TL.finalize_eval(TL.build_eval_step(tm)(tp, ts, TL.init_eval_acc(tm, "cpu"), _t(b)))
    names = ["CTR_AUC", "CVR_AUC", "CTCVR_AUC"] if model == "ESMM" else ["auc"]
    assert TL.model_metric_names(tm) == names
    assert list(got) == ["loss", *names] and got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_coo_sparse_trajectory_matches_jax():
    """5 --mh_coo sparse steps (fused w|m|v Adam) against the JAX package's
    build_sparse_train_step with the Pallas lookup and COO pool in
    interpret mode; the port runs make_expand_lookup, whose plain
    versions serve CPU tensors."""
    jm, tm, jp, js, tp, ts = _models(compute_dtype="float32")
    jtx, ttx = jax_make_optimizer("Adam", LR), make_optimizer("Adam", LR)
    jsopt = JSP.make_sparse_row_optimizer("Adam", LR, fused_table=True)
    tsopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True)
    jopt, topt = JSP.init_opt_state(jm, jtx, jsopt, jp), SP.init_opt_state(tm, ttx, tsopt, tp)
    jstep = JSP.build_sparse_train_step(jm, jtx, jsopt, lookup=make_vmem_expand_lookup(chunk=128, unroll=8))
    tstep = SP.build_sparse_train_step(tm, ttx, tsopt, lookup=make_expand_lookup())
    # fixed buckets (uids at the vocab, COO at 1024): one JAX compile
    groups = tm.mh_coo_groups()
    jchain = [JSB.MhCooPacker(groups, combine=True, cdest_aux=False),
              JSB.SparseBatchMapper(jm.sparse_slots(), pad_mode="pow2:400")]
    tchain = [TSB.MhCooPacker(groups, combine=True),
              TSB.SparseBatchMapper(tm.sparse_slots(), pad_mode="pow2:400")]
    key = jax.random.PRNGKey(1)
    CP.reset_launches()
    for i, raw in enumerate(_batches(5, seed=12)):
        jb, tb = dict(raw), dict(raw)
        for js_, ts_ in zip(jchain, tchain):
            jb, tb = js_(jb), ts_(tb)
        assert TSB.MHC_IDX in tb and "u_shopids" not in tb
        jp, jopt, js, lj = jstep(jp, jopt, js, _j(jb), key)
        tp, topt, ts, lt = tstep(tp, topt, ts, _t(tb))
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
    assert CP.coo_pool_rows.launches == 0  # CPU tensors: the plain versions
    np.testing.assert_allclose(topt["sparse"]["emb"]["wmv"][:-1].numpy(),
                               np.asarray(jopt["sparse"]["emb"]["wmv"]), rtol=1e-5, atol=1e-5)
    dense_t = {k: v for k, v in tp.items() if k != "emb"}
    dense_j = {k: v for k, v in jp.items() if k != "emb"}
    for a, b in zip(tree_leaves(dense_t), jax.tree.leaves(dense_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- CLI
def test_cli_train_then_eval(tmp_path, capsys):
    d = tmp_path / "data"
    TS.main(["--out_dir", str(d), "--format", "aliccp", "--feature_size", "3000",
             "--train", "70", "--valid", "40", "--test", "5", "--mh_lens", "published",
             "--zipf_a", "1.2"])
    common = ["--model=ESMM", "--feature_size=3000", "--field_size=11", "--embedding_size=4",
              "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=16", "--num_epochs=1",
              "--log_steps=2", "--eval_throttle_secs=0", f"--data_dir={d}",
              f"--model_dir={tmp_path}/m/", "--dt_dir=x", "--device=cpu", "--multi_hot_pad=32",
              "--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true",
              "--mh_coo=true", "--compute_dtype=bfloat16"]
    res = CLI.main(["--task_type=train", *common])
    assert res["step"] == 5 and np.isfinite(res["loss"])
    for k in ("CTR_AUC", "CVR_AUC", "CTCVR_AUC"):
        assert 0.0 <= res[k] <= 1.0
    assert "INFO: step = 2, loss = " in capsys.readouterr().out
    ev = CLI.main(["--task_type=eval", *common])
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
    assert ev["CTR_AUC"] == pytest.approx(res["CTR_AUC"], rel=1e-6)


@pytest.mark.parametrize(
    "extra,error",
    [(["--sparse_table_update=false"], ValueError),
     (["--model=DeepFM", "--field_size=39"], ValueError)],
    ids=["needs_sparse_table_update", "model_without_groups"],
)
def test_mh_coo_flag_validation(tmp_path, extra, error):
    args = ["--model=ESMM", "--feature_size=400", "--field_size=11", "--sparse_table_update=true",
            "--mh_coo=true", f"--model_dir={tmp_path}/m/", f"--data_dir={tmp_path}",
            "--device=cpu", *extra]
    with pytest.raises(error, match="--mh_coo"):
        CLI.main(args)
