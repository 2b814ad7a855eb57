"""The port's entry point, ``tf_repos_tpu_torch.main``, on tiny synthetic
libsvm data on the CPU: train and eval, then infer (pred.txt against the
JAX package's on the same data and weights, 2e-5), export and eval_loop;
its refusal of flags it does not implement; and its refusal to run on
the CPU unless asked. Also the port's copies of the synthetic writer and
the libsvm reader against the JAX package's."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data import libsvm as JL
from tf_repos_tpu.data.synthetic import write_synthetic_libsvm as jax_write
from tf_repos_tpu.train.harness import Harness as JaxHarness
from tf_repos_tpu_torch import main as M
from tf_repos_tpu_torch.config import parse_config
from tf_repos_tpu_torch.data import libsvm as TL
from tf_repos_tpu_torch.data.synthetic import write_synthetic_aliccp, write_synthetic_libsvm
from tf_repos_tpu_torch.ops import sparse_rows as SR
from tf_repos_tpu_torch.serve.scorer import Scorer
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves

FLAGS = [
    "--model=DeepFM", "--feature_size=400", "--field_size=39",
    "--embedding_size=4", "--deep_layers=8,4", "--dropout=1.0,1.0",
    "--batch_size=32", "--num_epochs=1", "--log_steps=2", "--eval_throttle_secs=0",
]


@pytest.fixture
def data_dir(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 160, feature_size=400, seed=0)
    write_synthetic_libsvm(str(d / "va.libsvm"), 64, feature_size=400, seed=1)
    return d


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true",
         "--static_fields=13", "--sparse_catchup=true", "--compute_dtype=bfloat16",
         "--steps_per_dispatch=2"],
    ],
    ids=["dense", "sparse_fused_kernels"],
)
def test_main_train_then_eval(tmp_path, data_dir, extra, capsys):
    common = [*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/m/", "--dt_dir=x",
              "--device=cpu", *extra]
    SR.reset_launches()
    res = M.main(["--task_type=train", *common])
    assert res["step"] == 5 and np.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0
    out = capsys.readouterr().out
    assert "INFO: step = 2, loss = " in out and "RESULT:" in out
    # on the CPU the lookup takes the plain versions: no kernel launched
    assert SR.expand_rows.launches == 0 and SR.accumulate_rows.launches == 0
    ev = M.main(["--task_type=eval", *common])
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
    assert ev["auc"] == pytest.approx(res["auc"], rel=1e-6)


@pytest.mark.parametrize(
    "flags,error,match",
    [(["--param_dtype=bfloat16"], ValueError, "requires --sparse_table_update"),
     (["--dist_mode=2"], ValueError, "--dist_mode=2 needs --worker_hosts"),
     (["--mesh_data=3"], ValueError, "not divisible by the data-mesh size 3"),
     (["--slim_transfer=true"], ValueError, "requires --static_fields>0"),
     (["--dist_mode=2", "--worker_hosts=127.0.0.1:1,127.0.0.1:2", "--mesh_data=3"], ValueError,
      "the data axis 3 does not divide over 2 hosts"),
     (["--mesh_model=2", "--task_type=serve"], ValueError, "unknown task_type"),
     (["--fused_moments=true", "--sparse_table_update=true", "--fused_table=true"], ValueError,
      "--fused_table supersedes --fused_moments"),
     (["--mesh_data=2", "--device=cuda"], ValueError, "needs 2 cards")],
)
def test_unsupported_flags_raise(tmp_path, data_dir, flags, error, match):
    """The port raises the JAX package's ValueError where it refuses a
    flag; --dist_mode=2 refuses an empty --worker_hosts by name (the JAX
    package's TPU-pod branch has no counterpart), and a mesh refuses,
    before any rank starts or any host is contacted, a data axis that
    does not divide over the hosts, a batch that does not split over
    "data", an unknown task and more positions than cards."""
    with pytest.raises(error, match=match):
        M.main([*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/m/",
                "--device=cpu", *flags])


# the DeepFM flags at the serving tests' width, and DIN's on Ali-CCP lines
INFER = {
    "DeepFM": [*FLAGS, "--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true",
               "--static_fields=13"],
    "DIN": ["--model=DIN", "--feature_size=600", "--field_size=11", "--embedding_size=4",
            "--deep_layers=8,4", "--attention_layers=8", "--dropout=1.0,1.0", "--batch_size=16",
            "--multi_hot_pad=8", "--mh_bucket=pow2", "--sparse_table_update=true",
            "--fused_table=true", "--pallas_expand=true", "--mh_coo=true"],
}


@pytest.mark.parametrize("model", ["DeepFM", "DIN"])
def test_main_infer_matches_jax(tmp_path, data_dir, model):
    """task_type=infer: the port's pred.txt (serving lookup over the
    whole table) equals the JAX package's on the same te* lines and
    weights: the JAX harness infers from its seed's init (no
    checkpoint), the port from a checkpoint of those weights converted."""
    data = tmp_path / "infer_data"
    data.mkdir()
    if model == "DeepFM":
        shutil.copy(data_dir / "va.libsvm", data / "te.libsvm")
    else:
        write_synthetic_aliccp(str(data / "te.samples.txt"), 40, feature_size=600, seed=5)
    argv = [*INFER[model], f"--data_dir={data}", f"--model_dir={tmp_path}/m/", "--dt_dir=x",
            "--device=cpu"]
    cfg = parse_config(argv)
    jcfg = JaxConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
    jh = JaxHarness(jcfg.replace(model_dir=f"{tmp_path}/jax/"))
    jts = jh.init_train_state()
    want_path = jh.infer(out_path=str(tmp_path / "jax_pred.txt"))
    # the port's train state with the JAX weights copied in (into the
    # fused store's [V, K] view for the table)
    h = Harness(cfg)
    state = h.init_train_state()
    tp, tm = params_from_jax(jax.tree.map(np.asarray, jts["params"]),
                             jax.tree.map(np.asarray, jts["mstate"]))
    for dst, src in zip(tree_leaves(state["params"]), tree_leaves(tp)):
        dst.copy_(src)
    state["mstate"] = tm
    CheckpointManager(h.model_dir).save(0, state)
    SR.reset_launches()
    got_path = M.main(["--task_type=infer", *argv])
    assert got_path == str(data / "pred.txt")
    assert SR.expand_rows.launches == 0  # the plain version on the CPU
    got = np.loadtxt(got_path)
    want = np.loadtxt(want_path)
    assert got.shape == want.shape == (64 if model == "DeepFM" else 40,)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)  # pred.txt's 6 decimals


# the libsvm zoo at the CLI tests' width, each on its own flags: the
# lazy-sparse step on the fused store and the row kernels' lookup (their
# plain versions here), LR on plain lazy Adam
ZOO_SPARSE = ["--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true"]
ZOO_FLAGS = {
    "LR": ["--sparse_table_update=true"],
    "fnn": ZOO_SPARSE,
    "ipnn": ZOO_SPARSE,
    "opnn": ZOO_SPARSE,
    "NFM": [*ZOO_SPARSE, "--batch_norm=true", "--dropout=1.0,1.0,1.0"],
    "AFM": [*ZOO_SPARSE, "--attention_layers=8"],
    "DCN": [*ZOO_SPARSE, "--cross_layers=2"],
    "DeepMVM": ZOO_SPARSE,
}


@pytest.mark.parametrize("model", list(ZOO_FLAGS))
def test_main_zoo_train_eval_infer(tmp_path, data_dir, model):
    """Each zoo model through the CLI: train then eval (the same loss and
    AUC from the checkpoint), then infer, whose pred.txt equals the JAX
    CLI's on the same te* lines and weights within 2e-5 (the JAX harness
    infers from its seed's init, LR's replaced by numpy weights, the port
    from a checkpoint of those weights converted)."""
    flags = [*FLAGS[1:], f"--model={model}", *ZOO_FLAGS[model], f"--data_dir={data_dir}",
             "--dt_dir=x", "--device=cpu"]
    train = [*flags, f"--model_dir={tmp_path}/m/"]
    res = M.main(["--task_type=train", *train])
    assert res["step"] == 5 and np.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0
    ev = M.main(["--task_type=eval", *train])
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
    assert ev["auc"] == pytest.approx(res["auc"], rel=1e-6)

    data = tmp_path / "infer_data"
    data.mkdir()
    shutil.copy(data_dir / "va.libsvm", data / "te.libsvm")
    argv = [*flags, f"--data_dir={data}", f"--model_dir={tmp_path}/i/"]
    cfg = parse_config(argv)
    jh = JaxHarness(JaxConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
                    .replace(model_dir=f"{tmp_path}/jax/"))
    jts = jh.init_train_state()
    if model == "LR":  # LR's init is all zeros: numpy weights on both sides
        w = np.random.default_rng(0).standard_normal(400).astype(np.float32)
        jts["params"]["w"] = jax.numpy.asarray(w)
        jh.restore_or_init = lambda ckpt: jts
    want = np.loadtxt(jh.infer(out_path=str(tmp_path / "jax_pred.txt")))
    h = Harness(cfg)
    state = h.init_train_state()
    tp, tm = params_from_jax(jax.tree.map(np.asarray, jts["params"]),
                             jax.tree.map(np.asarray, jts["mstate"]))
    for dst, src in zip(tree_leaves(state["params"]), tree_leaves(tp)):
        dst.copy_(src)
    state["mstate"] = tm
    CheckpointManager(h.model_dir).save(0, state)
    got = np.loadtxt(M.main(["--task_type=infer", *argv]))
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)  # pred.txt's 6 decimals


def test_main_export_and_eval_loop(tmp_path, data_dir):
    common = [*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/m/", "--dt_dir=x",
              "--device=cpu", "--sparse_table_update=true", "--fused_table=true",
              "--static_fields=13"]
    res = M.main(["--task_type=train", *common])
    version_dir = M.main(["--task_type=export", *common])
    assert os.path.dirname(version_dir) == f"{tmp_path}/m/x/servable"
    assert {"saved_model.json", "variables.npz"} <= set(os.listdir(version_dir))
    s = Scorer(os.path.dirname(version_dir), batch_buckets=(8,), warmup=False, device="cpu")
    assert s.version == os.path.basename(version_dir)
    rows = next(iter(TL.LibsvmDataset([str(data_dir / "va.libsvm")], field_size=39, batch_size=8)))
    probs = s.score([{"feat_ids": rows["feat_ids"][i], "feat_vals": rows["feat_vals"][i]}
                     for i in range(8)])["prob"]
    assert probs.shape == (8,) and np.all((probs > 0) & (probs < 1))
    # the evaluator evaluates the newest checkpoint once, then times out
    ev = M.main(["--task_type=eval_loop", "--eval_loop_secs=1", "--eval_loop_timeout=2", *common])
    assert ev["step"] == res["step"]
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
    assert ev["auc"] == pytest.approx(res["auc"], rel=1e-6)
    recs = [json.loads(line) for line in open(f"{tmp_path}/m/x/eval_metrics.jsonl")]
    assert [(r["step"], r["kind"]) for r in recs] == [(res["step"], "eval")]
    assert recs[0]["loss"] == pytest.approx(res["loss"], rel=1e-6)


def test_unknown_task_type_raises(tmp_path, data_dir):
    with pytest.raises(ValueError, match="unknown task_type"):
        M.main([*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/m/", "--device=cpu",
                "--task_type=serve"])


def test_no_cuda_raises_instead_of_running_on_cpu(tmp_path, data_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.main([*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/m/"])
    assert not (tmp_path / "m").exists()


def test_synthetic_writer_matches_jax(tmp_path):
    jax_write(str(tmp_path / "a.libsvm"), 50, feature_size=1000, seed=3)
    write_synthetic_libsvm(str(tmp_path / "b.libsvm"), 50, feature_size=1000, seed=3)
    assert (tmp_path / "a.libsvm").read_bytes() == (tmp_path / "b.libsvm").read_bytes()


def test_reader_matches_jax(tmp_path):
    path = str(tmp_path / "tr.libsvm")
    write_synthetic_libsvm(path, 70, feature_size=500, seed=4, zipf_a=1.2)
    lines = open(path, "rb").read().splitlines()
    for a, b in zip(TL.parse_libsvm_lines(lines, 39), JL.parse_libsvm_lines(lines, 39)):
        np.testing.assert_array_equal(a, b)
    got = list(TL.LibsvmDataset([path], field_size=39, batch_size=32))
    want = list(JL.LibsvmDataset([path], field_size=39, batch_size=32, use_native=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("feat_ids", "feat_vals", "label", "mask"):
            np.testing.assert_array_equal(g[k], w[k])
    # ragged lines take the per-line path: short rows are zero-padded
    ids, vals, labels = TL.parse_libsvm_lines([b"1 5:0.5 7:1", b"0 3:2"], 3)
    np.testing.assert_array_equal(ids, [[5, 7, 0], [3, 0, 0]])
    np.testing.assert_array_equal(labels, [1, 0])
