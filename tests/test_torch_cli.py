"""The port's entry point, ``tf_repos_tpu_torch.main``, on tiny synthetic
libsvm data on the CPU; its refusal of flags it does not implement; and
its refusal to run on the CPU unless asked. Also the port's copies of the
synthetic writer and the libsvm reader against the JAX package's."""

import numpy as np
import pytest
import torch

from tf_repos_tpu.data import libsvm as JL
from tf_repos_tpu.data.synthetic import write_synthetic_libsvm as jax_write
from tf_repos_tpu_torch import main as M
from tf_repos_tpu_torch.data import libsvm as TL
from tf_repos_tpu_torch.data.synthetic import write_synthetic_libsvm
from tf_repos_tpu_torch.ops import sparse_rows as SR

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
    "flag",
    ["--fused_moments=true", "--check_numerics=true", "--task_type=infer", "--slim_transfer=true",
     "--packed_cache=true", "--profile_steps=2", "--mesh_model=2", "--param_dtype=bfloat16", "--map_workers=2",
     "--task_type=export"],
)
def test_unsupported_flags_raise(tmp_path, data_dir, flag):
    with pytest.raises(NotImplementedError, match=flag.split("=")[0]):
        M.main([*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/m/",
                "--device=cpu", flag])


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
