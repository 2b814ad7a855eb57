"""The port's feature tools (tf_repos_tpu_torch/features/) and Criteo
surrogate (data/criteo_surrogate.py) against the JAX package's on the
same inputs: every output held byte-equal (the Criteo preprocessor with
one and two workers, the Ali-CCP pipeline and its streaming stages, the
"smart" round trip, the feature statistics, the Frappe label fix, the
surrogate's raw lines for one seed), the surrogate's field targets,
calibration and Bayes ceiling equal; and the port's exact_auc against
the JAX package's (1e-12 on unit and 0/1 weights, whose sums float32
holds exactly; 1e-6 on real-valued weights, float32 summation order)."""

import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.data import criteo_surrogate as JCS
from tf_repos_tpu.features import aliccp as JA
from tf_repos_tpu.features import criteo as JC
from tf_repos_tpu.features import frappe as JF
from tf_repos_tpu.features import smart as JSM
from tf_repos_tpu.features import stats as JST
from tf_repos_tpu.ops import metrics as JM
from tf_repos_tpu_torch.data import criteo_surrogate as CS
from tf_repos_tpu_torch.features import aliccp as A
from tf_repos_tpu_torch.features import criteo as C
from tf_repos_tpu_torch.features import frappe as F
from tf_repos_tpu_torch.features import smart as SM
from tf_repos_tpu_torch.features import stats as ST
from tf_repos_tpu_torch.ops import metrics as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the surrogate's label calibration at a small probe (the default probe
# takes half a minute); both modules cache it
PROBE = 20_000


@pytest.fixture(scope="module", autouse=True)
def small_calibration():
    JCS.calibration(probe=PROBE)
    CS.calibration(probe=PROBE)
    yield
    for mod in (JCS, CS):
        mod._CAL = None
        mod._FIELDS = None


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.fixture(scope="module")
def criteo_raw(tmp_path_factory):
    raw = tmp_path_factory.mktemp("criteo_raw")
    CS.generate_raw(str(raw / "train.txt"), 3000, seed=3)
    CS.generate_raw(str(raw / "test.txt"), 500, seed=4)
    return raw


@pytest.mark.parametrize("workers", [1, 2])
def test_criteo_preprocess_bytes_equal_jax(tmp_path, criteo_raw, workers):
    got = C.preprocess(str(criteo_raw), str(tmp_path / "port"), cutoff=2, workers=workers)
    want = JC.preprocess(str(criteo_raw), str(tmp_path / "jax"), cutoff=2, workers=workers)
    assert got == want
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert (C.field_blocks_from_feature_map(str(tmp_path / "port" / "feature_map"))
            == JC.field_blocks_from_feature_map(str(tmp_path / "jax" / "feature_map")))


def test_criteo_cli_bytes_equal_jax(tmp_path, criteo_raw):
    r = subprocess.run([sys.executable, "-m", "tf_repos_tpu_torch.features.criteo",
                        "--input_dir", str(criteo_raw), "--output_dir", str(tmp_path / "port"),
                        "--cutoff", "2", "--workers", "2"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    info = JC.preprocess(str(criteo_raw), str(tmp_path / "jax"), cutoff=2)
    assert r.stdout.strip() == f"feature_size {info['feature_size']} field_size 39"
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert (C.NUM_CONTINUOUS, C.NUM_CATEGORICAL, C.CONTINUOUS_CLIP) == (
        JC.NUM_CONTINUOUS, JC.NUM_CATEGORICAL, JC.CONTINUOUS_CLIP)


def _aliccp_raw(tmp_path, n=60, seed=0):
    rng = random.Random(seed)
    skel, comm = [], []
    for ci in range(5):
        feats = "\x01".join(f"109_14\x02{rng.randint(100, 110)}\x031.0" for _ in range(3))
        comm.append(f"c{ci},3,{feats}")
    for si in range(n):
        feats = "\x01".join([f"205\x02{rng.randint(1, 5)}\x031.0",
                             f"206\x02{rng.randint(6, 9)}\x030.5"])
        skel.append(f"s{si},{rng.randint(0, 1)},{rng.randint(0, 1)},c{si % 5},2,{feats}")
    (tmp_path / "skeleton.csv").write_text("\n".join(skel) + "\n")
    (tmp_path / "common.csv").write_text("\n".join(comm) + "\n")


def test_aliccp_pipeline_and_stages_bytes_equal_jax(tmp_path):
    _aliccp_raw(tmp_path)
    args = (str(tmp_path / "skeleton.csv"), str(tmp_path / "common.csv"))
    got = A.run_pipeline(*args, str(tmp_path / "port"), cutoff=1, seed=0, threads=2)
    want = JA.run_pipeline(*args, str(tmp_path / "jax"), cutoff=1, seed=0, threads=2)
    assert got == want
    _same_tree(tmp_path / "port", tmp_path / "jax")
    # the streaming stages, in process and one through the port's CLI
    raw = ((tmp_path / "skeleton.csv").read_text() + (tmp_path / "common.csv").read_text())
    lines = raw.splitlines(keepends=True)
    joined = list(A.join_reduce(sorted(A.join_map(lines))))
    assert joined == list(JA.join_reduce(sorted(JA.join_map(lines))))
    counts = list(A.stat_reduce(sorted(A.stat_map(joined))))
    assert counts == list(JA.stat_reduce(sorted(JA.stat_map(joined))))
    assert A.load_remap(counts, cutoff=1) == JA.load_remap(counts, cutoff=1)
    keyed = sorted(A.remap_map(joined, A.load_remap(counts, cutoff=1), random.Random(0)))
    assert keyed == sorted(JA.remap_map(joined, JA.load_remap(counts, cutoff=1), random.Random(0)))
    assert list(A.shuffle_reduce(keyed)) == list(JA.shuffle_reduce(keyed))
    r = subprocess.run([sys.executable, "-m", "tf_repos_tpu_torch.features.aliccp",
                        "--mode", "join_map"], input=raw, cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "".join(line + "\n" for line in JA.join_map(lines))


def test_smart_round_trip_bytes_equal_jax(tmp_path):
    n_cols = len(SM.CSV_COLUMNS)
    assert SM.CSV_COLUMNS == JSM.CSV_COLUMNS
    rows = []
    for i in range(12):
        row = ["1" if i % 2 else "0"]
        for j in range(1, n_cols):
            row.append(f"{0.01 * j * (i + 1):.4f}" if SM._is_continuous(j) else f"cat{(i + j) % 3}")
        rows.append(",".join(row))
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "part-0").write_text("\n".join(rows[:6]) + "\n")
    (raw / "part-1").write_text("\n".join(rows[6:]) + "\n")
    for task in ("tr", "te"):
        got = SM.run(str(raw), str(tmp_path / "port"), task_type=task, threads=2)
        want = JSM.run(str(raw), str(tmp_path / "jax"), task_type=task, threads=2)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        (raw / "part-0").write_text(rows[0].replace("cat1", "NEW") + "\n")
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_stats_and_frappe_equal_jax(tmp_path, capsys):
    lib = tmp_path / "tr.libsvm"
    lib.write_text("-1 1:1 2:1 7:0.5\n1 3:1 2:1\nbad\n0 7:1\n")
    for fmt, glob_ in (("libsvm", str(lib)),):
        got = ST.main(["--input_glob", glob_, "--format", fmt])
        out_port = capsys.readouterr().out
        want = JST.main(["--input_glob", glob_, "--format", fmt])
        assert got == want and out_port == capsys.readouterr().out
    ali = ["s0,1,0,205:21:1.0 206:22:1.0 205:21:1.0", "s1,0,0,206:23:1.0"]
    assert ST.feat_counts_aliccp(ali) == JST.feat_counts_aliccp(ali)
    port_out = F.fix_file(str(lib))
    port_bytes = open(port_out, "rb").read()
    os.remove(port_out)
    jax_out = JF.fix_file(str(lib))
    assert port_out == jax_out and port_bytes == open(jax_out, "rb").read()


def test_surrogate_raw_lines_and_calibration_equal_jax(tmp_path):
    assert CS.field_targets() == JCS.field_targets()
    assert CS.calibration(probe=PROBE) == JCS.calibration(probe=PROBE)
    assert CS.scaled_cutoff(1_000_000) == JCS.scaled_cutoff(1_000_000)
    got = CS.generate_raw(str(tmp_path / "port.txt"), 2500, seed=11, chunk=1000)
    want = JCS.generate_raw(str(tmp_path / "jax.txt"), 2500, seed=11, chunk=1000)
    assert got == want
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert CS.bayes_ceiling(n_probe=20_000) == JCS.bayes_ceiling(n_probe=20_000)


def _aucs(labels, preds, weights):
    got = float(M.exact_auc(torch.from_numpy(labels), torch.from_numpy(preds),
                            None if weights is None else torch.from_numpy(weights)))
    want = float(JM.exact_auc(jnp.asarray(labels), jnp.asarray(preds),
                              None if weights is None else jnp.asarray(weights)))
    return got, want


@pytest.mark.parametrize("weights", ["none", "mask", "real"])
def test_exact_auc_matches_jax(weights):
    rng = np.random.default_rng(5)
    n = 997
    labels = (rng.random(n) < 0.3).astype(np.float32)
    # ties: predictions on a coarse grid
    preds = (np.round(rng.random(n) * 50) / 50).astype(np.float32)
    w = {"none": None, "mask": (rng.random(n) < 0.9).astype(np.float32),
         "real": rng.random(n).astype(np.float32)}[weights]
    got, want = _aucs(labels, preds, w)
    assert got == pytest.approx(want, rel=1e-6 if weights == "real" else 1e-12, abs=0)
    assert 0.3 < got < 0.7
