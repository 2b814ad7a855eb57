"""The port's host input as a whole against the JAX package's, on the CPU.

Readers, shuffled, at the sizes where the port's earlier readers and the
JAX package's parted ways: 300 Ali-CCP lines at B=64 (the port permuted
65,536-line chunks where JAX shuffles a window of --shuffle_buffer
lines), and 200,000 libsvm lines at B=4096 (the port permuted 65,536-line
chunks where JAX's native path permutes each 16 MiB blob); the native
and plain paths of each reader; --multi_hot_pad=0 (auto_multi_hot_pad).

The slice end to end: ``tf_repos_tpu_torch.main`` and
``tf_repos_tpu.main`` train on the same files from the same weights (the
JAX init converted by utils/convert.params_from_jax into a step-0
checkpoint of the port), f32 towers, shuffle on, --map_workers=2,
--packed_cache=true, two epochs (the second reads the cache): ESMM with
--mh_coo --mh_coo_combine --multi_hot_pad=0, and DeepFM on the lazy
sparse step. Batches are held bit-exact; per-step losses (metrics.jsonl,
--log_steps=1) to 2e-5 relative, the final eval's loss likewise and its
AUCs to 1e-5 absolute."""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from tf_repos_tpu import main as JAX_CLI
from tf_repos_tpu.data import libsvm as JL
from tf_repos_tpu.data import ragged as JR
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu_torch import main as CLI
from tf_repos_tpu_torch.config import parse_config
from tf_repos_tpu_torch.data import libsvm as TL
from tf_repos_tpu_torch.data import ragged as TR
from tf_repos_tpu_torch.data.synthetic import (
    PUBLISHED_MH_AVG_LENS,
    write_synthetic_aliccp,
    write_synthetic_libsvm,
)
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


# ---------------------------------------------------------------- readers
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "plain"])
def test_shuffled_aliccp_batches_match_jax(tmp_path, use_native):
    path = str(tmp_path / "tr.samples.txt")
    write_synthetic_aliccp(path, 300, feature_size=2000, seed=5)
    kw = dict(batch_size=64, multi_hot_pad=16, seed=3)
    _same(list(TR.AliccpDataset([path], use_native=use_native, **kw)),
          list(JR.AliccpDataset([path], **kw)))
    kw.update(perform_shuffle=True, num_epochs=2)
    got = list(TR.AliccpDataset([path], use_native=use_native, **kw))
    assert len(got) == 10
    _same(got, list(JR.AliccpDataset([path], **kw)))


def test_shuffled_libsvm_batches_match_jax_past_one_chunk(tmp_path):
    """200,000 short lines: more than the 65,536-line chunks the port's
    earlier reader permuted, one 16 MiB blob of the native path."""
    path = str(tmp_path / "tr.libsvm")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1000, size=(200_000, 2))
    with open(path, "w") as f:
        f.write("".join(f"{i % 2} {a}:0.5 {b}:1\n" for i, (a, b) in enumerate(ids.tolist())))
    kw = dict(field_size=2, batch_size=4096, perform_shuffle=True, seed=3)
    got = list(TL.LibsvmDataset([path], **kw))
    assert len(got) == 49
    _same(got, list(JL.LibsvmDataset([path], **kw)))
    # the plain path: the window shuffle, on the same random stream
    plain = list(TL.LibsvmDataset([path], use_native=False, **kw))
    _same(plain, list(JL.LibsvmDataset([path], use_native=False, **kw)))


@pytest.mark.parametrize("workers", [1, 3])
def test_libsvm_blobs_on_the_parse_pool_match_jax(tmp_path, workers):
    """Several files (a blob each) over two epochs, parsed on 1 and 3
    threads: the parse pool yields in stream order; blobs_for_file cuts
    line-aligned blobs."""
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"tr{i}.libsvm"))
        write_synthetic_libsvm(paths[-1], 150 + 37 * i, feature_size=700, seed=i, zipf_a=1.2)
    kw = dict(field_size=39, batch_size=64, num_epochs=2, perform_shuffle=True, seed=11)
    _same(list(TL.LibsvmDataset(paths, parse_workers=workers, **kw)),
          list(JL.LibsvmDataset(paths, parse_workers=workers, **kw)))
    kw.update(perform_shuffle=False)
    _same(list(TL.LibsvmDataset(paths, parse_workers=workers, **kw)),
          list(JL.LibsvmDataset(paths, parse_workers=workers, **kw)))
    text = open(paths[0], "rb").read()
    blobs = list(TL.blobs_for_file(paths[0], 1000))
    assert b"".join(blobs) == text and len(blobs) > 10
    assert all(b.endswith(b"\n") for b in blobs)


def test_auto_multi_hot_pad_matches_jax(tmp_path):
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    write_synthetic_aliccp(a, 200, feature_size=500, multi_hot=5, seed=0)
    lens = {k: v / 10 for k, v in PUBLISHED_MH_AVG_LENS.items()}
    write_synthetic_aliccp(b, 300, feature_size=5000, seed=1, mh_avg_lens=lens, zipf_a=1.2)
    assert TR.auto_multi_hot_pad([a]) == JR.auto_multi_hot_pad([a]) == 8
    for files in ([b], [a, b], [b, a]):
        for n in (50, 2000):
            assert TR.auto_multi_hot_pad(files, sample_lines=n) == JR.auto_multi_hot_pad(files, n)
    assert TR.auto_multi_hot_pad([b]) > 8
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").close()
    assert TR.auto_multi_hot_pad([empty]) == 64
    ds = TR.AliccpDataset([b], batch_size=16, multi_hot_pad=0)
    assert ds.multi_hot_pad == JR.AliccpDataset([b], batch_size=16, multi_hot_pad=0).multi_hot_pad
    assert next(iter(ds))["u_shopids"].shape == (16, ds.multi_hot_pad)


# ------------------------------------------------------- the slice, end to end
ESMM_FLAGS = [
    "--model=ESMM", "--feature_size=700", "--field_size=11", "--embedding_size=4",
    "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=16", "--learning_rate=0.01",
    "--sparse_table_update=true", "--fused_table=true", "--mh_coo=true", "--mh_coo_combine=true",
    "--multi_hot_pad=0", "--mh_coo_floor=4096", "--sparse_pad_mode=pow2:700",
]
DEEPFM_FLAGS = [
    "--model=DeepFM", "--feature_size=500", "--field_size=39", "--embedding_size=4",
    "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--learning_rate=0.01",
    "--sparse_table_update=true", "--fused_table=true", "--static_fields=13",
    "--sparse_pad_mode=pow2:500",
]


def _train_losses(model_dir):
    recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    return [(r["step"], r["loss"]) for r in recs if r["kind"] == "train"]


@pytest.mark.parametrize("model", ["ESMM", "DeepFM"])
def test_cli_trajectory_matches_jax(tmp_path, model):
    src = tmp_path / "src"
    src.mkdir()
    if model == "ESMM":
        lens = {k: v / 25 for k, v in PUBLISHED_MH_AVG_LENS.items()}
        write_synthetic_aliccp(str(src / "tr.samples.txt"), 88, feature_size=700, seed=1,
                               mh_avg_lens=lens, zipf_a=1.2)
        write_synthetic_aliccp(str(src / "va.samples.txt"), 48, feature_size=700, seed=2,
                               mh_avg_lens=lens, zipf_a=1.2)
        flags, steps = ESMM_FLAGS, 11  # 2 x 88 lines at B=16 (the remainder carries over)
    else:
        write_synthetic_libsvm(str(src / "tr.libsvm"), 150, feature_size=500, seed=1, zipf_a=1.2)
        write_synthetic_libsvm(str(src / "va.libsvm"), 64, feature_size=500, seed=2, zipf_a=1.2)
        flags, steps = DEEPFM_FLAGS, 10
    # each package reads its own copy (same bytes and mtimes), so each
    # writes its own packed cache in epoch 1 and reads it in epoch 2
    dirs = {}
    for who in ("jax", "port"):
        shutil.copytree(src, tmp_path / f"data_{who}", copy_function=shutil.copy2)
        dirs[who] = tmp_path / f"data_{who}"
    common = [*flags, "--task_type=train", "--num_epochs=2", "--log_steps=1",
              "--eval_throttle_secs=0", "--map_workers=2", "--packed_cache=true",
              "--compute_dtype=float32", "--seed=5", "--dt_dir=x"]
    jargv = [*common, f"--data_dir={dirs['jax']}", f"--model_dir={tmp_path}/jm/"]
    targv = [*common, f"--data_dir={dirs['port']}", f"--model_dir={tmp_path}/tm/", "--device=cpu"]
    # the port starts from the JAX package's init: a step-0 checkpoint
    cfg = parse_config(targv)
    jcfg = JaxConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
    jp, js = jax_create_model(jcfg).init(jax.random.PRNGKey(jcfg.seed))
    h = Harness(cfg)
    state = h.init_train_state()
    tp, tm = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    for dst, s in zip(tree_leaves(state["params"]), tree_leaves(tp)):
        dst.copy_(s)
    state["mstate"] = tm
    CheckpointManager(h.model_dir).save(0, state)

    want = JAX_CLI.main(jargv)
    got = CLI.main(targv)
    # each wrote its caches (tr, va) under the same names: the same tags
    metas = {who: sorted(f for f in os.listdir(dirs[who] / ".packed_cache") if f.endswith(".meta.json"))
             for who in dirs}
    assert metas["port"] == metas["jax"] and [m.split(".")[0] for m in metas["port"]] == ["tr", "va"]
    jl, tl = _train_losses(f"{tmp_path}/jm/x"), _train_losses(f"{tmp_path}/tm/x")
    assert [s for s, _ in tl] == [s for s, _ in jl] == list(range(1, steps + 1))
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl], rtol=2e-5)
    assert got["step"] == want["step"] == steps
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    for k in want:
        if "AUC" in k or k == "auc":
            np.testing.assert_allclose(got[k], want[k], atol=1e-5)
