"""The port's mesh (parallel/mesh.py, parallel/launch.py) and its sharded
lookup (ops/embedding.py) against the JAX package's: the rank layout
r = d * model + m and its groups, pad_vocab, the masked lookup summed
over "model" and its gradient (the identity backward of the all-reduce:
the table gradient is not scaled by the model-axis size), the CLI's
mesh rule and backend rule, and the CLI on a 2x2 gloo mesh
(--device=cpu --mesh_data=2 --mesh_model=2) through train, infer,
export and eval_loop with the chief alone writing."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tf_repos_tpu.ops.embedding import make_sharded_lookup as jax_sharded_lookup
from tf_repos_tpu.ops.embedding import pad_vocab as jax_pad_vocab
from tf_repos_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tf_repos_tpu_torch import main as M
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.synthetic import write_synthetic_libsvm
from tf_repos_tpu_torch.ops.embedding import pad_vocab
from tf_repos_tpu_torch.parallel.mesh import choose_backend
from tf_repos_tpu_torch.train.harness import mesh_shape
from test_torch_mesh_ranks import rank_layout, rank_lookup, shared, spawn


def test_pad_vocab_matches_jax():
    for v in (1, 7, 8, 100, 301, 1000, 117581, 4_500_001):
        for n in (1, 2, 3, 4, 8):
            assert pad_vocab(v, n) == jax_pad_vocab(v, n)
            assert pad_vocab(v, n) % (8 * n) == 0 and pad_vocab(v, n) >= v


def test_rank_layout_and_groups():
    """Rank r sits at (r // model, r % model), JAX's reshape(data, model)
    order; the data group of r holds the ranks of its column m, the
    model group those of its row d."""
    rows = spawn(rank_layout, mesh=(2, 2))
    mine, table = rows[0], rows[1:]
    assert mine[:4] == (0, 0, 0, "gloo")
    jmesh = jax_make_mesh(data=2, model=2)
    order = [[int(d.id) for d in row] for row in jmesh.devices]
    for r, d, m, _, data_sum, model_sum in table:
        r, d, m = int(r), int(d), int(m)
        assert (d, m) == (r // 2, r % 2) and order[d][m] == order[0][0] + r
        assert data_sum == sum(dd * 2 + m + 1 for dd in range(2))
        assert model_sum == sum(d * 2 + mm + 1 for mm in range(2))


@pytest.mark.parametrize("model", [2, 3])
def test_sharded_lookup_and_grad_match_jax(model):
    """Forward and table gradient of the masked lookup on a (1, M) mesh:
    ids in every shard, the sentinel V (a zero padding row) and ids past
    the padded vocab (read as zeros)."""
    v, k = 37, 5
    vp = pad_vocab(v, model)
    rng = np.random.default_rng(0)
    table = np.zeros((vp, k), np.float32)
    table[:v] = rng.normal(size=(v, k))
    ids = rng.integers(0, v, size=(6, 4)).astype(np.int32)
    ids[0, 0], ids[1, 1], ids[2, 2] = v, vp + 3, 0
    cot = rng.normal(size=(6, 4, k)).astype(np.float32)

    mesh = jax_make_mesh(data=1, model=model)
    look = jax_sharded_lookup("model")
    f = shard_map(lambda t, i: look(t, i), mesh=mesh, in_specs=(P("model", None), P()),
                  out_specs=P(), check_vma=True)
    want = np.asarray(f(jnp.asarray(table), jnp.asarray(ids)))
    want_g = np.asarray(jax.grad(lambda t: jnp.sum(f(t, jnp.asarray(ids)) * cot))(jnp.asarray(table)))

    out, g = spawn(rank_lookup, table, ids, cot, mesh=(1, model))
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g, want_g, rtol=1e-6, atol=1e-6)
    assert np.all(out[1, 1] == 0)


def test_mesh_rule_follows_jax():
    """No mesh at --mesh_data=1 --mesh_model<=1 or by default on the CPU;
    every requested position a process on --device=cpu."""
    cpu = dict(device="cpu")
    assert mesh_shape(Config(**cpu)) is None
    assert mesh_shape(Config(mesh_data=1, mesh_model=1, **cpu)) is None
    assert mesh_shape(Config(mesh_data=2, **cpu)) == (2, 1)
    assert mesh_shape(Config(mesh_model=2, **cpu)) == (1, 2)
    assert mesh_shape(Config(mesh_data=2, mesh_model=2, **cpu)) == (2, 2)


def test_backend_rule():
    """NCCL only when every rank has a card of its own; gloo on the CPU
    and for ranks that share a card."""
    assert choose_backend(["cpu"] * 4) == "gloo"
    assert choose_backend(["cuda:0"] * 4) == "gloo"
    assert choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert choose_backend(["cuda:0"]) == "nccl"
    with pytest.raises(ValueError):
        choose_backend(["meta"])


FLAGS = ["--model=DeepFM", "--feature_size=401", "--field_size=39", "--embedding_size=4",
         "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--num_epochs=1",
         "--log_steps=2", "--dt_dir=x", "--eval_throttle_secs=0", "--learning_rate=0.01",
         "--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true",
         "--static_fields=13", "--device=cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One-process and 2x2-mesh train runs of the CLI on the same files
    and seed, once a session: (data dir, one-process argv, mesh argv,
    their results, the mesh run's stdout)."""
    return shared(tmp_path_factory, "cli", lambda: _trained(tmp_path_factory.mktemp("cli")))


def _trained(tmp):
    import contextlib
    import io

    d = tmp / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 160, feature_size=400, seed=0)
    write_synthetic_libsvm(str(d / "va.libsvm"), 64, feature_size=400, seed=1)
    write_synthetic_libsvm(str(d / "te.libsvm"), 40, feature_size=400, seed=2)
    one = [*FLAGS, f"--data_dir={d}", f"--model_dir={tmp}/one/"]
    mesh = [*FLAGS, f"--data_dir={d}", f"--model_dir={tmp}/mesh/", "--mesh_data=2",
            "--mesh_model=2"]
    ref = M.main(["--task_type=train", *one])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = M.main(["--task_type=train", *mesh])
    return d, one, mesh, ref, res, out.getvalue()


def test_cli_2x2_mesh_trains_as_one_process(trained):
    """Four gloo ranks: losses and eval equal to the one-process run's on
    the same seed and files; the chief alone writes the metrics, one
    TensorBoard file and the checkpoint."""
    d, _, mesh, ref, res, out = trained
    assert "INFO: mesh 2x2 on gloo" in out
    assert res["step"] == ref["step"] == 5
    for k in ("loss", "auc"):
        assert res[k] == pytest.approx(ref[k], rel=2e-5, abs=1e-6)
    mdir = d.parent / "mesh" / "x"
    with open(mdir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["kind"] for r in recs] == ["train", "train", "final"]
    assert len([f for f in os.listdir(mdir) if f.startswith("events.out.tfevents")]) == 1
    assert sorted(f for f in os.listdir(mdir) if f.startswith("ckpt-")) == ["ckpt-5.pt"]


def test_cli_2x2_mesh_infers_in_global_order(trained):
    """pred.txt of the 2x2 mesh (the sharded predict step, the chief
    writing) equals the one-process infer's."""
    d, one, mesh, _, _, _ = trained
    pred_path = M.main(["--task_type=infer", *mesh])
    got = np.loadtxt(pred_path)
    M.main(["--task_type=infer", *one])
    assert got.shape == (40,)
    np.testing.assert_allclose(got, np.loadtxt(str(d / "pred.txt")), atol=2e-6)


def test_cli_2x2_mesh_exports_the_single_device_servable(trained):
    d, _, mesh, _, _, _ = trained
    from tf_repos_tpu_torch.serve.export import load_servable

    # on a 1x2 mesh: any mesh exports the checkpoint's single-device state
    path = M.main(["--task_type=export", *mesh, "--mesh_data=1"])
    assert os.path.isdir(path) and len(os.listdir(d.parent / "mesh" / "x" / "servable")) == 1
    # the unpadded single-device table (401 rows, not the mesh's 416)
    _, params, _, _ = load_servable(path, device="cpu")
    assert tuple(params["fm_wv"].shape) == (401, 5)


def test_cli_2x2_mesh_evaluates(trained):
    """The evaluator on a 2x1 mesh polls on the chief's clock and
    evaluates the newest checkpoint once, the chief writing its metrics;
    eval equals the 2x2 train run's final eval."""
    d, _, mesh, _, res, _ = trained
    loop = M.main(["--task_type=eval_loop", "--eval_loop_secs=1", "--eval_loop_timeout=2", *mesh,
                   "--mesh_model=1"])
    assert loop["step"] == 5 and loop["loss"] == pytest.approx(res["loss"], rel=1e-6)
    assert loop["auc"] == pytest.approx(res["auc"], rel=1e-6)
    with open(d.parent / "mesh" / "x" / "eval_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["step"], r["kind"]) for r in recs] == [(5, "eval")]
