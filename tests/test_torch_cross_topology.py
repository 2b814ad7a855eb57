"""Cross-topology checkpoints (the port's counterpart of
tests/test_cross_topology.py): a checkpoint written under a (2, 2) mesh
holds the single-device state, assembled from the shards and unpadded;
it restores exactly under one device and under a (1, 2) mesh (whose
shards assemble back to it bit for bit), the one device's eval equals
the mesh's final eval, and training goes on under the other mesh. For
the dense step, the lazy step with --fused_moments, and the fused w|m|v
store with --sparse_catchup (its per-row step store shards too)."""

import numpy as np
import pytest
import torch

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.synthetic import write_synthetic_libsvm
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.harness import Harness, run_task
from tf_repos_tpu_torch.utils.tree import tree_leaves
from test_torch_mesh_ranks import rank_restore_then_train, spawn

EXTRAS = {
    "dense": {},
    "sparse_moments": dict(sparse_table_update=True, fused_moments=True),
    "fused_table_catchup": dict(sparse_table_update=True, fused_table=True, sparse_catchup=True,
                                pallas_expand=True),
}


def _kw(tmp_path, mesh, **extra):
    kw = dict(model="DeepFM", feature_size=509, field_size=39, embedding_size=4,
              deep_layers="8,4", dropout="1.0,1.0", batch_size=32, num_epochs=1, log_steps=5,
              learning_rate=0.01, data_dir=str(tmp_path / "data"), model_dir=str(tmp_path / "m"),
              dt_dir="d", eval_throttle_secs=0, seed=7, mesh_data=mesh[0], mesh_model=mesh[1],
              device="cpu")
    kw.update(extra)
    return kw


def _np_leaves(state):
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
            for x in tree_leaves(state)]


@pytest.mark.parametrize("variant", list(EXTRAS))
def test_restore_is_exact_under_every_mesh_and_training_continues(tmp_path, variant):
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 224, feature_size=509, seed=0)
    write_synthetic_libsvm(str(d / "va.libsvm"), 96, feature_size=509, seed=1)
    extra = EXTRAS[variant]
    m1 = run_task(Config(**_kw(tmp_path, (2, 2), **extra)))
    assert m1["step"] == 7

    # one device: the checkpoint is the single-device state (vocab 509,
    # not the mesh's padded 512), and its eval is the mesh's
    h = Harness(Config(**_kw(tmp_path, (1, 1), **extra)))
    ref = h.restore_or_init(CheckpointManager(h.model_dir))
    assert ref["step"] == 7
    for t in h.model.sharded_params():
        assert ref["params"][t].shape[0] == 509
    ev = run_task(Config(**_kw(tmp_path, (1, 1), task_type="eval", **extra)))
    assert ev["loss"] == pytest.approx(m1["loss"], rel=1e-6)
    assert ev["auc"] == pytest.approx(m1["auc"], rel=1e-6)

    # (1, 2): the shards assemble back bit for bit; one more epoch there
    got = spawn(rank_restore_then_train, _kw(tmp_path, (1, 2), **extra), mesh=(1, 2))
    assert got["step"] == 7
    want = _np_leaves({k: ref[k] for k in ("params", "opt_state", "mstate")})
    have = _np_leaves(got["state"])
    assert len(want) == len(have)
    for a, b in zip(want, have):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        else:
            assert a == b
    m2 = got["metrics"]
    assert m2["step"] == 14
    assert np.isfinite(m2["loss"]) and 0.0 <= m2["auc"] <= 1.0
