"""The port's sharded lazy step (parallel/sparse_step.py) on gloo CPU
ranks against the JAX package's build_sharded_sparse_train_step on the
8-virtual-device rig, from the same JAX mesh state (params and row
stores padded by pad_vocab, converted into each rank's shard) on the same
mapped batches: DeepFM on the fused w|m|v store under lazy Adam with the
row kernels' plain versions as the inner lookup, the same with
--dma_scatter and --sparse_catchup, DeepFM's unfused table under lazy GD,
and ESMM --mh_coo with --dma_scatter
(K3/K4's and K7's plain versions). The JAX side runs XLA's gather and COO
pool (its Pallas kernels in interpret mode take minutes on a 4-device
mesh; tests/test_torch_sparse_step.py holds the plain versions to them). Losses to rtol 2e-4 /
atol 2e-5, stores to rtol 2e-3 / atol 2e-5, padding rows exactly 0.
Also: the port's COO packer with a data-shard axis equals the JAX
package's."""

import jax
import numpy as np
import pytest

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data.sparse_batch import MhCooPacker as JaxPacker
from tf_repos_tpu.data.sparse_batch import SparseBatchMapper as JaxMapper
from tf_repos_tpu.data.synthetic import synthetic_aliccp_batch
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.parallel.mesh import make_mesh
from tf_repos_tpu.parallel.sparse_step import ShardedSparseState, build_sharded_sparse_train_step
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch.data.sparse_batch import MhCooPacker
from test_torch_mesh_ranks import rank_jobs, shared, spawn

DEEPFM = dict(model="DeepFM", feature_size=301, field_size=10, embedding_size=4,
              deep_layers="16,8", dropout="1.0,1.0", batch_size=32, l2_reg=1e-4,
              learning_rate=1e-2, optimizer="Adam", sparse_table_update=True, fused_table=True,
              static_fields=3)
ESMM = dict(model="ESMM", feature_size=400, field_size=11, embedding_size=4, deep_layers="8,4",
            dropout="1.0,1.0", batch_size=16, l2_reg=1e-4, learning_rate=1e-2, optimizer="Adam",
            multi_hot_pad=4, sparse_table_update=True, fused_table=True, mh_coo=True,
            dma_scatter=True)
CASES = {
    "deepfm_fused": (DEEPFM, (2, 2)),
    "deepfm_dma_catchup": (dict(DEEPFM, dma_scatter=True, sparse_catchup=True), (1, 2)),
    "esmm_coo_dma": (ESMM, (2, 2)),
    # GD's update is linear in the gradient (Adam's is not), so a row or
    # dense gradient summed over the wrong group moves the stores here.
    "deepfm_gd": (dict(DEEPFM, optimizer="GD", learning_rate=0.1, fused_table=False), (2, 2)),
}
STEPS = 3


def _deepfm_batches(kw):
    rng = np.random.default_rng(3)
    b, f, v = kw["batch_size"], kw["field_size"], kw["feature_size"]
    out = []
    for _ in range(STEPS):
        z = np.minimum(rng.zipf(1.2, size=(b, f)), v - 1).astype(np.int32)
        z[:, :3] = np.arange(1, 4)
        out.append({"feat_ids": z, "feat_vals": rng.random((b, f)).astype(np.float32),
                    "label": (rng.random(b) < 0.5).astype(np.float32),
                    "mask": np.ones(b, np.float32)})
    return out


def jax_sparse_run(kw, mesh_shape):
    cfg = JaxConfig(**kw)
    model = jax_create_model(cfg)
    tx = jax_make_optimizer(cfg.optimizer, cfg.learning_rate)
    sopt = JSP.make_sparse_row_optimizer(cfg.optimizer, cfg.learning_rate, sorted_indices=False,
                                         fused_table=cfg.fused_table, catchup=cfg.sparse_catchup,
                                         dma_scatter=cfg.dma_scatter)
    mesh = make_mesh(data=mesh_shape[0], model=mesh_shape[1])
    st = ShardedSparseState(model, tx, sopt, mesh)
    state, specs = st.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    mapper = JaxMapper(model.sparse_slots())
    if cfg.mh_coo:
        packer = JaxPacker(model.mh_coo_groups(), n_data=mesh_shape[0], floor=8, cdest_aux=False)
        raw = [synthetic_aliccp_batch(np.random.default_rng(i), cfg.batch_size, cfg.feature_size,
                                      multi_hot_pad=cfg.multi_hot_pad) for i in range(STEPS)]
        mapped = [mapper(packer(dict(b))) for b in raw]
    else:
        mapped = [mapper(dict(b)) for b in _deepfm_batches(kw)]
    step = build_sharded_sparse_train_step(model, tx, sopt, mesh, specs)
    losses = []
    for i, b in enumerate(mapped):
        state, loss = step(state, st.place_batch(b), jax.random.PRNGKey(100 + i))
        losses.append(float(loss))
    return init, mapped, losses, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    return shared(tmp_path_factory, f"sparse-{request.param}", lambda: _case(request.param))


def _case(name):
    kw, mesh_shape = CASES[name]
    init, mapped, losses, state = jax_sparse_run(kw, mesh_shape)
    (got,) = spawn(rank_jobs, [("rank_sparse", (kw, init["params"], init["mstate"],
                                                init["opt_state"]["sparse"], mapped))],
                   mesh=mesh_shape)
    return kw, losses, state, got


def test_sharded_sparse_loss_matches_jax(case):
    _, losses, _, got = case
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-4, atol=2e-5)


def test_sharded_sparse_stores_match_jax(case):
    """Every row store whole and padded, JAX's shard layout row for row;
    the rows past the vocab (and the lanes past 3K) exactly 0. An unfused
    optimizer's table is the port's store ``w`` and JAX's param."""
    kw, _, state, got = case
    v = kw["feature_size"]
    for t, aux in state["opt_state"]["sparse"].items():
        if "wmv" not in aux:
            aux = dict(aux, w=state["params"][t])
        for name, want in aux.items():
            if np.ndim(want) == 0:
                continue
            have = got["stores"][f"{t}/{name}"]
            assert have.shape == np.shape(want), name
            np.testing.assert_allclose(have[:v], np.asarray(want)[:v], rtol=2e-3, atol=2e-5,
                                       err_msg=name)
            assert np.all(have[v:] == 0), name


def test_sharded_sparse_dense_params_match_jax(case):
    kw, _, state, got = case
    for k, v in got["params"].items():
        for a, b in zip(jax.tree.leaves(state["params"][k]), jax.tree.leaves(v)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=2e-3, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("n_data", [1, 2, 4])
@pytest.mark.parametrize("combine", [False, True])
def test_coo_packer_data_shards_match_jax(n_data, combine):
    """The port's packer with n_data shards: every array equal to the JAX
    package's (idx, dest local to the shard's rows, w, counts, the
    compact segment and idx-sorted streams)."""
    jm = jax_create_model(JaxConfig(**ESMM))
    groups = jm.mh_coo_groups()
    b = synthetic_aliccp_batch(np.random.default_rng(5), 16, 400, multi_hot_pad=6)
    want = JaxPacker(groups, n_data=n_data, floor=8, combine=combine, cdest_aux=True,
                     sorted_aux=True)(dict(b))
    got = MhCooPacker(groups, floor=8, combine=combine, cdest_aux=True, sorted_aux=True,
                      use_native=False, n_data=n_data)(dict(b))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_bf16_rounding_on_a_model_mesh_equals_one_device():
    """--param_dtype=bfloat16 on the fused store, 1x2 mesh: every rank
    draws the whole [S, 3K] noise from a generator seeded alike and keeps
    its own rows, so the shards hold, bit for bit, what one device's
    store holds after the same steps (with no data axis the rows and
    their gradients are the same numbers on both)."""
    import torch

    from tf_repos_tpu_torch.config import Config
    from tf_repos_tpu_torch.data.sparse_batch import SparseBatchMapper
    from tf_repos_tpu_torch.models import create_model
    from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
    from tf_repos_tpu_torch.train import sparse as SP
    from tf_repos_tpu_torch.train.optimizers import make_optimizer
    from test_torch_mesh_ranks import rank_port_sparse

    kw = dict(DEEPFM, param_dtype="bfloat16")
    cfg = Config(**kw)
    model = create_model(cfg)
    mapper = SparseBatchMapper(model.sparse_slots())
    batches = [mapper(dict(b)) for b in _deepfm_batches(kw)]
    got = spawn(rank_port_sparse, kw, batches, mesh=(1, 2))

    tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
    sopt = SP.make_sparse_row_optimizer(cfg.optimizer, cfg.learning_rate, fused_table=True)
    params, mstate = model.init(torch.Generator().manual_seed(9))
    params = SP.cast_tables(model, params, torch.bfloat16)
    opt = SP.init_opt_state(model, tx, sopt, params)
    step = SP.build_sparse_train_step(model, tx, sopt, lookup=make_expand_lookup())
    sr = torch.Generator().manual_seed(5)
    losses = []
    for b in batches:
        b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
        params, opt, mstate, loss = step(params, opt, mstate, b, None, sr)
        losses.append(float(loss))
    assert got["losses"] == losses
    want = opt["sparse"]["fm_wv"]["wmv"].view(torch.int16).numpy()
    np.testing.assert_array_equal(got["store_bits"], want)
