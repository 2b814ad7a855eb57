"""The port's row expand / row accumulate (tf_repos_tpu_torch/ops/
sparse_rows.py) against the JAX package's Pallas kernels, run in
interpret mode on the CPU as tests/test_pallas_sparse.py runs them.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels are held to those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances: expand is a copy and must be bit-exact;
accumulate sums in another order than the Pallas kernel (index_add_ vs
sequential read-modify-write), so it is held to 1e-5 relative / 1e-5
absolute on unit-normal cotangents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.data.sparse_batch import SparseBatchMapper as JaxMapper
from tf_repos_tpu.data.sparse_batch import quarter_pow2 as jax_quarter_pow2
from tf_repos_tpu.models.base import SparseSlot as JaxSlot
from tf_repos_tpu.ops import pallas_sparse as PS
from tf_repos_tpu.train import sparse as JSP
from tf_repos_tpu_torch.data.sparse_batch import SparseBatchMapper, quarter_pow2
from tf_repos_tpu_torch.models.base import SparseSlot
from tf_repos_tpu_torch.ops import sparse_rows as SR
from tf_repos_tpu_torch.train import sparse as SP


def _zipf_idx(rng, n, s, a=1.3):
    return np.minimum(rng.zipf(a, size=(n,)) - 1, s - 1).astype(np.int32)


@pytest.mark.parametrize(
    "n,s,k,dtype",
    [(1000, 64, 17, "float32"), (300, 40, 5, "float32"), (777, 33, 16, "bfloat16")],
)
def test_expand_plain_matches_pallas(n, s, k, dtype):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((s, k)).astype(np.float32)
    idx = _zipf_idx(rng, n, s)
    want = np.asarray(
        PS.expand_rows(jnp.asarray(table, dtype), jnp.asarray(idx), chunk=256, unroll=8)
    ).astype(np.float32)
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = SR.expand_rows(tt, torch.from_numpy(idx)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,s,k,a,pad", [
    (1000, 64, 17, 1.3, 0), (4096, 512, 16, 1.3, 0), (600, 33, 8, 1.3, 0),
    (3000, 700, 17, 1.2, 0),  # the benchmark's Zipf(1.2) skew
    (2000, 300, 16, 1.2, 1500),  # a zero-cotangent padding block on row 0
])
def test_accumulate_plain_matches_pallas(n, s, k, a, pad):
    rng = np.random.default_rng(1)
    g = np.concatenate([rng.standard_normal((n, k)), np.zeros((pad, k))]).astype(np.float32)
    idx = np.concatenate([_zipf_idx(rng, n, s, a), np.zeros(pad, np.int32)])  # heavy duplication
    want = np.asarray(PS.accumulate_rows(jnp.asarray(g), jnp.asarray(idx), s, chunk=256, unroll=8))
    got = SR.accumulate_rows(torch.from_numpy(g), torch.from_numpy(idx), s).numpy()
    assert got.dtype == np.float32 and got.shape == (s, k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,s,k", [(4096, 500, 16), (1000, 77, 32)])
def test_accumulate_plain_matches_pallas_packed(n, s, k):
    # the lane-packed TPU variant computes the same function
    rng = np.random.default_rng(6)
    g = rng.standard_normal((n, k)).astype(np.float32)
    idx = _zipf_idx(rng, n, s)
    want = np.asarray(
        PS.accumulate_rows_packed(jnp.asarray(g), jnp.asarray(idx), s, chunk=256, unroll=8)
    )
    got = SR.accumulate_rows(torch.from_numpy(g), torch.from_numpy(idx), s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_accumulate_all_duplicates():
    n, s, k = 512, 16, 8
    g = torch.ones((n, k))
    idx = torch.full((n,), 3, dtype=torch.int32)
    got = SR.accumulate_rows(g, idx, s)
    assert float(got[3, 0]) == n and float(got.sum()) == n * k
    want = np.asarray(PS.accumulate_rows(jnp.ones((n, k)), jnp.full((n,), 3, jnp.int32), s,
                                         chunk=128, unroll=8))
    np.testing.assert_array_equal(got.numpy(), want)


def test_lookup_value_and_grad_match_vmem_lookup():
    rng = np.random.default_rng(2)
    s, k, b, f = 64, 9, 32, 7
    rows = rng.standard_normal((s, k)).astype(np.float32)
    ids = rng.integers(0, s, size=(b, f)).astype(np.int32)
    w = rng.standard_normal((f, k)).astype(np.float32)

    jl = PS.make_vmem_expand_lookup(chunk=128, unroll=8)
    v_j, g_j = jax.value_and_grad(lambda r: jnp.sum(jl(r, jnp.asarray(ids)) * w))(jnp.asarray(rows))

    lookup = SR.make_expand_lookup()
    assert lookup.static_slice_ok
    rt = torch.from_numpy(rows).requires_grad_(True)
    out = lookup(rt, torch.from_numpy(ids))
    assert out.shape == (b, f, k)
    v_t = torch.sum(out * torch.from_numpy(w))
    (g_t,) = torch.autograd.grad(v_t, rt)
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_count_launches():
    SR.reset_launches()
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.standard_normal((20, 5)).astype(np.float32)).requires_grad_(True)
    ids = torch.from_numpy(rng.integers(0, 20, size=(6, 4)).astype(np.int32))
    SR.expand_rows(rows.detach(), ids.reshape(-1))
    SR.accumulate_rows(torch.ones(24, 5), ids.reshape(-1), 20)
    lookup = SR.make_expand_lookup()
    torch.autograd.grad(lookup(rows, ids).sum(), rows)
    assert SR.expand_rows.launches == 0 and SR.accumulate_rows.launches == 0


def test_wrappers_refuse_other_devices():
    # no path falls back to the plain version for a non-CPU tensor
    table = torch.empty((8, 4), device="meta")
    idx = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        SR.expand_rows(table, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        SR.accumulate_rows(torch.empty((3, 4), device="meta"), idx, 8)


def test_take_put_rows_sentinel_semantics():
    # JAX: .at[u].get(mode="fill") / .at[u].set(mode="drop"); the port's
    # row store holds a spare zero row V instead
    rng = np.random.default_rng(4)
    v, k = 12, 3
    a = rng.standard_normal((v, k)).astype(np.float32)
    u = np.array([0, 2, 5, 11, v, v], np.int32)  # ascending, sentinel-padded
    new = rng.standard_normal((u.size, k)).astype(np.float32)

    want_take = np.asarray(JSP.take_rows(jnp.asarray(a), jnp.asarray(u)))
    want_put = np.asarray(JSP.put_rows(jnp.asarray(a), jnp.asarray(u), jnp.asarray(new)))

    store = SP.row_store(torch.from_numpy(a))
    assert store.shape == (v + 1, k)
    np.testing.assert_array_equal(SP.take_rows(store, torch.from_numpy(u)).numpy(), want_take)
    SP.put_rows(store, torch.from_numpy(u), torch.from_numpy(new))
    np.testing.assert_array_equal(store[:v].numpy(), want_put)
    assert float(store[v].abs().sum()) == 0.0


@pytest.mark.parametrize("pad_mode", ["pow2", "max", "pow2:64"])
def test_mapper_matches_jax_mapper(pad_mode):
    rng = np.random.default_rng(5)
    vocab, static = 300, 3
    jm = JaxMapper({"fm_wv": JaxSlot(("feat_ids",), vocab, static=static)}, pad_mode=pad_mode)
    tm = SparseBatchMapper({"fm_wv": SparseSlot(("feat_ids",), vocab, static=static)}, pad_mode=pad_mode)
    for n in (16, 64, 40):  # the pow2 bucket grows, then stays
        ids = rng.integers(1, vocab, size=(n, 9)).astype(np.int32)
        ids[:, :static] = np.arange(1, static + 1)
        batch = {"feat_ids": ids, "label": np.zeros(n, np.float32)}
        a, b = jm(dict(batch)), tm(dict(batch))
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_quarter_pow2_matches():
    for m in list(range(0, 70)) + [1000, 30_500, 107_832, 1 << 20]:
        assert quarter_pow2(m) == jax_quarter_pow2(m)
