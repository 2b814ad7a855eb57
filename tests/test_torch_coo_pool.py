"""The port's COO pool and its transpose (tf_repos_tpu_torch/ops/
coo_pool.py) against the JAX package's Pallas kernels, run in interpret
mode on the CPU as tests/test_mh_coo.py runs them.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels are held to those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Both sides sum in another order (index_add_ vs the
Pallas kernel's sequential read-modify-writes), so values are held to
1e-5 relative / 1e-5 absolute on unit-normal inputs, the JAX package's
own bar for these kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.ops import pallas_sparse as PS
from tf_repos_tpu_torch.ops import coo_pool as CP
from tf_repos_tpu_torch.ops import sparse_rows as SR
from tf_repos_tpu_torch.ops.embedding import coo_pool


def _triplet(rng, m, s, g, zipf=False, pad=0):
    """idx, dest, w of m live slots plus ``pad`` padding slots (idx = dest
    = 0, w = 0), as the packer emits them."""
    idx = (np.minimum(rng.zipf(1.3, size=(m,)) - 1, s - 1) if zipf
           else rng.integers(0, s, size=(m,)))
    dest = rng.integers(0, g, size=(m,))
    w = rng.standard_normal((m,))
    z = np.zeros(pad)
    return (np.concatenate([idx, z]).astype(np.int32), np.concatenate([dest, z]).astype(np.int32),
            np.concatenate([w, z]).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# shapes of tests/test_mh_coo.py:57-67, plus a pad-heavy case (25% padding)
@pytest.mark.parametrize("m,s,g,k,pad", [(1000, 64, 40, 17, 0), (4096, 512, 160, 16, 0),
                                         (3000, 128, 50, 16, 1000)])
def test_pool_plain_matches_pallas(m, s, g, k, pad):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((s, k)).astype(np.float32)
    idx, dest, w = _triplet(rng, m, s, g, pad=pad)
    want = np.asarray(PS.coo_pool_rows(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(dest),
                                       jnp.asarray(w), g, chunk=256, unroll=8))
    got = CP.coo_pool_rows(*_t(table, idx, dest, w), g).numpy()
    assert got.dtype == np.float32 and got.shape == (g, k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the order of the slots does not matter
    perm = rng.permutation(idx.size)
    shuffled = CP.coo_pool_rows(*_t(table, idx[perm], dest[perm], w[perm]), g).numpy()
    np.testing.assert_allclose(shuffled, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jax_kernel", ["coo_accumulate_rows", "coo_accumulate_rows_packed"])
@pytest.mark.parametrize("m,s,g,k,pad", [(2048, 128, 60, 8, 0), (2048, 128, 60, 16, 700)])
def test_accumulate_plain_matches_pallas(jax_kernel, m, s, g, k, pad):
    # heavy idx duplication, as in tests/test_mh_coo.py:69-83; the
    # lane-packed TPU variant computes the same function
    rng = np.random.default_rng(1)
    dp = rng.standard_normal((g, k)).astype(np.float32)
    idx, dest, w = _triplet(rng, m, s, g, zipf=True, pad=pad)
    want = np.asarray(getattr(PS, jax_kernel)(jnp.asarray(dp), jnp.asarray(idx), jnp.asarray(dest),
                                              jnp.asarray(w), s, chunk=256, unroll=8))
    got = CP.coo_accumulate_rows(*_t(dp, idx, dest, w), s).numpy()
    assert got.dtype == np.float32 and got.shape == (s, k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_make_coo_pool_value_and_grad_match_jax():
    # tests/test_mh_coo.py:86-105
    rng = np.random.default_rng(2)
    m, s, g, k = 700, 64, 30, 9
    rows = rng.standard_normal((s, k)).astype(np.float32)
    idx, dest, w = _triplet(rng, m, s, g)
    probe = rng.standard_normal((g, k)).astype(np.float32)

    jpool = PS.make_coo_pool(chunk=128, unroll=8)
    v_j, g_j = jax.value_and_grad(
        lambda r: jnp.sum(jpool(r, jnp.asarray(idx), jnp.asarray(dest), jnp.asarray(w), g) * probe)
    )(jnp.asarray(rows))

    pool = CP.make_coo_pool()
    rt = torch.from_numpy(rows).requires_grad_(True)
    v_t = torch.sum(pool(rt, *_t(idx, dest, w), g) * torch.from_numpy(probe))
    (g_t,) = torch.autograd.grad(v_t, rt)
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


def test_pool_grad_reaches_rows_only():
    rng = np.random.default_rng(3)
    rows = torch.randn((20, 4), requires_grad=True)
    idx, dest, w = _t(*_triplet(rng, 50, 20, 6))
    w.requires_grad_(True)
    out = CP.make_coo_pool()(rows, idx, dest, w, 6)
    g_rows, g_w = torch.autograd.grad(out.sum(), [rows, w], allow_unused=True)
    assert g_rows.shape == (20, 4) and g_w is None
    # the plain pool's own autograd gives the same row gradient
    (g_plain,) = torch.autograd.grad(coo_pool(rows, idx, dest, w.detach(), 6).sum(), rows)
    torch.testing.assert_close(g_rows, g_plain)


def test_expand_lookup_carries_the_coo_pool():
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.standard_normal((30, 5)).astype(np.float32))
    idx, dest, w = _t(*_triplet(rng, 90, 30, 12))
    lookup = SR.make_expand_lookup()
    torch.testing.assert_close(lookup.coo_pool(rows, idx, dest, w, 12),
                               coo_pool(rows, idx, dest, w, 12))


def test_bf16_table_pools_in_f32():
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32)).to(torch.bfloat16)
    idx, dest, w = _t(*_triplet(rng, 300, 40, 10))
    got = CP.coo_pool_rows(table, idx, dest, w, 10)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, coo_pool(table.float(), idx, dest, w, 10))


def test_cpu_tensors_never_count_launches():
    CP.reset_launches()
    rng = np.random.default_rng(6)
    rows = torch.randn((20, 4), requires_grad=True)
    idx, dest, w = _t(*_triplet(rng, 50, 20, 6))
    torch.autograd.grad(CP.make_coo_pool()(rows, idx, dest, w, 6).sum(), rows)
    CP.coo_accumulate_rows(torch.ones(6, 4), idx, dest, w, 20)
    assert CP.coo_pool_rows.launches == 0 and CP.coo_accumulate_rows.launches == 0


def test_wrappers_refuse_other_devices():
    # no path falls back to the plain version for a non-CPU tensor
    idx = torch.empty((3,), dtype=torch.int32, device="meta")
    w = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        CP.coo_pool_rows(torch.empty((8, 4), device="meta"), idx, idx, w, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        CP.coo_accumulate_rows(torch.empty((2, 4), device="meta"), idx, idx, w, 8)
