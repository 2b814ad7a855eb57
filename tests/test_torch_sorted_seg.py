"""The port's sorted-stream segment ops (tf_repos_tpu_torch/ops/
sorted_seg.py) against the JAX package's Pallas kernels sorted_segsum,
sorted_expand and sorted_segsum_packed and its make_sorted_seg /
make_sorted_bwd_expand, run in interpret mode on the CPU as
tests/test_mh_coo.py runs them.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels are held to those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances, each the JAX package's own bar for the same
comparison (tests/test_mh_coo.py): segment sums 2e-5 relative and 1e-6
absolute (2e-4 absolute against the lane-packed kernel), since both
sides sum f32 in another order; selections bit-exact; the autograd
pairs' values and gradients 3e-5 relative, 3e-4 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.ops import pallas_sparse as PS
from tf_repos_tpu_torch.ops import sorted_seg as SG
from tf_repos_tpu_torch.ops import sparse_rows as SR


def _sorted_cdest(rng, m, g, p=0.08):
    """A stream as the contract states it: nondecreasing, steps <= 1."""
    inc = (rng.random(m) < p).astype(np.int32)
    inc[:1] = 0
    return np.minimum(np.cumsum(inc), g - 1).astype(np.int32)


def _packer_stream(rng, m_live, pad, g):
    """A packer stream: a sorted live prefix, then ``pad`` slots of
    cdest 0 carrying zero values."""
    cdest = np.concatenate([_sorted_cdest(rng, m_live, g), np.zeros(pad, np.int32)])
    return cdest.astype(np.int32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("m,g,k", [(3000, 257, 16), (700, 40, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segsum_and_expand_plain_match_pallas(m, g, k, dtype):
    rng = np.random.default_rng(0)
    cdest = _sorted_cdest(rng, m, g)
    jv, tv = _pair(rng.normal(size=(m, k)).astype(np.float32), dtype)
    js, ts = _pair(rng.normal(size=(g, k)).astype(np.float32), dtype)
    want = _np(PS.sorted_segsum(jv, jnp.asarray(cdest), g))
    got = SG.sorted_segsum(tv, torch.from_numpy(cdest), g)
    assert got.dtype == torch.float32 and got.shape == (g, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
    sel = SG.sorted_expand(ts, torch.from_numpy(cdest))
    assert sel.dtype == ts.dtype and sel.shape == (m, k)
    np.testing.assert_array_equal(sel.float().numpy(), _np(PS.sorted_expand(js, jnp.asarray(cdest))))


@pytest.mark.parametrize("m,g,k", [(3000, 700, 16), (900, 57, 32)])
def test_segsum_plain_matches_pallas_packed(m, g, k):
    # K5p: the TPU's lane-packed sum for large n_out is the same function
    rng = np.random.default_rng(2)
    cdest = _sorted_cdest(rng, m, g, p=0.3)
    vals = rng.normal(size=(m, k)).astype(np.float32)
    want = np.asarray(PS.sorted_segsum_packed(jnp.asarray(vals), jnp.asarray(cdest), g))
    got = SG.sorted_segsum(torch.from_numpy(vals), torch.from_numpy(cdest), g).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("m_live,pad", [(2500, 700), (0, 1024)], ids=["pad_tail", "all_pads"])
def test_packer_streams_with_zero_pads(m_live, pad):
    """Padding slots carry cdest 0 and zero values after the live prefix
    (or are the whole stream): the sums match JAX's kernels in both
    forms, and the selection matches on the live prefix."""
    rng = np.random.default_rng(3)
    g, k = 300, 16
    cdest = _packer_stream(rng, m_live, pad, g)
    vals = rng.normal(size=(m_live + pad, k)).astype(np.float32)
    vals[m_live:] = 0.0
    src = rng.normal(size=(g, k)).astype(np.float32)
    got = SG.sorted_segsum(torch.from_numpy(vals), torch.from_numpy(cdest), g).numpy()
    for jax_fn in (PS.sorted_segsum, PS.sorted_segsum_packed):
        want = np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(cdest), g))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    if not m_live:
        assert not got.any()
    sel = SG.sorted_expand(torch.from_numpy(src), torch.from_numpy(cdest)).numpy()
    want_sel = np.asarray(PS.sorted_expand(jnp.asarray(src), jnp.asarray(cdest)))
    np.testing.assert_array_equal(sel[:m_live], want_sel[:m_live])
    np.testing.assert_array_equal(sel, src[cdest])


def test_make_sorted_seg_values_and_grads_match_jax():
    rng = np.random.default_rng(1)
    m, g, k = 2000, 129, 16
    cdest = _sorted_cdest(rng, m, g)
    vals = rng.normal(size=(m, k)).astype(np.float32)
    src = rng.normal(size=(g, k)).astype(np.float32)
    jpool, jsel = PS.make_sorted_seg()

    def jf(v, s):
        c = jnp.asarray(cdest)
        return jnp.sum(jpool(v, c, g) ** 2) + jnp.sum(jsel(s, c).astype(jnp.float32) ** 2 * 2.0)

    lj, (gvj, gsj) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(src))
    pool, sel = SG.make_sorted_seg()
    v = torch.from_numpy(vals).requires_grad_(True)
    s = torch.from_numpy(src).requires_grad_(True)
    c = torch.from_numpy(cdest)
    lt = torch.sum(pool(v, c, g) ** 2) + torch.sum(sel(s, c) ** 2 * 2.0)
    gv, gs = torch.autograd.grad(lt, [v, s])
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=3e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gvj), rtol=3e-5, atol=3e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gsj), rtol=3e-5, atol=3e-4)


def test_seg_pair_grads_keep_the_primal_dtype():
    rng = np.random.default_rng(4)
    cdest = torch.from_numpy(_sorted_cdest(rng, 300, 40))
    pool, sel = SG.make_sorted_seg()
    v = torch.randn((300, 8), dtype=torch.bfloat16, requires_grad=True)
    s = torch.randn((40, 8), dtype=torch.bfloat16, requires_grad=True)
    out = pool(v, cdest, 40)
    assert out.dtype == torch.float32
    (gv,) = torch.autograd.grad(out.sum(), v)
    (gs,) = torch.autograd.grad(sel(s, cdest).float().sum(), s)
    assert gv.dtype == gs.dtype == torch.bfloat16
    torch.testing.assert_close(gs.float(), torch.bincount(cdest.long(), minlength=40)[:, None]
                               .float().expand(40, 8))


def test_sorted_bwd_expand_matches_jax():
    """The idx-sorted backward with 0-sentinel pad tails (as
    tests/test_mh_coo.py:649-692 builds them), against the JAX
    package's make_sorted_bwd_expand and the plain lookup's gradient."""
    rng = np.random.default_rng(3)
    s, m, k, pad = 97, 400, 16, 80
    rows = rng.normal(size=(s, k)).astype(np.float32)
    ids_live = rng.integers(0, s, m).astype(np.int32)
    order = np.argsort(ids_live, kind="stable").astype(np.int32)
    si = ids_live[order]
    starts = np.concatenate([[True], si[1:] != si[:-1]])
    cidx = (np.cumsum(starts) - 1).astype(np.int32)
    z = np.zeros(pad, np.int32)
    ids, perm, cidxp = (np.concatenate([a, z]) for a in (ids_live, order, cidx))
    srows = np.concatenate([si[starts], np.zeros(33, np.int32)])
    w = np.concatenate([np.ones(m), np.zeros(pad)]).astype(np.float32)
    jexp = PS.make_sorted_bwd_expand(chunk=256)
    lj, gj = jax.value_and_grad(lambda r: jnp.sum((jexp(
        r, *(jnp.asarray(a) for a in (ids, perm, cidxp, srows)), jnp.int32(m)) * w[:, None]) ** 2
    ))(jnp.asarray(rows))

    exp = SG.make_sorted_bwd_expand()
    r = torch.from_numpy(rows).requires_grad_(True)
    out = exp(r, *(torch.from_numpy(a) for a in (ids, perm, cidxp, srows)), torch.tensor(m))
    lt = torch.sum((out * torch.from_numpy(w)[:, None]) ** 2)
    (gt,) = torch.autograd.grad(lt, r)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=3e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=3e-5, atol=3e-4)
    # and the plain lookup's gradient
    r2 = torch.from_numpy(rows).requires_grad_(True)
    (g2,) = torch.autograd.grad(
        torch.sum((r2[torch.from_numpy(ids).long()] * torch.from_numpy(w)[:, None]) ** 2), r2)
    torch.testing.assert_close(gt, g2, rtol=3e-5, atol=3e-4)


def test_expand_lookup_carries_the_sorted_ops():
    lookup = SR.make_expand_lookup()
    rng = np.random.default_rng(5)
    cdest = torch.from_numpy(_sorted_cdest(rng, 200, 30))
    vals = torch.randn((200, 4))
    torch.testing.assert_close(lookup.seg_pool(vals, cdest, 30), SG.sorted_segsum_plain(vals, cdest, 30))
    src = torch.randn((30, 4))
    torch.testing.assert_close(lookup.seg_select(src, cdest), src[cdest])
    assert callable(lookup.sorted_bwd_expand)


def test_cpu_tensors_never_count_launches():
    SG.reset_launches()
    rng = np.random.default_rng(6)
    cdest = torch.from_numpy(_sorted_cdest(rng, 100, 10))
    pool, sel = SG.make_sorted_seg()
    v = torch.randn((100, 4), requires_grad=True)
    s = torch.randn((10, 4), requires_grad=True)
    torch.autograd.grad(pool(v, cdest, 10).sum() + sel(s, cdest).sum(), [v, s])
    assert SG.sorted_segsum.launches == 0 and SG.sorted_expand.launches == 0


def test_wrappers_refuse_other_devices():
    # no path falls back to the plain version for a non-CPU tensor
    cdest = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        SG.sorted_segsum(torch.empty((3, 4), device="meta"), cdest, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        SG.sorted_expand(torch.empty((2, 4), device="meta"), cdest)
