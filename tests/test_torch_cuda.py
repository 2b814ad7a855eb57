"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip here
with a reason elsewhere. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: expand, the sorted select and the row
scatter are bit-exact; accumulate adds with atomics in run-to-run order,
held to 1e-4 of sum_i |g_i| per element; the COO pool, its transpose,
the sorted segment sum and the field-block scatter likewise, to 1e-4 of
sum_i |w_i x_i| (or |v_i|, |g_i|) per element, plus 1e-6. The serving
lookup is bit-exact against the plain gather on normalised ids; the
card's scorer is held to the CPU's at the bf16-tower bar, 2e-2."""

import numpy as np
import pytest
import torch

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import coo_pool as CP
from tf_repos_tpu_torch.ops import field_block as FB
from tf_repos_tpu_torch.ops import row_scatter as RS
from tf_repos_tpu_torch.ops import sorted_seg as SG
from tf_repos_tpu_torch.ops import sparse_rows as SR
from tf_repos_tpu_torch.serve.export import export_servable
from tf_repos_tpu_torch.serve.scorer import Scorer
from tf_repos_tpu_torch.train import sparse as SP

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _zipf(n, s, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.minimum(rng.zipf(1.2, size=n) - 1, s - 1).astype(np.int32))


# K1's two paths: 16-byte chunks where the row, the row stride and the
# base are 16-byte aligned (K = 4, 8, 16, 128 in f32 at stride 3K; 8, 16,
# 128 in bf16), words elsewhere (K = 1, 3, 17, 33; the su[:, 1:17] view).
# N = 0, 1, a block's ragged tail (255, 257), the DeepFM serving gather
# (13,312) and the DIN COO lookup (1,310,720).
_EXPAND_CASES = [(425_984, 28_672, 17, "w"), (1_000_003, 777, 17, "w"), (513, 40, 5, "w"),
                 (4096, 512, 64, "w")] + [
    (n, 5_000, k, "w") for n in (0, 1, 255, 257, 13_312, 1_310_720)
    for k in (1, 3, 4, 8, 16, 17, 33, 128)] + [
    (n, 114_688, 16, view) for n in (1, 257, 13_312, 1_310_720)
    for view in ("su16", "su1", "whole")]


@pytest.mark.parametrize("n,s,k,view", _EXPAND_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expand_bit_exact(dev, n, s, k, view, dtype):
    if view == "w":  # the w columns of a [S, 3K] store, as on the main path
        table = torch.randn((s, 3 * k), device=dev).to(dtype)[:, :k]
    elif view == "whole":
        table = torch.randn((s, k), device=dev).to(dtype)
    else:  # su[:, 16:32] or su[:, 1:17] of a [S, 48] store: 16-byte aligned or not
        lo = int(view[2:])
        table = torch.randn((s, 48), device=dev).to(dtype)[:, lo:lo + k]
    idx = _zipf(n, s).to(dev)
    before = SR.expand_rows.launches
    out = SR.expand_rows(table, idx)
    torch.cuda.synchronize()
    assert SR.expand_rows.launches == before + (1 if n else 0)
    assert out.dtype == dtype and out.shape == (n, k)
    assert torch.equal(out, table[idx])


@pytest.mark.parametrize("n,s,k,pad,zero_pad", [
    (425_984, 28_672, 17, 0, False),
    (100_000, 64, 17, 0, False),
    (513, 40, 5, 0, False),
    # the DIN COO lookup: 1,310,720 slots, 141,716 of them padding on row 0
    (1_169_004, 114_688, 16, 141_716, False),
    (300_000, 20_000, 16, 100_000, True),  # a zero-cotangent padding block
    (2_047, 500, 16, 0, False),  # N = T - 1, T, T + 1 (T = 2,048 slots a tile)
    (2_048, 500, 17, 0, False),
    (2_049, 500, 16, 0, False),
    (50_000, 3_000, 48, 0, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accumulate_matches_plain(dev, n, s, k, pad, zero_pad, dtype):
    g = torch.randn((n + pad, k), device=dev)
    if zero_pad:
        g[n:] = 0.0
    g = g.to(dtype)
    idx = torch.cat([_zipf(n, s), torch.zeros(pad, dtype=torch.int32)]).to(dev)
    before = SR.accumulate_rows.launches
    got = SR.accumulate_rows(g, idx, s)
    torch.cuda.synchronize()
    assert SR.accumulate_rows.launches == before + 1
    want = SR.accumulate_rows_plain(g, idx, s)
    scale = SR.accumulate_rows_plain(g.abs(), idx, s)
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())


def test_accumulate_tile_sizes(dev):
    # the boundary cases above and below are written for these tiles
    assert SR._lib().tr_accumulate_rows_tile() == 2_048
    assert CP._lib().tr_coo_accumulate_rows_tile() == 2_560


def test_accumulate_passes_nan_through(dev):
    """A NaN cotangent row reaches its output row, as with index_add_;
    +-0 rows add nothing, and one tile's slots on one id sum exactly."""
    n, s, k = 5_000, 64, 16
    g = torch.randn((n, k), device=dev)
    idx = torch.randint(0, s, (n,), dtype=torch.int32, device=dev)
    g[10:400] = 0.0
    g[400:800] = -0.0
    g[7] = float("nan")
    got = SR.accumulate_rows(g, idx, s)
    want = SR.accumulate_rows_plain(g, idx, s)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[int(idx[7])]).all())
    ok = ~torch.isnan(want)
    scale = SR.accumulate_rows_plain(g.abs(), idx, s)
    assert bool(((got - want).abs()[ok] <= 1e-4 * scale[ok] + 1e-6).all())
    ones = SR.accumulate_rows(torch.ones((2_048, k), device=dev),
                              torch.full((2_048,), 3, dtype=torch.int32, device=dev), s)
    assert float(ones[3, 0]) == 2_048.0 and float(ones.sum()) == 2_048.0 * k


def test_lookup_grad_on_card_matches_cpu(dev):
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.standard_normal((300, 17)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, size=(64, 26)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((26, 17)).astype(np.float32))
    lookup = SR.make_expand_lookup()
    grads = []
    for d in ("cpu", dev):
        r = rows.to(d).requires_grad_(True)
        (g,) = torch.autograd.grad((lookup(r, ids.to(d)) * w.to(d)).sum(), r)
        grads.append(g.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    table = torch.randn((10, 4), device=dev)
    with pytest.raises(ValueError, match="int32"):
        SR.expand_rows(table, torch.zeros(3, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="dtype"):
        SR.expand_rows(table.double(), torch.zeros(3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        SR.accumulate_rows(torch.randn((4, 3), device=dev).t(), torch.zeros(3, dtype=torch.int32, device=dev), 5)
    # the serving entry: int ids on the table's device, in rows of adjacent ids
    with pytest.raises(ValueError, match="int32 or int64"):
        SR.expand_rows_clamped(table, torch.zeros(3, device=dev))
    with pytest.raises(ValueError, match="expected"):
        SR.expand_rows_clamped(table, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="adjacent ids"):
        SR.expand_rows_clamped(table, torch.zeros((4, 3), dtype=torch.int32, device=dev).t())
    with pytest.raises(ValueError, match="0 rows"):
        SR.expand_rows_clamped(table[:0], torch.zeros(3, dtype=torch.int32, device=dev))


def _coo(m, s, g, pad, seed=0, runs=True):
    """idx (Zipf), dest and w of m live slots, emitted in runs of equal
    dest as the packer does (or shuffled), then ``pad`` padding slots."""
    rng = np.random.default_rng(seed)
    idx = np.minimum(rng.zipf(1.2, size=m) - 1, s - 1)
    dest = np.sort(rng.integers(0, g, size=m)) if runs else rng.integers(0, g, size=m)
    w = rng.random(m) + 0.5
    z = np.zeros(pad)
    return [torch.from_numpy(np.concatenate([a, z]).astype(t)) for a, t in
            ((idx, np.int32), (dest, np.int32), (w, np.float32))]


K3_STRIP, K3_BLOCK = 16, 1_024  # csrc/coo_pool.cu: slots a strip, slots a block at K = 16


@pytest.mark.parametrize("m,s,g,k,pad,case", [
    (655_360, 114_688, 20_480, 16, 0, "runs"),  # the ESMM published point's shapes
    (200_000, 5_000, 4_096, 16, 0, "shuffled"),  # shuffled triplets
    (30_000, 2_000, 640, 16, 90_000, "runs"),  # pad-heavy
    (513, 40, 7, 5, 3, "runs"),
    (10_000, 300, 4, 16, 0, "one"),  # one bag of 10,000 slots: many strips and blocks
    # runs of ~5 and ~130 slots across the strip and the block edges
    (K3_STRIP - 1, 40, 3, 16, 0, "runs"),
    (K3_STRIP, 40, 3, 16, 0, "runs"),
    (K3_STRIP + 1, 40, 3, 16, 0, "runs"),
    (K3_BLOCK - 1, 300, 8, 16, 0, "runs"),
    (K3_BLOCK + 1, 300, 8, 16, 0, "runs"),
    # K = 5, 17 and 48 ([S, 51] at K = 17: an odd row stride, scalar loads)
    (50_000, 3_000, 512, 5, 1_000, "runs"),
    (50_000, 3_000, 512, 17, 1_000, "runs"),
    (50_000, 3_000, 512, 48, 1_000, "runs"),
    (50_000, 3_000, 512, 16, 1_000, "col1"),  # a view from column 1: scalar loads
    (50_000, 3_000, 512, 16, 0, "nan"),  # a NaN table row reaches its bags' rows
    (50_000, 3_000, 512, 16, 1_000, "signed0"),  # +-0 weights inside the runs
    (50_000, 3_000, 512, 16, 1_000, "off1"),  # slot arrays 4 bytes off 16: one load a slot
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coo_pool_matches_plain(dev, m, s, g, k, pad, case, dtype):
    wide = torch.randn((s, 3 * k), device=dev).to(dtype)
    # row-strided view, as on the main path
    table = wide[:, 1:k + 1] if case == "col1" else wide[:, :k]
    idx, dest, w = (t.to(dev) for t in _coo(m, s, g, pad, runs=case != "shuffled"))
    if case == "off1":
        idx, dest, w = idx[1:], dest[1:], w[1:]
    elif case == "one":
        dest[:m] = g - 1
    elif case == "nan":
        table[idx[m // 2]] = float("nan")
    elif case == "signed0":
        w[:m:3] = -0.0
        w[1:m:7] = 0.0
    before = CP.coo_pool_rows.launches
    got = CP.coo_pool_rows(table, idx, dest, w, g)
    torch.cuda.synchronize()
    assert CP.coo_pool_rows.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (g, k)
    want = CP.coo_pool_rows_plain(table, idx, dest, w, g)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and bool(nan.any()) == (case == "nan")
    scale = CP.coo_pool_rows_plain(table.abs(), idx, dest, w.abs(), g)
    assert bool(((got - want).abs()[~nan] <= 1e-4 * scale[~nan] + 1e-6).all())


@pytest.mark.parametrize("m,s,g,k,pad,runs,zero_rows", [
    (655_360, 114_688, 20_480, 16, 0, True, 0),
    (200_000, 5_000, 4_096, 16, 0, False, 0),
    (30_000, 2_000, 640, 16, 90_000, True, 0),
    (513, 40, 7, 5, 3, True, 0),
    # the DIN COO point's slot count: 141,716 padding slots (w = 0)
    (1_169_004, 114_688, 16_384, 16, 141_716, True, 0),
    (200_000, 5_000, 4_096, 16, 0, True, 1_024),  # a zero-cotangent block of dp rows
    (2_559, 300, 64, 16, 0, True, 0),  # M = T - 1, T, T + 1 (T = 2,560)
    (2_560, 300, 64, 17, 0, True, 0),
    (2_561, 300, 64, 16, 0, False, 0),
    (50_000, 3_000, 512, 48, 0, True, 0),
])
def test_coo_accumulate_matches_plain(dev, m, s, g, k, pad, runs, zero_rows):
    dp = torch.randn((g, k), device=dev)
    dp[:zero_rows] = 0.0
    idx, dest, w = (t.to(dev) for t in _coo(m, s, g, pad, seed=1, runs=runs))
    before = CP.coo_accumulate_rows.launches
    got = CP.coo_accumulate_rows(dp, idx, dest, w, s)
    torch.cuda.synchronize()
    assert CP.coo_accumulate_rows.launches == before + 1
    want = CP.coo_accumulate_rows_plain(dp, idx, dest, w, s)
    scale = CP.coo_accumulate_rows_plain(dp.abs(), idx, dest, w.abs(), s)
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())


def test_coo_pool_grad_on_card_matches_cpu(dev):
    rows = torch.from_numpy(np.random.default_rng(2).standard_normal((300, 16)).astype(np.float32))
    idx, dest, w = _coo(5_000, 300, 96, 100, seed=2)
    probe = torch.randn((96, 16))
    pool = CP.make_coo_pool()
    grads = []
    for d in ("cpu", dev):
        r = rows.to(d).requires_grad_(True)
        out = pool(r, idx.to(d), dest.to(d), w.to(d), 96)
        (g,) = torch.autograd.grad((out * probe.to(d)).sum(), r)
        grads.append(g.cpu())
    # the hot (Zipf) rows sum thousands of terms in another order
    scale = CP.coo_accumulate_rows_plain(probe.abs(), idx, dest, w.abs(), 300)
    assert bool(((grads[1] - grads[0]).abs() <= 1e-4 * scale + 1e-6).all())


def test_coo_wrappers_reject_what_the_kernels_do_not_take(dev):
    table = torch.randn((10, 4), device=dev)
    i32 = torch.zeros(3, dtype=torch.int32, device=dev)
    w = torch.ones(3, device=dev)
    with pytest.raises(ValueError, match="int32"):
        CP.coo_pool_rows(table, i32.long(), i32, w, 2)
    with pytest.raises(ValueError, match="lengths differ"):
        CP.coo_pool_rows(table, i32, i32[:2], w, 2)
    with pytest.raises(ValueError, match="float32"):
        CP.coo_accumulate_rows(torch.randn((2, 4), device=dev).double(), i32, i32, w, 10)


def _sorted_stream(m_live, pad, n_out, seed=0, p=0.0125):
    """A packer stream: a sorted live prefix (steps <= 1, ~1/p slots a
    segment), then ``pad`` slots of cdest 0."""
    rng = np.random.default_rng(seed)
    inc = (rng.random(m_live) < p).astype(np.int32)
    inc[:1] = 0
    live = np.minimum(np.cumsum(inc), n_out - 1)
    return torch.from_numpy(np.concatenate([live, np.zeros(pad)]).astype(np.int32))


def _segsum_stream(kind, m_live, pad, n_out, p):
    """cdest for the K5 card cases: the packer's stream (sorted live prefix,
    then ``pad`` slots of cdest 0), one segment over the whole stream, runs
    whose lengths straddle the strip (32 slots) and the block (64 strips,
    2,048 slots at K = 16) edges, or an unsorted random cdest."""
    rng = np.random.default_rng(0)
    if kind == "one":
        live = np.full(m_live, n_out - 1)
    elif kind == "edges":
        lens = np.tile([1, 7, 31, 32, 33, 63, 64, 65, 2_047, 2_048, 2_049, 4_095, 6_000], 8)
        live = np.minimum(np.repeat(np.arange(lens.size), lens), n_out - 1)[:m_live]
    elif kind == "random":
        live = rng.integers(0, n_out, size=m_live)
    else:
        return _sorted_stream(m_live, pad, n_out, p=p)
    return torch.from_numpy(np.concatenate([live, np.zeros(pad)]).astype(np.int32))


@pytest.mark.parametrize("kind,m_live,pad,n_out,p,k", [
    ("sorted", 1_170_000, 140_720, 16_384, 0.0125, 16),  # DIN's published point, n_out = G
    ("sorted", 1_170_000, 140_720, 100_000, 0.085, 16),  # the --coo_sorted_bwd runs, n_out = Su
    ("sorted", 100_003, 0, 777, 0.01, 16),  # ragged M, no padding
    ("sorted", 0, 4096, 64, 0.01, 16),  # an all-padding stream
    ("sorted", 37, 5, 9, 0.3, 16),
    ("sorted", 100_003, 3_000, 777, 0.01, 5),  # K = 5, 17: scalar loads, float2/float reductions
    ("sorted", 100_003, 3_000, 777, 0.01, 17),
    ("one", 100_003, 0, 9, 0.0, 16),  # one segment over the whole stream
    ("one", 100_003, 0, 9, 0.0, 17),
    ("edges", 106_000, 1_000, 200, 0.0, 16),  # runs across strip and block edges
    ("edges", 106_000, 1_000, 200, 0.0, 5),
    ("random", 200_000, 0, 5_000, 0.0, 16),  # unsorted: only more runs
    ("random", 200_000, 0, 5_000, 0.0, 17),
    ("nan", 100_003, 3_000, 777, 0.01, 16),  # a NaN row reaches its output row
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_segsum_matches_plain(dev, kind, m_live, pad, n_out, p, k, dtype):
    cdest = _segsum_stream(kind, m_live, pad, n_out, p).to(dev)
    vals = torch.randn((m_live + pad, k), device=dev)
    vals[m_live:] = 0.0
    if kind == "nan":
        vals[5_000] = float("nan")
    vals = vals.to(dtype)
    before = SG.sorted_segsum.launches
    got = SG.sorted_segsum(vals, cdest, n_out)
    torch.cuda.synchronize()
    assert SG.sorted_segsum.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n_out, k)
    want = SG.sorted_segsum_plain(vals, cdest, n_out)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and bool(nan.any()) == (kind == "nan")
    scale = SG.sorted_segsum_plain(vals.abs(), cdest, n_out)
    assert bool(((got - want).abs()[~nan] <= 1e-4 * scale[~nan] + 1e-6).all())


@pytest.mark.parametrize("m,n_src,k", [(1_310_720, 16_384, 16), (100_003, 777, 5), (37, 9, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_expand_bit_exact(dev, m, n_src, k, dtype):
    cdest = _sorted_stream(m - m // 9, m // 9, n_src).to(dev)
    src = torch.randn((n_src, k), device=dev).to(dtype)
    before = SG.sorted_expand.launches
    out = SG.sorted_expand(src, cdest)
    torch.cuda.synchronize()
    assert SG.sorted_expand.launches == before + 1
    assert out.dtype == dtype and torch.equal(out, src[cdest])


def test_sorted_seg_grads_on_card_match_cpu(dev):
    cdest = _sorted_stream(5_000, 700, 300, seed=3, p=0.05)
    vals = torch.randn((5_700, 16))
    vals[5_000:] = 0.0
    src = torch.randn((300, 16))
    probe_p, probe_s = torch.randn((300, 16)), torch.randn((5_700, 16))
    pool, sel = SG.make_sorted_seg()
    grads = []
    for d in ("cpu", dev):
        v, s = vals.to(d).requires_grad_(True), src.to(d).requires_grad_(True)
        c = cdest.to(d)
        loss = (pool(v, c, 300) * probe_p.to(d)).sum() + (sel(s, c) * probe_s.to(d)).sum()
        grads.append([g.cpu() for g in torch.autograd.grad(loss, [v, s])])
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=0)  # a selection
    scale = SG.sorted_segsum_plain(probe_s.abs(), cdest, 300)
    assert bool(((grads[1][1] - grads[0][1]).abs() <= 1e-4 * scale + 1e-6).all())


def test_sorted_bwd_expand_grad_on_card_matches_cpu(dev):
    rng = np.random.default_rng(4)
    s, m, pad = 500, 20_000, 3_000
    ids_live = np.minimum(rng.zipf(1.2, size=m) - 1, s - 1).astype(np.int32)
    order = np.argsort(ids_live, kind="stable").astype(np.int32)
    si = ids_live[order]
    starts = np.concatenate([[True], si[1:] != si[:-1]])
    z = np.zeros(pad, np.int32)
    aux = [torch.from_numpy(np.concatenate([a, z])) for a in
           (ids_live, order, (np.cumsum(starts) - 1).astype(np.int32))]
    aux.append(torch.from_numpy(np.concatenate([si[starts], np.zeros(50, np.int32)])))
    rows = torch.randn((s, 16))
    probe = torch.randn((m + pad, 16))
    probe[m:] = 0.0
    exp = SG.make_sorted_bwd_expand()
    grads = []
    for d in ("cpu", dev):
        r = rows.to(d).requires_grad_(True)
        out = exp(r, *(a.to(d) for a in aux), torch.tensor(m, device=d))
        (g,) = torch.autograd.grad((out * probe.to(d)).sum(), r)
        grads.append(g.cpu())
    scale = SR.accumulate_rows_plain(probe.abs(), aux[0], s)
    assert bool(((grads[1] - grads[0]).abs() <= 1e-4 * scale + 1e-6).all())


def test_sorted_wrappers_reject_what_the_kernels_do_not_take(dev):
    i32 = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        SG.sorted_segsum(torch.randn((4, 8), device=dev), i32.long(), 2)
    with pytest.raises(ValueError, match="dtype"):
        SG.sorted_segsum(torch.randn((4, 8), device=dev).double(), i32, 2)
    with pytest.raises(ValueError, match="contiguous"):
        SG.sorted_segsum(torch.randn((8, 4), device=dev).t(), i32, 2)
    with pytest.raises(ValueError, match="rows of vals"):
        SG.sorted_segsum(torch.randn((5, 8), device=dev), i32, 2)
    with pytest.raises(ValueError, match="cdest on"):
        SG.sorted_expand(torch.randn((4, 8), device=dev), i32.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        SG.sorted_expand(torch.randn((8, 4), device=dev).t(), i32)
    with pytest.raises(ValueError, match="dtype"):
        SG.sorted_expand(torch.randn((4, 8), device=dev).half(), i32)


def _scatter_case(v, s, live, seed=0):
    """u: ``live`` unique ascending ids below v, then the sentinel v (and
    one id beyond it) up to s."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.choice(v, size=live, replace=False))
    pad = np.full(s - live, v)
    pad[-1:] = v + 7
    return torch.from_numpy(np.concatenate([u, pad]).astype(np.int32))


@pytest.mark.parametrize("v,width,s,live", [
    (4_500_000, 128, 114_688, 107_345),  # the ESMM published point, lane-padded store
    (4_500_000, 48, 114_688, 107_345),  # the same at the unpadded width 3K
    (1000, 17, 300, 280),  # odd width: 4-byte copy units
    (50, 8, 40, 30),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_scatter_bit_exact(dev, v, width, s, live, dtype):
    store = torch.randn((v + 1, width), device=dev).to(dtype)
    store[-1] = 0
    u = _scatter_case(v, s, live).to(dev)
    rows = torch.randn((s, width), device=dev)  # f32: cast to the store's dtype
    want = RS.dma_row_scatter_plain(store.clone(), u, rows, v)
    before = RS.dma_row_scatter.launches
    got = RS.dma_row_scatter(store, u, rows, n_valid=v)
    torch.cuda.synchronize()
    assert RS.dma_row_scatter.launches == before + 1 and got is store
    assert torch.equal(store, want) and not bool(store[-1].any())


def test_row_scatter_strided_rows(dev):
    """rows a column slice of a wider tensor (row stride 2L): 4-byte units."""
    store = torch.zeros((101, 64), device=dev)
    u = _scatter_case(100, 64, 50).to(dev)
    wide = torch.randn((64, 128), device=dev)
    RS.dma_row_scatter(store, u, wide[:, 32:96], n_valid=100)
    torch.cuda.synchronize()
    assert torch.equal(store, RS.dma_row_scatter_plain(torch.zeros_like(store), u, wide[:, 32:96], 100))


def test_expand_reads_w_columns_at_stride_128(dev):
    su = torch.randn((114_688, 128), device=dev)
    idx = _zipf(57_344, 114_688).to(dev)
    assert torch.equal(SR.expand_rows(su[:, :16], idx), su[:, :16][idx])


def test_dma_scatter_steps_on_card_match_cpu(dev):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((500, 6)).astype(np.float32))
    us = [torch.from_numpy(np.concatenate([np.sort(rng.choice(500, 90, replace=False)),
                                           np.full(38, 500)]).astype(np.int32)) for _ in range(3)]
    gs = [torch.from_numpy(rng.standard_normal((128, 6)).astype(np.float32)) for _ in range(3)]
    stores = []
    for d in ("cpu", dev):
        sopt = SP.make_sparse_row_optimizer("Adam", 1e-2, fused_table=True, dma_scatter=True)
        aux = sopt.init(table.to(d))
        for u, g in zip(us, gs):
            u = u.to(d)
            sopt.apply(aux, sopt.gather(aux, u), u, g.to(d))
        stores.append(aux["wmv"].cpu())
    torch.testing.assert_close(stores[1], stores[0], rtol=1e-6, atol=1e-7)
    assert not bool(stores[1][:, 18:].any()) and not bool(stores[1][-1].any())


def _blocks():
    """The DeepFM point's layout: 13 one-row blocks, 26 of 4,521 rows."""
    offsets = tuple(range(1, 14)) + tuple(14 + j * 4521 for j in range(26))
    return offsets, (1,) * 13 + (4521,) * 26, 117_581


def _field_block_case(case, b, w, rng):
    """(ids [b, F], g [b, F, w], vocab, offsets, sizes) for the K8 card
    cases, on the CPU."""
    if case == "overlap":
        offsets, sizes, vocab = (0, 20, 30, 30, 5), (40, 30, 10, 25, 1), 64
    elif case == "align":  # three overlapping whole-vocab fields: rows at every alignment
        offsets, sizes, vocab = (0, 0, 0), (1_000,) * 3, 1_000
    elif case == "onerow":  # row 7 is a one-row field hit by every batch row
        offsets, sizes, vocab = (0, 7), (5_000, 1), 5_000
    else:
        offsets, sizes, vocab = _blocks()
    ids = np.stack([rng.integers(o, o + s, size=b) for o, s in zip(offsets, sizes)], axis=1)
    if case == "masked":  # out-of-block ids and -1 padding
        ids[: b // 2, 13:] = rng.integers(0, vocab, size=(b // 2, 26))
        ids[-50:] = -1
    g = torch.randn((b, len(offsets), w))
    if case == "nan":  # in a large block and in a one-row field
        g[3, 20, 5] = float("nan")
        g[6, 2, 0] = float("nan")
    return torch.from_numpy(ids.astype(np.int32)), g, vocab, offsets, sizes


@pytest.mark.parametrize("b,case,w", [
    (16_384, "deepfm", 17), (1_000, "masked", 17), (37, "overlap", 17),
    (4_000, "align", 1), (4_000, "align", 3), (4_000, "align", 5), (4_000, "align", 17),
    (4_000, "align", 64), (16_384, "onerow", 17), (2_000, "nan", 17),
    (1_000, "align", 257), (1_000, "align", 1_024),  # warp tiles of 3 and 1 pairs
])
@pytest.mark.parametrize("use_bf16", [True, False])
def test_field_block_scatter_matches_plain(dev, b, case, w, use_bf16):
    ids, g, vocab, offsets, sizes = _field_block_case(case, b, w, np.random.default_rng(5))
    ids, g = ids.to(dev), g.to(dev)
    before = FB.field_block_scatter.launches
    got = FB.field_block_scatter(ids, g, vocab, offsets, sizes, use_bf16)
    torch.cuda.synchronize()
    assert FB.field_block_scatter.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (vocab, w)
    want = FB.field_block_scatter_plain(ids, g, vocab, offsets, sizes, use_bf16)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and bool(nan.any()) == (case == "nan")
    scale = FB.field_block_scatter_plain(ids, g.abs(), vocab, offsets, sizes, use_bf16)
    assert bool(((got - want).abs()[~nan] <= 1e-4 * scale[~nan] + 1e-6).all())


def test_field_block_lookup_grad_on_card_matches_cpu(dev):
    offsets, sizes, vocab = _blocks()
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(np.stack([rng.integers(o, o + s, size=2048) for o, s in
                                     zip(offsets, sizes)], axis=1).astype(np.int32))
    table = torch.from_numpy(rng.standard_normal((vocab, 17)).astype(np.float32))
    probe = torch.randn((2048, 39, 17))
    lookup = FB.make_field_block_lookup(vocab, offsets, sizes)
    grads = []
    for d in ("cpu", dev):
        t = table.to(d).requires_grad_(True)
        (g,) = torch.autograd.grad((lookup(t, ids.to(d)) * probe.to(d)).sum(), t)
        grads.append(g.cpu())
    scale = FB.field_block_scatter_plain(ids, probe.abs(), vocab, offsets, sizes)
    assert bool(((grads[1] - grads[0]).abs() <= 1e-4 * scale + 1e-6).all())


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    store = torch.zeros((11, 8), device=dev)
    u = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        RS.dma_row_scatter(store, u.long(), torch.zeros((4, 8), device=dev), 10)
    with pytest.raises(ValueError, match="expected"):
        RS.dma_row_scatter(store, u, torch.zeros((4, 6), device=dev), 10)
    with pytest.raises(ValueError, match="dtype"):
        RS.dma_row_scatter(store.double(), u, torch.zeros((4, 8), device=dev), 10)
    ids = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    g = torch.zeros((4, 2, 3), device=dev)
    with pytest.raises(ValueError, match="int32"):
        FB.field_block_scatter(ids.long(), g, 10, (0, 5), (5, 5))
    with pytest.raises(ValueError, match="float32"):
        FB.field_block_scatter(ids, g.double(), 10, (0, 5), (5, 5))
    with pytest.raises(ValueError, match="offsets"):
        FB.field_block_scatter(ids, g, 10, (0,), (5,))


# ------------------------------------------------------------------ serving
def _wild_ids(v, shape, seed=0):
    """Ids in [-2v, 2v) with the extremes: -1, v, 2**31 - 1, -2**31."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2 * v, 2 * v, size=shape)
    flat = ids.reshape(-1)
    flat[:6] = [-1, v, 2**31 - 1, -(2**31), -v, v - 1][:flat.size]
    return ids


@pytest.mark.parametrize("v,c,view", [(117_581, 17, False), (4_500_000, 16, False),
                                      (300, 17, True), (5_000, 16, True), (1, 16, False),
                                      (1, 17, False), (5_000, 16, "bf16")])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape,cols", [
    pytest.param((512, 26), None, id="contiguous"),
    pytest.param((512, 39), (13, 39), id="fields-view"),  # DeepFM's ids[:, 13:]
    pytest.param((512, 39), (5, 6), id="one-column-view"),
    pytest.param((1,), None, id="one-id"),
    pytest.param((0,), None, id="no-ids"),
])
def test_serving_lookup_bit_exact_on_whole_table(dev, v, c, view, dtype, shape, cols):
    """The serving lookup over a whole [V, C] table (or a fused store's
    [V, C] view, or a bf16 table) with ids from outside [0, V), -2**31,
    2**31 - 1 and V among them, contiguous or a view of a wider batch
    (DeepFM's dynamic fields): one K1 launch (none for no ids),
    bit-exact against the plain gather on normalised ids and against the
    CPU's lookup."""
    if view is True:
        table = torch.randn((v + 1, 3 * c), device=dev)[:-1, :c]
    else:
        table = torch.randn((v, c), device=dev).to(torch.bfloat16 if view else torch.float32)
    ids = torch.from_numpy(_wild_ids(v, shape)).to(dtype).to(dev)
    if cols:
        ids = ids[:, cols[0]:cols[1]]
    lookup = SR.make_serving_lookup()
    before = SR.expand_rows.launches
    got = lookup(table, ids)
    torch.cuda.synchronize()
    assert SR.expand_rows.launches == before + (1 if ids.numel() else 0)
    assert got.shape == tuple(ids.shape) + (c,) and got.dtype == table.dtype
    want = SR.expand_rows_plain(table, SR.normalize_ids(ids.reshape(-1), v)).reshape(got.shape)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), lookup(table.cpu(), ids.cpu()))


def test_scorer_on_card_matches_cpu(dev, tmp_path):
    """One DeepFM bucket at the bench width (bf16 towers), ids from
    outside [0, V) included: the card's scorer (K1) within 2e-2 of the
    CPU's (plain gather)."""
    cfg = Config(model="DeepFM", feature_size=117_581, field_size=39, embedding_size=16,
                 deep_layers="256,128,64", dropout="1.0,1.0,1.0", static_fields=13,
                 compute_dtype="bfloat16", device="cpu")
    model = create_model(cfg)
    params, mstate = model.init(torch.Generator().manual_seed(0))
    export_servable(str(tmp_path), model, params, mstate)
    card = Scorer(str(tmp_path), batch_buckets=(64,), device="cuda")  # warmup launches K1
    cpu = Scorer(str(tmp_path), batch_buckets=(64,), warmup=False, device="cpu")
    ids = _wild_ids(cfg.feature_size, (64, 39), seed=1)
    ids[:, :13] = np.arange(1, 14)
    vals = np.random.default_rng(2).random((64, 39)).astype(np.float32)
    inst = [{"feat_ids": ids[i], "feat_vals": vals[i]} for i in range(64)]
    before = SR.expand_rows.launches
    got = card.score(inst)["prob"]
    assert SR.expand_rows.launches == before + 1
    assert card.last_timing["bucket"] == 64
    np.testing.assert_allclose(got, cpu.score(inst)["prob"], rtol=2e-2, atol=1e-6)


@pytest.mark.parametrize("opt", ["Adagrad", "ftrl", "Momentum", "GD"])
def test_lazy_row_updates_on_card_match_cpu(dev, opt):
    """The other optimizers' row forms on the card: three updates of a
    plain [V+1, 6] store (sentinel rows included) equal to the CPU's, the
    spare row held at zero."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((500, 6)).astype(np.float32))
    us = [torch.from_numpy(np.concatenate([np.sort(rng.choice(500, 90, replace=False)),
                                           np.full(38, 500)]).astype(np.int32)) for _ in range(3)]
    gs = [torch.from_numpy(rng.standard_normal((128, 6)).astype(np.float32)) for _ in range(3)]
    for g in gs:
        g[90:] = 0.0  # the sentinel positions get no cotangent
    auxes = []
    for d in ("cpu", dev):
        sopt = SP.make_sparse_row_optimizer(opt, 1e-2)
        aux = sopt.init(table.to(d))
        for u, g in zip(us, gs):
            u = u.to(d)
            sopt.apply(aux, sopt.gather(aux, u), u, g.to(d))
        auxes.append({k: v.cpu() for k, v in aux.items()})
    assert auxes[0].keys() == auxes[1].keys()
    for k in auxes[0]:
        torch.testing.assert_close(auxes[1][k], auxes[0][k], rtol=1e-6, atol=1e-7)
        assert not bool(auxes[1][k][-1].any()), k


def test_wide_deep_scorer_on_card_matches_cpu(dev, tmp_path):
    """Wide&Deep at its published width (K=32, bf16 towers): the card's
    scorer gathers emb and wide_cat's [V, 1] view with one K1 launch each,
    within 2e-2 of the CPU's; ids outside the buckets read bucket 0."""
    cfg = Config(model="wide_n_deep", embedding_size=32, deep_layers="256,128,64",
                 dropout="1.0,1.0,1.0", compute_dtype="bfloat16", device="cpu")
    model = create_model(cfg)
    params, mstate = model.init(torch.Generator().manual_seed(0))
    params["wide_cat"] = torch.randn(params["wide_cat"].shape) * 0.1
    export_servable(str(tmp_path), model, params, mstate)
    card = Scorer(str(tmp_path), batch_buckets=(64,), device="cuda")
    cpu = Scorer(str(tmp_path), batch_buckets=(64,), warmup=False, device="cpu")
    rng = np.random.default_rng(3)
    cat = rng.integers(-3, 10_003, size=(64, 26)).astype(np.int32)
    cont = rng.random((64, 13)).astype(np.float32)
    inst = [{"cont": cont[i], "cat": cat[i]} for i in range(64)]
    before = SR.expand_rows.launches
    got = card.score(inst)["prob"]
    assert SR.expand_rows.launches == before + 2
    np.testing.assert_allclose(got, cpu.score(inst)["prob"], rtol=2e-2, atol=1e-6)


def test_stochastic_rounding_on_card_matches_cpu(dev):
    """The rounding on the card equals the CPU's bit for bit for the same
    noise (random bit patterns, NaNs and infinities among them), and a
    generator on the card rounds 0.25 ulp above 1.0 up at a rate of
    0.25 +- 0.01."""
    from tf_repos_tpu_torch.ops import rounding as R

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 2 ** 32, 300_000, dtype=np.uint32).view(np.float32))
    noise = torch.from_numpy(rng.integers(0, 1 << 16, x.numel()).astype(np.int32))
    want = R.round_bits(x, noise).view(torch.int16)
    got = R.round_bits(x.to(dev), noise.to(dev)).view(torch.int16).cpu()
    assert torch.equal(got, want)
    gen = torch.Generator(device=dev).manual_seed(1)
    up = R.stochastic_round_bf16(torch.full((200_000,), 1.0 + 0.25 * 2.0 ** -7, device=dev), gen)
    assert abs(float((up.float() > 1.0).float().mean()) - 0.25) <= 0.01
    with pytest.raises(RuntimeError):  # a CPU generator cannot draw on the card
        R.stochastic_round_bf16(x.to(dev), torch.Generator().manual_seed(0))


@pytest.mark.parametrize("opt,kw", [("Adam", {"fused_table": True, "catchup": True}),
                                    ("Adam", {"fused_moments": True}),
                                    ("ftrl", {"fused_moments": True}), ("Adagrad", {})])
def test_bf16_lazy_updates_on_card_match_cpu(dev, opt, kw, monkeypatch):
    """Three updates of bf16 row stores on the card and on the CPU with the
    same noise (drawn on the CPU and copied, for this comparison only):
    every store equal but for elements one bf16 ulp apart (at most 1e-3 of
    them: the f32 row math may differ in its last bit on the card), the
    spare row held at zero."""
    from tf_repos_tpu_torch.ops import rounding as R

    draw = R.sr_noise
    monkeypatch.setattr(R, "sr_noise", lambda shape, g, device: draw(shape, g, "cpu").to(device))
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((500, 6)).astype(np.float32)).to(torch.bfloat16)
    us = [torch.from_numpy(np.concatenate([np.sort(rng.choice(500, 90, replace=False)),
                                           np.full(38, 500)]).astype(np.int32)) for _ in range(3)]
    gs = [torch.from_numpy(rng.standard_normal((128, 6)).astype(np.float32)) for _ in range(3)]
    auxes = []
    for d in ("cpu", dev):
        sopt = SP.make_sparse_row_optimizer(opt, 1e-2, **kw)
        aux = sopt.init(table.to(d))
        gen = torch.Generator().manual_seed(9)
        for u, g in zip(us, gs):
            u = u.to(d)
            sopt.apply(aux, sopt.gather(aux, u), u, g.to(d), gen)
        auxes.append({k: v.cpu() for k, v in aux.items() if isinstance(v, torch.Tensor)})
    for k, want in auxes[0].items():
        got = auxes[1][k]
        assert got.dtype == want.dtype and not bool(got[-1].any()), k
        if got.dtype == torch.bfloat16:
            ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
            assert int(ulps.max()) <= 1 and int((ulps > 0).sum()) <= 1e-3 * ulps.numel(), k
        else:
            assert torch.equal(got, want), k


def test_slim_decode_on_card_matches_cpu(dev):
    """The Ali-CCP wire (u16 ids, the lo/hi idx with the packed 17th bit,
    the counts) and the Criteo wire decode on the card as on the CPU."""
    from tf_repos_tpu_torch.data import slim_wire as W
    from tf_repos_tpu_torch.data.sparse_batch import MHC_CNT, MHC_DEST, MHC_IDX, MHC_W
    from tf_repos_tpu_torch.data.synthetic import synthetic_aliccp_batch, synthetic_criteo_batch
    from tf_repos_tpu_torch.train.harness import to_device

    rng = np.random.default_rng(0)
    ngr, bs, m, bound = 3, 64, 2048, 1 << 17
    cnt = rng.integers(0, 9, size=(1, ngr, bs))
    dv = (np.arange(bs)[None, :] * ngr + np.arange(ngr)[:, None]).reshape(-1)
    live = int(cnt.sum())
    dest, idx = np.zeros((1, m), np.int32), np.zeros((1, m), np.int32)
    dest[0, :live] = np.repeat(dv, cnt[0].reshape(-1))
    idx[0, :live] = rng.integers(1, bound, live)
    coo = {"y": np.zeros(bs, np.float32), "mask": np.ones(bs, np.float32),
           "__uids_emb": np.zeros(bound, np.int32), MHC_IDX: idx, MHC_DEST: dest,
           MHC_W: (idx > 0).astype(np.float32), MHC_CNT: cnt.astype(np.int32)}
    cases = [(W.AliccpSlimEncoder(bound, n_groups=ngr)(coo), W.decode_aliccp_batch),
             (W.AliccpSlimEncoder(600)(synthetic_aliccp_batch(rng, 16, 600, multi_hot_pad=8)),
              W.decode_aliccp_batch),
             (W.encode_batch(synthetic_criteo_batch(rng, 16, 400), 13),
              lambda b: W.decode_batch(b, 13))]
    assert cases[0][0][W.MHC_HI].shape[-1] == m // 8
    for wire, decode in cases:
        want = decode(to_device(wire, torch.device("cpu")))
        got = decode(to_device(wire, dev))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k].cpu(), want[k]), k
