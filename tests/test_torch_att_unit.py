"""DIN's attention unit (tf_repos_tpu_torch/ops/att_unit.py).

On the CPU: ``att_unit_plain`` is the composition models/din.py ran
before the fused op, bit for bit (the same ATen calls); the dispatch
sends every configuration the kernels do not compute, and CPU tensors,
to it; the fused op's autograd route, on the CPU through the kernel
entries' plain versions, gives att_unit_plain's weights and gradients;
DIN routes both of its attention paths through the fused op when the
dispatch allows it.

Marked ``cuda``: the fused kernels against att_unit_plain on the card,
the forward weight and all six gradients. Tolerances are those of a bf16
GEMM against itself: the kernels and cuBLAS sum the same bf16 products
in another order, so a product or gradient rounded to bf16 may differ
by one bf16 ulp (2^-8 relative) where the f32 sums straddle a rounding
boundary, and a ReLU gate may flip where the pre-activation is within
that of 0. So the weight is held per slot to a quarter (the sigmoid's
slope) of 2^-8 of sum_c |w2_c h_c| plus 1e-6, and each gradient
normwise to 2^-8 of its norm."""

import numpy as np
import pytest
import torch

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data import sparse_batch as TSB
from tf_repos_tpu_torch.data import synthetic as TS
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import att_unit as AU
from tf_repos_tpu_torch.ops import towers as T
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_unflatten

BF16_ULP = 2.0 ** -8


def _leaves(k, w, layers=1, batch_norm=False, seed=0):
    """att_mlp (and its state) and att_out as DIN initialises them, with a
    random bias so the ReLU's gate is not the product's sign alone."""
    gen = torch.Generator().manual_seed(seed)
    mlp, state = T.init_mlp(gen, 3 * k, [w] * layers, batch_norm=batch_norm)
    for lp in mlp["layers"]:
        lp["dense"]["b"] = 0.1 * torch.randn(w, generator=gen)
    out = T.init_dense(gen, w, 1)
    out["b"] = torch.full((1,), 0.05)
    return mlp, state, out


def _ua(n, k, seed=1, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn((n, k), generator=gen)
    a = torch.randn((n, k), generator=gen)
    return u.to(device), a.to(device)


def _old_att_mlp(mlp, state, out, x, *, keep_probs, train, generator, batch_norm, compute_dtype):
    """The body of DIN._att_mlp before the fused op, verbatim."""
    h, new_state = T.apply_mlp(
        mlp, state, x, keep_probs=keep_probs, train=train, generator=generator,
        batch_norm=batch_norm, bn_decay=0.9, compute_dtype=compute_dtype,
    )
    return torch.sigmoid(T.dense(out, h))[:, 0], new_state


def _grads(fn, tensors):
    xs = [t.detach().clone().requires_grad_(True) for t in tensors]
    y = fn(*xs)
    gy = torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)
    return y.detach(), torch.autograd.grad(y, xs, gy, allow_unused=True)


PLAIN_CASES = {
    "bf16": dict(compute_dtype="bfloat16"),
    "f32": dict(compute_dtype=None),
    "batch_norm": dict(compute_dtype="bfloat16", batch_norm=True),
    "two_layers": dict(compute_dtype="bfloat16", layers=2),
    "dropout": dict(compute_dtype="bfloat16", keep=0.5),
}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_is_the_composition_din_ran(case):
    kw = dict(PLAIN_CASES[case])
    layers, bn, keep = kw.pop("layers", 1), kw.pop("batch_norm", False), kw.pop("keep", 1.0)
    mlp, state, out = _leaves(16, 64, layers=layers, batch_norm=bn)
    u, a = _ua(37, 16)
    leaves = tree_leaves((mlp, out))

    def run(fn, cat):
        def f(u, a, *lv):
            m, o = tree_unflatten((mlp, out), list(lv))
            gen = torch.Generator().manual_seed(5)
            x = (torch.cat([u, u - a, a], dim=1),) if cat else (u, a)
            return fn(m, state, o, *x, keep_probs=[keep, keep], train=True, generator=gen,
                      batch_norm=bn, compute_dtype=kw["compute_dtype"])[0]
        return _grads(f, [u, a, *leaves])

    y0, g0 = run(_old_att_mlp, True)
    y1, g1 = run(AU.att_unit_plain, False)
    assert torch.equal(y0, y1)
    for x0, x1 in zip(g0, g1):
        assert torch.equal(x0, x1)


def test_plain_keeps_the_state():
    mlp, state, out = _leaves(16, 64, batch_norm=True)
    u, a = _ua(20, 16)
    _, s0 = _old_att_mlp(mlp, state, out, torch.cat([u, u - a, a], dim=1), keep_probs=[1.0],
                         train=True, generator=None, batch_norm=True, compute_dtype=None)
    _, s1 = AU.att_unit_plain(mlp, state, out, u, a, keep_probs=[1.0], train=True,
                              generator=None, batch_norm=True, compute_dtype=None)
    for x0, x1 in zip(tree_leaves(s0), tree_leaves(s1)):
        assert torch.equal(x0, x1)


# each case: what it changes from the DIN cell's configuration (K=32, one
# bf16 layer of 256, no batch norm, dropout off)
DISPATCH_CASES = {
    "din_cell": ({}, True),
    "din_large_vocab_width": (dict(k=16), True),
    "width_64": (dict(w=64), True),
    "eval_with_keep_half": (dict(train=False, keep=0.5), True),
    "f32_towers": (dict(compute_dtype=None), False),
    "active_dropout": (dict(keep=0.5), False),
    "batch_norm": (dict(batch_norm=True), False),
    "two_attention_layers": (dict(layers=2), False),
    "k_8": (dict(k=8), False),
    "width_96": (dict(w=96), False),
    "width_512": (dict(w=512), False),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch(case):
    over, want = DISPATCH_CASES[case]
    k, w = over.get("k", 32), over.get("w", 256)
    mlp, _, out = _leaves(k, w, layers=over.get("layers", 1))
    kw = dict(keep_probs=[over.get("keep", 1.0)], train=over.get("train", True),
              generator=torch.Generator(), batch_norm=over.get("batch_norm", False),
              compute_dtype=over.get("compute_dtype", "bfloat16"))
    assert AU.fused_config_ok(mlp, k=k, **kw) is want
    u, a = _ua(8, k)
    # CPU tensors always take the plain composition
    assert AU.fused_ok(mlp, out, u, a, **kw) is False


def test_dispatch_needs_f32_on_the_card():
    """fused_ok's device and dtype test, on stand-ins for card tensors."""

    class Card:
        def __init__(self, x, dtype=torch.float32):
            self.x, self.dtype, self.device = x, dtype, torch.device("cuda", 0)
            self.shape = x.shape

    mlp, _, out = _leaves(32, 256)
    kw = dict(keep_probs=[1.0], train=True, generator=None, batch_norm=False,
              compute_dtype="bfloat16")
    card = lambda d: {k: Card(v) for k, v in d.items()}  # noqa: E731
    cmlp = {"layers": [{"dense": card(mlp["layers"][0]["dense"])}]}
    u, a = _ua(8, 32)
    assert AU.fused_ok(cmlp, card(out), Card(u), Card(a), **kw) is True
    assert AU.fused_ok(cmlp, card(out), Card(u, torch.bfloat16), Card(a), **kw) is False
    assert AU.fused_ok(cmlp, out, Card(u), Card(a), **kw) is False


FUSED_CPU_CASES = [(0, 32, 256), (1, 32, 256), (129, 16, 64), (300, 32, 128), (257, 16, 192)]


@pytest.mark.parametrize("n,k,w", FUSED_CPU_CASES)
def test_fused_route_on_cpu_matches_plain(n, k, w):
    """The autograd Function through the kernel entries' plain versions:
    the same ATen calls as autograd takes through att_unit_plain, so the
    weights and gradients agree to the last bit but for the order of
    autograd's own sums (2 ulps of f32 in the gradients)."""
    mlp, state, out = _leaves(k, w)
    u, a = _ua(n, k)
    dense = mlp["layers"][0]["dense"]
    tensors = [u, a, dense["w"], dense["b"], out["w"], out["b"]]

    def plain(u, a, w1, b1, w2, b2):
        m = {"layers": [{"dense": {"w": w1, "b": b1}}]}
        return AU.att_unit_plain(m, state, {"w": w2, "b": b2}, u, a, keep_probs=[1.0],
                                 train=True, generator=None, compute_dtype="bfloat16")[0]

    before = (AU.att_unit_forward.launches, AU.att_unit_backward.launches)
    y0, g0 = _grads(plain, tensors)
    y1, g1 = _grads(AU.att_unit, tensors)
    assert (AU.att_unit_forward.launches, AU.att_unit_backward.launches) == before
    assert y1.shape == (n,) and torch.equal(y0, y1)
    for name, x0, x1 in zip(("du", "da", "dw1", "db1", "dw2", "db2"), g0, g1):
        assert x1.shape == x0.shape, name
        torch.testing.assert_close(x1, x0, rtol=2.5e-7, atol=1e-9, msg=name)


def _din(**over):
    cfg = Config(model="DIN", feature_size=400, field_size=11, embedding_size=16,
                 deep_layers="64,8", attention_layers="64", dropout="1.0,1.0", batch_size=16,
                 compute_dtype="bfloat16", multi_hot_pad=8, **over)
    model = create_model(cfg)
    params, state = model.init(torch.Generator().manual_seed(0))
    return model, params, state


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "coo_sorted"])
def test_din_takes_the_fused_op_where_the_dispatch_allows(packed, monkeypatch):
    """Both attention paths of DIN, with the device test of the dispatch
    set aside so the fused op runs on the CPU: the same loss and
    gradients as the plain composition, through one fused call a field
    (padded) or a step (COO)."""
    model, params, state = _din()
    rng = np.random.default_rng(3)
    lens = {k: v / 25 for k, v in TS.PUBLISHED_MH_AVG_LENS.items()}
    raw = TS.synthetic_aliccp_batch(rng, 16, 400, multi_hot_pad=8, avg_lens=lens, zipf_a=1.2)
    kw = {}
    if packed:
        raw = TSB.MhCooPacker(model.mh_coo_groups(), cdest_aux=True)(raw)
        kw = {"lookup": make_expand_lookup()}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in raw.items()}

    def loss_and_grads():
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), state, batch, train=True, **kw)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    l0, g0 = loss_and_grads()
    calls = []
    fused = AU.att_unit
    monkeypatch.setattr(AU, "fused_ok", lambda mlp, out, u, a, **k: AU.fused_config_ok(
        mlp, k=u.shape[-1], **k))
    monkeypatch.setattr(AU, "att_unit", lambda *x: calls.append(x[0].shape) or fused(*x))
    l1, g1 = loss_and_grads()
    assert len(calls) == (1 if packed else 4)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0.0)
    for x0, x1 in zip(g0, g1):
        torch.testing.assert_close(x1, x0, rtol=1e-5, atol=1e-8)


# ------------------------------------------------------------------ the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# the benchmark cell's point (N = the COO bucket, K = 32, W = 256); K = 16
# (din_large_vocab and the smoke's DIN point); ragged tails; N = 0; the
# other widths the kernels take
CARD_CASES = [(1_572_864, 32, 256), (1_310_720, 16, 256), (1, 32, 256), (127, 32, 256),
              (129, 32, 256), (100_003, 32, 256), (100_003, 16, 256), (0, 32, 256),
              (4_099, 32, 64), (4_099, 16, 128), (4_099, 32, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,w", CARD_CASES)
def test_fused_matches_plain_on_card(dev, n, k, w):
    mlp, state, out = _leaves(k, w)
    u, a = _ua(n, k, device=dev)
    dense = mlp["layers"][0]["dense"]
    tensors = [x.to(dev) for x in (u, a, dense["w"], dense["b"], out["w"], out["b"])]

    def plain(u, a, w1, b1, w2, b2):
        m = {"layers": [{"dense": {"w": w1, "b": b1}}]}
        return AU.att_unit_plain(m, state, {"w": w2, "b": b2}, u, a, keep_probs=[1.0],
                                 train=True, generator=None, compute_dtype="bfloat16")[0]

    def grads(fn):
        xs = [t.detach().clone().requires_grad_(True) for t in tensors]
        y = fn(*xs)
        gy = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
        return y.detach(), torch.autograd.grad(y, xs, gy)

    f0, b0 = AU.att_unit_forward.launches, AU.att_unit_backward.launches
    y1, g1 = grads(AU.att_unit)
    torch.cuda.synchronize()
    assert AU.att_unit_forward.launches == f0 + (1 if n else 0)
    assert AU.att_unit_backward.launches == b0 + (1 if n else 0)
    y0, g0 = grads(plain)
    assert y1.shape == (n,)
    # per slot: a quarter of one bf16 ulp of sum_c |w2_c h_c|
    _, _, h = AU.first_layer(*tensors[:3])
    scale = (torch.relu(h + tensors[3]) * tensors[4][:, 0]).abs().sum(1)
    gap = (y1 - y0).abs()
    room = 0.25 * BF16_ULP * scale + 1e-6
    assert bool((gap <= room).all()), float((gap - room).max())
    for name, x0, x1 in zip(("du", "da", "dw1", "db1", "dw2", "db2"), g0, g1):
        assert x1.shape == x0.shape and x1.dtype == torch.float32, name
        assert bool(torch.isfinite(x1).all()), name
        ref = float(torch.linalg.vector_norm(x0))
        err = float(torch.linalg.vector_norm(x1 - x0))
        assert err <= BF16_ULP * ref + 1e-12, (name, err, ref)


@pytest.mark.cuda
def test_fused_wrappers_reject_what_the_kernels_do_not_take(dev):
    mlp, _, out = _leaves(32, 256)
    u, a = _ua(64, 32, device=dev)
    w1, b1 = mlp["layers"][0]["dense"]["w"].to(dev), mlp["layers"][0]["dense"]["b"].to(dev)
    w2, b2 = out["w"].to(dev), out["b"].to(dev)
    with pytest.raises(ValueError, match="K=8"):
        AU.att_unit_forward(u[:, :8].contiguous(), a[:, :8].contiguous(), w1[:24], b1, w2, b2)
    with pytest.raises(ValueError, match="w1"):
        AU.att_unit_forward(u, a, w1[:, :96].contiguous(), b1[:96], w2[:96], b2)
    with pytest.raises(ValueError, match="contiguous f32"):
        AU.att_unit_forward(u.double(), a, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="one \\[N, K\\] shape"):
        AU.att_unit_forward(u, a[:3], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="b1"):
        AU.att_unit_forward(u, a, w1, b1[:8], w2, b2)
    s = AU.att_unit_forward(u, a, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="gw"):
        AU.att_unit_backward(s[:3], u, a, s, w1, b1, w2)
