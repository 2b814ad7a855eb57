"""DIN's attention unit: the weight of each slot from its user-side row u
and its ad-side query a,

  att_unit(u[N,K], a[N,K], w1[3K,W], b1[W], w2[W,1], b2[1]) -> f32 [N]
      sigmoid(relu(bf16(bf16([u, u - a, a]) @ bf16(w1)) + b1) @ w2 + b2)

with every rounding point of the ATen chain that models/din.py ran
before (``att_unit_plain``: ops/towers.apply_mlp with bf16 GEMMs, then
the f32 output layer): bf16 GEMM operands with f32 sums, the product
rounded to bf16, the bias, ReLU, output layer and sigmoid in f32; in
the backward the GEMMs' gradients leave as bf16.

On the card the unit is one hand-written kernel each way
(``csrc/att_unit.cu``, nvcc for sm_90a, ctypes), and no [N, W] or
[N, 3K] tensor reaches device memory: the backward recomputes the first
layer. ``att_unit_forward`` and ``att_unit_backward`` are the kernel
entries; a CPU tensor goes to the plain PyTorch version beside each,
which repeats the kernel's arithmetic, and a CUDA tensor the kernel does
not take raises. Each entry counts its launches in ``launches`` (the
backward's one reduce launch a call is not counted); the plain versions
never count.

``fused_ok`` is the dispatch: the fused op takes one bf16 layer without
batch norm or active dropout, on f32 CUDA tensors, at 3K in {48, 96}
(the kernel holds its dW1 partial in registers) and W a multiple of 64
up to 256; everything else runs ``att_unit_plain``, the composition
unchanged."""

from __future__ import annotations

import ctypes
import functools

import torch

from tf_repos_tpu_torch.ops import build
from tf_repos_tpu_torch.ops import towers as T

FUSED_K = (16, 32)
FUSED_W = (64, 128, 192, 256)


# ------------------------------------------------------- the composition
def att_unit_plain(mlp, state, out, u, a, *, keep_probs, train, generator, batch_norm=False,
                   bn_decay=0.9, compute_dtype=None):
    """The attention MLP over [u, u - a, a] and its sigmoid output layer,
    as ATen ops: (weight [N], the MLP's new state)."""
    h, new_state = T.apply_mlp(
        mlp, state, torch.cat([u, u - a, a], dim=1), keep_probs=keep_probs, train=train,
        generator=generator, batch_norm=batch_norm, bn_decay=bn_decay,
        compute_dtype=compute_dtype,
    )
    return torch.sigmoid(T.dense(out, h))[:, 0], new_state


def fused_config_ok(mlp, *, k, keep_probs, train, generator, batch_norm, compute_dtype) -> bool:
    """Whether the configuration is the one the fused kernels compute: one
    layer, bf16 GEMMs, no batch norm, no active dropout (as apply_mlp
    draws it), and shapes the kernels take."""
    layers = mlp["layers"]
    if len(layers) != 1 or batch_norm or T._DTYPES.get(compute_dtype) is not torch.bfloat16:
        return False
    if train and generator is not None and keep_probs[0] < 1.0:
        return False
    kin, w = layers[0]["dense"]["w"].shape
    return k in FUSED_K and kin == 3 * k and w in FUSED_W


def fused_ok(mlp, out, u, a, *, keep_probs, train, generator, batch_norm, compute_dtype) -> bool:
    """fused_config_ok, and f32 tensors on the card."""
    if not fused_config_ok(mlp, k=u.shape[-1], keep_probs=keep_probs, train=train,
                           generator=generator, batch_norm=batch_norm,
                           compute_dtype=compute_dtype):
        return False
    dense = mlp["layers"][0]["dense"]
    return all(x.device.type == "cuda" and x.dtype == torch.float32
               for x in (u, a, dense["w"], dense["b"], out["w"], out["b"]))


# ------------------------------------------------------------ plain versions
def first_layer(u, a, w1):
    """(x, w1, x @ w1) as the plain versions form them: the bf16 input and
    weights, and the product rounded to bf16, returned in f32."""
    x = torch.cat([u, u - a, a], dim=1).to(torch.bfloat16)
    wb = w1.to(torch.bfloat16)
    return x, wb, (x @ wb).float()


def att_unit_forward_plain(u, a, w1, b1, w2, b2):
    _, _, h = first_layer(u, a, w1)
    return torch.sigmoid(torch.relu(h + b1) @ w2.reshape(-1, 1) + b2)[:, 0]


def att_unit_backward_plain(gw, u, a, s, w1, b1, w2):
    """(du, da, dw1, db1, dw2 [W,1], db2 [1]) as autograd takes them
    through att_unit_plain."""
    k = u.shape[1]
    x, wb, h = first_layer(u, a, w1)
    pre = h + b1
    r = torch.relu(pre)
    gs = gw * (1.0 - s) * s
    dw2 = r.t() @ gs[:, None]
    db2 = gs.sum().reshape(1)
    gpre = torch.where(r > 0, gs[:, None] * w2.reshape(1, -1), torch.zeros((), dtype=pre.dtype))
    db1 = gpre.sum(0)
    gb = gpre.to(torch.bfloat16)
    dx = (gb @ wb.t()).float()
    dw1 = (x.t() @ gb).float()
    du = dx[:, :k] + dx[:, k:2 * k]
    da = dx[:, 2 * k:] - dx[:, k:2 * k]
    return du, da, dw1, db1, dw2, db2


# ------------------------------------------------------------------ kernels
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("att_unit")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for f in (lib.tr_att_unit_tile, lib.tr_att_unit_fwd_blocks):
        f.argtypes = []
        f.restype = i
    lib.tr_att_unit_forward.argtypes = [p, p, ll, i, i, p, p, p, p, p, i, p]
    lib.tr_att_unit_forward.restype = i
    lib.tr_att_unit_backward.argtypes = [p, p, p, p, ll, i, i, p, p, p, p, p, p, ll, i, p]
    lib.tr_att_unit_backward.restype = i
    lib.tr_att_unit_reduce.argtypes = [p, i, ll, i, i, p, p, p, p, p]
    lib.tr_att_unit_reduce.restype = i
    return lib


@functools.cache
def _blocks(index: int):
    """(slots a tile, the forward's blocks a SM, SMs) of the card."""
    lib = _lib()
    return (lib.tr_att_unit_tile(), lib.tr_att_unit_fwd_blocks(),
            torch.cuda.get_device_properties(index).multi_processor_count)


def _grid(n: int, dev, forward: bool) -> int:
    """Persistent blocks, at most one a tile of slots."""
    tile, fwd_blocks, sms = _blocks(dev.index)
    return min(-(-n // tile), (fwd_blocks if forward else 1) * sms)


def _check(what, u, a, w1, b1, w2, b2=None):
    """u, a contiguous f32 [N, K] on one card; the leaves f32 beside them
    at the shapes the kernels take. Returns (N, K, W)."""
    dev = u.device
    if u.dim() != 2 or u.shape != a.shape:
        raise ValueError(f"{what}: u {tuple(u.shape)} and a {tuple(a.shape)} must be one "
                         "[N, K] shape")
    n, k = u.shape
    if k not in FUSED_K:
        raise ValueError(f"{what}: K={k} (the kernels take {FUSED_K})")
    if w1.dim() != 2 or w1.shape[0] != 3 * k or w1.shape[1] not in FUSED_W:
        raise ValueError(f"{what}: w1 {tuple(w1.shape)}, expected [{3 * k}, W] with W in {FUSED_W}")
    w = w1.shape[1]
    shapes = {"b1": (b1, (w,)), "w2": (w2, (w, 1)), "b2": (b2, (1,))}
    for name, x in (("u", u), ("a", a), ("w1", w1), *((nm, t) for nm, (t, _) in shapes.items()
                                                      if t is not None)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous f32 tensor on {dev} "
                             f"(got {x.dtype} on {x.device})")
    for name, (x, shape) in shapes.items():
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(x.shape)}, expected {shape}")
    for name, x in (("u", u), ("a", a), ("w1", w1)):
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    return n, k, w


def att_unit_forward(u, a, w1, b1, w2, b2):
    """The slots' weights, f32 [N]: one launch of the fused forward."""
    if u.device.type == "cpu":
        return att_unit_forward_plain(u, a, w1, b1, w2, b2)
    if u.device.type != "cuda":
        raise ValueError(f"att_unit_forward: unsupported device {u.device}")
    n, k, w = _check("att_unit_forward", u, a, w1, b1, w2, b2)
    out = torch.empty((n,), dtype=torch.float32, device=u.device)
    if n == 0:
        return out
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tr_att_unit_forward(
            u.data_ptr(), a.data_ptr(), n, k, w, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), _grid(n, u.device, True), stream,
        )
    build.check_rc("att_unit_forward", rc)
    att_unit_forward.launches += 1
    return out


def att_unit_backward(gw, u, a, s, w1, b1, w2):
    """(du, da, dw1, db1, dw2 [W,1], db2 [1]) from the weights' gradient
    gw [N] and the forward's weights s [N]: one launch of the fused
    backward, then one reduce of its per-block weight gradients."""
    if u.device.type == "cpu":
        return att_unit_backward_plain(gw, u, a, s, w1, b1, w2)
    if u.device.type != "cuda":
        raise ValueError(f"att_unit_backward: unsupported device {u.device}")
    n, k, w = _check("att_unit_backward", u, a, w1, b1, w2)
    for name, x in (("gw", gw), ("s", s)):
        if (x.device != u.device or x.dtype != torch.float32 or not x.is_contiguous()
                or tuple(x.shape) != (n,)):
            raise ValueError(f"att_unit_backward: {name} must be a contiguous f32 [{n}] tensor "
                             f"on {u.device}")
    dev = u.device
    dua = torch.empty((2, n, k), dtype=torch.float32, device=dev)
    du, da = dua[0], dua[1]
    kw = 3 * k * w
    wgrad = torch.empty((kw + 2 * w + 1,), dtype=torch.float32, device=dev)
    dw1, db1 = wgrad[:kw].view(3 * k, w), wgrad[kw:kw + w]
    dw2, db2 = wgrad[kw + w:kw + 2 * w].view(w, 1), wgrad[kw + 2 * w:]
    if n == 0:
        wgrad.zero_()
        return du, da, dw1, db1, dw2, db2
    grid = _grid(n, dev, False)
    stride = 3 * k * w + 2 * w + 2  # even: the partials' float2 stores
    part = torch.empty((grid, stride), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _lib()
        rc = lib.tr_att_unit_backward(
            u.data_ptr(), a.data_ptr(), gw.data_ptr(), s.data_ptr(), n, k, w, w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), du.data_ptr(), da.data_ptr(), part.data_ptr(), stride,
            grid, stream,
        )
        build.check_rc("att_unit_backward", rc)
        rc = lib.tr_att_unit_reduce(part.data_ptr(), grid, stride, 3 * k, w, dw1.data_ptr(),
                                    db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), stream)
    build.check_rc("att_unit_backward (reduce)", rc)
    att_unit_backward.launches += 1
    return du, da, dw1, db1, dw2, db2


att_unit_forward.launches = 0
att_unit_backward.launches = 0


def reset_launches() -> None:
    att_unit_forward.launches = 0
    att_unit_backward.launches = 0


# ------------------------------------------------------- differentiable op
class _AttUnit(torch.autograd.Function):
    """Forward: the fused forward; backward: the fused backward, which
    recomputes the first layer from u, a and w1 (nothing [N, W] is kept)."""

    @staticmethod
    def forward(ctx, u, a, w1, b1, w2, b2):
        s = att_unit_forward(u, a, w1, b1, w2, b2)
        ctx.save_for_backward(u, a, w1, b1, w2, s)
        return s

    @staticmethod
    def backward(ctx, gw):
        u, a, w1, b1, w2, s = ctx.saved_tensors
        return att_unit_backward(gw.contiguous(), u, a, s, w1, b1, w2)


def att_unit(u, a, w1, b1, w2, b2):
    """The fused unit's weights [N], differentiable in all six inputs."""
    return _AttUnit.apply(u, a, w1, b1, w2, b2)


def apply(mlp, state, out, u, a, *, keep_probs, train, generator, batch_norm=False,
          bn_decay=0.9, compute_dtype=None):
    """DIN's attention weight per slot, (weight [N], the MLP's new state):
    the fused op where ``fused_ok`` holds, else att_unit_plain."""
    if fused_ok(mlp, out, u, a, keep_probs=keep_probs, train=train, generator=generator,
                batch_norm=batch_norm, compute_dtype=compute_dtype):
        dense = mlp["layers"][0]["dense"]
        wgt = att_unit(*(x.contiguous()
                         for x in (u, a, dense["w"], dense["b"], out["w"], out["b"])))
        return wgt, {"layers": [{}]}
    return att_unit_plain(mlp, state, out, u, a, keep_probs=keep_probs, train=train,
                          generator=generator, batch_norm=batch_norm, bn_decay=bn_decay,
                          compute_dtype=compute_dtype)
