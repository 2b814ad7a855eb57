"""Pieces shared by the plain references: seeded initial weights made on
the device, bf16 tower GEMMs, the log loss, Adam (dense, and lazy on
the rows a batch touches) and the readings the correctness check
compares. Plain torch operations, float32 unless a configuration states
bf16 for a GEMM."""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
_LO, _HI = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))


def strict_f32() -> None:
    """float32 products in float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def generator(seed: int, device) -> torch.Generator:
    """The weights' generator: one Philox stream on the device, from the
    run's seed (any whole number; folded into 63 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def glorot_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """tf.glorot_normal_initializer: a normal truncated at 2 sigma (by its
    inverse CDF), stddev sqrt(2 / (fan_in + fan_out)) / 0.87962566; a 1-D
    shape uses fan_in = fan_out = shape[0]."""
    fan_in, fan_out = (shape[0], shape[0]) if len(shape) == 1 else (shape[-2], shape[-1])
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566
    u = torch.rand(tuple(shape), generator=gen, device=device)
    x = math.sqrt(2.0) * torch.erfinv(_LO + (_HI - _LO) * u)
    return x.clamp_(-2.0, 2.0).mul_(std)


def glorot_uniform(gen: torch.Generator, d_in: int, d_out: int, device) -> torch.Tensor:
    limit = math.sqrt(6.0 / (d_in + d_out))
    return (2.0 * torch.rand((d_in, d_out), generator=gen, device=device) - 1.0) * limit


def dense_init(gen, d_in: int, d_out: int, device) -> Dict[str, torch.Tensor]:
    return {"w": glorot_uniform(gen, d_in, d_out, device),
            "b": torch.zeros((d_out,), device=device)}


def mlp_init(gen, d_in: int, widths: Sequence[int], device) -> Dict:
    dims = [d_in, *widths]
    return {"layers": [{"dense": dense_init(gen, a, b, device)} for a, b in zip(dims[:-1], dims[1:])]}


# ------------------------------------------------------------------ math
def mm_tower(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """A tower GEMM in the configuration's precision: "bfloat16" is torch's
    bf16 GEMM (bf16 inputs and product, f32 accumulation), returned as f32;
    "fp8" (the control) first rounds both inputs to float8 e4m3 with one
    scale a tensor, then does the same."""
    if precision == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's largest finite value (448); the gradient passes
    through the rounding unchanged."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


def mlp(p: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """[dense -> relu] per layer, no dropout (keep 1.0), no batch norm."""
    for layer in p["layers"]:
        x = torch.relu(mm_tower(x, layer["dense"]["w"], precision) + layer["dense"]["b"])
    return x


def dense_f32(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def log_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    per = torch.nn.functional.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ----------------------------------------------------------------- trees
def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


# ------------------------------------------------------------------ step
def train(params: Dict, table: str, lr: float, batches: List, loss_fn, touched_fn) -> Dict:
    """``len(batches)`` training steps of the configuration from ``params``
    (updated in place): the loss's gradient by autograd, lazy Adam on the
    table rows each batch touches (``touched_fn(batch)``: ascending row
    ids; untouched rows keep w, m and v; the bias correction counts every
    step), Adam on every other leaf. Returns the readings: each step's
    loss, each leaf's gradient norm at step 1, the norm of each leaf's
    change after the last step, and each leaf's number of elements."""
    start = {n: t.detach().clone() for n, t in named_leaves(params)}
    leaves = dict(named_leaves(params))
    m = {n: torch.zeros_like(t) for n, t in leaves.items()}
    v = {n: torch.zeros_like(t) for n, t in leaves.items()}
    out = {"loss": [], "grad": {}, "change": {}, "numel": {n: t.numel() for n, t in leaves.items()}}
    for t, batch in enumerate(batches, start=1):
        for x in leaves.values():
            x.requires_grad_(True)
        rows = touched_fn(batch)
        loss = loss_fn(params, batch, rows)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        out["loss"].append(float(loss.detach()))
        if t == 1:
            out["grad"] = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
        c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
        with torch.no_grad():
            for n, x in leaves.items():
                x.requires_grad_(False)
                g = grads[n]
                if n == table:
                    g, mm, vv, w = g[rows], m[n][rows], v[n][rows], x[rows]
                else:
                    mm, vv, w = m[n], v[n], x
                mm = B1 * mm + (1.0 - B1) * g
                vv = B2 * vv + (1.0 - B2) * g * g
                w = w - lr * (mm / c1) / (torch.sqrt(vv / c2) + EPS)
                if n == table:
                    m[n][rows], v[n][rows], x[rows] = mm, vv, w
                else:
                    m[n], v[n] = mm, vv
                    x.copy_(w)
    out["change"] = {n: float(torch.linalg.vector_norm(x.detach() - start[n]))
                     for n, x in leaves.items()}
    return out
