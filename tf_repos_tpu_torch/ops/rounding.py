"""Stochastic rounding f32 -> bf16 (counterpart of the JAX package's
ops/rounding.py).

bf16 is the top 16 bits of an f32, so unbiased stochastic rounding is a
bit trick: add a uniform 16-bit integer to the f32 bit pattern and clear
the low 16 bits. E[round(x)] == x: an update smaller than half a bf16
ulp is lost every time under round-to-nearest, but lands with
probability |dx| / ulp here, so bf16 tables and moments keep their drift
in expectation. The lazy sparse path (train/sparse.py) writes its rows
through maybe_round under --param_dtype=bfloat16; row math stays f32.

The bits are those of the JAX package for the same noise: the sum wraps
as uint32 addition does (int32 two's complement), so 0x7F7FFFFF can round
up to inf and the all-ones NaN wraps to +0.0; a NaN that survives comes
out as the quiet NaN 0x7FC0 with its sign, as XLA's f32 -> bf16 cast
gives it. All noise is drawn by sr_noise, the one seam where a test
substitutes the bits JAX drew."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_LOW_MASK = -65536  # 0xFFFF0000 as an int32
_ABS = 0x7FFFFFFF
_INF_BITS = 0x7F800000
_QNAN_HI = 0x7FC0


def sr_noise(shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform integers in [0, 2^16), int32, drawn on ``device`` from
    ``generator`` (which must live there: noise is never drawn on one
    device and copied to another)."""
    return torch.randint(0, 1 << 16, tuple(shape), generator=generator, device=device,
                         dtype=torch.int32)


def round_bits(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """bf16 of ``x`` rounded with the given 16-bit noise (int32 tensor of
    x's shape, values in [0, 2^16))."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + noise.to(torch.int32)) & _LOW_MASK
    hi = rounded >> 16  # arithmetic: the int16 narrowing keeps the low 16 bits
    nan = (rounded & _ABS) > _INF_BITS
    hi = torch.where(nan, (hi & -32768) | _QNAN_HI, hi)
    return hi.to(torch.int16).view(torch.bfloat16)


def stochastic_round_bf16(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Unbiased f32 -> bf16 with noise from ``generator`` on x's device
    (required: the rounding never falls back to the global stream)."""
    if generator is None:
        raise ValueError("stochastic rounding to bf16 needs a generator on the tensor's device")
    return round_bits(x, sr_noise(x.shape, generator, x.device))


def maybe_round(x: torch.Tensor, generator: Optional[torch.Generator], dtype: torch.dtype) -> torch.Tensor:
    """Round to ``dtype``: stochastically for bf16 (the only case that
    draws noise), a plain cast otherwise."""
    if dtype == torch.bfloat16:
        return stochastic_round_bf16(x, generator)
    return x.to(dtype)
