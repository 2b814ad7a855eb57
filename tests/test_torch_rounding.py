"""Stochastic rounding f32 -> bf16 (tf_repos_tpu_torch/ops/rounding.py)
against the JAX package's ops/rounding.py, on the CPU: given the bits
JAX drew (``jax.random.bits(key) & 0xFFFF``) the port's result is the
same bf16 bit for bit, on the edge values (infinities, NaNs with their
payloads, the all-ones NaN that wraps to +0, 0x7F7FFFFF that rounds up
to inf, -0.0, subnormals, negatives) and on random bit patterns; the
rounding is unbiased; exact bf16 values are fixed points; maybe_round
draws only for bf16; a missing generator raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.ops import rounding as JR
from tf_repos_tpu_torch.ops import rounding as R

EDGE = np.array([
    0x7F800000, 0xFF800000,              # +-inf
    0x7FC00000, 0xFFC00000, 0x7FC10000,  # quiet NaNs, one with a payload
    0x7F800001, 0x7F80FFFF, 0x7FA00000,  # signalling NaNs (may round to inf)
    0xFFA12345, 0x7FBFFFFF, 0x7FFFFFFF,
    0xFFFFFFFF,                          # the all-ones NaN: wraps to +0.0
    0x7F7FFFFF, 0xFF7FFFFF,              # the largest finite: may round to inf
    0x00000000, 0x80000000,              # +-0.0
    0x00000001, 0x807FFFFF, 0x00008000,  # subnormals
    0x3F800000, 0xBF800001, 0x3F80FFFF, 0xC2C80000,
], np.uint32)


def _jax(x: np.ndarray, key) -> np.ndarray:
    return np.asarray(JR.stochastic_round_bf16(jnp.asarray(x), key)).view(np.uint16)


def _bits(key, shape) -> np.ndarray:
    return np.asarray(jax.random.bits(key, shape, jnp.uint32) & jnp.uint32(0xFFFF)).astype(np.int32)


def _port(x: np.ndarray, noise: np.ndarray) -> np.ndarray:
    out = R.round_bits(torch.from_numpy(x.copy()), torch.from_numpy(noise))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == x.shape
    return out.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("noise", [0, 1, 0x7FFF, 0x8000, 0xFFFF])
def test_edge_values_bit_exact_at_fixed_noise(noise):
    """Every edge value at the noise extremes, against JAX's own add, mask
    and cast on the same noise (JAX's function draws its noise, so the
    arithmetic is spelled out here with a constant)."""
    x = EDGE.view(np.float32)
    bits = jax.lax.bitcast_convert_type(jnp.asarray(x), jnp.uint32)
    rounded = (bits + jnp.uint32(noise)) & jnp.uint32(0xFFFF0000)
    want = np.asarray(jax.lax.bitcast_convert_type(rounded, jnp.float32)
                      .astype(jnp.bfloat16)).view(np.uint16)
    got = _port(x, np.full(x.shape, noise, np.int32))
    np.testing.assert_array_equal(got, want)


def test_edge_and_random_bits_match_jax_given_its_noise():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.repeat(EDGE, 97),
                        rng.integers(0, 2 ** 32, 200_000, dtype=np.uint32)]).view(np.float32)
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(_port(x, _bits(key, x.shape)), _jax(x, key))
    # named cases: the wrap, the round-up to inf, -0.0
    one = np.array([0xFFFFFFFF, 0x7F7FFFFF, 0x80000000], np.uint32).view(np.float32)
    got = _port(one, np.full(3, 0xFFFF, np.int32))
    assert got.tolist() == [0x0000, 0x7F80, 0x8000]


def test_two_dimensional_rows_match_jax():
    """The shape the optimizers round: an [S, 3K] block of row values."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((37, 48)) * 10.0 ** rng.integers(-8, 3, (37, 48))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(_port(x, _bits(key, x.shape)), _jax(x, key))


def test_exact_bf16_values_are_fixed_points():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(50_000).astype(np.float32)).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(R.stochastic_round_bf16(x.float(), gen).view(torch.int16).numpy(),
                                  x.view(torch.int16).numpy())


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.9])
def test_unbiased(frac):
    """x sits ``frac`` of a bf16 ulp above 1.0: it rounds up with
    probability frac, and the mean of the rounded values is x."""
    ulp = 2.0 ** -7
    n = 200_000
    x = torch.full((n,), 1.0 + frac * ulp, dtype=torch.float32)
    out = R.stochastic_round_bf16(x, torch.Generator().manual_seed(4)).float()
    assert set(np.unique(out.numpy()).tolist()) <= {1.0, 1.0 + ulp}
    up = float((out > 1.0).float().mean())
    assert abs(up - frac) < 0.01, up
    assert abs(float(out.double().mean()) - (1.0 + frac * ulp)) < 0.01 * ulp


def test_maybe_round_draws_only_for_bf16(monkeypatch):
    calls = []

    def noise(shape, generator, device):
        calls.append(tuple(shape))
        return torch.zeros(shape, dtype=torch.int32)

    monkeypatch.setattr(R, "sr_noise", noise)
    x = torch.tensor([1.0 + 2.0 ** -9, -3.5])
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(R.maybe_round(x, gen, torch.float32), x)
    assert calls == []
    out = R.maybe_round(x, gen, torch.bfloat16)
    assert calls == [(2,)] and out.dtype == torch.bfloat16
    assert out.float().tolist() == [1.0, -3.5]  # zero noise truncates


def test_missing_generator_raises():
    with pytest.raises(ValueError, match="needs a generator"):
        R.maybe_round(torch.ones(3), None, torch.bfloat16)
    # a plain cast needs none
    assert R.maybe_round(torch.ones(3), None, torch.float32).dtype == torch.float32


def test_noise_is_16_bit_on_the_generators_device():
    gen = torch.Generator().manual_seed(7)
    n = R.sr_noise((1000, 3), gen, "cpu")
    assert n.dtype == torch.int32 and n.shape == (1000, 3)
    assert int(n.min()) >= 0 and int(n.max()) < 65536 and int(n.max()) > 60000
    # same seed, same stream
    again = R.sr_noise((1000, 3), torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(n, again)
