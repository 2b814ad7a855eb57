"""The comparison fails its controls: the reference put in the program's
place with the towers' GEMMs in float8 e4m3 (the nearest precision below
the configuration's bf16), and the program's own bf16 table path (the
nearest below its f32 store), at a tiny size on the CPU, against the
cells' own limits. The same readings at the cells' sizes on the card
come from ``benchmark/calibrate.py`` (PERF.md)."""

import pytest
import torch

from bm_util import TINY, tiny_cell

from benchmark import calibrate, correct, reference, spec

SEEDS = (5, 6, 7)
# DIN's f32 store feeds bf16 GEMMs and f32 pools alike, so in three steps
# its bf16 control reads within the spread of sound runs on some seeds
# (37 of 55 on the card fail, PERF.md); fp8 towers fail on every seed
CONTROLS = [("deepfm.train.b128k", "fp8_towers"), ("deepfm.train.b128k", "bf16_store"),
            ("din.train.aliccp", "fp8_towers")]


def judged(name, mode, seed):
    cell = tiny_cell(name)
    ref = reference.load(cell.config["reference"])
    raw = spec.make_pool(cell, seed, torch.device("cpu"), 3)
    base = ref.train(cell.config, seed, raw, torch.device("cpu"))
    got = calibrate.readings(mode, cell, ref, seed, raw, torch.device("cpu"))
    return correct.judge(correct.gaps(got, base), cell.limits)


@pytest.mark.parametrize("name, control", CONTROLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_a_control_is_not_correct(name, seed, control):
    ok, rows = judged(name, control, seed)
    assert not ok, rows


def test_dins_bf16_store_fails_on_a_share_of_seeds():
    fails = sum(not judged("din.train.aliccp", "bf16_store", seed)[0] for seed in range(1, 9))
    assert fails >= 2, fails


@pytest.mark.parametrize("seed", SEEDS)
def test_dins_reference_with_float64_pools_is_correct(seed):
    """The witness of the numbers' own swing: the reference, its attention
    pools summed in float64, in the program's place, within DIN's limits."""
    ok, rows = judged("din.train.aliccp", "f64_pools", seed)
    assert ok, rows


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_sound_program_is_correct(name, seed):
    ok, rows = judged(name, "sound", seed)
    assert ok, rows
