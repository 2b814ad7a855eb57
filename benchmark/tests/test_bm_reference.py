"""The plain references against the port's plain CPU path: one step of
each configuration at a tiny size, from the same weights and batches,
and the traffic's seeds."""

import numpy as np
import pytest
import torch

from bm_util import TINY, tiny_cell

from benchmark import correct, reference, spec
from benchmark.program import Program, first_steps


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_matches_the_port_for_one_step(name):
    cell = tiny_cell(name)
    ref = reference.load(cell.config["reference"])
    raw = spec.make_pool(cell, 31, torch.device("cpu"), 1)
    prog = Program(cell.config, ref, 31, torch.device("cpu"))
    got = first_steps(prog, ref, cell.config, 31, [prog.stage(prog.map(b)) for b in raw], 1)
    want = ref.train(cell.config, 31, raw, torch.device("cpu"))
    g = correct.gaps(got, want)
    # bf16 tower products round alike; sums run in another order. DIN's
    # attention leaves, held to their own small gradients, read ~2e-4
    assert g["loss_gap"][0] < 1e-6, g
    assert g["grad_gap"][0] < 1e-4, g
    assert g["leaf_grad_gap"][0] < 1e-3, g
    assert g["grad_median_gap"][0] < 1e-4, g
    assert g["change_gap"][0] < 1e-3, g


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_seed_fixes_the_batches_and_not_their_shapes(name):
    cell = tiny_cell(name)
    a, b, c = (spec.make_pool(cell, s, torch.device("cpu"), 2) for s in (5, 5, 6))
    for x, y, z in zip(a, b, c):
        assert x.keys() == z.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].shape == z[k].shape
        live = [sum(int(np.count_nonzero(d[k])) for k in d if k.startswith("u_") and k.endswith("ids"))
                for d in (x, z)]
        assert live[0] == live[1]
    assert any(not np.array_equal(x["feat_ids"], z["feat_ids"]) for x, z in zip(a, c))
