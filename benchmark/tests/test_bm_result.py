"""A run's result line: the contract's keys only, the compared numbers
last; a cell without limits is never correct; the planted faults make a
run not correct."""

import json

import pytest
import torch

from bm_util import tiny_cell

from benchmark import correct, harness

CONTRACT = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def run_tiny(name, trace=False, fault=None, limits=None):
    r = harness.run(tiny_cell(name, limits), 2 ** 33 + 17, 0.2, trace, torch.device("cpu"),
                    harness.process_start_s(), fault=fault)
    return r, json.loads(harness.result_line(r))


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contract_keys_only(trace):
    r, line = run_tiny("deepfm.train.b128k", trace=trace)
    assert set(line) <= CONTRACT
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"train_examples_per_s", "peak_device_gib", "setup_s"}
    assert set(line["checks"]) == set(correct.NUMBERS)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_cell_without_limits_is_not_correct():
    r, line = run_tiny("deepfm.train.b128k", limits={})
    assert line["correct"] is False
    assert all(c["limit"] is None for c in line["checks"].values())


@pytest.mark.parametrize("name, fault", [
    ("deepfm.train.b128k", "state_unchanged"), ("deepfm.train.b128k", "half_batch"),
    ("din.train.aliccp", "state_unchanged"), ("din.train.aliccp", "half_batch"),
    ("din.train.aliccp", "attention_unchanged")])
def test_a_planted_fault_comes_out_not_correct(name, fault):
    """The rest of a run, past the look for a card, with the timed path
    broken underneath: the step leaves its state as it was, takes the
    mean over half the batch, or leaves DIN's attention weights
    unmoved."""
    sound, _ = run_tiny(name)
    assert sound["correct"] is True, sound["checks"]
    broken, line = run_tiny(name, fault=fault)
    assert line["correct"] is False, broken["checks"]
