"""Fixtures of the benchmark's tests: a copy of the benchmark folder to
add files to, and the ``cuda`` marker for tests that need the card
(decided inside the ``card`` fixture)."""

from __future__ import annotations

import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark folder (without outputs) under tmp_path;
    returns the copy's root, which holds ``benchmark/``."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__", ".pytest_cache"))
    return tmp_path
