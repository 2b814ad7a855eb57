"""Without a card a run fails and prints no result: no fall back to the
CPU. Without the port beside it (only BENCHMARK.json and benchmark/) a
run fails too."""

import os
import shutil
import subprocess
import sys

from bm_util import BENCH, ROOT


def run_py(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "deepfm.train.b128k",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_no_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = run_py(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
