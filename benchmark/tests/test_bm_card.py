"""On the card: each cell runs briefly and comes out correct, with the
end-to-end metrics, and traced with the per-layer ones its
BENCHMARK.json entries list."""

import json
import os
import subprocess
import sys

import pytest

from bm_util import ROOT


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_on_the_card(card, trace):
    b = cells()
    for w in b["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w["name"], "--seed",
                              "2147483659", "--seconds", "2", "--trace", str(trace)],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu"
        want = ({m["name"] for m in b["end_to_end"]} if not trace else
                {m["name"] for m in b["per_layer"] if w["name"] in m.get("workloads", [w["name"]])})
        assert set(line["metrics"]) == want
