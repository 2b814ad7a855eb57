"""Every cell of BENCHMARK.json resolves by name to its files, and a new
configuration, traffic mix, cell and per-layer metric are found as new
files, with no file edited."""

import json
import os
import subprocess
import sys
import textwrap

from bm_util import BENCH, ROOT, TINY, TINY_FIELDS, write_json

from benchmark import correct, reference, spec
from benchmark import metrics as M


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_by_name():
    b = bench_json()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            own = json.load(f)
        assert (own["config"], own["traffic"], own["chips"]) == (w["config"], w["traffic"], w["chips"])
        assert cell.config == spec.load_json("configs", w["config"])
        assert os.path.join(ROOT, configs[w["config"]]["file"]) == os.path.join(
            BENCH, "configs", w["config"] + ".json")
        assert configs[w["config"]]["source"] == cell.config["source"]
        assert configs[w["config"]]["reduced"] == cell.config["reduced"]
        assert reference.load(cell.config["reference"]).TABLE
        assert os.path.isfile(os.path.join(BENCH, "traffic", cell.traffic["generator"] + ".py"))
        assert set(cell.limits) == set(correct.NUMBERS)
        assert any(v is not None for v in cell.limits.values())


def test_every_per_layer_metric_has_a_reader():
    readers = M.load_all()
    for m in bench_json()["per_layer"]:
        assert m["name"] in readers
        assert readers[m["name"]].UNIT == m["unit"]
    assert set(readers) == {m["name"] for m in bench_json()["per_layer"]}


def test_a_cell_added_as_new_files_runs_unedited(bench_copy):
    """New config, traffic mix, cell and metric files in a copy; the copy's
    harness runs the new cell (on the CPU, past the look for a card) and
    reports the new metric."""
    root = bench_copy
    before = {p: open(p, "rb").read() for p in _files(root / "benchmark")}
    cfg = dict(spec.load_json("configs", "deepfm_criteo"), **TINY["deepfm.train.b128k"][0])
    write_json(root / "benchmark/configs/tiny_deepfm.json", cfg)
    mix = dict(spec.load_json("traffic", "criteo_b128k"), batch_size=256, pool=3, fields=TINY_FIELDS)
    write_json(root / "benchmark/traffic/tiny_mix.json", mix)
    write_json(root / "benchmark/workloads/tiny.new_cell.json",
               {"config": "tiny_deepfm", "traffic": "tiny_mix", "chips": 1, "why": "a test",
                "limits": {"loss_gap": 1e-3, "loss1_gap": 1e-3, "grad_gap": 1e-2, "leaf_grad_gap": 1e-2,
                           "grad_median_gap": 1e-2, "change_gap": 1e-2}})
    (root / "benchmark/metrics/steps_seen.test.py").write_text(textwrap.dedent('''
        UNIT = "steps"
        def read(trace):
            return float(trace.steps) if trace.steps else None
    '''))
    code = textwrap.dedent(f'''
        import json, sys
        sys.path[:0] = [{str(root)!r}, {ROOT!r}]
        import torch, benchmark
        assert benchmark.__file__.startswith({str(root)!r})
        from benchmark import harness, spec
        r = harness.run(spec.load_cell("tiny.new_cell"), 7, 0.3, True, torch.device("cpu"),
                        harness.process_start_s())
        print(harness.result_line(r))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["steps_seen.test"]["value"] >= 1
    for p, data in before.items():
        assert open(p, "rb").read() == data, f"{p} was edited"


def _files(top):
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if "__pycache__" not in d]
