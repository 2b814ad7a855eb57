"""The readers of the port's spans (``*_ms.train``, ``metrics/_spans.py``):
a traced run of each tiny cell on the CPU reports every span metric
whose ``workloads`` take the cell and no other; the step's forward,
backward and optimizer lie within the window's time a step; a port
without the recorder reads nothing and does not raise."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from bm_util import ROOT

SPAN_METRICS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train", "embed_ms.train",
                "fm_ms.train", "attention_ms.train", "towers_ms.train")


def _per_layer():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return {m["name"]: m for m in json.load(f)["per_layer"]}


def _traced_line(name: str, prelude: str = "") -> dict:
    """A traced run of the tiny form of cell ``name`` in a process of its
    own (the recorder is the process's), its result line."""
    code = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "benchmark", "tests")!r}]
        import torch
        {prelude}
        from bm_util import tiny_cell
        from benchmark import harness
        r = harness.run(tiny_cell({name!r}), 2 ** 33 + 5, 0.3, True, torch.device("cpu"),
                        harness.process_start_s())
        print(harness.result_line(r))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["deepfm.train.b128k", "din.train.aliccp"])
def test_a_traced_run_reports_the_span_metrics_of_its_cell(name):
    line = _traced_line(name)
    assert line["correct"] is True
    metrics, per_layer = line["metrics"], _per_layer()
    for m in SPAN_METRICS:
        want = name in per_layer[m].get("workloads", [name])
        assert (m in metrics) == want, m
        if want:
            assert metrics[m]["unit"] == "ms/step" and metrics[m]["value"] > 0
    step = sum(metrics[m]["value"] for m in ("forward_ms.train", "backward_ms.train",
                                            "optimizer_ms.train"))
    assert step <= 1e3 * line["device"]["window_s"] / line["attempted"]
    model = sum(metrics[m]["value"] for m in SPAN_METRICS[3:] if m in metrics)
    assert model <= metrics["forward_ms.train"]["value"] + metrics["backward_ms.train"]["value"]


def test_a_port_without_spans_reads_nothing():
    """The port as it was before its spans: the span is a no-op and the
    recorder is gone; the traced run goes through and reports none of
    these."""
    prelude = textwrap.dedent('''
        from tf_repos_tpu_torch.utils import observability as O
        from tf_repos_tpu_torch.train import sparse
        from tf_repos_tpu_torch.models import deepfm
        class _Off:
            def __enter__(self):
                return self
            def __exit__(self, *exc):
                return False
            def backward_half(self, *a):
                pass
        for mod in (sparse, deepfm):
            mod.span = lambda *a, **k: _Off()
        del O.RECORDER
    ''').replace("\n", "\n        ")
    line = _traced_line("deepfm.train.b128k", prelude)
    assert line["correct"] is True and line["attempted"] > 0
    assert not set(SPAN_METRICS) & set(line["metrics"])


def test_a_reader_reads_nothing_where_one_of_its_spans_is_missing(monkeypatch):
    """A sum that lost one of its spans (a ``.bwd`` half that stopped
    recording) falls silent rather than reading a fall."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from benchmark.metrics import _spans
    from tf_repos_tpu_torch.utils import observability as O

    monkeypatch.setattr(O, "RECORDER", O.SpanRecorder())
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with O.span("step"):
                with O.span("model.fm"):
                    pass
    trace = SimpleNamespace(steps=2)
    assert _spans.ms_per_step(trace, ("model.fm",)) > 0
    assert _spans.ms_per_step(trace, ("model.fm", "model.fm.bwd")) is None
    assert _spans.ms_per_step(SimpleNamespace(steps=3), ("model.fm",)) is None
