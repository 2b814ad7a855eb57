"""Per-layer metric readers, one file each, named as the metric is in
BENCHMARK.json. A reader has ``UNIT`` and ``read(trace) -> float | None``
(None: nothing to read in this cell, and the metric is left out), and
may name ``ENTRIES``, {(module, function): summarize}, kernel entries of
the port whose calls the traced window records into ``trace.calls``."""

from __future__ import annotations

import importlib.util
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))


def load_all() -> Dict[str, object]:
    """{metric name: reader module} for every reader file here."""
    out = {}
    for f in sorted(os.listdir(HERE)):
        if not f.endswith(".py") or f.startswith("_"):
            continue
        name = f[:-3]
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(out)}", os.path.join(HERE, f))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out
