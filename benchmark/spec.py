"""Cells, configurations and traffic mixes, found by name under this
folder: ``workloads/<cell>.json`` names its configuration and traffic
mix, ``configs/<config>.json`` and ``traffic/<mix>.json`` hold them, and
the mix names its generator, ``traffic/<generator>.py``, which has
``make_batches(seed, mix, vocab, count, device)``."""

from __future__ import annotations

import importlib
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(kind: str, name: str) -> Dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {os.path.relpath(path, os.path.dirname(HERE))}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    limits: Dict[str, Optional[float]]  # None: printed, not compared


def load_cell(name: str) -> Cell:
    w = load_json("workloads", name)
    return Cell(name=name, config=load_json("configs", w["config"]),
                traffic=load_json("traffic", w["traffic"]), chips=int(w["chips"]),
                limits={k: None if v is None else float(v) for k, v in w.get("limits", {}).items()})


def make_pool(cell: Cell, seed: int, device, n: int = 0) -> List[Dict[str, np.ndarray]]:
    """The cell's pool of raw batches (host arrays) from the seed, drawn
    on ``device`` where the generator can (the first ``n`` of them when
    n > 0): the same seed and device give the same batches."""
    gen = importlib.import_module(f"benchmark.traffic.{cell.traffic['generator']}")
    count = n or int(cell.traffic["pool"])
    return gen.make_batches(int(seed), cell.traffic, int(cell.config["feature_size"]), count, device)
