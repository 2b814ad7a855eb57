#!/usr/bin/env python3
"""Repeat chip_smoke.py's card-vs-CPU trajectories with the card's ReLU
gates replayed on the CPU, and count how often the CPU's own gates part
from the card's, on one NVIDIA GPU.

    python3 scripts/torch_gate_flips.py [--repeats=12] [--which=din,deepfm,lazy,zoo,esmm]

Each trajectory is chip_smoke.card_vs_cpu with its gate replay on (the
card's run records its gates, one CPU run takes its own, a third replays
the card's): 5 steps from the same weights and batches. The card sums
some gradients with atomics, in a new order on each run, so a ReLU
pre-activation within f32 round-off of 0 may take another gate on a
later repeat; under Adam one flipped gate can move a table element by
the learning rate. Per repeat the script prints card_vs_cpu's lines;
at the end, per trajectory, the count of differing gates in each repeat,
the repeats whose own-gate weights lie more than 1e-4 from the card's,
and the largest store and dense differences on the CPU's own gates and
on the card's, as one JSON object with the card's name and power limit.
--which picks the trajectories (din by default; zoo includes OPNN, about
a minute a repeat). A held check that fails stops the script with code 1,
as in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

GROUPS = {"din": cs.din_trajectory, "deepfm": cs.trajectory, "lazy": cs.lazy_trajectory,
          "zoo": cs.zoo_trajectory, "esmm": cs.esmm_trajectory}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=12)
    ap.add_argument("--which", default="din", help=",".join(GROUPS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(card)
    cs.build.build_all()

    seen = defaultdict(list)
    gated = cs.card_vs_cpu

    def replayed(label, cfg, mapped, dev, dense, gates=False):
        res = gated(label, cfg, mapped, dev, dense, gates=True)
        seen[label].append(res)
        return res

    cs.card_vs_cpu = replayed
    for rep in range(args.repeats):
        cs.log(f"repeat {rep}")
        for name in args.which.split(","):
            GROUPS[name](dev)

    summary = {}
    for label, runs in seen.items():
        summary[label] = {
            "flips": [r["flips"] for r in runs],
            "own_gate_weights_over_1e-4": sum(max(r["own"][1], r["own"][2]) > 1e-4 for r in runs),
            "own_store_max": max(r["own"][1] for r in runs),
            "own_dense_max": max(r["own"][2] for r in runs),
            "held_store_max": max(r["held"][1] for r in runs),
            "held_dense_max": max(r["held"][2] for r in runs),
        }
        cs.log(f"{label}: {summary[label]}")
    print(json.dumps({"card": card, "repeats": args.repeats, "trajectories": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
