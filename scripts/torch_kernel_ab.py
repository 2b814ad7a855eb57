#!/usr/bin/env python3
"""Time the PyTorch port's K5 sorted_segsum and K8 field_block_scatter
against another checkout's designs of the same kernels, on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py --baseline=DIR [--variant=DIR ...] [--out=FILE]

DIR is another checkout of this repository (for instance the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Its ``tf_repos_tpu_torch/ops/{sorted_seg,field_block}.py`` are
loaded beside this tree's, with their kernels built by nvcc from DIR's
``ops/csrc`` into ``DIR/_ab_build/``, so each side is timed through its own
wrapper: argument checks, output allocation and zero fill included, as
``chip_smoke.py`` times a kernel. Each --variant DIR (another design of
the same kernels, in the same layout) is loaded and timed the same way.

Points, the inputs of ``chip_smoke.py``'s kernel phases: K5 at DIN's
published point at n_out = G (the pool) and n_out = Su (the
--coo_sorted_bwd runs, where the TPU ran sorted_segsum_packed); K8 at the
DeepFM point in bf16 mode. Each point is held to its plain version on
every side (the chip_smoke tolerance), then timed with CUDA events over
50 back-to-back calls (``chip_smoke.cuda_ms``) in the order baseline,
this tree, the variants, then the same backwards; the plain version
once. Every time goes to the log and, as one JSON object, to stdout and
to --out, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402
from tf_repos_tpu_torch.ops import build  # noqa: E402
from tf_repos_tpu_torch.ops import field_block as FB  # noqa: E402
from tf_repos_tpu_torch.ops import sorted_seg as SG  # noqa: E402


class _BaselineBuild:
    """ops/build.py for another checkout: load() compiles that checkout's
    csrc/<name>.cu with the same nvcc flags; everything else is this
    tree's build module."""

    def __init__(self, root: str):
        self.csrc = os.path.join(root, "tf_repos_tpu_torch", "ops", "csrc")
        self.libdir = os.path.join(root, "_ab_build")

    def __getattr__(self, name):
        return getattr(build, name)

    def load(self, name: str) -> ctypes.CDLL:
        os.makedirs(self.libdir, exist_ok=True)
        out = os.path.join(self.libdir, f"lib{name}.so")
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", out,
                        os.path.join(self.csrc, f"{name}.cu")], check=True, capture_output=True)
        return ctypes.CDLL(out)


def baseline_module(root: str, name: str):
    """DIR's ops/<name>.py as a module of its own, building from DIR."""
    path = os.path.join(root, "tf_repos_tpu_torch", "ops", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = _BaselineBuild(root)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="another checkout of this repository")
    ap.add_argument("--variant", action="append", default=[], help="another design, timed beside")
    ap.add_argument("--out", help="also write the JSON report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    CS.log(card)
    build.build_all()
    sides = {"baseline": args.baseline, **{d: d for d in args.variant}}
    mods = {side: {n: baseline_module(d, n) for n in ("sorted_seg", "field_block")}
            for side, d in sides.items()}
    mods["this tree"] = {"sorted_seg": SG, "field_block": FB}
    order = ["baseline", "this tree", *args.variant]

    pt = CS.din_point(dev)
    _, ids, g = CS.field_block_point(dev)
    fb_args = (CS.WIDTH["feature_size"], CS.FB_OFFSETS, CS.FB_SIZES, True)
    points = {
        "sorted_segsum (n_out=G)": ("sorted_seg", "sorted_segsum", (pt["vals"], pt["cdest"], pt["g"])),
        "sorted_segsum (n_out=Su)": ("sorted_seg", "sorted_segsum", (pt["sct"], pt["cidx"], pt["su"])),
        "field_block_scatter (bf16 mode)": ("field_block", "field_block_scatter", (ids, g, *fb_args)),
    }
    report = {"card": card, "points": {}}
    for label, (mod, fn, a) in points.items():
        plain = getattr(SG if mod == "sorted_seg" else FB, f"{fn}_plain")
        want = plain(*a)
        scale = plain(a[0].abs(), *a[1:]) if mod == "sorted_seg" else plain(a[0], a[1].abs(), *a[2:])
        call = {side: getattr(mods[side][mod], fn) for side in order}
        for side in order:
            CS.held(f"{label} {side}", call[side](*a), want, scale)
        times = {side: [] for side in order}
        for side in order + order[::-1]:
            times[side].append(CS.cuda_ms(lambda f=call[side]: f(*a)))
        row = {"ms": times, "plain_ms": CS.cuda_ms(lambda: plain(*a))}
        CS.log(f"{label}: " + ", ".join(f"{s} {t[0]:.4f} / {t[1]:.4f} ms" for s, t in times.items())
               + f", plain {row['plain_ms']:.4f} ms")
        report["points"][label] = row
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
