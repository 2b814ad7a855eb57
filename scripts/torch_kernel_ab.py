#!/usr/bin/env python3
"""Time the PyTorch port's K1 expand_rows, K3 coo_pool_rows, K4
coo_accumulate_rows, K5 sorted_segsum and K8 field_block_scatter against
another checkout's designs of the same kernels, on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py --baseline=DIR [--variant=DIR ...] [--source=NAME ...]
                                       [--out=FILE]

DIR is another checkout of this repository (for instance the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Its ``tf_repos_tpu_torch/ops/{sparse_rows,coo_pool,sorted_seg,
field_block}.py`` are loaded beside this tree's, with their kernels
built by nvcc from DIR's ``ops/csrc`` into ``DIR/_ab_build/`` at first
use, so each side is timed through its own wrapper: argument checks,
output allocation and zero fill included, as ``chip_smoke.py`` times a
kernel. Each --variant DIR (another design of the same kernels, in the
same layout) is loaded and timed the same way.

Points, the inputs of ``chip_smoke.py``'s kernel phases: K1 at its six
shapes (DeepFM serving, the 26 dynamic fields of 512 Zipf(1.2) rows over
a [117,581, 17] table; ESMM/DIN serving, the 2,574 ids of each of 64
rows at the published point over a [4.5M, 16] table; the DIN COO lookup
and, under --coo_sorted_bwd, its [M, K] cotangent gathered into
idx-sorted order; the ESMM point; DeepFM training), and at the two serving
shapes each side's whole serving gather (make_serving_lookup: the
earlier normalize_ids + K1, or the one launch); K3 and K4 at the ESMM
published point (K4 shares K3's source file and is the control: its code
is the same on both sides); K5 at DIN's published point at n_out = G
(the pool) and n_out = Su (the --coo_sorted_bwd runs, where the TPU ran
sorted_segsum_packed); K8 at the DeepFM point in bf16 mode. --source
keeps the kernels of ``ops/NAME.py`` (sparse_rows, coo_pool, sorted_seg,
field_block; all by default). Each point is held to its plain version on
every side (K1 bit-exact, the others to the chip_smoke tolerance), then
timed with CUDA events over 50 back-to-back calls
(``chip_smoke.cuda_ms``) in the order baseline, this tree, the variants,
then the same backwards; the plain version once, and for K1 index_select
on the same rows and the bytes bound. Every time goes to the log and, as
one JSON object, to stdout and to --out, with the card's name and power
limit.
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
from tf_repos_tpu_torch.ops import coo_pool as CP  # noqa: E402
from tf_repos_tpu_torch.ops import field_block as FB  # noqa: E402
from tf_repos_tpu_torch.ops import sorted_seg as SG  # noqa: E402
from tf_repos_tpu_torch.ops import sparse_rows as SR  # noqa: E402


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
        done = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", out,
                               os.path.join(self.csrc, f"{name}.cu")], check=True,
                              capture_output=True, text=True)
        log_ptxas(f"{self.libdir} {name}", done.stdout + done.stderr)
        return ctypes.CDLL(out)


def log_ptxas(label: str, text: str) -> None:
    """The registers and spills nvcc's -Xptxas -v reports for each kernel."""
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            CS.log(f"ptxas {label}: {line.strip()}")


SOURCES = ("sparse_rows", "coo_pool", "sorted_seg", "field_block")


def baseline_module(root: str, name: str):
    """DIR's ops/<name>.py as a module of its own, building from DIR."""
    path = os.path.join(root, "tf_repos_tpu_torch", "ops", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = _BaselineBuild(root)
    return mod


def sparse_rows_points(dev):
    """K1's six shapes, and the whole serving gather at its two serving
    shapes, as points of main()."""
    points = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for label, v, c, ids in (
            ("DeepFM serving, bucket 512", CS.WIDTH["feature_size"], 1 + CS.WIDTH["embedding_size"],
             CS.deepfm_serving_ids(CS.zipf_batches(1, seed=5, batch=512)[0]["feat_ids"], dev)),
            ("ESMM/DIN serving, bucket 64", CS.ESMM_WIDTH["feature_size"],
             CS.ESMM_WIDTH["embedding_size"],
             CS.aliccp_serving_ids(CS.esmm_batches(1, seed=5, batch=64)[0], dev))):
        table = torch.randn((v, c), generator=gen, device=dev)
        idx = SR.normalize_ids(ids.reshape(-1), v).to(torch.int32).contiguous()
        points[f"expand_rows ({label})"] = ("sparse_rows", "expand_rows", (table, idx), None)
        points[f"serving gather ({label})"] = ("sparse_rows", "serving_lookup", (table, ids), None)
    pt = CS.din_point(dev)
    s_din = int(pt["mapped"]["__uids_emb"].shape[0])
    table = torch.randn((s_din, 3 * pt["k"]), generator=gen, device=dev)[:, :pt["k"]]
    points["expand_rows (DIN COO lookup)"] = ("sparse_rows", "expand_rows", (table, pt["idx"]),
                                              None)
    # --coo_sorted_bwd's third launch: the [M, K] cotangent (84 MB, past
    # L2) gathered into idx-sorted order
    ct = torch.randn((pt["m"], pt["k"]), generator=gen, device=dev)
    points["expand_rows (DIN sorted cotangent)"] = ("sparse_rows", "expand_rows",
                                                    (ct, pt["perm"]), None)
    e = CS.esmm_point(dev)
    points["expand_rows (ESMM point)"] = ("sparse_rows", "expand_rows", (e["table"], e["ids"]),
                                          None)
    d = CS.deepfm_point(dev)
    points["expand_rows (DeepFM training)"] = ("sparse_rows", "expand_rows",
                                               (d["table"], d["idx"]), None)
    return points


def k1_yardsticks(table, ids):
    """A K1 point's index_select time on the same rows (the serving ids
    normalised first) and its bytes bound: the ids, the distinct rows
    they read and the output, each moved once."""
    idx = SR.normalize_ids(ids.reshape(-1), table.shape[0])
    n, row = idx.shape[0], table.shape[1] * table.element_size()
    nbytes = n * ids.element_size() + int(torch.unique(idx).numel()) * row + n * row
    return {"library_ms": CS.cuda_ms(lambda: torch.index_select(table, 0, idx)),
            "bound_ms": nbytes / CS.HBM_BYTES_PER_S * 1e3}


def serving_plain(table, ids):
    """The serving gather's plain version: the plain gather on ids
    normalised as JAX's gather treats them."""
    return SR.expand_rows_plain(table, SR.normalize_ids(ids.reshape(-1), table.shape[0])).reshape(
        tuple(ids.shape) + (table.shape[-1],))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="another checkout of this repository")
    ap.add_argument("--variant", action="append", default=[], help="another design, timed beside")
    ap.add_argument("--source", action="append", choices=SOURCES,
                    help="time only the kernels of ops/NAME.py")
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
    names = args.source or SOURCES
    for name, text in build.build_all().items():
        if name in names:
            log_ptxas(f"this tree {name}", text)
    sides = {"baseline": args.baseline, **{d: d for d in args.variant}}
    mods = {side: {n: baseline_module(d, n) for n in names} for side, d in sides.items()}
    mods["this tree"] = {"sparse_rows": SR, "coo_pool": CP, "sorted_seg": SG, "field_block": FB}
    order = ["baseline", "this tree", *args.variant]

    # label: (source, function, arguments, the arguments whose abs gives
    # the tolerance's scale; None: bit-exact)
    points = {}
    if "sparse_rows" in names:
        points.update(sparse_rows_points(dev))
    if "coo_pool" in names:
        e = CS.esmm_point(dev)
        idx, dest, w = e["idx"], e["dest"], e["w"]
        points["coo_pool_rows (ESMM point)"] = ("coo_pool", "coo_pool_rows",
                                                (e["table"], idx, dest, w, e["g"]), (0, 3))
        points["coo_accumulate_rows (ESMM point)"] = ("coo_pool", "coo_accumulate_rows",
                                                      (e["dp"], idx, dest, w, e["s"]), (0, 3))
    if "sorted_seg" in names:
        pt = CS.din_point(dev)
        points["sorted_segsum (n_out=G)"] = ("sorted_seg", "sorted_segsum",
                                             (pt["vals"], pt["cdest"], pt["g"]), (0,))
        points["sorted_segsum (n_out=Su)"] = ("sorted_seg", "sorted_segsum",
                                              (pt["sct"], pt["cidx"], pt["su"]), (0,))
    if "field_block" in names:
        _, ids, g = CS.field_block_point(dev)
        points["field_block_scatter (bf16 mode)"] = (
            "field_block", "field_block_scatter",
            (ids, g, CS.WIDTH["feature_size"], CS.FB_OFFSETS, CS.FB_SIZES, True), (1,))
    report = {"card": card, "points": {}}
    for label, (mod, fn, a, absolute) in points.items():
        if fn == "serving_lookup":  # each side's make_serving_lookup()
            plain = serving_plain
            call = {side: mods[side][mod].make_serving_lookup() for side in order}
        else:
            plain = getattr(mods["this tree"][mod], f"{fn}_plain")
            call = {side: getattr(mods[side][mod], fn) for side in order}
        want = plain(*a)
        for side in order:
            if absolute is None:
                CS.check(torch.equal(call[side](*a), want), f"{label} {side} is not bit-exact")
            else:
                scale = plain(*(x.abs() if i in absolute else x for i, x in enumerate(a)))
                CS.held(f"{label} {side}", call[side](*a), want, scale)
        times = {side: [] for side in order}
        for side in order + order[::-1]:
            times[side].append(CS.cuda_ms(lambda f=call[side]: f(*a)))
        row = {"ms": times, "plain_ms": CS.cuda_ms(lambda: plain(*a))}
        extra = ""
        if mod == "sparse_rows":
            row.update(k1_yardsticks(*a))
            extra = (f", library (index_select) {row['library_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.5f} ms (bytes)")
        CS.log(f"{label}: " + ", ".join(f"{s} {t[0]:.4f} / {t[1]:.4f} ms" for s, t in times.items())
               + f", plain {row['plain_ms']:.4f} ms" + extra)
        report["points"][label] = row
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
