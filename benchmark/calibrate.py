"""Readings that set a cell's limits (not part of a benchmark run): for
each seed, the numbers of ``correct.py`` for the sound program, the
controls and the planted faults, each against the plain reference
from the same weights and batches, at the cell's own sizes.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--modes sound,bf16_store,...]

Modes: ``sound`` (the program as configured), ``bf16_store`` (the
program's own bf16 table path, --param_dtype=bfloat16: the control for
the f32 store), ``fp8_towers`` (the reference in the program's place
with its tower GEMMs in float8 e4m3: the control for the bf16 towers),
and the faults ``state_unchanged``, ``half_batch`` and (DIN)
``attention_unchanged`` (a model without attention leaves refuses it:
leave it out of ``--modes`` there); besides, ``f64_pools`` (DIN: the
reference in the program's place with its attention pools summed in
float64, a witness of how far a new summation order alone moves the
numbers; not run by default). One JSON line a (seed, mode) on
standard output, with the readings the numbers come from."""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import correct, reference, spec  # noqa: E402
from benchmark.harness import CHECKED_STEPS, forbidden_modules  # noqa: E402
from benchmark.reference.common import strict_f32  # noqa: E402

MODES = ("sound", "bf16_store", "fp8_towers", "state_unchanged", "half_batch", "attention_unchanged")


def program_readings(cell, ref, seed, raw, device, **kw):
    from benchmark.program import Program, first_steps

    prog = Program(cell.config, ref, seed, device, **kw)
    staged = [prog.stage(prog.map(b)) for b in raw]
    out = first_steps(prog, ref, cell.config, seed, staged, CHECKED_STEPS)
    del prog, staged
    return out


def readings(mode, cell, ref, seed, raw, device):
    if mode == "sound":
        return program_readings(cell, ref, seed, raw, device)
    if mode == "bf16_store":
        return program_readings(cell, ref, seed, raw, device, param_dtype="bfloat16")
    if mode == "fp8_towers":
        return ref.train(cell.config, seed, raw, device, precision="fp8")
    if mode == "f64_pools":
        return ref.train(cell.config, seed, raw, device, pool_dtype=torch.float64)
    return program_readings(cell, ref, seed, raw, device, fault=mode)


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    ref = reference.load(cell.config["reference"])
    for seed in (int(s) for s in args.seeds.split(",")):
        raw = spec.make_pool(cell, seed, device, CHECKED_STEPS)
        strict_f32()
        base = ref.train(cell.config, seed, raw, device)
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            got = readings(mode, cell, ref, seed, raw, device)
            gaps = correct.gaps(got, base)
            print(json.dumps({"cell": cell.name, "seed": seed, "mode": mode,
                              **{k: v[0] for k, v in gaps.items()},
                              "at": {k: v[1] for k, v in gaps.items()},
                              "s": round(time.perf_counter() - t0, 3),
                              "readings": got, "reference": base}), flush=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of {bad} were loaded", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
