"""One run of one cell: set-up (the seed's weights and pool, the port's
host chain over the pool, the pool staged on the card, the first three
steps read for the check, every pool shape warmed up), the measured or
traced window, then the check against the plain reference once the
program's state is freed."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import correct, spec
from benchmark import metrics as M
from benchmark import reference
from benchmark.reference.common import strict_f32

FORBIDDEN = ("jax", "jaxlib", "flax", "tf_repos_tpu")
CHECKED_STEPS = 3
HOST_TRACE_S = 1.0


def process_start_s() -> float:
    """This process's start on CLOCK_BOOTTIME, from /proc/self/stat."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return ticks / os.sysconf("SC_CLK_TCK")


def since_start(start: float) -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (tf_repos_tpu_torch is not tf_repos_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, start: float,
        fault: Optional[str] = None) -> Dict:
    """The result line's fields, and the compared numbers under "checks"."""
    from benchmark.program import Program, first_steps

    marks = [("start", since_start(start))]
    ref = reference.load(cell.config["reference"])
    raw = spec.make_pool(cell, seed, device)
    marks.append(("pool", since_start(start)))
    prog = Program(cell.config, ref, seed, device, fault=fault)
    marks.append(("program", since_start(start)))
    staged = [prog.stage(prog.map(b)) for b in raw]
    marks.append(("map+stage", since_start(start)))
    rows = [int(b["mask"].shape[0]) for b in raw]
    flops = [ref.step_flops(cell.config, b) for b in raw]
    readings = first_steps(prog, ref, cell.config, seed, staged, CHECKED_STEPS)
    marks.append(("checked steps", since_start(start)))
    for b in staged:  # every shape of the pool once more, as the window has them
        prog.step(b)
    _sync(device)
    # what set-up made stays out of the collector's generations: no
    # collection pause over it inside the window
    gc.collect()
    gc.freeze()
    setup_s = since_start(start)
    marks.append(("warm-up", setup_s))
    log("setup (s): " + ", ".join(f"{name} {t - (marks[i - 1][1] if i else 0.0):.3f}"
                                  for i, (name, t) in enumerate(marks)))
    pool = len(staged)
    out: Dict = {}
    if trace:
        from benchmark.trace import traced_window

        readers = M.load_all()
        entries = {e: f for r in readers.values() for e, f in getattr(r, "ENTRIES", {}).items()}
        _reset_peak(device)
        holder = {}

        def step(i):
            holder["loss"] = prog.step(staged[i % pool])
        # the metrics from a trace of the device's activity alone (the
        # host's operations cost host time); the idle gaps' attribution
        # from one more second with the host's operations traced
        tr = traced_window(step, seconds, lambda i: flops[i % pool], entries, device, host=False)
        gaps = traced_window(step, HOST_TRACE_S, lambda i: 0.0, {}, device, host=True).idle_gaps()
        steps, last = tr.steps, holder.get("loss")
        metrics = {}
        for name, r in readers.items():
            value = r.read(tr)
            if value is not None:
                metrics[name] = {"value": value, "unit": r.UNIT}
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        out["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": gaps}
    else:
        _reset_peak(device)
        _sync(device)
        t0, steps, last = time.perf_counter(), 0, None
        while time.perf_counter() - t0 < seconds:
            last = prog.step(staged[steps % pool])
            steps += 1
        _sync(device)
        window = time.perf_counter() - t0
        examples = sum(rows[i % pool] for i in range(steps))
        metrics = {"train_examples_per_s": {"value": examples / window, "unit": "examples/s"}}
        extra = {}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if not trace:
        metrics["peak_device_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    finite = last is None or math.isfinite(float(last))
    gc.unfreeze()
    del prog, staged
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    strict_f32()
    ref_readings = ref.train(cell.config, seed, raw[:CHECKED_STEPS], device)
    ok, checks = correct.judge(correct.gaps(readings, ref_readings), cell.limits)
    result = {
        "correct": bool(ok and finite),
        "attempted": steps,
        "failed": 0 if finite else steps,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
            **extra,
        },
    }
    result.update(out)
    result["checks"] = {name: {"value": _finite(value), "limit": limit, "at": where}
                        for name, value, limit, where in checks}
    result["readings"] = {"program": readings, "reference": ref_readings}
    return result


def _finite(x: float):
    """A number JSON can carry: a non-finite reading as its name."""
    return x if math.isfinite(x) else repr(x)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv) -> int:
    start = process_start_s()
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"error: the cell needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), start)
    log(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    bad = forbidden_modules()
    if bad:
        log(f"error: modules of {bad} were loaded in the process")
        return 4
    log(f"readings: {json.dumps(result['readings'])}")
    log(f"result: correct={result['correct']} attempted={result['attempted']} failed={result['failed']}")
    for name, c in result["checks"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']!r}"
        log(f"check {name} {c['value']!r} {limit} (worst at {c['at']})")
    print(result_line(result), flush=True)
    return 0


LINE_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown")


def result_line(result: Dict) -> str:
    """The one JSON line a run prints last: the contract's keys, then the
    compared numbers with their limits under "checks", last."""
    line = {k: result[k] for k in LINE_KEYS if k in result}
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                      for k, v in result["checks"].items() if v["limit"] is not None}
    return json.dumps(line)
