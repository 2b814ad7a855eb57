"""Serving latency against batch size on the PyTorch port (the port of
scripts/bench_serving.py). The reference's headline serving numbers are
~15 ms of fixed cost and ~0.5 ms an example (TF Serving on the CPU,
deep_ctr/README.md:78-81, the fit latency = 0.5256*ads + 15.449). This
script measures the same quantity against a live PredictionServer over
HTTP, end to end (request parse, micro-batch, forward on the device,
reply), and fits latency = a*batch + b.

    python scripts/torch_bench_serving.py [--servable_model_dir D] [--repeats N] [--device cpu]

With no servable it trains and exports a DeepFM first (2,000 synthetic
libsvm lines, V=117,581, K=16, towers 256/128/64, B=256) in a temporary
directory, which it names and leaves for reuse. --device defaults to
cuda and raises without a GPU; only --device=cpu runs on the CPU.

For each batch size it prints p50 and p99 over --repeats requests (after
3 warm-ups) with the K1 launches of those requests (the serving gather,
one launch a scored micro-batch on the card; the CPU runs its plain
version and counts none) beside the micro-batches the server scored.
Then the server's /stats split (batchify, device, HTTP), the median of
10 empty device round trips (a scalar add and a synchronize), the card's
name and power limit, and one JSON line."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tf_repos_tpu_torch.ops import sparse_rows as SR  # noqa: E402
from tf_repos_tpu_torch.utils.platform import card_label, resolve_device  # noqa: E402

BATCHES = (1, 4, 16, 64, 256)
VOCAB = 117_581
WARMUP = 3
# the reference's TF-Serving CPU fit (deep_ctr/README.md:78-81)
REF_PER_EXAMPLE, REF_FIXED = 0.5256, 15.449


def _ensure_servable(tmp: str, device: str = "cuda", vocab: int = VOCAB, small: bool = False,
                     dropout: str = "1.0,1.0,1.0") -> str:
    """Train (2,000 synthetic lines, 500 for eval) and export a DeepFM in
    tmp: K=16 and towers 256/128/64, or K=4 and towers 8/4 when small.
    The load bench builds its servable here too (with its dropout flag)."""
    from tf_repos_tpu_torch.config import Config
    from tf_repos_tpu_torch.data.synthetic import write_synthetic_libsvm
    from tf_repos_tpu_torch.train.harness import run_task

    data = os.path.join(tmp, "data")
    os.makedirs(data, exist_ok=True)
    write_synthetic_libsvm(os.path.join(data, "tr.libsvm"), 2000, vocab, seed=0)
    write_synthetic_libsvm(os.path.join(data, "va.libsvm"), 500, vocab, seed=1)
    cfg = Config(
        model="DeepFM", feature_size=vocab, field_size=39, embedding_size=4 if small else 16,
        deep_layers="8,4" if small else "256,128,64", dropout=dropout, batch_size=256,
        num_epochs=1, log_steps=5, data_dir=data,
        model_dir=os.path.join(tmp, "model"), dt_dir="bench",
        eval_throttle_secs=0, servable_model_dir=os.path.join(tmp, "servable"),
        device=device,
    )
    run_task(cfg)
    run_task(cfg.replace(task_type="export"))
    return cfg.servable_model_dir


def bare_device_sync_ms(dev: torch.device, n: int = 10) -> float:
    """Median of n empty round trips: a scalar add on the device and, on
    the card, torch.cuda.synchronize()."""
    x = torch.zeros((), device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t = []
    for _ in range(n):
        t0 = time.perf_counter()
        x + 1.0
        sync()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--servable_model_dir", default="")
    p.add_argument("--repeats", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a GPU) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    card = card_label(dev)

    from tf_repos_tpu_torch.serve.server import PredictionServer

    servable = a.servable_model_dir or _ensure_servable(
        tempfile.mkdtemp(prefix="bench_serving_"), a.device)
    print(f"servable: {servable}")
    srv = PredictionServer(servable, port=0, reload_secs=0, max_wait_ms=0.5, device=a.device)
    srv.start()
    try:
        model = srv.model_name
        url = f"http://127.0.0.1:{srv.port}/v1/models/{model}:predict"

        rng = np.random.default_rng(0)
        results, batches = {}, {}
        for n in BATCHES:
            insts = [
                {
                    "feat_ids": [int(x) for x in rng.integers(1, VOCAB, 39)],
                    "feat_vals": [1.0] * 39,
                }
                for _ in range(n)
            ]
            body = json.dumps({"instances": insts}).encode()
            lat = []
            k0, s0 = SR.expand_rows.launches, srv.batcher.scored
            for _ in range(a.repeats + WARMUP):
                t0 = time.perf_counter()
                req = urllib.request.Request(url, data=body,
                                             headers={"Content-Type": "application/json"})
                resp = json.loads(urllib.request.urlopen(req, timeout=60).read())
                lat.append((time.perf_counter() - t0) * 1e3)
            launches, scored = SR.expand_rows.launches - k0, srv.batcher.scored - s0
            assert len(resp["predictions"]) == n
            lat = np.asarray(lat[WARMUP:])
            results[n] = (float(np.median(lat)), float(np.percentile(lat, 99)))
            batches[n] = {"p50_ms": results[n][0], "p99_ms": results[n][1],
                          "requests": a.repeats + WARMUP, "k1_launches": launches,
                          "scored_batches": scored, "instances": insts,
                          "predictions": resp["predictions"]}
            print(f"batch={n:4d}  p50={results[n][0]:7.2f} ms  p99={results[n][1]:7.2f} ms  "
                  f"K1 launches {launches} in {scored} scored micro-batches "
                  f"({a.repeats + WARMUP} requests) on {card}")

        ns = np.asarray(sorted(results))
        p50s = np.asarray([results[n][0] for n in ns])
        slope, intercept = np.polyfit(ns, p50s, 1)
        print(f"fit: latency = {slope:.4f}*batch + {intercept:.3f} ms on {card} "
              f"(reference: {REF_PER_EXAMPLE}*batch + {REF_FIXED} ms, TF Serving on the CPU, "
              "deep_ctr/README.md:78-81)")

        # the server's split of the fixed cost: batchify (host arrays and the
        # copy to the device) against the device leg (the forward and the
        # copy back, which is the sync); the rest is HTTP. The fixed cost
        # less one empty device round trip is what the host side costs
        stats = json.loads(
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=10).read()
        )
    finally:
        srv.stop()
    device_p50 = stats.get("device_ms", {}).get("p50", 0.0)
    batchify_p50 = stats.get("batchify_ms", {}).get("p50", 0.0)
    http_overhead = max(float(intercept) - device_p50 - batchify_p50, 0.0)
    sync_ms = bare_device_sync_ms(dev)
    colocated_fixed = max(float(intercept) - sync_ms, 0.0)
    print(
        f"decomposition: batchify={batchify_p50:.2f} device={device_p50:.2f} "
        f"http~={http_overhead:.2f} bare_device_sync={sync_ms:.3f} ms on {card}\n"
        f"fixed cost less one empty device round trip = {colocated_fixed:.2f} ms "
        f"(total fixed {intercept:.2f} minus {sync_ms:.3f})"
    )
    line = {
        "metric": "serving_latency_fit",
        "ms_per_example": round(float(slope), 4),
        "ms_fixed": round(float(intercept), 3),
        "ms_fixed_colocated_est": round(colocated_fixed, 3),
        "server_device_ms_p50": round(device_p50, 3),
        "server_batchify_ms_p50": round(batchify_p50, 3),
        "bare_device_sync_ms": round(sync_ms, 3),
        "vs_baseline_per_example": round(REF_PER_EXAMPLE / max(float(slope), 1e-6), 1),
        "vs_baseline_fixed": round(REF_FIXED / max(float(intercept), 1e-6), 1),
        "vs_baseline_fixed_colocated": round(REF_FIXED / max(colocated_fixed, 1e-6), 1),
    }
    print(f"device: {card}")
    print(json.dumps(line), flush=True)
    return {"servable": servable, "card": card, "fit": line, "stats": stats, "batches": batches}


if __name__ == "__main__":
    main()
