"""Batch scorer over an exported servable (counterpart of the JAX
package's serve/scorer.py).

The forward is the predict step (train/loop.build_predict_step) with the
serving lookup (ops/sparse_rows.make_serving_lookup): every table gather
goes through K1 expand_rows on the card, over the whole table, with the
request's ids normalised as JAX's gather treats them. Requests are
padded up to static batch buckets and the results sliced back; a
request larger than the largest bucket is scored in chunks of it, as in
the JAX package. Weights move to the device once, at load.

``maybe_reload()`` picks up a newer timestamp version (hot reload, under
the scorer's lock). ``last_timing`` decomposes the last call:
batchify_ms (host arrays, padding, host-to-device copy), device_ms
(the forward and the device-to-host copy of its outputs, which is the
sync) and the bucket."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from tf_repos_tpu_torch.ops.sparse_rows import make_serving_lookup
from tf_repos_tpu_torch.serve.export import latest_version_dir, load_servable
from tf_repos_tpu_torch.train.loop import build_predict_step
from tf_repos_tpu_torch.utils.platform import resolve_device

DEFAULT_BUCKETS = (1, 8, 64, 512)


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Scorer:
    """Loads the newest version under servable_dir and scores batches on
    ``device`` (cuda unless the caller asks for the CPU)."""

    def __init__(
        self,
        servable_dir: str,
        batch_buckets: Sequence[int] = DEFAULT_BUCKETS,
        warmup: bool = True,
        device: str = "cuda",
    ):
        self.servable_dir = servable_dir
        self.buckets = tuple(sorted(batch_buckets))
        self.device = resolve_device(device)
        self.last_timing: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._load(latest_version_dir(servable_dir))
        if warmup:
            self.warmup()

    # ------------------------------------------------------------ loading
    def _load(self, version_dir: str) -> None:
        model, params, mstate, signature = load_servable(version_dir, self.device)
        predict = build_predict_step(model, lookup=make_serving_lookup())
        with self._lock:
            self.model = model
            self.params = params
            self.mstate = mstate
            self.signature = signature
            self.version_dir = version_dir
            self.version = signature["version"]
            self._predict = predict

    def maybe_reload(self) -> bool:
        """Hot-reload if a newer timestamp version appeared."""
        newest = latest_version_dir(self.servable_dir)
        if newest != self.version_dir:
            self._load(newest)
            return True
        return False

    # ------------------------------------------------------------ scoring
    def warmup(self) -> None:
        """Score every bucket once, so the first requests do not pay for
        the kernel library's build or first launches."""
        example = self._example_instance()
        for b in self.buckets:
            self.score([example] * b)

    def _example_instance(self) -> Dict[str, np.ndarray]:
        inst: Dict[str, np.ndarray] = {}
        for name, spec in self.signature["inputs"].items():
            shape = [d if d is not None else 1 for d in spec["shape"][1:]]
            dtype = np.float32 if "float" in spec["dtype"] else np.int32
            inst[name] = np.zeros(shape, dtype)
        return inst

    def score(self, instances: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        """instances: list of per-example dicts of arrays/lists. Returns
        {output_key: [n]} with the padding removed."""
        n = len(instances)
        if n == 0:
            return {k: np.zeros((0,), np.float32) for k in self.model.prediction_keys}
        top = self.buckets[-1]
        if n > top:  # chunk oversized requests through the largest bucket
            parts = [self.score(instances[i : i + top]) for i in range(0, n, top)]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        b = _bucket_for(n, self.buckets)
        t0 = time.perf_counter()
        batch: Dict[str, torch.Tensor] = {}
        for k in instances[0].keys():
            arr = np.stack([np.asarray(inst[k]) for inst in instances])
            if arr.dtype == np.int64:
                arr = arr.astype(np.int32)
            elif arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            pad = [(0, b - n)] + [(0, 0)] * (arr.ndim - 1)
            batch[k] = torch.from_numpy(np.pad(arr, pad)).to(self.device)
        batch.setdefault("mask", torch.from_numpy(
            np.pad(np.ones((n,), np.float32), (0, b - n))).to(self.device))
        t1 = time.perf_counter()
        with self._lock:
            out = self._predict(self.params, self.mstate, batch)
            res = {k: v.cpu().numpy()[:n] for k, v in out.items()}  # the device sync
        t2 = time.perf_counter()
        self.last_timing = {
            "batchify_ms": (t1 - t0) * 1e3,
            "device_ms": (t2 - t1) * 1e3,
            "bucket": b,
        }
        return res
