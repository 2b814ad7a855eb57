"""Observability (counterpart of the JAX package's utils/observability.py):
scalar metric events, profiler traces, NaN checks.

  MetricsWriter     append-only JSONL scalar events in model_dir, plus
                    TensorBoard event files (utils/tb_events.py) with the
                    same scalars under "<kind>/<name>" tags
  profile_trace     a torch.profiler trace (CPU, and CUDA when the run is
                    on a card) over a window of train steps, written by
                    torch.profiler.tensorboard_trace_handler as
                    <dir>/<worker>.<time>.pt.trace.json (Chrome trace
                    format; TensorBoard's profiler plugin reads it)
  enable_nan_checks --check_numerics, the port's jax_debug_nans: wraps a
                    train step so that a step that produces a NaN raises
                    FloatingPointError instead of carrying on
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Callable, Dict

import torch

from tf_repos_tpu_torch.utils.tb_events import TensorBoardWriter
from tf_repos_tpu_torch.utils.tree import tree_leaves


class MetricsWriter:
    """Append-only JSONL scalar events, {"step", "wall", "kind",
    <scalars>}, in model_dir/filename, and the same scalars as TensorBoard
    events in model_dir (tags "<kind>/<name>")."""

    def __init__(self, model_dir: str, filename: str = "metrics.jsonl", tensorboard: bool = True):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._tb = TensorBoardWriter(model_dir) if tensorboard else None

    def write(self, step: int, scalars: Dict[str, float], kind: str = "train") -> None:
        rec = {"step": int(step), "wall": time.time(), "kind": kind}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(step, {f"{kind}/{k}": float(v) for k, v in scalars.items()})

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class profile_trace:
    """Context manager: a torch.profiler trace into ``log_dir`` (the CUDA
    activity too when ``device`` is a card). The harness enters it at
    step profile_start_step and leaves it profile_steps steps later,
    after a device sync, so the window's kernels are in the trace."""

    def __init__(self, log_dir: str, device="cpu"):
        self.log_dir = log_dir
        self.device = torch.device(device)
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        os.makedirs(self.log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        worker = f"{socket.gethostname()}_{os.getpid()}"
        self._prof = profile(activities=acts,
                             on_trace_ready=tensorboard_trace_handler(self.log_dir, worker))
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof.__exit__(None, None, None)
            self._prof = None
        return False


def _has_nan(tensors) -> bool:
    flags = [torch.isnan(t).any() for t in tensors
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return bool(torch.stack(flags).any()) if flags else False


def enable_nan_checks(step: Callable) -> Callable:
    """Wrap a harness train step, (state, batch, generator, sr_generator)
    -> (state, loss), so that after every step it checks the loss, every
    updated parameter (the table shards on a mesh rank) and the model
    state for NaN, with one device sync, and raises FloatingPointError
    naming the first NaN leaf. As with jax_debug_nans, infinities pass."""

    def checked(state, batch, generator=None, sr_generator=None):
        state, loss = step(state, batch, generator, sr_generator)
        leaves = [loss] + tree_leaves(state["params"]) + tree_leaves(state["mstate"])
        if _has_nan(leaves):
            what = "loss" if _has_nan([loss]) else "an updated parameter or the model state"
            raise FloatingPointError(f"--check_numerics: the train step produced a NaN in {what}")
        return state, loss

    return checked
