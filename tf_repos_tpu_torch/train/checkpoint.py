"""Checkpoints as ``torch.save`` files under model_dir (the port's stand-in
for the JAX package's Orbax manager): ``ckpt-<step>.pt`` holding
{"params", "opt_state", "mstate", "step"}, the newest
``keep_checkpoint_max`` kept. Views that share a row store are saved
once and restored sharing it. A mesh saves the single-device state
assembled from its shards (rank 0 writes it), so any mesh, or one
device, restores any checkpoint."""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = directory
        self.keep = max(int(keep), 1)

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory) if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, state: Dict[str, Any]) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"ckpt-{step}.pt")
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[: -self.keep]:
            os.remove(os.path.join(self.directory, f"ckpt-{old}.pt"))
        return path

    def restore(self, device, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The checkpoint of ``step`` (default: the newest), or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self.directory, f"ckpt-{step}.pt")
        return torch.load(path, map_location=device, weights_only=False)


def clear_existing_model(model_dir: str) -> None:
    if model_dir and os.path.isdir(model_dir):
        shutil.rmtree(model_dir)
        print(f"INFO: cleared existing model at {model_dir}")
