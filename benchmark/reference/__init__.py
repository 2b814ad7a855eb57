"""Plain PyTorch references of the benchmark's models. Each module
``<model>.py`` holds, for its configuration: ``init_params`` (the
seeded initial weights, in the port's parameter layout, handed to both
sides), ``train`` (the reference's own steps from the raw batches:
mapping, forward, backward, lazy Adam on the table rows, dense Adam),
``step_flops`` (model FLOPs of one training step, forward and backward,
gathers and scatters at 0) and ``TABLE`` (the name of the embedding
table). Nothing here imports the port or JAX."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")
