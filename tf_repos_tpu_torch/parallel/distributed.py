"""Distribution flags (counterpart of the JAX package's
parallel/distributed.py).

--dist_mode 0 (local) and 1 (local cluster simulation) are no-ops, as
in JAX: the one-host mesh is spawned by the CLI itself (parallel/launch.py)
from --mesh_data and --mesh_model. --dist_mode=2 (one process per host,
from --worker_hosts and --task_index) is not ported: the harness
rejects it by name."""

from __future__ import annotations

import torch.distributed as dist

from tf_repos_tpu_torch.config import Config


def init_distributed(cfg: Config) -> bool:
    """True if a multi-host control plane was initialised: never for
    --dist_mode 0 and 1; --dist_mode=2 raises."""
    if cfg.dist_mode != 2:
        return False
    raise NotImplementedError(
        "--dist_mode=2: the multi-host mesh (worker_hosts/task_index, per-host file "
        "shards, the cross-host uid union) is not implemented in tf_repos_tpu_torch yet"
    )


def is_chief() -> bool:
    """The process that writes logs, metrics, checkpoints, pred.txt and
    exports: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
