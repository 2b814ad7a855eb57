"""Distribution flags and the host layer (counterpart of the JAX package's
parallel/distributed.py).

--dist_mode 0 (local) and 1 (local cluster simulation) are no-ops, as
in JAX: the one-host mesh is spawned by the CLI itself (parallel/launch.py)
from --mesh_data and --mesh_model. --dist_mode=2 runs one CLI process a
host: --worker_hosts=h0:p0,h1:p1,... lists the hosts (H = the non-empty
entries), --task_index is this host's index, and the first entry is the
coordinator, where the ranks of every host meet (a TCPStore served by
rank 0, which task 0 spawns). --ps_hosts and --job_name are accepted and
ignored, as in JAX. cfg.batch_size is per host under H > 1: the global
batch is H * batch_size.

Host collectives. The host-level agreements of the input pipeline (the
uid union, the lockstep batch count, multi-process infer's continue
flag) run on numpy values over a gloo group of CPU tensors: one rank of
each host, those that share a local index (set_host_group; every rank
belongs to one such group, so each issues the same agreement with its
peers). Gloo, because NCCL takes no CPU tensors, whatever the mesh's
device backend."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tf_repos_tpu_torch.config import Config


@dataclasses.dataclass(frozen=True)
class HostLayout:
    """The hosts of a --dist_mode=2 run and this process's index."""

    hosts: Tuple[str, ...]
    index: int

    @property
    def count(self) -> int:
        return len(self.hosts)

    @property
    def coordinator(self) -> Tuple[str, int]:
        """(address, port) of worker_hosts[0], where the ranks meet."""
        addr, _, port = self.hosts[0].rpartition(":")
        if not addr or not port.isdigit():
            raise ValueError(f"--worker_hosts: {self.hosts[0]!r} is not host:port")
        return addr, int(port)


def init_distributed(cfg: Config) -> Optional[HostLayout]:
    """The host layout of --dist_mode=2 (None for --dist_mode 0 and 1).
    Nothing is contacted here: the ranks meet at the coordinator when the
    launcher starts them (parallel/launch.run_on_hosts)."""
    if cfg.dist_mode != 2:
        return None
    workers = tuple(h for h in cfg.worker_hosts.split(",") if h)
    if not workers:
        raise ValueError(
            "--dist_mode=2 needs --worker_hosts=host:port,... (one entry a host, the "
            "first the coordinator); the JAX package's empty-list branch reads a TPU "
            "pod's environment, which has no counterpart here"
        )
    if not 0 <= cfg.task_index < len(workers):
        raise ValueError(f"--task_index={cfg.task_index} outside the {len(workers)} --worker_hosts")
    layout = HostLayout(workers, cfg.task_index)
    layout.coordinator  # noqa: B018 -- validates the coordinator's host:port
    return layout


def is_chief() -> bool:
    """The process that writes logs, metrics, checkpoints, pred.txt and
    exports: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ----------------------------------------------------------- host layer
_HOST = {"count": 1, "index": 0, "group": None}


def set_host_group(count: int, index: int, group: Any) -> None:
    """Register this rank's host count, host index and host-collective
    group (the launcher's ranks call it through make_mesh)."""
    _HOST.update(count=int(count), index=int(index), group=group)


def host_count() -> int:
    """H: the number of hosts (1 outside a --dist_mode=2 rank)."""
    return _HOST["count"]


def host_index() -> int:
    """This rank's host (its --task_index)."""
    return _HOST["index"]


def host_allgather(x: Any) -> np.ndarray:
    """[H, *x.shape]: every host's ``x`` (numpy scalar or array of one
    shape on every host), in host order."""
    a = np.array(x)  # a contiguous copy; a scalar stays 0-d
    if host_count() == 1:
        return a[None]
    t = torch.from_numpy(a).reshape(-1)
    out = [torch.empty_like(t) for _ in range(host_count())]
    dist.all_gather(out, t, group=_HOST["group"])
    return np.stack([o.numpy().reshape(a.shape) for o in out])


def _host_reduce(x: Any, op) -> np.ndarray:
    a = np.array(x)
    if host_count() == 1:
        return a
    t = torch.from_numpy(a)
    dist.all_reduce(t, op=op, group=_HOST["group"])
    return t.numpy()


def host_min(x: Any) -> np.ndarray:
    """The elementwise minimum of ``x`` over the hosts."""
    return _host_reduce(x, dist.ReduceOp.MIN)


def host_max(x: Any) -> np.ndarray:
    """The elementwise maximum of ``x`` over the hosts."""
    return _host_reduce(x, dist.ReduceOp.MAX)
