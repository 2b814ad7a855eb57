"""The mesh's spawner: one process a mesh position, started with
torch.multiprocessing's ``spawn`` (CUDA cannot fork), meeting through a
FileStore in a fresh temporary directory (no port to collide on), with a
timeout on every collective (COLLECTIVE_TIMEOUT_S).

A rank that raises ends the run: the launcher kills the other ranks and
re-raises, so the command exits nonzero, and a run that outlives
``timeout`` is killed the same way. Rank 0 is the chief: its return
value is the run's. The other ranks' standard output is discarded
(their errors still reach standard error); CPU ranks take an equal share
of the host's cores."""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tf_repos_tpu_torch.parallel.mesh import choose_backend, make_mesh

# seconds a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 600


def _rank_main(rank, fn, args, data, model, devices, backend, tmp):
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    dev = devices[rank]
    world = data * model
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # CPU ranks share the host's cores: one rank's share each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw,
    )
    try:
        mesh = make_mesh(data, model, devices)
        out = fn(mesh, *args)
        if rank == 0:
            path = os.path.join(tmp, "result.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(path + ".tmp", path)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def run_on_mesh(
    fn: Callable[..., Any],
    args: Sequence[Any] = (),
    *,
    data: int,
    model: int,
    devices: Sequence[Any],
    timeout: Optional[float] = None,
) -> Any:
    """Run ``fn(mesh, *args)`` on data * model spawned ranks, rank r on
    ``devices[r]``; return rank 0's result. ``fn`` must be importable by
    name (a module-level function) and its result picklable."""
    devices = [torch.device(d) for d in devices]
    world = data * model
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a {data}x{model} mesh")
    backend = choose_backend(devices)
    print(f"INFO: mesh {data}x{model} on {backend}, rank -> device: "
          + ", ".join(f"{r}:{d}" for r, d in enumerate(devices)), flush=True)
    tmp = tempfile.mkdtemp(prefix="mesh-")
    ctx = mp.start_processes(
        _rank_main,
        args=(fn, tuple(args), data, model, devices, backend, tmp),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"mesh run did not finish within {timeout} s; ranks killed")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
