"""The mesh's spawner: one process a mesh position, started with
torch.multiprocessing's ``spawn`` (CUDA cannot fork), with a timeout on
every collective (COLLECTIVE_TIMEOUT_S).

run_on_mesh: one host, every position a process of this one, meeting
through a FileStore in a fresh temporary directory (no port to collide
on). run_on_hosts: --dist_mode=2, one such process a host, each spawning
its L = D*M/H ranks (rank = task_index * L + local), which meet through
a TCPStore at the coordinator (worker_hosts[0]; rank 0, spawned by task
0, serves it) and agree on the backend from every rank's device
(parallel/mesh.agree_backend).

A rank that raises ends the run: the launcher kills its host's other
ranks and re-raises, so the command exits nonzero (the other hosts'
ranks fail at their next collective with the lost peer), and a run that
outlives ``timeout`` is killed the same way. A SIGTERM to the launching
process is forwarded to its ranks, whose harness stops at the next
step boundary that every rank agrees on (train/harness.GracefulStop), so
no rank is orphaned or killed mid-collective. Rank 0 is the chief; the
first rank of each host returns its result to its launcher. The other
ranks' standard output is discarded (their errors still reach standard
error); CPU ranks take an equal share of the host's cores."""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tf_repos_tpu_torch.parallel.mesh import agree_backend, choose_backend, make_mesh

# seconds a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What a spawned rank needs: the mesh, this host's place in it, its
    local devices, the rendezvous and the result directory."""

    data: int
    model: int
    hosts: int
    task: int
    devices: Tuple[torch.device, ...]  # this host's, one a local rank
    backend: Optional[str]  # None: agreed over the world
    coordinator: Optional[Tuple[str, int]]  # None: a FileStore in tmp
    tmp: str


def _rank_main(local, fn, args, spec: _Spec):
    if local != 0:
        sys.stdout = open(os.devnull, "w")
    per = len(spec.devices)
    rank = spec.task * per + local
    world = spec.data * spec.model
    dev = spec.devices[local]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # CPU ranks share the host's cores: one rank's share each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // per))
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if spec.coordinator is None:
        store = dist.FileStore(os.path.join(spec.tmp, "store"), world)
    else:
        addr, port = spec.coordinator
        store = dist.TCPStore(addr, port, world, is_master=rank == 0, timeout=timeout)
    backend = spec.backend or agree_backend(store, rank, world, dev, COLLECTIVE_TIMEOUT_S)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout, **kw)
    try:
        # only a rank's own device is read from the list
        devices = [dev if r == rank else torch.device("cpu") for r in range(world)]
        mesh = make_mesh(spec.data, spec.model, devices, hosts=spec.hosts)
        if spec.hosts > 1 and local == 0:
            print(f"INFO: mesh {spec.data}x{spec.model} over {spec.hosts} hosts on {backend}, "
                  f"host {spec.task}: rank -> device: "
                  + ", ".join(f"{spec.task * per + i}:{d}" for i, d in enumerate(spec.devices)),
                  flush=True)
        out = fn(mesh, *args)
        if local == 0:
            path = os.path.join(spec.tmp, "result.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(path + ".tmp", path)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, spec: _Spec, timeout: Optional[float]) -> Any:
    """Start the host's ranks, forward SIGTERM to them, join them (or kill
    them all on the first failure or at ``timeout``) and return the first
    local rank's result."""
    ctx = mp.start_processes(_rank_main, args=(fn, tuple(args), spec), nprocs=len(spec.devices),
                             join=False, start_method="spawn")

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not the main thread: nothing to forward from
        prev = None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"mesh run did not finish within {timeout} s; ranks killed")
        with open(os.path.join(spec.tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(spec.tmp, ignore_errors=True)


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
    devices = tuple(torch.device(d) for d in devices)
    world = data * model
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a {data}x{model} mesh")
    backend = choose_backend(devices)
    print(f"INFO: mesh {data}x{model} on {backend}, rank -> device: "
          + ", ".join(f"{r}:{d}" for r, d in enumerate(devices)), flush=True)
    spec = _Spec(data, model, 1, 0, devices, backend, None, tempfile.mkdtemp(prefix="mesh-"))
    return _spawn(fn, args, spec, timeout)


def run_on_hosts(
    fn: Callable[..., Any],
    args: Sequence[Any] = (),
    *,
    data: int,
    model: int,
    devices: Sequence[Any],
    hosts: Sequence[str],
    task_index: int,
    timeout: Optional[float] = None,
) -> Any:
    """This host's part of a mesh over len(hosts) hosts: ``fn(mesh,
    *args)`` on L = data * model / H spawned ranks, local rank l on
    ``devices[l]``; return the first local rank's result. Every host
    calls this with the same mesh and hosts and its own task_index; the
    ranks meet at hosts[0] (host:port)."""
    from tf_repos_tpu_torch.parallel.distributed import HostLayout

    layout = HostLayout(tuple(hosts), task_index)
    n = layout.count
    devices = tuple(torch.device(d) for d in devices)
    if data % n:
        raise ValueError(f"the data axis {data} does not divide over {n} hosts")
    if len(devices) * n != data * model:
        raise ValueError(f"{len(devices)} devices a host for a {data}x{model} mesh over {n} hosts")
    spec = _Spec(data, model, n, task_index, devices, None, layout.coordinator,
                 tempfile.mkdtemp(prefix="mesh-"))
    return _spawn(fn, args, spec, timeout)
