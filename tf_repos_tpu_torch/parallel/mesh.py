"""The device mesh (counterpart of the JAX package's parallel/mesh.py):
one torch.distributed process per mesh position, with two logical axes

  "data"   batch sharding: every gradient is SUM all-reduced over it
  "model"  embedding-table row sharding (the parameter-server analog)

Rank order is JAX's ``np.asarray(devices).reshape(data, model)``: rank
r = d * model + m. Each rank belongs to one ``data`` group (the ranks
of its model coordinate m) and one ``model`` group (the ranks of its
data coordinate d).

Backend: NCCL when every rank has a card of its own; gloo on the CPU,
and gloo when ranks share a card (NCCL refuses two ranks on one device).
Gloo runs only all_reduce, broadcast and barrier on CUDA tensors, so the
mesh's collectives keep to those three.

Several hosts (--dist_mode=2, H hosts): each host runs L = D*M/H ranks,
rank r = host * L + local, so with D % H == 0 host h holds the whole
data rows [h*D/H, (h+1)*D/H) of the grid; its input stream is its own
(per-host file shards, batch_size examples a batch), and each rank keeps
the rows of its host-local data coordinate ``d_local`` of D/H. The
backend is agreed over the whole world from every rank's device
identity (agree_backend): one host cannot see that another maps its
ranks to the same card. The host-collective group (one gloo group per
local index, of the H ranks that share it) carries the host agreements
of parallel/distributed.py."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


def choose_backend(devices: Sequence[torch.device]) -> str:
    """nccl when every position has its own card, gloo otherwise."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    if any(d.type not in ("cuda", "cpu") for d in devs):
        raise ValueError(f"unsupported mesh devices {devices!r} (cuda or cpu)")
    return "gloo"


def device_identity(device: torch.device) -> str:
    """What tells two ranks' devices apart across hosts: a card's UUID
    (two host processes on one machine may both say cuda:0), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    props = torch.cuda.get_device_properties(device)
    return f"cuda:{getattr(props, 'uuid', None) or device.index}"


def agree_backend(store, rank: int, world: int, device: torch.device, timeout_s: float) -> str:
    """The backend every rank takes, from every rank's device identity
    exchanged through ``store`` before the process group exists: nccl
    when every rank has a card of its own, gloo otherwise."""
    import datetime

    store.set(f"device/{rank}", json.dumps(device_identity(device)))
    store.wait([f"device/{r}" for r in range(world)], datetime.timedelta(seconds=timeout_s))
    ids = [json.loads(store.get(f"device/{r}")) for r in range(world)]
    if all(i.startswith("cuda:") for i in ids) and len(set(ids)) == world:
        return "nccl"
    return "gloo"


def mesh_devices(data: int, model: int, device: str) -> List[torch.device]:
    """One device a position: the visible cards in order on cuda (as many
    as the mesh has positions), every position on the CPU otherwise."""
    n = data * model
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if count < n:
        raise ValueError(
            f"a {data}x{model} mesh needs {n} cards, {count} visible; pass an explicit "
            "device list (launch.run_on_mesh(devices=...)) to put several ranks on one card"
        )
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: its coordinates (d, m), its device,
    the backend, and the process groups of its two axes."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Any
    model_group: Any
    hosts: int = 1

    @property
    def d(self) -> int:
        return self.rank // self.model

    @property
    def m(self) -> int:
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def local_data(self) -> int:
        """D/H: the data coordinates of one host."""
        return self.data // self.hosts

    @property
    def host(self) -> int:
        return self.d // self.local_data

    @property
    def d_local(self) -> int:
        """The rank's data coordinate within its host's rows."""
        return self.d % self.local_data

    def any_rank(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any (a SUM over the
        whole mesh)."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int64, device=self.device)
        dist.all_reduce(t)
        return bool(t.item() > 0)

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        """In-place SUM of ``x`` over the data axis (no collective at D=1)."""
        if self.data > 1:
            dist.all_reduce(x, group=self.data_group)
        return x

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        """In-place SUM of ``x`` over the model axis (no collective at M=1)."""
        if self.model > 1:
            dist.all_reduce(x, group=self.model_group)
        return x

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """In place: every rank gets rank 0's ``x``."""
        if self.size > 1:
            dist.broadcast(x, src=0)
        return x

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def make_mesh(
    data: int = -1,
    model: int = 1,
    devices: Optional[Sequence[Any]] = None,
    hosts: int = 1,
) -> Mesh:
    """The calling rank's Mesh over the initialised default process group
    (world size = data * model; data = -1 takes world // model). ``devices``
    lists the device of every rank in rank order (default: the visible
    cards, or the CPU for every rank when the backend is gloo without
    cards); several ranks may share a card, as with JAX's
    make_mesh(devices=...). ``hosts`` > 1 lays the ranks over H hosts
    (rank r on host r // (world/H)), makes the host-collective groups and
    registers this rank's (parallel/distributed.set_host_group). Every
    rank calls this with the same arguments: the groups are made in the
    same order everywhere."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data == -1:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, the group has {world}")
    if devices is None:
        devices = (mesh_devices(data, model, "cuda") if dist.get_backend() == "nccl"
                   else [torch.device("cpu")] * world)
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    grid = [[d * model + m for m in range(model)] for d in range(data)]
    data_group = model_group = None
    # every rank makes every group, in the same order
    for m in range(model):
        g = dist.new_group([grid[d][m] for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group(grid[d])
        if rank // model == d:
            model_group = g
    host_group = None
    if hosts > 1:
        if data % hosts:
            raise ValueError(f"the data axis {data} does not divide over {hosts} hosts")
        from tf_repos_tpu_torch.parallel.distributed import set_host_group

        per = world // hosts
        for local in range(per):
            g = dist.new_group([h * per + local for h in range(hosts)], backend="gloo")
            if rank % per == local:
                host_group = g
        set_host_group(hosts, rank // per, host_group)
    return Mesh(data, model, rank, devices[rank], dist.get_backend(), data_group, model_group,
                hosts)
