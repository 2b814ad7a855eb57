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
mesh's collectives keep to those three."""

from __future__ import annotations

import dataclasses
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

    @property
    def d(self) -> int:
        return self.rank // self.model

    @property
    def m(self) -> int:
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model

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
) -> Mesh:
    """The calling rank's Mesh over the initialised default process group
    (world size = data * model; data = -1 takes world // model). ``devices``
    lists the device of every rank in rank order (default: the visible
    cards, or the CPU for every rank when the backend is gloo without
    cards); several ranks may share a card, as with JAX's
    make_mesh(devices=...). Every rank calls this with the same
    arguments: the groups are made in the same order everywhere."""
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
    return Mesh(data, model, rank, devices[rank], dist.get_backend(), data_group, model_group)
