"""Device meshes and their collectives: one process per GPU.

Counterpart of halva_tpu/parallel/mesh.py. The reference lays a
`jax.sharding.Mesh` with the axes ("data", "model") over the chips of one
program, and XLA emits the collectives. Here each rank is a process that
holds its own shard of every leaf as a plain tensor (so the hand-written
kernels take it unchanged), the mesh is a `torch.distributed.device_mesh`
DeviceMesh over the ranks, and code calls the collectives below on
`mesh.group(axis)` where the reference has `psum` / `all_gather`.

Axes: "data" splits the batch (and, in training, FSDP's parameters);
"model" is tensor parallelism. Rank r sits at the row-major coordinates of
r in the mesh's shape, the reference's `devices.reshape(data, model)`.

`MeshShape` is a mesh's sizes and one rank's coordinates without any
process group: the spec and placement functions of partition.py read only
that, so they run (and are tested) without processes. `make_mesh` joins
the process group (NCCL for a CUDA device, gloo for the CPU) unless the
caller already has: from the environment under `torchrun` (`WORLD_SIZE`,
`RANK`, `MASTER_ADDR`, `MASTER_PORT`), else a one-process group on a free
local port. Two ranks on one card cannot share NCCL; they init gloo
themselves, which takes CUDA tensors for every collective here.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXIS_NAMES = (DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass
class MeshShape:
    """A mesh's axis sizes (`shape`, in axis order) and one rank's
    coordinates on them (`coords`, 0 on an axis it does not name), and the
    device its shards live on."""

    shape: Dict[str, int]
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)


@dataclasses.dataclass
class Mesh(MeshShape):
    """A MeshShape whose ranks are joined: `group(axis)` is the process
    group of the ranks that differ from this one only along `axis`."""

    device_mesh: Optional[object] = None

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


def mesh_shape(shape: Dict[str, int], rank: int = 0,
               device="cpu") -> MeshShape:
    """The MeshShape of `rank` in a mesh of `shape` (row-major)."""
    coords, rest = {}, rank
    for axis in reversed(list(shape)):
        coords[axis] = rest % shape[axis]
        rest //= shape[axis]
    return MeshShape(dict(shape), {a: coords[a] for a in shape},
                     torch.device(device))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device=None) -> torch.device:
    """`device` with its index: a CUDA device without one is this rank's
    card, `cuda:LOCAL_RANK` (torchrun sets it; 0 without it)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def init_process_group(device) -> None:
    """Join the default process group, unless this process has: from the
    environment under torchrun, else a world of one on a free local port.
    NCCL for a CUDA device (which becomes the current one), gloo
    otherwise."""
    if dist.is_initialized():
        return
    device = rank_device(device)
    backend = "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1)


def axes_mesh(shape: Dict[str, int], device=None) -> Mesh:
    """A mesh of the named axes over every rank of the default group, which
    is joined first (init_process_group); the product of the sizes must be
    the world size. `device`: this rank's device, its card by default."""
    device = rank_device(device)
    init_process_group(device)
    n = dist.get_world_size()
    sizes = list(shape.values())
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError("x".join(map(str, sizes)) + f" != {n} devices")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, tuple(sizes),
                          mesh_dim_names=tuple(shape))
    me = mesh_shape(shape, dist.get_rank(), device)
    return Mesh(me.shape, me.coords, device, dm)


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """A (data, model) mesh over every rank; data=None takes the ranks the
    model axis leaves. `device`: this rank's device, its card by default."""
    if data is None:
        init_process_group(rank_device(device))
        n = dist.get_world_size()
        if n % model:
            raise ValueError(f"{n} devices do not divide model={model}")
        data = n // model
    return axes_mesh({DATA_AXIS: data, MODEL_AXIS: model}, device)


def single_device_mesh(device=None) -> Mesh:
    """The {1, 1} mesh of a one-process world."""
    return make_mesh(data=1, model=1, device=device)


# --------------------------------------------------------------------------
# Collectives on one axis's group; a group of one rank returns its input.
# --------------------------------------------------------------------------


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # all_gather_single replaces all_gather_into_tensor in newer torch
    fn = getattr(dist, "all_gather_single", None) or (
        dist.all_gather_into_tensor)
    fn(out, x, group=group)


def _scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or (
        dist.reduce_scatter_tensor)
    fn(out, x, group=group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group's ranks (the reference's psum)."""
    if dist.get_world_size(group) == 1:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' `t` concatenated along `dim` in group-rank order (the
    reference's tiled all_gather), contiguous."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _gather_into(out, x, group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of `t` over the ranks, this rank's 1/n chunk along `dim`:
    the transpose of all_gather."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide {n} ranks")
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _scatter_into(out, x, group)
    return out.movedim(0, dim).contiguous()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group's ranks, for a quantity every rank then
    uses whole (a batch-global loss term): its backward passes the gradient
    through unchanged, since each rank holds the same d(loss)/d(sum), and a
    summing backward would count it once per rank. group None: `t`."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _Psum.apply(t, group)
