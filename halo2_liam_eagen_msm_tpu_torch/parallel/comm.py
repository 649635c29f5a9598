"""The mesh and its collectives on torch.distributed: the port's counterpart
of the jax.lax collectives that the JAX package's parallel modules call
inside shard_map.

A Mesh is this rank's view of a grid of ranks: one process group for each
axis (the ranks that differ from this one only along that axis, in axis
order), this rank's coordinate on each axis, the device its tensors live on
and the backend.  The collectives keep jax.lax's semantics:

  * all_gather(x, mesh, axis, dim): the shards stacked on a new dimension
    `dim`, in source order
  * all_to_all(x, mesh, axis, dim): x split into equal chunks along `dim`,
    chunk j sent to coordinate j, the received chunks concatenated along
    `dim` in source order
  * ppermute(x, mesh, axis, perm): perm lists (source, destination) pairs of
    coordinates; a coordinate that no source sends to gets zeros
  * psum(x, mesh, axis): the sum over the axis

Staging: NCCL takes device tensors as they are.  Gloo is handed host
tensors: a CUDA tensor is copied to the host for the collective and the
result copied back to its device.  The group's backend decides which, once,
when the mesh is made.

Every rank of the world must make every mesh, in the same order (group
creation is collective over the world); a rank outside a mesh gets None.
Each collective adds the bytes this rank hands to the other ranks to
mesh.sent, by kind, as if it sent its payload straight to each peer: an
all_gather or psum of b bytes counts b (D - 1), an all_to_all b (D - 1) / D,
a ppermute b for each destination other than itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..config import resolve_device

KINDS = ("all_gather", "all_to_all", "ppermute", "psum")


@dataclass
class Mesh:
    axis_names: tuple
    shape: tuple
    groups: dict        # axis -> process group of this rank's line along it
    coords: dict        # axis -> this rank's coordinate
    device: torch.device
    backend: str
    sent: dict = field(default_factory=lambda: dict.fromkeys(KINDS, 0))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors cross through host memory (gloo)."""
        return self.backend == "gloo"


def make_mesh(n_devices: int | None = None, axis: str = "data", device="cuda"):
    """1-D mesh over global ranks 0 .. n_devices - 1 (default: the world).
    Every rank of the world calls it; ranks outside the mesh get None."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.new_group(ranks=list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh((axis,), (n,), {axis: group}, {axis: rank}, resolve_device(device),
                dist.get_backend(group))


def make_mesh_2d(n_dcn: int, n_ici: int | None = None, axes=("dcn", "ici"), device="cuda"):
    """Hierarchical (dcn, ici) mesh over the whole world, ranks in contiguous
    order (rank = i_dcn * n_ici + i_ici): on one host there are no slice
    boundaries to follow.  Requires exactly n_dcn x n_ici ranks."""
    world = dist.get_world_size()
    if n_ici is None:
        if world % n_dcn:
            raise ValueError(f"{world} ranks do not split into {n_dcn} rows")
        n_ici = world // n_dcn
    if world != n_dcn * n_ici:
        raise ValueError(f"need exactly {n_dcn}x{n_ici} ranks, have {world}")
    rows = [dist.new_group(ranks=[i * n_ici + j for j in range(n_ici)]) for i in range(n_dcn)]
    cols = [dist.new_group(ranks=[i * n_ici + j for i in range(n_dcn)]) for j in range(n_ici)]
    i, j = divmod(dist.get_rank(), n_ici)
    dcn, ici = axes
    return Mesh(tuple(axes), (n_dcn, n_ici), {dcn: cols[j], ici: rows[i]}, {dcn: i, ici: j},
                resolve_device(device), dist.get_backend(rows[i]))


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.coords[axis]


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[mesh.axis_names.index(axis)]


def _wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor handed to the backend: a contiguous host copy of a CUDA
    tensor for gloo, x itself (contiguous) otherwise."""
    if x.is_cuda and mesh.staged:
        return x.detach().contiguous().cpu()
    return x.detach().contiguous()


def all_gather(x, mesh: Mesh, axis: str, dim: int = 0):
    """(shape) -> shape with a new dimension of size D at `dim`, the shards
    in source order."""
    size = axis_size(mesh, axis)
    w = _wire(mesh, x)
    parts = [torch.empty_like(w) for _ in range(size)]
    dist.all_gather(parts, w, group=mesh.groups[axis])
    mesh.sent["all_gather"] += w.nbytes * (size - 1)
    return torch.stack(parts, dim=dim).to(x.device)


def gather_shards(x, mesh: Mesh, axis: str):
    """The whole of a result sharded on dim 0 over `axis` (what JAX returns
    with out_specs=P(axis)): the shards concatenated in axis order."""
    return all_gather(x, mesh, axis).flatten(0, 1)


def all_to_all(x, mesh: Mesh, axis: str, dim: int):
    """Split x into D equal chunks along `dim`, send chunk j to coordinate j,
    concatenate the received chunks along `dim` in source order."""
    size = axis_size(mesh, axis)
    if x.shape[dim] % size:
        raise ValueError(f"all_to_all: dimension {dim} of {tuple(x.shape)} does not split "
                         f"into {size} chunks")
    w = _wire(mesh, x.movedim(dim, 0))
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.groups[axis])
    mesh.sent["all_to_all"] += w.nbytes * (size - 1) // size
    return out.to(x.device).movedim(0, dim)


def ppermute(x, mesh: Mesh, axis: str, perm):
    """perm: (source, destination) coordinate pairs, each source and each
    destination at most once.  Returns what this coordinate receives, zeros
    where no source sends to it."""
    me, group = mesh.coords[axis], mesh.groups[axis]
    w = _wire(mesh, x)
    out = torch.zeros_like(w)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(w)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, dst), group))
            mesh.sent["ppermute"] += w.nbytes
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


def psum(x, mesh: Mesh, axis: str):
    """Sum of x over the axis (integer tensors: an exact sum)."""
    size = axis_size(mesh, axis)
    w = _wire(mesh, x).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    mesh.sent["psum"] += w.nbytes * (size - 1)
    return w.to(x.device)
