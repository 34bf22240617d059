"""The 1-D ``shards`` mesh that the K-sharded round runs on (the port of
``repro.launch.mesh.make_host_mesh``).

JAX's ``shard_map`` runs every shard of a mesh inside one process.  The port
runs one process per device under ``torch.distributed``: a ``HostMesh`` names
this process's rank, the group's size and the device the rank computes on,
and carries the collectives the round needs (``psum`` and ``pmax`` are
``all_reduce`` SUM and MAX, ``all_gather`` gathers equal slabs in rank
order).  A one-rank mesh calls them too, so one card runs the code path that
D > 1 runs.

The caller starts the process group; nothing here opens a socket::

    # one card: a one-rank NCCL group, no network and no port
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_host_mesh(1)
    # D CPU processes (the tests): gloo over a file store, one process per rank
    dist.init_process_group("gloo", store=dist.FileStore(path, D), rank=r, world_size=D)
    mesh = make_host_mesh(D, device="cpu")
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["HostMesh", "make_host_mesh"]


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """This process's place on a 1-D mesh of ``size`` ranks over the default
    process group, and the mesh's collectives."""

    size: int
    rank: int
    device: torch.device

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        """The sum of ``v`` over the ranks (a new tensor on every rank)."""
        out = v.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``v`` over the ranks."""
        out = v.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """Every rank's ``v``, flattened and concatenated in rank order:
        ``(size * v.numel(),)`` (``lax.all_gather(..., tiled=True)``)."""
        out = v.new_empty(self.size * v.numel())
        # torch 2.11 has only this name; later releases add all_gather_single and warn here
        dist.all_gather_into_tensor(out, v.contiguous().reshape(-1))
        return out


def make_host_mesh(D: int | None = None, device=None) -> HostMesh:
    """The 1-D mesh over the default process group, which the caller has
    started (see the module docstring).  ``D`` defaults to the
    group's size and must equal it.  ``device=None`` means this rank's CUDA
    device (``cuda:<rank mod device count>``) and raises without CUDA; the
    tests pass ``device="cpu"``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs a started process group: e.g. on one card "
            "dist.init_process_group('nccl', store=dist.HashStore(), rank=0, world_size=1)"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    D = world if D is None else int(D)
    if D != world:
        raise ValueError(f"the mesh spans the whole process group: D={D}, but the group has {world} ranks")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dist.get_backend() == "nccl":
        raise ValueError(f"an NCCL group reduces CUDA tensors; the mesh's device is {dev}")
    return HostMesh(size=D, rank=rank, device=dev)
