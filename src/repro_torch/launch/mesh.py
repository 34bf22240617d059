"""The port's meshes (``repro.launch.mesh``): the 1-D ``shards`` mesh that
the K-sharded round runs on (``make_host_mesh``), and the named meshes of
the model zoo (``make_mesh``, ``make_production_mesh``).

JAX's ``shard_map`` runs every shard of a mesh inside one process.  The port
runs one process per device under ``torch.distributed``: a ``HostMesh`` names
this process's rank, the group's size and the device the rank computes on,
and carries the collectives the round needs (``psum`` and ``pmax`` are
``all_reduce`` SUM and MAX, ``all_gather`` gathers equal slabs in rank
order).  A one-rank mesh calls them too, so one card runs the code path that
D > 1 runs.

On a gloo group of host tensors, a small ``psum`` (3 to ``EXCHANGE_MAX``
elements) and a small ``all_gather`` go through one ``all_to_all`` round,
every rank sending its slab to every other, in place of gloo's ring, which
takes ``2 (D - 1)`` rounds of messages in turn (the allocator's block sums
are 15 elements).  A round costs a wake-up of every rank, which on a busy
host is what a collective's time is made of.  The sum then adds the ranks'
values in the ring's own order (``_ring_order``), so its bits are
``all_reduce``'s.  One or two elements take gloo's ring, whose empty
segments send nothing: cheaper than the round.

The caller starts the process group; nothing here opens a socket::

    # one card: a one-rank NCCL group, no network and no port
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_host_mesh(1)
    # D CPU processes (the tests): gloo over a file store, one process per rank
    dist.init_process_group("gloo", store=dist.FileStore(path, D), rank=r, world_size=D)
    mesh = make_host_mesh(D, device="cpu")
    # D ranks sharing one card (NCCL refuses two ranks on one device): gloo
    # over the card's tensors; a runner then steps uncaptured (``captures``)
    dist.init_process_group("gloo", store=dist.FileStore(path, D), rank=r, world_size=D)
    mesh = make_host_mesh(D, device="cuda:0")

``make_mesh`` names the axes of a ``torch.distributed`` ``DeviceMesh`` over
the same group, for the model zoo's sharded paths (``models.sharding``):
parameters are DTensors placed by the logical rules, one process a device.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["HostMesh", "make_host_mesh", "make_mesh", "make_production_mesh", "PRODUCTION_MESH", "axis_sizes"]


EXCHANGE_MAX = 256  # the most elements a gloo collective of host tensors sends in one all_to_all round
_EXCHANGE_SUM = (torch.float32, torch.float64, torch.int32, torch.int64)  # dtypes gloo adds as C++ does


@functools.lru_cache(maxsize=None)
def _ring_order(n: int, D: int) -> torch.Tensor:
    """``(D, n)``: the ranks in the order gloo's ring ``all_reduce`` adds
    element ``e`` of an ``n``-element tensor (``gloo/allreduce.cc``, ring):
    the tensor is cut into ``2 D`` segments of ``ceil(n / 2D)`` elements,
    segment ``s`` starts on rank ``r0 = (s // 2 - 1) mod D``, and each rank
    down the ring adds its own value to the running sum, ranks ``r0, r0 - 1,
    ..., r0 - D + 1``."""
    seg = -(-n // (2 * D))
    r0 = (torch.arange(n) // seg // 2 - 1) % D
    return (r0[None, :] - torch.arange(D)[:, None]) % D


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """This process's place on a 1-D mesh of ``size`` ranks over the default
    process group, and the mesh's collectives."""

    size: int
    rank: int
    device: torch.device

    def _exchanges(self, v: torch.Tensor) -> bool:
        """Whether ``v`` crosses the ranks in one ``all_to_all`` round (the
        module docstring): a small host tensor on a gloo group."""
        return (self.size > 1 and v.device.type == "cpu" and v.numel() <= EXCHANGE_MAX
                and dist.get_backend() == "gloo")

    def _exchange(self, v: torch.Tensor) -> torch.Tensor:
        """``(size, n)``: every rank's ``v`` flattened, in rank order."""
        flat = v.contiguous().reshape(-1)
        out = flat.new_empty(self.size * flat.numel())
        dist.all_to_all_single(out, flat.repeat(self.size))
        return out.reshape(self.size, -1)

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        """The sum of ``v`` over the ranks (a new tensor on every rank)."""
        if v.numel() > 2 and v.dtype in _EXCHANGE_SUM and self._exchanges(v):
            rows = self._exchange(v).gather(0, _ring_order(v.numel(), self.size))
            out = rows[0]
            for j in range(1, self.size):
                out = rows[j] + out
            return out.reshape(v.shape)
        out = v.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``v`` over the ranks."""
        out = v.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    @property
    def captures(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: an NCCL
        group's run on the device; a gloo group's (the tests', or two ranks
        sharing one card) go through host memory, which a capture cannot
        record."""
        return dist.get_backend() != "gloo"

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """Every rank's ``v``, flattened and concatenated in rank order:
        ``(size * v.numel(),)`` (``lax.all_gather(..., tiled=True)``)."""
        if self._exchanges(v):
            return self._exchange(v).reshape(-1)
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


def make_mesh(shape, axes, device=None):
    """A named ``DeviceMesh`` of ``shape`` over the default process group,
    which the caller has started (see the module docstring; the dry run
    starts a ``"fake"`` group of as many ranks as the mesh has devices).
    The product of ``shape`` must equal the group's size; ranks fill the
    mesh in row-major order, the last axis fastest, as ``jax.make_mesh``
    lays devices out.  ``device=None`` means CUDA (each rank on
    ``cuda:<rank mod device count>``) and raises without it; ``"cpu"`` makes
    a gloo or fake group's mesh.
    """
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a started process group: e.g. on one card "
            "dist.init_process_group('nccl', store=dist.HashStore(), rank=0, world_size=1)"
        )
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} has {math.prod(shape)} devices, but the group has {world} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else dist.get_rank() % torch.cuda.device_count())
    elif dist.get_backend() == "nccl":
        raise ValueError(f"an NCCL group reduces CUDA tensors; the mesh's device is {dev}")
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape), mesh_dim_names=axes)


# the dry run's meshes, with the JAX package's shapes and names
PRODUCTION_MESH = {
    "single": ((16, 16), ("data", "model")),  # 256 devices
    "multi": ((2, 16, 16), ("pod", "data", "model")),  # 512
}


def make_production_mesh(multi_pod: bool = False, device=None):
    """``PRODUCTION_MESH``'s ``"single"`` mesh, or with ``multi_pod`` its
    ``"multi"`` one.  The group must have that many ranks (a ``"fake"``
    group for a plan)."""
    return make_mesh(*PRODUCTION_MESH["multi" if multi_pod else "single"], device)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a named ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
