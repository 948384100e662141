"""Named device meshes over the ``torch.distributed`` process group.

The counterpart of ``repro/launch/mesh.py`` with ``jax.make_mesh``: a mesh
is a row-major layout of the process group's ranks over named axes, one
process per rank. :func:`make_mesh` builds it over
``torch.distributed.device_mesh.init_device_mesh`` (one process group per
axis) and wraps it in :class:`Mesh`, which reads as the reference's mesh
(``axis_names``, ``shape[axis]``) and carries the collectives the ZeRO-1
path needs over any subset of the axes, with the blocks in the order of
the reference's ``P(axes)`` layout (:meth:`Mesh.shard_index`).

Building a mesh creates process groups: every rank must call
:func:`make_mesh` with the same arguments, in the same order. The process
group itself is the caller's (``torch.distributed.init_process_group``;
``launch.train`` takes it from the environment ``torchrun`` sets). Install
a mesh with ``parallel.sharding.set_mesh``.

Backends: ``nccl`` runs the collectives on the card, one card a rank.
``gloo`` runs them in host memory: a CUDA tensor is copied to the host,
reduced or gathered there and copied back (what gloo's own CUDA path does),
which lets several ranks share one card. The mesh's device type follows:
``cuda`` under nccl, ``cpu`` under gloo.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist


class Mesh:
    """A named mesh of the process group's ranks (row-major over
    ``shape``). ``device_mesh`` is the ``torch.distributed`` DeviceMesh;
    ``backend`` the process group's."""

    def __init__(self, device_mesh, backend: str):
        self.device_mesh = device_mesh
        self.backend = backend
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: device_mesh.size(i)
                      for i, a in enumerate(self.axis_names)}
        self.rank = dist.get_rank()
        if math.prod(self.shape.values()) != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} does not cover the "
                             f"{dist.get_world_size()} ranks of the group")
        # groups over two or more (not all) axes: every rank creates every
        # coset's group, in one order, and keeps its own
        self._groups = {}
        for k in range(2, len(self.axis_names)):
            for subset in itertools.combinations(self.axis_names, k):
                for ranks in self._cosets(subset):
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[frozenset(subset)] = group

    def coords(self, rank: int) -> dict[str, int]:
        """``rank``'s position along each axis."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return out

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def shard_index(self, axes, rank: int | None = None) -> int:
        """The linear position of ``rank`` (this one by default) along
        ``axes``, row-major in the order given: the block it holds of a dim
        split over ``axes``."""
        c = self.coords(self.rank if rank is None else rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def _cosets(self, axes):
        """The rank sets that differ only along ``axes``."""
        cosets = {}
        for r in range(self.size(self.axis_names)):
            c = self.coords(r)
            cosets.setdefault(tuple(c[a] for a in self.axis_names
                                    if a not in axes), []).append(r)
        return list(cosets.values())

    def group(self, axes):
        """This rank's process group over ``axes``."""
        if set(axes) == set(self.axis_names):
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[frozenset(axes)]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_gather(self, t: torch.Tensor, axes) -> list[torch.Tensor]:
        """Every shard's ``t`` along ``axes``, in shard order, on ``t``'s
        device."""
        group = self.group(axes)
        src = t.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size(axes))]
        dist.all_gather(parts, src, group=group)
        # the list is in group-rank order; put it in shard order
        members = dist.get_process_group_ranks(group)
        order = sorted(range(len(members)),
                       key=lambda i: self.shard_index(axes, members[i]))
        return [parts[i].to(t.device) for i in order]

    def all_reduce_sum_(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed over ``axes`` in place. Every rank receives the same
        bits: the all-reduce reduces each element once and hands the
        result to every member."""
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group(axes))
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group(axes))
        return t


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str | None = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over the process group
    (its size must be ``prod(shape)``). ``device_type``: the DeviceMesh's,
    by default ``cuda`` under nccl and ``cpu`` under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first")
    backend = dist.get_backend()
    if device_type is None:
        device_type = "cuda" if backend == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape),
                          mesh_dim_names=tuple(axes))
    return Mesh(dm, backend)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (data=16, model=16), or with
    ``multi_pod`` (pod=2, data=16, model=16). Built only at that world
    size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {math.prod(shape)} ranks")
    return make_mesh(shape, axes)
