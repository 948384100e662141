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
``gloo`` runs them in host memory, which lets several ranks share one card:
a CUDA tensor is staged through pinned host buffers that the mesh keeps
and reuses (one device-to-host copy before a collective and one
host-to-device copy after it, whatever the number of parts), and the
tensors of one dtype that travel together go as one flat buffer
(:meth:`Mesh.all_gather_many`). Staging only copies: the bits are those
of the collective on host tensors. The mesh's device type follows: ``cuda``
under nccl, ``cpu`` under gloo.
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
        self._members: dict[tuple, list[int]] = {}
        self._buffers: dict[str, torch.Tensor] = {}
        #: whether ``reduce_scatter_sum`` runs the backend's reduce-scatter
        #: (nccl's; gloo's, which torch ships since 2.x) or, for a backend
        #: without one, an all-reduce and a cut
        self.reduce_scatter = backend in _REDUCE_SCATTER_BACKENDS
        self.reset_counts()

    def reset_counts(self) -> None:
        """Zero :attr:`counts`: ``{collective: [calls, bytes]}`` of this
        rank's collectives (an all-gather's bytes are the gathered
        buffer's, a reduction's its input's)."""
        self.counts = {"all_gather": [0, 0], "all_reduce": [0, 0],
                       "reduce_scatter": [0, 0], "all_to_all": [0, 0]}

    def _count(self, name: str, t: torch.Tensor) -> None:
        self.counts[name][0] += 1
        self.counts[name][1] += t.numel() * t.element_size()

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

    def members(self, axes) -> list[int]:
        """The ranks of this rank's group over ``axes``, in shard order
        (``shard_index`` 0, 1, ...)."""
        key = tuple(axes)
        if key not in self._members:
            ranks = dist.get_process_group_ranks(self.group(key))
            self._members[key] = sorted(
                ranks, key=lambda r: self.shard_index(key, r))
        return self._members[key]

    def _group_order(self, axes) -> list[int] | None:
        """The shard positions of the group's ranks in group-rank order
        (the order of gloo's and nccl's buffers), None when the two orders
        are one."""
        ranks = dist.get_process_group_ranks(self.group(tuple(axes)))
        order = [self.shard_index(tuple(axes), r) for r in ranks]
        return None if order == sorted(order) else order

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, role: str, numel: int, dtype) -> torch.Tensor:
        """A pinned host buffer of ``numel`` elements of ``dtype``: a view of
        the mesh's reusable buffer for ``role``, grown when too small. The
        copies into and out of it are synchronous, so a buffer is free again
        when the collective that used it returns."""
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        buf = self._buffers.get(role)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                              pin_memory=True)
            self._buffers[role] = buf
        return buf[:nbytes].view(dtype)

    def _gathered(self, src: torch.Tensor, axes) -> torch.Tensor:
        """(n, src.numel()) of every group member's flat ``src`` in group
        order: one all-gather."""
        n = self.size(axes)
        flat = src.reshape(-1)
        if self._staged(flat):
            host = self._host("send", flat.numel(), flat.dtype)
            host.copy_(flat)
            out = self._host("recv", n * flat.numel(), flat.dtype)
            self._all_gather_into(out, host, axes)
            return out.view(n, -1).to(src.device)
        out = torch.empty((n, flat.numel()), dtype=flat.dtype,
                          device=flat.device)
        self._all_gather_into(out.view(-1), flat, axes)
        return out

    def _all_gather_into(self, out, src, axes) -> None:
        self._count("all_gather", out)
        dist.all_gather_into_tensor(out, src, group=self.group(tuple(axes)))

    def all_gather_many(self, tensors: list[torch.Tensor], axes
                        ) -> list[list[torch.Tensor]]:
        """Every shard's ``tensors`` along ``axes`` (one dtype), through one
        all-gather of their concatenation: ``out[s][i]`` is shard ``s``'s
        ``tensors[i]``, shards in shard order, on the tensors' device."""
        if len({t.dtype for t in tensors}) != 1:
            raise ValueError("all_gather_many: one dtype a call")
        src = torch.cat([t.detach().reshape(-1) for t in tensors]) \
            if len(tensors) > 1 else tensors[0].detach().reshape(-1)
        rows = self._gathered(src, axes)
        order = self._group_order(axes)
        if order is not None:
            rows = rows[torch.tensor(sorted(range(len(order)),
                                            key=order.__getitem__),
                                     device=rows.device)]
        sizes = [t.numel() for t in tensors]
        return [[part.view(t.shape) for part, t in zip(row.split(sizes),
                                                        tensors)]
                for row in rows.unbind(0)]

    def all_gather(self, t: torch.Tensor, axes) -> list[torch.Tensor]:
        """Every shard's ``t`` along ``axes``, in shard order, on ``t``'s
        device."""
        return [parts[0] for parts in self.all_gather_many([t], axes)]

    def all_reduce_sum_(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed over ``axes`` in place. Every rank receives the same
        bits: the all-reduce reduces each element once and hands the
        result to every member."""
        self._count("all_reduce", t)
        if self._staged(t):
            host = self._host("send", t.numel(), t.dtype).view(t.shape)
            host.copy_(t)
            dist.all_reduce(host, group=self.group(axes))
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group(axes))
        return t

    def reduce_scatter_sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Shard ``s``'s chunk of the sum over ``axes`` of the flat ``t``
        (``n`` equal chunks in shard order), for this rank's ``s``: one
        reduce-scatter where the backend has one (:attr:`reduce_scatter`),
        else an all-reduce of ``t`` and the chunk cut out of it."""
        n = self.size(axes)
        flat = t.reshape(n, -1)
        order = self._group_order(axes)
        if order is not None:
            flat = flat[torch.tensor(order, device=flat.device)]
        mine = self.shard_index(tuple(axes))
        if not self.reduce_scatter:
            out = self.all_reduce_sum_(flat.clone(), axes)
            return out[mine if order is None else order.index(mine)]
        flat = flat.contiguous().view(-1)
        self._count("reduce_scatter", flat)
        chunk = flat.numel() // n
        if self._staged(flat):
            host = self._host("send", flat.numel(), flat.dtype)
            host.copy_(flat)
            out = self._host("recv", chunk, flat.dtype)
            dist.reduce_scatter_tensor(out, host, group=self.group(axes))
            return out.to(t.device)
        out = torch.empty(chunk, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat, group=self.group(axes))
        return out

    def all_to_all(self, parts: list[torch.Tensor], sizes: list[int], axes
                   ) -> list[torch.Tensor]:
        """Each shard's part for this rank along ``axes``: ``parts[s]`` is
        what this rank sends shard ``s`` (one dtype; empty where it sends
        nothing), ``sizes[s]`` the number of elements it receives from
        shard ``s``. Returns the received parts, flat, in shard order: one
        all-to-all of the flat parts (``all_to_all_single``: nccl's, and
        gloo's, which takes the staged host buffers). Only bits move."""
        n = self.size(axes)
        order = self._group_order(axes) or list(range(n))
        src = torch.cat([parts[s].detach().reshape(-1) for s in order])
        dev = src.device
        out_splits = [sizes[s] for s in order]
        in_splits = [parts[s].numel() for s in order]
        self._count("all_to_all", src)
        group = self.group(tuple(axes))
        if self._staged(src):
            host = self._host("send", src.numel(), src.dtype)
            host.copy_(src)
            recv = self._host("recv", sum(out_splits), src.dtype)
            dist.all_to_all_single(recv, host, out_splits, in_splits,
                                   group=group)
            recv = recv.to(dev)
        else:
            recv = torch.empty(sum(out_splits), dtype=src.dtype, device=dev)
            dist.all_to_all_single(recv, src, out_splits, in_splits,
                                   group=group)
        got = recv.split(out_splits)
        out = [None] * n
        for g, s in enumerate(order):
            out[s] = got[g]
        return out


#: the backends with a reduce-scatter of flat tensors
_REDUCE_SCATTER_BACKENDS = ("nccl", "gloo")


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
