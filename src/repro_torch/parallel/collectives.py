"""Collectives over the active mesh's axes with their backward: the
boundaries of the models' mesh bodies (``models.moe.moe_ffn``'s expert
parallelism, ``models.layers.sp_blockwise_attention``'s sequence
parallelism), where the reference writes a ``shard_map``.

Two kinds of axis meet a mesh body, and each collective's backward follows
from the kind:

* an axis the step cut the batch over (``sharding.batch_cut_axes``): each
  rank's loss is a share of the global loss and the train step averages
  the ranks' gradients over it. A collective's backward over such an axis
  is the same collective on the cotangents (the sum of a sum, the mean of
  a mean): :func:`all_reduce` with ``grad="same"``.
* any other axis (``model``; the data axes when the batch is whole on
  every rank): its ranks hold the same activations and the same loss, and
  each must end the backward with the whole gradient, as the step does
  not average over it. These are Megatron's pairs: a sum over the axis
  forward, the cotangent as it is backward (:func:`all_reduce` with
  ``grad="identity"``); a replicated input forward, a sum over the axis
  backward (:func:`replicated`); a block cut out of a whole tensor
  forward, the blocks' gradients all-gathered backward (:func:`cut`); an
  all-gather forward, this rank's block of the cotangent backward
  (:func:`gather`).

The weights of a train step under a mesh are gathered on use by
``parallel.fsdp`` (one autograd function a use site, its backward this
rank's block of the mean gradient), not here. Where a use site hands the
model code a group's Megatron leaves as this rank's ``model`` blocks
(:func:`megatron_axis`), the model runs Megatron's pair around them:
``f`` is :func:`replicated` on the group's input, ``g`` is
:func:`all_reduce` of the row-parallel output with ``grad="identity"``;
:func:`block_range` gives this rank's heads or hidden units.

Every function is the identity, with no collective, when its axes span
one rank. Blocks follow ``launch.mesh.Mesh.shard_index`` (the reference's
order). The all-reduces reduce each element once and hand every member the
same bits (``Mesh.all_reduce_sum_``), so the ranks stay bit-equal where
they must.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import sharding


def _mesh_axes(axes):
    mesh = sharding.active_mesh()
    if mesh is None:
        raise RuntimeError("a mesh collective needs an active mesh "
                           "(parallel.sharding.set_mesh)")
    axes = tuple(axes)
    return mesh, axes, mesh.size(axes) if axes else 1


def _sum(mesh, axes, t: torch.Tensor) -> torch.Tensor:
    return mesh.all_reduce_sum_(t.clone(memory_format=torch.contiguous_format),
                                axes)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, n, mean, grad):
        ctx.args = (mesh, axes, n, mean, grad)
        y = _sum(mesh, axes, x)
        return y.div_(n) if mean else y

    @staticmethod
    def backward(ctx, g):
        mesh, axes, n, mean, grad = ctx.args
        if grad == "same":
            g = _sum(mesh, axes, g)
            g = g.div_(n) if mean else g
        elif grad == "scale":
            g = g / n
        return g, None, None, None, None, None


def all_reduce(x: torch.Tensor, axes, *, mean: bool = False,
               grad: str = "identity") -> torch.Tensor:
    """The sum (``mean``: the mean) of ``x`` over ``axes``. Backward
    (``grad``): "identity" hands the cotangent on as it is (a sum of
    partials, or the mean of copies that are equal, on axes whose ranks
    each need the whole gradient); "same" runs the same collective on the
    cotangents (axes the step averages over); "scale" divides it by the
    axes' size (the mean of values that differ, where a :func:`replicated`
    input sums the ranks' gradients after)."""
    if grad not in ("identity", "same", "scale"):
        raise ValueError(f"all_reduce: grad {grad!r}")
    mesh, axes, n = _mesh_axes(axes)
    if n == 1:
        return x
    return _AllReduce.apply(x, mesh, axes, n, mean, grad)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _sum(mesh, axes, g), None, None


def replicated(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` as it is, entering a body replicated over ``axes`` whose ranks
    each compute a part of what depends on it: backward, the ranks'
    gradients summed."""
    mesh, axes, n = _mesh_axes(axes)
    if n == 1:
        return x
    return _Replicated.apply(x, mesh, axes)


def _block(x, dim, mesh, axes, n):
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.shard_index(axes) * size, size)


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, n):
        ctx.args = (dim, mesh, axes)
        return _block(x, dim, mesh, axes, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes = ctx.args
        return torch.cat(mesh.all_gather(g.contiguous(), axes), dim), \
            None, None, None, None


def cut(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's block of the whole ``x`` along ``dim`` over ``axes``
    (the reference's ``in_specs``); backward, the blocks' gradients
    all-gathered, so each rank holds the whole gradient."""
    mesh, axes, n = _mesh_axes(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"cut: dim {dim} of {tuple(x.shape)} does not "
                         f"split into {n} blocks over {axes}")
    return _Cut.apply(x, dim, mesh, axes, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, n):
        ctx.args = (dim, mesh, axes, n)
        return torch.cat(mesh.all_gather(x.contiguous(), axes), dim)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes, n = ctx.args
        return _block(g, dim, mesh, axes, n).contiguous(), None, None, None, \
            None


def gather(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """The blocks of every rank along ``dim`` over ``axes``, concatenated
    in shard order (the reference's ``out_specs``); backward, this rank's
    block of the cotangent."""
    mesh, axes, n = _mesh_axes(axes)
    if n == 1:
        return x
    return _Gather.apply(x, dim, mesh, axes, n)


def megatron_axis(p: dict, group: str):
    """The mesh axis over which a use site handed ``group``'s (``attn/``,
    ``mlp/``, ...) Megatron leaves of ``p`` as this rank's blocks
    (``sharding.MEGATRON``), None where they are whole."""
    return p.get(group + sharding.MEGATRON)


def block_range(n: int, axis) -> tuple[int, int]:
    """``[start, stop)`` of this rank's block of ``n`` units (heads, hidden
    units) cut into equal blocks over ``axis``, in shard order."""
    mesh, axes, size = _mesh_axes((axis,))
    if n % size:
        raise ValueError(f"block_range: {n} units do not split into {size} "
                         f"blocks over {axes}")
    per = n // size
    i = mesh.shard_index(axes)
    return i * per, (i + 1) * per
