"""FSDP's schedule in the train step: the parameters stay this rank's blocks
for the whole step, and each use site gathers the weights it reads.

The reference holds each parameter as a block under ``fsdp_tp``
(``sharding.param_spec``) and lets GSPMD gather a layer's weights inside the
scan body, again in the backward under ``jax.checkpoint``, and hand each
gradient back with its parameter's placement; the dense products it
derives from the placements run on each rank's ``model`` block
(Megatron's column / row pair). Here a :class:`Held` wraps the blocks of
one step; :func:`grad_fn` hands ``models.transformer.forward`` and
``encode`` the blocks and :meth:`Held.use` (their ``use``), which they
call where a layer (or the embedding, the final norm and the unembedding,
the MTP head) runs.

:meth:`Held.use` returns the weights of one use site, cast to the compute
dtype, through :class:`_GatherOnUse`, one autograd function a site:

* forward: the site's split leaves are cast to the compute dtype and
  all-gathered as one flat buffer per (dtype, mesh axes) group
  (``Mesh.all_gather_many``), over each leaf's split axes; the views are
  new contiguous tensors, one a leaf. Two kinds of leaf keep their
  ``model`` block and are gathered over the data axes only: an expert
  leaf under ``fsdp_tp`` (``P(tp, dp, None)`` past its stacked dim:
  ``models.moe`` runs this rank's E/tp experts on it), and a leaf of a
  Megatron group (below).
* backward: each gradient goes back to the parameter's dtype, then to the
  step's accumulation dtype, and this rank keeps its block of the mean
  over the axes the batch was cut over (the step's ``dp``): over the axes
  that are both gathered and cut, one reduce-scatter
  (``Mesh.reduce_scatter_sum``: the backend's own, gloo's included, else
  an all-reduce and a cut); over gathered axes the batch was not cut over
  (``model`` for a leaf gathered whole, whose ranks compute the same whole
  gradient, the models' mesh bodies included) a cut; over cut axes the
  leaf is not split over, an all-reduce. A leaf handed as its ``model``
  block comes back as this rank's block's gradient already: it is reduced
  over the batch-cut axes only. The sum over the ranks and the division
  are the gather-whole step's, so at two shares the blocks hold its bits.

Megatron groups: ``use``'s ``tp_sites`` (``models.transformer.
megatron_sites``) declares, for each group of a layer's leaves whose
products split by head or by hidden unit (``attn/``, ``xattn/``,
``mlp/``, ``moe/shared/``), which leaves are column-parallel (d_out on
``model``) and which row-parallel (d_in on ``model``), or the reason the
reference computes the group otherwise. A declared group takes the
Megatron route when each of its leaves is placed over ``model`` alone on
its declared dim (``fsdp_tp``; not ``decode_tp``, whose matrices split
over every axis at once, nor a dim ``_fit_spec`` left whole): its leaves
come as this rank's blocks and the group's ``sharding.MEGATRON`` key
names the axis, so the model code runs Megatron's ``f`` / ``g`` around
them (``parallel.collectives``). Any other group, and every undeclared
leaf, takes the gather route. :attr:`Held.log` records each group's
route and why (entries with a ``route`` key) beside every gather.

Between a site's forward and its backward no gathered weight stays alive.
Under ``cfg.remat`` the layer's gather runs inside the checkpointed function
and its recomputation in the backward is the second gather. Without it,
:meth:`Held.hooks` installs ``torch.autograd.graph.saved_tensors_hooks``
for the forward: a tensor an op saves whose storage is a gathered weight's
is packed as a handle (the site, the leaf, its view's size, stride and
offset), and unpacking gathers the site again, once for all its leaves (the
site's cache, dropped in its backward). The hooks' handles carry the mesh,
so they run on autograd's device thread as well.

A weight used at two sites of one forward (tied embeddings, the MTP head's
embedding) is gathered once and lives until its last use, so its gradients
add up on the whole before one reduction, as in the gather-whole step.
What lives at once in the forward: the gathered weights (whole, or
blocks) of the site that runs, and that non-layer weight; in the backward
one site's regathered weights. ``Held.live_bytes`` / ``peak_live_bytes``
count them; :attr:`Held.log` records every group a site hands out, its
axes (none where a block is handed without a collective) and bytes
(``Mesh.counts`` every collective).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable

import torch

from repro_torch.models.transformer import cast_dtype
from repro_torch.parallel import sharding


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One split leaf at a use site: its path, the placement of the tensor
    the site gathers (a stacked leaf's per-layer view drops the layers'
    dim), the dims it gathers (``dims``: (dim, axes, blocks)), the shape it
    gathers to, the compute dtype and the parameter's dtype."""

    path: str
    dims: tuple
    whole: tuple
    block: tuple
    cast: torch.dtype
    dtype: torch.dtype
    axes: tuple          # the gathered axes, in the mesh's order


def _narrow(t: torch.Tensor, leaf: _Leaf, mesh, rank: int) -> torch.Tensor:
    """``rank``'s block of the gathered ``t``."""
    for d, axes, _ in leaf.dims:
        size = leaf.block[d]
        t = t.narrow(d, mesh.shard_index(axes, rank) * size, size)
    return t


class _Site:
    """One use site's split leaves and their blocks: what gathers them
    (again) and reduces their gradients."""

    def __init__(self, held: "Held", leaves: list[_Leaf], blocks, tag):
        self.held, self.leaves, self.tag = held, leaves, tag
        self.blocks = [b.detach() for b in blocks]
        self.groups: dict[tuple, list[int]] = {}
        for i, leaf in enumerate(leaves):
            self.groups.setdefault((leaf.axes, leaf.cast), []).append(i)
        self.cache = None

    def gather(self) -> list[torch.Tensor]:
        held, mesh = self.held, self.held.mesh
        phase = "forward" if held.in_forward else "backward"
        out: list = [None] * len(self.leaves)
        for (axes, cdt), idxs in self.groups.items():
            srcs = [self.blocks[i].to(cdt) for i in idxs]
            if axes:
                parts = mesh.all_gather_many(srcs, axes)
                ranks = mesh.members(axes)
            else:
                parts, ranks = [srcs], [mesh.rank]
            for j, i in enumerate(idxs):
                leaf = self.leaves[i]
                whole = torch.empty(leaf.whole, dtype=cdt,
                                    device=srcs[j].device)
                for rank, row in zip(ranks, parts):
                    _narrow(whole, leaf, mesh, rank).copy_(row[j])
                out[i] = whole
            # a group with no axes (a ``model`` block with one data
            # block) is handed without a collective
            held.log.append({
                "phase": phase, "tag": self.tag, "axes": axes,
                "paths": [self.leaves[i].path for i in idxs],
                "bytes": sum(out[i].numel() * out[i].element_size()
                             for i in idxs)})
        return out

    def regathered(self, i: int) -> torch.Tensor:
        """Leaf ``i`` gathered again (the site's first unpack gathers every
        leaf of it; the cache lives until the site's backward)."""
        if self.cache is None:
            self.cache = self.gather()
            self.held._grow(sum(t.numel() * t.element_size()
                                for t in self.cache))
        return self.cache[i]

    def release(self) -> None:
        if self.cache is not None:
            self.held._grow(-sum(t.numel() * t.element_size()
                                 for t in self.cache))
            self.cache = None

    def reduce(self, grads) -> list[torch.Tensor]:
        """This rank's block of each whole gradient's mean over the batch
        cut (module docstring)."""
        held, mesh = self.held, self.held.mesh
        cut = held.grad_axes
        n_cut = mesh.size(cut) if cut else 1
        out: list = [None] * len(self.leaves)
        for (axes, _), idxs in self.groups.items():
            gs = [grads[i].to(self.leaves[i].dtype).to(held.accum_dtype)
                  for i in idxs]
            red = tuple(a for a in axes if a in cut)
            rest = tuple(a for a in cut if a not in axes)
            if red:
                flat = torch.cat([_narrow(g, self.leaves[i], mesh,
                                          rank).reshape(-1)
                                  for rank in mesh.members(red)
                                  for i, g in zip(idxs, gs)])
                mine = mesh.reduce_scatter_sum(flat, red)
            else:
                mine = torch.cat([_narrow(g, self.leaves[i], mesh,
                                          mesh.rank).reshape(-1)
                                  for i, g in zip(idxs, gs)])
            if rest:
                mesh.all_reduce_sum_(mine, rest)
            if cut:
                mine.div_(n_cut)
            sizes = [torch.Size(self.leaves[i].block).numel() for i in idxs]
            for i, part in zip(idxs, mine.split(sizes)):
                out[i] = part.view(self.leaves[i].block)
        return out


class _GatherOnUse(torch.autograd.Function):
    """A use site's blocks -> its whole weights; backward, each whole
    gradient -> this rank's block of its mean over the batch cut."""

    @staticmethod
    def forward(ctx, site, *blocks):
        ctx.site = site
        wholes = site.gather()
        for i, t in enumerate(wholes):
            site.held._register(t, site, i)
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        site = ctx.site
        site.release()
        return (None, *site.reduce(grads))


class _Saved:
    """A packed saved tensor: a view of a gathered weight."""

    __slots__ = ("site", "i", "size", "stride", "offset")

    def __init__(self, site, i, t):
        self.site, self.i = site, i
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class Held:
    """This rank's parameter blocks for one forward and backward.

    ``blocks``: ``{path: block}`` (the leaves autograd differentiates);
    ``specs``: their placements; ``whole``: the whole shapes (meta tensors
    do); ``grad_axes``: the axes the batch is cut over (the gradients'
    mean); ``accum_dtype``: the gradients' dtype; ``cast(path, tensor)``:
    the compute dtype of a leaf (``models.transformer.cast_dtype``)."""

    def __init__(self, blocks: dict, specs: dict, whole: dict, mesh,
                 grad_axes: tuple, accum_dtype: torch.dtype,
                 cast: Callable):
        self.blocks, self.specs, self.mesh = blocks, specs, mesh
        self.whole = {k: tuple(v.shape) for k, v in whole.items()}
        self.grad_axes = tuple(grad_axes)
        self.accum_dtype = accum_dtype
        self.cast = cast
        self.in_forward = False
        self.log: list[dict] = []
        self.live_bytes = self.peak_live_bytes = 0
        self._live: dict[int, tuple] = {}
        self._leaves: dict[tuple, _Leaf | None] = {}
        self._experts_by_block = (sharding.layout_policy() == "fsdp_tp"
                                  and sharding.tp_axis(mesh) is not None)

    def _entries(self, path: str, t: torch.Tensor) -> list:
        """The placement entries of the tensor the site is handed (a
        stacked leaf's layer view drops the layers' dim)."""
        whole = self.whole[path]
        entries = list(self.specs[path].spec(len(whole)))
        if entries and t.dim() == len(whole) - 1:
            if entries[0] is not None:
                raise ValueError(f"{path}: the layers' dim is split")
            entries = entries[1:]
        return entries

    def _leaf(self, path: str, t: torch.Tensor,
              by_block: bool = False) -> _Leaf | None:
        key = (path, t.dim(), by_block)
        if key in self._leaves:
            return self._leaves[key]
        leaf = None
        if self.specs[path].splits(self.mesh):
            entries = self._entries(path, t)
            tp = sharding.tp_axis(self.mesh)
            if by_block or (self._experts_by_block and
                            sharding.is_expert_leaf(path,
                                                    len(self.whole[path]))):
                # this rank's ``model`` block (a Megatron leaf; an expert
                # leaf's E/tp experts), gathered over the data axes
                entries = [None if sharding._axes(e) == (tp,) else e
                           for e in entries]
            dims = tuple(sharding.Placement(tuple(entries)).splits(self.mesh))
            gathered = list(t.shape)
            for d, _, n in dims:
                gathered[d] *= n
            axes = {a for _, ax, _ in dims for a in ax}
            leaf = _Leaf(path, dims, tuple(gathered), tuple(t.shape),
                         self.cast(path, t), t.dtype,
                         tuple(a for a in self.mesh.axis_names if a in axes))
        self._leaves[key] = leaf
        return leaf

    def _megatron(self, leaves: dict, prefix: str, tag, tp_sites
                  ) -> tuple[set, dict]:
        """The Megatron route of a site's declared groups (module
        docstring): the names handed as ``model`` blocks, and the markers
        of the groups that take it. A group takes it when each of its
        leaves is split over ``model`` alone on the declared dim (a
        column leaf's d_out, a row leaf's d_in) and over nothing else on
        ``model``; else (or where the model declared a reason) it takes
        the gather route. Each group's route is logged."""
        tp = sharding.tp_axis(self.mesh)
        names, marks = set(), {}
        for group, roles in (tp_sites or {}).items():
            why = roles if isinstance(roles, str) else None
            for leaf, role in ({} if why else roles).items():
                name = group + leaf
                if name not in leaves:
                    why = f"{name} is not at the site"
                    break
                entries = self._entries(prefix + name, leaves[name])
                dim = len(entries) - (1 if role == "col" else 2)
                on = [d for d, e in enumerate(entries)
                      if tp in sharding._axes(e)]
                if on != [dim] or sharding._axes(entries[dim]) != (tp,) \
                        or self.mesh.shape[tp] == 1:
                    why = (f"{name} ({role}) is placed "
                           f"{sharding.Placement(tuple(entries))}, not split "
                           f"over {tp!r} alone on dim {dim}")
                    break
            if why is None:
                names.update(group + leaf for leaf in roles)
                marks[group + sharding.MEGATRON] = tp
            self.log.append({
                "phase": "forward" if self.in_forward else "backward",
                "tag": prefix if tag is None else tag, "group": group,
                "route": "gather" if why else "megatron", "why": why,
                "paths": [] if isinstance(roles, str) else
                [prefix + group + leaf for leaf in roles]})
        return names, marks

    def use(self, leaves: dict, prefix: str = "", tag=None,
            tp_sites: dict | None = None) -> dict:
        """The weights of one use site, cast to the compute dtype:
        ``leaves`` are blocks (or a stacked leaf's per-layer views of
        them) keyed under ``prefix``; the split ones come through one
        :class:`_GatherOnUse`, whole or, for the groups of ``tp_sites``
        that take the Megatron route (:meth:`_megatron`), as this rank's
        ``model`` block, the group's ``sharding.MEGATRON`` key naming the
        axis; the others are cast as they are."""
        by_block, marks = self._megatron(leaves, prefix, tag, tp_sites)
        out, names, split, blocks = {}, [], [], []
        for name, t in leaves.items():
            leaf = self._leaf(prefix + name, t, name in by_block)
            if leaf is None:
                out[name] = t.to(self.cast(prefix + name, t))
            else:
                names.append(name)
                split.append(leaf)
                blocks.append(t)
        if split:
            site = _Site(self, split, blocks, prefix if tag is None else tag)
            wholes = _GatherOnUse.apply(site, *blocks)
            out.update(zip(names, wholes if isinstance(wholes, tuple)
                           else (wholes,)))
        return {**{name: out[name] for name in leaves}, **marks}

    # -- the live whole weights and the saved-tensor hooks ------------------
    def _grow(self, nbytes: int) -> None:
        self.live_bytes += nbytes
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _register(self, t: torch.Tensor, site: _Site, i: int) -> None:
        ptr = t.untyped_storage().data_ptr()
        nbytes = t.numel() * t.element_size()
        self._live[ptr] = (site, i)
        self._grow(nbytes)
        weakref.finalize(t, self._forget, ptr, nbytes)

    def _forget(self, ptr: int, nbytes: int) -> None:
        self._live.pop(ptr, None)
        self._grow(-nbytes)

    def _pack(self, t: torch.Tensor):
        if not t.numel():
            return t
        hit = self._live.get(t.untyped_storage().data_ptr())
        if hit is None or t.dtype != hit[0].leaves[hit[1]].cast:
            return t
        return _Saved(hit[0], hit[1], t)

    @staticmethod
    def _unpack(x):
        if not isinstance(x, _Saved):
            return x
        return x.site.regathered(x.i).as_strided(x.size, x.stride, x.offset)

    @contextlib.contextmanager
    def hooks(self):
        """The forward's scope: gathered weights an op saves are packed as
        handles and gathered again when the backward unpacks them."""
        self.in_forward = True
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield self
        finally:
            self.in_forward = False


def grad_fn(params: dict, specs: dict, whole: dict, mesh, grad_axes: tuple,
            accum_dtype: torch.dtype, loss_fn, batch: dict, cfg):
    """``loss_fn``'s gradients with respect to this rank's parameter blocks
    ``params``: the split leaves' come back as this rank's blocks of the
    mean over ``grad_axes``; the others as this rank's whole share (the
    caller averages them). Returns (grads, metrics, the :class:`Held`)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    held = Held(leaves, specs, whole, mesh, grad_axes, accum_dtype,
                lambda path, t: cast_dtype(path, t, cfg))
    with held.hooks():
        loss, metrics = loss_fn(leaves, batch, cfg, use=held.use)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), metrics, held
