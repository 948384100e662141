"""Placements on the active mesh: the data-parallel and ZeRO-1 part of
``repro/parallel/sharding.py``.

Every rank holds the whole parameters and runs the model on its slice of
the global batch (:func:`batch_specs_tree`); the train step averages the
loss and the gradients over the data axes (:func:`all_reduce_mean`). Under
ZeRO-1 each rank keeps only its row block of every eligible leaf's
optimizer state (:func:`opt_state_specs`, ``parallel.zero``).

A :class:`Placement` stands where the reference has a ``PartitionSpec``: the
dim an array is split on and the mesh axes it is split over (this rank
holds block ``mesh.shard_index(axes)``), or replicated. ``Placement.spec``
gives the PartitionSpec's entries as a tuple. Placement trees mirror the
state trees they describe; :func:`shard_tree` cuts a rank's blocks out of
whole arrays, :func:`gather_tree` all-gathers them back (checkpoints are
saved whole, ``train.checkpoint``).

The active mesh (``launch.mesh.Mesh``) is a context variable:
``with set_mesh(mesh): ...`` installs it for the thread (the reference takes
it from ``parallel/compat.py``, which the port does not need). Without one
every function here is an identity and the step runs as on one device.

The layout policy (:class:`ShardingPolicy`, ``use_policy``) is ported with
its names. The port's parameters replicate under every layout: the FSDP x
TP parameter placements (``logical_to_spec``, ``shard``, ``param_spec``,
``params_specs``, ``named_shardings``, the ``fsdp_tp`` / ``decode_tp``
layouts as DTensor placements), the sequence-parallel mesh path
(``seq_parallel``), ``cache_specs_tree`` and ``telemetry_specs`` come with
the next slice. So a non-ZeRO array of the optimizer state replicates
here, where the reference shape-matches it to its parameter's spec.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch

DP_AXES = ("pod", "data")   # batch / data-parallel axes (present subset)
TP_AXIS = "model"

LAYOUTS = ("fsdp_tp", "pure_dp", "decode_tp")


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The layout policy. ``layout``: "fsdp_tp" (default), "pure_dp"
    (the batch over every mesh axis) or "decode_tp"; ``seq_parallel``:
    the residual stream's sequence dim over ``model``. In this slice only
    the batch placement reads them (see the module docstring)."""

    layout: str = "fsdp_tp"
    seq_parallel: bool = False

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; "
                             f"allowed: {LAYOUTS}")


_POLICY: contextvars.ContextVar[ShardingPolicy] = contextvars.ContextVar(
    "repro_torch_sharding_policy", default=ShardingPolicy())
_MESH: contextvars.ContextVar[Any] = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None)


def current_policy() -> ShardingPolicy:
    return _POLICY.get()


@contextlib.contextmanager
def use_policy(policy: ShardingPolicy | None = None, **replacements):
    """Scope a layout policy: ``with use_policy(layout="pure_dp"): ...``,
    a whole :class:`ShardingPolicy` or field replacements over the current
    one; the previous policy is back on exit."""
    if policy is None:
        policy = dataclasses.replace(current_policy(), **replacements)
    elif replacements:
        raise TypeError("pass either a policy object or field replacements,"
                        " not both")
    token = _POLICY.set(policy)
    try:
        yield policy
    finally:
        _POLICY.reset(token)


def layout_policy() -> str:
    return current_policy().layout


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` as the active mesh for a ``with`` block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_active_mesh():
    """The mesh installed by :func:`set_mesh`, or None."""
    return _MESH.get()


def active_mesh():
    return get_active_mesh()


def dp_axes(mesh=None) -> tuple[str, ...]:
    mesh = mesh or active_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def tp_axis(mesh=None):
    mesh = mesh or active_mesh()
    if mesh is None or TP_AXIS not in mesh.axis_names:
        return None
    return TP_AXIS


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in axes or ():
        n *= mesh.shape[a]
    return n


@dataclasses.dataclass(frozen=True)
class Placement:
    """An array split on ``dim`` over the mesh ``axes``, or replicated
    (``dim`` None)."""

    dim: int | None = None
    axes: tuple[str, ...] = ()

    @property
    def split(self) -> bool:
        return self.dim is not None

    def spec(self, ndim: int) -> tuple:
        """The reference's PartitionSpec entries: ``()`` replicated, else
        ``axes`` at ``dim`` and None elsewhere."""
        if not self.split:
            return ()
        return tuple(self.axes if i == self.dim else None
                     for i in range(ndim))


REPLICATED = Placement()


def map_leaves(fn, tree):
    """``tree`` with every tensor and int replaced by ``fn(leaf)`` (the
    port's one state-tree walker, ``train.checkpoint.tree_map_with_path``);
    None stays None."""
    from repro_torch.train.checkpoint import tree_map_with_path

    return tree_map_with_path(lambda path, leaf: fn(leaf), tree)


def _map_placed(fn, tree, specs):
    """``tree`` with every tensor and int replaced by ``fn(leaf,
    placement)``, the placement at the leaf's path of ``specs``."""
    from repro_torch.train.checkpoint import tree_map_with_path

    placed = placements_by_path(specs)
    return tree_map_with_path(lambda path, leaf: fn(leaf, placed[path]),
                              tree)


def placements_by_path(specs, prefix: tuple = ()) -> dict:
    """``{path: Placement}`` with the paths of
    ``train.checkpoint.tree_map_with_path`` (dict keys, indices,
    ``.field``)."""
    if isinstance(specs, Placement):
        return {prefix: specs}
    out = {}
    if isinstance(specs, dict):
        items = ((str(k), v) for k, v in specs.items())
    elif hasattr(specs, "_fields"):
        items = ((f".{k}", v) for k, v in zip(specs._fields, specs))
    elif isinstance(specs, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(specs))
    else:
        items = ()
    for key, v in items:
        out.update(placements_by_path(v, prefix + (key,)))
    return out


def _mesh_for(mesh):
    mesh = mesh or active_mesh()
    if mesh is None:
        raise RuntimeError("a split placement needs an active mesh "
                           "(parallel.sharding.set_mesh)")
    return mesh


def local_block(t: torch.Tensor, placement: Placement, mesh=None
                ) -> torch.Tensor:
    """This rank's block of the whole array ``t`` (a new contiguous
    tensor), or ``t`` itself when it is replicated."""
    if not placement.split:
        return t
    mesh = _mesh_for(mesh)
    n = mesh.size(placement.axes)
    size = t.shape[placement.dim]
    if size % n:
        raise ValueError(f"dim {placement.dim} of {tuple(t.shape)} does not "
                         f"split into {n} blocks")
    block = size // n
    start = mesh.shard_index(placement.axes) * block
    return t.narrow(placement.dim, start, block).clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh=None):
    """This rank's blocks of a tree of whole arrays."""
    return _map_placed(
        lambda t, p: local_block(t, p, mesh) if isinstance(t, torch.Tensor)
        else t, tree, specs)


def gather_tree(tree, specs, mesh=None):
    """The whole arrays of a tree of this rank's blocks: one all-gather per
    split array (a collective: every rank of the mesh calls it)."""
    def gather(t, p):
        if not isinstance(t, torch.Tensor) or not p.split:
            return t
        return torch.cat(_mesh_for(mesh).all_gather(t, p.axes), dim=p.dim)

    return _map_placed(gather, tree, specs)


def state_bytes(tree, specs, mesh=None) -> tuple[int, int]:
    """``(held, whole)``: the bytes of the tensors this rank holds, and of
    the whole arrays they are blocks of."""
    held = whole = 0

    def count(t, p):
        nonlocal held, whole
        if isinstance(t, torch.Tensor):
            b = t.numel() * t.element_size()
            held += b
            whole += b * (_mesh_for(mesh).size(p.axes) if p.split else 1)
        return t

    _map_placed(count, tree, specs)
    return held, whole


def all_reduce_mean(tensors: list[torch.Tensor], axes, mesh=None
                    ) -> list[torch.Tensor]:
    """The mean over ``axes`` of each tensor, as new tensors: the tensors
    of one dtype travel as one flat buffer through one all-reduce."""
    mesh = _mesh_for(mesh)
    n = mesh.size(axes)
    out: list[torch.Tensor | None] = [None] * len(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        mesh.all_reduce_sum_(flat, axes).div_(n)
        for i, part in zip(idxs, flat.split([tensors[i].numel()
                                             for i in idxs])):
            out[i] = part.view(tensors[i].shape)
    return out


def batch_specs_tree(batch, mesh=None,
                     policy: ShardingPolicy | None = None):
    """Placements of an input batch: the leading (batch) dim over the data
    axes where it divides; under "pure_dp" over every mesh axis, falling
    back to the data axes. ``shard_tree(batch, ...)`` gives this rank's
    slice."""
    mesh = mesh or active_mesh()
    policy = policy or current_policy()
    dp_only = dp_axes(mesh) or None
    if policy.layout == "pure_dp":
        all_axes = tuple(a for a in (*dp_axes(mesh), tp_axis(mesh)) if a) \
            or None
        candidates = (all_axes, dp_only)
    else:
        candidates = (dp_only,)

    def spec(x):
        for axes in candidates:
            if axes and isinstance(x, torch.Tensor) and x.dim() \
                    and x.shape[0] % _axis_size(mesh, axes) == 0:
                return Placement(0, axes)
        return REPLICATED

    return map_leaves(spec, batch)


def opt_state_specs(opt_state, params, *, zero=None, mesh=None):
    """Placements of an optimizer state (``ChainState`` or the legacy
    ``HarnessState``; the whole arrays or this rank's blocks of them).

    The walk descends the combinators' containers (chain tuples, partition
    dicts, inject-hyperparams records) to the ``{path: leaf state}`` dicts
    whose keys are parameter paths, and places each leaf state by its
    parameter. ``zero`` (a ``parallel.zero.ZeroConfig``) puts the leaves
    ZeRO-1 claims (``zero.partitioned``: eligible leaves of the index-basis
    projected-Adam rules and of Muon / Trion / Dion) on their ZeRO
    placement (``zero.state_specs``); everything else replicates."""
    from repro_torch.parallel import zero as zero_mod

    zinfo = None
    if zero is not None and zero.active:
        mesh = mesh or active_mesh()
        axes = zero_mod.present_axes(mesh, zero)
        n = _axis_size(mesh, axes) if axes else 1
        if n > 1:
            zinfo = (axes, n)

    def leaf_specs(p, s):
        if zinfo is not None and zero_mod.partitioned(s, p.shape, zinfo[1]):
            return zero_mod.state_specs(p.shape, s, *zinfo)
        return map_leaves(lambda _: REPLICATED, s)

    def walk(node):
        if (isinstance(node, dict) and node
                and all(k in params and hasattr(v, "_fields")
                        for k, v in node.items())):
            return {k: leaf_specs(params[k], v) for k, v in node.items()}
        if node is None:
            return None
        if hasattr(node, "_fields"):
            return type(node)(*(walk(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(c) for c in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return REPLICATED

    return walk(opt_state)


def train_state_specs(state, *, zero=None, mesh=None):
    """Placements of a ``TrainState``: step and parameters replicated, the
    optimizer state by :func:`opt_state_specs`. The Trainer's
    ``state_shardings``."""
    return state._replace(
        step=REPLICATED, params={k: REPLICATED for k in state.params},
        opt_state=opt_state_specs(state.opt_state, state.params, zero=zero,
                                  mesh=mesh))
