"""ZeRO-1 partitioning of the low-rank optimizer state: the counterpart of
``repro/parallel/zero.py`` over ``torch.distributed``.

The projected-Adam state (Adam moments in R^{rows x r}, the int8 or fp32
error-feedback buffer in R^{rows x cols}, per-row EF scales) is
row-parallel, so each rank of the data axes keeps only its row block of
every eligible leaf's state and runs the select + project + update step on
those rows. Per-rank optimizer-state bytes drop by the data-parallel width
on top of the paper's low-rank reduction. The API hands the rules whole
(averaged) gradients and parameters; the train step hands its blocks
(``sharding.Block``, ``parallel.fsdp``), and a sharded leaf's rows then
come from them without the whole leaf: a view where the parameter's
block is this rank's rows, else one all-to-all of the parts each rank
lacks (``Mesh.all_to_all``), and the row update goes back to the
parameter's block the same way.

Why the row-block step computes the replicated step's function: every row
of ``S = G @ Q``, the Adam update, the back-projections ``u @ Q_r^T`` and
the per-row q8 EF quantization are row-local. The one cross-shard quantity
is the column statistic ``||S[:, j]||^2`` of the dynamic selection, one
``(n,)`` vector per leaf, completed across the shards so that every rank
selects the same indices. On the kernel path ``dct_project`` returns its
per-row-block partial norms (``BLOCK_ROWS`` rows a block); the ranks
all-gather them and sum all of them in the replicated kernel's fixed order
(``selection.allsum_row_blocks``). When a rank's rows are a whole number of
blocks this is the replicated statistic bit for bit. Off the kernel path
(fused "off" / "fft", the l1 ranking norm) each rank's column totals are
summed across the ranks in rank order (``selection.allsum``, the
reference's ``psum``), which can part from the replicated sum by rounding.
Either way the sum runs in one fixed order on every rank, so the ranks
agree bit for bit.

Muon / Trion / Dion (``zero_shardable`` rules) shard by gather - compute -
slice: Muon all-gathers the rank-sized factor for Newton-Schulz (and its
full moment for full-space NS), Trion and Dion the momentum sum; every rank
runs the same whole-matrix step and keeps its own rows. Dion's per-layer
``q`` comes out of that identical on every rank and replicates.

There is no ``shard_map`` here: ``sharded_leaf_update`` cuts this rank's
rows out of the right-oriented gradient, runs the rule on them with
``ctx.axis`` set (the collectives of ``core.selection`` go over those mesh
axes) and ``ctx.oriented`` (orientation is decided on the whole leaf), and
returns the update as a :class:`RowBlock`. The chain's elementwise
transforms act on its rows (weight decay reads this rank's rows of the
parameter); the caller all-gathers it (:func:`gather_updates`) before
``apply_updates``, as the train step does. A sharded leaf's rule records
its telemetry into the leaf's scope directly: every term it records is completed across the
shards, so each rank records the same values (the reference re-records
them out of its ``shard_map``).

The placement of a leaf's state follows its type, as in the reference
(:func:`partitioned`): the index-basis ``ProjAdamLeaf`` and the Muon /
Trion / Dion leaves whose oriented rows split evenly. A rule that is not
``zero_shardable`` on such a state (FIRA with an index basis: its residual
scaling sums norms over every row) keeps its state partitioned and computes
replicated (:func:`replicated_leaf_update`: the state is gathered, updated
whole and cut again), where the reference lets XLA gather it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import REPLICATED, Placement

ZERO_MODES = ("off", "1")


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """Optimizer-state partitioning config.

    ``mode``: "off" (replicated state) or "1" (ZeRO-1: state and update
    step partitioned, updates all-gathered). ``axes``: the mesh axes to
    partition over; the present subset of the active mesh is used.
    """

    mode: str = "off"
    axes: tuple[str, ...] = ("pod", "data")

    def __post_init__(self):
        if self.mode not in ZERO_MODES:
            raise ValueError(f"unknown zero mode {self.mode!r}; "
                             f"allowed: {ZERO_MODES}")
        if isinstance(self.axes, list):
            object.__setattr__(self, "axes", tuple(self.axes))

    @property
    def active(self) -> bool:
        return self.mode != "off"


ZERO_OFF = ZeroConfig()


def parse_zero(flag: str) -> ZeroConfig:
    """CLI helper: ``--zero {off,1}`` -> :class:`ZeroConfig`."""
    return ZeroConfig(mode=flag)


@dataclasses.dataclass(frozen=True)
class ZeroContext:
    """A config resolved against the active mesh."""

    mesh: object
    axes: tuple[str, ...]
    n_shards: int


def present_axes(mesh, cfg: ZeroConfig) -> tuple[str, ...]:
    if mesh is None:
        return ()
    return tuple(a for a in cfg.axes if a in mesh.axis_names)


def resolve(cfg: ZeroConfig | None) -> ZeroContext | None:
    """Resolve a config against the active mesh; None when inactive (mode
    off, no mesh, the configured axes absent, or one shard)."""
    if cfg is None or not cfg.active:
        return None
    mesh = sharding.active_mesh()
    axes = present_axes(mesh, cfg)
    if not axes:
        return None
    n = mesh.size(axes)
    if n <= 1:
        return None
    return ZeroContext(mesh=mesh, axes=axes, n_shards=n)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def _oriented_rows(param_shape) -> int:
    """Rules orient a matrix so the projected dim is last: rows = the
    larger of the trailing two dims."""
    return max(param_shape[-2], param_shape[-1])


def eligible(param_shape, n_shards: int) -> bool:
    """A leaf's state partitions iff its oriented row dim splits evenly."""
    if len(param_shape) < 2 or n_shards <= 1:
        return False
    return _oriented_rows(param_shape) % n_shards == 0


def grad_spec(param_shape, axes: tuple[str, ...]) -> Placement:
    """The placement splitting an oriented (rows at dim -2) array's rows."""
    return Placement.on(len(param_shape) - 2, tuple(axes), len(param_shape))


def state_array_spec(param_shape, state_shape, axes: tuple[str, ...],
                     n_shards: int = 1) -> Placement:
    """The placement of one state array of an eligible leaf. Arrays stored
    oriented with the rows first of the trailing two dims (moments
    ``(..., rows, r)``, EF payload ``(..., rows, cols)``, per-row EF scales
    ``(..., rows, 1)``) split their rows; index sets, scalars and anything
    else replicate. ``state_shape`` may be the whole array's or, given
    ``n_shards``, one shard's block of it."""
    rows = _oriented_rows(param_shape)
    if (len(state_shape) == len(param_shape) and len(state_shape) >= 2
            and state_shape[-2] in (rows, rows // n_shards)):
        return Placement.on(len(state_shape) - 2, tuple(axes),
                            len(state_shape))
    return REPLICATED


def state_specs(param_shape, state_tree, axes: tuple[str, ...],
                n_shards: int = 1):
    """Placements of a whole per-leaf state (``ProjAdamLeaf`` with its q8
    ``QuantizedBuffer``, ``MuonLeaf`` / ``TrionLeaf`` / ``DionLeaf``).
    Dion's per-layer basis ``q (..., cols, r)`` replicates: it comes out of
    the gathered momentum sum identical on every rank, and on a square leaf
    its ``cols`` dim would pass for a row dim."""
    from repro_torch.optim.dion import DionLeaf

    def spec(s):
        if isinstance(s, int):
            return REPLICATED
        return state_array_spec(param_shape, s.shape, axes, n_shards)

    if isinstance(state_tree, DionLeaf):
        return DionLeaf(m=spec(state_tree.m), q=REPLICATED)
    return sharding.map_leaves(spec, state_tree)


def partitioned(leaf_state, param_shape, n_shards: int) -> bool:
    """Whether ZeRO-1 holds this leaf's state by rows: an eligible leaf of
    the index-basis projected-Adam rules (integer projector state) or of
    the momentum families."""
    from repro_torch.optim.dion import DionLeaf
    from repro_torch.optim.muon import MuonLeaf
    from repro_torch.optim.projected_adam import ProjAdamLeaf
    from repro_torch.optim.trion import TrionLeaf

    if not eligible(param_shape, n_shards):
        return False
    if isinstance(leaf_state, (MuonLeaf, TrionLeaf, DionLeaf)):
        return True
    return (isinstance(leaf_state, ProjAdamLeaf)
            and not leaf_state.proj.is_floating_point())


# ---------------------------------------------------------------------------
# the sharded leaf update
# ---------------------------------------------------------------------------
class RowBlock(sharding.UpdateBlock):
    """This rank's rows of a row-sharded update: ``local`` is the oriented
    ``(..., rows / n, cols)`` block, ``transposed`` whether the parameter
    is the transpose of the oriented matrix. A parameter-shaped tensor in
    its arithmetic is cut to this rank's rows; :meth:`gather` gives the
    whole update in the parameter's layout."""

    __slots__ = ("axes", "transposed")

    def __init__(self, local: torch.Tensor, axes, transposed: bool):
        self.local = local
        self.axes = tuple(axes)
        self.transposed = transposed

    def _like(self, local: torch.Tensor) -> "RowBlock":
        return RowBlock(local, self.axes, self.transposed)

    def _cut(self, x):
        from repro_torch.core.selection import local_row_block

        if isinstance(x, RowBlock):
            return x.local
        if isinstance(x, torch.Tensor) and x.dim() >= 2:
            xo = x.transpose(-1, -2) if self.transposed else x
            return local_row_block(xo, self.axes, self.local.shape[-2])
        return x

    @property
    def shard_axes(self) -> tuple[str, ...]:
        return self.axes

    def gather(self) -> torch.Tensor:
        """The whole update (an all-gather over ``axes``)."""
        from repro_torch.core.selection import allgather_rows
        from repro_torch.optim.common import deorient

        return deorient(allgather_rows(self.local, self.axes),
                        self.transposed)


def gather_updates(updates: dict) -> dict:
    """``updates`` with every block (:class:`RowBlock`,
    ``sharding.Block``) all-gathered (the others as they are)."""
    return {k: u.gather() if isinstance(u, sharding.UpdateBlock) else u
            for k, u in updates.items()}


def _check_held(state, param_shape, block: int) -> None:
    rows = state.m.shape[-2]
    if rows != block:
        raise ValueError(
            f"ZeRO-1: the optimizer state of a {tuple(param_shape)} leaf "
            f"holds {rows} rows, not this rank's block of {block}; "
            "initialize it (opt.init) under the active mesh")


def sharded_leaf_update(rule, g, state, param, ctx, zctx: ZeroContext):
    """``rule.update`` on this rank's rows of the leaf.

    Orientation is decided on the whole leaf (a row block's aspect ratio
    can differ); this rank's rows of the right-oriented gradient go to the
    rule with ``ctx.axis`` set, so its row reductions span the shards, and
    ``ctx.oriented``. A gradient handed as a ``sharding.Block`` (the train
    step's) gives its rows without the whole leaf (:func:`_rows_of`), and
    the update comes back as the parameter's block; otherwise it is a
    :class:`RowBlock`. Returns it and the new (row-sharded) state."""
    from repro_torch.core.selection import local_row_block
    from repro_torch.optim.common import oriented_dims, orient_right

    rows, _ = oriented_dims(g.shape)
    transposed = g.shape[-1] > g.shape[-2]
    block = rows // zctx.n_shards
    _check_held(state, param.shape, block)
    if isinstance(g, sharding.Block):
        g_blk = _rows_of(g, transposed, zctx)
    else:
        gf, _ = orient_right(g)
        g_blk = local_row_block(gf, zctx.axes, block).contiguous()
        del gf
    inner = dataclasses.replace(ctx, axis=zctx.axes, oriented=True)
    d, new_state = rule.update(g_blk, state, param, inner)
    d = RowBlock(d, zctx.axes, transposed)
    if isinstance(g, sharding.Block):
        d = _as_param_block(d, g)
    return d, new_state


# -- moving rows between the ZeRO row cut and a parameter's block ----------
# A box is one (start, stop) range per dim of the whole array: a rank's
# block under a placement, or its ZeRO rows (the oriented row dim cut over
# the ZeRO axes, every other dim whole). The boxes of a placement form a
# grid, so two ranks' boxes are the same or disjoint.
def _placement_box(shape, placement, mesh, rank) -> list[tuple[int, int]]:
    box = [(0, n) for n in shape]
    for d, axes, n in placement.splits(mesh):
        size = shape[d] // n
        i = mesh.shard_index(axes, rank)
        box[d] = (i * size, (i + 1) * size)
    return box


def _rows_box(shape, dim: int, zctx: ZeroContext, rank
              ) -> list[tuple[int, int]]:
    size = shape[dim] // zctx.n_shards
    i = zctx.mesh.shard_index(zctx.axes, rank)
    return [(i * size, (i + 1) * size) if d == dim else (0, n)
            for d, n in enumerate(shape)]


def _meet(a, b):
    box = [(max(lo, lo2), min(hi, hi2)) for (lo, hi), (lo2, hi2)
           in zip(a, b)]
    return None if any(lo >= hi for lo, hi in box) else box


def _view(t: torch.Tensor, box, origin) -> torch.Tensor:
    """The part ``box`` of ``t``, which holds the box ``origin``."""
    for d, ((lo, hi), (o, _)) in enumerate(zip(box, origin)):
        t = t.narrow(d, lo - o, hi - lo)
    return t


def _exchange(local: torch.Tensor, have, need, mesh, axes) -> torch.Tensor:
    """This rank's ``need(rank)`` box of a whole array of which each rank
    of the group over ``axes`` holds its ``have(rank)`` box (this rank:
    ``local``). Each part comes from this rank where it holds it, else
    from the first rank in shard order with that box; where every rank
    holds what it needs, a view of ``local`` (no collective), else one
    all-to-all of the parts (``Mesh.all_to_all``). Only bits move."""
    ranks = mesh.members(axes)
    me = mesh.rank
    haves = {r: have(r) for r in ranks}
    needs = {r: need(r) for r in ranks}

    def sources(r):
        """The ranks ``r`` takes its parts from, itself first."""
        out = [r]
        for q in ranks:
            if all(haves[q] != haves[o] for o in out):
                out.append(q)
        return out

    mine = needs[me]
    if all(_meet(haves[r], needs[r]) == needs[r] for r in ranks):
        return _view(local, mine, haves[me])
    parts, sizes, boxes = [], [], []
    for r in ranks:
        send = _meet(haves[me], needs[r]) \
            if r != me and me in sources(r)[1:] else None
        parts.append(_view(local, send, haves[me]).reshape(-1) if send
                     else local.new_empty(0))
        recv = None
        if r != me and r in sources(me)[1:]:
            recv = _meet(haves[r], mine)
        boxes.append(recv)
        sizes.append(0 if recv is None else
                     torch.Size([hi - lo for lo, hi in recv]).numel())
    got = mesh.all_to_all(parts, sizes, axes)
    out = local.new_empty([hi - lo for lo, hi in mine])
    own = _meet(haves[me], mine)
    if own:
        _view(out, own, mine).copy_(_view(local, own, haves[me]))
    for box, part in zip(boxes, got):
        if box:
            _view(out, box, mine).copy_(part.view([hi - lo for lo, hi
                                                   in box]))
    return out


def _group_axes(g: "sharding.Block", zctx: ZeroContext) -> tuple:
    axes = set(zctx.axes) | set(g.shard_axes)
    return tuple(a for a in g.mesh.axis_names if a in axes)


def _rows_of(g: "sharding.Block", transposed: bool, zctx: ZeroContext
             ) -> torch.Tensor:
    """This rank's ZeRO rows of the oriented whole gradient, from the
    ranks' blocks ``g``: a view where the block is those rows (the ZeRO
    cut and the placement cut the same dim over the same axes), else the
    overlaps moved by one all-to-all; never the whole leaf."""
    shape, mesh = tuple(g.shape), g.mesh
    dim = len(shape) - (1 if transposed else 2)
    rows = _exchange(
        g.local, lambda r: _placement_box(shape, g.placement, mesh, r),
        lambda r: _rows_box(shape, dim, zctx, r), mesh, _group_axes(g, zctx))
    return (rows.transpose(-1, -2) if transposed else rows).contiguous()


def _as_param_block(d: "RowBlock", g: "sharding.Block") -> "sharding.Block":
    """A row-block update as the parameter's block ``g`` is placed: the
    inverse move of :func:`_rows_of` (each part of the block from a rank
    whose rows hold it), so the chain's elementwise transforms meet the
    parameter's block."""
    zctx = ZeroContext(g.mesh, d.axes, g.mesh.size(d.axes))
    shape, mesh = tuple(g.shape), g.mesh
    dim = len(shape) - (1 if d.transposed else 2)
    local = d.local.transpose(-1, -2) if d.transposed else d.local
    blk = _exchange(
        local, lambda r: _rows_box(shape, dim, zctx, r),
        lambda r: _placement_box(shape, g.placement, mesh, r), mesh,
        _group_axes(g, zctx))
    return sharding.Block(blk.contiguous(), g.placement, mesh)


def replicated_leaf_update(rule, g, state, param, ctx, zctx: ZeroContext):
    """A partitioned state under a rule that is not ``zero_shardable``:
    the state is gathered, the rule runs on the whole leaf, and the new
    state is cut to this rank's rows again."""
    specs = state_specs(param.shape, state, zctx.axes, zctx.n_shards)
    whole = sharding.gather_tree(state, specs, zctx.mesh)
    blocked = isinstance(g, sharding.Block)
    d, new_state = rule.update(g.gather() if blocked else g, whole, param,
                               ctx)
    if blocked:
        d = sharding.Block(sharding.local_block(d, g.placement, g.mesh),
                           g.placement, g.mesh)
    return d, sharding.shard_tree(new_state, specs, zctx.mesh)
