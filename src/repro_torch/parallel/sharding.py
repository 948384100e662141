"""Placements on the active mesh: the port of ``repro/parallel/sharding.py``.

Data parallelism: every rank runs the model on its slice of the global
batch (:func:`batch_specs_tree`) and the train step averages the loss and
the gradients over the data axes (:func:`all_reduce_mean`).

The train state is held as blocks. Under an active mesh the parameters
follow the reference's MaxText FSDP x TP recipe (:func:`param_spec`, under
the layout of the active :class:`ShardingPolicy`):

  * 2-D weights  (d_in, d_out)          -> (fsdp, tp)   (fsdp = the data axes)
  * stacked      (L, ..., d_in, d_out)  -> (None, ..., fsdp, tp)
  * row-parallel ``wd`` / ``wo`` / ``out_proj`` -> (..., tp, fsdp)
  * embeddings   (vocab, d_model)       -> (tp, fsdp)
  * experts      (L, E, d, f)           -> (None, tp, fsdp, None)
  * 1-D parameters and the small stacked ones (norms, biases, gates, ...)
    replicate; a mesh axis that does not divide its dim drops (``_fit_spec``)

``"pure_dp"`` replicates every parameter, ``"decode_tp"`` splits each
matrix's d_out (d_in for the row-parallel ones) over all the mesh axes at
once. The optimizer state follows its parameter (:func:`opt_state_specs`:
full-size state as the parameter, transposed EF payloads transposed,
low-rank ``(..., rows, r)`` state with the rank dim whole), except the
leaves ZeRO-1 holds by rows (``parallel.zero``). Each rank keeps only its
blocks, between steps and through them: a train step gathers each use
site's weights when it runs and again in the backward, reduces each
gradient to this rank's block and updates the blocks (``parallel.fsdp``,
``train.steps``), so no rank holds the whole parameters or gradients at
once. The models' mesh bodies run over ``model`` inside the step
(expert-parallel MoE on this rank's expert block, sequence-parallel
attention: ``models.moe``, ``models.layers``, their collectives in
``parallel.collectives``), reading which block of the global batch the
activations are (:func:`batch_cut`), and so do the dense attention and
MLP products where the placements split them by head or hidden unit
(Megatron's column / row pair, what GSPMD derives from the reference's
placements: ``parallel.fsdp`` hands those leaves as this rank's ``model``
blocks, :data:`MEGATRON`).

A :class:`Placement` stands where the reference has a ``PartitionSpec``:
one entry per dim, None (whole) or the mesh axes the dim is split over,
written as the reference writes them (a name, or a tuple of names).
``Placement.entries`` is the reference's spec tuple. The blocks follow the
reference's order: along a dim split over several axes, row-major in the
order given (``launch.mesh.Mesh.shard_index``). Placement trees mirror the
state trees they describe; :func:`shard_tree` cuts a rank's blocks out of
whole arrays, :func:`gather_tree` all-gathers them back (one collective a
split array), :func:`state_bytes` counts them. Checkpoints are saved whole
(``train.checkpoint``).

Placements are derived from whole shapes, as the reference derives them
from ``jax.eval_shape``: the port's abstract values are meta tensors
(``init_params(cfg, seed, "meta")``, an optimizer's ``init`` of them).

The active mesh (``launch.mesh.Mesh``) is a context variable:
``with set_mesh(mesh): ...`` installs it for the thread (the reference takes
it from ``parallel/compat.py``, which the port does not need). Without one
every function here is an identity and the step runs as on one device.
Outside the two mesh bodies the activations are whole on every rank (their
batch rows the step's slice): :func:`shard` checks its logical axes and
returns its input.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch

DP_AXES = ("pod", "data")   # batch / FSDP axes (the present subset)
TP_AXIS = "model"
#: the key, after a group's prefix (``attn/``, ``mlp/``, ...), under which
#: ``parallel.fsdp.Held.use`` tells the model code that it hands that
#: group's Megatron leaves as this rank's blocks over the named axis
MEGATRON = "megatron"

LAYOUTS = ("fsdp_tp", "pure_dp", "decode_tp")


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The layout policy. ``layout``: "fsdp_tp" (default: parameters FSDP
    over the data axes x TP over ``model``), "pure_dp" (parameters
    replicated, the batch over every mesh axis) or "decode_tp" (the
    decode-time Megatron layout: every matrix split over all the mesh axes
    at once). ``seq_parallel``: the residual stream's sequence dim over
    ``model`` (``logical_to_spec``'s ``"sp"``); the models do not place
    activations yet, so it reads as a spec only."""

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
_BATCH_CUT: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_batch_cut", default=())


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


def seq_parallel() -> bool:
    return current_policy().seq_parallel


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


@contextlib.contextmanager
def batch_cut(axes):
    """Declare, for a ``with`` block, that the activations are this rank's
    block of the global batch cut over ``axes`` (the train step's cut,
    :func:`batch_specs_tree`); outside one, every rank holds the whole
    batch. The models' mesh bodies read it (:func:`batch_cut_axes`) to
    route MoE tokens and cut attention queries as the reference does on
    the global batch."""
    token = _BATCH_CUT.set(tuple(axes))
    try:
        yield
    finally:
        _BATCH_CUT.reset(token)


def batch_cut_axes() -> tuple[str, ...]:
    """The axes the activations' batch is cut over (:func:`batch_cut`), ()
    when it is whole on every rank."""
    return _BATCH_CUT.get()


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


def _axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (None: none)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]
    return n


@dataclasses.dataclass(frozen=True)
class Placement:
    """An array's placement: ``entries[i]`` None (dim i whole) or the mesh
    axes dim i is split over (a name, or a tuple of two or more); dims
    past the entries are whole. The empty placement (:data:`REPLICATED`)
    is the reference's ``P()``."""

    entries: tuple = ()

    def __post_init__(self):
        # the PartitionSpec's own normalization: a one-name tuple is the
        # name, an empty one None
        object.__setattr__(self, "entries", tuple(
            None if e is None or e == () else
            e if isinstance(e, str) else
            e[0] if len(e) == 1 else tuple(e) for e in self.entries))

    @classmethod
    def on(cls, dim: int, axes, ndim: int) -> "Placement":
        """Dim ``dim`` of an ``ndim``-dim array split over ``axes``."""
        return cls(tuple(axes if i == dim else None for i in range(ndim)))

    @property
    def split(self) -> bool:
        return any(e is not None for e in self.entries)

    def spec(self, ndim: int) -> tuple:
        """The entries as a PartitionSpec tuple of ``ndim`` entries, ``()``
        when nothing is split."""
        if not self.split:
            return ()
        return tuple(self.entries) + (None,) * (ndim - len(self.entries))

    def splits(self, mesh) -> list[tuple[int, tuple[str, ...], int]]:
        """``(dim, axes, blocks)`` of every dim cut into more than one
        block on ``mesh``."""
        out = []
        for d, e in enumerate(self.entries):
            n = _axis_size(mesh, e)
            if n > 1:
                out.append((d, _axes(e), n))
        return out


REPLICATED = Placement()


def map_leaves(fn, tree):
    """``tree`` with every tensor and int replaced by ``fn(leaf)`` (the
    port's one state-tree walker, ``train.checkpoint.tree_map_with_path``);
    None stays None."""
    from repro_torch.train.checkpoint import tree_map_with_path

    return tree_map_with_path(lambda path, leaf: fn(leaf), tree)


def map_specs(fn, specs):
    """A placement tree with every :class:`Placement` replaced by
    ``fn(placement)``."""
    if isinstance(specs, Placement):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v) for v in specs))
    if isinstance(specs, (tuple, list)):
        return type(specs)(map_specs(fn, v) for v in specs)
    return specs


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


def block_shape(shape, placement: Placement, mesh=None) -> tuple[int, ...]:
    """The shape of one rank's block of a whole ``shape`` array."""
    out = list(shape)
    if placement.split:
        for d, _, n in placement.splits(_mesh_for(mesh)):
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {n} blocks")
            out[d] //= n
    return tuple(out)


def local_block(t: torch.Tensor, placement: Placement, mesh=None
                ) -> torch.Tensor:
    """This rank's block of the whole array ``t`` (a new contiguous
    tensor), or ``t`` itself when nothing is cut."""
    if not placement.split:
        return t
    mesh = _mesh_for(mesh)
    splits = placement.splits(mesh)
    if not splits:
        return t
    shape = block_shape(t.shape, placement, mesh)
    for d, axes, _ in splits:
        t = t.narrow(d, mesh.shard_index(axes) * shape[d], shape[d])
    return t.clone(memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, placement: Placement, mesh=None) -> torch.Tensor:
    """The whole array of this rank's block ``t``: one all-gather over the
    split dims' axes together (a collective: every rank of the mesh calls
    it), the blocks put back in the reference's order."""
    if not placement.split:
        return t
    mesh = _mesh_for(mesh)
    splits = placement.splits(mesh)
    if not splits:
        return t
    parts = mesh.all_gather(t, tuple(a for _, axes, _ in splits
                                     for a in axes))
    # the parts run row-major over the split dims: fold the last dim first
    for d, _, n in reversed(splits):
        parts = [torch.cat(parts[i:i + n], dim=d)
                 for i in range(0, len(parts), n)]
    return parts[0]


def shard_tree(tree, specs, mesh=None):
    """This rank's blocks of a tree of whole arrays."""
    return _map_placed(
        lambda t, p: local_block(t, p, mesh) if isinstance(t, torch.Tensor)
        else t, tree, specs)


def gather_tree(tree, specs, mesh=None):
    """The whole arrays of a tree of this rank's blocks: one all-gather per
    split array, in the tree's order."""
    return _map_placed(
        lambda t, p: gather(t, p, mesh) if isinstance(t, torch.Tensor)
        else t, tree, specs)


def check_blocks(tree, whole, specs, mesh=None, what: str = "state") -> None:
    """Raise unless every tensor of ``tree`` has the shape of this rank's
    block of the same tensor of ``whole`` (whole arrays or meta tensors of
    their shapes)."""
    from repro_torch.train.checkpoint import tree_items

    placed = placements_by_path(specs)
    shapes = dict(tree_items(whole))
    for path, t in tree_items(tree):
        if not isinstance(t, torch.Tensor):
            continue
        want = block_shape(shapes[path].shape, placed[path], mesh)
        if tuple(t.shape) != want:
            raise ValueError(
                f"the {what} at {'/'.join(path)!r} is {tuple(t.shape)}, not "
                f"this rank's block {want} of {tuple(shapes[path].shape)}; "
                "build it under the active mesh and policy (init_state, "
                "opt.init)")


def state_bytes(tree, specs, mesh=None) -> tuple[int, int]:
    """``(held, whole)``: the bytes of the tensors this rank holds, and of
    the whole arrays they are blocks of."""
    held = whole = 0

    def count(t, p):
        nonlocal held, whole
        if isinstance(t, torch.Tensor):
            b = t.numel() * t.element_size()
            held += b
            if p.split:
                for _, _, n in p.splits(_mesh_for(mesh)):
                    b *= n
            whole += b
        return t

    _map_placed(count, tree, specs)
    return held, whole


class UpdateBlock:
    """This rank's block of a whole update. Arithmetic with a number, a 0-d
    tensor, another block or a whole tensor (cut to this rank's block by
    ``_cut``) gives a block of the same kind, so the chain's elementwise
    transforms act on it; :meth:`gather` gives the whole update. Kinds:
    :class:`Block` and ``parallel.zero.RowBlock``."""

    __slots__ = ("local",)

    def _like(self, local: torch.Tensor) -> "UpdateBlock":
        raise NotImplementedError

    def _cut(self, x):
        raise NotImplementedError

    def gather(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def shard_axes(self) -> tuple[str, ...]:
        """The mesh axes the whole update is cut over."""
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def float(self) -> "UpdateBlock":
        return self._like(self.local.float())

    def to(self, *args, **kwargs) -> "UpdateBlock":
        return self._like(self.local.to(*args, **kwargs))

    def __mul__(self, x):
        return self._like(self.local * self._cut(x))

    def __rmul__(self, x):
        return self._like(self._cut(x) * self.local)

    def __add__(self, x):
        return self._like(self.local + self._cut(x))

    def __radd__(self, x):
        return self._like(self._cut(x) + self.local)

    def __sub__(self, x):
        return self._like(self.local - self._cut(x))

    def __rsub__(self, x):
        return self._like(self._cut(x) - self.local)

    def __neg__(self):
        return self._like(-self.local)


class Block(UpdateBlock):
    """This rank's block of a whole array under ``placement``: what the
    elementwise optimizer transforms produce for a leaf whose state is
    held as blocks (``optim.transform.scale_by_adam``), and how a train
    step under a mesh hands the optimizer its gradient and parameter
    blocks. ``shape`` and ``ndim`` are the whole array's (what the rules
    and the label functions read of a parameter)."""

    __slots__ = ("placement", "mesh")

    def __init__(self, local: torch.Tensor, placement: Placement, mesh):
        self.local = local
        self.placement = placement
        self.mesh = mesh

    def _like(self, local: torch.Tensor) -> "Block":
        return Block(local, self.placement, self.mesh)

    def _cut(self, x):
        if isinstance(x, Block):
            return x.local
        if isinstance(x, torch.Tensor) and x.dim():
            return local_block(x, self.placement, self.mesh)
        return x

    @property
    def shape(self) -> torch.Size:
        out = list(self.local.shape)
        for d, _, n in self.placement.splits(self.mesh):
            out[d] *= n
        return torch.Size(out)

    @property
    def ndim(self) -> int:
        return self.local.dim()

    def gather(self) -> torch.Tensor:
        """The whole update (an all-gather)."""
        return gather(self.local, self.placement, self.mesh)

    @property
    def shard_axes(self) -> tuple[str, ...]:
        return tuple(a for _, axes, _ in self.placement.splits(self.mesh)
                     for a in axes)


def held_updates(updates: dict, specs: dict, mesh=None) -> dict:
    """Each leaf's update cut to the block of its parameter's placement in
    ``specs``: a :class:`Block` of that placement as it is, another
    :class:`UpdateBlock` gathered first, a whole update cut."""
    out = {}
    for k, u in updates.items():
        p = specs[k]
        if isinstance(u, Block) and u.placement == p:
            out[k] = u.local
            continue
        if isinstance(u, UpdateBlock):
            u = u.gather()
        out[k] = local_block(u, p, mesh)
    return out


def sum_squares(leaves) -> torch.Tensor:
    """The sum of the squares of every element of ``leaves`` (tensors, or
    :class:`UpdateBlock` s of whole arrays), in fp32: each leaf's own sum,
    the leaves added in their order (a 0-d tensor; the global norm is its
    root). A block's sum is this rank's partial: the partials of the
    blocks cut over one set of mesh axes travel as one fp32 vector through
    one all-reduce over those axes, so no leaf is gathered and every rank
    of a group gets the same bits."""
    sums, groups, mesh = [], {}, None
    for u in leaves:
        if isinstance(u, UpdateBlock):
            mesh = getattr(u, "mesh", None) or _mesh_for(mesh)
            axes = set(u.shard_axes)
            key = tuple(a for a in mesh.axis_names if a in axes)
            groups.setdefault(key, []).append(len(sums))
            u = u.local
        sums.append(torch.sum(torch.square(u.float())))
    for axes, idxs in groups.items():
        if not axes:
            continue
        part = mesh.all_reduce_sum_(torch.stack([sums[i] for i in idxs]),
                                    axes)
        for i, s in zip(idxs, part.unbind(0)):
            sums[i] = s
    return sum(sums)


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


# ---------------------------------------------------------------------------
# logical activation axes
# ---------------------------------------------------------------------------
def logical_to_spec(axes: tuple, mesh=None) -> Placement:
    """Map logical names to a placement on the active mesh.

    Logical names: 'batch' (the data axes), 'tp' (the model axis), 'seq'
    (over the data axes: long-context KV), 'sp' (``model`` under
    ``seq_parallel``), None (whole). Under the 'pure_dp' layout, 'batch'
    spans every mesh axis and 'tp' replicates."""
    mesh = mesh or active_mesh()
    policy = current_policy()
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    if policy.layout == "pure_dp":
        batch_axes = tuple(a for a in (*dp, tp) if a) or None
        tp = None
    else:
        batch_axes = dp if dp else None
    out = []
    for a in axes:
        if a == "batch" or a == "seq":
            out.append(batch_axes)
        elif a == "tp":
            out.append(tp)
        elif a == "sp":
            out.append(tp if policy.seq_parallel else None)
        elif a is None:
            out.append(None)
        else:
            raise ValueError(f"unknown logical axis {a!r}")
    return Placement(tuple(out))


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes. Eager
    PyTorch has no constraint to hand a compiler: the code that computes
    an activation places it. The models' mesh bodies cut and gather their
    own activations over ``model``; the reference's ``shard(q, "batch",
    None, "tp", None)`` and ``_shard_hidden`` are the Megatron sites, where
    each rank computes its heads and hidden units from its ``model``
    blocks (``parallel.fsdp``, ``models.layers.swiglu``); elsewhere a
    step's activations are whole on every rank (its batch rows). So this
    checks the names (:func:`logical_to_spec`) and returns ``x``, with or
    without a mesh. The ``seq_parallel`` residual stream, which no use in
    the reference turns on, is ROADMAP 6f."""
    logical_to_spec(axes)
    return x


# ---------------------------------------------------------------------------
# parameter placements (by path pattern + shape)
# ---------------------------------------------------------------------------
_REPLICATED_HINTS = ("norm", "scale", "bias", "gate", "mu_", "decay",
                     "bonus", "a_log", "d_skip", "conv", "ln_")


def _fit_spec(axes: tuple, shape: tuple[int, ...], mesh) -> Placement:
    """Drop mesh axes that do not evenly divide their dim (whisper's vocab
    51866 does not split 16 ways: that dim replicates)."""
    out = []
    for a, dim in zip(axes, shape):
        if a is None:
            out.append(None)
        elif dim % _axis_size(mesh, a) == 0:
            out.append(a)
        else:
            out.append(None)
    return Placement(tuple(out))


def is_expert_leaf(path: str, ndim: int) -> bool:
    """Whether :func:`param_spec` places ``path`` (a whole leaf of
    ``ndim`` dims) by the expert rule: the experts' dim on ``model``, the
    block the expert-parallel MoE body computes on."""
    return "expert" in path.lower() and ndim >= 3


def param_spec(path: str, shape: tuple[int, ...], mesh=None,
               policy: ShardingPolicy | None = None) -> Placement:
    """A parameter's placement by its path and whole shape under
    ``policy`` (the active one by default): the module docstring's
    rules."""
    mesh = mesh or active_mesh()
    policy = policy or current_policy()
    if policy.layout == "pure_dp":
        return REPLICATED       # params replicated; batch over all axes
    dp = dp_axes(mesh)
    dp = dp if dp else None
    tp = tp_axis(mesh)
    nd = len(shape)
    lpath = path.lower()
    if nd == 0 or nd == 1:
        return REPLICATED
    if any(h in lpath for h in _REPLICATED_HINTS):
        # stacked small params (norm scales, biases, ssm constants): the
        # leading dim is layers, the rest are tiny
        return REPLICATED
    is_row = any(seg in ("wd", "wo", "out_proj")
                 for seg in lpath.split("/"))
    if policy.layout == "decode_tp":
        # the decode-time Megatron layout over the combined (dp x tp)
        # axes: every matrix column-parallel (d_out over all ranks),
        # down / out projections row-parallel
        allax = tuple(a for a in (*(dp or ()), tp) if a) or None
        lead = (None,) * (nd - 2)
        if "embed" in lpath or "unembed" in lpath or "lm_head" in lpath:
            return _fit_spec((*lead, allax, None), shape, mesh)
        if is_expert_leaf(path, nd):
            # experts on tp; expert hidden column / row-parallel on dp
            lead3 = (None,) * (nd - 3)
            if is_row:   # (L, E, f, d)
                return _fit_spec((*lead3, tp, dp, None), shape, mesh)
            return _fit_spec((*lead3, tp, None, dp), shape, mesh)
        if is_row:
            return _fit_spec((*lead, allax, None), shape, mesh)
        return _fit_spec((*lead, None, allax), shape, mesh)
    if "embed" in lpath or "unembed" in lpath or "lm_head" in lpath:
        # (vocab, d) or (L?, vocab, d): vocab on tp, d on fsdp
        lead = (None,) * (nd - 2)
        return _fit_spec((*lead, tp, dp), shape, mesh)
    if is_expert_leaf(path, nd):
        # (L, E, d_in, d_out): experts on tp (EP), d_in on fsdp
        lead = (None,) * (nd - 3)
        return _fit_spec((*lead, tp, dp, None), shape, mesh)
    lead = (None,) * (nd - 2)
    if is_row:
        # down / out projections row-parallel (the contraction dim on
        # `model`): the Megatron column -> row pair
        return _fit_spec((*lead, tp, dp), shape, mesh)
    # (L?, d_in, d_out): fsdp x tp
    return _fit_spec((*lead, dp, tp), shape, mesh)


def params_specs(params: dict, mesh=None,
                 policy: ShardingPolicy | None = None) -> dict:
    """``{path: Placement}`` of a flat parameter dict (whole tensors or
    meta tensors of their shapes; the keys are the reference's
    ``path_str``)."""
    policy = policy or current_policy()
    return {k: param_spec(k, tuple(p.shape), mesh, policy)
            for k, p in params.items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement on a mesh: what cuts an array into this rank's block
    and gathers it back (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Placement

    def local_block(self, t: torch.Tensor) -> torch.Tensor:
        return local_block(t, self.spec, self.mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather(t, self.spec, self.mesh)


def named_shardings(tree_of_specs: Any, mesh) -> Any:
    return map_specs(lambda s: NamedSharding(mesh, s), tree_of_specs)


# ---------------------------------------------------------------------------
# optimizer-state placements: derived from the parameters' by shape
# matching. Full-size state follows the parameter; low-rank (..., r) keeps
# the row entries and replicates the rank dim; indices and scalars
# replicate.
# ---------------------------------------------------------------------------
def _match_state_spec(p_shape, p_spec: Placement, s_shape) -> Placement:
    if tuple(s_shape) == tuple(p_shape):
        return p_spec
    sp = list(p_spec.entries) + [None] * (len(p_shape)
                                          - len(p_spec.entries))
    # transpose-oriented full-size state (EF buffers are stored oriented)
    if (len(s_shape) == len(p_shape)
            and tuple(s_shape[:-2]) == tuple(p_shape[:-2])
            and (s_shape[-2], s_shape[-1]) == (p_shape[-1], p_shape[-2])):
        sp[-2], sp[-1] = sp[-1], sp[-2]
        return Placement(tuple(sp))
    # low-rank (..., rows, r): keep leading / row entries, replicate rank
    if len(s_shape) == len(p_shape):
        return Placement(tuple(sp[i] if ss == ps else None
                               for i, (ss, ps) in enumerate(zip(s_shape,
                                                                p_shape))))
    if len(s_shape) == len(p_shape) + 1 \
            and tuple(s_shape[:-1]) == tuple(p_shape):
        return Placement((*sp, None))
    # anything else (indices, scales, scalars): replicate
    return REPLICATED


def leaf_state_specs(p_shape, p_spec: Placement, leaf_state):
    """Placements of one parameter's (whole) state tree by shape matching;
    ints replicate."""
    return map_leaves(
        lambda s: _match_state_spec(p_shape, p_spec, s.shape)
        if isinstance(s, torch.Tensor) else REPLICATED, leaf_state)


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
                return Placement.on(0, axes, x.dim())
        return REPLICATED

    return map_leaves(spec, batch)


def cache_specs_tree(cache: dict, mesh=None) -> dict:
    """Placements of a flat decode cache (``models.transformer.init_cache``
    and the recurrent entries; leaves ``(repeats, B, ...)``), by the last
    segment of each key: the batch over the data axes where it divides,
    else (long-context B = 1) the sequence of an attention cache over
    them; KV heads and channel dims on ``model`` where they divide;
    everything else whole."""
    mesh = mesh or active_mesh()
    dp = dp_axes(mesh) or None
    tp = tp_axis(mesh)
    dp_n = _axis_size(mesh, dp)
    tp_n = _axis_size(mesh, tp) if tp else 1

    def leaf_spec(key, x):
        name = key.rsplit("/", 1)[-1]
        shp = x.shape
        out = [None] * len(shp)
        b_ok = len(shp) >= 2 and shp[1] % dp_n == 0 and dp is not None
        if b_ok:
            out[1] = dp
        if name in ("k", "v", "xk", "xv"):            # (R,B,S,H,hd)
            if not b_ok and dp is not None and shp[2] % dp_n == 0:
                out[2] = dp                           # sequence-sharded KV
            if tp and shp[3] % tp_n == 0:
                out[3] = tp
        elif name in ("ckv", "krope"):                # (R,B,S,dim) MLA latent
            if not b_ok and dp is not None and shp[2] % dp_n == 0:
                out[2] = dp
        elif name == "conv":                          # (R,B,K,din)
            if tp and shp[3] % tp_n == 0:
                out[3] = tp
        elif name == "ssm":                           # (R,B,din,st)
            if tp and shp[2] % tp_n == 0:
                out[2] = tp
        elif name == "wkv":                           # (R,B,H,K,V)
            if tp and shp[2] % tp_n == 0:
                out[2] = tp
        return Placement(tuple(out))

    return {k: leaf_spec(k, x) for k, x in cache.items()}


def telemetry_specs(tree: Any) -> Any:
    """Placements of telemetry trees (the per-leaf ``SubspaceStats`` under
    ``metrics["telemetry"]``, controller state, sink records). The stats
    are computed from whole operands, identical on every rank: every leaf
    replicates."""
    if isinstance(tree, dict):
        return {k: telemetry_specs(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(telemetry_specs(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(telemetry_specs(v) for v in tree)
    return None if tree is None else REPLICATED


def opt_state_specs(opt_state, params, p_specs, *, zero=None, mesh=None):
    """Placements of an optimizer state (``ChainState`` or the legacy
    ``HarnessState``) of whole arrays: meta tensors do, as the reference
    reads ``jax.eval_shape``'s.

    The walk descends the combinators' containers (chain tuples, partition
    dicts, inject-hyperparams records) to the ``{path: leaf state}`` dicts
    whose keys are parameter paths, and places each leaf state by its
    parameter's placement in ``p_specs`` (:func:`leaf_state_specs`).
    ``zero`` (a ``parallel.zero.ZeroConfig``) puts the leaves ZeRO-1
    claims (``zero.partitioned``: eligible leaves of the index-basis
    projected-Adam rules and of Muon / Trion / Dion) on their row
    placement (``zero.state_specs``) instead. Everything else (steps,
    keys, bases, hyperparameters) replicates."""
    from repro_torch.parallel import zero as zero_mod

    zinfo = None
    if zero is not None and zero.active:
        mesh = mesh or active_mesh()
        axes = zero_mod.present_axes(mesh, zero)
        n = _axis_size(mesh, axes) if axes else 1
        if n > 1:
            zinfo = (axes, n)

    def leaf_specs(k, s):
        p = params[k]
        if zinfo is not None and zero_mod.partitioned(s, p.shape, zinfo[1]):
            return zero_mod.state_specs(p.shape, s, *zinfo)
        return leaf_state_specs(p.shape, p_specs[k], s)

    def walk(node):
        if (isinstance(node, dict) and node
                and all(k in params and hasattr(v, "_fields")
                        for k, v in node.items())):
            return {k: leaf_specs(k, v) for k, v in node.items()}
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


def optimizer_state_specs(optimizer, params: dict, *, zero=None, mesh=None):
    """Placements of ``optimizer``'s state of ``params`` (whole tensors or
    meta tensors of their shapes) on ``mesh`` (the active one by
    default): :func:`opt_state_specs` of its state of the shapes on
    ``meta``, built outside any mesh. What describes the blocks that
    ``optimizer.init`` keeps under that mesh."""
    mesh = mesh or active_mesh()
    meta = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for k, p in params.items()}
    with set_mesh(None):
        abstract = optimizer.init(meta)
    return opt_state_specs(abstract, meta, params_specs(meta, mesh),
                           zero=zero, mesh=mesh)


def train_state_specs(state, *, zero=None, mesh=None):
    """Placements of a ``TrainState`` of whole arrays (meta tensors do:
    ``train.steps.init_state(cfg, opt, seed, "meta")`` outside the mesh is
    the port's ``jax.eval_shape``): the step replicated, the parameters by
    :func:`params_specs` under the active policy, the optimizer state by
    :func:`opt_state_specs`. The Trainer's ``state_shardings``."""
    mesh = mesh or active_mesh()
    p_specs = params_specs(state.params, mesh)
    return state._replace(
        step=REPLICATED, params=p_specs,
        opt_state=opt_state_specs(state.opt_state, state.params, p_specs,
                                  zero=zero, mesh=mesh))
