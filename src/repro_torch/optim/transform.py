"""Composable gradient-transform optimizer API (DESIGN.md §4).

A ``GradientTransform`` is an ``(init, update)`` pair with the signature

    init(params)                        -> state
    update(updates, state, params, ctx) -> (updates, state)

where the trees are flat ``{leaf path: tensor}`` dicts and ``ctx`` is the
:class:`~repro_torch.optim.common.Context` threaded by the chain runtime.

Combinators: ``chain`` (sequential composition), ``partition`` (route
leaves to transforms by label; ``merge_by_label`` puts the per-label trees
back together) and ``inject_hyperparams`` (float hyperparameters become 0-d
fp32 state tensors, updatable between steps). Primitives:
``clip_global_norm``, ``scale_by_schedule``, ``scale_by_adam`` (full-rank
Adam), ``scale_by_learning_rate``, ``add_decayed_weights``,
``lr_scale_transform`` (the resilience ladder's LR-cut seam) and
``lowrank_project(rule)``, which lifts a per-matrix-leaf
:class:`~repro_torch.optim.common.MatrixRule` to a whole-tree transform.
``as_optimizer`` closes a transform into ``Optimizer(init, update)``: it
owns the step counter, the root key and the shared-basis store.

Randomness: the runtime folds the step into its root key (the ``seed``),
and ``lowrank_project`` folds in ``path_hash`` of each leaf's path
(``leaf_key``), as the JAX package does with ``jax.random.fold_in``. The
keys here are 63-bit integers mixed by splitmix64, so the stream is the
port's own: the same seed gives other draws than JAX's.

Telemetry: ``as_optimizer`` puts the collector installed by
``telemetry.stats.collect`` (if any) into the step's ``Context``, and
``lowrank_project`` narrows it to each leaf's path, the key ``overrides=``
takes.

Masked positions: JAX's ``partition`` hands each sub-transform the whole
tree with ``MASKED`` in the other labels' places. On flat dicts the port's
``partition`` drops those paths instead, so no tree of the port holds a
``MaskedNode``; the class is the port's name for the JAX holes that
``convert`` meets in a carried partition state, and ``merge_by_label``
accepts per-label trees either way.

Placed state: under an active mesh (``parallel.sharding.set_mesh``)
``as_optimizer``'s ``init`` keeps each rank's blocks of the state
(``sharding.opt_state_specs`` under the active policy), and ``update``
takes the gradients and parameters whole, or a split leaf's as this
rank's ``sharding.Block`` (the train step's; its ``shape`` is the whole
one). A leaf's state follows its parameter's placement: ``scale_by_adam``
(elementwise) updates its blocks from the gradient's block and emits a
``sharding.Block``; ``lowrank_project`` gathers a split low-rank state
(and a gradient handed as a block), runs the rule on the whole leaf, cuts
the new state again and, for a block gradient, the update too, so one
leaf is whole at a time. With ``zero=ZeroConfig("1")``
each rank keeps the row block of the state of every leaf
``parallel.zero.partitioned`` claims instead; ``lowrank_project`` runs a
``zero_shardable`` rule on those rows (``zero.sharded_leaf_update``) and
emits its update as a ``zero.RowBlock``. The elementwise transforms here
act on either block, and the caller all-gathers them
(``zero.gather_updates``) or cuts each update to its parameter's block
(``sharding.held_updates``, as the train step does) before
``apply_updates``.
"""
from __future__ import annotations

import dataclasses
import inspect
import zlib
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.transforms import (
    basis_store_key,
    normalize_basis_request,
    shared_basis,
)
from repro_torch.parallel import sharding
from repro_torch.parallel import zero as zero_mod
from repro_torch.telemetry.stats import active_collector

from .common import (
    AdamMoments,
    Context,
    FullAdamLeaf,
    MatrixRule,
    Optimizer,
    Schedule,
    adam_update,
    default_label_fn,
    labelled_tree,
    sched_value,
)


class GradientTransform(NamedTuple):
    """Composable optimizer building block. ``basis_sizes(params)`` declares
    which shared predefined bases the transform needs — ``(kind, n)`` pairs
    or bare orders ``n`` (DCT); ``as_optimizer`` stores one of each."""

    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict, Context], tuple[dict, Any]]
    basis_sizes: Callable[[dict], set] = lambda params: set()


class EmptyState(NamedTuple):
    """State of a stateless transform."""


class MaskedNode:
    """Placeholder for a leaf hidden from a partitioned sub-transform (the
    JAX package's pytree node with no leaves). All instances are equal."""

    def __repr__(self):
        return "MaskedNode"

    def __eq__(self, other):
        return isinstance(other, MaskedNode)

    def __hash__(self):
        return hash(MaskedNode)


MASKED = MaskedNode()


_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from ``key`` and ``data`` (splitmix64 of their
    mix): the port's counterpart of ``jax.random.fold_in``."""
    z = (key * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def path_hash(path: str) -> int:
    """Stable 31-bit hash of a leaf path ('block/0/wq'), the per-leaf fold
    constant: crc32, the JAX package's own."""
    return zlib.crc32(path.encode("utf-8")) & 0x7FFFFFFF


def leaf_key(key: int | None, path: str) -> int | None:
    """Per-leaf key: fold the path hash into the step key."""
    if key is None:
        return None
    return fold_in(key, path_hash(path))


def chain(*transforms: GradientTransform) -> GradientTransform:
    """Apply ``transforms`` in sequence; state is the tuple of member states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params, ctx):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params, ctx)
            new_state.append(s)
        return updates, tuple(new_state)

    def basis_sizes(params):
        sizes = set()
        for t in transforms:
            sizes |= t.basis_sizes(params)
        return sizes

    return GradientTransform(init, update, basis_sizes)


def _mask(labels: dict, tree: dict, label: str) -> dict:
    """The leaves of ``tree`` whose label is ``label``."""
    return {k: v for k, v in tree.items() if labels[k] == label}


def merge_by_label(labels: dict, by_label: dict) -> dict:
    """Inverse of the partition's split: one ``{path: leaf}`` tree taking
    each path from its own label's tree (which may hold only its label's
    paths, or ``MASKED`` in the others' places)."""
    return {path: by_label[lbl][path] for path, lbl in labels.items()}


def partition(transforms: dict[str, GradientTransform],
              label_fn=default_label_fn) -> GradientTransform:
    """Route each parameter leaf to the transform of its label. An unknown
    label raises at ``init``. The state is ``{label: sub-state}``."""

    def _labels(params):
        labels = labelled_tree(params, label_fn)
        unknown = set(labels.values()) - set(transforms)
        if unknown:
            raise ValueError(f"label_fn produced labels {sorted(unknown)} "
                             f"with no transform; have {sorted(transforms)}")
        return labels

    def init(params):
        labels = _labels(params)
        return {lbl: t.init(_mask(labels, params, lbl))
                for lbl, t in transforms.items()}

    def update(updates, state, params, ctx):
        labels = _labels(params)
        outs, new_state = {}, {}
        for lbl, t in transforms.items():
            outs[lbl], new_state[lbl] = t.update(
                _mask(labels, updates, lbl), state[lbl],
                _mask(labels, params, lbl), ctx)
        return merge_by_label(labels, outs), new_state

    def basis_sizes(params):
        labels = _labels(params)
        sizes = set()
        for lbl, t in transforms.items():
            sizes |= t.basis_sizes(_mask(labels, params, lbl))
        return sizes

    return GradientTransform(init, update, basis_sizes)


def stateless(update_fn) -> GradientTransform:
    """Lift ``update_fn(updates, params, ctx) -> updates`` to a transform."""
    return GradientTransform(
        init=lambda params: EmptyState(),
        update=lambda u, s, p, ctx: (update_fn(u, p, ctx), s),
    )


class InjectHyperparamsState(NamedTuple):
    hyperparams: dict        # name -> 0-d fp32 tensor
    inner: Any


def inject_hyperparams(factory: Callable[..., GradientTransform],
                       *, static_args: tuple[str, ...] = ()):
    """Make a transform factory's float hyperparameters updatable at run
    time, as the JAX package's ``inject_hyperparams`` does.

    ``inject_hyperparams(factory)(lr_scale=1.0)`` returns a transform whose
    state carries ``{"lr_scale": tensor(1.0)}``: a 0-d fp32 tensor on the
    parameters' device. The transform is rebuilt from those tensors at every
    update, so overwriting one between steps changes the next update.
    Python floats are injected; ints, bools, strings, callables and anything
    named in ``static_args`` stay static."""
    sig = inspect.signature(factory)

    def wrapped(*args, **kwargs) -> GradientTransform:
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        hyper: dict[str, float] = {}
        static: dict[str, Any] = {}

        def place(name, val):
            if name not in static_args and isinstance(val, float):
                hyper[name] = val
            else:
                static[name] = val

        for name, val in bound.arguments.items():
            if sig.parameters[name].kind == inspect.Parameter.VAR_KEYWORD:
                for k, v in val.items():
                    place(k, v)
            else:
                place(name, val)

        def make(hp):
            return factory(**static, **hp)

        def init(params):
            device = next(iter(params.values())).device if params else None
            return InjectHyperparamsState(
                hyperparams={k: torch.tensor(v, dtype=torch.float32,
                                             device=device)
                             for k, v in hyper.items()},
                inner=make(hyper).init(params))

        def update(updates, state, params, ctx):
            t = make({k: state.hyperparams[k] for k in hyper})
            updates, inner = t.update(updates, state.inner, params, ctx)
            return updates, InjectHyperparamsState(dict(state.hyperparams),
                                                   inner)

        def basis_sizes(params):
            return make(hyper).basis_sizes(params)

        return GradientTransform(init, update, basis_sizes)

    return wrapped


def lr_scale_transform(initial: float = 1.0) -> GradientTransform:
    """A run-time LR multiplier as an injected hyperparameter. At the end of
    a chain it scales the final update (descent and decay alike). Its
    ``lr_scale`` state tensor is what the resilience ladder's LR-cut rung
    rewrites between steps (``train.resilience.scale_hyperparam``). Each
    update is multiplied by that 0-d tensor in the update's dtype, never by
    a Python float, so the product is the JAX package's IEEE one."""

    def factory(lr_scale: float = 1.0) -> GradientTransform:
        # only updates run the product, and they rebuild the transform
        # from the state's tensor
        return stateless(lambda updates, params, ctx: {
            k: u * lr_scale.to(u.dtype) for k, u in updates.items()})

    return inject_hyperparams(factory)(lr_scale=float(initial))


def clip_global_norm(max_norm: float) -> GradientTransform:
    """Scale updates so their global l2 norm is at most ``max_norm``: the
    norm in fp32, the factor ``min(1, max_norm / max(norm, 1e-9))`` as a 0-d
    fp32 tensor (a bf16 update is widened to fp32 by it, as JAX's
    promotion does)."""

    def upd(updates, params, ctx):
        # a block's squares summed with the other ranks' blocks
        norm = torch.sqrt(sharding.sum_squares(updates.values()))
        # a tensor quotient: torch divides a Python scalar by a tensor as a
        # multiply by the reciprocal, an ulp off IEEE
        scale = torch.clamp(torch.full_like(norm, max_norm)
                            / torch.clamp_min(norm, 1e-9), max=1.0)
        return {k: u.to(torch.promote_types(u.dtype, scale.dtype)) * scale
                for k, u in updates.items()}

    return stateless(upd)


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransform:
    """Multiply updates by ``step_size_fn(step)`` (or a constant)."""

    def upd(updates, params, ctx):
        s = sched_value(step_size_fn, ctx.step)
        return {k: s * u for k, u in updates.items()}

    return stateless(upd)


def scale_by_learning_rate(lr: Schedule) -> GradientTransform:
    """Descent scaling ``u -> -lr_t * u`` (fp32)."""

    def upd(updates, params, ctx):
        lr_t = sched_value(lr, ctx.step)
        return {k: -lr_t * u.float() for k, u in updates.items()}

    return stateless(upd)


def add_decayed_weights(weight_decay: float, *,
                        schedule: Schedule | None = None) -> GradientTransform:
    """Decoupled weight decay. Without ``schedule``: ``u + wd * p`` (before
    the lr scaling). With ``schedule``: ``u - lr_t * wd * p`` (after
    ``scale_by_learning_rate``)."""

    def upd(updates, params, ctx):
        if schedule is None:
            return {k: u + weight_decay * params[k].float()
                    for k, u in updates.items()}
        lr_t = sched_value(schedule, ctx.step)
        return {k: u - lr_t * weight_decay * params[k].float()
                for k, u in updates.items()}

    return stateless(upd)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransform:
    """Full-rank Adam direction ``mhat / (sqrt(vhat) + eps)`` per leaf,
    bias-corrected by the global step."""

    def init(params):
        return {k: FullAdamLeaf(AdamMoments(
                    torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    torch.zeros(p.shape, dtype=torch.float32, device=p.device)))
                for k, p in params.items()}

    def update(updates, state, params, ctx):
        mesh = sharding.active_mesh()
        d, new_state = {}, {}
        for k, g in updates.items():
            mom = state[k].mom
            p_spec = (sharding.param_spec(k, tuple(g.shape), mesh)
                      if mesh is not None else sharding.REPLICATED)
            if p_spec.split and p_spec.splits(mesh):
                # elementwise: the moments' block updates from the
                # gradient's block (as the step hands it, or cut from a
                # whole gradient), no gather (module docstring)
                blk = sharding.block_shape(g.shape, p_spec, mesh)
                if tuple(mom.m.shape) != blk:
                    raise ValueError(
                        f"the Adam moments of {k!r} are "
                        f"{tuple(mom.m.shape)}, not this rank's block {blk}"
                        "; initialize the state (opt.init) under the "
                        "active mesh and policy")
                u, mom = adam_update(_block_of(g, p_spec, mesh), mom,
                                     ctx.step, b1, b2, eps)
                d[k] = sharding.Block(u, p_spec, mesh)
            else:
                d[k], mom = adam_update(g, mom, ctx.step, b1, b2, eps)
            new_state[k] = FullAdamLeaf(mom)
        return d, new_state

    return GradientTransform(init, update)


def lowrank_project(rule: MatrixRule, *,
                    overrides: dict[str, dict] | None = None
                    ) -> GradientTransform:
    """Lift a per-matrix-leaf :class:`MatrixRule` to a whole-tree transform.
    Each leaf gets a :class:`Context` whose key folds in the hash of its
    path. Emits the rule's raw descent direction ``D``; compose with
    ``scale_by_learning_rate`` / ``add_decayed_weights``.

    ``overrides`` maps leaf paths to field replacements on ``rule``, e.g.
    ``{"block/0/wq": {"rank": 192, "update_interval": 4}}``: the plug point
    the adaptive rank / refresh controllers drive (``telemetry.adaptive``
    rebuilds the optimizer and migrates its state when they move). The
    telemetry collector, if one is installed, is narrowed to the same path,
    so a leaf's stats land under its override key.

    Under ZeRO-1 (``ctx.zero`` resolving against the active mesh) a leaf
    whose state is held by rows (``zero.partitioned``) runs on this rank's
    rows when its rule is ``zero_shardable`` and whole otherwise. Under
    an active mesh every other leaf's state follows its parameter's
    placement: gathered, updated whole and cut again
    (``_placed_leaf_update``)."""

    def rule_for(path: str) -> MatrixRule:
        if overrides and path in overrides:
            return dataclasses.replace(rule, **overrides[path])
        return rule

    def init(params):
        return {k: rule_for(k).init(p.shape, p.dtype, p.device)
                for k, p in params.items()}

    def update(updates, state, params, ctx):
        zctx = zero_mod.resolve(ctx.zero)
        mesh = sharding.active_mesh()
        d, new_state = {}, {}
        for k, g in updates.items():
            r, s, p = rule_for(k), state[k], params[k]
            leaf_ctx = dataclasses.replace(
                ctx, key=leaf_key(ctx.key, k),
                stats=ctx.stats.scope(k) if ctx.stats is not None else None)
            if zctx is not None and zero_mod.partitioned(s, p.shape,
                                                         zctx.n_shards):
                fn = (zero_mod.sharded_leaf_update if r.zero_shardable
                      else zero_mod.replicated_leaf_update)
                d[k], new_state[k] = fn(r, g, s, p, leaf_ctx, zctx)
            elif mesh is not None:
                d[k], new_state[k] = _placed_leaf_update(r, k, g, s, p,
                                                         leaf_ctx, mesh)
            else:
                d[k], new_state[k] = r.update(g, s, p, leaf_ctx)
        return d, new_state

    def basis_sizes(params):
        sizes = set()
        if rule.needs_shared_basis:
            for p in params.values():
                sizes.update(rule.basis_sizes(p.shape))
        return sizes

    return GradientTransform(init, update, basis_sizes)


def _block_of(g, spec, mesh) -> torch.Tensor:
    """This rank's block under ``spec`` of ``g``: a ``sharding.Block`` of
    that placement as it is, a whole tensor cut."""
    if isinstance(g, sharding.Block):
        if g.placement != spec:
            raise ValueError(f"a block under {g.placement}, not {spec}")
        return g.local
    return sharding.local_block(g, spec, mesh)


def _placed_leaf_update(rule, path, g, state, param, ctx, mesh):
    """A leaf whose state follows its parameter's placement on ``mesh``:
    the state is gathered, the rule runs on the whole leaf and the new
    state is cut again, so every element is computed as on one process
    (the placements come from the rule's state of the whole leaf on
    ``meta``). A gradient handed as a ``sharding.Block`` (the train step's)
    is gathered for the rule and the update cut to this rank's block, so
    the whole leaf lives only for this call; a whole gradient (the API's)
    gives the whole update."""
    p_spec = sharding.param_spec(path, tuple(param.shape), mesh)
    if not p_spec.splits(mesh):
        return rule.update(g, state, param, ctx)
    whole = rule.init(param.shape, param.dtype, "meta")
    specs = sharding.leaf_state_specs(param.shape, p_spec, whole)
    sharding.check_blocks(state, whole, specs, mesh,
                          what=f"optimizer state of {path!r}")
    blocked = isinstance(g, sharding.Block)
    d, new_state = rule.update(g.gather() if blocked else g,
                               sharding.gather_tree(state, specs, mesh),
                               param, ctx)
    if blocked:
        d = sharding.Block(sharding.local_block(d, p_spec, mesh), p_spec,
                           mesh)
    return d, sharding.shard_tree(new_state, specs, mesh)


class ChainState(NamedTuple):
    """Top-level optimizer state emitted by ``as_optimizer``: the global step,
    the root key (``seed``: where the JAX ``ChainState`` holds
    ``PRNGKey(seed)``), the shared bases (and their contiguous transposes)
    and the wrapped transform's state."""

    step: int
    seed: int
    bases: dict
    bases_t: dict
    leaves: Any


def as_optimizer(transform: GradientTransform, *, seed: int = 0,
                 basis_mode: str = "stored", zero=None, lr_scale: bool = False
                 ) -> Optimizer:
    """Close a transform into the ``Optimizer(init, update)`` interface.

    ``basis_mode="stored"`` materializes one ``(n, n)`` basis per distinct
    ``(kind, n)`` the stack requests (the paper's whole-model shared basis,
    from the process-wide BasisCache, on the parameters' device) and one
    contiguous transpose of each; ``"onthefly"`` stores nothing and lets
    ``Context.basis`` rebuild it inside the step.

    Under an active mesh ``init`` keeps this rank's blocks of the state
    (``sharding.opt_state_specs``: each leaf's state follows its
    parameter's placement under the active policy) and ``update`` runs on
    them (module docstring). ``zero``: a
    :class:`repro_torch.parallel.zero.ZeroConfig` enabling ZeRO-1 on the
    active mesh: the claimed leaves' state is held by rows instead, and
    every update runs them by rows (``lowrank_project``). Without a mesh
    the state and the update are the replicated ones.

    ``lr_scale=True`` appends :func:`lr_scale_transform`, the resilience
    ladder's LR-cut seam (off by default: the chain and its state are then
    those of a build without the option).
    """
    if basis_mode not in ("stored", "onthefly"):
        raise ValueError(f"unknown basis_mode {basis_mode!r}; expected "
                         f"'stored' or 'onthefly'")
    if zero is not None and not isinstance(zero, zero_mod.ZeroConfig):
        raise TypeError(f"zero= takes a parallel.zero.ZeroConfig, not "
                        f"{zero!r}")
    if lr_scale:
        transform = chain(transform, lr_scale_transform())

    def init(params):
        sizes = transform.basis_sizes(params) if basis_mode == "stored" else ()
        reqs = sorted({normalize_basis_request(s) for s in sizes})
        device = next(iter(params.values())).device if params else None
        bases = {basis_store_key(k, n): shared_basis(k, n, torch.float32, device)
                 for k, n in reqs}
        state = ChainState(step=0, seed=seed, bases=bases,
                           bases_t=transposed(bases),
                           leaves=transform.init(params))
        mesh = sharding.active_mesh()
        if mesh is None:
            return state
        specs = sharding.opt_state_specs(
            state, params, sharding.params_specs(params, mesh), zero=zero,
            mesh=mesh)
        return sharding.shard_tree(state, specs, mesh)

    def update(grads, state: ChainState, params):
        step = state.step + 1
        # the collector installed around this call (``telemetry.stats.
        # collect``), if any, rides the ctx; rules record into it
        ctx = Context(step=step, bases=state.bases, bases_t=state.bases_t,
                      key=fold_in(state.seed, step),
                      stats=active_collector(), zero=zero)
        updates, leaves = transform.update(grads, state.leaves, params, ctx)
        return updates, state._replace(step=step, leaves=leaves)

    return Optimizer(init=init, update=update)


def transposed(bases: dict) -> dict:
    """Contiguous ``Q^T`` of every stored basis, same keys."""
    return {k: q.T.contiguous() for k, q in bases.items()}


def matrix_optimizer(rule: MatrixRule, lr: Schedule, *,
                     weight_decay: float = 0.0, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8,
                     label_fn=default_label_fn,
                     basis_mode: str = "stored", seed: int = 0,
                     fullrank_weight_decay: bool = True,
                     overrides: dict[str, dict] | None = None,
                     zero=None, lr_scale: bool = False) -> Optimizer:
    """The matrix-optimizer preset as a chain: matrix leaves to ``rule``
    (with the per-leaf ``overrides``), everything else to full-rank Adam,
    then lr scaling and decoupled weight decay — the same chain, and state
    layout, as the JAX preset, and bit for bit the legacy
    ``common.make_matrix_optimizer``. With ``fullrank_weight_decay=False``
    the decay applies to the matrix leaves only: the partition then holds
    ``(rule, lr, decay)`` under ``"lowrank"`` and ``(adam, lr)`` under
    ``"full"``. ``zero`` and ``lr_scale`` are forwarded to
    :func:`as_optimizer`."""
    routes = {"lowrank": lowrank_project(rule, overrides=overrides),
              "full": scale_by_adam(b1, b2, eps)}
    if fullrank_weight_decay:
        t = chain(partition(routes, label_fn),
                  scale_by_learning_rate(lr),
                  add_decayed_weights(weight_decay, schedule=lr))
    else:
        t = partition({
            "lowrank": chain(routes["lowrank"], scale_by_learning_rate(lr),
                             add_decayed_weights(weight_decay, schedule=lr)),
            "full": chain(routes["full"], scale_by_learning_rate(lr)),
        }, label_fn)
    return as_optimizer(t, seed=seed, basis_mode=basis_mode, zero=zero,
                        lr_scale=lr_scale)
