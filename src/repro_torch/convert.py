"""Carry parameters and optimizer state across from the JAX package.

Both functions take the JAX objects with their arrays already turned into
numpy arrays (``jax.tree.map(np.asarray, tree)``) and import nothing of JAX
or ``repro``: the JAX state's containers are recognised by their fields.

* ``params_from_jax`` flattens a nested parameter tree (dicts and lists) into
  the port's ``{leaf path: tensor}`` dict, with the same paths and layouts.
* ``pools_from_jax`` does the same for a serving cache (the paged pools, the
  prefill scratch or the dense decode cache: a list of segments), under
  ``segments/{i}/p{j}/k`` and ``/v``.
* ``opt_state_from_jax`` turns the ``ChainState`` of one of ``repro``'s
  presets into the port's ``ChainState``. The matrix-optimizer presets
  (``dct_adamw``, ``ldadamw``, ``galore``, ``frugal``, ``fira``, ``trion``,
  ``muon``, ``dion``) hold ``(partition{"lowrank", "full"}, EmptyState,
  EmptyState)`` under ``leaves``; ``adamw`` holds ``(scale_by_adam tree,
  EmptyState, EmptyState)``. Carried: the step, the stored bases, the
  full-rank Adam moments, and each matrix leaf's rule state: a
  ``ProjAdamLeaf``'s moments, projector state (int32 indices, or the dense
  kinds' fp32 ``(..., n, r)`` basis), error-feedback buffer (int8 payload and
  scale, fp32, or none where the residual is not EF) and ``inner_step``; a
  ``TrionLeaf``'s or ``MuonLeaf``'s momentum; a ``DionLeaf``'s momentum and
  projection. A preset built with ``lr_scale=True`` holds ``(that chain,
  InjectHyperparamsState)``: its ``hyperparams`` become 0-d fp32 tensors and
  its inner ``EmptyState`` stays empty. The JAX key ``PRNGKey(seed)`` (threefry: ``[seed >> 32, seed
  & 0xFFFFFFFF]``) becomes the port's ``seed``; the stream itself cannot
  carry across (the port draws from ``torch.Generator``, see
  ``optim.transform.fold_in``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.error_feedback import QuantizedBuffer
from repro_torch.devices import resolve_device
from repro_torch.optim.common import AdamMoments, FullAdamLeaf
from repro_torch.optim.dion import DionLeaf
from repro_torch.optim.muon import MuonLeaf
from repro_torch.optim.projected_adam import ProjAdamLeaf
from repro_torch.optim.transform import (ChainState, EmptyState,
                                        InjectHyperparamsState, MaskedNode,
                                        transposed)
from repro_torch.optim.trion import TrionLeaf


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":       # numpy has no bf16 of its own
        return torch.from_numpy(x.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _walk(node, path: str):
    """Yield ``(path, node)`` for every node below dicts and lists, skipping
    the masked positions of a JAX partition state (its ``MaskedNode``, the
    port's by name: the class itself is JAX's)."""
    if type(node).__name__ == MaskedNode.__name__:
        return
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, node


def params_from_jax(tree, device=None) -> dict[str, torch.Tensor]:
    """Nested JAX parameter tree of numpy arrays -> ``{path: tensor}`` on
    ``device`` (None: the card; ``resolve_device``)."""
    device = resolve_device(device)
    return {path: _tensor(leaf, device) for path, leaf in _walk(tree, "")}


def pools_from_jax(tree, device=None) -> dict[str, torch.Tensor]:
    """JAX cache tree ``[{'p{j}': {'k', 'v'}}, ...]`` of numpy arrays ->
    ``{'segments/{i}/p{j}/k': tensor, ...}``."""
    return params_from_jax({"segments": tree}, device)


def _fields(node) -> tuple[str, ...]:
    return tuple(getattr(node, "_fields", ()))


# JAX leaf-state class -> its fields; the momentum families' leaves are told
# apart by class name (TrionLeaf and MuonLeaf have the same one field)
_LEAF_FIELDS = {"ProjAdamLeaf": ("m", "v", "proj", "ef", "inner_step"),
                "FullAdamLeaf": ("mom",), "TrionLeaf": ("m",),
                "MuonLeaf": ("m",), "DionLeaf": ("m", "q")}


def _leaf_states(tree) -> dict:
    """``{path: leaf state}`` of a partition branch (``_walk`` skips the
    positions that belong to the other label)."""
    return {path: node for path, node in _walk(tree, "")
            if _LEAF_FIELDS.get(type(node).__name__) == _fields(node)}


def _proj_leaf(s, device) -> ProjAdamLeaf:
    if s.ef is None:                     # residual "discard": no EF state
        ef = None
    elif _fields(s.ef) == ("q", "scale"):
        ef = QuantizedBuffer(q=_tensor(s.ef.q, device),
                             scale=_tensor(s.ef.scale, device))
    else:
        ef = _tensor(s.ef, device)
    proj = _tensor(s.proj, device)
    if not proj.is_floating_point():     # indices: int32, as JAX holds them
        proj = proj.to(torch.int32)
    return ProjAdamLeaf(m=_tensor(s.m, device), v=_tensor(s.v, device),
                        proj=proj, ef=ef, inner_step=int(s.inner_step))


def _rule_leaf(s, device):
    """A matrix leaf's rule state, by the JAX class's name."""
    kind = type(s).__name__
    if kind == "ProjAdamLeaf":
        return _proj_leaf(s, device)
    if kind == "DionLeaf":
        return DionLeaf(m=_tensor(s.m, device), q=_tensor(s.q, device))
    leaf = {"TrionLeaf": TrionLeaf, "MuonLeaf": MuonLeaf}[kind]
    return leaf(m=_tensor(s.m, device))


def _full_leaf(s, device) -> FullAdamLeaf:
    return FullAdamLeaf(AdamMoments(_tensor(s.mom.m, device),
                                    _tensor(s.mom.v, device)))


def seed_from_jax_key(key) -> int:
    """The seed of a JAX ``PRNGKey(seed)`` (a uint32 pair, high word
    first)."""
    hi, lo = (int(x) for x in np.asarray(key).reshape(-1)[-2:])
    return (hi << 32) | lo


def _rule_chain(leaves, device) -> tuple:
    """``(update rule state, EmptyState, EmptyState)`` of a preset's chain."""
    part, *rest = leaves
    if len(rest) != 2 or any(type(x).__name__ != "EmptyState" for x in rest):
        raise TypeError("expected a chain of (update rule, lr scaling, "
                        "weight decay)")
    if set(part) == {"lowrank", "full"}:
        lowrank = {k: _rule_leaf(s, device)
                   for k, s in _leaf_states(part["lowrank"]).items()}
        full = {k: _full_leaf(s, device)
                for k, s in _leaf_states(part["full"]).items()}
        rule_state = {"lowrank": lowrank, "full": full}
    else:                                # adamw: one scale_by_adam tree
        leaves = _leaf_states(part)
        if not leaves or any(type(s).__name__ != "FullAdamLeaf"
                             for s in leaves.values()):
            raise TypeError("expected a matrix-optimizer partition "
                            "{lowrank, full} or adamw's scale_by_adam tree")
        rule_state = {k: _full_leaf(s, device) for k, s in leaves.items()}
    return (rule_state, EmptyState(), EmptyState())


def opt_state_from_jax(state, device=None) -> ChainState:
    """``repro`` ``ChainState`` of a matrix-optimizer preset or of
    ``adamw`` (numpy leaves), with or without ``lr_scale``, -> the port's,
    on ``device`` (None: the card)."""
    device = resolve_device(device)
    if _fields(state) != ("step", "key", "bases", "leaves"):
        raise TypeError(f"expected repro's ChainState, got {type(state)}")
    if len(state.leaves) == 2 and \
            _fields(state.leaves[1]) == ("hyperparams", "inner"):
        inner, inj = state.leaves
        leaves = (_rule_chain(inner, device), InjectHyperparamsState(
            hyperparams={k: _tensor(v, device)
                         for k, v in inj.hyperparams.items()},
            inner=EmptyState()))
    else:
        leaves = _rule_chain(state.leaves, device)
    bases = {k: _tensor(q, device) for k, q in state.bases.items()}
    return ChainState(step=int(state.step),
                      seed=seed_from_jax_key(state.key), bases=bases,
                      bases_t=transposed(bases), leaves=leaves)
