"""Carry parameters and DCT-AdamW optimizer state across from the JAX package.

Both functions take the JAX objects with their arrays already turned into
numpy arrays (``jax.tree.map(np.asarray, tree)``) and import nothing of JAX
or ``repro``: the JAX state's containers are recognised by their fields.

* ``params_from_jax`` flattens a nested parameter tree (dicts and lists) into
  the port's ``{leaf path: tensor}`` dict, with the same paths and layouts.
* ``pools_from_jax`` does the same for a serving cache (the paged pools, the
  prefill scratch or the dense decode cache: a list of segments), under
  ``segments/{i}/p{j}/k`` and ``/v``.
* ``opt_state_from_jax`` turns the ``ChainState`` of ``repro``'s
  ``dct_adamw`` — ``(partition{"lowrank", "full"}, EmptyState, EmptyState)``
  under ``leaves`` — into the port's ``ChainState``: the step, the stored
  bases, the full-rank Adam moments, and each ``ProjAdamLeaf``'s moments,
  int32 indices, error-feedback buffer (int8 payload and scale, or fp32) and
  ``inner_step``. The JAX PRNG key is dropped: no ported rule draws random
  numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.error_feedback import QuantizedBuffer
from repro_torch.optim.common import AdamMoments, FullAdamLeaf
from repro_torch.optim.projected_adam import ProjAdamLeaf
from repro_torch.optim.transform import ChainState, EmptyState, transposed


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _walk(node, path: str):
    """Yield ``(path, node)`` for every node below dicts and lists."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, node


def params_from_jax(tree, device=None) -> dict[str, torch.Tensor]:
    """Nested JAX parameter tree of numpy arrays -> ``{path: tensor}``."""
    return {path: _tensor(leaf, device) for path, leaf in _walk(tree, "")}


def pools_from_jax(tree, device=None) -> dict[str, torch.Tensor]:
    """JAX cache tree ``[{'p{j}': {'k', 'v'}}, ...]`` of numpy arrays ->
    ``{'segments/{i}/p{j}/k': tensor, ...}``."""
    return params_from_jax({"segments": tree}, device)


def _fields(node) -> tuple[str, ...]:
    return tuple(getattr(node, "_fields", ()))


def _leaf_states(tree) -> dict:
    """``{path: leaf state}`` of a partition branch, skipping the masked
    positions (``MaskedNode``) that belong to the other label."""
    return {path: node for path, node in _walk(tree, "")
            if _fields(node) in (("m", "v", "proj", "ef", "inner_step"),
                                 ("mom",))}


def _proj_leaf(s, device) -> ProjAdamLeaf:
    if _fields(s.ef) == ("q", "scale"):
        ef = QuantizedBuffer(q=_tensor(s.ef.q, device),
                             scale=_tensor(s.ef.scale, device))
    else:
        ef = _tensor(s.ef, device)
    return ProjAdamLeaf(m=_tensor(s.m, device), v=_tensor(s.v, device),
                        proj=_tensor(s.proj, device).to(torch.int32),
                        ef=ef, inner_step=int(s.inner_step))


def _full_leaf(s, device) -> FullAdamLeaf:
    return FullAdamLeaf(AdamMoments(_tensor(s.mom.m, device),
                                    _tensor(s.mom.v, device)))


def opt_state_from_jax(state, device=None) -> ChainState:
    """``repro`` dct_adamw ``ChainState`` (numpy leaves) -> the port's."""
    if _fields(state) != ("step", "key", "bases", "leaves"):
        raise TypeError(f"expected repro's ChainState, got {type(state)}")
    part, *rest = state.leaves
    if set(part) != {"lowrank", "full"} or len(rest) != 2:
        raise TypeError("expected the dct_adamw chain "
                        "(partition{lowrank, full}, lr scaling, weight decay)")
    lowrank = {k: _proj_leaf(s, device)
               for k, s in _leaf_states(part["lowrank"]).items()}
    full = {k: _full_leaf(s, device)
            for k, s in _leaf_states(part["full"]).items()}
    bases = {k: _tensor(q, device) for k, q in state.bases.items()}
    return ChainState(step=int(state.step), bases=bases,
                      bases_t=transposed(bases),
                      leaves=({"lowrank": lowrank, "full": full},
                              EmptyState(), EmptyState()))
