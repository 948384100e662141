"""Mixture-of-Experts FFN (``repro/models/moe.py``) on one device.

Every token is routed by an fp32 router (softmax over the experts, top-k,
gate weights renormalised), dispatched into a capacity-bounded ``(E, C, d)``
buffer in token-major slot order (tokens past an expert's capacity are
dropped), run through the expert SwiGLUs as three batched products, and
combined back by its gate weights; the shared experts' SwiGLU is added on
top. ``moe_ffn`` returns the output and the load-balance loss ``E * sum(me
* ce)`` times ``cfg.router_aux_weight``.

The reference runs the same body expert-parallel over its mesh's ``model``
axis (``shard_map``, each device keeping its local expert shard, a psum
combine). This package has no mesh yet (``parallel/`` is not ported), so
``moe_ffn`` runs the body with ``tp_size=1``: every expert on this device.

Parameters are the flat leaves of a block's ``moe/`` subtree, keyed as
the reference's: ``router/kernel`` (d, E) (kept in fp32 at init; the
model's ``cast_params`` rounds it to the compute dtype like any matrix, and
the router widens it back), ``experts/wg`` / ``experts/wu`` (E, d, f),
``experts/wd`` (E, f, d), and with shared experts ``shared/wg`` /
``shared/wu`` (d, fs), ``shared/wd`` (fs, d).

Every step runs in a fixed order, so two runs on the card are bit-equal:
the top-k is a stable descending sort (lower expert index first on ties,
as ``jax.lax.top_k``); the counts and the positions inside an expert are
integer sums; the token gather is an ``expand`` (its backward a sum over
the k slots in order); the dispatch writes each kept pair to its own
slot; and the combine adds the k slots' contributions one after the other
in x's dtype (the order of JAX's scatter-add on the CPU). No ``index_add_``
or scatter-add, whose atomics on the card add in a run-dependent order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense_init, swiglu


class MoEParams(NamedTuple):
    router: torch.Tensor     # (d, E)
    wg: torch.Tensor         # (E, d, f) gate
    wu: torch.Tensor         # (E, d, f) up
    wd: torch.Tensor         # (E, f, d) down


def init_moe(gen, cfg, *, batch: tuple = (), device=None) -> dict:
    """The ``moe/`` leaves of one block (with leading ``batch`` axes: the
    stacked layers of a schedule position), drawn from the
    ``torch.Generator`` ``gen`` in a fixed order (router, wg, wu, wd, then
    the shared wg, wu, wd): N(0, 1/d) for the router and the experts' wg /
    wu, N(0, 1/f) for wd, as the reference's scales (its stream differs).
    ``gen=None`` with ``device="meta"`` gives shapes only."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dt = getattr(torch, cfg.param_dtype)

    def experts(d_in, d_out):
        # (E, d_in, d_out) with the 1/sqrt(d_in) scale of the expert's input
        return dense_init(gen, d_in, d_out, dt, batch=(*batch, e),
                          device=device)

    p = {"router/kernel": dense_init(gen, d, e, torch.float32, batch=batch,
                                     device=device),
         "experts/wg": experts(d, f),
         "experts/wu": experts(d, f),
         "experts/wd": experts(f, d)}
    if cfg.n_shared_experts:
        fs = cfg.shared_d_ff or cfg.moe_d_ff * cfg.n_shared_experts
        for name, (d_in, d_out) in (("wg", (d, fs)), ("wu", (d, fs)),
                                    ("wd", (fs, d))):
            p[f"shared/{name}"] = dense_init(gen, d_in, d_out, dt,
                                             batch=batch, device=device)
    return p


def capacity(tokens: int, cfg) -> int:
    """Slots per expert: ``ceil(T k / E * capacity_factor)`` rounded up to
    a multiple of 8, at least 8."""
    cap = int(math.ceil(tokens * cfg.moe_top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _local_moe(x, router_w, wg, wu, wd, *, cfg, tp_index: int = 0,
               tp_size: int = 1):
    """The MoE body on the experts ``wg`` / ``wu`` / ``wd`` of this device
    (all of them: this package runs ``tp_size=1``). x: (B, S, d). Returns
    ``(out (B, S, d) in x's dtype, aux)``, aux the unweighted load-balance
    loss."""
    b, s, d = x.shape
    e_loc = wg.shape[0]
    e = e_loc * tp_size
    k = cfg.moe_top_k
    t = b * s

    xf = x.reshape(t, d)
    logits = xf.float() @ router_w.float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = top_k(probs, k)                              # (T, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # the load-balance loss: mean router probability times the share of
    # the T k routed pairs, per expert
    me = probs.mean(dim=0)
    flat_e = gate_e.reshape(-1)                                   # (T k,)
    ce = torch.bincount(flat_e, minlength=e).float() / (t * k)
    aux = e * torch.sum(me * ce)

    # capacity-bounded dispatch in token-major (T k) slot order; the
    # position of a pair inside its expert: the one-hot's running count,
    # laid out (E, T k) so the scan runs along the inner axis (along the
    # outer axis of (T k, E), CUDA scans each of the E columns alone)
    cap = capacity(t, cfg)
    first = tp_index * e_loc
    local = (flat_e >= first) & (flat_e < first + e_loc)
    leid = torch.where(local, flat_e - first, e_loc)              # drop
    onehot = F.one_hot(leid, e_loc + 1)[:, :e_loc].T.contiguous()  # (E, T k)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=0)
    keep = local & (pos < cap)
    slot = torch.where(keep, leid * cap + pos, e_loc * cap)       # overflow

    # each token's row once per slot (an expand: its backward sums the k
    # slots in order); each kept pair writes its own row of the buffer, the
    # dropped ones the overflow row, cut off after
    rows = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros((e_loc * cap + 1, d)).index_put((slot,), rows)
    buf = buf[:-1].reshape(e_loc, cap, d)

    h = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    out_buf = torch.bmm(F.silu(h) * u, wd).reshape(e_loc * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])

    contrib = out_buf[slot] * gate_w.reshape(-1)[:, None].to(out_buf.dtype)
    contrib = torch.where(keep[:, None], contrib, 0).reshape(t, k, d)
    # the combine: the k slots of each token added in order, in x's dtype
    out = x.new_zeros((t, d))
    for j in range(k):
        out = out + contrib[:, j].to(x.dtype)
    return out.reshape(b, s, d), aux


def moe_ffn(p: dict, x: torch.Tensor, cfg):
    """(B, S, d) -> ((B, S, d), aux-loss scalar times
    ``cfg.router_aux_weight``). ``p``: the block's ``moe/`` leaves (module
    docstring), in the compute dtype or the stored one."""
    out, aux = _local_moe(x, p["router/kernel"], p["experts/wg"],
                          p["experts/wu"], p["experts/wd"], cfg=cfg)
    if "shared/wg" in p:
        out = out + swiglu(x, p["shared/wg"], p["shared/wu"], p["shared/wd"])
    return out, aux * cfg.router_aux_weight
