"""Mixture-of-Experts FFN (``repro/models/moe.py``), on one device or
expert-parallel over the active mesh.

Every token is routed by an fp32 router (softmax over the experts, top-k,
gate weights renormalised), dispatched into a capacity-bounded ``(E, C, d)``
buffer in token-major slot order (tokens past an expert's capacity are
dropped), run through the expert SwiGLUs as three batched products, and
combined back by its gate weights; the shared experts' SwiGLU is added on
top. ``moe_ffn`` returns the output and the load-balance loss ``E * sum(me
* ce)`` times ``cfg.router_aux_weight``.

On a mesh ``moe_ffn`` computes the reference's function of the global
batch, whatever block of it this rank holds (``sharding.batch_cut_axes``):

* without a ``model`` axis the reference routes the global batch as one
  (its ``_local_moe`` under jit): ``_local_moe`` with ``dp_cut`` routes
  this rank's rows with the global token count and capacity, each pair's
  position inside its expert offset by the pairs of the lower data ranks
  (one all-gather of the (E,) counts), and the global ``me`` / ``ce`` (one
  all-reduce of the router's column sums), so a pair is kept exactly when
  the reference keeps it;
* with a ``model`` axis (its ``shard_map``): each rank runs ``_local_moe``
  on its E/tp experts (the block it is handed, or cut from whole expert
  leaves), and the partial outputs are summed over ``model``; the batch
  is cut over the data axes
  when the global batch divides (``batch_sharded``: each data shard routes
  its own rows, the aux averaged over the data axes), else the tokens are
  replicated; under ``decode_tp`` the tokens are replicated and each
  expert's hidden dim is cut over the data axes as well, the f-partials
  summed there too. Where the step cut the batch over axes whose rows
  the reference routes together (``model`` under ``pure_dp``: each data
  shard's tokens; the data axes in a ``decode_tp`` train step: every
  token), ``moe_ffn`` first gathers those rows and keeps its own rows of
  the output; each rank's loss is then a share of the step's, so over
  those axes the gathered rows' cotangents are summed before this rank's
  block is taken and the experts' partial outputs hand every rank the
  summed cotangent. The shared experts run on this rank's rows, as this
  rank's Megatron blocks where the use site hands them so
  (``models.layers.swiglu``).

The backward pairs each collective with its transpose
(``parallel.collectives``): every rank ends with the whole gradient of
what it was handed whole, equal on all ``model`` ranks. In a train step
under ``fsdp_tp`` the expert leaves arrive as this rank's E/tp experts
(``parallel.fsdp`` gathers them over the data axes only), so no expert
leaf is gathered over ``model`` and its gradient stays this rank's block;
where ``_fit_spec`` replicates the expert dim the leaf arrives whole and
is cut here, its gradient all-gathered back. The step then reduces each
gradient to this rank's block over the axes it cut the batch over.

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

from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding

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
               tp_size: int = 1, dp_cut: tuple = (), spread: tuple = ()):
    """The MoE body on the experts ``wg`` / ``wu`` / ``wd`` held here: the
    ``tp_index``-th of ``tp_size`` blocks of E/tp experts (all of them at
    ``tp_size=1``). x: (B, S, d). Returns ``(out (B, S, d) in x's dtype,
    aux)``, aux the unweighted load-balance loss; with ``tp_size > 1`` out
    is this block's part of the output, to be summed over the blocks.

    ``dp_cut``: the mesh axes x is this rank's block of the batch over
    (rows in shard order): the pairs are routed as those of the whole
    batch (module docstring). ``spread``: the mesh axes over which other
    ranks run other experts (or other slices of their hidden dim) on the
    same tokens: the gates and the dispatched rows enter replicated over
    them (``collectives.replicated``: their gradients summed), while the
    aux, which every such rank computes whole, does not."""
    b, s, d = x.shape
    e_loc = wg.shape[0]
    e = e_loc * tp_size
    k = cfg.moe_top_k
    t_loc = b * s
    mesh = sharding.active_mesh()
    t = t_loc * (mesh.size(dp_cut) if dp_cut else 1)

    xf = x.reshape(t_loc, d)
    logits = xf.float() @ router_w.float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gprobs = C.replicated(probs, spread) if spread else probs
    gate_w, gate_e = top_k(gprobs, k)                             # (T, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # the load-balance loss: mean router probability times the share of
    # the T k routed pairs, per expert (over the whole batch with dp_cut:
    # the counts of every data rank, the router's column sums all-reduced)
    flat_e = gate_e.reshape(-1)                                   # (T k,)
    counts = torch.bincount(flat_e, minlength=e)
    prefix = None
    if dp_cut:
        parts = mesh.all_gather(counts, dp_cut)
        prefix = sum(parts[:mesh.shard_index(dp_cut)],
                     torch.zeros_like(counts))
        counts = sum(parts[1:], parts[0])
        me = C.all_reduce(probs.sum(dim=0), dp_cut, grad="same") / t
    else:
        me = probs.mean(dim=0)
    ce = counts.float() / (t * k)
    aux = e * torch.sum(me * ce)

    # capacity-bounded dispatch in token-major (T k) slot order; the
    # position of a pair inside its expert: the one-hot's running count,
    # laid out (E, T k) so the scan runs along the inner axis (along the
    # outer axis of (T k, E), CUDA scans each of the E columns alone), plus
    # the lower data ranks' pairs with dp_cut; this rank's kept pairs fill
    # the buffer's first slots of each expert in that order
    cap = capacity(t, cfg)
    first = tp_index * e_loc
    local = (flat_e >= first) & (flat_e < first + e_loc)
    leid = torch.where(local, flat_e - first, e_loc)              # drop
    onehot = F.one_hot(leid, e_loc + 1)[:, :e_loc].T.contiguous()  # (E, T k)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=0)
    if prefix is None:
        keep = local & (pos < cap)
    else:
        before = torch.cat([prefix[first:first + e_loc],
                            prefix.new_zeros(1)])[leid]
        keep = local & (pos + before < cap)
    slot = torch.where(keep, leid * cap + pos, e_loc * cap)       # overflow

    # each token's row once per slot (an expand: its backward sums the k
    # slots in order); each kept pair writes its own row of the buffer, the
    # dropped ones the overflow row, cut off after
    xr = C.replicated(xf, spread) if spread else xf
    rows = xr[:, None, :].expand(t_loc, k, d).reshape(t_loc * k, d)
    buf = xf.new_zeros((e_loc * cap + 1, d)).index_put((slot,), rows)
    buf = buf[:-1].reshape(e_loc, cap, d)

    h = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    out_buf = torch.bmm(F.silu(h) * u, wd).reshape(e_loc * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])

    contrib = out_buf[slot] * gate_w.reshape(-1)[:, None].to(out_buf.dtype)
    contrib = torch.where(keep[:, None], contrib, 0).reshape(t_loc, k, d)
    # the combine: the k slots of each token added in order, in x's dtype
    out = x.new_zeros((t_loc, d))
    for j in range(k):
        out = out + contrib[:, j].to(x.dtype)
    return out.reshape(b, s, d), aux


def _expert_parallel(p: dict, x, cfg, mesh, tp: str, cut_axes: tuple,
                     shares: tuple = ()):
    """The reference's ``shard_map`` body over ``model`` (module
    docstring) on this rank's activations ``x``, cut over ``cut_axes``
    (() or the data axes). ``shares``: the batch-cut axes whose rows
    ``moe_ffn`` gathered into ``x`` (each rank's loss a share of the
    step's): over them the experts (or their hidden dim) are sliced as
    they are, the gates and the dispatched rows enter as they are, and the
    partial outputs' sum hands each rank the summed cotangent
    (``all_reduce`` with ``grad="same"``), so each rank's gradients are
    its share. Returns (out, aux) for x's rows."""
    dp = sharding.dp_axes(mesh)
    decode_tp = sharding.layout_policy() == "decode_tp"
    if cut_axes and (decode_tp or set(cut_axes) != {
            a for a in dp if mesh.shape[a] > 1}):
        raise ValueError(
            f"moe_ffn: the batch is cut over {cut_axes} on the mesh "
            f"{mesh.shape} under the {sharding.layout_policy()!r} layout, "
            f"where the reference routes the tokens of "
            f"{'every rank (decode_tp)' if decode_tp else 'each data shard'}")
    n_dp = mesh.size(dp) if dp else 1
    # the reference's rule on the global batch: cut over the data axes
    # where it divides, tokens replicated under decode_tp
    b_global = x.shape[0] * (n_dp if cut_axes else 1)
    batch_sharded = bool(dp) and b_global % n_dp == 0 and not decode_tp
    # the whole batch on every rank, cut here: the data ranks then hold
    # equal losses, not shares, and each needs the whole gradient
    cut_here = batch_sharded and not cut_axes
    router = p["router/kernel"]
    wg, wu, wd = p["experts/wg"], p["experts/wu"], p["experts/wd"]
    if cut_here:
        x = C.cut(x, 0, dp)
        router, wg, wu, wd = (C.replicated(w, dp)
                              for w in (router, wg, wu, wd))
    tp_size = mesh.shape[tp]
    tp_index = mesh.shard_index((tp,))
    if wg.shape[0] == cfg.n_experts:
        # whole expert leaves (decode, one process's parameters, the
        # pure_dp layout's, or an expert dim ``_fit_spec`` replicates):
        # this rank's E/tp experts
        if tp in shares:
            e = cfg.n_experts // tp_size
            wg, wu, wd = (w.narrow(0, tp_index * e, e) for w in (wg, wu, wd))
        else:
            wg, wu, wd = (C.cut(w, 0, (tp,)) for w in (wg, wu, wd))
    elif wg.shape[0] * tp_size != cfg.n_experts:
        raise ValueError(f"moe_ffn: {wg.shape[0]} experts held, neither "
                         f"the {cfg.n_experts} of the model nor its block "
                         f"over {tp!r}")
    spread = (tp,) if tp not in shares else ()
    if decode_tp and dp:
        # the experts' hidden dim over the data axes: wg / wu column-,
        # wd row-parallel; the f-partials summed there too
        if shares:
            f = wg.shape[2] // n_dp
            i = mesh.shard_index(dp)
            wg, wu = wg.narrow(2, i * f, f), wu.narrow(2, i * f, f)
            wd = wd.narrow(1, i * f, f)
        else:
            wg, wu = C.cut(wg, 2, dp), C.cut(wu, 2, dp)
            wd = C.cut(wd, 1, dp)
            spread = (tp, *dp)
    out, aux = _local_moe(x, router, wg, wu, wd, cfg=cfg,
                          tp_index=tp_index, tp_size=tp_size, spread=spread)
    out = C.all_reduce(out, spread)
    if shares:
        # the partials over the gathered axes: each rank's experts (or
        # hidden slice) feed every rank's rows
        out = C.all_reduce(out, (tp,) if tp in shares else dp, grad="same")
    # every model rank computes the same aux: their mean, the cotangent
    # handed to each whole
    aux = C.all_reduce(aux, (tp,), mean=True)
    if batch_sharded:
        # the global load-balance loss: the data shards' mean; a share of
        # the step's loss where the step cut the batch, else each data
        # rank's router gradient sums the shards' (replicated above)
        aux = C.all_reduce(aux, dp, mean=True,
                           grad="scale" if cut_here else "same")
    if cut_here:
        out = C.gather(out, 0, dp)
    return out, aux


def moe_ffn(p: dict, x: torch.Tensor, cfg):
    """(B, S, d) -> ((B, S, d), aux-loss scalar times
    ``cfg.router_aux_weight``). ``p``: the block's ``moe/`` leaves (module
    docstring), whole, in the compute dtype or the stored one; x: this
    rank's activations (``sharding.batch_cut_axes`` says which block of the
    global batch they are)."""
    mesh = sharding.active_mesh()
    tp = sharding.tp_axis(mesh)
    cut_axes = tuple(a for a in sharding.batch_cut_axes()
                     if mesh is not None and mesh.shape.get(a, 1) > 1)
    if mesh is not None and tp is not None:
        # the rows the reference routes together that this rank lacks:
        # under pure_dp (the batch cut over model too) its data shard's,
        # gathered over model; in a decode_tp train step (the batch cut
        # over the data axes) the global batch's, gathered over them
        shares = (tp,) if tp in cut_axes else \
            cut_axes if sharding.layout_policy() == "decode_tp" else ()
        if shares:
            rows = x.shape[0]
            # the gathered rows' cotangents summed over the shares before
            # this rank's block is taken: a reduce-scatter's transpose
            xs = C.replicated(C.gather(x, 0, shares), shares)
            out, aux = _expert_parallel(
                p, xs, cfg, mesh, tp,
                tuple(a for a in cut_axes if a not in shares), shares)
            out = out.narrow(0, mesh.shard_index(shares) * rows, rows)
        else:
            out, aux = _expert_parallel(p, x, cfg, mesh, tp, cut_axes)
    else:
        # no model axis: the reference routes the global batch as one
        out, aux = _local_moe(x, p["router/kernel"], p["experts/wg"],
                              p["experts/wu"], p["experts/wd"], cfg=cfg,
                              dp_cut=cut_axes)
    if "shared/wg" in p:
        out = out + swiglu(x, p["shared/wg"], p["shared/wu"], p["shared/wd"],
                           C.megatron_axis(p, "shared/"))
    return out, aux * cfg.router_aux_weight
