"""The schedule-driven transformer: the dense GQA models (the paper's
llamas, gemma3-27b, qwen2.5-32b, phi3-mini-3.8b, command-r-plus-104b).

Parameters are a flat dict keyed by the JAX tree's leaf paths, with the same
layouts: segment ``i``, pattern position ``j`` lives under
``segments/{i}/p{j}/...`` with a leading stacked axis of ``repeats`` layers,
e.g. ``segments/0/p0/attn/wq/kernel`` of shape ``(layers, d, hq * hd)``
applied as ``x @ w``. ``convert.params_from_jax`` carries a JAX parameter
tree across unchanged.

Ported for ``family="dense"`` with the ``attn`` and ``local`` (sliding
window of ``cfg.sliding_window``) blocks, optional qk-norm, optional qkv
bias (``attn/w{q,k,v}/bias``, added after each projection's product) and
``attn_sp`` (``layers.sp_blockwise_attention``, plain blockwise attention
on one device): ``init_params``, ``param_count``, ``cast_params``, the
per-block API (``ATTN_KINDS``, ``init_block``, ``block_apply``: the one
place a block's math lives) and ``forward`` (training, and the dense
prefill, whose no-grad attention is the ``flash_attention`` kernel on the
card); the dense decode path (``init_cache``, ``prefill``, ``decode_step``;
a ``local`` layer keeps a ring of its last ``window`` positions); the paged
serving path (``init_paged_pools``, ``init_prefill_scratch``,
``prefill_chunk``, ``write_prefill_to_pools``, ``decode_step_paged``),
whose attention is the ``flash_decode`` kernel. Not yet ported: the other
block kinds and families (``attn_moe``, MoE, MLA, Mamba, RWKV,
encoder-decoder, VLM, with ``MLA_KINDS``, ``MOE_KINDS`` and ``encode``),
and the mesh of sequence-parallel attention.

Caches and pools are flat dicts too, keyed like the JAX trees:
``segments/{i}/p{j}/k`` and ``.../v``. Unlike the JAX package, whose
arrays are immutable, the serving entry points write K/V into them in
place and return them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.devices import resolve_device

from .layers import (
    apply_rope,
    blockwise_attention,
    chunk_attention,
    decode_attention,
    dense_init,
    embed_init,
    matmul,
    rms_norm,
    rope_at,
    rope_table,
    rope_tables_at,
    sp_blockwise_attention,
    swiglu,
)


#: the reference's attention block kinds
ATTN_KINDS = ("attn", "local", "attn_moe", "enc", "dec", "cross")
#: the block kinds this package builds
PORTED_KINDS = ("attn", "local")


def _check_ported(cfg) -> None:
    kinds = cfg.block_kinds()
    if cfg.family != "dense" or not set(kinds) <= set(PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: only dense models of {PORTED_KINDS} blocks are "
            f"ported to repro_torch (family={cfg.family!r}, blocks={kinds})")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not yet ported to "
                                  f"repro_torch (ported: {PORTED_KINDS})")


def _window(kind: str, cfg) -> int | None:
    return cfg.sliding_window if kind == "local" else None


def init_params(cfg, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """Full parameter dict from a ``torch.Generator`` seeded with ``seed``
    (its own stream: the values differ from ``repro``'s for the same seed),
    on ``device`` (None: the card; ``resolve_device``).
    ``device="meta"`` gives the shapes and dtypes without values (the
    counterpart of ``jax.eval_shape``; a meta tensor draws from no
    generator)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    params = {"embed/kernel": embed_init(gen, cfg.vocab_size, d, dt,
                                         device=dev)}
    if not cfg.tie_embeddings:
        params["unembed/kernel"] = embed_init(gen, cfg.vocab_size, d, dt,
                                              device=dev)
    params["final_norm/scale"] = torch.zeros(d, dtype=torch.float32,
                                             device=dev)
    for i, (pattern, repeats) in enumerate(cfg.schedule):
        for j, _ in enumerate(pattern):
            block = _block_leaves(gen, cfg, (repeats,), dev)
            params.update({f"segments/{i}/p{j}/{k}": v
                           for k, v in block.items()})
    return params


def _block_leaves(gen, cfg, batch: tuple, dev) -> dict[str, torch.Tensor]:
    """One ``attn`` / ``local`` block's leaves with leading ``batch`` axes
    (the stacked layers of a schedule position, or none), the weights drawn
    from ``gen`` in a fixed order: wq, wk, wv, wo, wg, wu, wd."""
    dt = getattr(torch, cfg.param_dtype)
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)

    def w(d_in, d_out):
        return dense_init(gen, d_in, d_out, dt, batch=batch, device=dev)

    p = {
        "ln1/scale": torch.zeros((*batch, d), device=dev),
        "attn/wq/kernel": w(d, hq * hd),
        "attn/wk/kernel": w(d, hkv * hd),
        "attn/wv/kernel": w(d, hkv * hd),
        "attn/wo/kernel": w(hq * hd, d),
        "ln2/scale": torch.zeros((*batch, d), device=dev),
        "mlp/wg/kernel": w(d, f),
        "mlp/wu/kernel": w(d, f),
        "mlp/wd/kernel": w(f, d),
    }
    if cfg.qkv_bias:
        for n, width in (("q", hq * hd), ("k", hkv * hd), ("v", hkv * hd)):
            p[f"attn/w{n}/bias"] = torch.zeros((*batch, width), dtype=dt,
                                               device=dev)
    if cfg.use_qk_norm:
        for n in ("q", "k"):
            p[f"attn/{n}_norm_scale"] = torch.zeros(
                (*batch, hd), dtype=torch.float32, device=dev)
    return p


def init_block(gen, kind: str, cfg, device=None) -> dict[str, torch.Tensor]:
    """One block's leaves, keyed as a layer's parameters under its
    ``segments/{i}/p{j}/`` prefix (``attn/wq/kernel`` of (d, hq * hd), no
    stacked axis), drawn from the ``torch.Generator`` ``gen`` (the JAX
    package's ``init_block`` takes a key; the streams differ). ``device``:
    the generator's by default; ``"meta"`` (with ``gen=None``) gives shapes
    only."""
    _check_kind(kind)
    return _block_leaves(gen, cfg, (),
                         torch.device(device) if device is not None
                         else gen.device)


def param_count(params: dict) -> int:
    """Elements over every leaf; a ``device="meta"`` dict counts too (a
    full configuration without allocating it)."""
    return sum(p.numel() for p in params.values())


_PRECISION_CRITICAL = ("norm", "ln", "scale", "bias", "a_log", "d_skip",
                       "decay", "bonus", "gate", "mu_")


def cast_params(params: dict, cfg) -> dict:
    """Mixed precision: weights cast to the compute dtype at use; small
    precision-critical leaves (norm scales) stay in their stored dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    out = {}
    for path, p in params.items():
        if any(h in path.lower() for h in _PRECISION_CRITICAL) \
                or not p.is_floating_point():
            out[path] = p
        else:
            out[path] = p.to(cdt)
    return out


def _qk_norm(p: dict, q, k, cfg):
    """qk-norm (an RMS norm over the head dim, eps 1e-6, as the JAX
    package's ``_qk_norm``) where the config has it; before the rope."""
    if not cfg.use_qk_norm:
        return q, k
    return (rms_norm(q, p["attn/q_norm_scale"]),
            rms_norm(k, p["attn/k_norm_scale"]))


def _proj(p: dict, h, n: str):
    """``h @ attn/w{n}/kernel``, then its bias where the config has one: a
    separate add after the product, as the JAX package's (one rounding
    more than a fused ``addmm`` in bf16). A bias kept in fp32 beside bf16
    products widens the result to fp32, as JAX's promotion does."""
    y = h @ p[f"attn/w{n}/kernel"]
    bias = p.get(f"attn/w{n}/bias")
    return y if bias is None else y + bias


def block_apply(kind: str, p: dict, x, cfg, ctx=None, *,
                return_kv: bool = False):
    """One block of the schedule on ``x`` (B, S, d): pre-norm GQA
    self-attention (a sliding window for ``local``) and a SwiGLU MLP, each
    added to the residual. ``p``: the block's leaves (one layer's, keyed as
    ``init_block``'s); ``ctx``: the cross-attention inputs of the
    reference's other kinds (the ported kinds read none). Returns ``(x,
    aux, kv)``: ``aux`` the block's auxiliary loss (a 0-d fp32 zero: no
    MoE), ``kv`` the block's roped ``(k, v)`` with ``return_kv``, else
    None."""
    _check_kind(kind)
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1/scale"], cfg.norm_eps)
    q = _proj(p, h, "q").reshape(b, s, hq, hd)
    k = _proj(p, h, "k").reshape(b, s, hkv, hd)
    v = _proj(p, h, "v").reshape(b, s, hkv, hd)
    q, k = _qk_norm(p, q, k, cfg)
    cos, sin = rope_table(s, hd, cfg.rope_theta, device=x.device)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attend = sp_blockwise_attention if cfg.attn_sp else blockwise_attention
    a = attend(q, k, v, causal=True, window=_window(kind, cfg),
               q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + matmul(a.reshape(b, s, hq * hd), p["attn/wo/kernel"])
    h = rms_norm(x, p["ln2/scale"], cfg.norm_eps)
    x = x + swiglu(h, p["mlp/wg/kernel"], p["mlp/wu/kernel"],
                   p["mlp/wd/kernel"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, ((k, v) if return_kv else None)


def _layers(p: dict, cfg):
    """Yield ``(segment prefix, block kind, layer index, that layer's
    parameter views)`` in schedule order. One ``unbind`` per stacked leaf:
    its backward stacks the per-layer gradients in one pass, where indexing
    the stack per layer would make autograd build and add a full-stack
    gradient buffer for every layer."""
    for pre, kind, repeats in _kv_keys(cfg):
        stacked = {k[len(pre):]: v.unbind(0) for k, v in p.items()
                   if k.startswith(pre)}
        for layer in range(repeats):
            yield pre, kind, layer, {k: v[layer] for k, v in stacked.items()}


def forward(params: dict, batch: dict, cfg, *, return_cache: bool = False):
    """batch: ``{'tokens': (B, S) int}``. Returns ``(logits, aux)`` with
    logits (B, S, vocab) in the compute dtype or, with ``return_cache``,
    ``(logits, aux, kv)``: ``kv[segment prefix]`` the per-layer roped
    ``(k, v)``, each (B, S, Hkv, hd). ``cfg.remat`` recomputes each layer in
    the backward pass (``torch.utils.checkpoint``); it is off with
    ``return_cache`` (inference)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    cdt = getattr(torch, cfg.compute_dtype)
    p = cast_params(params, cfg)
    x = p["embed/kernel"][tokens]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kv: dict[str, list] = {}
    for pre, kind, _, lp in _layers(p, cfg):
        if cfg.remat and not return_cache:
            x, a, _ = checkpoint(block_apply, kind, lp, x, cfg, {},
                                 use_reentrant=False)
        else:
            x, a, pair = block_apply(kind, lp, x, cfg, {},
                                     return_kv=return_cache)
            if return_cache:
                kv.setdefault(pre, []).append(pair)
        x = x.to(cdt)                      # pin the residual-stream dtype
        aux_total = aux_total + a
    x = rms_norm(x, p["final_norm/scale"], cfg.norm_eps)
    unemb = p["embed/kernel"] if cfg.tie_embeddings else p["unembed/kernel"]
    logits = x @ unemb.to(cdt).T
    aux = {"moe_aux": aux_total, "mtp_logits": None}
    if return_cache:
        return logits, aux, kv
    return logits, aux


# ===========================================================================
# Dense decode cache and decode step
# ===========================================================================
def _kv_keys(cfg):
    """``(segment prefix, block kind, repeats)`` of every attention
    position."""
    for i, (pattern, repeats) in enumerate(cfg.schedule):
        for j, kind in enumerate(pattern):
            yield f"segments/{i}/p{j}/", kind, repeats


def _cache_len(kind: str, cfg, max_len: int) -> int:
    """A ``local`` layer's decode cache is a ring of its window."""
    return min(cfg.sliding_window, max_len) if kind == "local" else max_len


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Zeroed dense decode cache: ``segments/{i}/p{j}/k`` and ``/v`` of
    (repeats, B, max_len, Hkv, hd) in the compute dtype; ``max_len`` is
    ``min(window, max_len)`` for a ``local`` layer (position p at ring slot
    p % that length), on ``device`` (None: the card)."""
    _check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    dev = resolve_device(device)
    return {pre + n: torch.zeros(
                (repeats, batch, _cache_len(kind, cfg, max_len),
                 cfg.n_kv_heads, cfg.hd), dtype=cdt, device=dev)
            for pre, kind, repeats in _kv_keys(cfg) for n in "kv"}


def _rope_decode(x, cos, sin):
    """x: (B, H, hd); tables (B, 1, half), broadcast over the head axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _qkv_decode(p, x_t, pos, cfg):
    """Roped (and qk-normed) single-token q (B, Hq, hd), k and v (B, Hkv,
    hd)."""
    b = x_t.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj(p, x_t, "q").reshape(b, hq, hd)
    k = _proj(p, x_t, "k").reshape(b, hkv, hd)
    v = _proj(p, x_t, "v").reshape(b, hkv, hd)
    q, k = _qk_norm(p, q, k, cfg)
    cos, sin = rope_at(pos, hd, cfg.rope_theta)        # (B, 1, half)
    return _rope_decode(q, cos, sin), _rope_decode(k, cos, sin), v


def _gqa_decode(p, x_t, k_cache, v_cache, pos, cfg, *, window=None):
    """x_t: (B, d); caches (B, S, Hkv, hd) of one layer, written in place at
    each row's ``pos`` or, with a ``window``, at ring slot ``pos % S``
    (entries masked by the position they hold). Returns the attention
    output projected by wo."""
    b = x_t.shape[0]
    q, k, v = _qkv_decode(p, x_t, pos, cfg)
    rows = torch.arange(b, device=x_t.device)
    s = k_cache.shape[1]
    slot = pos % s if window is not None else pos
    k_cache[rows, slot] = k.to(k_cache.dtype)
    v_cache[rows, slot] = v.to(v_cache.dtype)
    if window is not None:
        posc = pos[:, None]
        entry_pos = posc - ((posc - torch.arange(s, device=x_t.device)) % s)
        mask = (entry_pos >= 0) & (entry_pos >= posc - window + 1)
        out = decode_attention(q, k_cache, v_cache, mask=mask)
    else:
        out = decode_attention(q, k_cache, v_cache, length=pos + 1)
    return matmul(out.reshape(b, cfg.n_heads * cfg.hd), p["attn/wo/kernel"])


def _ffn(p, x_t, cfg):
    """Post-attention half of an ``attn`` block: norm + SwiGLU, residual."""
    h = rms_norm(x_t, p["ln2/scale"], cfg.norm_eps)
    return x_t + swiglu(h, p["mlp/wg/kernel"], p["mlp/wu/kernel"],
                        p["mlp/wd/kernel"])


def block_decode(kind: str, p, x_t, k_cache, v_cache, pos, cfg):
    """One layer of the dense decode step. x_t: (B, d); pos: (B,)."""
    _check_kind(kind)
    h = rms_norm(x_t, p["ln1/scale"], cfg.norm_eps)
    x_t = x_t + _gqa_decode(p, h, k_cache, v_cache, pos, cfg,
                            window=_window(kind, cfg))
    return _ffn(p, x_t, cfg)


def _lm_head(x_t, params, cfg):
    """Final norm + unembedding of every decode entry point.
    x_t: (..., d) -> logits (..., vocab)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x_t = rms_norm(x_t, params["final_norm/scale"], cfg.norm_eps)
    unemb = params["embed/kernel"] if cfg.tie_embeddings \
        else params["unembed/kernel"]
    return x_t @ unemb.to(cdt).T


def _positions(pos, b: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, dtype=torch.long, device=device)
    return pos.expand(b) if pos.dim() == 0 else pos


def decode_step(params, cache, token, pos, cfg):
    """token: (B,) int; pos: scalar or (B,) per-sequence positions of this
    token. Writes the token's K/V into ``cache`` in place. Returns
    ``(logits (B, vocab), cache)``."""
    _check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    p = cast_params(params, cfg)
    x_t = p["embed/kernel"][token]
    pos = _positions(pos, x_t.shape[0], x_t.device)
    for pre, kind, layer, lp in _layers(p, cfg):
        x_t = block_decode(kind, lp, x_t, cache[pre + "k"][layer],
                           cache[pre + "v"][layer], pos, cfg).to(cdt)
    return _lm_head(x_t, p, cfg), cache


def prefill(params, batch, cfg, max_len: int | None = None):
    """Run the full prompt and build the decode cache. Returns
    ``(last_logits (B, vocab), cache, n_prompt)``; the per-layer K/V are
    zero-padded to ``max_len``, a ``local`` layer's laid out as its ring."""
    s = batch["tokens"].shape[1]
    max_len = max_len or s
    logits, _, kv = forward(params, batch, cfg, return_cache=True)
    cdt = getattr(torch, cfg.compute_dtype)
    kinds = {pre: kind for pre, kind, _ in _kv_keys(cfg)}
    cache = {}
    for pre, pairs in kv.items():
        w = _cache_len(kinds[pre], cfg, max_len)
        for n, t in zip("kv", zip(*pairs)):
            cache[pre + n] = _prefill_entry(torch.stack(t), w, cdt,
                                            ring=kinds[pre] == "local")
    return logits[:, -1], cache, s


def _prefill_entry(x, w: int, cdt, *, ring: bool):
    """(R, B, S, Hkv, hd) -> (R, B, w, Hkv, hd), zero-padded. With ``ring``
    and S > w, the last ``w`` positions laid out ring-style (position p at
    slot p % w), as a ``local`` layer's decode cache holds them."""
    s = x.shape[2]
    x = x.to(cdt)
    if ring and s > w:
        slots = torch.arange(s - w, s, device=x.device) % w
        return x[:, :, -w:][:, :, torch.argsort(slots)]
    if s >= w:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, w - s))


# ===========================================================================
# Paged serving path
#
# The dense decode cache charges every slot for max_len tokens. The serving
# engine instead keeps one pool of fixed-size token blocks per layer
# (serve/kv_cache.py), addressed through per-slot block tables; attention is
# the flash_decode kernel, which reads K/V through the table. Entry points:
#
#   init_paged_pools(cfg, NB, bs)                 zeroed pools
#   init_prefill_scratch(cfg, max_prefill_len)    dense scratch of ONE prompt
#   prefill_chunk(params, scratch, tokens, ...)   one prompt chunk into it
#   write_prefill_to_pools(pools, scratch, ...)   scratch -> the prompt's blocks
#   decode_step_paged(params, pools, ...)         one token for every slot
# ===========================================================================
PAGED_KINDS = ("attn", "local", "attn_moe")


def paged_supported(cfg) -> bool:
    """True when every block in ``cfg.schedule`` has a paged layout."""
    return all(kind in PAGED_KINDS
               for pattern, _ in cfg.schedule for kind in pattern)


def _check_paged(cfg):
    if not paged_supported(cfg):
        bad = sorted({k for pattern, _ in cfg.schedule for k in pattern
                      if k not in PAGED_KINDS})
        raise ValueError(
            f"paged serving supports kinds {PAGED_KINDS}; {cfg.name!r} "
            f"has {bad} — use the dense ServeEngine for this family")
    missing = sorted({k for pattern, _ in cfg.schedule for k in pattern
                      if k not in PORTED_KINDS})
    if missing:
        raise NotImplementedError(f"paged block kinds {missing} are not yet "
                                  f"ported to repro_torch")
    _check_ported(cfg)


def init_paged_pools(cfg, num_blocks: int, block_size: int,
                     device=None) -> dict:
    """Zeroed paged K/V pools ``segments/{i}/p{j}/k`` and ``/v`` of
    (repeats, NB, bs, Hkv, hd) in the compute dtype. Block ids are shared
    across layers: entry ``i`` of a block table addresses block ``i`` of
    every layer's pool. A ``local`` layer keeps every position, as the
    JAX package's pools do: the window is a mask of ``flash_decode``. On
    ``device`` (None: the card)."""
    _check_paged(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {pre + n: torch.zeros((repeats, *shape), dtype=cdt, device=dev)
            for pre, _, repeats in _kv_keys(cfg) for n in "kv"}


def init_prefill_scratch(cfg, max_prefill_len: int, device=None) -> dict:
    """Dense per-layer K/V scratch of (repeats, 1, max_prefill_len, Hkv, hd)
    used while chunk-prefilling ONE sequence, then scattered into the
    pools. ``local`` layers get the full length too (the window is a mask,
    so the scatter into blocks stays position-indexed). On ``device``
    (None: the card)."""
    _check_paged(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    shape = (1, max_prefill_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {pre + n: torch.zeros((repeats, *shape), dtype=cdt, device=dev)
            for pre, _, repeats in _kv_keys(cfg) for n in "kv"}


def _paged_gqa_decode(p, x_t, k_pool, v_pool, table, pos, lengths, write,
                      cfg, *, window, num_splits):
    """One token of paged GQA attention for one layer. x_t: (B, d); pools
    (NB, bs, Hkv, hd); table (B, MAXB) int32; pos (B,); lengths (B,) int32
    (0 for inactive slots). ``write = (rows, blocks, offsets)``: the active
    rows and where their new K/V go; inactive rows write nothing (the JAX
    package scatters them out of range, which a CUDA index would assert
    on). Then flash_decode attends through the table."""
    from repro_torch.kernels.flash_decode import flash_decode

    b = x_t.shape[0]
    q, k, v = _qkv_decode(p, x_t, pos, cfg)
    rows, blk, off = write
    if rows is not None:
        k, v = k[rows], v[rows]
    k_pool[blk, off] = k.to(k_pool.dtype)
    v_pool[blk, off] = v.to(v_pool.dtype)
    out = flash_decode(q, k_pool, v_pool, table, lengths, window=window,
                       num_splits=num_splits)
    return matmul(out.reshape(b, cfg.n_heads * cfg.hd), p["attn/wo/kernel"])


def decode_step_paged(params, pools, token, pos, block_table, active, cfg,
                      *, num_splits: int = 1):
    """One decode token for every scheduler slot against the paged pools.

    token / pos / active: (B,) host lanes (numpy arrays or CPU tensors, B =
    slot capacity, fixed); the scatter's rows are picked on the host, so
    the step needs no device sync. block_table: (B, MAXB) int32 tensor on
    the pools' device. Inactive slots cost compute but write nothing and
    read length-0 caches (zero attention output). Each active slot's K/V
    is written into its current block in place. Returns
    ``(logits (B, vocab), pools)``."""
    _check_paged(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    p = cast_params(params, cfg)
    dev = block_table.device
    bs = next(iter(pools.values())).shape[2]
    token = np.asarray(token, np.int64)
    pos = np.asarray(pos, np.int64)
    active = np.asarray(active, bool)
    b = token.shape[0]
    rows = np.flatnonzero(active)
    # one upload: token, pos, lengths | active rows, their table columns
    # and in-block offsets
    lanes = torch.from_numpy(np.concatenate([
        token, pos, np.where(active, pos + 1, 0),
        rows, pos[rows] // bs, pos[rows] % bs])).to(dev)
    n = len(rows)
    token_d, pos_d, len_d, rows_d, col_d, off_d = (
        lanes[:b], lanes[b:2 * b], lanes[2 * b:3 * b], lanes[3 * b:3 * b + n],
        lanes[3 * b + n:3 * b + 2 * n], lanes[3 * b + 2 * n:])
    lengths = len_d.to(torch.int32)
    write = (None if n == b else rows_d,
             block_table[rows_d, col_d].long(), off_d)
    x_t = p["embed/kernel"][token_d]
    for pre, kind, layer, lp in _layers(p, cfg):
        h = rms_norm(x_t, lp["ln1/scale"], cfg.norm_eps)
        a = _paged_gqa_decode(lp, h, pools[pre + "k"][layer],
                              pools[pre + "v"][layer], block_table, pos_d,
                              lengths, write, cfg, window=_window(kind, cfg),
                              num_splits=num_splits)
        x_t = _ffn(lp, x_t + a, cfg).to(cdt)
    return _lm_head(x_t, p, cfg), pools


def prefill_chunk(params, scratch, tokens, start: int, take_idx: int, cfg):
    """Run one prompt chunk through the model, extending the prefill
    scratch in place. tokens: (1, C) (right-padded garbage is fine: causal
    masking keeps it out of valid positions); start: absolute position of
    tokens[:, 0]; take_idx: chunk-local index whose logits to return (the
    prompt's last token on the final chunk). Attention reads the scratch up
    to this chunk's end only, which the causal mask would cut to anyway.
    Returns ``(logits (1, vocab), scratch)``."""
    _check_paged(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    p = cast_params(params, cfg)
    b, c = tokens.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    end = start + c
    x = p["embed/kernel"][tokens]                     # (1, C, d)
    qpos = torch.arange(start, end, device=x.device)
    cos, sin = rope_tables_at(qpos, hd, cfg.rope_theta)
    kpos = torch.arange(end, device=x.device)
    causal = kpos[None, :] <= qpos[:, None]           # causal with offset
    local = causal & (kpos[None, :] >= qpos[:, None] - cfg.sliding_window + 1)
    for pre, kind, layer, lp in _layers(p, cfg):
        h = rms_norm(x, lp["ln1/scale"], cfg.norm_eps)
        q = _proj(lp, h, "q").reshape(b, c, hq, hd)
        k = _proj(lp, h, "k").reshape(b, c, hkv, hd)
        q, k = _qk_norm(lp, q, k, cfg)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        v = _proj(lp, h, "v").reshape(b, c, hkv, hd)
        sk, sv = scratch[pre + "k"][layer], scratch[pre + "v"][layer]
        sk[:, start:end] = k.to(sk.dtype)
        sv[:, start:end] = v.to(sv.dtype)
        out = chunk_attention(q, sk[:, :end], sv[:, :end],
                              local if kind == "local" else causal)
        x = x + matmul(out.reshape(b, c, hq * hd), lp["attn/wo/kernel"])
        x = _ffn(lp, x, cfg).to(cdt)
    return _lm_head(x[:, take_idx], p, cfg), scratch


def write_prefill_to_pools(pools, scratch, block_ids, length: int,
                           block_size: int):
    """Copy a finished prefill scratch into the paged pools, in place.

    block_ids: the sequence's block table (padded; host array or tensor);
    length: valid tokens. The first ``ceil(length / block_size)`` blocks
    are written whole (the tail of the last one holds garbage that stays
    masked by ``length``); the padding entries are not touched."""
    nblocks = -(-int(length) // block_size)
    for key, pool in pools.items():
        scr = scratch[key]
        r = scr.shape[0]
        ids = torch.as_tensor(np.asarray(block_ids)[:nblocks],
                              dtype=torch.long).to(pool.device)
        blocks = scr[:, 0, :nblocks * block_size].reshape(
            r, nblocks, block_size, *scr.shape[3:])
        pool[:, ids] = blocks.to(pool.dtype)
    return pools
