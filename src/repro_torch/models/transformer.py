"""Schedule-driven model builder: the dense GQA llama of the paper.

Parameters are a flat dict keyed by the JAX tree's leaf paths, with the same
layouts: segment ``i``, pattern position ``j`` lives under
``segments/{i}/p{j}/...`` with a leading stacked axis of ``repeats`` layers,
e.g. ``segments/0/p0/attn/wq/kernel`` of shape ``(layers, d, hq * hd)``
applied as ``x @ w``. ``convert.params_from_jax`` carries a JAX parameter
tree across unchanged.

Ported: ``init_params``, ``cast_params`` and ``forward`` for
``family="dense"`` with the ``("attn",)`` block. Not yet ported: the other
block kinds and families (MoE, MLA, Mamba, RWKV, encoder-decoder, VLM),
sliding-window and sequence-parallel attention, and the serving entry points
(``prefill``, ``decode_step`` and the paged variants).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .layers import (
    apply_rope,
    blockwise_attention,
    dense_init,
    embed_init,
    rms_norm,
    rope_table,
    swiglu,
)


def _check_ported(cfg) -> None:
    kinds = cfg.block_kinds()
    if cfg.family != "dense" or kinds != ("attn",) or cfg.use_qk_norm \
            or cfg.qkv_bias or cfg.attn_sp:
        raise NotImplementedError(
            f"{cfg.name}: only dense ('attn',) models without qk-norm, qkv "
            f"bias or sequence-parallel attention are ported to repro_torch "
            f"(family={cfg.family!r}, blocks={kinds})")


def init_params(cfg, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """Full parameter dict from a ``torch.Generator`` seeded with ``seed``
    (its own stream: the values differ from ``repro``'s for the same seed)."""
    _check_ported(cfg)
    dev = torch.device(device or "cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    params = {"embed/kernel": embed_init(gen, cfg.vocab_size, d, dt,
                                         device=dev)}
    if not cfg.tie_embeddings:
        params["unembed/kernel"] = embed_init(gen, cfg.vocab_size, d, dt,
                                              device=dev)
    params["final_norm/scale"] = torch.zeros(d, dtype=torch.float32,
                                             device=dev)
    for i, (pattern, repeats) in enumerate(cfg.schedule):
        for j, _ in enumerate(pattern):
            pre = f"segments/{i}/p{j}/"
            L = (repeats,)

            def w(d_in, d_out):
                return dense_init(gen, d_in, d_out, dt, batch=L, device=dev)

            params.update({
                pre + "ln1/scale": torch.zeros((repeats, d), device=dev),
                pre + "attn/wq/kernel": w(d, hq * hd),
                pre + "attn/wk/kernel": w(d, hkv * hd),
                pre + "attn/wv/kernel": w(d, hkv * hd),
                pre + "attn/wo/kernel": w(hq * hd, d),
                pre + "ln2/scale": torch.zeros((repeats, d), device=dev),
                pre + "mlp/wg/kernel": w(d, f),
                pre + "mlp/wu/kernel": w(d, f),
                pre + "mlp/wd/kernel": w(f, d),
            })
    return params


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


def _attn_block(p: dict, x, cfg):
    """One ``attn`` block: pre-norm GQA self-attention + SwiGLU MLP."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1/scale"], cfg.norm_eps)
    q = (h @ p["attn/wq/kernel"]).reshape(b, s, hq, hd)
    k = (h @ p["attn/wk/kernel"]).reshape(b, s, hkv, hd)
    v = (h @ p["attn/wv/kernel"]).reshape(b, s, hkv, hd)
    cos, sin = rope_table(s, hd, cfg.rope_theta, device=x.device)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    a = blockwise_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    x = x + a.reshape(b, s, hq * hd) @ p["attn/wo/kernel"]
    h = rms_norm(x, p["ln2/scale"], cfg.norm_eps)
    return x + swiglu(h, p["mlp/wg/kernel"], p["mlp/wu/kernel"],
                      p["mlp/wd/kernel"])


def forward(params: dict, batch: dict, cfg):
    """batch: ``{'tokens': (B, S) int}``. Returns ``(logits, aux)`` with
    logits (B, S, vocab) in the compute dtype. ``cfg.remat`` recomputes each
    layer in the backward pass (``torch.utils.checkpoint``)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    cdt = getattr(torch, cfg.compute_dtype)
    p = cast_params(params, cfg)
    x = p["embed/kernel"][tokens]
    for i, (pattern, repeats) in enumerate(cfg.schedule):
        for j, _ in enumerate(pattern):
            pre = f"segments/{i}/p{j}/"
            # unbind once: its backward stacks the per-layer gradients in one
            # pass, where indexing the stack per layer would make autograd
            # build and add a full-stack gradient buffer for every layer
            stacked = {k[len(pre):]: v.unbind(0) for k, v in p.items()
                       if k.startswith(pre)}
            for layer in range(repeats):
                lp = {k: v[layer] for k, v in stacked.items()}
                if cfg.remat:
                    x = checkpoint(_attn_block, lp, x, cfg,
                                   use_reentrant=False)
                else:
                    x = _attn_block(lp, x, cfg)
                x = x.to(cdt)              # pin the residual-stream dtype
    x = rms_norm(x, p["final_norm/scale"], cfg.norm_eps)
    unemb = p["embed/kernel"] if cfg.tie_embeddings else p["unembed/kernel"]
    logits = x @ unemb.to(cdt).T
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device),
           "mtp_logits": None}
    return logits, aux
