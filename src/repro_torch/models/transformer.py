"""The schedule-driven transformer: the dense GQA models (the paper's
llamas, gemma3-27b, qwen2.5-32b, phi3-mini-3.8b, command-r-plus-104b), the
DeepSeek MoE family (deepseek-moe-16b, deepseek-v3-671b), the recurrent
families (jamba-1.5-large-398b, rwkv6-1.6b), the encoder-decoder
(whisper-large-v3) and the cross-attention VLM (llama-3.2-vision-90b).

Parameters are a flat dict keyed by the JAX tree's leaf paths, with the same
layouts: segment ``i``, pattern position ``j`` lives under
``segments/{i}/p{j}/...`` with a leading stacked axis of ``repeats`` layers,
e.g. ``segments/0/p0/attn/wq/kernel`` of shape ``(layers, d, hq * hd)``
applied as ``x @ w``; an encoder's under ``encoder/blocks/...`` (stacked
``(encoder_layers, ...)``) and ``encoder/ln_post/...``.
``convert.params_from_jax`` carries a JAX parameter tree across unchanged.

Every family (``PORTED_FAMILIES``) and block kind (``PORTED_KINDS``) of the
JAX package: ``attn`` and ``local`` (sliding window of
``cfg.sliding_window``), with optional qk-norm, optional qkv bias
(``attn/w{q,k,v}/bias``, added after each projection's product) and
``attn_sp`` (``layers.sp_blockwise_attention``: on a mesh with a
``model`` axis each rank attends its slice of the queries, plain
blockwise attention otherwise); ``attn_moe`` (GQA attention and the MoE FFN of
``models/moe.py``: its leaves under ``moe/``); ``mla_dense`` and ``mla_moe``
(DeepSeek's multi-head latent attention, ``MLA_KINDS``: the queries and the
keys / values through low-rank latents, a shared roped key part, a query /
key head dim of ``qk_nope_dim + qk_rope_dim`` beside a value head dim
``v_head_dim``) with a SwiGLU or the MoE FFN; the multi-token prediction
head (``cfg.mtp``: ``mtp/proj`` and ``mtp/norm``, whose logits predict the
token after next); the recurrent blocks of ``RECURRENT_KINDS``:
``mamba_dense`` and ``mamba_moe`` (RMS norm, the Mamba mixer of
``models/mamba.py``: its leaves under ``mamba/``, then a SwiGLU or the MoE
FFN) and ``rwkv`` (layer norm with a bias, RWKV-6's time mix, layer norm,
its channel mix: ``models/rwkv.py``, leaves under ``tm/`` and ``cm/``), each
a sequence mixer with a constant-size decode state; and the blocks of the
modality families: ``enc`` (whisper's encoder: layer norms with biases,
bidirectional attention and a GELU MLP, all with biases), ``dec`` (its
decoder: causal roped self-attention, cross-attention (``xattn/``) over the
encoder's output, the GELU MLP) and ``cross`` (llama-3.2-vision's gated
cross-attention over the image embeddings and a SwiGLU, each scaled by the
tanh of an fp32 gate). The audio and vision frontends are stubs, as in the
JAX package: the batch carries precomputed ``frames`` and
``image_embeds``. The entry points: ``init_params``, ``param_count``,
``cast_params``, the per-block API (``ATTN_KINDS``, ``MLA_KINDS``,
``MOE_KINDS``, ``init_block``, ``block_apply``: the one place a block's
math lives; ``encode``, the encoder) and ``forward`` (training, and the
dense prefill, whose no-grad attention is a kernel on the card, at the
encoder's and the cross-attentions' keys too); the dense decode path
(``init_cache``, ``prefill``, ``decode_step``; a ``local`` layer keeps a
ring of its last ``window`` positions, a ``dec`` / ``cross`` layer the
keys and values of its cross-attention, an MLA layer its latent and roped
key part, decoded in the absorbed form, a Mamba layer its conv tail and
SSM state, an RWKV layer its last tokens and WKV state); the paged serving
path (``init_paged_pools``, ``init_prefill_scratch``, ``prefill_chunk``,
``write_prefill_to_pools``, ``decode_step_paged``; ``PAGED_KINDS``: not
MLA, no recurrent block and no encoder-decoder or cross-attention, as in
the JAX package), whose attention is the ``flash_decode`` kernel. The MoE
blocks sum their load-balance losses into ``aux["moe_aux"]``.

On an active mesh (``parallel.sharding.set_mesh``) the two mesh bodies of
the reference run over ``model``: ``attn_sp`` attention as query slices
(``layers.sp_blockwise_attention``) and the MoE FFN expert-parallel
(``moe.moe_ffn``, which also routes the whole batch as one where the batch
is cut over the data axes without a ``model`` axis). Everything else runs
whole on every rank, from parameters the train step gathers whole; the
per-layer weight gathers and Megatron column / row compute that GSPMD
derives from the reference's placements are not ported (ROADMAP 6d).

As in the JAX package, an fp32 leaf beside bf16 activations widens what
follows it: whisper's fp32 biases make its attention and MLPs run in fp32
under bf16 compute, and the fp32 gates of a ``cross`` block make its output
fp32 (``_gated``: torch would keep bf16 beside a 0-d tensor). The
residual stream is pinned to the compute dtype after every block.

Caches and pools are flat dicts too, keyed like the JAX trees:
``segments/{i}/p{j}/k`` and ``.../v``, a ``dec`` layer's also ``.../xk``
and ``.../xv`` (R, B, encoder_seq, Hkv, hd), a ``cross`` layer's ``xk`` and
``xv`` (R, B, n_image_tokens, Hkv, hd) alone, or an MLA layer's
``segments/{i}/p{j}/ckv`` (R, B, S, kv_lora_rank) and ``.../krope`` (R, B,
S, qk_rope_dim); a Mamba layer's ``conv`` (R, B, K-1, d_inner) and ``ssm``
(R, B, d_inner, state) fp32; an RWKV layer's ``x_prev_tm`` and ``x_prev_cm``
(R, B, d) and ``wkv`` (R, B, H, K, V) fp32. Unlike the JAX package, whose
arrays are immutable, the serving entry points write into them in place and
return them.
"""
from __future__ import annotations

import contextvars
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.devices import resolve_device
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding

from .layers import (
    NEG_INF,
    apply_rope,
    blockwise_attention,
    chunk_attention,
    decode_attention,
    dense_init,
    embed_init,
    gelu_mlp,
    layer_norm,
    matmul,
    rms_norm,
    rope_at,
    rope_table,
    rope_tables_at,
    sp_blockwise_attention,
    swiglu,
)
from .mamba import init_mamba, mamba_mix, mamba_step
from .moe import init_moe, moe_ffn
from .rwkv import (channel_mix, channel_mix_step, init_rwkv, time_mix,
                   time_mix_step)

#: the reference's attention block kinds
ATTN_KINDS = ("attn", "local", "attn_moe", "enc", "dec", "cross")
MLA_KINDS = ("mla_dense", "mla_moe")
MOE_KINDS = ("attn_moe", "mla_moe", "mamba_moe")
MAMBA_KINDS = ("mamba_dense", "mamba_moe")
#: the sequence mixers with a constant-size decode state
RECURRENT_KINDS = (*MAMBA_KINDS, "rwkv")
#: the block kinds and model families this package builds: all of the
#: reference's
PORTED_KINDS = (*ATTN_KINDS, *MLA_KINDS, *RECURRENT_KINDS)
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")
#: the kinds whose norms are layer norms with a bias (scale ones, bias
#: zeros), not RMS norms
LAYER_NORM_KINDS = ("rwkv", "enc", "dec")


def _check_ported(cfg) -> None:
    kinds = cfg.block_kinds()
    if cfg.family not in PORTED_FAMILIES \
            or not set(kinds) <= set(PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: only {PORTED_FAMILIES} models of {PORTED_KINDS} "
            f"blocks are ported to repro_torch (family={cfg.family!r}, "
            f"blocks={kinds})")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r} (the kinds: "
                         f"{PORTED_KINDS})")


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
    params.update(_norm_leaves("final_norm", d, (), dev,
                               bias=cfg.family == "encdec"))
    for i, (pattern, repeats) in enumerate(cfg.schedule):
        for j, kind in enumerate(pattern):
            block = _block_leaves(gen, kind, cfg, (repeats,), dev)
            params.update({f"segments/{i}/p{j}/{k}": v
                           for k, v in block.items()})
    if cfg.encoder_layers:
        block = _block_leaves(gen, "enc", cfg, (cfg.encoder_layers,), dev)
        params.update({f"encoder/blocks/{k}": v for k, v in block.items()})
        params.update(_norm_leaves("encoder/ln_post", d, (), dev, bias=True))
    if cfg.mtp:
        params["mtp/norm/scale"] = torch.zeros(d, dtype=torch.float32,
                                               device=dev)
        params["mtp/proj/kernel"] = dense_init(
            gen, 2 * d, d, getattr(torch, cfg.param_dtype), device=dev)
    return params


def _norm_leaves(name: str, d: int, batch: tuple, dev, *,
                 bias: bool) -> dict[str, torch.Tensor]:
    """A norm's fp32 leaves: an RMS norm's ``scale`` of zeros (its gain is
    ``1 + scale``), or a layer norm's ``scale`` of ones and ``bias`` of
    zeros."""
    if not bias:
        return {f"{name}/scale": torch.zeros((*batch, d), dtype=torch.float32,
                                             device=dev)}
    return {f"{name}/scale": torch.ones((*batch, d), dtype=torch.float32,
                                        device=dev),
            f"{name}/bias": torch.zeros((*batch, d), dtype=torch.float32,
                                        device=dev)}


def _block_leaves(gen, kind: str, cfg, batch: tuple,
                  dev) -> dict[str, torch.Tensor]:
    """One block's leaves with leading ``batch`` axes (the stacked layers
    of a schedule position, or none), the weights drawn from ``gen`` in a
    fixed order: the mixers' (GQA: wq, wk, wv, wo, a ``dec`` block's self-
    then its cross-attention; MLA: wq_a, wq_b, wkv_a, wkv_b, wo;
    ``mamba.init_mamba``'s; ``rwkv.init_rwkv``'s), then the FFN's (wg, wu,
    wd; the GELU MLP's wi, wo; or ``moe.init_moe``'s). The norms of
    ``LAYER_NORM_KINDS`` are layer norms with a bias. An ``enc`` / ``dec``
    block's attention and MLP carry biases in the parameter dtype (the
    reference's zeros); a ``cross`` block's attention lives under
    ``xattn/``, and its two gates are fp32 zeros of the stacked shape."""
    dt = getattr(torch, cfg.param_dtype)
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)

    def w(d_in, d_out):
        return dense_init(gen, d_in, d_out, dt, batch=batch, device=dev)

    def zeros(width, dtype=torch.float32):
        return torch.zeros((*batch, width), dtype=dtype, device=dev)

    def norm(name):
        return _norm_leaves(name, d, batch, dev,
                            bias=kind in LAYER_NORM_KINDS)

    def gqa(pre, bias=False):
        """The reference's ``_init_gqa``: (the four kernels, the rest: with
        ``bias`` or the config's qkv bias the q / k / v biases, with
        ``bias`` wo's too; the qk-norm scales)."""
        kernels = {f"{pre}w{n}/kernel": w(*shape) for n, shape in (
            ("q", (d, hq * hd)), ("k", (d, hkv * hd)), ("v", (d, hkv * hd)),
            ("o", (hq * hd, d)))}
        rest = {}
        if bias or cfg.qkv_bias:
            for n, width in (("q", hq * hd), ("k", hkv * hd),
                             ("v", hkv * hd)):
                rest[f"{pre}w{n}/bias"] = zeros(width, dt)
        if bias:
            rest[f"{pre}wo/bias"] = zeros(d, dt)
        if cfg.use_qk_norm:
            for n in ("q", "k"):
                rest[f"{pre}{n}_norm_scale"] = zeros(hd)
        return kernels, rest

    if kind == "rwkv":
        p = init_rwkv(gen, cfg, batch=batch, device=dev)
        return {**p, **norm("ln1"), **norm("ln2")}
    if kind in ("enc", "dec"):
        p = norm("ln1")
        for pre, ln in (("attn/", "ln2"), ("xattn/", "ln3"))[
                :2 if kind == "dec" else 1]:
            kernels, rest = gqa(pre, bias=True)
            p.update({**kernels, **rest, **norm(ln)})
        p.update({"mlp/wi/kernel": w(d, f), "mlp/wi/bias": zeros(f, dt),
                  "mlp/wo/kernel": w(f, d), "mlp/wo/bias": zeros(d, dt)})
        return p
    p, rest = norm("ln1"), {}
    if kind in MAMBA_KINDS:
        p.update({f"mamba/{k}": v for k, v in init_mamba(
            gen, cfg, batch=batch, device=dev).items()})
    elif kind in MLA_KINDS:
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        kvr = cfg.kv_lora_rank
        p.update({
            "attn/wq_a/kernel": w(d, cfg.q_lora_rank),
            "attn/q_norm_scale": zeros(cfg.q_lora_rank),
            "attn/wq_b/kernel": w(cfg.q_lora_rank, hq * qk),
            "attn/wkv_a/kernel": w(d, kvr + cfg.qk_rope_dim),
            "attn/kv_norm_scale": zeros(kvr),
            "attn/wkv_b/kernel": w(kvr, hq * (cfg.qk_nope_dim
                                              + cfg.v_head_dim)),
            "attn/wo/kernel": w(hq * cfg.v_head_dim, d),
        })
    elif kind == "cross":
        kernels, rest = gqa("xattn/")
        p.update(kernels)
        p["gate_attn"] = torch.zeros(batch, dtype=torch.float32, device=dev)
    else:
        kernels, rest = gqa("attn/")
        p.update(kernels)
    p.update(norm("ln2"))
    if kind in MOE_KINDS:
        p.update({f"moe/{k}": v for k, v in init_moe(
            gen, cfg, batch=batch, device=dev).items()})
    else:
        p.update({"mlp/wg/kernel": w(d, f), "mlp/wu/kernel": w(d, f),
                  "mlp/wd/kernel": w(f, d)})
    if kind == "cross":
        p["gate_mlp"] = torch.zeros(batch, dtype=torch.float32, device=dev)
    return {**p, **rest}


def init_block(gen, kind: str, cfg, device=None) -> dict[str, torch.Tensor]:
    """One block's leaves, keyed as a layer's parameters under its
    ``segments/{i}/p{j}/`` prefix (``attn/wq/kernel`` of (d, hq * hd), no
    stacked axis), drawn from the ``torch.Generator`` ``gen`` (the JAX
    package's ``init_block`` takes a key; the streams differ). ``device``:
    the generator's by default; ``"meta"`` (with ``gen=None``) gives shapes
    only."""
    _check_kind(kind)
    return _block_leaves(gen, kind, cfg, (),
                         torch.device(device) if device is not None
                         else gen.device)


def param_count(params: dict) -> int:
    """Elements over every leaf; a ``device="meta"`` dict counts too (a
    full configuration without allocating it)."""
    return sum(p.numel() for p in params.values())


_PRECISION_CRITICAL = ("norm", "ln", "scale", "bias", "a_log", "d_skip",
                       "decay", "bonus", "gate", "mu_")


def cast_dtype(path: str, p: torch.Tensor, cfg) -> torch.dtype:
    """The dtype a leaf is used in: the compute dtype for a floating
    weight, its stored dtype for the small precision-critical leaves (norm
    scales, biases, gates, ...) and integer leaves."""
    if any(h in path.lower() for h in _PRECISION_CRITICAL) \
            or not p.is_floating_point():
        return p.dtype
    return getattr(torch, cfg.compute_dtype)


def cast_params(params: dict, cfg) -> dict:
    """Mixed precision: weights cast to the compute dtype at use; small
    precision-critical leaves (norm scales) stay in their stored dtype."""
    return {path: p.to(cast_dtype(path, p, cfg)) for path, p in params.items()}


def _qk_norm(p: dict, q, k, cfg, pre: str = "attn/"):
    """qk-norm (an RMS norm over the head dim, eps 1e-6, as the JAX
    package's ``_qk_norm``) where the config has it; before the rope."""
    if not cfg.use_qk_norm:
        return q, k
    return (rms_norm(q, p[f"{pre}q_norm_scale"]),
            rms_norm(k, p[f"{pre}k_norm_scale"]))


def _proj(p: dict, h, n: str, pre: str = "attn/"):
    """``h @ {pre}w{n}/kernel``, then its bias where the block has one: a
    separate add after the product, as the JAX package's (one rounding
    more than a fused ``addmm`` in bf16). A bias kept in fp32 beside bf16
    products widens the result to fp32, as JAX's promotion does, and the
    products after it promote in ``matmul``."""
    y = matmul(h, p[f"{pre}w{n}/kernel"])
    bias = p.get(f"{pre}w{n}/bias")
    return y if bias is None else y + bias


def _sub(p: dict, prefix: str) -> dict:
    """The leaves of ``p`` under ``prefix``, keyed without it."""
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def _gqa_apply(p: dict, h, cfg, *, pre: str = "attn/", causal: bool = True,
               window: int | None = None, kv_src=None, rope: bool = True):
    """GQA attention of a block on normed h (B, S, d), its leaves under
    ``pre``: self-attention, or with ``kv_src`` (B, Skv, d) a
    cross-attention whose keys and values are projected from it (no rope
    on them, as the JAX package's). Returns (the output projected by wo,
    with wo's bias where the block has one; the (roped) (k, v))."""
    tp = C.megatron_axis(p, pre)
    if tp is not None:
        p, h, kv_src, heads = _megatron_heads(p, h, cfg, pre, kv_src, tp)
    b, s, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if tp is not None:
        hq, hkv = heads
    src = h if kv_src is None else kv_src
    q = _proj(p, h, "q", pre).reshape(b, s, hq, hd)
    k = _proj(p, src, "k", pre).reshape(b, src.shape[1], hkv, hd)
    v = _proj(p, src, "v", pre).reshape(b, src.shape[1], hkv, hd)
    q, k = _qk_norm(p, q, k, cfg, pre)
    if rope and kv_src is None:
        cos, sin = rope_table(s, hd, cfg.rope_theta, device=h.device)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    attend = sp_blockwise_attention if cfg.attn_sp else blockwise_attention
    a = attend(q, k, v, causal=causal, window=window, q_chunk=cfg.q_chunk,
               kv_chunk=cfg.kv_chunk)
    if tp is None:
        return _out(p, a.reshape(b, s, hq * hd), pre), (k, v)
    y = C.all_reduce(matmul(a.reshape(b, s, hq * hd), p[f"{pre}wo/kernel"]),
                     (tp,))
    bias = p.get(f"{pre}wo/bias")
    return (y if bias is None else y + bias), (k, v)


def _megatron_heads(p: dict, h, cfg, pre: str, kv_src, tp: str):
    """A GQA site's leaves as Megatron hands them (``Held.use``: ``wq`` /
    ``wo`` this rank's column / row blocks of its ``hq/tp`` query heads;
    ``wk`` / ``wv`` column blocks of its ``hkv/tp`` kv heads where hkv
    divides, else whole) made this rank's heads: the q / k / v biases cut
    to them, whole ``wk`` / ``wv`` cut to the kv heads the rank's query
    heads read, and every leaf or input that this rank uses for a part of
    the heads entered through ``collectives.replicated`` (its gradient
    summed over ``tp``: the inputs, the qk-norm scales, whole ``wk`` /
    ``wv``). Returns (the leaves, h, kv_src, (query heads, kv heads))."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    group = hq // hkv
    q0, q1 = C.block_range(hq, tp)
    p = dict(p)
    h = C.replicated(h, (tp,))
    kv_src = None if kv_src is None else C.replicated(kv_src, (tp,))
    if f"{pre}wq/bias" in p:
        p[f"{pre}wq/bias"] = C.cut(p[f"{pre}wq/bias"], -1, (tp,))
    for n in ("q", "k"):
        if f"{pre}{n}_norm_scale" in p:
            p[f"{pre}{n}_norm_scale"] = C.replicated(
                p[f"{pre}{n}_norm_scale"], (tp,))
    if p[f"{pre}wk/kernel"].shape[-1] != hkv * hd:
        # kv heads cut with the query heads: whole groups on the rank
        for n in ("k", "v"):
            if f"{pre}w{n}/bias" in p:
                p[f"{pre}w{n}/bias"] = C.cut(p[f"{pre}w{n}/bias"], -1,
                                             (tp,))
        return p, h, kv_src, (q1 - q0, hkv * (q1 - q0) // hq)
    # kv gathered whole: the kv heads this rank's query heads read (whole
    # groups, or one kv head: ``megatron_sites``)
    k0, k1 = q0 // group, (q1 - 1) // group + 1
    for n in ("k", "v"):
        for leaf in (f"{pre}w{n}/kernel", f"{pre}w{n}/bias"):
            if leaf in p:
                p[leaf] = C.replicated(p[leaf], (tp,))[
                    ..., k0 * hd:k1 * hd]
    return p, h, kv_src, (q1 - q0, k1 - k0)


def _out(p: dict, a, pre: str = "attn/"):
    """The attention output projection ``a @ {pre}wo/kernel`` and its
    bias where the block has one."""
    y = matmul(a, p[f"{pre}wo/kernel"])
    bias = p.get(f"{pre}wo/bias")
    return y if bias is None else y + bias


def _gated(x, gate, y):
    """``x + tanh(gate) * y`` with JAX's promotion: the fp32 0-d gate
    widens bf16 ``x`` and ``y`` to fp32, where torch would treat a 0-d
    tensor as a scalar and keep bf16."""
    dt = torch.promote_types(torch.promote_types(x.dtype, y.dtype),
                             gate.dtype)
    return x.to(dt) + torch.tanh(gate).to(dt) * y.to(dt)


def _mla_apply(p: dict, h, cfg):
    """DeepSeek MLA in the non-absorbed (train / prefill) form on normed h
    (B, S, d): q through the ``q_lora_rank`` latent (RMS-normed), k and v
    through the ``kv_lora_rank`` latent c_kv (RMS-normed), a roped key part
    of ``qk_rope_dim`` shared by every head; attention of query / key head
    dim ``qk_nope_dim + qk_rope_dim`` over values of ``v_head_dim``.
    Returns (the output projected by wo, (c_kv (B, S, kv_lora_rank), the
    roped shared key part (B, S, qk_rope_dim))): the decode cache holds
    the latent, not K / V."""
    b, s, _ = h.shape
    heads = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    cq = rms_norm(matmul(h, p["attn/wq_a/kernel"]), p["attn/q_norm_scale"])
    q = matmul(cq, p["attn/wq_b/kernel"]).reshape(b, s, heads, nope + rope_d)
    ckv = matmul(h, p["attn/wkv_a/kernel"])
    c_kv = rms_norm(ckv[..., :kvr], p["attn/kv_norm_scale"])
    kv = matmul(c_kv, p["attn/wkv_b/kernel"]).reshape(b, s, heads, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    cos, sin = rope_table(s, rope_d, cfg.rope_theta, device=h.device)
    q_rope = apply_rope(q[..., nope:], cos, sin)
    k_rope = apply_rope(ckv[..., kvr:][:, :, None, :], cos, sin)  # (B,S,1,r)
    k = torch.cat([k_nope, k_rope.expand(b, s, heads, rope_d)], dim=-1)
    q = torch.cat([q[..., :nope], q_rope], dim=-1)
    attend = sp_blockwise_attention if cfg.attn_sp else blockwise_attention
    a = attend(q, k, v, causal=True, q_chunk=cfg.q_chunk,
               kv_chunk=cfg.kv_chunk)
    y = matmul(a.reshape(b, s, heads * vd), p["attn/wo/kernel"])
    return y, (c_kv, k_rope[:, :, 0, :])


def _mlp(kind: str, p: dict, h, cfg):
    """The FFN half of a block on normed h (..., d): the SwiGLU, or the MoE
    FFN for ``MOE_KINDS`` (h of (B, d), one token a row as in decode, is
    routed as the (B, 1, d) batch). Returns (out, the MoE's weighted
    load-balance loss, or None)."""
    if kind in MOE_KINDS:
        moe = _sub(p, "moe/")
        if h.dim() == 2:
            m, aux = moe_ffn(moe, h[:, None, :], cfg)
            return m[:, 0], aux
        return moe_ffn(moe, h, cfg)
    return swiglu(h, p["mlp/wg/kernel"], p["mlp/wu/kernel"],
                  p["mlp/wd/kernel"], C.megatron_axis(p, "mlp/")), None


def _rwkv_apply(p: dict, x, cfg):
    """An ``rwkv`` block on x (B, S, d) from a zero state: layer norm, the
    time mix (from a zero previous token and WKV state), layer norm, the
    channel mix, each added to the residual. Returns (x, its decode cache
    entry: the last normed tokens of each mix and the WKV state)."""
    b, _, d = x.shape
    hh, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    h = layer_norm(x, p["ln1/scale"], p["ln1/bias"], cfg.norm_eps)
    st0 = torch.zeros((b, hh, hs, hs), dtype=torch.float32, device=x.device)
    tm_out, last_x, st = time_mix(_sub(p, "tm/"), h, h.new_zeros((b, d)),
                                  st0, cfg)
    x = x + tm_out
    h2 = layer_norm(x, p["ln2/scale"], p["ln2/bias"], cfg.norm_eps)
    cm_out, last_cm = channel_mix(_sub(p, "cm/"), h2, h2.new_zeros((b, d)))
    return x + cm_out, {"x_prev_tm": last_x, "x_prev_cm": last_cm,
                        "wkv": st}


def _encdec_apply(kind: str, p: dict, x, cfg, ctx):
    """An ``enc`` block (layer norm, bidirectional self-attention with
    biases and no rope, layer norm, the GELU MLP), a ``dec`` block (layer
    norm, causal roped self-attention, layer norm, cross-attention over
    ``ctx["enc_out"]``, layer norm, the GELU MLP) or a ``cross`` block (RMS
    norm, cross-attention over ``ctx["image_embeds"]`` scaled by
    ``tanh(gate_attn)``, RMS norm, the SwiGLU scaled by ``tanh(gate_mlp)``),
    each added to the residual. Returns (x, the cache entry: ``dec``'s
    ``((k, v), (xk, xv))``, ``cross``'s ``(xk, xv)``, ``enc``'s None)."""
    eps = cfg.norm_eps
    if kind == "cross":
        h = rms_norm(x, p["ln1/scale"], eps)
        a, kv = _gqa_apply(p, h, cfg, pre="xattn/", causal=False,
                           kv_src=ctx["image_embeds"], rope=False)
        x = _gated(x, p["gate_attn"], a)
        h = rms_norm(x, p["ln2/scale"], eps)
        return _gated(x, p["gate_mlp"], _mlp(kind, p, h, cfg)[0]), kv
    h = layer_norm(x, p["ln1/scale"], p["ln1/bias"], eps)
    a, kv = _gqa_apply(p, h, cfg, causal=kind == "dec", rope=kind == "dec")
    x = x + a
    ln = "ln2"
    if kind == "dec":
        h = layer_norm(x, p["ln2/scale"], p["ln2/bias"], eps)
        a, xkv = _gqa_apply(p, h, cfg, pre="xattn/", causal=False,
                            kv_src=ctx["enc_out"], rope=False)
        x, kv, ln = x + a, (kv, xkv), "ln3"
    h = layer_norm(x, p[f"{ln}/scale"], p[f"{ln}/bias"], eps)
    x = x + gelu_mlp(h, p["mlp/wi/kernel"], p["mlp/wi/bias"],
                     p["mlp/wo/kernel"], p["mlp/wo/bias"],
                     C.megatron_axis(p, "mlp/"))
    return x, (kv if kind == "dec" else None)


def block_apply(kind: str, p: dict, x, cfg, ctx=None, *,
                return_kv: bool = False):
    """One block of the schedule on ``x`` (B, S, d): a pre-norm sequence
    mixer (causal GQA self-attention, a sliding window for ``local``; MLA
    for ``MLA_KINDS``; the Mamba mixer for ``MAMBA_KINDS``) and an FFN (a
    SwiGLU; the MoE for ``MOE_KINDS``), each added to the residual; an
    ``rwkv`` block (``_rwkv_apply``); or an ``enc``, ``dec`` or ``cross``
    block (``_encdec_apply``). ``p``: the block's leaves (one layer's,
    keyed as ``init_block``'s); ``ctx``: the cross-attention inputs
    (``{"enc_out"}`` for ``dec``, ``{"image_embeds"}`` for ``cross``; the
    other kinds read none). Returns ``(x, aux, kv)``: ``aux`` the block's
    auxiliary loss (a 0-d fp32 tensor: the MoE's load-balance loss, else
    zero), ``kv`` with ``return_kv`` the block's cache entry (GQA: the
    roped ``(k, v)``; ``dec``: ``((k, v), (xk, xv))``; ``cross``: ``(xk,
    xv)``; MLA: ``(c_kv, k_rope)``; Mamba: ``{"conv", "ssm"}``; RWKV:
    ``{"x_prev_tm", "x_prev_cm", "wkv"}``), else None. As in the JAX
    package, an fp32 bias or gate beside bf16 activations widens the
    block's output to fp32; the caller pins the residual stream."""
    _check_kind(kind)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        x, kv = _rwkv_apply(p, x, cfg)
        return x, zero, (kv if return_kv else None)
    if kind in ("enc", "dec", "cross"):
        x, kv = _encdec_apply(kind, p, x, cfg, ctx)
        return x, zero, (kv if return_kv else None)
    h = rms_norm(x, p["ln1/scale"], cfg.norm_eps)
    if kind in MAMBA_KINDS:
        a = mamba_mix(_sub(p, "mamba/"), h, cfg, return_state=return_kv)
        a, kv = a if return_kv else (a, None)
    elif kind in MLA_KINDS:
        a, kv = _mla_apply(p, h, cfg)
    else:
        a, kv = _gqa_apply(p, h, cfg, window=_window(kind, cfg))
    x = x + a
    h = rms_norm(x, p["ln2/scale"], cfg.norm_eps)
    m, aux = _mlp(kind, p, h, cfg)
    x = x + m
    return x, (zero if aux is None else aux), (kv if return_kv else None)


def _unstacked(p: dict, pre: str, repeats: int):
    """Yield each of ``repeats`` stacked layers' parameter views under
    ``pre``, keyed without it. One ``unbind`` per stacked leaf: its
    backward stacks the per-layer gradients in one pass, where indexing the
    stack per layer would make autograd build and add a full-stack gradient
    buffer for every layer."""
    stacked = {k[len(pre):]: v.unbind(0) for k, v in p.items()
               if k.startswith(pre)}
    for layer in range(repeats):
        yield {k: v[layer] for k, v in stacked.items()}


def _layers(p: dict, cfg):
    """Yield ``(segment prefix, block kind, layer index, that layer's
    parameter views)`` in schedule order: each segment's pattern once per
    repeat, its positions in turn (the reference's scan over the repeats
    of a segment, whose body applies ``p0``, ``p1``, ...)."""
    for i, (pattern, repeats) in enumerate(cfg.schedule):
        pres = [f"segments/{i}/p{j}/" for j in range(len(pattern))]
        views = [list(_unstacked(p, pre, repeats)) for pre in pres]
        for layer in range(repeats):
            for pre, kind, lps in zip(pres, pattern, views):
                yield pre, kind, layer, lps[layer]


def _remat(fn, cfg, *args):
    """``fn(*args)``, recomputed in the backward pass under ``cfg.remat``
    (``torch.utils.checkpoint``) when the call takes a gradient. The
    recomputation runs in the forward's context variables (the active mesh,
    policy and batch cut of ``parallel.sharding``): the backward of CUDA
    tensors runs on autograd's device thread, which has its own."""
    if cfg.remat and torch.is_grad_enabled():
        ctx = contextvars.copy_context()
        return checkpoint(lambda *a: ctx.run(fn, *a), *args,
                          use_reentrant=False)
    return fn(*args)


def _sinusoid(seq: int, d: int, dtype, device):
    """Whisper's sinusoidal position table (seq, d), computed in fp32 and
    cast to ``dtype`` (the JAX package's ``_sinusoid``; its divisor a
    tensor, since a division by a Python number on the card is a multiply
    by its reciprocal)."""
    half = d // 2
    steps = torch.arange(half, dtype=torch.float32, device=device)
    freqs = torch.exp(-math.log(10000.0) * steps / torch.tensor(
        float(half - 1), device=device))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _as_is(leaves: dict, prefix: str = "", tag=None,
           tp_sites=None) -> dict:
    """The use of whole parameters: cast once by ``forward`` already."""
    return leaves


def megatron_sites(kind: str, cfg) -> dict:
    """What a block of ``kind`` declares to a use site for Megatron's
    column / row compute on the active mesh's ``model`` axis (the
    reference's ``shard(q, "batch", None, "tp", None)`` and
    ``_shard_hidden``): ``{group: {leaf: "col" | "row"}}`` for each group
    whose products split by head or by hidden unit, or ``{group: reason}``
    where the reference computes it otherwise (its attention under
    ``attn_sp`` cuts the queries by sequence; query heads that do not
    divide over ``model``, or a rank's query heads that read parts of kv
    groups). The GQA groups (``attn/``, ``xattn/``) declare wk / wv column
    leaves only where the kv heads divide too (else they come whole and
    each rank picks the kv heads its query heads read); the
    FFN groups: the SwiGLU (``mlp/``), the GELU MLP, the MoE's shared
    experts. MLA's latents, Mamba's and RWKV's mixes, the experts and the
    embedding / head declare nothing: they keep the gather route. {}
    without a ``model`` axis of more than one rank."""
    mesh = sharding.active_mesh()
    tp = sharding.tp_axis(mesh)
    if tp is None or mesh.shape[tp] == 1:
        return {}
    n = mesh.shape[tp]
    out = {}
    attn = {"enc": ("attn/",), "dec": ("attn/", "xattn/"),
            "cross": ("xattn/",)}.get(
        kind, ("attn/",) if kind in ("attn", "local", "attn_moe") else ())
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    for pre in attn:
        if cfg.attn_sp:
            out[pre] = "attn_sp: the reference cuts the queries by sequence"
        elif hq % n:
            out[pre] = f"{hq} query heads do not split over {n} ranks"
        elif hkv % n and (hq // n) % (hq // hkv) and (hq // hkv) % (hq // n):
            out[pre] = (f"a rank's {hq // n} query heads read parts of "
                        f"groups of {hq // hkv}")
        else:
            roles = {"wq/kernel": "col", "wo/kernel": "row"}
            if cfg.n_kv_heads % n == 0:
                roles.update({"wk/kernel": "col", "wv/kernel": "col"})
            out[pre] = roles
    if kind in ("enc", "dec"):
        out["mlp/"] = {"wi/kernel": "col", "wo/kernel": "row"}
    elif kind in MOE_KINDS:
        if cfg.n_shared_experts:
            out["moe/shared/"] = {"wg": "col", "wu": "col", "wd": "row"}
    elif kind != "rwkv":
        out["mlp/"] = {"wg/kernel": "col", "wu/kernel": "col",
                       "wd/kernel": "row"}
    return out


def _block(kind, lp, x, cfg, ctx, use, pre, layer):
    """``block_apply`` on a layer's weights as ``use`` hands them: the
    whole ones as they are, or (blocks) gathered here, inside the function
    ``_remat`` recomputes (the Megatron groups of ``megatron_sites`` as
    this rank's blocks)."""
    return block_apply(kind, use(lp, pre, f"{pre}{layer}",
                                 megatron_sites(kind, cfg)), x, cfg, ctx)


def encode(params: dict, frames, cfg, use=_as_is):
    """Whisper's encoder over ``frames`` (B, encoder_seq, d): the
    precomputed frame embeddings of the audio frontend's stub, cast to the
    compute dtype, plus the sinusoid; the ``cfg.encoder_layers`` ``enc``
    blocks of ``encoder/blocks/`` (the residual pinned to the compute
    dtype after each, each recomputed in the backward pass under
    ``cfg.remat``); then the layer norm ``encoder/ln_post``. ``params``:
    the parameter dict (``forward`` passes it cast), or with ``use`` a
    train step's blocks, each layer's weights gathered as it runs (as in
    ``forward``). Returns (B, encoder_seq, d) in the norm's output dtype,
    the compute dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = frames.to(cdt)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    pre = "encoder/blocks/"
    for layer, lp in enumerate(_unstacked(params, pre, cfg.encoder_layers)):
        x = _remat(_block, cfg, "enc", lp, x, cfg, {}, use, pre,
                   layer)[0].to(cdt)
    ln = use({k: params[k] for k in ("encoder/ln_post/scale",
                                     "encoder/ln_post/bias")},
             tag="ln_post")
    return layer_norm(x, ln["encoder/ln_post/scale"],
                      ln["encoder/ln_post/bias"], cfg.norm_eps)


def _final_norm(x, p: dict, cfg):
    """The final norm: a layer norm with a bias for ``encdec``, else an RMS
    norm."""
    if cfg.family == "encdec":
        return layer_norm(x, p["final_norm/scale"], p["final_norm/bias"],
                          cfg.norm_eps)
    return rms_norm(x, p["final_norm/scale"], cfg.norm_eps)


def forward(params: dict, batch: dict, cfg, *, return_cache: bool = False,
            use=None):
    """batch: ``{'tokens': (B, S) int}``, with ``'frames'`` (B,
    encoder_seq, d) for an encoder-decoder (``encode``'s input) and
    ``'image_embeds'`` (B, n_image_tokens, d) for a VLM (cast to the
    compute dtype): the modality frontends' stubs. Returns ``(logits,
    aux)`` with logits (B, S, vocab) in the compute dtype or, with
    ``return_cache``, ``(logits, aux, kv)``: ``kv[segment prefix]`` the
    per-layer cache entries (``block_apply``'s: GQA's roped ``(k, v)``,
    each (B, S, Hkv, hd); MLA's ``(c_kv, k_rope)``). ``aux``:
    ``{"moe_aux": the blocks' load-balance losses summed, "mtp_logits":
    None}``; with ``cfg.mtp``, ``mtp_logits`` (B, S, vocab) of the
    multi-token prediction head, which predicts the token after next from
    the final hidden state and the next token's embedding (the last
    position wraps around: the loss masks it; inference, ``return_cache``,
    skips the head). ``cfg.remat`` recomputes each layer in the backward
    pass (``torch.utils.checkpoint``); it is off with ``return_cache``.

    ``params``: the whole parameters (decode, prefill, one process: cast
    to the compute dtype once here), or, with ``use``, a train step's
    blocks under a mesh. ``use(leaves, prefix, tag)`` hands a use site its
    whole weights in the compute dtype (``parallel.fsdp.Held.use``
    gathers them when the site runs): the embedding first,
    each layer inside the function ``cfg.remat`` recomputes, the final
    norm, the unembedding and the MTP head at the end; the embedding's
    whole lives on only where a tied unembedding or the MTP head reads it
    again."""
    _check_ported(cfg)
    if use is not None and return_cache:
        raise ValueError("forward: return_cache takes whole parameters")
    tokens = batch["tokens"]
    cdt = getattr(torch, cfg.compute_dtype)
    p, use = (params, use) if use is not None \
        else (cast_params(params, cfg), _as_is)
    mtp = cfg.mtp and "mtp/proj/kernel" in p and not return_cache
    emb = use({"embed/kernel": p["embed/kernel"]},
              tag="embed")["embed/kernel"]
    x = emb[tokens]
    if not (cfg.tie_embeddings or mtp):
        del emb
    ctx = {}
    if cfg.encoder_layers:
        ctx["enc_out"] = encode(p, batch["frames"], cfg, use)
    if cfg.n_image_tokens:
        ctx["image_embeds"] = batch["image_embeds"].to(cdt)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kv: dict[str, list] = {}
    for pre, kind, layer, lp in _layers(p, cfg):
        if return_cache:
            x, a, pair = block_apply(kind, lp, x, cfg, ctx, return_kv=True)
            kv.setdefault(pre, []).append(pair)
        else:
            x, a, _ = _remat(_block, cfg, kind, lp, x, cfg, ctx, use, pre,
                             layer)
        x = x.to(cdt)                      # pin the residual-stream dtype
        aux_total = aux_total + a
    names = [k for k in p if k.startswith("final_norm/")]
    if not cfg.tie_embeddings:
        names.append("unembed/kernel")
    if mtp:
        names += ["mtp/proj/kernel", "mtp/norm/scale"]
    head = use({k: p[k] for k in names}, tag="head")
    x = _final_norm(x, head, cfg)
    unemb = emb if cfg.tie_embeddings else head["unembed/kernel"]
    logits = x @ unemb.to(cdt).T
    aux = {"moe_aux": aux_total, "mtp_logits": None}
    if mtp:
        # predict token t+2 from [h_t ; embed(token t+1)], full length with
        # a roll, as the JAX package (position S-1 is masked in the loss)
        emb_next = emb[torch.roll(tokens, -1, dims=1)]
        h_mtp = matmul(torch.cat([x, emb_next], dim=-1),
                       head["mtp/proj/kernel"].to(cdt))
        h_mtp = rms_norm(h_mtp, head["mtp/norm/scale"], cfg.norm_eps)
        aux["mtp_logits"] = h_mtp @ unemb.to(cdt).T
    if return_cache:
        return logits, aux, kv
    return logits, aux


# ===========================================================================
# Dense decode cache and decode step
# ===========================================================================
def _kv_keys(cfg):
    """``(segment prefix, block kind, repeats)`` of every schedule
    position."""
    for i, (pattern, repeats) in enumerate(cfg.schedule):
        for j, kind in enumerate(pattern):
            yield f"segments/{i}/p{j}/", kind, repeats


def _cache_len(kind: str, cfg, max_len: int) -> int:
    """A ``local`` layer's decode cache is a ring of its window."""
    return min(cfg.sliding_window, max_len) if kind == "local" else max_len


def _cache_entries(kind: str, cfg, max_len: int = 1) -> dict:
    """A layer's cache entries: ``{name: (shape past the batch axis,
    dtype; None for the compute dtype)}``. GQA's ``k`` and ``v`` (S, Hkv,
    hd); a ``dec`` layer's also ``xk`` and ``xv`` (encoder_seq, Hkv, hd),
    its cross-attention's keys and values; a ``cross`` layer's ``xk`` and
    ``xv`` (n_image_tokens, Hkv, hd) alone; MLA's latent ``ckv`` (S,
    kv_lora_rank) and roped shared key part ``krope`` (S, qk_rope_dim), S =
    ``_cache_len``; Mamba's ``conv`` (K-1, d_inner) and fp32 ``ssm``
    (d_inner, state); RWKV's ``x_prev_tm`` and ``x_prev_cm`` (d,) and fp32
    ``wkv`` (H, K, V)."""
    if kind in MAMBA_KINDS:
        return {"conv": ((cfg.mamba_conv - 1, cfg.mamba_d_inner), None),
                "ssm": ((cfg.mamba_d_inner, cfg.mamba_state), torch.float32)}
    if kind == "rwkv":
        hh, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
        return {"x_prev_tm": ((cfg.d_model,), None),
                "x_prev_cm": ((cfg.d_model,), None),
                "wkv": ((hh, hs, hs), torch.float32)}
    s = _cache_len(kind, cfg, max_len)
    if kind in MLA_KINDS:
        return {"ckv": ((s, cfg.kv_lora_rank), None),
                "krope": ((s, cfg.qk_rope_dim), None)}
    lengths = {"k": s, "v": s}
    if kind == "cross":
        lengths = {"xk": cfg.n_image_tokens, "xv": cfg.n_image_tokens}
    elif kind == "dec":
        lengths.update(xk=cfg.encoder_seq, xv=cfg.encoder_seq)
    return {n: ((length, cfg.n_kv_heads, cfg.hd), None)
            for n, length in lengths.items()}


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Zeroed dense decode cache: ``segments/{i}/p{j}/k`` and ``/v`` of
    (repeats, B, max_len, Hkv, hd) in the compute dtype (a ``dec`` layer's
    ``xk`` and ``xv`` of the encoder's length beside them, a ``cross``
    layer's of the image tokens' alone; an MLA layer's ``ckv`` (repeats,
    B, max_len, kv_lora_rank) and ``krope`` (repeats, B, max_len,
    qk_rope_dim); a recurrent layer's state, ``_cache_entries``);
    ``max_len`` is ``min(window, max_len)`` for a ``local`` layer
    (position p at ring slot p % that length), on ``device`` (None: the
    card)."""
    _check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    dev = resolve_device(device)
    return {pre + n: torch.zeros((repeats, batch, *shape), dtype=dt or cdt,
                                 device=dev)
            for pre, kind, repeats in _kv_keys(cfg)
            for n, (shape, dt) in _cache_entries(kind, cfg, max_len).items()}


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
    return _out(p, out.reshape(b, cfg.n_heads * cfg.hd))


def _cross_decode(p, x_t, xk, xv, cfg):
    """One token's cross-attention (``xattn/``) against the whole (B, Skv,
    Hkv, hd) cross cache ``xk`` / ``xv`` (no rope, no mask; the plain
    ``decode_attention``, as the JAX package's). Returns the output
    projected by wo, with its bias where the block has one."""
    b = x_t.shape[0]
    q = _proj(p, x_t, "q", "xattn/").reshape(b, cfg.n_heads, cfg.hd)
    out = decode_attention(q, xk, xv)
    return _out(p, out.reshape(b, cfg.n_heads * cfg.hd), "xattn/")


def _encdec_decode(kind: str, p, x_t, cache: dict, pos, cfg):
    """One token of a ``dec`` block (layer norms; self-attention against
    its ``k`` / ``v``, written in place; cross-attention against ``xk`` /
    ``xv``; the GELU MLP) or a ``cross`` block (the gated cross-attention
    and SwiGLU of ``_encdec_apply``)."""
    eps = cfg.norm_eps
    if kind == "cross":
        h = rms_norm(x_t, p["ln1/scale"], eps)
        x_t = _gated(x_t, p["gate_attn"],
                     _cross_decode(p, h, cache["xk"], cache["xv"], cfg))
        h = rms_norm(x_t, p["ln2/scale"], eps)
        return _gated(x_t, p["gate_mlp"], _mlp(kind, p, h, cfg)[0])
    h = layer_norm(x_t, p["ln1/scale"], p["ln1/bias"], eps)
    x_t = x_t + _gqa_decode(p, h, cache["k"], cache["v"], pos, cfg)
    h = layer_norm(x_t, p["ln2/scale"], p["ln2/bias"], eps)
    x_t = x_t + _cross_decode(p, h, cache["xk"], cache["xv"], cfg)
    h = layer_norm(x_t, p["ln3/scale"], p["ln3/bias"], eps)
    return x_t + gelu_mlp(h, p["mlp/wi/kernel"], p["mlp/wi/bias"],
                          p["mlp/wo/kernel"], p["mlp/wo/bias"])


def _mla_decode(p, x_t, cache, pos, cfg):
    """Absorbed-form MLA decode (the DeepSeek-V3 inference form): the
    per-head key up-projection is folded into q and the value one into the
    output, so attention runs in the latent space against the (B, S,
    kv_lora_rank) latent cache and the (B, S, qk_rope_dim) roped key part.
    x_t: (B, d); ``cache`` {"ckv", "krope"} of one layer, written in place
    at each row's ``pos``. Products of the cache's dtype sum in fp32 (the
    JAX package's ``preferred_element_type``: q and the softmax weights
    rounded to the cache dtype first). Returns the output projected by
    wo."""
    b = x_t.shape[0]
    heads = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    cq = rms_norm(matmul(x_t, p["attn/wq_a/kernel"]), p["attn/q_norm_scale"])
    q = matmul(cq, p["attn/wq_b/kernel"]).reshape(b, heads, nope + rope_d)
    ckv = matmul(x_t, p["attn/wkv_a/kernel"])
    c_kv = rms_norm(ckv[..., :kvr], p["attn/kv_norm_scale"])
    cos, sin = rope_at(pos, rope_d, cfg.rope_theta)
    q_rope = _rope_decode(q[..., nope:], cos, sin)
    k_rope = _rope_decode(ckv[..., kvr:][:, None, :], cos, sin)[:, 0]

    wkv_b = p["attn/wkv_b/kernel"].reshape(kvr, heads, nope + vd)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    # W_uk absorbed into q: q_lat (B, H, kv_lora_rank)
    q_lat = torch.einsum("bhn,khn->bhk", q[..., :nope].float(), w_uk.float())

    ckv_cache, kr_cache = cache["ckv"], cache["krope"]
    rows = torch.arange(b, device=x_t.device)
    ckv_cache[rows, pos] = c_kv.to(ckv_cache.dtype)
    kr_cache[rows, pos] = k_rope.to(kr_cache.dtype)
    cdt = ckv_cache.dtype
    s = ckv_cache.shape[1]
    ckv_f = ckv_cache.float()
    scores = (torch.einsum("bhk,bsk->bhs", q_lat.to(cdt).float(), ckv_f)
              + torch.einsum("bhr,bsr->bhs", q_rope.to(cdt).float(),
                             kr_cache.float()))
    scores = scores / math.sqrt(nope + rope_d)
    mask = torch.arange(s, device=x_t.device)[None] <= pos[:, None]
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cdt)
    ctx_lat = torch.einsum("bhs,bsk->bhk", probs.float(), ckv_f)
    v = torch.einsum("bhk,khv->bhv", ctx_lat, w_uv.float())
    return matmul(v.reshape(b, heads * vd).to(x_t.dtype), p["attn/wo/kernel"])


def _ffn(kind: str, p, x_t, cfg):
    """Post-attention half of a block: norm + SwiGLU or MoE, residual.
    x_t: (B, d) (decode) or (B, C, d) (a prefill chunk)."""
    h = rms_norm(x_t, p["ln2/scale"], cfg.norm_eps)
    return x_t + _mlp(kind, p, h, cfg)[0]


def _rwkv_decode(p, x_t, cache: dict, cfg):
    """One token of an ``rwkv`` block from its cache entry, written in
    place (the new states cast to the entry's dtype)."""
    h = layer_norm(x_t, p["ln1/scale"], p["ln1/bias"], cfg.norm_eps)
    tm_out, new_xp, new_st = time_mix_step(
        _sub(p, "tm/"), h, cache["x_prev_tm"].to(h.dtype), cache["wkv"], cfg)
    x_t = x_t + tm_out
    h2 = layer_norm(x_t, p["ln2/scale"], p["ln2/bias"], cfg.norm_eps)
    cm_out, new_xp_cm = channel_mix_step(_sub(p, "cm/"), h2,
                                         cache["x_prev_cm"].to(h2.dtype))
    _write(cache, {"x_prev_tm": new_xp, "x_prev_cm": new_xp_cm,
                   "wkv": new_st})
    return x_t + cm_out


def _write(cache: dict, new: dict) -> None:
    """A recurrent layer's new state into its cache entries, in place."""
    for n, t in new.items():
        cache[n].copy_(t)


def block_decode(kind: str, p, x_t, cache: dict, pos, cfg):
    """One layer of the dense decode step. x_t: (B, d); ``cache``: the
    layer's entries (``k`` / ``v``, with a ``dec`` layer's ``xk`` / ``xv``;
    a ``cross`` layer's ``xk`` / ``xv``; MLA's ``ckv`` / ``krope``; or a
    recurrent layer's state), written in place (the cross entries only
    read); pos: (B,). Returns ``(x_t, cache)``."""
    _check_kind(kind)
    if kind == "rwkv":
        return _rwkv_decode(p, x_t, cache, cfg), cache
    if kind in ("dec", "cross"):
        return _encdec_decode(kind, p, x_t, cache, pos, cfg), cache
    h = rms_norm(x_t, p["ln1/scale"], cfg.norm_eps)
    if kind in MAMBA_KINDS:
        a, new = mamba_step(_sub(p, "mamba/"), h, cache, cfg)
        _write(cache, new)
    elif kind in MLA_KINDS:
        a = _mla_decode(p, h, cache, pos, cfg)
    else:
        a = _gqa_decode(p, h, cache["k"], cache["v"], pos, cfg,
                        window=_window(kind, cfg))
    return _ffn(kind, p, x_t + a, cfg), cache


def _lm_head(x_t, params, cfg):
    """Final norm + unembedding of every decode entry point.
    x_t: (..., d) -> logits (..., vocab)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x_t = _final_norm(x_t, params, cfg)
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
        entry = {n: cache[pre + n][layer] for n in _cache_entries(kind, cfg)}
        x_t = block_decode(kind, lp, x_t, entry, pos, cfg)[0].to(cdt)
    return _lm_head(x_t, p, cfg), cache


def prefill(params, batch, cfg, max_len: int | None = None):
    """Run the full prompt and build the decode cache. ``batch``: the
    forward's (the tokens and the modality stubs). Returns ``(last_logits
    (B, vocab), cache, n_prompt)``; the per-layer entries (K/V, or MLA's
    latent and roped key part) are zero-padded to ``max_len``, a ``local``
    layer's laid out as its ring; a ``dec`` / ``cross`` layer's ``xk`` and
    ``xv`` are its cross-attention's keys and values of the encoder's
    output or the image embeddings, in the compute dtype; a recurrent
    layer's state is its state after the prompt (``conv`` and the last
    tokens in the compute dtype, ``ssm`` / ``wkv`` fp32)."""
    s = batch["tokens"].shape[1]
    max_len = max_len or s
    logits, _, kv = forward(params, batch, cfg, return_cache=True)
    cdt = getattr(torch, cfg.compute_dtype)
    kinds = {pre: kind for pre, kind, _ in _kv_keys(cfg)}
    cache = {}
    for pre, entries in kv.items():
        kind = kinds[pre]
        if kind in RECURRENT_KINDS:
            for n, (_, dt) in _cache_entries(kind, cfg).items():
                cache[pre + n] = torch.stack([e[n] for e in entries]).to(
                    dt or cdt)
            continue
        if kind == "dec":                  # ((k, v), (xk, xv)) a layer
            entries = [(*self_kv, *cross_kv) for self_kv, cross_kv in entries]
        shapes = _cache_entries(kind, cfg, max_len)
        for (n, (shape, _)), t in zip(shapes.items(), zip(*entries)):
            cache[pre + n] = _prefill_entry(torch.stack(t), shape[0], cdt,
                                            ring=kind == "local")
    return logits[:, -1], cache, s


def _prefill_entry(x, w: int, cdt, *, ring: bool):
    """(R, B, S, ...) -> (R, B, w, ...), zero-padded. With ``ring`` and S >
    w, the last ``w`` positions laid out ring-style (position p at slot p %
    w), as a ``local`` layer's decode cache holds them."""
    s = x.shape[2]
    x = x.to(cdt)
    if ring and s > w:
        slots = torch.arange(s - w, s, device=x.device) % w
        return x[:, :, -w:][:, :, torch.argsort(slots)]
    if s >= w:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, w - s))


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
        x_t = _ffn(kind, lp, x_t + a, cfg).to(cdt)
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
        x = _ffn(kind, lp, x, cfg).to(cdt)
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
