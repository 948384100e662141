"""Model primitives: init helpers, RMS norm, RoPE, blockwise, decode and
chunk attention, SwiGLU.

Plain functions on tensors, mirroring ``repro/models/layers.py``. Weights are
``(d_in, d_out)`` matrices applied as ``x @ w`` (the JAX layout, not
``nn.Linear``'s), and a stacked ``(layers, d_in, d_out)`` leaf holds one
matrix per layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, *, batch=(), device=None):
    """Normal ``(*batch, d_in, d_out)`` scaled by ``1/sqrt(d_in)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*batch, d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, *,
               device=None):
    return (torch.randn((vocab, d), generator=gen, device=device) * 0.02
            ).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    """RMS norm in fp32 with the ``(1 + scale)`` gain; output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_table(seq_len: int, head_dim: int, theta: float = 1e4,
               offset: int = 0, dtype=torch.float32, device=None):
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=device) / half)
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * freqs[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (..., S, H, hd); tables (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rope_at(pos, head_dim: int, theta: float = 1e4):
    """Per-position rope tables for decode. pos: (B,) int -> (B, 1, half)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=pos.device) / half)
    ang = pos.float()[:, None] * freqs[None, :]
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def rope_tables_at(positions, head_dim: int, theta: float = 1e4,
                   dtype=torch.float32):
    """``rope_table`` for a position vector (a prefill chunk at any start).
    positions: (S,) int -> ((S, half), (S, half)) for ``apply_rope``."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


NEG_INF = -1e30


def _attn_scores(qg, k, mask, hd):
    """qg: (B,Hkv,G,qc,hd); k: (B,Hkv,kc,hd) -> fp32 scores (B,Hkv,G,qc,kc).

    The product runs in k's dtype. In bf16 its result is rounded to bf16
    before the upcast, where the JAX package keeps fp32 (its
    ``preferred_element_type``); in fp32 the two agree.
    """
    s = (qg.to(k.dtype) @ k[:, :, None].transpose(-1, -2)).float() / math.sqrt(hd)
    return torch.where(mask, s, NEG_INF)


def blockwise_attention(q, k, v, *, causal: bool, window: int | None = None,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Online-softmax attention over query and key/value chunks, in plain
    PyTorch (memory O(S * chunk)). q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv,
    hd). ``q_offset`` is the absolute position of q[0]. Returns (B, Sq, Hq,
    vd)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk:
        q_chunk = sq       # odd lengths (tests): one chunk
    if skv % kv_chunk:
        kv_chunk = skv
    nq, nk = sq // q_chunk, skv // kv_chunk
    group = hq // hkv

    qt = q.transpose(1, 2)                                # (B, Hq, Sq, hd)
    kt = k.transpose(1, 2)                                # (B, Hkv, Skv, hd)
    vt = v.transpose(1, 2)
    dev = q.device

    outs = []
    for qi in range(nq):
        qsl = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qb = qt[:, :, qsl].reshape(b, hkv, group, q_chunk, hd)
        qp = q_offset + torch.arange(qsl.start, qsl.stop, device=dev)
        acc = torch.zeros((b, hkv, group, q_chunk, vd), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, hkv, group, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        denom = torch.zeros((b, hkv, group, q_chunk), dtype=torch.float32,
                            device=dev)
        for ki in range(nk):
            ksl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kb, vb = kt[:, :, ksl], vt[:, :, ksl]
            kp = torch.arange(ksl.start, ksl.stop, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window is not None:
                mask &= qp[:, None] - kp[None, :] < window
            s = _attn_scores(qb, kb, mask, hd)            # (B,Hkv,G,qc,kc)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            pv = (p.to(vb.dtype) @ vb[:, :, None]).float()
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(denom[..., None], 1e-30)
        outs.append(out.reshape(b, hq, q_chunk, vd))
    out = torch.cat(outs, dim=2)                          # (B, Hq, Sq, vd)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, length=None, window=None,
                     mask=None, scale=None):
    """Single-token attention against a (B, S, Hkv, hd) cache.

    q: (B, Hq, hd). ``length``: (B,) valid cache length (entries >= length
    masked). ``mask``: explicit (B, S) bool validity, overriding
    length/window. Products of the cache's dtype accumulate in fp32 (as the
    JAX package's ``preferred_element_type``): q and the softmax weights are
    rounded to the cache dtype, the products run in fp32. Returns
    (B, Hq, vd) in q's dtype."""
    b, hq, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, hd).to(k_cache.dtype).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    if mask is None:
        pos = torch.arange(s, device=q.device)[None, :]
        mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
        if length is not None:
            mask &= pos < length[:, None]
        if window is not None and length is not None:
            mask &= pos >= (length[:, None] - window)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, -1).to(q.dtype)


def chunk_attention(q, k_cache, v_cache, mask, *, scale=None):
    """Multi-token attention against a cache (chunked paged prefill).

    q: (B, C, Hq, hd), the prompt chunk's queries; k/v_cache: (B, S, Hkv,
    hd), every position written so far (this chunk's included); mask:
    (C, S) or (B, C, S) bool validity (causal with offset, sliding window).
    Same dtype discipline as ``decode_attention``. Returns (B, C, Hq, hd)
    in q's dtype."""
    b, c, hq, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qg = q.reshape(b, c, hkv, group, hd).to(k_cache.dtype).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bckgd,bskd->bkcgs", qg, k_cache.float()) * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, :, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bkcgs,bskd->bckgd", p, v_cache.float())
    return out.reshape(b, c, hq, hd).to(q.dtype)


def swiglu(x, wg, wu, wd):
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd
