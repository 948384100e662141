"""Model primitives: init helpers, RMS and layer norm, RoPE, blockwise
attention and its sequence-parallel form over the mesh's ``model`` axis,
decode and chunk attention, SwiGLU and the GELU MLP.

Plain functions on tensors, mirroring ``repro/models/layers.py``. Weights are
``(d_in, d_out)`` matrices applied as ``x @ w`` (the JAX layout, not
``nn.Linear``'s), and a stacked ``(layers, d_in, d_out)`` leaf holds one
matrix per layer.

Attention products follow the JAX package's ``preferred_element_type=
float32``: q (or the softmax weights) is rounded to the K (V) dtype, and the
product of the rounded operands runs in fp32, never rounded to bf16.

``blockwise_attention`` is the JAX package's chunked online softmax
(``kernels.flash_attention.blockwise_attention_ref``). A call on CUDA
tensors that takes no gradient (grad mode off, or no input requiring
grad) -- the dense prefill's forward under ``torch.inference_mode()`` --
launches a kernel when its keys cover its queries under a causal or
window mask (Skv >= q_offset + Sq: the whole prefill, or one rank's query
slice at ``q_offset`` in a sequence-parallel prefill), or when the call
has no mask and the keys a length of their own (an encoder's or a
cross-attention's keys): in bf16 ``flash_attention_blockwise``, the same
function on tensor cores with the model's ``kv_chunk``, also with a value
dim of its own (MLA's qk 192 beside v 128); in fp32 ``flash_attention``,
which equals it to within fp32 sums in another order (P's rounding to v's
dtype is a no-op there), and whose contract (the TPU kernel's) wants the
value dim equal to the head dim: an fp32 call with another value dim
raises. A masked no-grad call on the card whose keys end before its last
query raises, naming the shapes: no kernel takes it. Every other call --
CPU tensors, every training forward and backward -- runs the plain loop:
the JAX package has no backward for a kernel.

``sp_blockwise_attention`` is the reference's sequence-parallel
``shard_map`` over the mesh's ``model`` axis (its docstring).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import blockwise_attention_ref
from repro_torch.kernels.ops import (flash_attention_blockwise,
                                     flash_attention_op)
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, *, batch=(), device=None):
    """Normal ``(*batch, d_in, d_out)`` scaled by ``1/sqrt(d_in)``, drawn in
    fp32 and scaled in place (one fp32 transient: a stacked expert leaf of
    deepseek-v3-671b is 3.8 B elements)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*batch, d_in, d_out), generator=gen, device=device)
    return w.mul_(scale).to(dtype)


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


def layer_norm(x, scale, bias, eps=1e-5):
    """Layer norm with fp32 statistics (population variance) and an affine
    ``scale`` / ``bias`` in their own dtype; output in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


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


def _on_card(t: torch.Tensor) -> bool:
    """The route's device test (the CPU tests patch it to drive the kernel
    route with spies in place of the launchers)."""
    return t.is_cuda


def blockwise_attention(q, k, v, *, causal: bool, window: int | None = None,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Online-softmax attention over query and key/value chunks: a kernel
    where the module docstring's route sends the call, else the plain loop.
    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, vd). ``q_offset`` is the
    absolute position of q[0]. Returns (B, Sq, Hq, vd)."""
    if _on_card(q) and not (torch.is_grad_enabled()
                            and any(t.requires_grad for t in (q, k, v))):
        masked = causal or window is not None
        if masked and k.shape[1] < q_offset + q.shape[1]:
            raise ValueError(
                f"blockwise_attention: no kernel takes a prefill on the card "
                f"with q {tuple(q.shape)}, k {tuple(k.shape)}, causal="
                f"{causal}, window={window}, q_offset={q_offset} (keys of "
                f"their own length only without a mask; a query slice at "
                f"an offset against keys covering it)")
        if q.dtype == torch.bfloat16:
            return flash_attention_blockwise(q, k, v, causal=causal,
                                             window=window, kv_chunk=kv_chunk,
                                             q_offset=q_offset)
        if v.shape[-1] != q.shape[-1]:
            raise ValueError(
                f"blockwise_attention: a {q.dtype} prefill on the card with "
                f"value dim {v.shape[-1]} != head dim {q.shape[-1]} has no "
                f"kernel (flash_attention takes v of k's shape); run the "
                f"model in bfloat16")
        return flash_attention_op(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    return blockwise_attention_ref(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   q_offset=q_offset)


def sp_blockwise_attention(q, k, v, *, causal: bool, window=None,
                           q_chunk: int = 512, kv_chunk: int = 512):
    """Sequence-parallel attention (``cfg.attn_sp``): the reference's
    ``shard_map`` over the mesh's ``model`` axis.

    On a mesh with a ``model`` axis of tp ranks, when S % tp == 0 and S/tp
    >= 64, rank i attends its query rows ``[i S/tp, (i+1) S/tp)`` with
    ``q_offset = i S/tp`` and ``q_chunk = min(q_chunk, S/tp)`` against the
    whole K/V (keys of their own length too: a cross-attention's), through
    ``blockwise_attention`` (on the card without grad: a prefill kernel at
    that offset), and the slices are all-gathered over ``model`` in shard
    order, so the output is whole on every rank. Backward: dq stays on its
    slice (all-gathered to the whole q's gradient), dk / dv are summed over
    ``model`` (``parallel.collectives``).

    The reference's third condition, B % dp == 0, reads the global batch:
    where the step cut the batch over the data axes
    (``sharding.batch_cut_axes``) it holds, and each rank's rows are its
    data shard's; where every rank holds the whole batch this call cuts it
    over the data axes too when it divides, and gathers the rows back.
    Where the batch is cut over ``model`` as well (the ``pure_dp`` layout)
    each rank's rows are already its share: it attends all of their
    queries, the same function on as many rows as the reference's slice.
    Otherwise (no mesh, no ``model`` axis, sizes that do not divide) this
    is plain ``blockwise_attention``, as in the reference. The
    parameters are still gathered whole for a step: the projections run
    whole on every rank (``train.steps``)."""
    mesh = sharding.active_mesh()
    tp = sharding.tp_axis(mesh)
    plain = dict(causal=causal, window=window, q_chunk=q_chunk,
                 kv_chunk=kv_chunk)
    if mesh is None or tp is None:
        return blockwise_attention(q, k, v, **plain)
    b, s = q.shape[:2]
    tp_n = mesh.shape[tp]
    dp = sharding.dp_axes(mesh)
    cut = tuple(a for a in sharding.batch_cut_axes() if mesh.shape[a] > 1)
    dp_n = mesh.size(dp) if dp else 1
    cut_here = not cut and dp_n > 1
    if s % tp_n or s // tp_n < 64 or (cut_here and b % dp_n) \
            or tp in cut:
        return blockwise_attention(q, k, v, **plain)
    s_loc = s // tp_n
    if cut_here:
        q, k, v = (C.cut(t, 0, dp) for t in (q, k, v))
    k, v = C.replicated(k, (tp,)), C.replicated(v, (tp,))
    out = blockwise_attention(C.cut(q, 1, (tp,)), k, v, causal=causal,
                              window=window, q_chunk=min(q_chunk, s_loc),
                              kv_chunk=kv_chunk,
                              q_offset=mesh.shard_index((tp,)) * s_loc)
    out = C.gather(out, 1, (tp,))
    return C.gather(out, 0, dp) if cut_here else out


def matmul(x, w):
    """``x @ w`` with JAX's dtype promotion: a bf16 operand beside an fp32
    one is widened (exactly) first, where torch's matmul wants one dtype.
    A qkv bias kept in fp32 makes bf16 activations fp32 this way."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def gelu_mlp(x, wi, bi, wo, bo, tp=None):
    """``gelu(x @ wi + bi) @ wo + bo``, GELU by its tanh approximation (the
    JAX package's ``approximate=True``). The products promote as JAX's do
    (``matmul``): an fp32 bias beside bf16 weights widens what follows it to
    fp32. With ``tp`` (a mesh axis) ``wi`` / ``wo`` are this rank's column
    / row blocks over it (Megatron, :func:`swiglu`): x enters replicated,
    this rank's slice of ``bi`` is added, the output partials are summed
    over ``tp`` and ``bo`` is added once after."""
    if tp is not None:
        x, bi = C.replicated(x, (tp,)), C.cut(bi, -1, (tp,))
    h = F.gelu(matmul(x, wi) + bi, approximate="tanh")
    y = matmul(h, wo)
    return (y if tp is None else C.all_reduce(y, (tp,))) + bo


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


def swiglu(x, wg, wu, wd, tp=None):
    """``(silu(x @ wg) * (x @ wu)) @ wd``. With ``tp`` (a mesh axis) the
    weights are this rank's Megatron blocks over it, the reference's
    ``_shard_hidden`` (the hidden units on ``model``): ``wg`` / ``wu``
    column blocks, ``wd`` the row block; x enters through Megatron's ``f``
    (``collectives.replicated``: its gradient summed over ``tp``) and the
    output's partial products are summed over ``tp`` (``g``:
    ``collectives.all_reduce``, the cotangent handed on as it is)."""
    if tp is not None:
        x = C.replicated(x, (tp,))
    h = F.silu(matmul(x, wg)) * matmul(x, wu)
    y = matmul(h, wd)
    return y if tp is None else C.all_reduce(y, (tp,))
