"""Dense flash attention: online-softmax GQA attention over a whole sequence.

q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), query head ``h`` reading kv
head ``h // (Hq / Hkv)``. The mask is causal (key <= query) and/or a
sliding window (query - key < ``window``); a masked call wants keys that
cover its rows (Skv >= q_offset + Sq; Skv == Sq for a whole prefill). A
call with no mask takes keys of their own length, as the JAX model's ``blockwise_attention`` does: an encoder's bidirectional
attention, or a cross-attention's queries against an encoder's frames or
an image's patch embeddings. ``q_offset`` makes q a slice of a longer
query sequence: row i is absolute position ``q_offset + i``, and the masks
compare absolute positions against keys ``0 .. Skv-1`` (a masked slice
wants ``Skv >= q_offset + Sq``). That is one rank's share of a
sequence-parallel prefill (``models.layers.sp_blockwise_attention``): its
rows of the whole prefill against all of the keys. Both kernels take it.

The function is the JAX package's ``flash_attention``: q, k, v upcast to
fp32, scores times 1/sqrt(hd), masked scores -1e30, softmax in
fp32 with P unrounded, the output in q's dtype. It equals the model's
``blockwise_attention`` with ``q_offset = 0`` to within fp32 sums taken in
another order.

On CUDA tensors ``flash_attention`` launches the kernel of
``csrc/flash_attention.cu`` (replacing ``repro/kernels/flash_attention.py::
_kernel``; bound by its operations — see the source note), reading the
model's layout through strides, or raises. That kernel runs both products
on the tensor cores as 3xTF32 (each fp32 operand split into two TF32
parts, three products summed in fp32: about fp32's accuracy), with P taken
unrounded from the score accumulators; bf16 inputs are upcast to fp32 as
they are staged. On CPU tensors it runs
``flash_attention_ref``, a port of the JAX package's
``kernels/ref.py::flash_attention_ref``: K/V repeated per query head, one
masked fp32 softmax over the whole sequence.

``flash_attention_blockwise`` is the model's function, the JAX package's
``models/layers.py::blockwise_attention``, which its prefill runs: scores
from q rounded to k's dtype times k with fp32 sums, divided by sqrt(hd);
the running max taken once per kv chunk of ``kv_chunk`` keys (``min(
kv_chunk, Skv)``, or Skv when Skv is not a multiple of it: the rule reads
the keys' length, not the queries'); the denominator
summed over the fp32 p; P rounded to v's dtype before P.V, with fp32 sums.
Its plain version ``blockwise_attention_ref`` is that chunked loop, which
the model runs for CPU tensors and for every call that takes a gradient.
For bf16 CUDA tensors it launches the tensor-core kernel of
``csrc/flash_attention_blockwise.cu`` (see its source note), or raises.
Unlike ``flash_attention`` (the TPU kernel's contract: k and v of one
shape), it takes values of their own head dim ``vd`` beside q and k's
``hd``, as MLA's (qk 192, v 128) and the model's loop do.
In fp32 the rounding to v's dtype is a no-op and the chunk max changes
only the order of fp32 sums, so the model sends fp32 calls to
``flash_attention``.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib

NEG_INF = -1e30


def _check_shapes(q, k, v, causal, window, *, own_vd: bool = False,
                  q_offset: int = 0):
    """(B, Sq, Hq, hd) / (B, Skv, Hkv, hd) / (B, Skv, Hkv, hd) with Hq % Hkv
    == 0; under a mask (causal or a window) keys that cover the rows at
    ``q_offset`` (Skv >= q_offset + Sq); with ``own_vd`` v's last dim may
    differ."""
    vshape = tuple(v.shape[:3]) + ((k.shape[3],) if own_vd else
                                   tuple(v.shape[3:]))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or tuple(k.shape) != vshape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        vd = "vd" if own_vd else "hd"
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not fit "
                         f"(B, Sq, Hq, hd) / (B, Skv, Hkv, hd) / (B, Skv, "
                         f"Hkv, {vd}), Hq % Hkv == 0")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if (causal or window is not None) and \
            k.shape[1] < q_offset + q.shape[1]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} at q_offset {q_offset}: keys of "
                         f"their own length take no causal or window mask "
                         f"(a query slice at an offset takes keys covering "
                         f"it)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain version: masked fp32 softmax attention over the whole sequence.
    q: (B, Sq, Hq, hd), rows at ``q_offset``; k, v: (B, Skv, Hkv, hd)
    (module docstring). Returns (B, Sq, Hq, hd) in q's dtype."""
    _check_shapes(q, k, v, causal, window, q_offset=q_offset)
    sq, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[1]
    group = hq // k.shape[2]
    kx = k.repeat_interleave(group, dim=2).float()
    vx = v.repeat_interleave(group, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / math.sqrt(hd)
    qp = q_offset + torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def _check_heads(fn: str, q, k, v, *, aligned: bool = False) -> None:
    """q, k, v on the card, each with a contiguous head dim; with
    ``aligned`` every row and head on 16 bytes (a kernel that copies
    16-byte pieces of the rows)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{fn} {name}: expected a CUDA tensor, got "
                             f"{t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{fn} {name}: the head dim must be contiguous "
                             f"(stride {t.stride(3)})")
        if aligned and (t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:3])):
            raise ValueError(f"{fn} {name}: every row must start on 16 bytes "
                             f"(strides {t.stride()}, address "
                             f"{t.data_ptr():#x})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) with ``Hq % Hkv == 0``,
    any Sq, Skv >= 1 (under a mask Skv >= q_offset + Sq), hd <= 256 on the card, each with a contiguous head dim
    (other strides are read as they are). ``window``: the sliding window,
    None for none; ``q_offset``: the absolute position of q's first row.
    Returns (B, Sq, Hq, hd) contiguous in q's dtype."""
    _check_shapes(q, k, v, causal, window, q_offset=q_offset)
    dev = cuda_lib.same_device(q, k, v)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype} must all be float32 or all bfloat16")
    _check_heads("flash_attention", q, k, v)
    b, s, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hd > 256 or hq >= 2**16 or b >= 2**16 or max(s, skv) >= 2**31:
        raise ValueError(f"flash_attention: head dim {hd} > 256 or shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)} exceed the "
                         f"grid")
    out = torch.empty((b, s, hq, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = cuda_lib.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, skv,
        hq, hkv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), window or 0, q_offset, 1.0 / math.sqrt(hd),
        int(q.dtype == torch.bfloat16), cuda_lib.stream(q))
    cuda_lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def effective_kv_chunk(s: int, kv_chunk: int) -> int:
    """The kv chunk the model's loop takes for S keys (the keys' length,
    whatever the queries'): ``min(kv_chunk, S)``, or S when S is not a
    multiple of it."""
    chunk = min(kv_chunk, s)
    return s if s % chunk else chunk


def _attn_scores(qg, k, mask, hd):
    """qg: (B,Hkv,G,qc,hd); k: (B,Hkv,kc,hd) -> fp32 scores (B,Hkv,G,qc,kc).

    q is rounded to k's dtype, then the product runs in fp32 on the upcast
    operands, as the JAX package's ``preferred_element_type=float32`` does
    (a bf16 product is exact in fp32; the sum is not rounded to bf16).
    """
    s = (qg.to(k.dtype).float() @ k[:, :, None].transpose(-1, -2).float()
         ) / math.sqrt(hd)
    return torch.where(mask, s, NEG_INF)


def blockwise_attention_ref(q, k, v, *, causal: bool,
                            window: int | None = None, q_chunk: int = 512,
                            kv_chunk: int = 512, q_offset: int = 0):
    """Plain version of ``flash_attention_blockwise``: the JAX model's
    online-softmax loop over query and key/value chunks (memory O(S *
    chunk)), differentiable. q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, vd).
    ``q_offset`` is the absolute position of q[0]. Returns (B, Sq, Hq, vd)
    in q's dtype."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    q_chunk = min(q_chunk, sq)
    if sq % q_chunk:
        q_chunk = sq       # odd lengths (tests): one chunk
    kv_chunk = effective_kv_chunk(skv, kv_chunk)
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
            pv = p.to(vb.dtype).float() @ vb[:, :, None].float()
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(denom[..., None], 1e-30)
        outs.append(out.reshape(b, hq, q_chunk, vd))
    out = torch.cat(outs, dim=2)                          # (B, Hq, Sq, vd)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_blockwise(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None, kv_chunk: int = 512,
                              q_offset: int = 0) -> torch.Tensor:
    """The model's attention (module docstring): q (B, Sq, Hq, hd), k (B,
    Skv, Hkv, hd), v (B, Skv, Hkv, vd), with ``Hq % Hkv == 0``, any Sq, Skv
    >= 1 (under a mask Skv >= q_offset + Sq).
    On the card: bf16, hd and vd multiples of 16 up to 256, a contiguous
    head dim and rows on 16 bytes (other strides are read as they are).
    ``window``: the sliding window, None for none; ``kv_chunk``: the
    model's ``cfg.kv_chunk``, resolved against Skv (``effective_kv_chunk``);
    ``q_offset``: the absolute position of q's first row. Returns (B, Sq,
    Hq, vd) contiguous in q's dtype."""
    _check_shapes(q, k, v, causal, window, own_vd=True, q_offset=q_offset)
    if kv_chunk < 1:
        raise ValueError(f"flash_attention_blockwise: kv_chunk {kv_chunk} < 1")
    dev = cuda_lib.same_device(q, k, v)
    if dev.type == "cpu":
        return blockwise_attention_ref(q, k, v, causal=causal, window=window,
                                       kv_chunk=kv_chunk, q_offset=q_offset)
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_blockwise: q {q.dtype}, k "
                        f"{k.dtype}, v {v.dtype} must all be bfloat16")
    b, s, hq, hd = q.shape
    skv, vd = k.shape[1], v.shape[3]
    if hd % 16 or hd > 256 or vd % 16 or vd > 256 or hq >= 2**16 \
            or b >= 2**16 or max(s, skv) >= 2**30:
        raise ValueError(f"flash_attention_blockwise: head dim {hd} or value "
                         f"dim {vd} is not a multiple of 16 up to 256, or "
                         f"shapes {tuple(q.shape)}, {tuple(k.shape)} exceed "
                         f"the grid")
    _check_heads("flash_attention_blockwise", q, k, v, aligned=True)
    out = torch.empty((b, s, hq, vd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = cuda_lib.library().repro_flash_attention_blockwise(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, skv,
        hq, k.shape[2], hd, vd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), window or 0, q_offset,
        effective_kv_chunk(skv, kv_chunk), math.sqrt(hd), cuda_lib.stream(q))
    cuda_lib.check(rc, "flash_attention_blockwise")
    flash_attention_blockwise.launches += 1
    return out


flash_attention_blockwise.launches = 0
