"""Dense flash attention: online-softmax GQA attention over a whole sequence.

Queries, keys and values share one sequence axis: q (B, S, Hq, hd), k and v
(B, S, Hkv, hd), query head ``h`` reading kv head ``h // (Hq / Hkv)``. The
mask is causal (key <= query) and/or a sliding window (query - key <
``window``). The function is the JAX package's ``flash_attention``: q, k,
v upcast to fp32, scores times 1/sqrt(hd), masked scores -1e30, softmax in
fp32 with P unrounded, the output in q's dtype. It equals the model's
``blockwise_attention`` with ``q_offset = 0`` to within fp32 sums taken in
another order.

On CUDA tensors ``flash_attention`` launches the kernel of
``csrc/flash_attention.cu`` (replacing ``repro/kernels/flash_attention.py::
_kernel``; bound by its operations — see the source note), reading the
model's layout through strides, or raises. On CPU tensors it runs
``flash_attention_ref``, a port of the JAX package's
``kernels/ref.py::flash_attention_ref``: K/V repeated per query head, one
masked fp32 softmax over the whole sequence.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib

NEG_INF = -1e30


def _check_shapes(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[0] != q.shape[0] or k.shape[1] != q.shape[1] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not fit "
                         f"(B, S, Hq, hd) / (B, S, Hkv, hd), Hq % Hkv == 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None
                        ) -> torch.Tensor:
    """Plain version: masked fp32 softmax attention over the whole sequence.
    q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd). Returns (B, S, Hq, hd) in q's
    dtype."""
    _check_shapes(q, k, v, window)
    s, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    group = hq // k.shape[2]
    kx = k.repeat_interleave(group, dim=2).float()
    vx = v.repeat_interleave(group, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / math.sqrt(hd)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) with ``Hq % Hkv == 0``, any
    S >= 1, hd <= 256 on the card, each with a contiguous head dim (other
    strides are read as they are). ``window``: the sliding window, None for
    none. Returns (B, S, Hq, hd) contiguous in q's dtype."""
    _check_shapes(q, k, v, window)
    dev = cuda_lib.same_device(q, k, v)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype} must all be float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention {name}: expected a CUDA "
                             f"tensor, got {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention {name}: the head dim must be "
                             f"contiguous (stride {t.stride(3)})")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if hd > 256 or hq >= 2**16 or b >= 2**16 or s >= 2**31:
        raise ValueError(f"flash_attention: head dim {hd} > 256 or shape "
                         f"{tuple(q.shape)} exceeds the grid")
    out = torch.empty((b, s, hq, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = cuda_lib.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq,
        hkv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), window or 0, 1.0 / math.sqrt(hd),
        int(q.dtype == torch.bfloat16), cuda_lib.stream(q))
    cuda_lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
