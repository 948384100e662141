"""Mamba-1 selective SSM mixer (Jamba's sequence mixer), the port of
``repro/models/mamba.py``.

Training and prefill run a chunked scan: a loop over sequence chunks of
``chunk`` positions carrying the (B, d_inner, state) fp32 SSM state, and
inside each chunk the recurrence ``h' = a * h + b`` as a parallel scan in
log depth: ``associative_scan`` is the recursive odd / even form of
``jax.lax.associative_scan`` with the reference's ``combine``, so each
level is a few whole-tensor products rather than one launch per position.
The (B, chunk, d_inner, state) decay and drive exist one chunk at a time
(elementwise, so the values are the reference's whole-sequence ones).

Decode is the exact single-step recurrence with a ``{conv, ssm}`` cache:
the last ``mamba_conv - 1`` pre-conv activations (B, K-1, d_inner) in the
compute dtype and the SSM state (B, d_inner, state) in fp32.

Parameters are the flat leaves of a block's ``mamba/`` subtree, keyed as
the reference's: ``in_proj/kernel`` (d, 2 d_inner), ``conv/kernel`` (K,
d_inner), ``conv/bias``, ``x_proj/kernel`` (d_inner, dt_rank + 2 state),
``dt_proj/kernel`` (dt_rank, d_inner), ``dt_proj/bias``, ``a_log``
(d_inner, state) fp32, ``d_skip`` (d_inner,) fp32, ``out_proj/kernel``
(d_inner, d). Each path keeps the reference's casts: the scan forms its
drive from fp32 ``dt`` and ``xs``, the step from their product in the
compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init, matmul


def init_mamba(gen, cfg, *, batch: tuple = (), device=None) -> dict:
    """The ``mamba/`` leaves of one block (with leading ``batch`` axes),
    drawn from the ``torch.Generator`` ``gen`` in a fixed order (in_proj,
    conv, x_proj, dt_proj, out_proj) at the reference's scales and
    constants: a conv kernel N(0, 1/K), dt bias -4.6 (softplus^-1(0.01)),
    ``a_log = log(1..state)`` per channel, ``d_skip`` ones. ``gen=None``
    with ``device="meta"`` gives shapes only."""
    d, din, st = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_state
    dtr, ck = cfg.dt_rank, cfg.mamba_conv
    dt = getattr(torch, cfg.param_dtype)

    def w(d_in, d_out):
        return dense_init(gen, d_in, d_out, dt, batch=batch, device=device)

    p = {"in_proj/kernel": w(d, 2 * din)}
    conv = torch.randn((*batch, ck, din), generator=gen, device=device)
    p["conv/kernel"] = conv.div_(math.sqrt(ck)).to(dt)
    p["conv/bias"] = torch.zeros((*batch, din), dtype=dt, device=device)
    p["x_proj/kernel"] = w(din, dtr + 2 * st)
    p["dt_proj/kernel"] = w(dtr, din)
    p["dt_proj/bias"] = torch.full((*batch, din), -4.6, dtype=dt,
                                   device=device)
    p["out_proj/kernel"] = w(din, d)
    a = torch.arange(1, st + 1, dtype=torch.float32, device=device)
    p["a_log"] = torch.log(a).expand(*batch, din, st).clone()
    p["d_skip"] = torch.ones((*batch, din), dtype=torch.float32,
                             device=device)
    return p


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear branch above a
    threshold, as ``F.softplus`` has)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, kernel, bias):
    """Depthwise causal conv. x: (B, S, din); kernel: (K, din). The K
    products summed in order from 0, then the bias."""
    k, s = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + s, :] * kernel[i][None, None, :]
    return out + bias


def _combine(left, right):
    """The reference's ``combine`` of two spans of ``h' = a h + b``: the
    earlier ``left`` then ``right``."""
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even, odd, axis: int):
    """``even`` at positions 0, 2, ... and ``odd`` at 1, 3, ... along
    ``axis`` (``even`` as long as ``odd`` or one longer)."""
    n = odd.shape[axis]
    pairs = torch.stack([even.narrow(axis, 0, n), odd], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if even.shape[axis] > n:
        out = torch.cat([out, even.narrow(axis, n, 1)], dim=axis)
    return out


def associative_scan(elems, axis: int = 1):
    """Inclusive scan of ``_combine`` over ``axis`` of the pair ``elems``
    in log depth: ``jax.lax.associative_scan``'s recursion (adjacent pairs
    combined, the half-length scan, the even positions combined from it),
    so the products are the reference's in the same order."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = _combine([sl(e, 0, -1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, axis)
    if n % 2 == 0:
        even = _combine([sl(e, 0, -1) for e in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _ssm_chunk(h0, decay, drive, c):
    """One chunk. h0: (B, din, st) fp32; decay, drive: (B, c, din, st);
    c: (B, c, st). Returns (the chunk's last state, y (B, c, din))."""
    a_cum, h_in = associative_scan([decay, drive], axis=1)
    h = a_cum * h0[:, None] + h_in                        # (B, c, din, st)
    y = torch.einsum("bcds,bcs->bcd", h, c)
    return h[:, -1], y


def _split_dbc(dbc, cfg):
    st, dtr = cfg.mamba_state, cfg.dt_rank
    return dbc[..., :dtr], dbc[..., dtr:dtr + st], dbc[..., dtr + st:]


def mamba_mix(p: dict, x, cfg, chunk: int = 128, return_state: bool = False):
    """(B, S, d) -> (B, S, d); with ``return_state`` also the decode cache
    ``{"conv": the last K-1 pre-conv activations, "ssm": the final SSM
    state}``. S must be a multiple of ``min(chunk, S)`` (the reference's
    rule; nothing is padded)."""
    b, s, _ = x.shape
    din = cfg.mamba_d_inner
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mamba_mix: sequence length {s} is not a multiple "
                         f"of the scan chunk {chunk} (S <= {chunk} or a "
                         f"multiple of it)")
    xz = matmul(x, p["in_proj/kernel"])
    xs, z = xz[..., :din], xz[..., din:]
    conv_tail = xs[:, -(cfg.mamba_conv - 1):, :]          # decode conv cache
    xs = F.silu(_causal_conv(xs, p["conv/kernel"], p["conv/bias"]))

    dt_r, b_ssm, c_ssm = _split_dbc(matmul(xs, p["x_proj/kernel"]), cfg)
    dt = _softplus(matmul(dt_r, p["dt_proj/kernel"]) + p["dt_proj/bias"])
    a = -torch.exp(p["a_log"].float())                    # (din, st)

    xsf = xs.float()
    h = torch.zeros((b, din, cfg.mamba_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    # one split per tensor: its backward joins the chunks' gradients in
    # one pass (a slice per chunk would build a whole-sequence buffer each)
    for dtc, xc, bc, cc in zip(*(t.split(chunk, dim=1) for t in
                                 (dt.float(), xsf, b_ssm.float(),
                                  c_ssm.float()))):
        decay = torch.exp(dtc[..., None] * a)             # (B, c, din, st)
        drive = (dtc * xc)[..., None] * bc[:, :, None, :]
        h, y = _ssm_chunk(h, decay, drive, cc)
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xsf * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = matmul(y, p["out_proj/kernel"])
    if return_state:
        return out, {"conv": conv_tail, "ssm": h}
    return out


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.mamba_conv - 1, cfg.mamba_d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_state),
                           dtype=torch.float32, device=device),
    }


def mamba_step(p: dict, x_t, cache: dict, cfg):
    """x_t: (B, d) one token. Returns ``(y_t, new cache)``."""
    din = cfg.mamba_d_inner
    xz = matmul(x_t, p["in_proj/kernel"])
    xs, z = xz[..., :din], xz[..., din:]

    conv_in = torch.cat([cache["conv"], xs[:, None, :]], dim=1)
    xs = F.silu(torch.einsum("bkd,kd->bd", conv_in, p["conv/kernel"])
                + p["conv/bias"])
    new_conv = conv_in[:, 1:]

    dt_r, b_ssm, c_ssm = _split_dbc(matmul(xs, p["x_proj/kernel"]), cfg)
    dt = _softplus(matmul(dt_r, p["dt_proj/kernel"]) + p["dt_proj/bias"])
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt.float()[..., None] * a)          # (B, din, st)
    drive = (dt * xs).float()[..., None] * b_ssm.float()[:, None, :]
    h = decay * cache["ssm"] + drive
    y = torch.einsum("bds,bs->bd", h, c_ssm.float())
    y = y + xs.float() * p["d_skip"]
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return matmul(y, p["out_proj/kernel"]), {"conv": new_conv, "ssm": h}
