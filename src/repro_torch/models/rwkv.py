"""RWKV-6 ("Finch") blocks: time-mix with data-dependent decay and
channel-mix, the port of ``repro/models/rwkv.py``.

The WKV recurrence per head (K = V = head_size):
    state'[k, v] = w_t[k] * state[k, v] + kv_t[k] * v_t[v]
    out_t[v]     = sum_k r_t[k] * (state[k, v] + u[k] * kv_t[k] * v_t[v])
with the data-dependent per-channel decay ``w_t = exp(-exp(w0 +
lora(x_t)))``. Training and prefill run the reference's exact per-token
scan: a loop over the positions, the (B, H, K, V) fp32 state carried from
one to the next (the outer products ``k v`` and ``u k v`` of every
position are formed before the loop: elementwise, the same values). The
JAX package has no WKV kernel (a chunked parallel form is future kernel
work there), so neither has this one. Decode is the same single-step
update.

Parameters are the flat leaves of a block's ``tm/`` and ``cm/`` subtrees,
keyed as the reference's: ``tm/mu_{r,k,v,g,w}`` (d,), ``tm/w{r,k,v,g,o}/
kernel`` (d, d), ``tm/decay_w0`` (d,), ``tm/decay_a`` (d, lora),
``tm/decay_b`` (lora, d), ``tm/bonus_u`` (H, K), ``tm/ln_scale`` (d,);
``cm/mu_c``, ``cm/ck/kernel`` (d, d_ff), ``cm/cv/kernel`` (d_ff, d),
``cm/cr/kernel`` (d, d). The ``decay_*`` leaves, ``bonus_u`` and
``ln_scale`` are fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, matmul


def init_rwkv(gen, cfg, *, batch: tuple = (), device=None) -> dict:
    """The ``tm/`` and ``cm/`` leaves of one block (with leading ``batch``
    axes), drawn from the ``torch.Generator`` ``gen`` in a fixed order (wr,
    wk, wv, wg, wo, decay_a, decay_b, ck, cv, cr) at the reference's scales
    and constants: mixes 0.5, ``decay_w0`` -2, ``decay_b`` N(0, 0.01^2),
    ``bonus_u`` zeros, ``ln_scale`` ones. ``gen=None`` with
    ``device="meta"`` gives shapes only."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    h, lo = cfg.rwkv_n_heads, cfg.rwkv_decay_lora
    dt = getattr(torch, cfg.param_dtype)
    f32 = torch.float32

    def w(d_in, d_out, dtype=dt, scale=None):
        return dense_init(gen, d_in, d_out, dtype, scale, batch=batch,
                          device=device)

    def full(shape, value, dtype):
        return torch.full((*batch, *shape), value, dtype=dtype, device=device)

    p = {f"tm/mu_{n}": full((d,), 0.5, dt) for n in "rkvgw"}
    for n in "rkvgo":
        p[f"tm/w{n}/kernel"] = w(d, d)
    p["tm/decay_w0"] = full((d,), -2.0, f32)
    p["tm/decay_a"] = w(d, lo, f32)
    p["tm/decay_b"] = w(lo, d, f32, scale=0.01)
    p["tm/bonus_u"] = full((h, hs), 0.0, f32)
    p["tm/ln_scale"] = full((d,), 1.0, f32)
    p["cm/mu_c"] = full((d,), 0.5, dt)
    p["cm/ck/kernel"] = w(d, cfg.d_ff)
    p["cm/cv/kernel"] = w(cfg.d_ff, d)
    p["cm/cr/kernel"] = w(d, d)
    return p


def _decay(tm: dict, xw):
    """Data-dependent per-channel decay in (0, 1)."""
    lora = torch.tanh(xw.float() @ tm["decay_a"]) @ tm["decay_b"]
    return torch.exp(-torch.exp(tm["decay_w0"] + lora))


def _wkv_step(state, rkvw, u):
    """state: (B, H, K, V); r, k, v: (B, H, K|V); w: (B, H, K). Returns
    ``(new state, out (B, H, V))``."""
    r, k, v, w = rkvw
    kv = k[..., :, None] * v[..., None, :]               # (B, H, K, V)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[..., None] * kv)
    return w[..., None] * state + kv, out


def _heads(x, h: int, hs: int):
    return x.reshape(*x.shape[:-1], h, hs)


def _group_norm(x, scale, h: int, hs: int, eps: float = 1e-5):
    """Per-head layer norm of the wkv output, fp32 statistics. x: (..., d)."""
    xh = x.reshape(*x.shape[:-1], h, hs).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(x.shape) * scale).to(x.dtype)


def _projections(tm: dict, x, xx, h: int, hs: int):
    """r, k, v (heads), the gate g and the decay w (heads) of tokens x
    mixed with their predecessors xx."""
    def mixed(mu):
        return x + mu * (xx - x)

    r = _heads(matmul(mixed(tm["mu_r"]), tm["wr/kernel"]), h, hs)
    k = _heads(matmul(mixed(tm["mu_k"]), tm["wk/kernel"]), h, hs)
    v = _heads(matmul(mixed(tm["mu_v"]), tm["wv/kernel"]), h, hs)
    g = F.silu(matmul(mixed(tm["mu_g"]), tm["wg/kernel"]))
    w = _heads(_decay(tm, mixed(tm["mu_w"])), h, hs)
    return r, k, v, g, w


def time_mix(tm: dict, x, x_prev, state, cfg):
    """x: (B, S, d); x_prev: (B, d) the last token of the previous segment;
    state: (B, H, K, V). Returns ``(out, last x, new state)``."""
    b, s, d = x.shape
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    xx = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    r, k, v, g, w = _projections(tm, x, xx, h, hs)
    rs, ks_, vs, ws = (t.transpose(0, 1).float()
                       for t in (r, k, v, w))             # (S, B, H, .)
    kv = ks_[..., :, None] * vs[..., None, :]             # (S, B, H, K, V)
    ukv = tm["bonus_u"][..., None] * kv
    # one unbind per tensor: its backward stacks the positions' gradients
    # in one pass, where indexing per position would make autograd build a
    # whole-sequence zero buffer for every position
    steps = zip(rs.unbind(0), ws.unbind(0), kv.unbind(0), ukv.unbind(0))
    state = state.float()
    outs = []
    for r_t, w_t, kv_t, ukv_t in steps:
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, state + ukv_t))
        state = w_t[..., None] * state + kv_t
    out = torch.stack(outs, dim=1).reshape(b, s, d)       # (B, S, d)
    out = _group_norm(out, tm["ln_scale"], h, hs)
    out = matmul(out * g.to(out.dtype), tm["wo/kernel"])
    return out, x[:, -1, :], state


def channel_mix(cm: dict, x, x_prev):
    """x: (B, S, d); x_prev: (B, d). Returns ``(out, last x)``."""
    xx = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    return _channel(cm, x + cm["mu_c"] * (xx - x)), x[:, -1, :]


def _channel(cm: dict, xm):
    k = torch.square(F.relu(matmul(xm, cm["ck/kernel"])))
    return torch.sigmoid(matmul(xm, cm["cr/kernel"])) * \
        matmul(k, cm["cv/kernel"])


def time_mix_step(tm: dict, x_t, x_prev, state, cfg):
    """Single-token decode. x_t, x_prev: (B, d); state (B, H, K, V) fp32.
    Returns ``(out, x_t, new state)``."""
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    r, k, v, g, w = _projections(tm, x_t, x_prev, h, hs)
    new_state, out = _wkv_step(state.float(),
                               (r.float(), k.float(), v.float(), w),
                               tm["bonus_u"])
    out = out.reshape(x_t.shape).to(x_t.dtype)
    out = _group_norm(out, tm["ln_scale"], h, hs)
    out = matmul(out * g.to(out.dtype), tm["wo/kernel"])
    return out, x_t, new_state


def channel_mix_step(cm: dict, x_t, x_prev):
    return _channel(cm, x_t + cm["mu_c"] * (x_prev - x_t)), x_t
