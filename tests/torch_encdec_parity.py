"""Checks shared by the parity tests of the modality families
(``test_torch_whisper.py``: whisper-large-v3, the encoder-decoder;
``test_torch_vision.py``: llama-3.2-vision-90b, gated cross-attention): the
port against the JAX package on the same numpy-seeded parameters and
inputs.

Parameters are drawn by ``torch_dense_parity.pair`` with ``special`` for
the leaves whose init is a constant the generic rule would leave
degenerate: the norms' scales (1 + N(0, 0.1^2): a layer norm's gain is
its scale, an RMS norm's 1 + scale) and the layer norms' biases (N(0,
0.1^2)), and a ``cross`` block's gates (N(0, 0.5^2): the reference's zero
gates would make the block an identity). The other biases are N(0, 0.5^2)
(the generic rule). The stub frontends' inputs (``frames``,
``image_embeds``) are N(0, 1) numpy draws, as the JAX package's
``tests/test_serve_families.py`` makes them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch_dense_parity as P
import torch_recurrent_parity as R

from repro_torch.serve import ServeEngine


def special(path: str, shape, rng):
    """The draws of the leaves named in the module docstring, else None."""
    name = path.rsplit("/", 1)[-1]
    norm = "ln" in path or "final_norm" in path
    if name.startswith("gate_"):
        return rng.normal(0.0, 0.5, shape)
    if norm and name == "scale":
        return 1.0 + rng.normal(0.0, 0.1, shape)
    if norm and name == "bias":
        return rng.normal(0.0, 0.1, shape)
    return None


def pair(jax_cfg, seed: int = 0):
    return P.pair(jax_cfg, seed=seed, special=special)


def stubs(cfg, b: int, seed: int) -> dict:
    """The stub frontends' inputs of ``cfg`` for ``b`` rows as fp32 numpy:
    ``frames`` (b, encoder_seq, d) and / or ``image_embeds`` (b,
    n_image_tokens, d)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_image_tokens:
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def batch(cfg, seed: int, s: int, b: int = 2) -> dict:
    """Tokens (b, s) and the stubs, numpy."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return {"tokens": toks, **stubs(cfg, b, seed + 100)}


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "targets")
                           else jnp.float32) for k, v in b.items()}


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def train_batches(cfg, steps: int) -> list:
    """``R.trajectory``'s token batches (the JAX package's synthetic
    stream, 4 x 16) with the stubs of each step."""
    return [{**b, **stubs(cfg, 4, 200 + i)}
            for i, b in enumerate(R._batches(cfg, steps))]


def oracle_stream(jparams, tparams, jcfg, tcfg, forward, *, s: int = 6,
                  new: int = 4) -> None:
    """``R.oracle_stream`` with the stubs: the port's greedy
    ``ServeEngine.generate`` equal to argmax over growing full forwards of
    JAX's model (``forward(params, batch) -> logits``, run at one length:
    the decoder is causal, and the frames and image embeddings are the same
    at every step)."""
    b = batch(jcfg, 0, s)
    got = ServeEngine(tcfg, tparams, max_len=s + new).generate(
        to_torch(b), max_new_tokens=new)
    seq = np.zeros((2, s + new - 1), np.int64)
    seq[:, :s] = b["tokens"]
    for t in range(s, s + new):
        logits = forward(jparams, to_jax({**b, "tokens": seq}))
        nxt = np.asarray(jnp.argmax(logits[:, t - 1], axis=-1))
        if t < s + new - 1:
            seq[:, t] = nxt
    want = np.concatenate([seq[:, s:], nxt[:, None]], axis=1)
    assert got.tolist() == want.tolist()


def layer(tree, j: int, i: int = 0):
    """Layer ``i`` of schedule position ``j`` of a JAX parameter tree."""
    return jax.tree.map(lambda a: a[i], tree["segments"][0][f"p{j}"])
