#!/usr/bin/env python3
"""DCT-AdamW on a dense configuration in the port against the JAX package
on the CPU, at a narrowed width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dense_configs_vs_jax.py \
        [--arch phi3-mini-3.8b] [--d-model 768] [--heads 8] [--kv-heads 8]
        [--head-dim 96] [--d-ff 2048] [--layers 4] [--steps 3]

The configuration (``--arch``: qwen2.5-32b, phi3-mini-3.8b or
command-r-plus-104b, its rope theta, qkv bias and ``attn_sp``) through
``reduced(...)`` with the widths given (fp32 parameters and compute). The
parameters are drawn by numpy into the JAX package's tree (the init's
scales) and carried to the port by ``repro_torch.convert``. Both packages
then take ``--steps`` training steps of ``dct_adamw`` with the training
CLI's settings (rank 128, lr 0.01, cosine schedule with 2 warmup steps,
weight decay 0.01, clip 1.0) on the same numpy batches of 4 x 128 tokens:
JAX on its reference path (``fused="off"``), the port on its kernel path
(``fused="on"``: the kernels' plain versions on the CPU). Prints one JSON
line per step with both losses.

A comparison tool like the tests (it imports both packages); the port
itself imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import torch_dense_parity as P  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.optim.api import get_optimizer as jax_get_optimizer  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro.train.schedule import cosine_warmup as jax_cosine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.optim.api import get_optimizer  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from repro_torch.train.schedule import cosine_warmup  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=96)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    over = dict(d_model=args.d_model, n_heads=args.heads,
                n_kv_heads=args.kv_heads, head_dim=args.head_dim,
                d_ff=args.d_ff, schedule=((("attn",), args.layers),))
    jcfg = jax_get_config(args.arch).reduced(**over)
    tcfg = get_config(args.arch).reduced(**over)
    jparams, tparams = P.pair(jcfg)
    kw = dict(rank=128, weight_decay=0.01)
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(0.01, 2, args.steps),
                             fused="off", **kw)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, args.steps),
                         fused="on", **kw)
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jopt.init(jparams))
    tstate = TS.TrainState(0, tparams, topt.init(tparams))
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = TS.make_train_step(tcfg, topt)
    rng = np.random.default_rng(0)
    for i in range(args.steps):
        toks = rng.integers(2, jcfg.vocab_size, (4, 129)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        print(json.dumps({"arch": args.arch, "step": i + 1,
                          "jax_loss": float(jm["loss"]),
                          "port_loss": float(tm["loss"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
