#!/usr/bin/env python3
"""Dion in the port against the JAX package on the CPU, at llama-350m's
width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dion_vs_jax.py \
        [--layers 2] [--batch 8] [--seq-len 128] [--steps 3] [--fused fft]
        [--compute-dtype bfloat16]

llama-350m (d 1024, 16 heads of 64, d_ff 2816, vocab 32000, fp32
parameters, bf16 compute, or ``--compute-dtype float32`` to take bf16's
rounding out of the comparison) cut to ``--layers`` layers. One set of
parameters, made by the JAX package from a seed, is carried to the port by
``repro_torch.convert``, and so is the optimizer state JAX's ``init``
builds. Both then take ``--steps`` training steps of ``dion`` (rank 128,
``--fused`` mode: "fft" is the Newton-Schulz polar factor through the plain
iteration, "off" the QR route) with the training CLI's settings (lr 0.01,
cosine schedule with 2 warmup steps, weight decay 0.01, clip 1.0) on the
same batches of the JAX package's synthetic stream. Prints one JSON line
per step (both losses, and the relative Frobenius distance of the two
parameter sets after the step) and a summary line.

A comparison tool like the tests (it imports both packages); the port
itself imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.data.synthetic import SyntheticLM
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.train import steps as JS
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.optim.api import get_optimizer
from repro_torch.train import steps as TS
from repro_torch.train.schedule import cosine_warmup


def _rel_distance(tparams: dict, jparams) -> float:
    want = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    num = sum(float(torch.sum((tparams[k].double() - want[k].double()) ** 2))
              for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fused", default="fft", choices=["off", "fft"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    sched = ((("attn",), args.layers),)
    over = dict(schedule=sched, compute_dtype=args.compute_dtype)
    jcfg = dataclasses.replace(jax_get_config("llama-350m"), **over)
    tcfg = dataclasses.replace(get_config("llama-350m"), **over)
    kw = dict(rank=128, fused=args.fused, weight_decay=0.01)
    jopt = jax_get_optimizer("dion", lr=jax_cosine(0.01, 2, args.steps), **kw)
    topt = get_optimizer("dion", lr=cosine_warmup(0.01, 2, args.steps), **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(args.seed))
    jopt_state = jopt.init(jparams)
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jparams, jopt_state)
    tstate = TS.TrainState(
        0, convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu"),
        convert.opt_state_from_jax(jax.tree.map(np.asarray, jopt_state),
                                   device="cpu"))
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = TS.make_train_step(tcfg, topt)
    data = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=args.seq_len,
                       global_batch=args.batch, seed=args.seed)
    jl, tl = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        b = {k: np.array(v) for k, v in data.batch(jnp.int32(i)).items()}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        print(json.dumps({"step": i + 1, "jax_loss": jl[-1],
                          "port_loss": tl[-1],
                          "params_rel_distance": _rel_distance(
                              tstate.params, jstate.params)}), flush=True)
    print(json.dumps({
        "dion_vs_jax": f"llama-350m width, {args.layers} layers, batch "
                       f"{args.batch} x {args.seq_len}, rank 128, fused "
                       f"{args.fused}, {args.compute_dtype} compute, CPU",
        "jax_losses": jl, "port_losses": tl,
        "max_loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(tl, jl)),
        "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
