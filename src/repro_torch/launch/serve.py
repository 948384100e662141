"""Serving driver: paged continuous batching or the dense fixed batch.

  python -m repro_torch.launch.serve --arch llama-350m --engine paged \
      [--batch 4] [--prompt-len 12] [--new-tokens 16] [--block-size 8] \
      [--prefill-chunk 8] [--num-splits 2] [--smoke] [--device cpu]

Runs on the CUDA card by default and raises if there is none; ``--device
cpu`` runs on the CPU (the tests). The weights are random, from
``init_params`` with ``--seed``; no weights are downloaded.

``--engine paged`` (the default): two tenant sessions submit staggered
requests with different sampling parameters into a block-pool KV cache; the
continuous-batching scheduler admits and retires them between decode steps,
whose attention is the ``flash_decode`` kernel on the card. One request
streams token by token, one is admitted mid-flight, one is cancelled, and
the pool's stats are printed at the end.

``--engine dense``: one prefill and decode steps over a dense cache for a
batch of prompts.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.launch.train import device_for


def build(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-350m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--engine", choices=["paged", "dense"], default="paged")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (paged) or batch rows (dense)")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--num-splits", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(sys.argv[1:] if argv is None else argv)


def run_dense(cfg, params, args, rng, dev) -> dict:
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.new_tokens,
                      temperature=args.temperature, seed=args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    t0 = time.perf_counter()
    out = eng.generate({"tokens": prompts}, max_new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} dense batch={args.batch} device={dev}")
    for i, row in enumerate(out.tolist()):
        print(f"  seq {i}: {row}")
    print(f"{out.numel()} tokens in {dt:.2f}s ({out.numel() / dt:.1f} tok/s "
          f"incl. prefill)")
    return {"tokens": out.tolist(), "seconds": dt}


def run_paged(cfg, params, args, rng, dev) -> dict:
    from repro_torch.serve import PagedServeEngine, SamplingParams, Session

    bs = args.block_size
    eng = PagedServeEngine(
        cfg, params, block_size=bs,
        num_blocks=args.batch * 2 * -(-(args.prompt_len + args.new_tokens)
                                      // bs),
        num_slots=args.batch, max_prefill_len=args.prompt_len,
        prefill_chunk=args.prefill_chunk, num_splits=args.num_splits)
    tenant_a = Session(eng, "tenant-a")
    tenant_b = Session(eng, "tenant-b", default_sampling=SamplingParams(
        temperature=max(args.temperature, 0.7), top_k=50, top_p=0.95,
        seed=args.seed + 1))

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, (n,))

    t0 = time.perf_counter()
    # tenant A: greedy requests, one streamed token by token
    streamed = tenant_a.submit(prompt(args.prompt_len),
                               max_new_tokens=args.new_tokens)
    rest = [tenant_a.submit(prompt(max(args.prompt_len - 2, 1)),
                            max_new_tokens=args.new_tokens)]
    # tenant B: sampled requests admitted mid-flight, one cancelled
    eng.step()
    rest.append(tenant_b.submit(prompt(args.prompt_len),
                                max_new_tokens=args.new_tokens))
    doomed = tenant_b.submit(prompt(args.prompt_len),
                             max_new_tokens=4 * args.new_tokens)
    print(f"arch={args.arch} paged slots={args.batch} device={dev}")
    got = []
    for tok in streamed.stream():
        got.append(tok)
        if len(got) == 3:
            doomed.cancel()
    print(f"  {streamed.request.request_id} (streamed): {got}")
    eng.run()
    for h in rest:
        print(f"  {h.request.request_id} ({h.finish_reason}): {h.tokens}")
    print(f"  {doomed.request.request_id}: {doomed.finish_reason} after "
          f"{len(doomed.tokens)} tokens (blocks returned to pool)")
    dt = time.perf_counter() - t0
    stats = eng.stats()
    handles = (streamed, doomed, *rest)
    toks = sum(len(h.tokens) for h in handles)
    print(f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s incl. "
          f"prefill)")
    print(f"pool: {stats['used_blocks']}/{stats['num_blocks']} blocks used "
          f"after drain, paged {stats['cache_bytes'] / 1e6:.2f}MB vs "
          f"dense-equivalent {stats['dense_bytes_equivalent'] / 1e6:.2f}MB, "
          f"{stats['steps']} decode steps")
    return {"handles": {h.request.request_id: h for h in handles},
            "streamed": got, "stats": stats, "seconds": dt}


def run(args: argparse.Namespace) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    dev = device_for(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = T.init_params(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    if args.engine == "paged":
        return run_paged(cfg, params, args, rng, dev)
    return run_dense(cfg, params, args, rng, dev)


def main(argv=None) -> int:
    run(build(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
