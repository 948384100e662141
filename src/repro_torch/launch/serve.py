"""Serving driver: paged continuous batching or the dense fixed batch.

  python -m repro_torch.launch.serve --arch llama-350m --engine paged \
      [--batch 4] [--prompt-len 12] [--new-tokens 16] [--block-size 8] \
      [--prefill-chunk 8] [--num-splits 2] [--smoke] [--device cpu] \
      [--metrics [--metrics-dir DIR]]

Runs on the CUDA card by default and raises if there is none; ``--device
cpu`` runs on the CPU (the tests). The weights are random, from
``init_params`` with ``--seed``; no weights are downloaded.

``--engine paged`` (the default): two tenant sessions submit staggered
requests with different sampling parameters into a block-pool KV cache; the
continuous-batching scheduler admits and retires them between decode steps,
whose attention is the ``flash_decode`` kernel on the card. One request
streams token by token, one is admitted mid-flight, one is cancelled, and
the pool's stats are printed at the end, with the serving kernels' launch
counts of the run (``flash_decode`` on the card, 0 on the CPU).

``--metrics`` (paged engine only) enables the obs layer (``repro_torch.
obs``) before the engine is built: at the end it prints the per-request
latency table (queue wait, TTFT, mean ITL, E2E, from each handle's
timestamps), TTFT and ITL p50 / p99 from the registry's histograms, and
writes a Prometheus text snapshot ``metrics.prom`` and a Chrome trace
``trace.json`` under ``--metrics-dir`` (default: ``build/serve_metrics``
of the checkout).

``--engine dense``: one prefill and decode steps over a dense cache for a
batch of prompts.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.devices import resolve_device

DEFAULT_METRICS_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "serve_metrics"


def build(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-350m",
                    help="one of repro_torch.configs.registry.list_archs(): "
                         "the llamas, gemma3-27b, qwen2.5-32b, "
                         "phi3-mini-3.8b, command-r-plus-104b")
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
    ap.add_argument("--metrics", action="store_true",
                    help="enable the obs layer (paged engine only): "
                         "per-request latency table + Prometheus snapshot "
                         "+ Chrome trace under --metrics-dir")
    ap.add_argument("--metrics-dir", default=str(DEFAULT_METRICS_DIR))
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
    from repro_torch.kernels import ops
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
    launches = ops.launch_counts(ops.SERVING)
    print("kernel launches: " + ", ".join(f"{k}={n}"
                                          for k, n in launches.items()))
    out = {"handles": {h.request.request_id: h for h in handles},
           "streamed": got, "stats": stats, "seconds": dt,
           "launches": launches}
    if args.metrics:
        out["metrics"] = report_metrics(args.metrics_dir, handles)
    return out


def _fmt(v, spec: str) -> str:
    # a request cancelled before admission has no queue wait or TTFT
    return format(v, spec) if v is not None else "-"


def report_metrics(metrics_dir: str, handles) -> dict:
    """The ``--metrics`` report of a paged run: the per-request latency
    table, TTFT / ITL p50 and p99 from the registry's histograms, and
    ``metrics.prom`` and ``trace.json`` written under ``metrics_dir``.
    Returns the quantiles and the two paths."""
    from repro_torch import obs

    print("\nper-request latency (seconds; quantized to decode steps):")
    print(f"  {'request':<22} {'finish':<10} {'toks':>4} {'queue':>7} "
          f"{'ttft':>7} {'itl_mean':>8} {'e2e':>7}")
    for h in handles:
        s = h.latency_summary()
        print(f"  {s['request_id']:<22} {s['finish_reason']:<10} "
              f"{s['n_tokens']:>4} {_fmt(s['queue_wait'], '.3f'):>7} "
              f"{_fmt(s['ttft'], '.3f'):>7} {_fmt(s['itl_mean'], '.4f'):>8} "
              f"{_fmt(s['e2e'], '.3f'):>7}")
    r = obs.registry()
    ttft, itl = r.get("serve_ttft_seconds"), r.get("serve_itl_seconds")
    q = {"ttft_p50": ttft.quantile(0.5), "ttft_p99": ttft.quantile(0.99),
         "itl_p50": itl.quantile(0.5), "itl_p99": itl.quantile(0.99)}
    print(f"ttft p50/p99: {q['ttft_p50']:.3f}/{q['ttft_p99']:.3f}"
          f"  itl p50/p99: {q['itl_p50']:.4f}/{q['itl_p99']:.4f}")
    os.makedirs(metrics_dir, exist_ok=True)
    prom = obs.write_prometheus(os.path.join(metrics_dir, "metrics.prom"))
    trace = obs.write_chrome_trace(os.path.join(metrics_dir, "trace.json"))
    print(f"wrote {prom} and {trace}")
    return {**q, "prometheus": prom, "trace": trace}


def run(args: argparse.Namespace) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    if args.metrics:
        if args.engine != "paged":
            raise SystemExit("--metrics instruments the paged engine; "
                             "use --engine paged")
        from repro_torch import obs
        obs.enable()
    dev = resolve_device(args.device)
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
