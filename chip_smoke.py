#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX or of the JAX
package ``repro``, and fails (non-zero exit, no result line) without a CUDA
device or without the port beside it. Any failure raises. Phases:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of the kernels from ``src/repro_torch/csrc``.
2. Each of the four CUDA kernels of the DCT-AdamW step against its plain
   PyTorch version, on the card, at the main path's shapes: G of
   (24, 1024, 1024) and (24, 2816, 1024) with a planted spectrum, r = 128.
   Times are per training step (4 launches at the first shape, 3 at the
   second, as the seven matrix leaves of llama-350m give), from CUDA events.
   Then one fused-"on" optimizer update of a square and a transposed leaf
   against the reference path ("off") on the card.
3. The main path: ``repro_torch.launch.train`` with llama-350m at full width
   and depth, DCT-AdamW, rank 128, 6 steps of batch 8 x 512 (the CLI's
   default batch of 64 is cut to 8 to stay inside the time and memory
   limits; no microbatching). The launch counters are zeroed just before it
   and read just after: each kernel must have run 7 times per step.
4. Where a step of that configuration goes: its parts timed alone, then one
   step under ``torch.profiler`` (device time by kernel, idle share).
5. The ``kernels`` line, the card's line, and last:
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TRAIN_ARGV = ["--arch", "llama-350m", "--optimizer", "dct_adamw",
              "--rank", "128", "--steps", "6", "--warmup", "2",
              "--batch", "8", "--seq-len", "512", "--log-every", "1"]
STEPS, BATCH, SEQ = 6, 8, 512
LAYERS, RANK = 24, 128
# (oriented G shape, launches per step): wq/wk/wv/wo, then wg/wu/wd
MAIN_SHAPES = (((LAYERS, 1024, 1024), 4), ((LAYERS, 2816, 1024), 3))
LAUNCHES_PER_STEP = sum(k for _, k in MAIN_SHAPES)
# NVIDIA H100 SXM data sheet: HBM bandwidth and fp32 (non-tensor) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
TIMED_ITERS = 10


def _device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, iters: int = TIMED_ITERS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _planted(shape, q, gen):
    """G whose projection S = G @ Q has RANK planted columns per layer, 8x
    larger than the rest, so the top-r selection has a clear margin."""
    import torch
    *batch, m, n = shape
    s = torch.randn(shape, generator=gen, device=q.device)
    big = torch.rand((*batch, n), generator=gen, device=q.device
                     ).argsort(dim=-1)[..., :RANK]
    col_scale = torch.full((*batch, n), 0.125, device=q.device)
    col_scale.scatter_(-1, big, 1.0)
    return (s * col_scale[..., None, :]) @ q.T


def check_kernels(torch, dev) -> dict:
    """Phase 2. Returns ``{name: row}`` with the numbers of the kernels line
    (``launches`` is filled in by the main path)."""
    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.selection import select_top_r, take_columns
    from repro_torch.kernels import colgather_matmul as cg
    from repro_torch.kernels import dct_project as dp
    from repro_torch.kernels import quant_ef as qe

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0}
            for name in ("dequant_add_ef", "dct_project",
                         "colgather_matmul_dual", "quantize_ef")}
    rows["quantize_ef"]["library_ms"] = None
    rows["colgather_matmul_dual"]["library_ms"] = None

    def acc(name, per_step, err, kernel_ms, plain_ms, library_ms,
            nbytes, flops):
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += per_step * kernel_ms
        row["plain_ms"] += per_step * plain_ms
        if library_ms is not None:
            row["library_ms"] += per_step * library_ms
        row["bytes"] += per_step * nbytes
        row["flops"] += per_step * flops

    for shape, per_step in MAIN_SHAPES:
        nb, m, n = shape
        e = nb * m * n
        q = dct2_matrix(n, device=dev)
        qt = q.T.contiguous()
        g = _planted(shape, q, gen)
        # a zero row and a subnormal row: the cases the F32_TINY clamp is for
        g[0, 0] = 0.0
        g[0, 1] = 1e-40

        # dct_project: S and norms
        s_k, n_k = dp.dct_project(g, q)
        s_p, n_p = dp.dct_project_plain(g, q)
        torch.cuda.synchronize()
        err = (s_k - s_p).abs().max().item()
        assert err <= 1e-5 * s_p.abs().max().item(), \
            f"dct_project S {shape}: max |dS| {err}"
        norm_rel = ((n_k - n_p).abs() / n_p.clamp_min(1e-30)).max().item()
        assert norm_rel <= 1e-5, f"dct_project norms {shape}: rel {norm_rel}"
        idx_k = select_top_r(n_k, RANK)
        idx_p = select_top_r(n_p, RANK)
        assert torch.equal(idx_k, idx_p), f"top-r differs {shape}"
        acc("dct_project", per_step, err,
            _time_ms(lambda: dp.dct_project(g, q)),
            _time_ms(lambda: dp.dct_project_plain(g, q)),
            _time_ms(lambda: torch.matmul(g, q)),
            4.0 * (2 * e + n * n + nb * n), 2.0 * e * n + 2.0 * e)
        print(json.dumps({"kernel": "dct_project", "shape": list(shape),
                          "max_abs_err_S": err, "max_rel_err_norms": norm_rel,
                          "top_r_equal": True}), flush=True)

        # colgather_matmul_dual on the selected columns
        b1 = take_columns(s_k, idx_k).contiguous()
        b2 = torch.randn(b1.shape, generator=gen, device=dev)
        o_k = cg.colgather_matmul_dual(b1, b2, qt, idx_k)
        o_p = cg.colgather_matmul_dual_plain(b1, b2, qt, idx_k)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(o_k, o_p))
        ref = max(b.abs().max().item() for b in o_p)
        assert err <= 1e-5 * ref, f"colgather_matmul_dual {shape}: {err}"
        # bytes: b1, b2, the indices, the rows of Q^T this run selects (each
        # distinct row once, whichever layers share it) and both outputs
        rows_needed = torch.unique(idx_k).numel()
        acc("colgather_matmul_dual", per_step, err,
            _time_ms(lambda: cg.colgather_matmul_dual(b1, b2, qt, idx_k)),
            _time_ms(lambda: cg.colgather_matmul_dual_plain(b1, b2, qt, idx_k)),
            None,
            4.0 * (2 * nb * m * RANK + rows_needed * n + nb * RANK + 2 * e),
            2 * 2.0 * nb * m * n * RANK)
        print(json.dumps({"kernel": "colgather_matmul_dual",
                          "shape": list(shape), "max_abs_err": err,
                          "max_abs_out": ref}), flush=True)

        # quantize_ef of the residual, then dequant_add_ef back onto G
        resid = g - o_k[1]
        q_k, sc_k = qe.quantize_ef(resid)
        q_p, sc_p = qe.quantize_ef_plain(resid)
        torch.cuda.synchronize()
        dq = (q_k.int() - q_p.int()).abs().max().item()
        assert torch.equal(sc_k, sc_p), f"quantize_ef scales {shape}"
        assert dq <= 1, f"quantize_ef payload {shape}: max |dq| {dq}"
        acc("quantize_ef", per_step, float(dq),
            _time_ms(lambda: qe.quantize_ef(resid)),
            _time_ms(lambda: qe.quantize_ef_plain(resid)), None,
            5.0 * e + 4.0 * nb * m, 5.0 * e)
        print(json.dumps({"kernel": "quantize_ef", "shape": list(shape),
                          "max_abs_dq": dq, "scales_equal": True,
                          "payload_equal": dq == 0}), flush=True)

        out_k = qe.dequant_add_ef(g, q_k, sc_k)
        out_p = qe.dequant_add_ef_plain(g, q_k, sc_k)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        assert err == 0.0, f"dequant_add_ef {shape}: {err}"
        qf = q_k.float()
        acc("dequant_add_ef", per_step, err,
            _time_ms(lambda: qe.dequant_add_ef(g, q_k, sc_k)),
            _time_ms(lambda: qe.dequant_add_ef_plain(g, q_k, sc_k)),
            _time_ms(lambda: torch.addcmul(g, qf, sc_k)),
            9.0 * e + 4.0 * nb * m, 2.0 * e)
        print(json.dumps({"kernel": "dequant_add_ef", "shape": list(shape),
                          "max_abs_err": err}), flush=True)
        del g, s_k, s_p, o_k, o_p, resid, q_k, q_p, out_k, out_p, qf
        torch.cuda.empty_cache()
    return rows


def check_fused_update(torch, dev) -> None:
    """Phase 2b: one projected-Adam leaf through the kernels ("on") against
    the reference path ("off") on the card, two steps, for a square leaf and
    one that orients by transposing (wq- and wg-shaped)."""
    from repro_torch.core.transforms import shared_basis
    from repro_torch.optim.common import Context
    from repro_torch.optim.projected_adam import ProjectedAdamRule
    from repro_torch.optim.transform import transposed

    (square, _), ((nb, m, n), _) = MAIN_SHAPES
    q = shared_basis("dct", n, device=dev)
    ctx_b = {str(n): q}
    for shape in (square, (nb, n, m)):
        gen = torch.Generator(device=dev).manual_seed(1)
        oriented = shape if shape[-1] <= shape[-2] else \
            (shape[0], shape[2], shape[1])
        grads = []
        for _ in range(2):
            g = _planted(oriented, q, gen)
            grads.append(g if oriented == shape else
                         g.transpose(-1, -2).contiguous())
        out = {}
        for mode in ("on", "off"):
            rule = ProjectedAdamRule(rank=RANK, fused=mode)
            state = rule.init(shape, torch.float32, dev)
            for step, g in enumerate(grads, 1):
                ctx = Context(step=step, bases=ctx_b,
                              bases_t=transposed(ctx_b))
                d, state = rule.update(g, state, None, ctx)
            out[mode] = (d, state.proj)
        torch.cuda.synchronize()
        (d_on, idx_on), (d_off, idx_off) = out["on"], out["off"]
        assert torch.equal(idx_on, idx_off), f"fused update indices {shape}"
        err = (d_on - d_off).abs().max().item()
        ref = d_off.abs().max().item()
        assert math.isfinite(err) and err <= 1e-4 * ref, \
            f"fused update {shape}: max |dD| {err} vs max |D| {ref}"
        print(json.dumps({"fused_update_vs_reference": list(shape),
                          "steps": 2, "indices_equal": True,
                          "max_abs_err": err, "max_abs_update": ref}),
              flush=True)


def run_main_path(torch):
    """Phase 3: the training CLI's code path, counters zeroed just before."""
    from repro_torch.core import fused_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    assert fused_step.resolve("auto", "cuda") == "on"
    args = train_cli.build(TRAIN_ARGV)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_cli.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hist = trainer.metrics_history
    assert len(hist) == STEPS, hist
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), losses
    for name, n in counts.items():
        assert n == LAUNCHES_PER_STEP * STEPS, \
            f"{name}: {n} launches in {STEPS} steps, expected " \
            f"{LAUNCHES_PER_STEP * STEPS}"
    ms_step = sum(h["s_per_step"] for h in hist[1:]) / (STEPS - 1) * 1e3
    summary = {
        "main_path": "llama-350m dct_adamw rank 128 fused auto->on",
        "steps": STEPS, "batch": BATCH, "seq_len": SEQ,
        "losses": losses,
        "first_step_ms": hist[0]["s_per_step"] * 1e3,
        "ms_per_step_after_first": ms_step,
        "tokens_per_s": BATCH * SEQ / (ms_step / 1e3),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "wall_s": wall,
        "launches": counts,
        "launches_per_step": {k: v / STEPS for k, v in counts.items()},
    }
    print(json.dumps(summary), flush=True)
    return counts


def time_breakdown(torch, dev) -> None:
    """Phase 4: where one step of the main path's configuration goes. The
    step's parts are timed alone with CUDA events (the step is functional,
    so a part can be repeated on the same state), then one whole step runs
    under ``torch.profiler`` for the device time by kernel and the device's
    idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train import steps as S
    from repro_torch.train.schedule import cosine_warmup

    cfg = get_config("llama-350m")
    opt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, STEPS),
                        rank=RANK, weight_decay=0.01)
    state = S.init_state(cfg, opt, 0, dev)
    batch = make_batch_fn(cfg, SEQ, BATCH, device=dev)(0)
    step = S.make_train_step(cfg, opt)
    state, _ = step(state, batch)
    grads, _ = S.grad_fn(state.params, batch, cfg)
    grads, _ = S._clip_by_global_norm(grads, 1.0)
    parts = {
        "step_ms": _time_ms(lambda: step(state, batch), 3),
        "forward_backward_ms": _time_ms(
            lambda: S.grad_fn(state.params, batch, cfg), 3),
        "optimizer_update_ms": _time_ms(
            lambda: opt.update(grads, state.opt_state, state.params), 3),
    }
    del grads
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    print(json.dumps({
        "time_breakdown": parts,
        "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "top_device_kernels": [{"name": e.key[:90], "ms": dev_us(e) / 1e3,
                                "count": e.count} for e in top],
    }), flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_lib

    print(_device_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    t0 = time.perf_counter()
    cuda_lib.library()
    print(json.dumps({"kernel_build_s": time.perf_counter() - t0}), flush=True)
    print("\n".join(line for line in cuda_lib.build_log().splitlines()
                    if "registers" in line or "Compiling entry" in line))

    rows = check_kernels(torch, dev)
    check_fused_update(torch, dev)
    counts = run_main_path(torch)
    time_breakdown(torch, dev)

    sources = {"dequant_add_ef": ("quant_ef.cu", "src/repro/kernels/quant_ef.py:44"),
               "dct_project": ("dct_project.cu", "src/repro/kernels/dct_project.py:63"),
               "colgather_matmul_dual": ("colgather_matmul.cu",
                                         "src/repro/kernels/colgather_matmul.py:80"),
               "quantize_ef": ("quant_ef.cu", "src/repro/kernels/quant_ef.py:32")}
    kernels = []
    for name, row in rows.items():
        bound, by = _bound_ms(row["bytes"], row["flops"])
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": row["library_ms"],
            "launches_per_step": counts[name] / STEPS,
            "times_are": "per training step at the main path's shapes",
        })
    device_line = _device_line()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(device_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
