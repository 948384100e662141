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
   ``dct_project`` is launched twice (S and norms bit-identical) and timed
   beside ``torch.matmul(g, q)``; ``colgather_matmul_dual`` twice (the same
   bits), timed beside the gather and ``torch.matmul`` of the stacked
   operands (three calls, no library time). Times are per training step
   (4 launches at the first shape, 3 at the second, as the seven matrix
   leaves of llama-350m give), from CUDA events.
   Then one fused-"on" optimizer update of a square and a transposed leaf
   against the reference path ("off") on the card.
3. The main path: ``repro_torch.launch.train`` with llama-350m at full width
   and depth, DCT-AdamW, rank 128, 6 steps of batch 8 x 512 (the CLI's
   default batch of 64 is cut to 8 to stay inside the time and memory
   limits; no microbatching). The launch counters are zeroed just before it
   and read just after: each kernel must have run 7 times per step.
4. Where a step of that configuration goes: its parts timed alone, then one
   step under ``torch.profiler`` (device time by kernel, idle share).
5. The ``flash_decode`` kernel of serving against its plain version on the
   card, each launched twice (bit-identical): (a) llama-350m's shapes (8
   slots, 16 heads of 64, block 16, bf16 pools, lengths 1-2048, 1, 2, 4,
   16 and 128 splits), (b) a GQA shape (32 / 8 heads of 128) and
   gemma3-27b's local layer (32 / 16 heads of 128, window 1024), all on
   the 16-byte path, (c) edge cases on the scalar path (group 8/1, fp32
   pools, odd head dims 17 and 31), a sliding window, a length-0 row that
   must be exactly zero, pool blocks outside every table poisoned with NaN
   without changing the output. Times are per decode step of the serving
   path (24 launches at shape (a), 2 splits) as device time of CUDA-graph
   replays (the kernels take less time than the wrapper's host work;
   eager times beside them), with the time per call at 1-128 splits and
   SDPA on the densified K/V timed the same way.
6. The serving path: ``PagedServeEngine`` with llama-350m at full width and
   depth, bf16, random weights: 8 slots, block 16, 128 blocks per
   sequence, 16 requests of prompts 64-1024 and 64 new tokens admitted as
   slots free, prefill chunk 128, 2 splits. The launch counters are zeroed
   just before it and read just after: ``flash_decode`` must have run 24
   times per decode step, every layer's pools on the 16-byte path. A
   greedy and a sampled request are then rerun alone on the same engine
   and must give the same tokens. Then five decode steps under
   ``torch.profiler``.
7. The kernels of the momentum families against their plain versions on
   the card: the Newton-Schulz gram and apply kernels, one iteration and
   the whole 5-step orthogonalization at Trion's factor shapes (wide
   (24, 128, 1024) and (24, 128, 2816)) and at ragged ones (r = 17, 45),
   each launch twice (bit-identical, and the Gram exactly symmetric), and
   the Gram alone at ``GRAM_RAGGED`` (r = 8-512, m of 1, 37, 333, 700,
   1030); the
   single-operand ``colgather_matmul`` at (24, 1024 | 2816, 128), relaunched
   bit-identical and equal to the dual's first output. Times are
   per training step of Trion (35 NS launches of each kernel) and of
   subspace Muon (7 back-projections); ``ns_gram`` / ``ns_apply`` and
   ``torch.bmm`` / ``torch.baddbmm`` are also timed as CUDA-graph replays
   of a step's launches of each shape (the kernels take ~10-50 us a call,
   which the wrappers' host work rivals), and those replays are their
   rows' times (eager beside them).
8. Trion, the training CLI's default optimizer: ``repro_torch.launch.train``
   with llama-350m at full width and depth, its defaults (rank 128, fused
   auto) and 6 steps of batch 8 x 512, the counters zeroed just before and
   read just after (per step: 7 ``dct_project``, 35 ``ns_gram``, 35
   ``ns_apply``, 7 ``colgather_matmul_dual``, no other kernel); then where
   a Trion step goes, as in phase 4.
9. Subspace Muon (``--rank 128``), Dion, and Dion on its QR route
   (``--fused off``) and on the plain NS iteration (``--fused fft``), no
   kernel on either, 3 steps each, and full-space Muon, 2
   steps, at full width and depth, each with its launch counts (full-space
   Muon's NS runs the plain iteration: its short side of 1024 is past
   ``NS_KERNEL_MAX_RANK``, and past the apply kernel's envelope).
10. The bf16 and int8 variants of ``dct_project`` and of the single and
   dual ``colgather_matmul`` against their plain versions at the main
   path's shapes: int8 bit-equal (exact integer sums, the same epilogue),
   the int8 ``dct_project``'s quantizer kernels (``quant_rows_q8`` of G,
   ``quant_cols_q8t`` of Q, codes written as Q^T's) bit-equal to
   ``lowp.quant_rows`` / ``quant_cols``, the int8 colgathers' (``quant_qt_q8``
   of Q^T, ``quant_fold_q8`` of both b) to ``quantize_operands_plain``, the
   int8 and bf16 ``dct_project``
   relaunched bit-identical, the bf16 ``dct_project`` and colgathers (all
   on the tensor cores) within ``LOWP_TC_RTOL`` of max |out| and relaunched
   bit-identical (the single colgather equal to the dual's first output),
   the norms of each giving the top-128 of the planted
   spectrum that fp32 gives, each precision within ``LOWP_ERROR_BOUNDS`` of
   fp32. Times per DCT-AdamW step: the kernel alone on quantized operands
   and the wrapper with its operand quantization, bounds at the
   precision's peak; library times the bf16 GEMM with an fp32 result and
   ``torch._int_mm`` on the int8 codes; the quantizers as device time of
   CUDA-graph replays (eager beside). Beside the bf16 colgathers, a
   yardstick that is no single call (so no library time): the gather and
   cuBLAS, ``torch.matmul(b.bfloat16(), qt[idx].bfloat16())``.
11. DCT-AdamW's precisions and bases at full width and depth, 3 steps each,
   the counters zeroed just before and read just after each: ``--compute-
   dtype int8`` (7 ``dct_project_q8``, 7 ``quant_rows_q8``, 7
   ``quant_cols_q8t``, 7 ``colgather_matmul_dual_q8``, 7 ``quant_qt_q8``, 7
   ``quant_fold_q8``, 7 of each EF kernel per step, no fp32 projection),
   ``--compute-dtype bf16``, the API with ``error_feedback=False`` in int8
   (7 ``colgather_matmul_q8`` with its two quantizers, no EF kernel) and in
   bf16, ``--basis hadamard`` (the fp32 kernels) and
   ``--basis hadamard --fused fft`` (no kernel). Each step-1 loss must
   equal phase 3's: the same seed gives the same weights and batch. Then
   where an int8 step goes, as in phase 4, its launch count beside
   ``INT8_STEP_LAUNCHES_BEFORE``, and where a bf16 step goes.
12. The dense attention kernels against their plain versions on the card,
   each launched twice (bit-identical), at (a) llama-350m's prefill (8 x
   512, 16 / 16 heads of 64, causal, bf16, kv chunk 512), (b) a gemma3-27b
   local layer (2 x 2048, 32 / 16 heads of 128, window 1024, bf16, kv chunk
   1024), (c) a global one (the same, causal): ``flash_attention`` (the TPU
   kernel's function, on its route's fp32 inputs) within ``FA_TOL_F32``,
   timed beside fp32 SDPA and its fp32 bounds (bytes at 4 B an element,
   operations at the TF32 rate over 3 passes and at the SIMT rate), with
   edge cases in bf16 (upcast; within ``FA_TOL_F32`` plus one bf16 ulp) at
   llama-350m's shape, group 5, head dims 96 and 17, S = 1 and 777, a
   window of 1;
   ``flash_attention_blockwise`` (the JAX model's function, the bf16
   prefill's route) at the model's bar (max |d| <= 4e-3 max |out|, >= 99%
   bit-equal), with edge cases head dims 96, 16 and 256, S = 1 and 777,
   chunks of 100 under a window of 50 (fully masked first chunks), group 5.
   Times per call of (a)-(c), each beside its bound and
   ``scaled_dot_product_attention`` (``enable_gqa``; the window as a
   boolean mask) on the same tensors (fp32 for ``flash_attention``, bf16
   for ``flash_attention_blockwise``).
13. The dense prefill path, counters zeroed just before each run and read
   just after: ``ServeEngine`` with llama-350m at full width and depth,
   bf16, 8 prompts x 512, 16 new tokens (24 ``flash_attention_blockwise``
   launches in its one prefill and no other kernel), and with gemma3-27b at
   full width, depth cut from 62 to 8 layers (one repeat of each schedule
   segment: 7 local, 1 global), bf16, random weights, 2 prompts x 2048, 32
   new tokens (8 launches); then llama-350m with fp32 compute, 2 prompts x
   512 (24 ``flash_attention`` launches: the fp32 route). Each prefill's
   last logits are held to the same forward through the plain chunked loop
   within ``PREFILL_LOGITS_RTOL``, top-1 equal, beside the floor of that
   measure (the plain route with ``FLOOR_SHARE`` of layer 0's attention
   outputs moved by one ulp), and each layer's kernel output to the loop's
   on that layer's own inputs (bf16 within ``LAYER_MAX_ULPS`` bf16 ulps of
   max |out| and >= 99% bit-equal, fp32 within ``FA_TOL_F32`` of max
   |out|). Then
   ``PagedServeEngine`` with the same gemma3-27b: 4 slots, block 16, 6
   prompts of 512-2048 tokens, 32 new tokens, prefill chunk 256: 8
   ``flash_decode`` launches per decode step (the local layers with their
   window) and no dense attention kernel; a greedy request rerun alone
   gives the same tokens. One prefill of each
   dense configuration runs under ``torch.profiler``. The training phases
   (3, 8, 9, 11) and the paged runs launch neither attention kernel.
14. The paper's baselines at full width and depth, 3 steps each of batch
   8 x 512, rank 128, through ``repro_torch.launch.train``, the counters
   zeroed just before each run and read just after: ``--optimizer
   ldadamw``, ``galore``, ``frugal``, ``fira`` (SVD) and ``adamw`` launch no
   kernel; ``galore --basis dct`` launches 7 ``dct_project`` in the run (T_u
   200: step 1 refreshes, steps 2-3 keep) and 7 ``colgather_matmul`` per
   step, ``frugal`` / ``fira --basis dct`` 7 ``dct_project`` and 7
   ``colgather_matmul_dual`` per step; FRUGAL with ``projector="random"``
   and ``"randperm"`` through the API launches none. No other kernel runs.
   Each run's step-1 loss must equal phase 3's, its losses be finite; it
   prints its peak device memory and the Trainer's time of the refresh
   step (step 1) and of a keep step (mean of steps 2-3). Then, through the
   API on one gradient of llama-350m, each preset's optimizer state in
   bytes (projector state, shared bases and their transposes, moments, EF,
   full-rank Adam; DCT-AdamW beside them) and the time of a refresh update
   and of a keep update alone (CUDA events). Then the dense refresh on the
   card against float64 on the CPU: a leaf of (24, 1024, 1024) with planted,
   well separated singular values (numpy, from ``--seed``): GaLore's SVD
   basis and LDAdamW's one power-iteration step from ``eye(n, r)`` must
   span the float64 reference's subspace (every singular value of
   ``Q_card^T Q_ref``, and of ``Q_card`` made orthonormal in float64, >= 1
   - ``DENSE_SPAN_TOL``; ``|Q_card^T Q_card - I|`` <= ``DENSE_ORTHO_TOL``);
   the SVD and power refreshes are timed at (24, 1024, 1024) and (24,
   2816, 1024). The phase's wall time is printed.
15. The training substrate at the main path's configuration, through
   ``repro_torch.launch.train`` (its ``run`` in this process, the counters
   zeroed just before each run and read just after: 7 launches of each of
   the four kernels per step): (a guard) 6 steps without and with
   ``--resilient`` in turns (plain, resilient, resilient, plain), every
   run's losses equal to phase 3's bit for bit; s_per_step and peak memory
   of each. (a) ``--resilient --ckpt-dir --ckpt-every 2 --obs-dir``,
   stopped after step 4 as a preemption would (the schedule still spans 6
   steps), then a second run that resumes from step 4: steps 1-6 equal
   phase 3's losses bit for bit; the mean data wait, dispatch and host
   sync of a step and the checkpoint's bytes, snapshot, write and restore
   seconds from the run's ``metrics.prom``. (b) Through the API, a chaos
   NaN on one data step: the guarded step refuses with the four kernels
   launched (7 each) and every tensor of the pre-step state, cloned, is
   bit-equal to the state after it. (d) NaN on every batch exhausts the
   ladder: the CLI returns 86 and writes ``halt.json``. (c) ``--supervise``
   with a checkpoint ``sigkill`` at ``mid_write`` of step 4, in fresh
   processes at full width and depth: the supervisor restarts the child,
   which resumes from step 2 and finishes. The checkpoints (2.6 GB each,
   two on disk at most) live under ``build/chip_smoke_substrate`` and are
   deleted at the end.
16. Subspace telemetry and closed-loop control at the main path's
   configuration: (a) ``--telemetry jsonl --telemetry-every 2`` through
   the CLI, the counters zeroed just before and read just after: losses
   equal to phase 3's bit for bit, 7 launches of each of the four kernels
   per step, every row finite with captured energy in [0, 1]; then one
   step and the Trainer's host conversion of its metrics under the
   profiler without and with telemetry, in turns: the kernels and device
   time telemetry adds, and exactly one more device -> host copy. (b) The
   rule's captured energy of a real ``mlp/wg`` gradient (oriented (24,
   2816, 1024)) on the kernel path within ``ENERGY_RTOL`` of float64
   numpy's ||G Q_r||^2 / ||G||^2. (c) The closed loop through the API: a
   ``RankAllocator`` (deadband 0, decide every 2 steps) drives
   ``AdaptiveOptimizerManager`` for 6 steps: at least one rebuild to a
   non-uniform allocation within the weighted budget, each leaf's moments
   shaped (24, rows, r_leaf), 7 launches of each kernel every step (after
   a rebuild too), finite losses, steps 1-2 equal to phase 3's; peak
   memory against phase 3's and each rebuild's own, the basis cache's hits
   and misses; then the four kernels against their plain versions at an
   allocated rank off a multiple of 16, fp32 and int8. (d)
   ``--adaptive-refresh --control-every 2`` through the CLI at rank 128
   and at rank 1024 (every column: no drift, so the intervals double and
   keep steps follow): keep steps report the -1 sentinels, ``dct_project``
   runs once per leaf and refresh step, the other kernels 7 a step. (e)
   (c) with checkpoints every 2 steps, stopped after step 4 and resumed by
   a new manager: the losses equal to (c)'s bit for bit. Its files live
   under ``build/chip_smoke_telemetry`` and are deleted at the end. The
   phase's wall time is printed.
17. The dense configurations of the JAX registry at full width on random
   weights (``--seed`` of the CLIs' default 0), bf16 compute: qwen2.5-32b
   (qkv bias, 40 / 8 heads: group 5), phi3-mini-3.8b (32 / 32 heads of 96)
   and command-r-plus-104b (96 / 8 heads: group 12). (a) The kernels at
   their shapes against their plain versions, each launched twice
   (bit-identical): ``flash_decode`` on the 16-byte path (4 slots, block
   16, lengths 512-2080, 1 and 2 splits, q in fp32 and bf16) at the bar of
   phase 5, and ``flash_attention_blockwise`` at each model's prefill (2 x
   2048, causal, kv chunk 1024) at the model's bar; each timed per call
   beside its bound and SDPA on the same tensors. (b) Serving, the
   counters zeroed just before each run and read just after: the dense
   ``ServeEngine`` (2 prompts x 2048, 32 new tokens; ``depth``
   ``flash_attention_blockwise`` launches per prefill, nothing else) with
   phase 13's checks (last logits against the plain loop within
   ``PREFILL_LOGITS_RTOL`` beside the floor, each layer's kernel output
   against the loop on its own inputs, a rerun equal), and
   ``PagedServeEngine`` as gemma3-27b's in phase 13 (``depth``
   ``flash_decode`` launches per decode step; a solo rerun equal). Depths
   (``CONFIG_SERVE_DEPTHS``): qwen2.5-32b cut from 64 to 8 layers,
   phi3-mini-3.8b at its full 32, command-r-plus-104b cut from 64 to 4
   (its untied 256000 x 12288 embedding and unembedding are 6.3 GB of the
   25.2). (c) Training through ``repro_torch.launch.train`` (its ``run``
   in this process; a cut depth by the registry's entry, the CLI has no
   depth flag): DCT-AdamW, rank 128, 3 steps: phi3-mini-3.8b at full width,
   depth cut from 32 to 24 (at 32 a step runs out of memory), batch 8 x
   512 (fp32 parameters), and qwen2.5-32b at full width, depth cut to 2,
   batch 2 x 512 (bf16 parameters with the qkv bias): 7 launches of each
   of the four kernels per step, finite losses, step time and peak memory;
   then phi3-mini-3.8b's optimizer update alone at depth 24 on one
   gradient (no Trainer, no new parameters), timed and under the profiler
   (its device time by kernel). The phase's wall time is printed.
18. The rest of the transform-chain runtime, llama-350m at full width and
   depth, phase 3's batch and seed: (a) DCT-AdamW through the legacy
   harness ``optim.common.make_matrix_optimizer`` in ``make_train_step``
   for 3 steps, the counters zeroed just before each step and read just
   after (7 launches of each of the four kernels): the losses equal to
   phase 3's, and each step's parameters equal to those of the chain
   preset ``get_optimizer("dct_adamw")`` stepped beside it, bit for bit;
   (b) ``core.fused_step.set_default_fused_mode``: "off" gives a step with
   no launch of the four kernels, "fft" one with no ``dct_project`` (each
   twice from the same state: the first of a mode builds the libraries'
   plans; the step-1 loss still phase 3's), and the default is put back;
   (c)
   ``fullrank_weight_decay=False`` with weight decay 0.1: the chain and the
   harness agree bit for bit for one step; (d) each ``kernels.ops.*_op``
   alias of the JAX package's dispatchers at the main path's shapes (the
   serving and prefill ones at phase 5's and phase 13's) adds one to its
   kernel's counter (``newton_schulz_op`` five of each NS kernel) and
   equals the direct wrapper call bit for bit; (e) ``python -m
   repro_torch.launch.serve --arch llama-350m --engine paged --metrics
   --metrics-dir DIR`` as a subprocess: exit 0, ``flash_decode`` launched
   (its printed count), ``metrics.prom`` parsed with
   ``serve_ttft_seconds_count`` equal to the requests that produced a
   token, ``trace.json`` with its decode-step spans, TTFT / ITL p50 / p99
   printed. Files under ``build/chip_smoke_runtime``, deleted at the end.
   The phase's wall time is printed.
19. The ``kernels`` line, the card's line, and last:
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import os
import shutil
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
# NVIDIA H100 SXM data sheet: HBM bandwidth, the fp32 (non-tensor) peak and
# the dense tensor-core peaks of bf16 and int8
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_INT8_PER_S = 1979e12
# the TF32 tensor-core peak; an fp32-accurate product by 3xTF32 (hi.hi +
# hi.lo + lo.hi) takes three passes, so its bound runs at a third of it
PEAK_TF32_PER_S = 495e12
TF32_PASSES = 3
TIMED_ITERS = 10

# the momentum families: the CLI's defaults (trion, rank 128, fused auto)
# with the main path's steps, batch and sequence
MOMENTUM_ARGV = ["--arch", "llama-350m", "--warmup", "2", "--batch", "8",
                 "--seq-len", "512", "--log-every", "1"]
NS_STEPS = 5
NS_PER_STEP = NS_STEPS * LAUNCHES_PER_STEP
# (argv, steps, launches per step of each kernel; unnamed kernels 0)
MOMENTUM_PATHS = {
    "trion": ([], STEPS, {"dct_project": LAUNCHES_PER_STEP,
                          "ns_gram": NS_PER_STEP, "ns_apply": NS_PER_STEP,
                          "colgather_matmul_dual": LAUNCHES_PER_STEP}),
    "muon rank 128": (["--optimizer", "muon", "--rank", str(RANK)], 3,
                      {"dct_project": LAUNCHES_PER_STEP,
                       "ns_gram": NS_PER_STEP, "ns_apply": NS_PER_STEP,
                       "colgather_matmul": LAUNCHES_PER_STEP}),
    "dion": (["--optimizer", "dion"], 3,
             {"ns_gram": NS_PER_STEP, "ns_apply": NS_PER_STEP}),
    "muon full space": (["--optimizer", "muon"], 2, {}),
    # witnesses for the "on" route's loss trajectory on the same seed: the
    # QR route, and the NS polar factor through the plain iteration (no
    # kernel on either)
    "dion off": (["--optimizer", "dion", "--fused", "off"], 3, {}),
    "dion fft": (["--optimizer", "dion", "--fused", "fft"], 3, {}),
}
# the kernels against their plain versions, relative to max |out|: the gram
# (m-term sums), the apply and one iteration (r-term sums) in another order
# than cuBLAS
NS_RTOL = 1e-5
# five iterations: the quintic's slope at 0 is a = 3.4445, so a relative
# difference in a small singular direction grows up to a^5 ~ 500x; the JAX
# package holds its Pallas NS to its jnp NS at 1e-3 after 5 steps
NS_FULL_RTOL = 1e-3
# NS5 bands singular values instead of driving them to 1
# (tests/test_newton_schulz_properties.py)
OFFDIAG_TOL, SV_LO, SV_HI = 0.35, 0.3, 1.35
# the Gram alone at other ranks (one to four 32-row blocks; r > 128 on
# several 128-row macro tiles) on ragged m: one column, below one range of
# the kernel's split, off a multiple of 4
GRAM_RAGGED = ((24, 8, 1), (1, 45, 37), (24, 128, 1030), (2, 300, 333),
               (2, 512, 700))

# DCT-AdamW's precisions and bases (phase 11): (CLI argv or API keywords,
# launches per step of each kernel; unnamed kernels 0). Steps: LOWP_STEPS.
LOWP_STEPS = 3
_EF = {"quantize_ef": LAUNCHES_PER_STEP, "dequant_add_ef": LAUNCHES_PER_STEP}
# the int8 dct_project: its kernel and one quantizer launch per operand
_Q8 = {"dct_project_q8": LAUNCHES_PER_STEP, "quant_rows_q8": LAUNCHES_PER_STEP,
       "quant_cols_q8t": LAUNCHES_PER_STEP}
# the int8 colgather's operand quantizers: one launch each per call
_Q8_GATHER = {"quant_qt_q8": LAUNCHES_PER_STEP,
              "quant_fold_q8": LAUNCHES_PER_STEP}
LOWP_PATHS = {
    "int8": (["--compute-dtype", "int8"],
             {**_Q8, "colgather_matmul_dual_q8": LAUNCHES_PER_STEP, **_Q8_GATHER,
              **_EF}),
    "bf16": (["--compute-dtype", "bf16"],
             {"dct_project_bf16": LAUNCHES_PER_STEP,
              "colgather_matmul_dual_bf16": LAUNCHES_PER_STEP, **_EF}),
    "int8 discard": ({"error_feedback": False, "compute_dtype": "int8"},
                     {**_Q8, "colgather_matmul_q8": LAUNCHES_PER_STEP,
                      **_Q8_GATHER}),
    "bf16 discard": ({"error_feedback": False, "compute_dtype": "bf16"},
                     {"dct_project_bf16": LAUNCHES_PER_STEP,
                      "colgather_matmul_bf16": LAUNCHES_PER_STEP}),
    "hadamard": (["--basis", "hadamard"],
                 {"dct_project": LAUNCHES_PER_STEP,
                  "colgather_matmul_dual": LAUNCHES_PER_STEP, **_EF}),
    "hadamard fft": (["--basis", "hadamard", "--fused", "fft"], {}),
}
# the kernel launches of one profiled int8 DCT-AdamW step while the int8
# colgather's operands were quantized by PyTorch ops (commit ee07339;
# NVIDIA H100 80GB HBM3, 700 W): phase 11 prints its own count beside it
INT8_STEP_LAUNCHES_BEFORE = 8495
# the bf16 kernels on the tensor cores (dct_project, the colgathers)
# against their plain versions, relative to max |out|: the same rounded
# operands multiplied exactly, but mma's fp32 accumulation is not a
# sequence of IEEE adds, so the sums part by more than an order of fp32
# adds would. Twice the worst measured over this phase's shapes, the
# dct_project's 1.93e-6 at (24, 2816, 1024) (NVIDIA H100 80GB HBM3, 700 W)
LOWP_TC_RTOL = 4e-6

# serving: llama-350m's attention and the engine's settings
HEADS, HEAD_DIM, BLOCK = 16, 64, 16
SLOTS, MAX_BLOCKS, NUM_SPLITS = 8, 128, 2
SERVE_REQUESTS, NEW_TOKENS, PREFILL_CHUNK = 16, 64, 128
PROMPT_LENS = (64, 1024)
# a flash_decode output in fp32 within this share of max |out| of the plain
# version (sums over up to 2048 keys in another order); in bf16 within that
# plus one bf16 ulp of each element (the fp32 values may round apart)
FD_RTOL_F32 = 2e-6

# dense attention (phase 12): the JAX package's tolerance for its kernel
# against its oracle (tests/test_kernels.py) in fp32; in bf16 that plus one
# bf16 ulp of each element (the last rounding)
FA_TOL_F32 = 3e-5
# the model's function in bf16 (tests/test_torch_layers.py's bar): max |d|
# <= 4e-3 max |out| (about one bf16 ulp of the largest output), at least
# 99% of the elements bit-equal; S and the fp32 sums run in another order
# than the plain loop's cuBLAS products, so a P or an output may round to a
# neighbouring bf16 value
BLOCKWISE_REL_TOL, BLOCKWISE_MIN_EQUAL = 4e-3, 0.99
# (b, s, hq, hkv, hd, window, kv chunk), causal: the prefill shapes of
# llama-350m and of a gemma3-27b local and global layer, with the model's
# kv chunk; flash_attention runs them in fp32 (its route),
# flash_attention_blockwise in bf16 (its route)
FA_CASES = {"a: llama-350m": (8, 512, 16, 16, 64, None, 512),
            "b: gemma3 local": (2, 2048, 32, 16, 128, 1024, 1024),
            "c: gemma3 global": (2, 2048, 32, 16, 128, None, 1024)}
# the dense prefill path (phase 13)
LLAMA_PROMPTS, LLAMA_NEW = (8, 512), 16
LLAMA_F32_PROMPTS = (2, 512)
GEMMA_PROMPTS, GEMMA_NEW = (2, 2048), 32
GEMMA_SLOTS, GEMMA_REQUESTS, GEMMA_CHUNK = 4, 6, 256
GEMMA_PROMPT_LENS = (512, 2048)
# the last logits of a prefill through the kernels against the plain
# chunked loop, relative Frobenius norm. The function is the same (each
# layer's kernel output is held to the loop's on the same inputs at the
# model's bar), but the sums run in another order, and a random-weight
# bf16 forward is chaotic: moving one in 1e5 of layer 0's attention outputs
# by one bf16 ulp in the plain route alone moves its last logits 0.0149
# (llama-350m) and 0.0106 (gemma3 depth 8). The kernel route measured
# 0.0155 and 0.0121 (both on NVIDIA H100 80GB HBM3, 700 W); the bar keeps
# a 1.6x margin over the larger. Each run prints its own floor.
PREFILL_LOGITS_RTOL = 2.5e-2
# that floor's perturbation: this share of layer 0's attention outputs
# moved by one ulp of the compute dtype
FLOOR_SHARE = 1e-5
# each bf16 prefill layer's kernel output against the loop's on its own
# inputs: max |d| in bf16 ulps of max |out| (4e-3 of max |out| is half an
# ulp to one, by where max |out| falls in its binade, and the model's
# layers put it near the top: 1.07 ulps measured), at least
# BLOCKWISE_MIN_EQUAL bit-equal. An output may round to its neighbour, and
# a P that rounded apart may move it by up to one ulp more
LAYER_MAX_ULPS = 2.0

# the paper's baselines (phase 14): (CLI argv, or API keywords with the
# preset's name, launches of each kernel in the run; unnamed kernels 0).
# GaLore / FRUGAL / FIRA refresh every 200 steps: with --basis dct, step 1
# runs dct_project (7 launches in all) and every step its back-projection
BASELINE_STEPS = 3
_DCT_REFRESH = {"dct_project": LAUNCHES_PER_STEP}
_PER_STEP = LAUNCHES_PER_STEP * BASELINE_STEPS
BASELINE_PATHS = {
    "ldadamw": (["--optimizer", "ldadamw"], {}),
    "galore": (["--optimizer", "galore"], {}),
    "frugal": (["--optimizer", "frugal"], {}),
    "fira": (["--optimizer", "fira"], {}),
    "adamw": (["--optimizer", "adamw"], {}),
    "galore dct": (["--optimizer", "galore", "--basis", "dct"],
                   {**_DCT_REFRESH, "colgather_matmul": _PER_STEP}),
    "frugal dct": (["--optimizer", "frugal", "--basis", "dct"],
                   {**_DCT_REFRESH, "colgather_matmul_dual": _PER_STEP}),
    "fira dct": (["--optimizer", "fira", "--basis", "dct"],
                 {**_DCT_REFRESH, "colgather_matmul_dual": _PER_STEP}),
    "frugal random": ({"name": "frugal", "projector": "random"}, {}),
    "frugal randperm": ({"name": "frugal", "projector": "randperm"}, {}),
}
# the dense refresh on the card against float64 on the CPU: every singular
# value of Q_card^T Q_ref (the cosines of the principal angles between the
# two rank-r subspaces) at least 1 - this
DENSE_SPAN_TOL = 1e-4
# |Q^T Q - I| of the card's bases, max entry: QR's is ~1e-6; cuSOLVER's
# fp32 SVD of (24, 1024, 1024) (torch's default, Jacobi gesvdj) measured
# 6.0e-4 at this leaf (NVIDIA H100 80GB HBM3, 700.00 W)
DENSE_ORTHO_TOL = 2e-3
DENSE_SHAPE = (LAYERS, 1024, 1024)

# the training substrate (phase 15): its checkpoints, plans and obs files
# live here, inside the checkout, and are deleted at the end of the phase
SUBSTRATE_DIR = ROOT / "build" / "chip_smoke_substrate"
# run (a) stops after this step (the schedule still spans STEPS) and a
# second run resumes from its checkpoint
SUBSTRATE_STOP = 4
# (c): the supervised run's steps and the checkpoint step of its kill
SUPERVISED_STEPS, SUPERVISED_KILL = 4, 4

# telemetry and closed-loop control (phase 16): its telemetry files and
# checkpoints live here and are deleted at the end of the phase
TELEMETRY_DIR = ROOT / "build" / "chip_smoke_telemetry"
# (b): the rule's captured energy against float64, relative
ENERGY_RTOL = 1e-5
# (c): the allocator decides every 2 steps on any spread of captured energy
ADAPTIVE_ALLOC = dict(deadband=0.0, decide_every=2)
# (c): the kernels at an allocated rank off a multiple of 16 (the int8
# colgathers' 4-byte copies); this one when the allocation has none
OFF16_RANK = 136
# (d): the adaptive-refresh runs through the CLI, (rank, steps): the main
# path's rank, and every column (r = n = 1024: the selection cannot drift,
# so the scheduler doubles each leaf's interval at each decision and keep
# steps follow)
REFRESH_RUNS = ((RANK, STEPS), (1024, 10))

# the dense configurations (phase 17): serving depths (full width; qwen2.5-32b
# and command-r-plus-104b cut from 64 layers to fit one card beside the
# checks' extra forwards), and the training runs: (arch, depth, batch); 3
# steps of seq 512, DCT-AdamW rank 128. phi3-mini-3.8b is cut from 32
# layers to 24: at 32 its second step ran out of the card's 79.2 GiB (69.0
# allocated, 8.3 reserved free; fp32 parameters, gradients, updates and
# the new parameters are 15.3 GB each; NVIDIA H100 80GB HBM3, 700 W)
CONFIG_SERVE_DEPTHS = {"qwen2.5-32b": 8, "phi3-mini-3.8b": 32,
                       "command-r-plus-104b": 4}
CONFIG_TRAIN_RUNS = (("phi3-mini-3.8b", 24, 8), ("qwen2.5-32b", 2, 2))
CONFIG_TRAIN_STEPS = 3
# the transform-chain runtime (phase 18): its serving CLI's metrics files
RUNTIME_DIR = ROOT / "build" / "chip_smoke_runtime"
RUNTIME_STEPS = 3
# the optimizer update alone (no Trainer, no new parameters): (arch, depth,
# batch of its gradient). At phi3-mini-3.8b's full 32 layers it peaked at
# 77.4 GB of the card's 79.2 GiB (scripts/dense_configs_probe.py
# --update-depth 32; NVIDIA H100 80GB HBM3, 700 W): too close to run after
# the other phases, so at the trained depth
CONFIG_UPDATE_PROFILE = ("phi3-mini-3.8b", 24, 8)
# flash_decode at the configurations' decode shapes: (hq, hkv, hd)
CONFIG_DECODE_SHAPES = {"qwen2.5-32b": (40, 8, 128),
                        "phi3-mini-3.8b": (32, 32, 96),
                        "command-r-plus-104b": (96, 8, 128)}
CONFIG_DECODE_LENS = [512, 1034, 1557, 2080]


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


def _graph_ms(fn, calls: int = 1, iters: int = TIMED_ITERS) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``iters`` times between CUDA events. Where a
    kernel takes less time than its wrapper's host work, eager launches
    time the host; a replay launches only the captured device work."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * calls)


def _bound_ms(nbytes: float, flops: float,
              peak: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _planted(shape, q, gen, r: int = RANK):
    """G whose projection S = G @ Q has ``r`` planted columns per layer, 8x
    larger than the rest, so the top-r selection has a clear margin."""
    import torch
    *batch, m, n = shape
    s = torch.randn(shape, generator=gen, device=q.device)
    big = torch.rand((*batch, n), generator=gen, device=q.device
                     ).argsort(dim=-1)[..., :r]
    col_scale = torch.full((*batch, n), 0.125, device=q.device)
    col_scale.scatter_(-1, big, 1.0)
    return (s * col_scale[..., None, :]) @ q.T


def check_kernels(torch, dev) -> dict:
    """Phase 2. Returns ``{name: row}`` with the numbers of the kernels line
    (``launches`` is filled in by the main path)."""
    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.selection import select_top_r, take_columns
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    dp = importlib.import_module("repro_torch.kernels.dct_project")
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
        again = dp.dct_project(g, q)
        assert torch.equal(again[0], s_k) and torch.equal(again[1], n_k), \
            f"dct_project {shape}: a relaunch differs"
        del again
        acc("dct_project", per_step, err,
            _time_ms(lambda: dp.dct_project(g, q)),
            _time_ms(lambda: dp.dct_project_plain(g, q)),
            _time_ms(lambda: torch.matmul(g, q)),
            4.0 * (2 * e + n * n + nb * n), 2.0 * e * n + 2.0 * e)
        print(json.dumps({"kernel": "dct_project", "shape": list(shape),
                          "max_abs_err_S": err, "max_rel_err_norms": norm_rel,
                          "top_r_equal": True, "relaunch_bit_identical": True}),
              flush=True)

        # colgather_matmul_dual on the selected columns
        b1 = take_columns(s_k, idx_k).contiguous()
        b2 = torch.randn(b1.shape, generator=gen, device=dev)
        o_k = cg.colgather_matmul_dual(b1, b2, qt, idx_k)
        o_p = cg.colgather_matmul_dual_plain(b1, b2, qt, idx_k)
        again = cg.colgather_matmul_dual(b1, b2, qt, idx_k)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(o_k, o_p))
        ref = max(b.abs().max().item() for b in o_p)
        assert err <= 1e-5 * ref, f"colgather_matmul_dual {shape}: {err}"
        assert all(map(torch.equal, again, o_k)), \
            f"colgather_matmul_dual {shape}: a relaunch differs"
        del again
        # the yardstick, three calls (no library time): the gather, then
        # cuBLAS on the stacked operands
        idx_l = idx_k.long()
        rows["colgather_matmul_dual"]["gather_cublas_ms"] = \
            rows["colgather_matmul_dual"].get("gather_cublas_ms", 0.0) \
            + per_step * _time_ms(
                lambda: torch.matmul(torch.stack((b1, b2)), qt[idx_l]))
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
                          "max_abs_out": ref,
                          "relaunch_bit_identical": True}), flush=True)

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


# phase 3's peak device memory, for the phases that compare with it
MAIN_PATH = {}


def run_main_path(torch):
    """Phase 3: the training CLI's code path, counters zeroed just before.
    Returns the counts and the losses."""
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
    hist = trainer.metrics_history
    assert len(hist) == STEPS, hist
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), losses
    counts = ops.launch_counts(ops.TRAINING)
    assert not any(ops.launch_counts(ops.ATTENTION).values()), \
        "the training step's attention launched an attention kernel"
    for name, n in counts.items():
        assert n == LAUNCHES_PER_STEP * STEPS, \
            f"{name}: {n} launches in {STEPS} steps, expected " \
            f"{LAUNCHES_PER_STEP * STEPS}"
    ms_step = sum(h["s_per_step"] for h in hist[1:]) / (STEPS - 1) * 1e3
    MAIN_PATH["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
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
    return counts, losses


def time_breakdown(torch, dev, optimizer: str = "dct_adamw",
                   **opt_kw) -> None:
    """Phase 4 (and 8 for Trion, 11 for int8 and bf16 DCT-AdamW): where one
    training step of llama-350m at batch 8 x 512 with ``optimizer`` at rank
    128 (and ``opt_kw``) goes. The step's parts are timed alone with CUDA
    events (the step is functional, so a part can be repeated on the same
    state); then the optimizer update alone and one
    whole step run under ``torch.profiler`` for the device time by kernel
    and the device's idle share of the step's wall time. A profile can lose
    the first kernel records of its window (one leaf's launches of an
    optimizer update, now and then): the launch counters, asserted by the
    phases that drive each path, are the count of record."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train import steps as S
    from repro_torch.train.schedule import cosine_warmup

    cfg = get_config("llama-350m")
    opt = get_optimizer(optimizer, lr=cosine_warmup(0.01, 2, STEPS),
                        rank=RANK, weight_decay=0.01, **opt_kw)
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
    torch.cuda.synchronize()
    # the optimizer update alone, then one whole step, under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as oprof:
        opt.update(grads, state.opt_state, state.params)
        torch.cuda.synchronize()
    del grads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms = _device_kernels(prof)
    okernels, obusy_ms = _device_kernels(oprof)
    print(json.dumps({
        "time_breakdown": parts, "optimizer": optimizer, "options": opt_kw,
        "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        **({"kernel_launches_before_colgather_quantizers":
            INT8_STEP_LAUNCHES_BEFORE}
           if opt_kw.get("compute_dtype") == "int8" else {}),
        "top_device_kernels": _top(kernels, 12),
        "optimizer_update_device_ms": obusy_ms,
        "optimizer_update_launches": sum(e.count for e in okernels),
        "optimizer_update_top_kernels": _top(okernels, 12),
    }), flush=True)


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_kernels(prof):
    """The device kernels of a profile and their summed time in ms."""
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _dev_us(e) > 0]
    return kernels, sum(_dev_us(e) for e in kernels) / 1e3


def _top(kernels, n: int) -> list:
    return [{"name": e.key[:90], "ms": _dev_us(e) / 1e3, "count": e.count}
            for e in sorted(kernels, key=_dev_us, reverse=True)[:n]]


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return (got - want).abs().max().item() / want.abs().max().item()


def check_momentum_kernels(torch, dev) -> dict:
    """Phase 7. Returns ``{name: row}`` for ``ns_gram``, ``ns_apply`` and
    ``colgather_matmul`` (``launches`` come from phases 8-9)."""
    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.newton_schulz import NS_COEFFS, _ns_step, newton_schulz
    from repro_torch.core.selection import select_top_r
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    from repro_torch.kernels import newton_schulz as ns

    a, b, c = NS_COEFFS
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0}
            for name in ("ns_gram", "ns_apply", "colgather_matmul")}
    rows["colgather_matmul"]["library_ms"] = None
    # the NS kernels' ms and library_ms are CUDA-graph replays; eager beside
    for name in ("ns_gram", "ns_apply"):
        rows[name].update(wrapper_ms=0.0, library_eager_ms=0.0)
    full = {"ms": 0.0, "plain_ms": 0.0}
    report = []
    # tall factors (layers, rows, r) as Trion hands them to NS, launches per
    # step: the main path's two, then ragged ones checked only
    cases = [((nb, m, RANK), k) for (nb, m, _), k in MAIN_SHAPES]
    cases += [((3, 100, 17), 0), ((2, 333, 45), 0)]
    for shape, per_step in cases:
        nb, m, r = shape
        bt = torch.randn(shape, generator=gen, device=dev)
        xw = bt.mT
        x = (xw / (torch.linalg.norm(xw, dim=(-2, -1), keepdim=True) + 1e-7)
             ).contiguous()                  # the first iteration's input
        g_k = ns.ns_gram(x)
        g_k2 = ns.ns_gram(x)
        g_p = ns.ns_gram_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(g_k, g_k2), f"ns_gram {shape}: not deterministic"
        assert torch.equal(g_k, g_k.mT), f"ns_gram {shape}: not symmetric"
        e_gram = _rel(g_k, g_p)
        assert e_gram <= NS_RTOL, f"ns_gram {shape}: rel err {e_gram}"
        poly = b * g_k + c * torch.matmul(g_k, g_k)
        y_k = ns.ns_apply(x, poly, a=a)
        y_k2 = ns.ns_apply(x, poly, a=a)
        y_p = ns.ns_apply_plain(x, poly, a)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2), f"ns_apply {shape}: not deterministic"
        e_apply = _rel(y_k, y_p)
        assert e_apply <= NS_RTOL, f"ns_apply {shape}: rel err {e_apply}"
        e_iter = _rel(ns.ns_iteration(x), _ns_step(x))
        assert e_iter <= NS_RTOL, f"ns_iteration {shape}: rel err {e_iter}"
        o_k = ns.newton_schulz_kernel(bt, steps=NS_STEPS)
        o_p = newton_schulz(bt, steps=NS_STEPS)
        torch.cuda.synchronize()
        e_full = _rel(o_k, o_p)
        assert o_k.shape == bt.shape and torch.isfinite(o_k).all()
        assert e_full <= NS_FULL_RTOL, f"newton_schulz {shape}: rel {e_full}"
        gram_o = o_k.double().mT @ o_k.double()
        off = (gram_o - torch.diag_embed(torch.diagonal(gram_o, dim1=-2,
                                                        dim2=-1))).abs().max()
        sv = torch.linalg.svdvals(o_k.double())
        assert off.item() < OFFDIAG_TOL, f"newton_schulz {shape}: off {off}"
        assert SV_LO < sv.min().item() and sv.max().item() < SV_HI, \
            f"newton_schulz {shape}: singular values {sv.min()} {sv.max()}"
        rows["ns_gram"]["max_abs_err"] = max(rows["ns_gram"]["max_abs_err"],
                                             (g_k - g_p).abs().max().item())
        rows["ns_apply"]["max_abs_err"] = max(
            rows["ns_apply"]["max_abs_err"], (y_k - y_p).abs().max().item())
        case = {"shape_wide": [nb, r, m], "rel_err_gram": e_gram,
                "rel_err_apply": e_apply, "rel_err_iteration": e_iter,
                "rel_err_ns5": e_full, "ns5_offdiag": off.item(),
                "ns5_sv": [sv.min().item(), sv.max().item()],
                "deterministic": True, "gram_symmetric": True}
        if per_step:
            launches = per_step * NS_STEPS
            t = {"gram": _time_ms(lambda: ns.ns_gram(x)),
                 "gram_plain": _time_ms(lambda: ns.ns_gram_plain(x)),
                 "gram_library": _time_ms(lambda: torch.bmm(x, x.mT)),
                 # a step's launches of this shape captured in one graph:
                 # device time without the wrapper's host work
                 "gram_graph": _graph_ms(lambda: ns.ns_gram(x), launches),
                 "gram_library_graph": _graph_ms(
                     lambda: torch.bmm(x, x.mT), launches),
                 "apply": _time_ms(lambda: ns.ns_apply(x, poly, a=a, out=y_k)),
                 "apply_plain": _time_ms(lambda: ns.ns_apply_plain(x, poly, a)),
                 "apply_library": _time_ms(
                     lambda: torch.baddbmm(x, poly, x, beta=a)),
                 "apply_graph": _graph_ms(
                     lambda: ns.ns_apply(x, poly, a=a, out=y_k), launches),
                 "apply_library_graph": _graph_ms(
                     lambda: torch.baddbmm(x, poly, x, beta=a), launches),
                 "ns5": _time_ms(lambda: ns.newton_schulz_kernel(bt)),
                 "ns5_plain": _time_ms(lambda: newton_schulz(bt))}
            case["per_call_ms"] = t
            t_row = dict(t)
            for name, key in (("ns_gram", "gram"), ("ns_apply", "apply")):
                rows[name]["wrapper_ms"] += launches * t[key]
                rows[name]["library_eager_ms"] += launches * t[key + "_library"]
                t_row[key] = t[key + "_graph"]
                t_row[key + "_library"] = t[key + "_library_graph"]
            for name, key, nbytes, flops in (
                    # A is symmetric: its r(r+1)/2 distinct entries
                    ("ns_gram", "gram", 4.0 * nb * (r * m + r * r),
                     1.0 * nb * r * (r + 1) * m),
                    ("ns_apply", "apply", 4.0 * nb * (2 * r * m + r * r),
                     2.0 * nb * r * r * m + 2.0 * nb * r * m)):
                row = rows[name]
                row["ms"] += launches * t_row[key]
                row["plain_ms"] += launches * t_row[key + "_plain"]
                row["library_ms"] += launches * t_row[key + "_library"]
                row["bytes"] += launches * nbytes
                row["flops"] += launches * flops
            full["ms"] += per_step * t["ns5"]
            full["plain_ms"] += per_step * t["ns5_plain"]

            # the single-operand back-projection of subspace Muon
            n = RANK * 8
            qt = dct2_matrix(n, device=dev).T.contiguous()
            idx = select_top_r(torch.rand((nb, n), generator=gen, device=dev),
                               RANK)
            o = torch.randn((nb, m, RANK), generator=gen, device=dev)
            c_k = cg.colgather_matmul(o, qt, idx)
            c_p = cg.colgather_matmul_plain(o, qt, idx)
            again = cg.colgather_matmul(o, qt, idx)
            dual_first, _ = cg.colgather_matmul_dual(o, o.flip(-1), qt, idx)
            torch.cuda.synchronize()
            e_cg = _rel(c_k, c_p)
            assert e_cg <= NS_RTOL, f"colgather_matmul {shape}: rel {e_cg}"
            assert torch.equal(again, c_k) and torch.equal(dual_first, c_k), \
                f"colgather_matmul {shape}: differs from its relaunch or " \
                f"the dual's first output"
            del again, dual_first
            row = rows["colgather_matmul"]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     (c_k - c_p).abs().max().item())
            row["ms"] += per_step * _time_ms(
                lambda: cg.colgather_matmul(o, qt, idx))
            row["plain_ms"] += per_step * _time_ms(
                lambda: cg.colgather_matmul_plain(o, qt, idx))
            rows_needed = torch.unique(idx).numel()
            row["bytes"] += per_step * 4.0 * (nb * m * RANK + rows_needed * n
                                              + nb * RANK + nb * m * n)
            row["flops"] += per_step * 2.0 * nb * m * n * RANK
            case["colgather_matmul_rel_err"] = e_cg
            case["colgather_matmul_equals_dual_first"] = True
        report.append(case)
        del bt, x, g_k, g_k2, g_p, poly, y_k, y_k2, y_p, o_k, o_p
    # the Gram alone at the other ranks fused_step routes, on m of one
    # column, below one range of the kernel's split and off a multiple of 4
    for nb, r, m in GRAM_RAGGED:
        x = torch.randn((nb, r, m), generator=gen, device=dev)
        x /= torch.linalg.norm(x, dim=(-2, -1), keepdim=True)
        g_k, g_k2, g_p = ns.ns_gram(x), ns.ns_gram(x), ns.ns_gram_plain(x)
        torch.cuda.synchronize()
        e_gram = _rel(g_k, g_p)
        assert torch.equal(g_k, g_k2), f"ns_gram {(nb, r, m)}: not deterministic"
        assert torch.equal(g_k, g_k.mT), f"ns_gram {(nb, r, m)}: not symmetric"
        assert e_gram <= NS_RTOL, f"ns_gram {(nb, r, m)}: rel err {e_gram}"
        rows["ns_gram"]["max_abs_err"] = max(rows["ns_gram"]["max_abs_err"],
                                             (g_k - g_p).abs().max().item())
        report.append({"gram_only_wide": [nb, r, m], "rel_err_gram": e_gram,
                       "deterministic": True, "gram_symmetric": True})
    print(json.dumps({"momentum_kernels": report,
                      "ns5_ms_per_trion_step": full,
                      "tolerance": f"gram/apply/iteration {NS_RTOL} of max "
                                   f"|out|, 5 iterations {NS_FULL_RTOL}"}),
          flush=True)
    torch.cuda.empty_cache()
    return rows


def run_momentum_path(torch, name: str) -> dict:
    """Phases 8-9: one momentum family through the training CLI at full
    width and depth, counters zeroed just before. Returns the counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    extra, steps, per_step = MOMENTUM_PATHS[name]
    args = train_cli.build([*MOMENTUM_ARGV, "--steps", str(steps), *extra])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_cli.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hist = trainer.metrics_history
    assert len(hist) == steps, hist
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), (name, losses)
    for kernel, n in counts.items():
        want = per_step.get(kernel, 0) * steps
        assert n == want, f"{name}: {kernel} ran {n} times in {steps} " \
                          f"steps, expected {want}"
    ms_step = sum(h["s_per_step"] for h in hist[1:]) / (steps - 1) * 1e3
    print(json.dumps({
        "momentum_path": name, "optimizer": args.optimizer,
        "rank": args.rank, "fused": args.fused, "steps": steps,
        "batch": BATCH, "seq_len": SEQ, "losses": losses,
        "first_step_ms": hist[0]["s_per_step"] * 1e3,
        "ms_per_step_after_first": ms_step,
        "tokens_per_s": BATCH * SEQ / (ms_step / 1e3),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "allocated_before_bytes": held,
        "wall_s": wall,
        "launches_per_step": {k: v / steps for k, v in counts.items()}}),
        flush=True)
    del trainer
    torch.cuda.empty_cache()
    return counts


def _lowp_row() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bytes": 0.0,
            "flops": 0.0, "max_abs_err": 0.0, "wrapper_ms": 0.0}


def _library_ms(fn):
    """A library yardstick's time, or None (printed) where this torch's
    call refuses the inputs: a yardstick is no phase of the port."""
    try:
        return _time_ms(fn)
    except RuntimeError as err:
        print(json.dumps({"library_call_refused": str(err)[:200]}), flush=True)
        return None


def _has_cuda_op(torch, op: str) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")


def _mm_out_dtype(torch) -> bool:
    """Whether this torch has ``torch.mm(a, b, out_dtype=...)`` on CUDA (a
    bf16 product with an fp32 result in one call)."""
    return _has_cuda_op(torch, "aten::mm.dtype")


def check_lowp_kernels(torch, dev) -> dict:
    """Phase 10. Returns ``{name: row}`` of the bf16 and int8 kernels
    (``launches`` come from phase 11)."""
    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.selection import select_top_r, take_columns
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    dp = importlib.import_module("repro_torch.kernels.dct_project")
    from repro_torch.kernels import lowp
    from repro_torch.kernels import quant_ef as qe

    gen = torch.Generator(device=dev).manual_seed(3)
    names = ("dct_project_bf16", "dct_project_q8", "quant_rows_q8",
             "quant_cols_q8t", "colgather_matmul_dual_bf16",
             "colgather_matmul_dual_q8", "colgather_matmul_bf16",
             "colgather_matmul_q8", "quant_qt_q8", "quant_fold_q8")
    rows = {name: _lowp_row() for name in names}
    lib = _mm_out_dtype(torch)
    int_mm = _has_cuda_op(torch, "aten::_int_mm")
    report = []
    for shape, per_step in MAIN_SHAPES:
        nb, m, n = shape
        e = nb * m * n
        q = dct2_matrix(n, device=dev)
        qt = q.T.contiguous()
        g = _planted(shape, q, gen)
        g[0, 0] = 0.0
        g[0, 1] = 1e-40
        s32, n32 = dp.dct_project_plain(g, q)
        idx32 = select_top_r(n32, RANK)
        case = {"shape": list(shape)}

        # the projections; the int8 route's quantizers against lowp's
        gq, sg = lowp.quant_rows(g)
        qq, sq = lowp.quant_cols(q)
        gq_k, sg_k = qe.quant_rows_q8(g)
        qtq, sq_k = qe.quant_cols_q8t(q)
        s_bf, n_bf = dp.dct_project(g, q, compute_dtype="bf16")
        sp_bf, np_bf = dp.dct_project_plain(g, q, compute_dtype="bf16")
        s_q8, n_q8 = dp.dct_project(g, q, compute_dtype="int8")
        sp_q8, np_q8 = dp.dct_project_q8_plain(gq, sg, qq, sq)
        torch.cuda.synchronize()
        assert torch.equal(gq_k, gq) and torch.equal(sg_k, sg), \
            f"quant_rows_q8 {shape}: differs from lowp.quant_rows"
        assert torch.equal(qtq, qq.T) and torch.equal(sq_k, sq), \
            f"quant_cols_q8t {shape}: differs from lowp.quant_cols"
        del gq_k, sg_k, sq_k
        assert torch.equal(s_q8, sp_q8), f"dct_project_q8 {shape}: S differs"
        again = dp.dct_project_q8t(gq, sg, qtq, sq)
        assert torch.equal(again[0], s_q8) and torch.equal(again[1], n_q8), \
            f"dct_project_q8 {shape}: a relaunch differs"
        del again
        e_bf = _rel(s_bf, sp_bf)
        assert e_bf <= LOWP_TC_RTOL, f"dct_project_bf16 {shape}: rel {e_bf}"
        again = dp.dct_project_bf16(g, q)
        assert torch.equal(again[0], s_bf) and torch.equal(again[1], n_bf), \
            f"dct_project_bf16 {shape}: a relaunch differs"
        del again
        for dt, (s, nk, npl) in {"bf16": (s_bf, n_bf, np_bf),
                                 "int8": (s_q8, n_q8, np_q8)}.items():
            norm_rel = ((nk - npl).abs() / npl.clamp_min(1e-30)).max().item()
            assert norm_rel <= 1e-5, f"{dt} norms {shape}: rel {norm_rel}"
            idx = select_top_r(nk, RANK)
            assert torch.equal(idx, select_top_r(npl, RANK)), f"{dt} top-r"
            assert torch.equal(idx, idx32), f"{dt} top-r differs from fp32"
            fro = (torch.linalg.norm(s.double() - s32.double())
                   / torch.linalg.norm(s32.double())).item()
            assert fro <= lowp.LOWP_ERROR_BOUNDS[dt], f"{dt} S vs fp32 {fro}"
            case[f"dct_project_{dt}"] = {"norms_rel_err": norm_rel,
                                         "rel_fro_vs_fp32": fro}
        case["dct_project_bf16"]["rel_err"] = e_bf
        rows["dct_project_bf16"]["max_abs_err"] = max(
            rows["dct_project_bf16"]["max_abs_err"],
            (s_bf - sp_bf).abs().max().item())
        g16, q16 = g.to(torch.bfloat16), q.to(torch.bfloat16)
        times = {
            "dct_project_bf16": (
                _time_ms(lambda: dp.dct_project_bf16(g, q)), None,
                _time_ms(lambda: dp.dct_project_plain(
                    g, q, compute_dtype="bf16")),
                _time_ms(lambda: torch.mm(g16.view(-1, n), q16,
                                          out_dtype=torch.float32))
                if lib else None),
            "dct_project_q8": (
                _time_ms(lambda: dp.dct_project_q8t(gq, sg, qtq, sq)),
                _time_ms(lambda: dp.dct_project(g, q, compute_dtype="int8")),
                _time_ms(lambda: dp.dct_project_q8_plain(gq, sg, qq, sq)),
                _library_ms(lambda: torch._int_mm(gq.view(-1, n), qq))
                if int_mm else None),
            # the quantizers: device time of CUDA-graph replays (their
            # kernels take less time than their wrappers' host work),
            # eager calls beside
            "quant_rows_q8": (_graph_ms(lambda: qe.quant_rows_q8(g),
                                        per_step),
                              _time_ms(lambda: qe.quant_rows_q8(g)),
                              _time_ms(lambda: lowp.quant_rows(g)), None),
            "quant_cols_q8t": (_graph_ms(lambda: qe.quant_cols_q8t(q),
                                         per_step),
                               _time_ms(lambda: qe.quant_cols_q8t(q)),
                               _time_ms(lambda: qe.quant_cols_q8t_plain(q)),
                               None)}
        # bytes: the function's inputs read once and outputs written once
        out_b = 4.0 * (e + nb * n)                       # S and the norms
        cost = {"dct_project_bf16": (4.0 * (e + n * n) + out_b, 2.0 * e * n,
                                     PEAK_BF16_PER_S),
                "dct_project_q8": (1.0 * (e + n * n) + 4.0 * (nb * m + n)
                                   + out_b, 2.0 * e * n, PEAK_INT8_PER_S),
                # fp32 in, codes and scales out; a division, a rounding and
                # a clip per element (as quantize_ef's row of phase 2)
                "quant_rows_q8": (5.0 * e + 4.0 * nb * m, 5.0 * e,
                                  PEAK_FP32_PER_S),
                "quant_cols_q8t": (5.0 * n * n + 4.0 * n, 5.0 * n * n,
                                   PEAK_FP32_PER_S)}
        del g16, q16

        # the back-projections on the selected columns
        b1 = take_columns(s32, idx32).contiguous()
        b2 = torch.randn(b1.shape, generator=gen, device=dev)
        o32 = cg.colgather_matmul_dual_plain(b1, b2, qt, idx32)
        # the int8 route's operand quantizers against their plain versions
        ((b1q, s1), (b2q, s2)), qt_q = cg.quantize_operands((b1, b2), qt,
                                                            idx32)
        plain_ops = cg.quantize_operands_plain((b1, b2), qt, idx32)
        s_qt = qe.quant_qt_q8(qt)[1]
        torch.cuda.synchronize()
        assert torch.equal(qt_q, plain_ops[1]) \
            and torch.equal(s_qt, lowp.quant_rows(qt)[1]), \
            f"quant_qt_q8 {shape}: differs from lowp.quant_rows"
        assert all(torch.equal(x, y) for pair, plain in
                   zip(((b1q, s1), (b2q, s2)), plain_ops[0])
                   for x, y in zip(pair, plain)), \
            f"quant_fold_q8 {shape}: differs from its plain version"
        ((p1q, p1s), (p2q, p2s)), pt_q = plain_ops
        outs = {
            "colgather_matmul_dual_bf16": (
                cg.colgather_matmul_dual(b1, b2, qt, idx32,
                                         compute_dtype="bf16"),
                cg.colgather_matmul_dual_plain(b1, b2, qt, idx32,
                                               compute_dtype="bf16"), o32),
            "colgather_matmul_dual_q8": (
                cg.colgather_matmul_dual(b1, b2, qt, idx32,
                                         compute_dtype="int8"),
                cg.colgather_q8_plain(((p1q, p1s), (p2q, p2s)), pt_q, idx32),
                o32),
            "colgather_matmul_bf16": (
                (cg.colgather_matmul(b1, qt, idx32, compute_dtype="bf16"),),
                (cg.colgather_matmul_plain(b1, qt, idx32,
                                           compute_dtype="bf16"),), o32[:1]),
            "colgather_matmul_q8": (
                (cg.colgather_matmul(b1, qt, idx32, compute_dtype="int8"),),
                cg.colgather_q8_plain(((p1q, p1s),), pt_q, idx32), o32[:1]),
        }
        torch.cuda.synchronize()
        for name, (got, want, ref) in outs.items():
            dt = "int8" if name.endswith("q8") else "bf16"
            for a, b, c in zip(got, want, ref):
                if dt == "int8":
                    assert torch.equal(a, b), f"{name} {shape}: differs"
                else:
                    err = _rel(a, b)
                    assert err <= LOWP_TC_RTOL, f"{name} {shape}: rel {err}"
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"], (a - b).abs().max().item())
                    case.setdefault(f"{name}_rel_err", []).append(err)
                fro = (torch.linalg.norm(a.double() - c.double())
                       / torch.linalg.norm(c.double())).item()
                assert fro <= lowp.LOWP_ERROR_BOUNDS[dt], f"{name} vs fp32"
                case.setdefault(name, []).append(fro)
        # the bf16 colgathers relaunched: the same bits, and the single
        # operand's output is the dual's first
        dual_bf = outs["colgather_matmul_dual_bf16"][0]
        again = cg.colgather_matmul_dual_bf16(b1, b2, qt, idx32)
        single = cg.colgather_matmul_bf16(b1, qt, idx32)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(again, dual_bf)), \
            f"colgather_matmul_dual_bf16 {shape}: a relaunch differs"
        assert torch.equal(single, outs["colgather_matmul_bf16"][0][0]) \
            and torch.equal(single, dual_bf[0]), \
            f"colgather_matmul_bf16 {shape}: differs from its relaunch or " \
            f"the dual's first output"
        del outs, again, single, dual_bf
        rows_needed = torch.unique(idx32).numel()
        times.update({
            "colgather_matmul_dual_bf16": (
                _time_ms(lambda: cg.colgather_matmul_dual_bf16(b1, b2, qt,
                                                               idx32)),
                None,
                _time_ms(lambda: cg.colgather_matmul_dual_plain(
                    b1, b2, qt, idx32, compute_dtype="bf16")), None),
            "colgather_matmul_dual_q8": (
                _time_ms(lambda: cg.colgather_matmul_dual_q8(
                    b1q, s1, b2q, s2, qt_q, idx32)),
                _time_ms(lambda: cg.colgather_matmul_dual(
                    b1, b2, qt, idx32, compute_dtype="int8")),
                _time_ms(lambda: cg.colgather_q8_plain(
                    ((b1q, s1), (b2q, s2)), qt_q, idx32)), None),
            "colgather_matmul_bf16": (
                _time_ms(lambda: cg.colgather_matmul_bf16(b1, qt, idx32)),
                None,
                _time_ms(lambda: cg.colgather_matmul_plain(
                    b1, qt, idx32, compute_dtype="bf16")), None),
            "colgather_matmul_q8": (
                _time_ms(lambda: cg.colgather_matmul_q8(b1q, s1, qt_q,
                                                        idx32)),
                _time_ms(lambda: cg.colgather_matmul(
                    b1, qt, idx32, compute_dtype="int8")),
                _time_ms(lambda: cg.colgather_q8_plain(((b1q, s1),), qt_q,
                                                       idx32)), None),
            "quant_qt_q8": (_graph_ms(lambda: qe.quant_qt_q8(qt), per_step),
                            _time_ms(lambda: qe.quant_qt_q8(qt)),
                            _time_ms(lambda: lowp.quant_rows(qt)), None),
            "quant_fold_q8": (
                _graph_ms(lambda: qe.quant_fold_q8((b1, b2), s_qt, idx32),
                          per_step),
                _time_ms(lambda: qe.quant_fold_q8((b1, b2), s_qt, idx32)),
                _time_ms(lambda: qe.quant_fold_q8_plain((b1, b2), s_qt,
                                                        idx32)), None)})
        # the bf16 colgathers' yardstick, two calls (no library time): the
        # gather, then cuBLAS on bf16 operands with a bf16 result
        idx_l = idx32.long()

        def gather_cublas(bs):
            rows16 = qt[idx_l].bfloat16()
            return tuple(torch.matmul(x.bfloat16(), rows16) for x in bs)
        yardstick = {
            "colgather_matmul_dual_bf16": _time_ms(
                lambda: gather_cublas((b1, b2))),
            "colgather_matmul_bf16": _time_ms(lambda: gather_cublas((b1,)))}
        for name, ms in yardstick.items():
            rows[name]["gather_cublas_ms"] = \
                rows[name].get("gather_cublas_ms", 0.0) + per_step * ms
        case["gather_cublas_ms"] = yardstick
        # the int8 colgather's quantizers: Q^T per row (as quant_rows_q8);
        # both b read, codes and scales written, Q^T's scales and the
        # indices read, a product, a division, a rounding and a clip per
        # element of each b
        e_b = nb * m * RANK
        cost["quant_qt_q8"] = (5.0 * n * n + 4.0 * n, 5.0 * n * n,
                               PEAK_FP32_PER_S)
        cost["quant_fold_q8"] = (2 * (5.0 * e_b + 4.0 * nb * m)
                                 + 4.0 * (nb * RANK + n), 2 * 5.0 * e_b,
                                 PEAK_FP32_PER_S)
        # bytes: each b, the indices, the rows of Q^T this run selects (each
        # distinct row once) and the fp32 outputs; int8 b with row scales
        for ops_n, suffix in ((2, "dual_"), (1, "")):
            flops = ops_n * 2.0 * e * RANK
            cost[f"colgather_matmul_{suffix}bf16"] = (
                4.0 * (ops_n * nb * m * RANK + rows_needed * n + nb * RANK
                       + ops_n * e), flops, PEAK_BF16_PER_S)
            cost[f"colgather_matmul_{suffix}q8"] = (
                ops_n * (1.0 * nb * m * RANK + 4.0 * nb * m)
                + 1.0 * rows_needed * n + 4.0 * nb * RANK + 4.0 * ops_n * e,
                flops, PEAK_INT8_PER_S)
        for name, (kernel_ms, wrapper_ms, plain_ms, library_ms) in times.items():
            row = rows[name]
            row["ms"] += per_step * kernel_ms
            row["wrapper_ms"] += per_step * (wrapper_ms or kernel_ms)
            row["plain_ms"] += per_step * plain_ms
            if library_ms is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) \
                    + per_step * library_ms
            nbytes, flops, peak = cost[name]
            row["bytes"] += per_step * nbytes
            row["flops"] += per_step * flops
            row["peak"] = peak
        case["per_call_ms"] = dict(times)
        report.append(case)
        del g, s32, n32, s_bf, sp_bf, s_q8, sp_q8, gq, qtq, b1, b2, b1q, b2q, \
            o32, plain_ops, p1q, p2q
        torch.cuda.empty_cache()
    print(json.dumps({
        "lowp_kernels": report,
        "tolerance": f"int8 bit-equal (and its quantizers' codes and "
                     f"scales); bf16 dct_project and colgathers (tensor "
                     f"cores, relaunch bit-identical) "
                     f"{LOWP_TC_RTOL} of max |out|; norms 1e-5 relative, "
                     "top-128 equal to fp32's; each within "
                     "LOWP_ERROR_BOUNDS of fp32 (relative Frobenius)",
        "per_call_ms_order": "kernel (the quantizers: CUDA-graph replays), "
                             "wrapper with its operand quantization (the "
                             "quantizers: eager; None: the same), plain, "
                             "library"}),
        flush=True)
    return rows


def run_lowp_path(torch, name: str, step1_loss: float) -> dict:
    """Phase 11: one of DCT-AdamW's precisions or bases at full width and
    depth, through the training CLI (argv) or the API (keywords), the
    counters zeroed just before. Returns the counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    spec, per_step = LOWP_PATHS[name]
    base = [*TRAIN_ARGV[:TRAIN_ARGV.index("--steps")], "--steps",
            str(LOWP_STEPS), *TRAIN_ARGV[TRAIN_ARGV.index("--warmup"):]]
    args = train_cli.build(base + (spec if isinstance(spec, list) else []))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = (train_cli.run(args) if isinstance(spec, list)
               else _run_api(args, spec))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hist = trainer.metrics_history
    assert len(hist) == LOWP_STEPS, hist
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), (name, losses)
    assert losses[0] == step1_loss, \
        f"{name}: step-1 loss {losses[0]} != the main path's {step1_loss}"
    for kernel, n in counts.items():
        want = per_step.get(kernel, 0) * LOWP_STEPS
        assert n == want, f"{name}: {kernel} ran {n} times in {LOWP_STEPS} " \
                          f"steps, expected {want}"
    ms_step = sum(h["s_per_step"] for h in hist[1:]) / (LOWP_STEPS - 1) * 1e3
    print(json.dumps({
        "lowp_path": name, "spec": spec, "steps": LOWP_STEPS,
        "batch": BATCH, "seq_len": SEQ, "losses": losses,
        "first_step_ms": hist[0]["s_per_step"] * 1e3,
        "ms_per_step_after_first": ms_step,
        "tokens_per_s": BATCH * SEQ / (ms_step / 1e3),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "wall_s": wall,
        "launches_per_step": {k: v / LOWP_STEPS for k, v in counts.items()
                              if v}}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return counts


def _run_api(args, opt_kw: dict, name: str = "dct_adamw"):
    """The training CLI's ``run`` with the preset ``name`` built through
    ``get_optimizer`` with ``opt_kw`` (``error_feedback`` and FRUGAL's
    random projectors have no CLI flag)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.devices import resolve_device
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train.loop import Trainer
    from repro_torch.train.schedule import cosine_warmup
    from repro_torch.train.steps import init_state, make_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt = get_optimizer(name, lr=cosine_warmup(args.lr, args.warmup,
                                                args.steps),
                        rank=args.rank, weight_decay=args.weight_decay,
                        **opt_kw)
    trainer = Trainer(
        train_step=make_train_step(cfg, opt),
        init_state_fn=lambda: init_state(cfg, opt, args.seed, dev),
        batch_fn=make_batch_fn(cfg, args.seq_len, args.batch, seed=args.seed,
                               device=dev),
        log_every=args.log_every)
    trainer.run(total_steps=args.steps)
    return trainer


def _fd_case(torch, dev, seed, *, b, hq, hkv, hd, bs, maxb, lengths,
             kv_dtype, spare=0):
    """One flash_decode input: each slot gets distinct pool blocks for its
    length, unused table entries are 0, and ``spare`` more pool blocks lie
    outside every table. Returns (q in fp32, k, v, table, lengths)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    need = [-(-n // bs) for n in lengths]
    nb = sum(need) + spare
    free = list(rng.permutation(nb))
    table = np.zeros((b, maxb), np.int32)
    for i, n in enumerate(need):
        table[i, :n] = [free.pop() for _ in range(n)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, hd), generator=gen, device=dev)
    k = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(kv_dtype)
    v = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(kv_dtype)
    return (q, k, v, torch.from_numpy(table).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _bf16_excess(a, b, slack) -> float:
    """max over elements of (|a - b| - slack) in bf16 ulps of the larger
    magnitude: <= 1 when a and b are within ``slack`` before their last
    rounding to bf16."""
    import torch
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    d = torch.clamp_min((a - b).abs() - slack, 0.0)
    return torch.where(mag > 0, d / ulp, d).max().item()


def _fd_compare(torch, fd, args, q_dtype, splits, window=None) -> float:
    """The kernel twice (bit-identical) against its plain version on the
    same inputs: fp32 within FD_RTOL_F32 of max |out|; bf16 within that
    plus one bf16 ulp of each element (the last rounding). Returns max
    |dout|."""
    q, *rest = args
    q = q.to(q_dtype)
    got = fd.flash_decode(q, *rest, window=window, num_splits=splits)
    again = fd.flash_decode(q, *rest, window=window, num_splits=splits)
    want = fd.flash_decode_plain(q, *rest, window=window, num_splits=splits)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype and torch.isfinite(got).all(), "flash_decode"
    assert torch.equal(got, again), "flash_decode: relaunch differs"
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    if q_dtype == torch.float32:
        assert err <= FD_RTOL_F32 * ref, \
            f"flash_decode fp32: max |dout| {err} vs max |out| {ref}"
    else:
        ulps = _bf16_excess(got, want, FD_RTOL_F32 * ref)
        assert ulps <= 1.0, f"flash_decode bf16: {ulps} ulps past the fp32 " \
            f"tolerance"
    return err


def _fd_sdpa(torch, q, k, v, table, ln, window=None):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    K/V already densified through the table (the gather is not counted),
    keys outside each slot's valid range masked."""
    b, hq, hd = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    n = table.shape[1] * bs
    kd = k[table.long()].reshape(b, n, hkv, hd).transpose(1, 2).contiguous()
    vd = v[table.long()].reshape(b, n, hkv, hd).transpose(1, 2).contiguous()
    pos = torch.arange(n, device=q.device)[None, :]
    keep = pos < ln[:, None]
    if window:
        keep &= pos >= ln[:, None] - window
    keep = keep[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q4, kd, vd, attn_mask=keep, enable_gqa=hq != hkv)


def check_flash_decode(torch, dev) -> dict:
    """Phase 5. Returns the row of ``flash_decode`` for the kernels line
    (its ``launches`` come from the serving run)."""
    import numpy as np

    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    f32, bf16 = torch.float32, torch.bfloat16
    errs, report = [], []

    def case(name, args, splits, window=None, q_dtypes=(f32, bf16),
             vector=None):
        if vector is not None:
            assert fd.vector_path(args[1], args[2]) == vector, name
        for qd in q_dtypes:
            for sp in splits:
                errs.append(_fd_compare(torch, fd, args, qd, sp, window))
        report.append(name)

    maxb = MAX_BLOCKS
    lens_a = np.linspace(1, maxb * BLOCK, SLOTS).astype(int).tolist()
    args_a = _fd_case(torch, dev, 0, b=SLOTS, hq=HEADS, hkv=HEADS,
                      hd=HEAD_DIM, bs=BLOCK, maxb=maxb, lengths=lens_a,
                      kv_dtype=bf16)
    case("a: llama-350m", args_a, (1, NUM_SPLITS, 4, 16, maxb), vector=True)
    case("b: gqa 32/8 hd 128",
         _fd_case(torch, dev, 1, b=4, hq=32, hkv=8, hd=128, bs=16, maxb=64,
                  lengths=[1000, 17, 512, 1024], kv_dtype=bf16), (1, 3),
         vector=True)
    case("b: gemma3-27b local layer (32/16 hd 128, window 1024)",
         _fd_case(torch, dev, 6, b=GEMMA_SLOTS, hq=32, hkv=16, hd=128,
                  bs=BLOCK, maxb=-(-(GEMMA_PROMPT_LENS[1] + GEMMA_NEW)
                                   // BLOCK),
                  lengths=[512, 1034, 1557, 2080], kv_dtype=bf16),
         (1, NUM_SPLITS), window=1024, vector=True)
    case("c: group 8/1",
         _fd_case(torch, dev, 2, b=3, hq=8, hkv=1, hd=64, bs=8, maxb=16,
                  lengths=[100, 1, 64], kv_dtype=f32), (1, 2), q_dtypes=(f32,),
         vector=False)
    for hd in (17, 31):
        case(f"c: hd {hd}",
             _fd_case(torch, dev, 3, b=2, hq=4, hkv=2, hd=hd, bs=8, maxb=3,
                      lengths=[11, 24], kv_dtype=f32), (1, 2, 3),
             q_dtypes=(f32,), vector=False)
    case("c: window 100",
         _fd_case(torch, dev, 4, b=3, hq=HEADS, hkv=HEADS, hd=HEAD_DIM,
                  bs=BLOCK, maxb=32, lengths=[500, 6, 300], kv_dtype=bf16),
         (1, 4), window=100)

    # a length-0 row is exactly zero; NaN in every pool position no slot
    # reaches (blocks outside the tables, the tails of last blocks, and
    # the unused table entries pointed at a poisoned block) changes nothing
    lens = [200, 0, 37]
    q, k, v, table, ln = _fd_case(torch, dev, 5, b=3, hq=HEADS, hkv=4,
                                  hd=HEAD_DIM, bs=BLOCK, maxb=16,
                                  lengths=lens, kv_dtype=bf16, spare=3)
    clean = fd.flash_decode(q, k, v, table, ln, num_splits=NUM_SPLITS)
    assert torch.count_nonzero(clean[1]).item() == 0, "length-0 row"
    used = set()
    for i, n in enumerate(lens):
        nblk = -(-n // BLOCK)
        used.update(table[i, :nblk].tolist())
        if n % BLOCK:
            blk = table[i, nblk - 1].item()
            k[blk, n % BLOCK:] = float("nan")
            v[blk, n % BLOCK:] = float("nan")
    poison = sorted(set(range(k.shape[0])) - used)
    k[poison] = float("nan")
    v[poison] = float("nan")
    for i, n in enumerate(lens):
        table[i, -(-n // BLOCK):] = poison[0]
    dirty = fd.flash_decode(q, k, v, table, ln, num_splits=NUM_SPLITS)
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty), "flash_decode read a poisoned block"
    errs.append(_fd_compare(torch, fd, (q, k, v, table, ln), f32,
                            NUM_SPLITS))
    report.append("c: zero row, NaN-poisoned pool")

    # times per decode step of the serving path: 24 launches at shape (a)
    # with its q in bf16 and 2 splits. The kernels take less time than the
    # wrapper's host work, so the device time comes from CUDA-graph
    # replays of 24 calls (wrapper_ms: eager calls, host included)
    q, k, v, table, ln = args_a
    q = q.to(bf16)

    def call(sp=NUM_SPLITS):
        return lambda: fd.flash_decode(q, k, v, table, ln, num_splits=sp)

    ms = _graph_ms(call(), LAYERS)
    wrapper_ms = _time_ms(call())
    plain_ms = _time_ms(lambda: fd.flash_decode_plain(
        q, k, v, table, ln, num_splits=NUM_SPLITS))
    # the decomposition does not follow the caller's split count: the time
    # per call with 1-16 splits (and MAXB) stays flat
    split_ms = {sp: _graph_ms(call(sp), LAYERS)
                for sp in (1, 2, 4, 8, 16, maxb)}
    library_ms = _graph_ms(_fd_sdpa(torch, q, k, v, table, ln), LAYERS)
    # bytes this call must move: the valid K/V rows, q, the table entries
    # of the run blocks, the lengths and the output
    tokens = int(ln.sum())
    run_blocks = sum(-(-n // BLOCK) for n in lens_a)
    nbytes = (tokens * HEADS * HEAD_DIM * 2 * 2 + 2 * q.numel() * 2
              + run_blocks * 4 + SLOTS * 4)
    flops = 4.0 * tokens * HEADS * HEAD_DIM
    out = {"kernel": "flash_decode", "cases": report,
           "max_abs_err": max(errs), "tolerance": f"fp32 {FD_RTOL_F32} of max "
           f"|out|; bf16 that + 1 ulp; each launched twice, bit-identical",
           "ranges": dict(zip(("splits", "bps", "cols", "per_split"),
                              fd.plan_ranges(maxb, BLOCK, NUM_SPLITS))),
           "per_call_ms": ms, "wrapper_per_call_ms": wrapper_ms,
           "plain_per_call_ms": plain_ms,
           "sdpa_per_call_ms_gather_not_counted": library_ms,
           "per_call_ms_by_splits": split_ms,
           "bound_per_call_ms": _bound_ms(nbytes, flops)[0],
           "lengths": lens_a}
    print(json.dumps(out), flush=True)
    return {"ms": LAYERS * ms, "wrapper_ms": LAYERS * wrapper_ms,
            "plain_ms": LAYERS * plain_ms, "library_ms": LAYERS * library_ms,
            "bytes": LAYERS * nbytes, "flops": LAYERS * flops,
            "max_abs_err": max(errs)}


def run_serving(torch, dev) -> int:
    """Phase 6: the paged serving path at full width, counters zeroed just
    before it. Returns the flash_decode launch count of that run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import PagedServeEngine, SamplingParams, Session

    cfg = get_config("llama-350m")
    eng = PagedServeEngine(
        cfg, T.init_params(cfg, seed=0, device=dev), block_size=BLOCK,
        num_blocks=SLOTS * MAX_BLOCKS, max_blocks_per_seq=MAX_BLOCKS,
        num_slots=SLOTS, max_prefill_len=PROMPT_LENS[1],
        prefill_chunk=PREFILL_CHUNK, num_splits=NUM_SPLITS)
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(*PROMPT_LENS, SERVE_REQUESTS)
                           .astype(int))
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=7)
    sess = Session(eng, "smoke")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.enable()
    obs.reset()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [sess.submit(p, max_new_tokens=NEW_TOKENS,
                           sampling=sampled if i % 4 == 3 else None)
               for i, p in enumerate(prompts)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts(ops.SERVING)
    steps = eng.steps
    spans = obs.tracer().records()
    obs.disable()
    assert counts["flash_decode"] == LAYERS * steps, \
        f"flash_decode: {counts['flash_decode']} launches in {steps} steps"
    # every layer's pools take the 16-byte path
    from repro_torch.kernels.flash_decode import vector_path
    assert all(vector_path(x[r], x[r]) for x in eng.cache.pools.values()
               for r in range(x.shape[0])), "a pool off the 16-byte path"
    assert not any(ops.launch_counts(ops.ATTENTION).values()), \
        "the chunked paged prefill launched an attention kernel"
    for h in handles:
        assert h.finish_reason == "length" \
            and len(h.tokens) == NEW_TOKENS, h.request.request_id
    decode_ms = [r["dur"] / 1e6 for r in spans
                 if r["name"] == "serve/decode_step"]
    admit_ms = [r["dur"] / 1e6 for r in spans if r["name"] == "serve/admit"]
    assert len(decode_ms) == steps and len(admit_ms) == SERVE_REQUESTS
    tokens = sum(len(h.tokens) for h in handles)
    stats = eng.stats()
    peak = torch.cuda.max_memory_allocated()

    # the same greedy and sampled requests alone on the same engine
    solo = {}
    for i in (5, 7):
        h = sess.submit(prompts[i], max_new_tokens=NEW_TOKENS,
                        sampling=handles[i].request.sampling)
        eng.run()
        assert h.tokens == handles[i].tokens, \
            f"request {i}: churned stream differs from its solo run"
        solo[handles[i].request.request_id] = \
            handles[i].request.sampling.temperature
    print(json.dumps({
        "serving_path": "llama-350m bf16 PagedServeEngine, flash_decode",
        "slots": SLOTS, "block_size": BLOCK, "max_blocks_per_seq": MAX_BLOCKS,
        "requests": SERVE_REQUESTS, "prompt_lens": lens.tolist(),
        "new_tokens": NEW_TOKENS, "prefill_chunk": PREFILL_CHUNK,
        "num_splits": NUM_SPLITS, "decode_steps": steps,
        "flash_decode_launches": counts["flash_decode"],
        "flash_decode_launches_per_step": counts["flash_decode"] / steps,
        "decode_ms_per_step_mean": sum(decode_ms) / steps,
        "decode_ms_per_step_median": sorted(decode_ms)[steps // 2],
        "admit_prefill_ms_mean": sum(admit_ms) / len(admit_ms),
        "wall_s": wall, "output_tokens": tokens,
        "output_tokens_per_s": tokens / wall,
        "ttft_s_mean": sum(h.ttft for h in handles) / len(handles),
        "max_memory_allocated_bytes": peak,
        "pool_bytes": stats["cache_bytes"],
        "dense_bytes_equivalent": stats["dense_bytes_equivalent"],
        "solo_equals_churn": solo}), flush=True)

    # five decode steps of eight running slots under the profiler
    for p in prompts[:SLOTS]:
        sess.submit(p[:256], max_new_tokens=16)
    eng.step()                       # admits all eight, one decode step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()

    kernels, busy_ms = _device_kernels(prof)
    fd_ms = sum(_dev_us(e) for e in kernels if "flash_decode" in e.key) / 1e3
    print(json.dumps({
        "decode_profile_steps": 5, "slots_running": SLOTS,
        "profiled_wall_ms_per_step": wall_ms / 5,
        "device_busy_ms_per_step": busy_ms / 5,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "flash_decode_device_ms_per_step": fd_ms / 5,
        "kernel_launches_per_step": sum(e.count for e in kernels) / 5,
        "top_device_kernels": _top(kernels, 10),
    }), flush=True)
    return counts["flash_decode"]


def _fa_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head: what the kernel must do."""
    import numpy as np
    q = np.arange(s)
    hi = q + 1 if causal else np.full(s, s)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, int)
    return int((hi - lo).sum())


def _fa_inputs(torch, dev, seed, b, s, hq, hkv, hd, dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
            for h in (hq, hkv, hkv)]


def _fa_compare(torch, fa, q, k, v, causal, window) -> float:
    """The kernel twice (bit-identical) against its plain version: fp32
    within FA_TOL_F32, bf16 within that plus one bf16 ulp of each element.
    Returns max |dout|."""
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape \
        and torch.isfinite(got).all(), "flash_attention output"
    assert torch.equal(got, again), "flash_attention: relaunch differs"
    err = (got.float() - want.float()).abs().max().item()
    if q.dtype == torch.float32:
        assert err <= FA_TOL_F32, f"flash_attention fp32: max |dout| {err}"
    else:
        ulps = _bf16_excess(got, want, FA_TOL_F32)
        assert ulps <= 1.0, f"flash_attention bf16: {ulps} ulps past " \
            f"{FA_TOL_F32}"
    return err


def _per_prefill_row(cases: dict, max_abs_err: float, peak: float) -> dict:
    """A dense attention kernel's kernels-line row from its cases (a)-(c):
    times per dense prefill, llama-350m 24 launches at (a), gemma3-27b at
    depth 8 7 at (b) and 1 at (c); the ops bound at ``peak``."""
    a, lb, gc = (cases[n] for n in FA_CASES)
    row = {key: LAYERS * a[key] for key in ("ms", "plain_ms", "library_ms",
                                            "bytes")}
    row.update(flops=LAYERS * 4.0 * a["unmasked_pairs"] * a["shape"][4],
               peak=peak, max_abs_err=max_abs_err,
               gemma3_prefill={key: 7 * lb[key] + gc[key] for key in (
                   "ms", "plain_ms", "library_ms", "bound_ms")},
               cases=cases)
    if "wrapper_ms" in a:
        row["wrapper_ms"] = LAYERS * a["wrapper_ms"]
    return row


def _sdpa(torch, q, k, v, window):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the same tensors (``enable_gqa``; the window as a boolean mask)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    pos = torch.arange(q.shape[1], device=q.device)
    keep = (pos[:, None] >= pos[None, :]) \
        & (pos[:, None] - pos[None, :] < window)
    return lambda: sdpa(qt, kt, vt, attn_mask=keep, enable_gqa=True)


def check_flash_attention(torch, dev) -> dict:
    """Phase 12. Returns the kernels-line row of ``flash_attention`` (its
    ``launches`` come from phase 13)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    f32, bf16 = torch.float32, torch.bfloat16
    errs, cases = [], {}
    for i, (name, (b, s, hq, hkv, hd, window, _)) in enumerate(
            FA_CASES.items()):
        cases[name] = _fa_fp32_case(torch, dev, fa, i, b, s, hq, hkv, hd,
                                    window)
        errs.append(cases[name]["max_abs_err"])
        print(json.dumps({"flash_attention_case": name, **cases[name]}),
              flush=True)
    # edge cases: (b, s, hq, hkv, hd, causal, window, dtype); bf16 inputs
    # are upcast (no route sends them here, the function takes them)
    edges = {"bf16 llama-350m": (8, 512, 16, 16, 64, True, None, bf16),
             "group 5": (2, 300, 10, 2, 64, True, 64, bf16),
             "hd 96": (2, 257, 8, 4, 96, True, None, bf16),
             "hd 17": (1, 100, 4, 2, 17, True, None, f32),
             "S 1": (3, 1, 4, 2, 64, True, None, f32),
             "S 777": (1, 777, 8, 4, 128, True, 128, bf16),
             "window 1": (1, 200, 4, 4, 64, True, 1, f32),
             "no mask": (2, 130, 6, 3, 64, False, None, f32)}
    for i, (name, (b, s, hq, hkv, hd, causal, window, dt)) in enumerate(
            edges.items()):
        q, k, v = _fa_inputs(torch, dev, 10 + i, b, s, hq, hkv, hd, dt)
        errs.append(_fa_compare(torch, fa, q, k, v, causal, window))
    print(json.dumps({"kernel": "flash_attention", "cases": list(cases),
                      "edge_cases": list(edges), "max_abs_err": max(errs),
                      "tolerance": f"fp32 {FA_TOL_F32}; bf16 that + 1 ulp; "
                                   f"each launched twice, bit-identical"}),
          flush=True)
    return _per_prefill_row(cases, max(errs), PEAK_TF32_PER_S / TF32_PASSES)


def _fa_fp32_case(torch, dev, fa, seed, b, s, hq, hkv, hd, window) -> dict:
    """``flash_attention`` on fp32 inputs (its route) at one causal shape:
    held to its plain version (twice, bit-identical), timed beside fp32
    SDPA on the same tensors and its fp32 bounds: bytes at 4 B an element,
    operations at the TF32 rate over 3 passes (the tensor-core design) and
    at the fp32 SIMT rate. Kernel and SDPA times are device time of
    CUDA-graph replays of a prefill's 24 calls (at (a) the kernel takes
    about as long as the wrapper's host work); ``wrapper_ms``: eager
    calls."""
    q, k, v = _fa_inputs(torch, dev, seed, b, s, hq, hkv, hd, torch.float32)
    err = _fa_compare(torch, fa, q, k, v, True, window)
    lib = _sdpa(torch, q, k, v, window)
    # the yardstick computes the same function (within the JAX package's
    # bf16 tolerance, tests/test_kernels.py: a check of what it computes)
    lib_err = (lib().transpose(1, 2)
               - fa.flash_attention_ref(q, k, v, window=window)
               ).abs().max().item()
    assert lib_err <= 2e-2, f"SDPA differs by {lib_err}"
    pairs = b * hq * _fa_pairs(s, True, window)
    flops = 4.0 * pairs * hd
    nbytes = 4 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    bound, by = _bound_ms(nbytes, flops, PEAK_TF32_PER_S / TF32_PASSES)
    simt_bound, simt_by = _bound_ms(nbytes, flops, PEAK_FP32_PER_S)
    def call():
        return fa.flash_attention(q, k, v, window=window)

    ms = _graph_ms(call, LAYERS)
    case = {
        "shape": [b, s, hq, hkv, hd], "window": window, "dtype": "fp32",
        "max_abs_err": err, "sdpa_max_abs_err": lib_err, "ms": ms,
        "tflop_per_s": flops / ms / 1e9, "wrapper_ms": _time_ms(call),
        "plain_ms": _time_ms(lambda: fa.flash_attention_ref(
            q, k, v, window=window), 3),
        "library_ms": _graph_ms(lib, LAYERS), "bound_ms": bound,
        "bound_by": by,
        "bound_peak": "TF32 495 TFLOP/s / 3 passes",
        "fp32_simt_bound_ms": simt_bound, "fp32_simt_bound_by": simt_by,
        "unmasked_pairs": pairs, "bytes": nbytes}
    del q, k, v, lib
    torch.cuda.empty_cache()
    return case


def _blockwise_compare(torch, fa, q, k, v, causal, window, chunk) -> dict:
    """``flash_attention_blockwise`` twice (bit-identical) against its plain
    version at the model's bar. Returns the errors."""
    kw = dict(causal=causal, window=window, kv_chunk=chunk)
    got = fa.flash_attention_blockwise(q, k, v, **kw)
    again = fa.flash_attention_blockwise(q, k, v, **kw)
    want = fa.blockwise_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape \
        and torch.isfinite(got).all(), "flash_attention_blockwise output"
    assert torch.equal(got, again), "flash_attention_blockwise: relaunch differs"
    d = (got.float() - want.float()).abs()
    err = d.max().item()
    rel = err / want.float().abs().max().item()
    equal = (d == 0).float().mean().item()
    assert rel <= BLOCKWISE_REL_TOL and equal >= BLOCKWISE_MIN_EQUAL, \
        f"flash_attention_blockwise: max |d| {rel} of max |out|, " \
        f"{equal} bit-equal"
    return {"max_abs_err": err, "rel_err": rel, "bit_equal_share": equal}


def check_flash_attention_blockwise(torch, dev) -> dict:
    """Phase 12, the model's route. Returns the kernels-line row of
    ``flash_attention_blockwise`` (its ``launches`` come from phase 13)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    cases, errs = {}, []
    for i, (name, (b, s, hq, hkv, hd, window, chunk)) in enumerate(
            FA_CASES.items()):
        q, k, v = _fa_inputs(torch, dev, i, b, s, hq, hkv, hd, torch.bfloat16)
        gaps = _blockwise_compare(torch, fa, q, k, v, True, window, chunk)
        errs.append(gaps["max_abs_err"])
        lib = _sdpa(torch, q, k, v, window)
        pairs = b * hq * _fa_pairs(s, True, window)
        flops = 4.0 * pairs * hd
        nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
        bound, by = _bound_ms(nbytes, flops, PEAK_BF16_PER_S)
        ms = _time_ms(lambda: fa.flash_attention_blockwise(
            q, k, v, window=window, kv_chunk=chunk))
        cases[name] = {
            "shape": [b, s, hq, hkv, hd], "window": window, "kv_chunk": chunk,
            "dtype": "bf16", **gaps, "ms": ms,
            "tflop_per_s": flops / ms / 1e9,
            "plain_ms": _time_ms(lambda: fa.blockwise_attention_ref(
                q, k, v, causal=True, window=window, kv_chunk=chunk), 3),
            "library_ms": _time_ms(lib), "bound_ms": bound, "bound_by": by,
            "unmasked_pairs": pairs, "bytes": nbytes}
        print(json.dumps({"flash_attention_blockwise_case": name,
                          **cases[name]}), flush=True)
        del q, k, v, lib
        torch.cuda.empty_cache()
    # edge cases: (b, s, hq, hkv, hd, causal, window, kv chunk)
    edges = {"hd 96": (2, 384, 8, 8, 96, True, None, 128),
             "group 5": (1, 320, 10, 2, 64, True, 64, 64),
             "S 777": (1, 777, 8, 4, 128, True, 128, 512),
             "chunk 100, window 50": (1, 300, 4, 2, 64, True, 50, 100),
             "hd 16, S 1": (3, 1, 4, 2, 16, True, None, 512),
             "hd 256": (1, 200, 2, 1, 256, True, None, 64),
             "no mask": (2, 130, 6, 3, 64, False, None, 512)}
    for i, (name, (b, s, hq, hkv, hd, causal, window, chunk)) in enumerate(
            edges.items()):
        q, k, v = _fa_inputs(torch, dev, 20 + i, b, s, hq, hkv, hd,
                             torch.bfloat16)
        errs.append(_blockwise_compare(torch, fa, q, k, v, causal, window,
                                       chunk)["max_abs_err"])
    print(json.dumps({"kernel": "flash_attention_blockwise",
                      "cases": list(cases), "edge_cases": list(edges),
                      "max_abs_err": max(errs),
                      "tolerance": f"max |d| <= {BLOCKWISE_REL_TOL} max |out|, "
                                   f">= {BLOCKWISE_MIN_EQUAL} bit-equal; each "
                                   "launched twice, bit-identical"}),
          flush=True)
    return _per_prefill_row(cases, max(errs), PEAK_BF16_PER_S)


def _gemma3_depth8():
    """gemma3-27b at full width, one repeat of each schedule segment: 7
    local layers and 1 global."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config("gemma3-27b")
    return dataclasses.replace(
        cfg, schedule=tuple((pattern, 1) for pattern, _ in cfg.schedule))


def _plain_route_last_logits(torch, T, params, tokens, cfg):
    """The same forward with grad enabled on the parameters: the model's
    attention runs the plain chunked loop, not the kernel."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in params.items()}
        logits, _ = T.forward(leaves, {"tokens": tokens}, cfg)
    return logits[:, -1].detach().float()


# phase 13's dense runs: the kernel each prefill launches once per layer
DENSE_RUNS = {"llama-350m": "flash_attention_blockwise",
              "gemma3-27b": "flash_attention_blockwise",
              "llama-350m fp32": "flash_attention"}


def _one_ulp(torch, x, share: float):
    """``x`` with ``share`` of its elements (a fixed draw) moved by one ulp
    of its dtype, away from zero."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[x.dtype]
    gen = torch.Generator(device=x.device).manual_seed(1)
    hit = torch.rand(x.shape, generator=gen, device=x.device) < share
    return torch.where(hit, (x.view(ints) + 1).view(x.dtype), x)


def _prefill_attention_probe(torch, T, params, tokens, cfg, mode: str):
    """One no-grad forward of the model with its attention wrapped: "gaps"
    runs the route (the kernel) and the plain loop on each layer's own
    inputs and returns per layer (share of elements that differ, max |d| /
    max |out|, max |d| in bf16 ulps of max |out|), continuing
    with the kernel's output; "floor" runs the plain
    loop with FLOOR_SHARE of layer 0's outputs moved by one ulp and returns
    the last logits."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import layers as L

    gaps = []
    # attn_sp configurations attend through sp_blockwise_attention (the
    # same function and route on one device)
    routes = (T.blockwise_attention, T.sp_blockwise_attention)

    def attn(q, k, v, **kw):
        want = fa.blockwise_attention_ref(q, k, v, **kw)
        if mode == "floor":
            gaps.append(None)
            return _one_ulp(torch, want, FLOOR_SHARE) if len(gaps) == 1 \
                else want
        got = L.blockwise_attention(q, k, v, **kw)
        d = (got.float() - want.float()).abs()
        top = want.float().abs().max()
        ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
        gaps.append(((d > 0).float().mean().item(), (d.max() / top).item(),
                     (d.max() / ulp).item()))
        return got

    T.blockwise_attention = T.sp_blockwise_attention = attn
    try:
        with torch.inference_mode():
            logits, _ = T.forward(params, {"tokens": tokens}, cfg)
    finally:
        T.blockwise_attention, T.sp_blockwise_attention = routes
    return gaps if mode == "gaps" else logits[:, -1].float()


def run_dense_prefill(torch, dev, name: str, cfg=None) -> dict:
    """Phase 13, dense engine: ``ServeEngine.generate`` of llama-350m (bf16,
    or fp32 compute) or gemma3-27b at depth 8, counters zeroed just before;
    phase 17: of ``cfg`` (a dense configuration, bf16 compute, 2 prompts x
    2048). Returns the counts."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    if cfg is not None:
        (b, s), new = GEMMA_PROMPTS, GEMMA_NEW
    elif name == "llama-350m":
        cfg, (b, s), new = get_config(name), LLAMA_PROMPTS, LLAMA_NEW
    elif name == "llama-350m fp32":
        cfg = dataclasses.replace(get_config("llama-350m"),
                                  compute_dtype="float32")
        (b, s), new = LLAMA_F32_PROMPTS, LLAMA_NEW
    else:
        cfg, (b, s), new = _gemma3_depth8(), GEMMA_PROMPTS, GEMMA_NEW
    kernel = DENSE_RUNS.get(name, "flash_attention_blockwise")
    params = T.init_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_len=s + new)
    del params
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate({"tokens": tokens}, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    assert counts[kernel] == cfg.n_layers, counts
    assert sum(counts.values()) == cfg.n_layers, counts
    assert out.shape == (b, new), out.shape
    again = eng.generate({"tokens": tokens}, max_new_tokens=new)
    assert torch.equal(out, again), f"{name}: a rerun gave other tokens"

    # the prefill alone: its time, its last logits against the plain
    # route, and one run under the profiler
    with torch.inference_mode():
        T.prefill(eng.params, {"tokens": tokens}, cfg, max_len=s + new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _, _ = T.prefill(eng.params, {"tokens": tokens}, cfg,
                               max_len=s + new)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            T.prefill(eng.params, {"tokens": tokens}, cfg, max_len=s + new)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated()
    plain = _plain_route_last_logits(torch, T, eng.params, tokens, cfg)
    last = last.float()
    assert torch.isfinite(last).all() and last.shape == (b, cfg.vocab_size)
    rel = ((last - plain).norm() / plain.norm()).item()
    top1 = (last.argmax(-1) == plain.argmax(-1)).float().mean().item()
    assert rel <= PREFILL_LOGITS_RTOL and top1 == 1.0, \
        f"{name}: prefill logits {rel} from the plain route, top-1 {top1}"
    # each layer's kernel output against the loop on the same inputs
    gaps = _prefill_attention_probe(torch, T, eng.params, tokens, cfg,
                                    "gaps")
    for i, (share, gap, ulps) in enumerate(gaps):
        if cfg.compute_dtype == "bfloat16":
            assert ulps <= LAYER_MAX_ULPS \
                and 1.0 - share >= BLOCKWISE_MIN_EQUAL, \
                f"{name} layer {i}: {share} differ, by up to {ulps} ulps"
        else:
            assert gap <= FA_TOL_F32, f"{name} layer {i}: max |d| {gap}"
    floor_logits = _prefill_attention_probe(torch, T, eng.params, tokens, cfg,
                                            "floor")
    floor = ((floor_logits - plain).norm() / plain.norm()).item()
    kernels, busy_ms = _device_kernels(prof)
    fa_ms = sum(_dev_us(e) for e in kernels
                if f"{kernel}_fwd" in e.key) / 1e3
    print(json.dumps({
        "dense_prefill_path": f"{name} ({cfg.compute_dtype}) ServeEngine, "
                              f"{kernel}",
        "layers": cfg.n_layers, "kinds": list(cfg.block_kinds()),
        "batch": b, "prompt_len": s, "new_tokens": new,
        f"{kernel}_launches": counts[kernel],
        "generate_wall_s": wall, "output_tokens_per_s": b * new / wall,
        "prefill_ms": prefill_ms,
        "prefill_last_logits_rel_to_plain_route": rel,
        "prefill_top1_agreement_with_plain_route": top1,
        "plain_route_floor_rel": floor, "floor_share": FLOOR_SHARE,
        "per_layer_attention_share_differing": [g[0] for g in gaps],
        "per_layer_attention_max_rel": [g[1] for g in gaps],
        "per_layer_attention_max_ulps_of_max_out": [g[2] for g in gaps],
        "rerun_equal": True,
        "ttft_ms": prefill_ms,
        "decode_ms_per_step_est": (wall * 1e3 - prefill_ms) / new,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "serving_max_memory_allocated_bytes": prefill_peak,
        "params": T.param_count(eng.params),
        "profiled_prefill_wall_ms": prof_wall_ms,
        "prefill_device_busy_ms": busy_ms,
        "prefill_device_idle_share": 1.0 - busy_ms / prof_wall_ms,
        f"{kernel}_device_ms": fa_ms,
        "prefill_kernel_launches": sum(e.count for e in kernels),
        "top_device_kernels": _top(kernels, 8)}), flush=True)
    del eng
    torch.cuda.empty_cache()
    return counts


def run_paged(torch, dev, cfg=None, label=None) -> dict:
    """Phase 13, paged engine: gemma3-27b at depth 8 on
    ``PagedServeEngine``, counters zeroed just before; phase 17: ``cfg``
    the same way. Returns the counts."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import PagedServeEngine, Session

    if cfg is None:
        cfg = _gemma3_depth8()
        label = ("gemma3-27b depth 8 bf16 PagedServeEngine, flash_decode "
                 "with window 1024 on local layers")
    max_blocks = -(-(GEMMA_PROMPT_LENS[1] + GEMMA_NEW) // BLOCK)
    eng = PagedServeEngine(
        cfg, T.init_params(cfg, seed=0, device=dev), block_size=BLOCK,
        num_blocks=GEMMA_SLOTS * max_blocks, max_blocks_per_seq=max_blocks,
        num_slots=GEMMA_SLOTS, max_prefill_len=GEMMA_PROMPT_LENS[1],
        prefill_chunk=GEMMA_CHUNK, num_splits=NUM_SPLITS)
    rng = np.random.default_rng(1)
    lens = rng.permutation(np.linspace(*GEMMA_PROMPT_LENS, GEMMA_REQUESTS)
                           .astype(int))
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    sess = Session(eng, "gemma3")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.enable()
    obs.reset()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [sess.submit(p, max_new_tokens=GEMMA_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = eng.steps
    spans = obs.tracer().records()
    obs.disable()
    assert counts["flash_decode"] == cfg.n_layers * steps, (counts, steps)
    assert sum(counts.values()) == counts["flash_decode"], counts
    for h in handles:
        assert h.finish_reason == "length" and len(h.tokens) == GEMMA_NEW, \
            h.request.request_id
    solo = sess.submit(prompts[2], max_new_tokens=GEMMA_NEW)
    eng.run()
    assert solo.tokens == handles[2].tokens, \
        f"{cfg.name} paged: the solo rerun differs from the churned stream"
    decode_ms = [r["dur"] / 1e6 for r in spans
                 if r["name"] == "serve/decode_step"]
    admit_ms = [r["dur"] / 1e6 for r in spans if r["name"] == "serve/admit"]
    tokens = sum(len(h.tokens) for h in handles)
    stats = eng.stats()
    print(json.dumps({
        "paged_path": label,
        "slots": GEMMA_SLOTS, "block_size": BLOCK,
        "requests": GEMMA_REQUESTS, "prompt_lens": lens.tolist(),
        "new_tokens": GEMMA_NEW, "prefill_chunk": GEMMA_CHUNK,
        "num_splits": NUM_SPLITS, "decode_steps": steps,
        "flash_decode_launches_per_step": counts["flash_decode"] / steps,
        "attention_kernel_launches": {k: counts[k] for k in (
            "flash_attention", "flash_attention_blockwise")},
        "decode_ms_per_step_mean": sum(decode_ms) / len(decode_ms),
        "decode_ms_per_step_median": sorted(decode_ms)[len(decode_ms) // 2],
        "admit_prefill_ms_mean": sum(admit_ms) / len(admit_ms),
        "wall_s": wall, "output_tokens": tokens,
        "output_tokens_per_s": tokens / wall,
        "ttft_s_mean": sum(h.ttft for h in handles) / len(handles),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "pool_bytes": stats["cache_bytes"], "solo_equals_churn": True}),
        flush=True)
    del eng
    torch.cuda.empty_cache()
    return counts


def _baseline_args(spec):
    """The training CLI's arguments of a phase-14 run (the API runs take the
    CLI's rank, seed, batch and schedule)."""
    from repro_torch.launch import train as train_cli

    base = [*TRAIN_ARGV[:TRAIN_ARGV.index("--steps")], "--steps",
            str(BASELINE_STEPS), *TRAIN_ARGV[TRAIN_ARGV.index("--warmup"):]]
    base = [a for a in base if a not in ("--optimizer", "dct_adamw")]
    return train_cli.build(base + (spec if isinstance(spec, list) else []))


def run_baseline_path(torch, name: str, step1_loss: float) -> dict:
    """Phase 14: one baseline at full width and depth through the training
    CLI (argv) or the API (keywords), the counters zeroed just before.
    Returns the counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    spec, want = BASELINE_PATHS[name]
    args = _baseline_args(spec)
    # the earlier phases' engines hold reference cycles: collect them, so
    # the peak is this run's and not that of garbage awaiting collection
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if isinstance(spec, list):
        trainer = train_cli.run(args)
    else:
        kw = dict(spec)
        trainer = _run_api(args, kw, kw.pop("name"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hist = trainer.metrics_history
    assert len(hist) == BASELINE_STEPS, hist
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), (name, losses)
    assert losses[0] == step1_loss, \
        f"{name}: step-1 loss {losses[0]} != the main path's {step1_loss}"
    for kernel, n in counts.items():
        assert n == want.get(kernel, 0), \
            f"{name}: {kernel} ran {n} times in {BASELINE_STEPS} steps, " \
            f"expected {want.get(kernel, 0)}"
    print(json.dumps({
        "baseline_path": name, "spec": spec, "steps": BASELINE_STEPS,
        "batch": BATCH, "seq_len": SEQ, "rank": RANK, "losses": losses,
        "refresh_step_ms": hist[0]["s_per_step"] * 1e3,
        "keep_step_ms": sum(h["s_per_step"] for h in hist[1:])
        / (BASELINE_STEPS - 1) * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start_bytes": at_start,
        "wall_s": wall,
        "launches": {k: v for k, v in counts.items() if v}}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return counts


def _nbytes(tree) -> int:
    """Bytes of every tensor in a state tree."""
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _state_bytes(state) -> dict:
    """An optimizer state's bytes by part."""
    rule = state.leaves[0]
    out = {"shared_bases": _nbytes(state.bases),
           "shared_bases_t": _nbytes(state.bases_t)}
    if "lowrank" in rule:
        leaves = list(rule["lowrank"].values())
        out.update(projector_state=sum(_nbytes(x.proj) for x in leaves),
                   low_rank_moments=sum(_nbytes((x.m, x.v)) for x in leaves),
                   error_feedback=sum(_nbytes(x.ef) for x in leaves),
                   full_rank_adam=_nbytes(rule["full"]))
    else:
        out["full_rank_adam"] = _nbytes(rule)
    out["total"] = _nbytes(state)
    return out


def _once_ms(fn) -> float:
    """Device time of one call (CUDA events), for work too slow to repeat."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def baseline_states_and_updates(torch, dev) -> None:
    """Phase 14: each baseline's optimizer state in bytes and the time of a
    refresh update and of a keep update, through the API on one gradient
    of llama-350m at batch 8 x 512, each alone between CUDA events (updates
    are functional, so a call repeats): the mean of 3 calls after an
    untimed one, but a refresh that takes over a second (the SVD's; the
    runs before warmed cuSOLVER) is timed once."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train import steps as S

    cfg = get_config("llama-350m")
    params = T.init_params(cfg, 0, dev)
    batch = make_batch_fn(cfg, SEQ, BATCH, device=dev)(0)
    grads, _ = S.grad_fn(params, batch, cfg)
    grads, _ = S._clip_by_global_norm(grads, 1.0)
    del batch
    runs = {"dct_adamw (main path)": ("dct_adamw", {"rank": RANK,
                                                   "weight_decay": 0.01})}
    for name, (spec, _) in BASELINE_PATHS.items():
        args = _baseline_args(spec)
        if isinstance(spec, list):
            runs[name] = (args.optimizer,
                          train_cli._optimizer_kwargs(args, dev))
        else:
            kw = dict(spec)
            runs[name] = (kw.pop("name"), {"rank": args.rank,
                                           "weight_decay": 0.01, **kw})
    rows = {}
    for name, (preset, kw) in runs.items():
        opt = get_optimizer(preset, lr=0.01, **kw)
        state = opt.init(params)
        refresh = lambda: opt.update(grads, state, params)  # noqa: E731
        refresh_ms = _once_ms(refresh)
        if refresh_ms < 1e3:       # cheap: the first call allocated; repeat
            refresh_ms = _time_ms(refresh, 3)
        _, after = refresh()
        keep_ms = _time_ms(lambda: opt.update(grads, after, params), 3)
        rows[name] = {"preset": preset, "options": kw,
                      "state_bytes": _state_bytes(state),
                      "refresh_update_ms": refresh_ms,
                      "keep_update_ms": keep_ms}
        del opt, state, after
        torch.cuda.empty_cache()
    print(json.dumps({"baseline_updates": rows,
                      "note": "update alone on one llama-350m gradient; "
                              "refresh = a state at step 0, keep = after "
                              "one update (ldadamw refreshes every step, "
                              "adamw has no basis)"}), flush=True)


def check_dense_refresh(torch, dev, seed: int) -> None:
    """Phase 14: GaLore's SVD basis and LDAdamW's power-iteration step on
    the card against float64 on the CPU, on a leaf with planted singular
    values; then the two refreshes timed at the main path's shapes."""
    import numpy as np

    from repro_torch.core.projectors import Projector

    layers, m, n = DENSE_SHAPE
    rng = np.random.default_rng(seed)
    # 128 singular values from 10 down to 5, the rest from 1 down to 0.1:
    # neighbours 0.4-0.8% apart and a 5x gap at the cut
    s = np.concatenate([np.linspace(10.0, 5.0, RANK),
                        np.linspace(1.0, 0.1, n - RANK)])
    g64 = np.empty(DENSE_SHAPE)
    for i in range(layers):
        u, _ = np.linalg.qr(rng.standard_normal((m, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        g64[i] = (u * s) @ v.T
    g32 = torch.from_numpy(g64.astype(np.float32))
    g64 = g32.double()                  # the same G, in float64
    t0 = time.perf_counter()
    v_ref = torch.linalg.svd(g64, full_matrices=False).Vh[:, :RANK].mT
    eye = torch.eye(n, RANK, dtype=torch.float64).expand(layers, n, RANK)
    p_ref = torch.linalg.qr(g64.mT @ (g64 @ eye)).Q
    ref_s = time.perf_counter() - t0
    g = g32.to(dev)
    out = {"shape": list(DENSE_SHAPE), "rank": RANK, "seed": seed,
           "reference_cpu_float64_s": ref_s}
    for kind, ref in (("svd", v_ref), ("power", p_ref)):
        proj = Projector(kind=kind, r=RANK)
        q = proj.update(g, proj.init(g.shape, dev))
        assert q.device == g.device and q.dtype == torch.float32, kind
        ortho = (q.mT @ q - torch.eye(RANK, device=dev)).abs().max().item()
        q64 = q.double().cpu()
        # the bar on Q_card itself, and on its span alone (Q_card made
        # orthonormal in float64: a basis a little off orthonormal can
        # read cosines above 1)
        cos = torch.linalg.svdvals(q64.mT @ ref)
        span = torch.linalg.svdvals(torch.linalg.qr(q64).Q.mT @ ref)
        out[kind] = {"min_cosine": cos.min().item(),
                     "max_cosine": cos.max().item(),
                     "span_one_minus_min_cosine": 1.0 - span.min().item(),
                     "orthonormality_max_abs": ortho}
    print(json.dumps({"dense_refresh_check": out}), flush=True)
    for kind in ("svd", "power"):
        assert out[kind]["min_cosine"] >= 1.0 - DENSE_SPAN_TOL, (kind, out)
        assert out[kind]["span_one_minus_min_cosine"] <= DENSE_SPAN_TOL, \
            (kind, out)
        assert out[kind]["orthonormality_max_abs"] <= DENSE_ORTHO_TOL, \
            (kind, out)
    # the refreshes at the main path's shapes: 4 leaves of (24, 1024, 1024)
    # and 3 of (24, 2816, 1024) per refresh step
    gen = torch.Generator(device=dev).manual_seed(seed)
    times = {}
    for shape, _ in MAIN_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev)
        for kind in ("svd", "power"):
            proj = Projector(kind=kind, r=RANK)
            prev = proj.init(shape, dev)
            fn = lambda: proj.update(x, prev)  # noqa: E731
            times[f"{kind} {shape}"] = (_once_ms(fn) if kind == "svd"
                                        else _time_ms(fn, 3))
        del x
    for kind in ("svd", "power"):
        times[f"{kind} per refresh step (7 leaves)"] = sum(
            times[f"{kind} {shape}"] * k for shape, k in MAIN_SHAPES)
    print(json.dumps({"dense_refresh_ms": times}), flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 15: the training substrate
# ---------------------------------------------------------------------------
def _cli_run(torch, argv, stop_at=None, steps=STEPS):
    """One in-process run of the training CLI's path (``launch.train.run``),
    the counters zeroed just before it and read just after; each kernel of
    the step must have run 7 times per step. Returns the history, the
    counts and the peak device memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer = train_cli.run(train_cli.build(argv), stop_at)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts(ops.TRAINING)
    hist = trainer.metrics_history
    assert len(hist) == steps, (argv, len(hist))
    for name, n in counts.items():
        assert n == LAUNCHES_PER_STEP * steps, \
            f"{argv}: {name} ran {n} times in {steps} steps, expected " \
            f"{LAUNCHES_PER_STEP * steps}"
    return hist, counts, peak


def _ms_after_first(hist) -> float:
    return sum(h["s_per_step"] for h in hist[1:]) / (len(hist) - 1) * 1e3


def _prom_means(path: Path) -> dict:
    """``{name: sum / count}`` of every histogram, and every counter, of a
    Prometheus text file."""
    vals = {}
    for line in path.read_text().splitlines():
        if line and not line.startswith("#") and "{" not in line:
            name, value = line.split()
            vals[name] = float(value)
    out = {k: v for k, v in vals.items()
           if not k.endswith(("_sum", "_count"))}
    for k, v in vals.items():
        if k.endswith("_sum") and vals.get(k[:-4] + "_count"):
            out[k[:-4] + "_mean"] = v / vals[k[:-4] + "_count"]
    return out


def _same_bits(a, b) -> bool:
    """The same dtype, shape and bytes (NaN and -0.0 included)."""
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def _guard_overhead(torch, main_losses) -> dict:
    """s_per_step and peak memory without and with ``--resilient`` (the
    guard, the ladder and ``lr_scale``), in turns: plain, resilient,
    resilient, plain. Each run's losses equal phase 3's bit for bit."""
    runs = {"plain": [], "resilient": []}
    peaks = {}
    for name in ("plain", "resilient", "resilient", "plain"):
        argv = TRAIN_ARGV + (["--resilient"] if name == "resilient" else [])
        hist, _, peak = _cli_run(torch, argv)
        losses = [h["loss"] for h in hist]
        assert losses == main_losses, (name, losses, main_losses)
        if name == "resilient":
            assert all(h["all_finite"] == 1.0 for h in hist), hist
        runs[name].append(_ms_after_first(hist))
        peaks[name] = max(peaks.get(name, 0), peak)
    plain, res = (sum(v) / len(v) for v in (runs["plain"],
                                            runs["resilient"]))
    return {"ms_per_step_after_first": runs,
            "plain_ms": plain, "resilient_ms": res,
            "resilient_over_plain": res / plain,
            "max_memory_allocated_bytes": peaks}


def _resume(torch, main_losses) -> dict:
    """(a): ``--resilient --ckpt-dir --ckpt-every 2 --obs-dir``, stopped
    after step SUBSTRATE_STOP, then a second run that resumes from its
    checkpoint; steps 1-6 of the two equal phase 3's losses bit for bit."""
    from repro_torch import obs

    ck, od = SUBSTRATE_DIR / "resume", SUBSTRATE_DIR / "obs"
    argv = TRAIN_ARGV + ["--resilient", "--ckpt-dir", str(ck),
                         "--ckpt-every", "2", "--obs-dir", str(od)]
    obs.reset()
    try:
        first, _, peak1 = _cli_run(torch, argv, SUBSTRATE_STOP,
                                   SUBSTRATE_STOP)
        saved = sorted(p.name for p in ck.iterdir())
        assert saved == ["step_2", f"step_{SUBSTRATE_STOP}"], saved
        ckpt_bytes = (ck / f"step_{SUBSTRATE_STOP}" / "state.npz").stat(
            ).st_size
        # keep two checkpoints on disk at most (2.6 GB each)
        shutil.rmtree(ck / "step_2")
        second, _, peak2 = _cli_run(torch, argv, None,
                                    STEPS - SUBSTRATE_STOP)
    finally:
        obs.disable()
    assert [h["step"] for h in second] == list(
        range(SUBSTRATE_STOP + 1, STEPS + 1)), second
    losses = [h["loss"] for h in first + second]
    assert losses == main_losses, (losses, main_losses)
    prom = _prom_means(od / "metrics.prom")
    obs.reset()
    keys = ("train_data_wait_seconds_mean", "train_dispatch_seconds_mean",
            "train_host_sync_seconds_mean", "train_step_seconds_mean",
            "ckpt_snapshot_seconds_mean", "ckpt_save_seconds_mean",
            "ckpt_restore_seconds_mean", "ckpt_bytes_written_total",
            "ckpt_saves_total", "ckpt_restores_total")
    return {"losses": losses, "equal_to_phase_3": True,
            "checkpoint_file_bytes": ckpt_bytes,
            "checkpoint_leaf_bytes": prom["ckpt_bytes_written_total"]
            / prom["ckpt_saves_total"],
            "max_memory_allocated_bytes": max(peak1, peak2),
            **{k: prom[k] for k in keys},
            "trace_json_bytes": (od / "trace.json").stat().st_size}


def _refused_step(torch, dev) -> dict:
    """(b): a chaos NaN on data step 1 makes the guarded step refuse with
    the fused kernels launched; every tensor of the pre-step state, cloned,
    is bit-equal to the state after it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train import steps as S
    from repro_torch.train.chaos import ChaosPlan, Fault
    from repro_torch.train.checkpoint import tree_items
    from repro_torch.train.schedule import cosine_warmup

    cfg = get_config("llama-350m")
    opt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, STEPS),
                        rank=RANK, weight_decay=0.01, lr_scale=True)
    plan = ChaosPlan([Fault(step=1, site="grads", mode="nan")])
    step = S.make_train_step(cfg, opt, guard=True, chaos=plan)
    batch_fn = plan.wrap_batch_fn(make_batch_fn(cfg, SEQ, BATCH,
                                                device=dev))
    state, m = step(S.init_state(cfg, opt, 0, dev), batch_fn(0))
    assert bool(m["all_finite"]) and state.step == 1
    before = [t.clone() for _, t in tree_items(state)
              if isinstance(t, torch.Tensor)]
    ops.reset_launch_counts()
    after, m = step(state, batch_fn(1))
    torch.cuda.synchronize()
    counts = ops.launch_counts(ops.TRAINING)
    assert not bool(m["all_finite"]), m
    assert after.step == state.step == 1 and after.opt_state.step == 1
    now = [t for _, t in tree_items(after) if isinstance(t, torch.Tensor)]
    assert len(now) == len(before)
    assert all(_same_bits(a, b) for a, b in zip(now, before)), \
        "a refused step changed the pre-step state"
    for name, n in counts.items():
        assert n == LAUNCHES_PER_STEP, f"refused step: {name} ran {n}"
    state, m = step(after, batch_fn(2))
    assert bool(m["all_finite"]) and state.step == 2
    return {"refused_step_bit_equal": True, "tensors": len(before),
            "state_bytes": sum(t.numel() * t.element_size() for t in before),
            "launches": counts, "recovered_loss": float(m["loss"])}


def _supervised(torch) -> dict:
    """(c): ``--supervise`` with a checkpoint ``sigkill`` at ``mid_write``:
    the first child dies writing step SUPERVISED_KILL's checkpoint, the
    supervisor restarts it, the second resumes from step 2 and finishes.
    Full width and depth (the CLI has no depth option), fresh processes."""
    ck = SUBSTRATE_DIR / "supervised"
    plan = SUBSTRATE_DIR / "sigkill.json"
    plan.write_text(json.dumps([{"step": SUPERVISED_KILL,
                                 "site": "checkpoint", "mode": "sigkill",
                                 "arg": "mid_write"}]))
    argv = [a for a in TRAIN_ARGV]
    argv[argv.index("--steps") + 1] = str(SUPERVISED_STEPS)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv,
           "--ckpt-dir", str(ck), "--ckpt-every", "2", "--chaos", str(plan),
           "--supervise"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    text = out.stdout + out.stderr
    assert out.returncode == 0, text[-4000:]
    assert text.count("[supervisor] launching") == 2, text[-4000:]
    assert f"SIGKILL at checkpoint step {SUPERVISED_KILL}" in text, \
        text[-4000:]
    assert "resumed from checkpoint step 2" in text, text[-4000:]
    assert f"[train] done at step {SUPERVISED_STEPS}" in text, text[-4000:]
    steps = sorted(p.name for p in ck.iterdir() if p.name.startswith("step"))
    assert steps == ["step_2", f"step_{SUPERVISED_KILL}"], steps
    return {"supervised_rc": out.returncode, "children": 2,
            "killed_at": f"checkpoint step {SUPERVISED_KILL} mid_write",
            "resumed_from": 2, "wall_s": wall,
            "cut": "none: full width and depth (24 layers)"}


def _halt(torch) -> dict:
    """(d): NaN gradients on every batch exhaust the ladder (one skip, one
    rollback): the CLI returns 86 and writes halt.json."""
    from repro_torch.launch import train as train_cli
    from repro_torch.train.resilience import HALT_EXIT_CODE

    ck = SUBSTRATE_DIR / "halt"
    plan = SUBSTRATE_DIR / "nan.json"
    plan.write_text(json.dumps([{"step": list(range(4 * STEPS)),
                                 "site": "grads", "mode": "nan"}]))
    rc = train_cli.main(TRAIN_ARGV + [
        "--resilient", "--ckpt-dir", str(ck), "--chaos", str(plan),
        "--max-skips", "1", "--max-rollbacks", "1"])
    assert rc == HALT_EXIT_CODE == 86, rc
    rec = json.loads((ck / "halt.json").read_text())
    assert rec["halted"] and rec["ladder"]["n_rollbacks"] == 2, rec
    return {"halt_rc": rc, "ladder": rec["ladder"]}


def run_substrate(torch, dev, main_losses) -> None:
    """Phase 15: the training substrate on the card (the main path's
    configuration through ``repro_torch.launch.train``)."""
    t0 = time.perf_counter()
    shutil.rmtree(SUBSTRATE_DIR, ignore_errors=True)
    SUBSTRATE_DIR.mkdir(parents=True)
    try:
        out = {"guard": _guard_overhead(torch, main_losses)}
        out["resume"] = _resume(torch, main_losses)
        torch.cuda.empty_cache()
        out["refused_step"] = _refused_step(torch, dev)
        torch.cuda.empty_cache()
        out["halt"] = _halt(torch)
        torch.cuda.empty_cache()
        out["supervisor"] = _supervised(torch)
    finally:
        shutil.rmtree(SUBSTRATE_DIR, ignore_errors=True)
    print(json.dumps({"substrate": out, "device": _device_line(),
                      "substrate_phase_wall_s": time.perf_counter() - t0}),
          flush=True)


# ---------------------------------------------------------------------------
# phase 16: subspace telemetry and closed-loop rank / refresh control
# ---------------------------------------------------------------------------
def _profile_step_and_fetch(torch, step, state, batch):
    """One train step and the Trainer's host conversion of its metrics
    (each scalar, then the telemetry tree in one piece) under the
    profiler: device kernels, device -> host copies, and the CPU side's
    kernel launch and copy calls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry.stats import to_host

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, m = step(state, batch)
        host = {k: v if k == "telemetry" else float(v) for k, v in m.items()}
        if "telemetry" in host:
            host["telemetry"] = to_host(host["telemetry"])
        torch.cuda.synchronize()
    dev_events, busy_ms = _device_kernels(prof)
    dtoh = sum(e.count for e in dev_events if "DtoH" in e.key)
    memcpy = sum(e.count for e in dev_events if "Memcpy" in e.key
                 or "Memset" in e.key)
    cpu = {e.key: e.count for e in prof.key_averages()
           if e.key.startswith(("cudaLaunchKernel", "cudaMemcpy"))}
    return {"device_kernels": sum(e.count for e in dev_events) - memcpy,
            "device_busy_ms": busy_ms, "device_dtoh_copies": dtoh,
            "cuda_launch_calls": sum(v for k, v in cpu.items()
                                     if k.startswith("cudaLaunchKernel")),
            "cuda_memcpy_calls": sum(v for k, v in cpu.items()
                                     if k.startswith("cudaMemcpy"))}


def _telemetry_on(torch, dev, main_losses) -> dict:
    """(a): ``--telemetry jsonl --telemetry-every 2``, 6 steps through the
    CLI: losses bit-equal to phase 3's, 7 launches of each kernel a step,
    every row finite with captured energy in [0, 1]; then one step without
    and with telemetry under the profiler, in turns (off, on, on, off), with
    the Trainer's host conversion: the launches and device time telemetry
    adds and its device -> host copies (one a step)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train import steps as S
    from repro_torch.train.schedule import cosine_warmup

    path = TELEMETRY_DIR / "telemetry.jsonl"
    hist, counts, peak = _cli_run(torch, TRAIN_ARGV + [
        "--telemetry", "jsonl", "--telemetry-every", "2",
        "--telemetry-path", str(path)])
    losses = [h["loss"] for h in hist]
    assert losses == main_losses, (losses, main_losses)
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [2.0, 4.0, 6.0], rows
    stats = {k: v for r in rows for k, v in r.items()
             if k.startswith("telemetry/")}
    assert len(stats) == 7 * 5, sorted(stats)
    for r in rows:
        for k, v in r.items():
            vals = v if isinstance(v, list) else [v]
            assert all(math.isfinite(x) for x in vals), (k, v)
            if k.endswith("/captured_energy"):
                assert len(vals) == LAYERS
                assert all(0.0 <= x <= 1.0 for x in vals), (k, v)

    cfg = get_config("llama-350m")
    opt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, STEPS),
                        rank=RANK, weight_decay=0.01)
    state = S.init_state(cfg, opt, 0, dev)
    batch = make_batch_fn(cfg, SEQ, BATCH, device=dev)(0)
    steps = {tel: S.make_train_step(cfg, opt, telemetry=tel == "on")
             for tel in ("off", "on")}
    for step in steps.values():
        step(state, batch)                       # warm
    prof = {"off": [], "on": []}
    for tel in ("off", "on", "on", "off"):
        prof[tel].append(_profile_step_and_fetch(torch, steps[tel], state,
                                                 batch))
    del state
    on, off = ({k: sum(p[k] for p in prof[t]) / 2 for k in prof[t][0]}
               for t in ("on", "off"))
    extra = {k: on[k] - off[k] for k in on}
    for p_on in prof["on"]:
        for p_off in prof["off"]:
            assert p_on["device_dtoh_copies"] \
                - p_off["device_dtoh_copies"] == 1, prof
    mean = {k.split("/")[-1]: [] for k in stats}
    for k, v in stats.items():
        mean[k.split("/")[-1]].extend(v)
    return {"losses_equal_to_phase_3": True, "launches": counts,
            "launches_per_step": {k: v / STEPS for k, v in counts.items()},
            "rows": len(rows), "ms_per_step_after_first":
            _ms_after_first(hist), "max_memory_allocated_bytes": peak,
            "profiled_step_and_fetch": prof, "telemetry_adds": extra,
            "row_means": {k: sum(v) / len(v) for k, v in mean.items()}}


def _captured_energy_vs_float64(torch, dev) -> dict:
    """(b): one leaf's gradient of the main path (``mlp/wg``, oriented
    (24, 2816, 1024)) through the rule on the kernel path under a
    collector: its captured energy against float64 numpy's ||G Q_r||^2 /
    ||G||^2 at the indices the rule selected, per layer."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.core.transforms import shared_basis
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.optim.common import Context
    from repro_torch.optim.projected_adam import ProjectedAdamRule
    from repro_torch.optim.transform import transposed
    from repro_torch.telemetry.stats import collect
    from repro_torch.train import steps as S

    cfg = get_config("llama-350m")
    params = T.init_params(cfg, 0, dev)
    batch = make_batch_fn(cfg, SEQ, BATCH, device=dev)(0)
    path = "segments/0/p0/mlp/wg/kernel"
    grads, _ = S.grad_fn(params, batch, cfg)
    g = grads[path]
    del grads, params
    n = min(g.shape[-2:])
    bases = {str(n): shared_basis("dct", n, device=dev)}
    rule = ProjectedAdamRule(rank=RANK, fused="on")
    state = rule.init(g.shape, g.dtype, dev)
    with collect() as col:
        ctx = Context(step=1, bases=bases, bases_t=transposed(bases),
                      stats=col.scope(path))
        _, new = rule.update(g, state, None, ctx)
    ce = col.tree()[path].captured_energy.cpu().numpy().astype(np.float64)
    g64 = g.transpose(-1, -2).double().cpu().numpy()        # oriented
    q64 = bases[str(n)].double().cpu().numpy()
    idx = new.proj.long().cpu().numpy()
    want = np.array([np.sum((g64[i] @ q64[:, idx[i]]) ** 2)
                     / np.sum(g64[i] ** 2) for i in range(g64.shape[0])])
    rel = float(np.max(np.abs(ce - want) / want))
    assert rel <= ENERGY_RTOL, (rel, ce, want)
    return {"leaf": path, "oriented_shape": list(g64.shape),
            "max_rel_err_vs_float64": rel, "captured_energy_min":
            float(want.min()), "captured_energy_max": float(want.max())}


def check_kernels_at_rank(torch, dev, r: int, shape) -> dict:
    """(c): the four kernels of the step against their plain versions at
    an allocated rank ``r``, fp32 and int8, at the leaf's oriented
    ``shape`` (G with ``r`` planted columns): ``dct_project`` (S within
    1e-5 of max |S|, norms 1e-5 relative, the same top-r; int8 S equal),
    ``colgather_matmul_dual`` on the selected columns (1e-5 of max |out|,
    relaunch bit-identical; int8 equal given the plain quantizers'
    operands, its quantizers' codes and scales equal), ``quantize_ef``
    (scales equal, codes within 1) and ``dequant_add_ef`` (exact), as
    phases 2 and 10 hold them at r = 128."""
    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.selection import select_top_r, take_columns
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    dp = importlib.import_module("repro_torch.kernels.dct_project")
    from repro_torch.kernels import lowp
    from repro_torch.kernels import quant_ef as qe

    gen = torch.Generator(device=dev).manual_seed(16)
    n = shape[-1]
    q = dct2_matrix(n, device=dev)
    qt = q.T.contiguous()
    g = _planted(shape, q, gen, r)
    out = {"rank": r, "shape": list(shape), "r_mod_16": r % 16}
    s_k, n_k = dp.dct_project(g, q)
    s_p, n_p = dp.dct_project_plain(g, q)
    idx = select_top_r(n_k, r)
    torch.cuda.synchronize()
    out["dct_project_rel_err"] = _rel(s_k, s_p)
    assert out["dct_project_rel_err"] <= 1e-5, out
    norm_rel = ((n_k - n_p).abs() / n_p.clamp_min(1e-30)).max().item()
    assert norm_rel <= 1e-5 and torch.equal(idx, select_top_r(n_p, r)), \
        (r, norm_rel)
    b1 = take_columns(s_k, idx).contiguous()
    b2 = torch.randn(b1.shape, generator=gen, device=dev)
    del s_p, n_p
    o_k = cg.colgather_matmul_dual(b1, b2, qt, idx)
    o_p = cg.colgather_matmul_dual_plain(b1, b2, qt, idx)
    again = cg.colgather_matmul_dual(b1, b2, qt, idx)
    torch.cuda.synchronize()
    out["colgather_matmul_dual_rel_err"] = max(
        _rel(a, b) for a, b in zip(o_k, o_p))
    assert out["colgather_matmul_dual_rel_err"] <= 1e-5, out
    assert all(map(torch.equal, again, o_k)), f"colgather relaunch, r={r}"
    resid = g - o_k[1]
    q_k, sc_k = qe.quantize_ef(resid)
    q_p, sc_p = qe.quantize_ef_plain(resid)
    ef_k = qe.dequant_add_ef(g, q_k, sc_k)
    ef_p = qe.dequant_add_ef_plain(g, q_k, sc_k)
    torch.cuda.synchronize()
    dq = (q_k.int() - q_p.int()).abs().max().item()
    assert torch.equal(sc_k, sc_p) and dq <= 1, (r, dq)
    assert torch.equal(ef_k, ef_p), f"dequant_add_ef, r={r}"
    out["quantize_ef_max_abs_dq"] = dq
    del o_k, o_p, again, resid, q_k, q_p, ef_k, ef_p
    # int8: the projection and the dual colgather at the same rank
    gq, sg = lowp.quant_rows(g)
    qq, sq = lowp.quant_cols(q)
    s8, n8 = dp.dct_project(g, q, compute_dtype="int8")
    s8p, n8p = dp.dct_project_q8_plain(gq, sg, qq, sq)
    torch.cuda.synchronize()
    assert torch.equal(s8, s8p), f"dct_project_q8, r={r}"
    idx8 = select_top_r(n8, r)
    assert torch.equal(idx8, select_top_r(n8p, r)), f"int8 top-r, r={r}"
    del s8p, gq, qq
    b1 = take_columns(s8, idx8).contiguous()
    ops_k = cg.quantize_operands((b1, b2), qt, idx8)
    ops_p = cg.quantize_operands_plain((b1, b2), qt, idx8)
    o8 = cg.colgather_matmul_dual(b1, b2, qt, idx8, compute_dtype="int8")
    o8p = cg.colgather_q8_plain(*ops_p, idx8)
    torch.cuda.synchronize()
    assert torch.equal(ops_k[1], ops_p[1]) and all(
        torch.equal(x, y) for kp, pp in zip(ops_k[0], ops_p[0])
        for x, y in zip(kp, pp)), f"int8 colgather quantizers, r={r}"
    assert all(map(torch.equal, o8, o8p)), f"colgather_matmul_dual_q8, r={r}"
    out["int8"] = ("dct_project_q8, its quantizers and "
                   "colgather_matmul_dual_q8 bit-equal")
    del g, s_k, s8, b1, b2, o8, o8p, ops_k, ops_p
    torch.cuda.empty_cache()
    return out


def _adaptive_trainer(torch, dev, ckpt_dir=None, record=None):
    """The closed loop at the main path's configuration through the API:
    DCT-AdamW rank 128 rebuilt by a RankAllocator(deadband 0, decide every
    2 steps) from the telemetry, the CLI's schedule, batches and seed.
    ``record`` gets each step's launch counts, the rebuilds' memory and
    the manager's log lines."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import get_optimizer
    from repro_torch.telemetry.adaptive import AdaptiveOptimizerManager
    from repro_torch.telemetry.controllers import (RankAllocator,
                                                   RankAllocatorConfig,
                                                   leaf_inventory)
    from repro_torch.train import steps as S
    from repro_torch.train.loop import Trainer
    from repro_torch.train.schedule import cosine_warmup

    cfg = get_config("llama-350m")
    lr = cosine_warmup(0.01, 2, STEPS)
    record = record if record is not None else {}
    record.setdefault("log", [])
    mgr = AdaptiveOptimizerManager(
        make_optimizer=lambda ov=None: get_optimizer(
            "dct_adamw", lr=lr, rank=RANK, weight_decay=0.01, overrides=ov),
        make_step=lambda opt: S.make_train_step(cfg, opt, telemetry=True),
        make_train_state=lambda opt: S.init_state(cfg, opt, 0, dev),
        rank_allocator=RankAllocator(
            RankAllocatorConfig(base_rank=RANK, **ADAPTIVE_ALLOC),
            leaf_inventory(T.init_params(cfg, 0, "meta"))),
        log_fn=record["log"].append)
    last = {}

    def log_metrics(rec):
        now = ops.launch_counts(ops.TRAINING)
        record.setdefault("per_step", []).append(
            {k: v - last.get(k, 0) for k, v in now.items()})
        last.update(now)

    def control_hook(step, state, metrics):
        record["run_peak"] = max(record.get("run_peak", 0),
                                 torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        new = mgr.control_hook(step, state, metrics)
        if new is not None:
            record.setdefault("rebuilds", []).append({
                "step": step, "allocated_before": before,
                "peak_during": torch.cuda.max_memory_allocated(),
                "allocated_after": torch.cuda.memory_allocated()})
        return new

    trainer = Trainer(train_step=mgr.step, init_state_fn=mgr.init_state,
                      batch_fn=make_batch_fn(cfg, SEQ, BATCH, seed=0,
                                             device=dev),
                      control_hook=control_hook, extra_state=mgr,
                      log_metrics=log_metrics, ckpt_dir=ckpt_dir,
                      ckpt_every=2, log_every=100, log_fn=lambda s: None)
    return trainer, mgr


def _adaptive_rank(torch, dev, main_losses) -> tuple[dict, list]:
    """(c): the closed loop through the API, 6 steps: at least one rebuild
    to a non-uniform allocation within the weighted budget, each leaf's
    moments shaped (24, rows, r_leaf), 7 launches of each kernel every step
    (after the rebuild too), finite losses, steps 1-2 (before the first
    decision) equal to phase 3's; the peak memory against phase 3's and the
    rebuild's own; then the kernels at an allocated rank off a multiple of
    16. Returns the summary and the losses."""
    from repro_torch.core.transforms import basis_cache
    from repro_torch.kernels import ops
    from repro_torch.optim.common import oriented_dims

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    record = {}
    cache0 = basis_cache().stats()
    trainer, mgr = _adaptive_trainer(torch, dev, record=record)
    state = trainer.run(total_steps=STEPS)
    torch.cuda.synchronize()
    peak = max(record.get("run_peak", 0), torch.cuda.max_memory_allocated())
    losses = [h["loss"] for h in trainer.metrics_history]
    assert len(losses) == STEPS and all(map(math.isfinite, losses)), losses
    assert losses[:2] == main_losses[:2], (losses, main_losses)
    alloc = dict(mgr.rank_allocator.alloc)
    assert mgr.n_rebuilds >= 1, record["log"]
    assert len(set(alloc.values())) > 1, alloc
    leaves = mgr.rank_allocator.leaves
    used = sum(leaves[p].rows * r for p, r in alloc.items())
    assert used <= mgr.rank_allocator.budget, (used, alloc)
    lowrank = state.opt_state.leaves[0]["lowrank"]
    for path, leaf in lowrank.items():
        rows = oriented_dims(state.params[path].shape)[0]
        want = (LAYERS, rows, alloc[path])
        assert tuple(leaf.m.shape) == tuple(leaf.v.shape) == want, \
            (path, leaf.m.shape, want)
    for i, counts in enumerate(record["per_step"], 1):
        for name, c in counts.items():
            assert c == LAUNCHES_PER_STEP, (i, name, c)
    cache = basis_cache().stats()
    # the kernels at an allocated rank that is not a multiple of 16
    off16 = sorted((r, p) for p, r in alloc.items() if r % 16)
    r, path = off16[0] if off16 else (OFF16_RANK, next(iter(alloc)))
    shape = (LAYERS, *oriented_dims(state.params[path].shape))
    del state, trainer, lowrank
    gc.collect()
    torch.cuda.empty_cache()
    at_rank = check_kernels_at_rank(torch, dev, r, shape)
    at_rank["rank_from"] = path if off16 else "OFF16_RANK (none allocated)"
    return {"rebuilds": mgr.n_rebuilds, "allocation": alloc,
            "ranks": sorted(set(alloc.values())),
            "budget_used": used, "budget": mgr.rank_allocator.budget,
            "losses": losses, "launches_per_step": record["per_step"],
            "max_memory_allocated_bytes": peak,
            "phase_3_max_memory_allocated_bytes":
            MAIN_PATH.get("max_memory_allocated_bytes"),
            "peak_over_phase_3_bytes": peak
            - MAIN_PATH.get("max_memory_allocated_bytes", peak),
            "rebuild_memory": record.get("rebuilds"),
            "basis_cache": {"before": cache0, "after": cache},
            "manager_log": record["log"],
            "kernels_at_allocated_rank": at_rank}, losses


def _adaptive_refresh(torch, rank: int, steps: int) -> dict:
    """(d): ``--adaptive-refresh --control-every 2`` through the CLI, with
    ``--telemetry jsonl --telemetry-every 1`` (a row a step): keep steps
    report the -1 sentinels; ``dct_project`` runs once per leaf and refresh
    step (7 a step that refreshes every leaf, 0 a keep step), the other
    three kernels 7 a step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    path = TELEMETRY_DIR / f"refresh_{rank}.jsonl"
    argv = [a for a in TRAIN_ARGV]
    argv[argv.index("--steps") + 1] = str(steps)
    argv[argv.index("--rank") + 1] = str(rank)
    argv += ["--adaptive-refresh", "--control-every", "2", "--telemetry",
             "jsonl", "--telemetry-every", "1", "--telemetry-path", str(path)]
    gc.collect()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_cli.run(train_cli.build(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts(ops.TRAINING)
    losses = [h["loss"] for h in trainer.metrics_history]
    assert len(losses) == steps and all(map(math.isfinite, losses)), losses
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(rows) == steps
    refresh, keep_steps = 0, []
    for row in rows:
        ov = {k: v for k, v in row.items() if k.endswith("/index_overlap")}
        mg = {k: v for k, v in row.items() if k.endswith("/topr_margin")}
        assert len(ov) == len(mg) == LAUNCHES_PER_STEP
        kept = [k for k, v in ov.items() if v[0] < 0]
        for k in kept:
            assert all(x == -1.0 for x in ov[k]), (row["step"], k)
            assert all(x == -1.0 for x in mg[k.replace("index_overlap",
                                                       "topr_margin")])
        refresh += len(ov) - len(kept)
        if len(kept) == len(ov):
            keep_steps.append(int(row["step"]))
    assert counts["dct_project"] == refresh, (counts, refresh)
    for name in ("dequant_add_ef", "colgather_matmul_dual", "quantize_ef"):
        assert counts[name] == LAUNCHES_PER_STEP * steps, (name, counts)
    drift = {int(r["step"]): sorted({round(1 - v[0], 4) for k, v in r.items()
                                     if k.endswith("/index_overlap")
                                     and v[0] >= 0}) for r in rows}
    return {"rank": rank, "steps": steps, "launches": counts,
            "leaf_refreshes": refresh, "keep_steps": keep_steps,
            "drift_by_step": drift, "losses": losses, "wall_s": wall}


def _adaptive_resume(torch, dev, adaptive_losses) -> dict:
    """(e): (c)'s loop with checkpoints every 2 steps, stopped after step
    4 (a rebuild at step 2, before its save), then resumed to 6 by a new
    manager and Trainer, which rebuild the optimizer from the manifest's
    allocation before the restore: the losses bit-equal to (c)'s."""
    ck = TELEMETRY_DIR / "ckpt"
    first, mgr1 = _adaptive_trainer(torch, dev, str(ck))
    first.run(total_steps=4)
    assert mgr1.n_rebuilds >= 1
    manifest = json.loads((ck / "step_4" / "manifest.json").read_text())
    saved = manifest["extra_state"]["rank_allocator"]["alloc"]
    assert saved == mgr1.rank_allocator.alloc
    losses = [h["loss"] for h in first.metrics_history]
    shutil.rmtree(ck / "step_2")                  # two on disk at most
    del first
    gc.collect()
    torch.cuda.empty_cache()
    second, mgr2 = _adaptive_trainer(torch, dev, str(ck))
    second.run(total_steps=STEPS)
    assert [h["step"] for h in second.metrics_history] == [5, 6]
    losses += [h["loss"] for h in second.metrics_history]
    assert losses == adaptive_losses, (losses, adaptive_losses)
    return {"losses_equal_to_c": True, "saved_allocation": saved,
            "rebuilds_before_save": mgr1.n_rebuilds,
            "rebuilds_after_resume": mgr2.n_rebuilds,
            "final_allocation": mgr2.rank_allocator.alloc}


def run_telemetry(torch, dev, main_losses) -> None:
    """Phase 16: subspace telemetry and closed-loop control on the card at
    the main path's configuration."""
    t0 = time.perf_counter()
    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    TELEMETRY_DIR.mkdir(parents=True)
    out = {}
    try:
        out["telemetry_on"] = _telemetry_on(torch, dev, main_losses)
        torch.cuda.empty_cache()
        out["captured_energy"] = _captured_energy_vs_float64(torch, dev)
        torch.cuda.empty_cache()
        out["adaptive_rank"], losses = _adaptive_rank(torch, dev, main_losses)
        torch.cuda.empty_cache()
        out["adaptive_refresh"] = []
        for rank, steps in REFRESH_RUNS:
            out["adaptive_refresh"].append(_adaptive_refresh(torch, rank,
                                                             steps))
            torch.cuda.empty_cache()
        assert out["adaptive_refresh"][-1]["keep_steps"], \
            out["adaptive_refresh"]
        out["resume"] = _adaptive_resume(torch, dev, losses)
    finally:
        shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    print(json.dumps({"telemetry": out, "device": _device_line(),
                      "telemetry_phase_wall_s": time.perf_counter() - t0}),
          flush=True)


def _config(arch: str, depth=None):
    """``arch`` at full width, its one schedule segment cut to ``depth``
    layers (``None``: the configuration's own depth)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if depth is None or depth == cfg.n_layers:
        return cfg
    (pattern, _), = cfg.schedule
    return dataclasses.replace(cfg, schedule=((pattern, depth),))


def check_config_kernels(torch, dev) -> dict:
    """Phase 17 (a): ``flash_decode`` and ``flash_attention_blockwise`` at
    the dense configurations' decode and prefill shapes against their plain
    versions, each timed per call beside its bound and SDPA on the same
    tensors. Returns ``{arch: {kernel: case}}``."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    f32, bf16 = torch.float32, torch.bfloat16
    maxb = -(-(GEMMA_PROMPT_LENS[1] + GEMMA_NEW) // BLOCK)
    run_blocks = sum(-(-n // BLOCK) for n in CONFIG_DECODE_LENS)
    b, s = GEMMA_PROMPTS
    out = {}
    for i, (arch, (hq, hkv, hd)) in enumerate(CONFIG_DECODE_SHAPES.items()):
        cfg = _config(arch)
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (hq, hkv, hd), arch
        # decode: the paged engine's slots, lengths up to a 2048-token
        # prompt and 32 new tokens
        args = _fd_case(torch, dev, 40 + i, b=GEMMA_SLOTS, hq=hq, hkv=hkv,
                        hd=hd, bs=BLOCK, maxb=maxb,
                        lengths=CONFIG_DECODE_LENS, kv_dtype=bf16)
        assert fd.vector_path(args[1], args[2]), arch
        errs = [_fd_compare(torch, fd, args, qd, sp)
                for qd in (f32, bf16) for sp in (1, NUM_SPLITS)]
        q, k, v, table, ln = args
        q = q.to(bf16)

        def call():
            return fd.flash_decode(q, k, v, table, ln, num_splits=NUM_SPLITS)

        tokens = int(ln.sum())
        nbytes = (tokens * hkv * hd * 2 * 2 + 2 * q.numel() * 2
                  + run_blocks * 4 + GEMMA_SLOTS * 4)
        flops = 4.0 * tokens * hq * hd
        bound, by = _bound_ms(nbytes, flops)
        decode = {
            "shape": [GEMMA_SLOTS, hq, hkv, hd], "lengths": CONFIG_DECODE_LENS,
            "splits": NUM_SPLITS, "max_abs_err": max(errs),
            "ms": _graph_ms(call, CONFIG_SERVE_DEPTHS[arch]),
            "wrapper_ms": _time_ms(call),
            "plain_ms": _time_ms(lambda: fd.flash_decode_plain(
                q, k, v, table, ln, num_splits=NUM_SPLITS), 3),
            "library_ms": _graph_ms(_fd_sdpa(torch, q, k, v, table, ln),
                                    CONFIG_SERVE_DEPTHS[arch]),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops}
        del q, k, v, table, ln, args
        # prefill: 2 x 2048, causal, the model's kv chunk
        qa, ka, va = _fa_inputs(torch, dev, 50 + i, b, s, hq, hkv, hd, bf16)
        chunk = cfg.kv_chunk
        gaps = _blockwise_compare(torch, fa, qa, ka, va, True, None, chunk)
        lib = _sdpa(torch, qa, ka, va, None)
        pairs = b * hq * _fa_pairs(s, True, None)
        flops = 4.0 * pairs * hd
        nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
        bound, by = _bound_ms(nbytes, flops, PEAK_BF16_PER_S)
        ms = _time_ms(lambda: fa.flash_attention_blockwise(
            qa, ka, va, kv_chunk=chunk))
        prefill = {
            "shape": [b, s, hq, hkv, hd], "kv_chunk": chunk, **gaps,
            "ms": ms, "tflop_per_s": flops / ms / 1e9,
            "plain_ms": _time_ms(lambda: fa.blockwise_attention_ref(
                qa, ka, va, causal=True, kv_chunk=chunk), 3),
            "library_ms": _time_ms(lib), "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "flops": flops}
        del qa, ka, va, lib
        torch.cuda.empty_cache()
        out[arch] = {"flash_decode": decode,
                     "flash_attention_blockwise": prefill}
        print(json.dumps({"config_kernels": arch, **out[arch],
                          "tolerance": "flash_decode: phase 5's; blockwise: "
                                       "phase 12's; each launched twice, "
                                       "bit-identical"}), flush=True)
    return out


def run_config_serving(torch, dev) -> dict:
    """Phase 17 (b): the dense and the paged engine of each configuration
    at ``CONFIG_SERVE_DEPTHS``, through phase 13's runs (their launch
    counts asserted there: ``depth`` per prefill, ``depth`` per decode
    step). Returns ``{arch: launches}``."""
    launches = {}
    for arch, depth in CONFIG_SERVE_DEPTHS.items():
        cfg = _config(arch, depth)
        name = f"{arch} depth {depth}"
        dense = run_dense_prefill(torch, dev, name, cfg)
        paged = run_paged(torch, dev, cfg, f"{name} bf16 "
                                 "PagedServeEngine, flash_decode")
        launches[arch] = {
            "flash_attention_blockwise_per_prefill":
                dense["flash_attention_blockwise"],
            "flash_decode_per_decode_step": depth,
            "flash_decode_in_paged_run": paged["flash_decode"]}
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _registry_depth(arch: str, depth):
    """The registry's ``arch`` cut to ``depth`` layers while the training
    CLI builds and runs (the CLI has no depth flag)."""
    from repro_torch.configs import registry

    full = registry.ARCHS[arch]
    registry.ARCHS[arch] = _config(arch, depth)
    try:
        yield registry.ARCHS[arch]
    finally:
        registry.ARCHS[arch] = full


def _config_update_profile(torch, dev, cfg, batch: int) -> dict:
    """The DCT-AdamW update of ``cfg`` alone on one clipped gradient: CUDA
    events (mean of 2) and one update under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train import steps as S

    torch.cuda.reset_peak_memory_stats()
    opt = get_optimizer("dct_adamw", lr=0.01, rank=RANK, weight_decay=0.01)
    state = S.init_state(cfg, opt, 0, dev)
    grads, _ = S.grad_fn(state.params,
                         make_batch_fn(cfg, SEQ, batch, device=dev)(0), cfg)
    grads, _ = S._clip_by_global_norm(grads, 1.0)
    ms = _time_ms(lambda: opt.update(grads, state.opt_state, state.params), 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.update(grads, state.opt_state, state.params)
        torch.cuda.synchronize()
    kernels, busy_ms = _device_kernels(prof)
    by_kernel = {}
    for e in kernels:
        name = next((k for k in ("dct_project", "colgather_matmul",
                                 "dequant_add", "quantize_ef")
                     if k in e.key), "other")
        by_kernel[name] = by_kernel.get(name, 0.0) + _dev_us(e) / 1e3
    return {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "optimizer_update_ms": ms, "optimizer_update_device_ms": busy_ms,
            "optimizer_update_device_ms_by_kernel": by_kernel,
            "optimizer_update_launches": sum(e.count for e in kernels),
            "optimizer_update_top_kernels": _top(kernels, 10)}


def run_config_training(torch, dev, update_depth=None) -> dict:
    """Phase 17 (c): DCT-AdamW through the training CLI on the
    configurations of ``CONFIG_TRAIN_RUNS``, counters zeroed just before
    each run and read just after (7 launches of each of the four kernels
    per step, asserted by ``_cli_run``). Returns ``{arch: launches per
    step}``. ``update_depth``: the depth of the update-alone profile, in
    place of ``CONFIG_UPDATE_PROFILE``'s."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    out = {}
    for arch, depth, batch in CONFIG_TRAIN_RUNS:
        argv = ["--arch", arch, "--optimizer", "dct_adamw", "--rank",
                str(RANK), "--steps", str(CONFIG_TRAIN_STEPS), "--warmup",
                "2", "--batch", str(batch), "--seq-len", str(SEQ),
                "--log-every", "1"]
        with _registry_depth(arch, depth) as cfg:
            t0 = time.perf_counter()
            hist, counts, peak = _cli_run(torch, argv,
                                          steps=CONFIG_TRAIN_STEPS)
            wall = time.perf_counter() - t0
        assert not any(ops.launch_counts(ops.ATTENTION).values()), arch
        losses = [h["loss"] for h in hist]
        assert all(math.isfinite(x) for x in losses), (arch, losses)
        ms = _ms_after_first(hist)
        gc.collect()
        torch.cuda.empty_cache()
        summary = {
            "config_training": f"{arch} depth {cfg.n_layers} dct_adamw rank "
                               f"{RANK} fused auto->on",
            "param_dtype": cfg.param_dtype, "qkv_bias": cfg.qkv_bias,
            "params": T.param_count(T.init_params(cfg, 0, "meta")),
            "steps": CONFIG_TRAIN_STEPS, "batch": batch, "seq_len": SEQ,
            "losses": losses, "first_step_ms": hist[0]["s_per_step"] * 1e3,
            "ms_per_step_after_first": ms,
            "tokens_per_s": batch * SEQ / (ms / 1e3),
            "max_memory_allocated_bytes": peak, "wall_s": wall,
            "launches_per_step": {k: v / CONFIG_TRAIN_STEPS
                                  for k, v in counts.items()}}
        print(json.dumps(summary), flush=True)
        out[arch] = summary["launches_per_step"]
    arch, depth, batch = CONFIG_UPDATE_PROFILE
    cfg = _config(arch, update_depth or depth)
    print(json.dumps({"config_update_alone": f"{arch} depth {cfg.n_layers} "
                                             f"dct_adamw rank {RANK}",
                      **_config_update_profile(torch, dev, cfg, batch)}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_dense_configs(torch, dev) -> dict:
    """Phase 17: (a) the kernels at the configurations' shapes, (b)
    serving, (c) training. Returns the kernels line's additions."""
    t0 = time.perf_counter()
    cases = check_config_kernels(torch, dev)
    serving = run_config_serving(torch, dev)
    training = run_config_training(torch, dev)
    print(json.dumps({"dense_configs_phase_wall_s": time.perf_counter() - t0}),
          flush=True)
    return {"cases": cases, "serving": serving, "training": training}



# ---------------------------------------------------------------------------
# phase 18: the rest of the transform-chain runtime
# ---------------------------------------------------------------------------
def _timed_step(torch, step, state, batch):
    """One train step, the counters zeroed just before it and read just
    after. Returns the new state, its loss, the counts and its ms."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return state, loss, ops.launch_counts(ops.TRAINING), ms


def _runtime_harness(torch, dev, main_losses) -> dict:
    """(a)-(c): the legacy harness against the chain preset, the fused-mode
    default, ``fullrank_weight_decay=False``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import fused_step
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.optim.common import make_matrix_optimizer
    from repro_torch.optim.projected_adam import ProjectedAdamRule
    from repro_torch.optim.transform import matrix_optimizer
    from repro_torch.train import steps as S
    from repro_torch.train.schedule import cosine_warmup

    cfg = get_config("llama-350m")
    lr = cosine_warmup(0.01, 2, STEPS)
    # the rule get_optimizer("dct_adamw", rank=RANK) builds
    rule = ProjectedAdamRule(rank=RANK, projector="dct", update_interval=1,
                             rotate=True, residual="ef", ef_dtype="q8")
    hkw = dict(b1=rule.b1, b2=rule.b2, eps=rule.eps)
    batch_fn = make_batch_fn(cfg, SEQ, BATCH, seed=0, device=dev)
    legacy = make_matrix_optimizer(rule, lr, weight_decay=0.01, **hkw)
    chain = get_optimizer("dct_adamw", lr=lr, rank=RANK, weight_decay=0.01)
    steps = {"harness": S.make_train_step(cfg, legacy),
             "chain": S.make_train_step(cfg, chain)}
    states = {"harness": S.init_state(cfg, legacy, 0, dev),
              "chain": S.init_state(cfg, chain, 0, dev)}
    out = {"harness_ms": [], "chain_ms": [], "harness_launches": []}
    for i in range(RUNTIME_STEPS):
        batch = batch_fn(i)
        states["harness"], loss, counts, ms = _timed_step(
            torch, steps["harness"], states["harness"], batch)
        assert loss == main_losses[i], (i, loss, main_losses[i])
        for name, n in counts.items():
            assert n == LAUNCHES_PER_STEP, f"harness step {i + 1}: {name} " \
                f"ran {n} times, expected {LAUNCHES_PER_STEP}"
        out["harness_ms"].append(ms)
        out["harness_launches"].append(counts)
        states["chain"], closs, _, cms = _timed_step(
            torch, steps["chain"], states["chain"], batch)
        out["chain_ms"].append(cms)
        assert closs == loss, (i, closs, loss)
        hp, cp = states["harness"].params, states["chain"].params
        assert hp.keys() == cp.keys()
        bad = [k for k in hp if not _same_bits(hp[k], cp[k])]
        assert not bad, f"step {i + 1}: harness params differ at {bad[:3]}"
    out["losses"] = main_losses[:RUNTIME_STEPS]
    del states
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the process-wide default of the rules whose fused is "auto"
    batch = batch_fn(0)
    state = S.init_state(cfg, chain, 0, dev)
    default = {}
    try:
        for mode in ("off", "fft"):
            fused_step.set_default_fused_mode(mode)
            assert fused_step.resolve("auto", dev) == mode
            default[mode] = {"launches": [], "step_ms": []}
            # twice: the first step of a mode builds its library plans
            for _ in range(2):
                _, loss, counts, ms = _timed_step(torch, steps["chain"],
                                                  state, batch)
                assert loss == main_losses[0], (mode, loss)
                if mode == "off":
                    assert not any(counts.values()), (mode, counts)
                assert counts["dct_project"] == 0, (mode, counts)
                default[mode]["launches"].append(counts)
                default[mode]["step_ms"].append(ms)
    finally:
        fused_step.set_default_fused_mode("auto")
    assert fused_step.default_fused_mode() == "auto"
    _, _, counts, ms = _timed_step(torch, steps["chain"], state, batch)
    assert all(n == LAUNCHES_PER_STEP for n in counts.values()), counts
    default["auto (restored)"] = {"launches": counts, "step_ms": ms}
    out["default_fused_mode"] = default
    del state

    # (c) the decay on the matrix leaves only
    wd = dict(weight_decay=0.1, fullrank_weight_decay=False, **hkw)
    opts = {"harness": make_matrix_optimizer(rule, lr, **wd),
            "chain": matrix_optimizer(rule, lr, **wd)}
    new = {}
    for name, opt in opts.items():
        st = S.init_state(cfg, opt, 0, dev)
        new[name], loss, counts, _ = _timed_step(
            torch, S.make_train_step(cfg, opt), st, batch)
        del st
        assert loss == main_losses[0], (name, loss)
        assert all(n == LAUNCHES_PER_STEP for n in counts.values()), counts
    hp, cp = new["harness"].params, new["chain"].params
    bad = [k for k in hp if not _same_bits(hp[k], cp[k])]
    assert not bad, f"fullrank_weight_decay=False: params differ at {bad[:3]}"
    out["no_fullrank_decay_bit_equal"] = True
    del new, opts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _runtime_op_aliases(torch, dev) -> dict:
    """(d): each ``*_op`` alias once, its counter read, against the direct
    wrapper call on the same tensors."""
    from repro_torch.core.dct import dct2_matrix
    from repro_torch.kernels import ops
    from repro_torch.kernels.newton_schulz import (newton_schulz_kernel,
                                                   ns_iteration)

    gen = torch.Generator(device=dev).manual_seed(7)
    (nb, m, n), _ = MAIN_SHAPES[1]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    g = randn(nb, m, n)
    q = dct2_matrix(n, device=dev)
    qt = q.T.contiguous()
    idx = torch.sort(torch.randperm(n, generator=gen, device=dev)
                     .view(1, n).expand(nb, n)[:, :RANK], dim=-1).values \
        .to(torch.int32).contiguous()
    b1, b2 = randn(nb, m, RANK), randn(nb, m, RANK)
    codes, scale = ops.quantize_ef(randn(nb, m, n) * 0.1)
    fd_args = _fd_case(torch, dev, 3, b=8, hq=16, hkv=16, hd=64, bs=16,
                       maxb=128, lengths=[1, 17, 256, 511, 1024, 1500, 2000,
                                          2048], kv_dtype=torch.bfloat16)
    cases = {
        "dct_project_op": ((g, q), ops.dct_project, {"dct_project": 1}),
        "colgather_matmul_op": ((b1, qt, idx), ops.colgather_matmul,
                                {"colgather_matmul": 1}),
        "colgather_matmul_dual_op": ((b1, b2, qt, idx),
                                     ops.colgather_matmul_dual,
                                     {"colgather_matmul_dual": 1}),
        "newton_schulz_op": ((randn(nb, RANK, m),), newton_schulz_kernel,
                             {"ns_gram": NS_STEPS, "ns_apply": NS_STEPS}),
        "ns_iteration_op": ((randn(nb, RANK, m) * 0.02,), ns_iteration,
                            {"ns_gram": 1, "ns_apply": 1}),
        "flash_attention_op": ((randn(BATCH, SEQ, 16, 64),
                                randn(BATCH, SEQ, 16, 64),
                                randn(BATCH, SEQ, 16, 64)),
                               ops.flash_attention, {"flash_attention": 1}),
        "flash_decode_op": ((fd_args[0].to(torch.bfloat16), *fd_args[1:]),
                            ops.flash_decode, {"flash_decode": 1}),
        "quantize_ef_op": ((g,), ops.quantize_ef, {"quantize_ef": 1}),
        "dequant_add_ef_op": ((g, codes, scale), ops.dequant_add_ef,
                              {"dequant_add_ef": 1}),
    }
    out = {}
    for name, (args, wrapper, want) in cases.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = getattr(ops, name)(*args)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == want, (name, counts, want)
        direct = wrapper(*args)
        got = got if isinstance(got, tuple) else (got,)
        direct = direct if isinstance(direct, tuple) else (direct,)
        assert all(_same_bits(a, b) for a, b in zip(got, direct)), name
        assert all(torch.isfinite(a.float()).all() for a in got), name
        out[name] = counts
    return out


def _runtime_serve_metrics(torch) -> dict:
    """(e): the serving CLI with ``--metrics`` in a fresh process."""
    shutil.rmtree(RUNTIME_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama-350m", "--engine", "paged", "--metrics", "--metrics-dir",
         str(RUNTIME_DIR)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert run.returncode == 0, run.stderr[-4000:]
    out = run.stdout
    launches = [line for line in out.splitlines()
                if line.startswith("kernel launches:")]
    assert len(launches) == 1, out[-2000:]
    fd = int(launches[0].split("flash_decode=")[1].split(",")[0])
    assert fd > 0, launches
    table = out.split("per-request latency")[1].splitlines()[2:]
    rows = [line.split() for line in table if line.startswith("  ")]
    served = sum(1 for r in rows if int(r[2]) > 0)
    assert len(rows) == 4 and served >= 3, rows
    samples = {}
    for line in (RUNTIME_DIR / "metrics.prom").read_text().splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            samples[series] = float(value)
    assert samples["serve_ttft_seconds_count"] == served, samples
    trace = json.loads((RUNTIME_DIR / "trace.json").read_text())
    spans = [e for e in trace["traceEvents"]
             if e.get("name") == "serve/decode_step"]
    assert spans, "trace.json has no decode-step span"
    qline = [line for line in out.splitlines()
             if line.startswith("ttft p50/p99:")]
    assert len(qline) == 1, out[-2000:]
    words = qline[0].split()
    ttft = [float(x) for x in words[2].split("/")]
    itl = [float(x) for x in words[5].split("/")]
    assert all(math.isfinite(x) and x > 0 for x in ttft + itl), qline
    shutil.rmtree(RUNTIME_DIR, ignore_errors=True)
    return {"exit": run.returncode, "flash_decode_launches": fd,
            "requests": len(rows), "requests_with_a_token": served,
            "serve_ttft_seconds_count": samples["serve_ttft_seconds_count"],
            "decode_step_spans": len(spans),
            "ttft_p50_s": ttft[0], "ttft_p99_s": ttft[1],
            "itl_p50_s": itl[0], "itl_p99_s": itl[1],
            "subprocess_wall_s": wall}


def run_runtime(torch, dev, main_losses) -> None:
    """Phase 18: (a)-(c) the harness, the fused-mode default and the decay
    option; (d) the op aliases; (e) the serving CLI's ``--metrics``."""
    t0 = time.perf_counter()
    harness = _runtime_harness(torch, dev, main_losses)
    print(json.dumps({"runtime_harness": harness}), flush=True)
    aliases = _runtime_op_aliases(torch, dev)
    print(json.dumps({"runtime_op_aliases": aliases}), flush=True)
    torch.cuda.empty_cache()
    metrics = _runtime_serve_metrics(torch)
    print(json.dumps({"runtime_serve_metrics": metrics}), flush=True)
    print(json.dumps({"runtime_phase_wall_s": time.perf_counter() - t0}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 14's planted dense-refresh leaf")
    opts = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_lib, ops

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
                    if "registers" in line or "Compiling entry" in line
                    or "spill" in line))

    rows = check_kernels(torch, dev)
    check_fused_update(torch, dev)
    counts, main_losses = run_main_path(torch)
    step1_loss = main_losses[0]
    time_breakdown(torch, dev)
    torch.cuda.empty_cache()
    rows["flash_decode"] = check_flash_decode(torch, dev)
    counts["flash_decode"] = run_serving(torch, dev)
    torch.cuda.empty_cache()

    rows.update(check_momentum_kernels(torch, dev))
    trion = run_momentum_path(torch, "trion")
    counts["ns_gram"], counts["ns_apply"] = trion["ns_gram"], trion["ns_apply"]
    time_breakdown(torch, dev, "trion")
    torch.cuda.empty_cache()
    counts["colgather_matmul"] = run_momentum_path(
        torch, "muon rank 128")["colgather_matmul"]
    run_momentum_path(torch, "dion")
    run_momentum_path(torch, "dion off")
    run_momentum_path(torch, "dion fft")
    run_momentum_path(torch, "muon full space")

    rows.update(check_lowp_kernels(torch, dev))
    for name in LOWP_PATHS:
        for kernel, n in run_lowp_path(torch, name, step1_loss).items():
            # each new kernel's launches: the first path that runs it
            if kernel not in counts and n:
                counts[kernel] = n
    for kernel in ops.LOWP:
        assert counts.get(kernel), f"{kernel}: no path of phase 11 ran it"
    time_breakdown(torch, dev, compute_dtype="int8")
    time_breakdown(torch, dev, compute_dtype="bf16")
    torch.cuda.empty_cache()

    rows["flash_attention"] = check_flash_attention(torch, dev)
    rows["flash_attention_blockwise"] = check_flash_attention_blockwise(
        torch, dev)
    prefill_launches = {name: run_dense_prefill(torch, dev, name)[kernel]
                        for name, kernel in DENSE_RUNS.items()}
    for kernel in ops.ATTENTION:
        counts[kernel] = sum(n for name, n in prefill_launches.items()
                             if DENSE_RUNS[name] == kernel)
    run_paged(torch, dev)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    for name in BASELINE_PATHS:
        run_baseline_path(torch, name, step1_loss)
    baseline_states_and_updates(torch, dev)
    check_dense_refresh(torch, dev, opts.seed)
    print(json.dumps({"baselines_phase_wall_s": time.perf_counter() - t0}),
          flush=True)

    torch.cuda.empty_cache()
    run_substrate(torch, dev, main_losses)
    torch.cuda.empty_cache()
    run_telemetry(torch, dev, main_losses)
    torch.cuda.empty_cache()
    dense_configs = run_dense_configs(torch, dev)
    torch.cuda.empty_cache()
    run_runtime(torch, dev, main_losses)
    for arch, case in dense_configs["cases"].items():
        for kernel, row in case.items():
            row["launches"] = dense_configs["serving"][arch][
                "flash_attention_blockwise_per_prefill"
                if kernel == "flash_attention_blockwise"
                else "flash_decode_per_decode_step"]
            rows[kernel].setdefault("dense_configs", {})[arch] = row

    sources = {"dequant_add_ef": ("quant_ef.cu", "src/repro/kernels/quant_ef.py:44"),
               "dct_project": ("dct_project.cu", "src/repro/kernels/dct_project.py:63"),
               "colgather_matmul_dual": ("colgather_matmul.cu",
                                         "src/repro/kernels/colgather_matmul.py:80"),
               "quantize_ef": ("quant_ef.cu", "src/repro/kernels/quant_ef.py:32"),
               "flash_decode": ("flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:46"),
               "ns_gram": ("newton_schulz.cu",
                           "src/repro/kernels/newton_schulz.py:53"),
               "ns_apply": ("newton_schulz.cu",
                            "src/repro/kernels/newton_schulz.py:68"),
               "colgather_matmul": ("colgather_matmul.cu",
                                    "src/repro/kernels/colgather_matmul.py:65"),
               "dct_project_bf16": ("dct_project.cu",
                                    "src/repro/kernels/dct_project.py:63"),
               "dct_project_q8": ("dct_project.cu",
                                  "src/repro/kernels/dct_project.py:93"),
               "quant_rows_q8": ("quant_ef.cu", "src/repro/kernels/lowp.py:66"),
               "quant_cols_q8t": ("quant_ef.cu", "src/repro/kernels/lowp.py:75"),
               "quant_qt_q8": ("quant_ef.cu",
                               "src/repro/kernels/colgather_matmul.py:158"),
               "quant_fold_q8": ("quant_ef.cu",
                                 "src/repro/kernels/colgather_matmul.py:162"),
               "colgather_matmul_dual_bf16": (
                   "colgather_matmul.cu", "src/repro/kernels/colgather_matmul.py:80"),
               "colgather_matmul_dual_q8": (
                   "colgather_matmul.cu", "src/repro/kernels/colgather_matmul.py:113"),
               "colgather_matmul_bf16": ("colgather_matmul.cu",
                                         "src/repro/kernels/colgather_matmul.py:65"),
               "colgather_matmul_q8": ("colgather_matmul.cu",
                                       "src/repro/kernels/colgather_matmul.py:98"),
               "flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:32"),
               "flash_attention_blockwise": (
                   "flash_attention_blockwise.cu",
                   "src/repro/kernels/flash_attention.py:32")}
    lowp_note = ("per DCT-AdamW training step at the main path's shapes (7 "
                 "launches); ms: the kernel alone, wrapper_ms: with the "
                 "operand quantization; bound at the precision's tensor-core "
                 "peak; gather_cublas_ms (bf16 colgathers): the gather and "
                 "torch.matmul on bf16 operands, two calls; launches from "
                 "phase 11's {} run")
    quant_note = ("per DCT-AdamW training step at the main path's shapes (7 "
                  "launches), an operand quantizer of the int8 dct_project "
                  "(quant_rows_q8, quant_cols_q8t) or colgather (quant_qt_q8: "
                  "Q^T; quant_fold_q8: both b of the dual, the selected "
                  "scales folded in); ms: device time of CUDA-graph replays "
                  "of a step's calls of each shape, wrapper_ms: eager calls; "
                  "plain: lowp.quant_rows (of Q^T for quant_cols_q8t, made "
                  "contiguous), quant_fold_q8_plain; launches from phase "
                  "11's int8 run")
    lowp_path = {"dct_project_bf16": "bf16", "colgather_matmul_dual_bf16": "bf16",
                 "dct_project_q8": "int8", "colgather_matmul_dual_q8": "int8",
                 "quant_rows_q8": "int8", "quant_cols_q8t": "int8",
                 "quant_qt_q8": "int8", "quant_fold_q8": "int8",
                 "colgather_matmul_q8": "int8 discard",
                 "colgather_matmul_bf16": "bf16 discard"}
    times_are = {
        "flash_decode": "per decode step: 24 launches at llama-350m's shapes "
                        "(a), 2 splits; ms and library_ms: device time of "
                        "CUDA-graph replays of 24 calls; wrapper_ms: eager "
                        "calls, the wrapper's host work included; library "
                        "= SDPA on K/V already densified, gather not "
                        "counted; dense_configs: phase 17's shapes (4 "
                        "slots, lengths 512-2080), ms per call, launches "
                        "per decode step of the depth served",
        "ns_gram": "per Trion training step: 35 launches (5 iterations x 7 "
                   "leaves); ms and library_ms: device time of CUDA-graph "
                   "replays of a step's launches of each shape; wrapper_ms "
                   "and library_eager_ms: eager calls; library = "
                   "torch.bmm(x, x.mT)",
        "ns_apply": "per Trion training step: 35 launches; ms and "
                    "library_ms: device time of CUDA-graph replays of a "
                    "step's launches of each shape; wrapper_ms and "
                    "library_eager_ms: eager calls; library = "
                    "torch.baddbmm(x, p, x, beta=a)",
        "colgather_matmul": "per subspace-Muon training step: 7 launches",
        "colgather_matmul_dual": "per training step at the main path's "
                                 "shapes; gather_cublas_ms: the gather and "
                                 "torch.matmul of the stacked operands, "
                                 "three calls",
        "flash_attention": "the TPU kernel's function on fp32 inputs (its "
                           "route), at the shapes of a llama-350m dense "
                           "prefill (8 x 512): 24 launches at shape (a); "
                           "ms and library_ms: device time of CUDA-graph "
                           "replays; wrapper_ms: eager calls; "
                           "bound: bytes at 4 B an element, operations at "
                           "the TF32 peak over 3 passes (3xTF32); library "
                           "= fp32 SDPA with enable_gqa; gemma3_prefill: 7 "
                           "launches at (b) + 1 at (c); launches from "
                           "phase 13's fp32 llama-350m prefill",
        "flash_attention_blockwise": "the model's function (the bf16 "
                                     "prefill's route), per llama-350m dense "
                                     "prefill (8 x 512): 24 launches at "
                                     "shape (a); library = SDPA with "
                                     "enable_gqa; gemma3_prefill: 7 launches "
                                     "at (b) + 1 at (c); launches from phase "
                                     "13's two bf16 dense prefills; "
                                     "dense_configs: phase 17's prefill "
                                     "shapes (2 x 2048), ms per call, "
                                     "launches per prefill of the depth "
                                     "served",
    }
    kernels = []
    for name, row in rows.items():
        bound, by = _bound_ms(row["bytes"], row["flops"],
                              row.get("peak", PEAK_FP32_PER_S))
        src, replaces = sources[name]
        # phase 17: the dense configurations' shapes (per call, launches
        # per decode step or prefill) and training launches per step
        extra = {}
        if "dense_configs" in row:
            extra["dense_configs"] = row["dense_configs"]
        if name in dense_configs["training"].get("phi3-mini-3.8b", {}):
            extra["dense_configs_launches_per_step"] = {
                arch: per_step[name]
                for arch, per_step in dense_configs["training"].items()}
        if name in lowp_path:
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
                "launches": counts[name], "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": bound, "bound_by": by,
                "library_ms": row["library_ms"],
                "wrapper_ms": row["wrapper_ms"],
                **({"gather_cublas_ms": row["gather_cublas_ms"]}
                   if "gather_cublas_ms" in row else {}),
                "launches_per_step": counts[name] / LOWP_STEPS,
                "times_are": quant_note if name.startswith("quant_")
                else lowp_note.format(lowp_path[name]), **extra})
            continue
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": row["library_ms"],
            **({"times_are": times_are[name], "wrapper_ms": row["wrapper_ms"]}
               if name == "flash_decode" else
               {"times_are": times_are[name],
                "launches_per_prefill": {
                    run: n for run, n in prefill_launches.items()
                    if DENSE_RUNS[run] == name},
                "gemma3_prefill": row["gemma3_prefill"],
                **({"wrapper_ms": row["wrapper_ms"]} if "wrapper_ms" in row
                   else {})}
               if name in ops.ATTENTION else
               {"launches_per_step": counts[name] / (
                   MOMENTUM_PATHS["muon rank 128"][1]
                   if name == "colgather_matmul" else STEPS),
                "times_are": times_are.get(
                    name, "per training step at the main path's shapes"),
                **{k: row[k] for k in ("wrapper_ms", "library_eager_ms",
                                       "gather_cublas_ms") if k in row}}),
            **extra,
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
