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
19. The DeepSeek MoE family (``MOE_*`` below; random weights, bf16
   compute, the registry's configs at full width, depth cut): (a) the
   kernels at its new shapes against their plain versions, each launched
   twice (bit-identical): ``flash_decode`` at deepseek-moe-16b's decode
   (16 / 16 heads of 128) at phase 5's bar, ``flash_attention_blockwise``
   at its prefill and at deepseek-v3-671b's MLA prefill (2 x 2048, 128
   heads, q / k head dim 192, v 128) at the model's bar, each timed per
   call beside its bound and SDPA (with the backends that take v of its
   own head dim), and the four DCT-AdamW kernels at phase 2's bars on the
   4-D expert leaf (4, 64, 2048, 1408), the router (r = n = 64) and
   deepseek-v3-671b's wkv_a / wkv_b / wo (n = 576, 512, 7168); (b)
   serving through phase 13's runs and checks, the counters zeroed just
   before each: deepseek-moe-16b cut from 28 layers to 14 (1 dense + 13
   MoE, fp32 parameters) on the dense engine (14 blockwise launches per
   prefill) and the paged engine (14 ``flash_decode`` launches per decode
   step), deepseek-v3-671b cut from 61 to 2 (1 ``mla_dense`` + 1
   ``mla_moe``) on the dense engine: its MLA prefill through the extended
   blockwise kernel (2 launches), then 16 tokens of latent-cache decode;
   an MoE prefill's last logits within ``MOE_LOGITS_FLOOR_FACTOR`` of their
   floor (routing is discrete), each layer's kernel output at phase 13's
   bar; (c) DCT-AdamW rank 128 through the training CLI, 3 steps:
   deepseek-moe-16b at depth 5 (1 dense + 4 MoE), batch 8 x 512, and
   deepseek-v3-671b at 1 ``mla_dense`` layer with the MTP head, batch 8 x
   512: one launch of each of the four kernels per projected leaf and step
   (18 and 9 leaves), finite losses and MTP terms, step time and peak
   memory. The phase's wall time is printed.
20. The recurrent families (``RECURRENT_*`` below; random weights, bf16
   compute, the registry's configs at full width, depth cut): (a) the
   kernels at their new shapes against their plain versions:
   ``flash_attention_blockwise`` at jamba-1.5-large-398b's prefill (64 / 8
   heads of 128, 2 x 2048) and the four DCT-AdamW kernels at phase 2's
   bars on rwkv6-1.6b's stacked mixes (n = 24) and ``bonus_u`` (n = 32),
   jamba's router (r = n = 16), its full-depth ``d_skip`` (n = 9, odd),
   ``x_proj`` (n = 544) and ``in_proj`` (n = 8192, m = 32768), with the
   "fft" route's S at each; at n = 24, 16 and 9 also int8 (bit-equal) and
   bf16; (b)
   serving through phase 13's run on the dense engine: jamba cut from 72
   layers to its first 5 (2 ``mamba_dense``, 2 ``mamba_moe``, the
   attention layer: one blockwise launch per prefill) and rwkv6-1.6b at
   its 24 layers (no kernel: the WKV scan is a loop over the positions),
   prefills of 2 x 2048 (jamba) and 2 x 512 (rwkv6), then 16 tokens of
   recurrent-state decode; (c) DCT-AdamW rank 128 through the training
   CLI, 3 steps: rwkv6-1.6b at 24 layers and jamba at its first layer (one
   ``mamba_dense``), batch 8 x 512: one launch of each of the four kernels
   per projected leaf and step (15 and 6 leaves), finite losses, step time
   and peak memory. The phase's wall time is printed.
21. The encoder-decoder and cross-attention families (``ENCDEC_*`` below;
   random weights, the registry's configs at full width): (a) the prefill
   kernels at keys of their own length against their plain versions, each
   launched twice (bit-identical): the fp32 ``flash_attention`` at
   whisper-large-v3's encoder (2 x 1500 frames, bidirectional), decoder
   self-attention (2 x 448, causal) and cross-attention (448 queries
   against 1500 frames), 20 / 20 heads of 64, within ``FA_TOL_F32`` of its
   plain version and of the model's loop; ``flash_attention_blockwise`` at
   llama-3.2-vision-90b's self-attention (2 x 2048, 64 / 8 heads of 128,
   kv chunk 1024) and cross-attention (2048 queries against 6400 image
   tokens: one chunk of 6400) at the model's bar; each timed per call
   beside its bound and SDPA; and the four DCT-AdamW kernels at phase 2's
   bars on whisper's (32, 1280, 1280) and (32, 5120, 1280) leaves (n =
   1280) and vision's (4, 28672, 8192) and (4, 8192, 1024); (b) serving
   through phase 13's run on the dense engine with stub frames / image
   embeddings (``data.synthetic.stub_inputs``): whisper at its full 32 +
   32 layers (bf16 compute, fp32 parameters: its fp32 biases make every
   attention fp32, so the prefill launches the fp32 ``flash_attention``
   96 times: 32 encoder, 32 decoder and 32 cross-attention calls),
   prompts of 2 x 448,
   and vision cut from 100 layers to two repeats of its pattern (8 attn +
   2 cross: 10 blockwise launches), prompts of 2 x 2048 against 2 x 6400
   image tokens; then 16 tokens of decode over the cross caches; (c)
   DCT-AdamW rank 128 through the training CLI, 3 steps
   (``ENCDEC_TRAIN_RUNS``): whisper at full depth, 8 x 448 against 8 x
   1500 frames, and vision cut to one ``cross`` layer (a deeper cut runs
   out of the card's memory), 8 x 512 against 8 x 6400 image tokens: one
   launch of each of the four kernels per projected leaf and step, no
   attention kernel, finite losses, step time and peak memory. The phase's
   wall time is printed.
22. ZeRO-1 at world 2 over ``("data",)`` on the one card: ``gloo`` with
   CUDA tensors (NCCL refuses two ranks on one device), the ranks spawned
   after the kernels are built, a file store for the process group. (a)
   Through the API: llama-350m's projected leaves ((24, 1024 | 2816,
   1024), rank 128) with the same N(0, 1) gradients on two ranks and, in
   rank 0, replicated: DCT-AdamW in fp32 (q8 EF, ``update_interval=2``: a
   keep step between two refreshes) for 3 updates, one in bf16, one in
   int8, and Trion for 3 (``ZERO_API_RUNS``); every selection equal
   (``select_top_r`` spied in both), the gathered updates and state bit
   for bit; each rank's launches of each kernel, exactly
   ``ZERO_API_LAUNCHES``, its G block shapes and optimizer-state bytes
   beside the replicated state's; the fp32 state saved whole and restored
   at 2 ranks (each its blocks, bit for bit) and at 1 (the gathered state,
   bit for bit). The same two ranks then build a (data 1, model 2) mesh
   (``PLACED_MESH``): one llama-350m DCT-AdamW step on phase 3's first
   batch with the train state held as ``fsdp_tp`` blocks (each split
   parameter gathered at the step's start), every parameter and state
   block bit-equal to the replicated step's cut, 7 launches of each of the
   four kernels a rank, the held and whole parameter and state bytes, and
   the bytes a rank would hold under ``decode_tp``. (b) Through the CLI:
   ``python -m torch.distributed.run
   --standalone --nproc-per-node 2 -m repro_torch.launch.train`` with
   phase 3's configuration (6 steps, batch 8 x 512 global, 4 x 512 a
   rank) and ``--zero 1 --dist-backend gloo``, a checkpoint every 2 steps:
   each rank's line (7 launches of each of the four kernels per step, its
   parameter and state bytes: the state held as ``fsdp_tp`` blocks over
   ``("data",)``, every matrix and embedding halved; peak memory), losses
   equal bit for bit to a world-1 run
   of the same configuration in microbatches of one rank's rows
   (``ZERO_MICROBATCH``) and within ``ZERO_LOSS_BARS`` of phase 3's, step
   time and each rank's mean data wait, dispatch and host sync from
   ``--obs-dir``. (c) (b)'s step-2 checkpoint restored at 2 ranks and at
   1: the whole parameters, moments and EF equal the concatenation of the
   blocks (CRC32 of each block); a world-1 run in those microbatches resumes
   from it and runs steps 3-6, its losses equal to (b)'s bit for bit.
   Files under ``build/chip_smoke_zero``, deleted at the end; the phase's
   wall time is printed. Order: (b), then one spawn of the two ranks for
   (a) and their half of (c), then (c)'s world-1 half.
23. The ``kernels`` line, the card's line, and last:
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
# keys of their own length (phase 21): the bar in ulps of max |out|
# (LAYER_MAX_ULPS below) and this share bit-equal. Over thousands of keys
# the outputs are small averages and more of their last roundings land
# near a bf16 boundary: 98.61% bit-equal measured at vision's 2048 x 6400
# on random inputs, every other output one ulp off (NVIDIA H100 80GB HBM3,
# 700 W); 99.6% and more inside vision's prefill
BLOCKWISE_LONG_MIN_EQUAL = 0.98
# (b, s, hq, hkv, hd, window, kv chunk), causal: the prefill shapes of
# llama-350m and of a gemma3-27b local and global layer, with the model's
# kv chunk; flash_attention runs them in fp32 (its route),
# flash_attention_blockwise in bf16 (its route)
FA_CASES = {"a: llama-350m": (8, 512, 16, 16, 64, None, 512),
            "b: gemma3 local": (2, 2048, 32, 16, 128, 1024, 1024),
            "c: gemma3 global": (2, 2048, 32, 16, 128, None, 1024)}
# query slices at an offset (phase 12, sequence-parallel attention: one
# model rank's rows of a prefill against all of its keys): (b, S, hq, hkv,
# hd, vd, window, kv chunk, q_offset, rows). At an offset and a row count
# that are multiples of the kernels' 64-row query tile each row of the
# slice is the same row of the whole prefill's launch, bit for bit (the
# same CTA walk over the same key tiles); the ragged case is held to the
# plain version only. MLA's value dim runs on the blockwise kernel only
# (flash_attention takes v of k's shape)
OFFSET_CASES = {"causal, llama-350m": (2, 1024, 16, 16, 64, 64, None, 512,
                                       512, 512),
                "window, gemma3 local": (1, 2048, 32, 16, 128, 128, 1024,
                                         1024, 1024, 1024),
                "causal, MLA v 128": (1, 1024, 16, 16, 192, 128, None, 512,
                                      512, 512),
                "ragged, window 100": (1, 700, 8, 4, 64, 64, 100, 256, 300,
                                       200)}
# the sequence-parallel prefill's shape in phase 22 (qwen2.5-32b, 2 x 2048
# at tp 2): rank 1's 1024 rows at q_offset 1024, the kernels' rows 13 and
# 13b time it
SP_PREFILL = (2, 2048, 2)            # batch, sequence, model ranks

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

# the DeepSeek MoE family (phase 19): random weights, bf16 compute, the
# registry's configs at full width, cut in depth only, as (layers of the
# first schedule segment, layers of the second). Served: deepseek-moe-16b
# 28 -> 14 (1 dense + 13 attn_moe: 8.15 B fp32 parameters, 32.6 GB, beside
# their bf16 copy of 16.3 GB while the engine casts them), deepseek-v3-671b
# 61 -> 2 (1 mla_dense + 1 mla_moe, and the MTP head: 14.05 B bf16
# parameters, 28.1 GB; the mla_moe layer alone 11.27 B)
MOE_SERVE_LAYERS = {"deepseek-moe-16b": (1, 13), "deepseek-v3-671b": (1, 1)}
# trained through the CLI, DCT-AdamW rank 128, MOE_TRAIN_STEPS steps of seq
# 512: (arch, layers, batch). deepseek-moe-16b 28 -> 5 (1 dense + 4
# attn_moe, 2.85 B fp32: 63.7 GB peak alone; at 6 layers, 3.44 B, 75.8 GB,
# too close to the card's 79.2 GiB after the other phases);
# deepseek-v3-671b 61 -> 1 mla_dense layer and the MTP head (2.54 B bf16:
# 68.4 GB peak alone). At 2 mla_dense layers (3.12 B) the update ran out
# of the card's 79.2 GiB (67.1 GB allocated, 8.5 reserved free, at its
# weight decay: the functional step holds the old and the new full-rank
# Adam moments of the two 926.7 M-element embeddings, 29.6 GB, and two
# fp32 update trees of 12.5 GB; scripts/deepseek_probe.py, NVIDIA H100
# 80GB HBM3, 700 W; so are the peaks above). One mla_moe layer does not
# train on one card either
# (11.27 B bf16 parameters, as many gradients, 11.3 GB of int8 EF and a
# 45 GB fp32 G + EF transient of its expert leaves)
MOE_TRAIN_RUNS = (("deepseek-moe-16b", (1, 4), 8),
                  ("deepseek-v3-671b", (1, 0), 8))
MOE_TRAIN_STEPS = 3
# deepseek-v3-671b's latent-cache decode after its dense prefill
MLA_DECODE_NEW = 16
# the last logits of an MoE prefill through the kernels against the plain
# route: an ulp that moves a router's top-k sends a token to other experts,
# so the bar is this factor times the larger of the run's floor and
# PREFILL_LOGITS_RTOL; each layer's kernel output keeps phase 13's bar
MOE_LOGITS_FLOOR_FACTOR = 3.0
# the four DCT-AdamW kernels at the family's new leaf shapes (oriented
# (..., m, n), r = min(128, n)), held to their plain versions as phase 2
# holds them: (shape, launches per step). deepseek-moe-16b's expert leaves
# (wg, wu, wd of MOE_TRAIN_RUNS's 4 MoE layers, 64 experts: 256 matrices a
# launch; the kernel table's row), its router (r = n = 64: every column),
# and deepseek-v3-671b's wkv_a (n = 576), wkv_b (n = 512) and wo (n = 7168:
# a 205 MB fp32 basis) at 2 layers
MOE_LEAF_SHAPES = {"deepseek-moe-16b experts": ((4, 64, 2048, 1408), 3),
                   "deepseek-moe-16b router": ((4, 2048, 64), 1),
                   "deepseek-v3-671b wkv_a": ((2, 7168, 576), 1),
                   "deepseek-v3-671b wkv_b": ((2, 32768, 512), 1),
                   "deepseek-v3-671b wo": ((2, 16384, 7168), 1)}
# the recurrent families (phase 20): random weights, bf16 compute, the
# registry's configs at full width, cut in depth only. Served on the dense
# engine (the paged one refuses them, as the JAX package's):
# jamba-1.5-large-398b 72 -> its first 5 layers, positions p0-p4 of its
# pattern (2 mamba_dense, 2 mamba_moe and the attn layer: every kind;
# 24.05 B bf16 parameters, 48.1 GB; the sixth layer is a mamba_moe of
# 10.08 B: 6 layers would hold 68.3 GB beside the 12.9 GB fp32 draw of an
# expert leaf at init), and
# rwkv6-1.6b at its full 24 layers (1.58 B fp32 parameters)
RECURRENT_SERVE = {"jamba-1.5-large-398b": 5, "rwkv6-1.6b": 24}
# their prompts (batch, length); new tokens of the recurrent-state decode.
# rwkv6's exact WKV scan is a loop over the positions: a 2 x 2048 prefill
# is 248 k kernel launches and 3.5-4.7 s, and phase 13's run prefills 6
# times, so it serves 2 x 512 (1.0 s a prefill; scripts/recurrent_probe.py
# --prefill-once times both; NVIDIA H100 80GB HBM3, 700 W)
RECURRENT_PROMPTS = {"jamba-1.5-large-398b": (2, 2048),
                     "rwkv6-1.6b": (2, 512)}
RECURRENT_NEW = 16
# trained through the CLI, DCT-AdamW rank 128, MOE_TRAIN_STEPS steps of seq
# 512: (arch, layers, batch). rwkv6-1.6b at full depth; jamba cut to its
# first layer (p0, one mamba_dense: 2.10 B bf16 parameters, the Mamba
# backward at full width; batch 8 peaked at 57.7 GB alone, NVIDIA H100 80GB
# HBM3, 700 W). One mamba_moe layer does not train on one card (10.08 B
# bf16 parameters, as many gradients, 9.7 GB of int8 EF and a ~26 GB fp32
# G + EF transient of its expert leaves): it waits for the mesh
RECURRENT_TRAIN_RUNS = (("rwkv6-1.6b", 24, 8),
                        ("jamba-1.5-large-398b", 1, 8))
# the four DCT-AdamW kernels at the families' new leaf shapes (oriented
# (..., m, n), r = min(128, n)): (shape, launches per step of the training
# runs above; 1 for a shape held standalone). rwkv6-1.6b's six stacked
# mixes mu_* (24, 2048): n = 24; its bonus_u (24, 32, 64): 24 matrices with
# n = 32; jamba's router (8192, 16) of one layer (r = n = 16) and its
# (9, 16384) d_skip at full depth (n = 9, odd), both standalone; its x_proj
# (n = 544) and in_proj (n = 8192 with m = 32768) of the trained layer
RECURRENT_LEAF_SHAPES = {"rwkv6-1.6b mu": ((2048, 24), 6),
                         "rwkv6-1.6b bonus_u": ((24, 64, 32), 1),
                         "jamba router": ((1, 8192, 16), 1),
                         "jamba d_skip": ((16384, 9), 1),
                         "jamba x_proj": ((1, 16384, 544), 1),
                         "jamba in_proj": ((1, 32768, 8192), 1)}
# the shapes held in int8 and bf16 too, and the fft route's S: n = 24, 16, 9
RECURRENT_LOWP_LEAVES = ("rwkv6-1.6b mu", "jamba router", "jamba d_skip")
# the encoder-decoder and cross-attention families (phase 21): random
# weights, the registry's configs at full width. Served on the dense engine
# (the paged one refuses them, as the JAX package's), (layers, prompts
# (batch, length)): whisper-large-v3 whole (32 encoder and 32 decoder
# layers, 1.60 B fp32 parameters, bf16 compute; its fp32 biases make each
# attention fp32: the fp32 flash_attention's route, 96 launches a prefill)
# on prompts of Whisper's decoder context (448) against its 1500 frames;
# llama-3.2-vision-90b cut from 100 layers to two repeats of its pattern (8
# attn, 2 cross: 10.66 B bf16 parameters, 21.3 GB; the stacked cross leaves
# and caches at repeats > 1: 10 blockwise launches a prefill) on 2048-token
# prompts against 6400 image tokens
ENCDEC_SERVE = {"whisper-large-v3": (None, (2, 448)),
                "llama-3.2-vision-90b": (10, (2, 2048))}
ENCDEC_NEW = 16
# the prefill kernels at the families' shapes, each against its plain
# version: (b, sq, skv, causal). fp32 flash_attention at whisper's
# encoder (1500 frames, bidirectional: no multiple of the 64-key tile),
# decoder self-attention and cross-attention (20 / 20 heads of 64); the
# blockwise kernel at vision's self-attention and cross-attention (64 / 8
# heads of 128, kv chunk 1024: 6400 image tokens are one chunk of 6400)
ENCDEC_FA_CASES = {"whisper encoder": (2, 1500, 1500, False),
                   "whisper decoder self": (2, 448, 448, True),
                   "whisper cross": (2, 448, 1500, False)}
ENCDEC_BLOCKWISE_CASES = {"vision self": (2, 2048, 2048, True),
                          "vision cross": (2, 2048, 6400, False)}
# the four DCT-AdamW kernels at the families' new leaf shapes (oriented
# (..., m, n), r = 128), (shape, launches per step): whisper's stacked d x
# d projections (12 leaves: the encoder's and the decoder's attention and
# cross-attention; n = 1280, no power of two) and its MLPs (4), and
# vision's (4, 28672, 8192) MLP and (4, 8192, 1024) key / value leaves (four
# attn layers stacked), held standalone
ENCDEC_LEAF_SHAPES = {"whisper d x d": ((32, 1280, 1280), 12),
                      "whisper mlp": ((32, 5120, 1280), 4),
                      "vision mlp": ((4, 28672, 8192), 1),
                      "vision kv": ((4, 8192, 1024), 1)}
# trained through the CLI, DCT-AdamW rank 128, ENCDEC_TRAIN_STEPS steps:
# (arch, layers, batch, seq len). whisper-large-v3 at full depth, 8 x 448
# (Whisper's decoder context) against 8 x 1500 frames (34.1 GB peak);
# llama-3.2-vision-90b cut from 100 layers to one cross layer (2.96 B bf16
# parameters, 2.10 B of them its two embeddings), 8 x 512 against 8 x 6400
# image tokens: its first 5 layers (6.38 B) ran out of memory at batch 8
# and 4, the pattern ("attn", "cross") (3.81 B) at batch 8, 4 and 2; the
# cross layer peaked at 81.9 GB allocated of the card's 85.0 with
# expandable segments (``_expandable_segments``; without them it ran out
# at batch 8 and 4). The embeddings' fp32 gradients and their clipped
# copy, and the old and the new Adam moments of the functional step, 50 GB
# for the two tables, set the depth (scripts/encdec_probe.py, NVIDIA H100
# 80GB HBM3, 700 W)
ENCDEC_TRAIN_RUNS = (("whisper-large-v3", None, 8, 448),
                     ("llama-3.2-vision-90b", ("cross",), 8, 512))
ENCDEC_TRAIN_STEPS = 3

# phase 22: ZeRO-1 and the train state held as fsdp_tp blocks at world 2
# over ("data",) on the one card: gloo with CUDA tensors (NCCL refuses two
# ranks on one device)
ZERO_WORLD = 2
ZERO_DIR = ROOT / "build" / "chip_smoke_zero"
# (a): (label, preset, keywords, updates) on llama-350m's projected leaves
# with N(0, 1) gradients from a seeded generator on the card (the same in
# every process); fused auto -> on
ZERO_API_RUNS = (
    ("fp32", "dct_adamw", dict(rank=RANK, update_interval=2), 3),
    ("bf16", "dct_adamw", dict(rank=RANK, compute_dtype="bf16"), 1),
    ("int8", "dct_adamw", dict(rank=RANK, compute_dtype="int8"), 1),
    ("trion", "trion", dict(rank=RANK), 3))
# each rank's launches of each run, exactly (one a leaf: 7 a step): the
# fp32 run refreshes at updates 1 and 3 (dct_project twice) and
# back-projects at all three; Trion refreshes every step and runs NS_STEPS
# Gram / apply pairs a leaf and step on the gathered factor
ZERO_API_LAUNCHES = {
    "fp32": {"dct_project": 2 * LAUNCHES_PER_STEP,
             **{k: 3 * LAUNCHES_PER_STEP for k in (
                 "colgather_matmul_dual", "quantize_ef", "dequant_add_ef")}},
    "bf16": {k: LAUNCHES_PER_STEP for k in (
        "dct_project_bf16", "colgather_matmul_dual_bf16", "quantize_ef",
        "dequant_add_ef")},
    "int8": {k: LAUNCHES_PER_STEP for k in (
        "dct_project_q8", "quant_rows_q8", "quant_cols_q8t",
        "colgather_matmul_dual_q8", "quant_qt_q8", "quant_fold_q8",
        "quantize_ef", "dequant_add_ef")},
    "trion": {"dct_project": 3 * LAUNCHES_PER_STEP,
              "colgather_matmul_dual": 3 * LAUNCHES_PER_STEP,
              "ns_gram": 3 * NS_PER_STEP, "ns_apply": 3 * NS_PER_STEP}}
# every run is held bit for bit (updates, the gathered state) and every
# selection equal: the column statistic is the replicated kernel's own sum
# of the same row-block partials, everything else row-local or computed on
# the gathered whole (Trion's momentum sum, NS)
# (b): phase 3's configuration and schedule (6 steps), a checkpoint every 2
ZERO_CLI_ARGV = TRAIN_ARGV
ZERO_CLI_STEPS = STEPS
ZERO_CKPT_STEP = 2
# the witness of (b) and (c): one process runs phase 3's configuration in
# microbatches of one rank's rows, the function the ranks compute (their
# averaged gradients equal its accumulated ones: g0 / 2 + g1 / 2 ==
# (g0 + g1) / 2 in fp32), so (b)'s first loss and gradients are its bits;
# the clip's norm from the blocks' sums parts the later steps from it
# (ZERO_WITNESS_LOSS_BARS)
ZERO_MICROBATCH = BATCH // ZERO_WORLD
# |loss - phase 3's| at steps 1-6 (measured on an H100 80GB HBM3 at 700 W,
# scripts/zero_probe.py: 9.5e-7, 4.4e-3, 6.2e-3, 1.5e-3, 3.03e-2, 9.4e-3):
# step 1 averages the two half-batch means; the later steps follow
# updates at phase 3's LRs from gradients summed in another order (Adam's
# first steps move each weight by ~lr, whatever the gradient's size, so an
# element near zero that changes sign moves the loss)
ZERO_LOSS_BARS = (1e-5,) + (5e-2,) * (ZERO_CLI_STEPS - 1)
# (a)'s ranks also build a (data 1, model 2) mesh: one llama-350m DCT-AdamW
# step on phase 3's first batch with the state held as fsdp_tp blocks and
# the attention heads and MLP hidden units on each rank's model block
# (Megatron: the row products' partials summed over model), against the
# replicated step cut to each rank's blocks at the MESH_STEP bars, beside
# the same step with every site gathered whole; a no-grad forward through
# the Megatron sites; and the decode_tp placement's bytes a rank
PLACED_MESH = (1, 2)
# ... and the models' mesh bodies (parts d-g), each held to one process on
# the global batch: (d) deepseek-moe-16b at full width, cut to its dense
# first layer and one attn_moe, one DCT-AdamW step under fsdp_tp with the
# experts expert-parallel on (data 1, model 2) (32 of its 64 experts a
# rank; the dense layer's MLP and attention and the shared experts on the
# Megatron route), one on ("data",) (the whole batch routed as one: global
# capacity, positions and aux; peak ~28 GB a rank) and one under pure_dp on
# (1, 2) (the batch over both axes, each rank's rows gathered over model
# for the MoE, 32 experts a rank); (e) its decode_step under decode_tp on
# (1, 2) and (2, 1) (the experts' hidden dim cut over data, the f-partials
# summed)
# in fp32 compute, at the reference's bar (tests/test_multidevice.py);
# (f) qwen2.5-32b at full width, depth 2, its own attn_sp: a no-grad bf16
# prefill of SP_PREFILL on (1, 2), each rank's flash_attention_blockwise
# launch over its 1024 rows at q_offset 1024 r; (g) one llama-350m
# DCT-AdamW step with attn_sp on (1, 2) (phase 3's first batch)
MESH_MOE_LAYERS = (1, 1)
MESH_MOE_BATCH = (2, 256)
MESH_DECODE_BATCH = 4
MESH_SP_DEPTH = 2
# a mesh step's parameters against one process's: within this many of the
# witness's largest update (a weight whose first Adam step changes sign
# where its gradient, summed in another order, sits near zero moves by
# two steps), the gradient norm at rtol 1e-3 and the loss at
# MESH_STEP_LOSS_RTOL: deepseek-moe-16b computes in bf16, and the
# expert-parallel step adds each token's six expert outputs in bf16 on two
# ranks and then across them, another order than one process's (9.0e-6
# measured, scripts/mesh_models_probe.py, NVIDIA H100 80GB HBM3, 700 W)
MESH_STEP_UPDATE_BAR = 2.0
MESH_STEP_LOSS_RTOL = 1e-4
# each rank's peak device memory in a step of (b) and of (d) (on (1, 2),
# on ("data",)) when the step gathered the parameters whole (PERF.md §5:
# chip_smoke.py on NVIDIA H100 80GB HBM3 at 700 W): the FSDP schedule
# (parallel/fsdp.py) holds the blocks and one use site's weights whole, so
# each peak must fall below these
WHOLE_GATHER_PEAKS = {"cli": 8.24e9, "ep_step": 27.7e9, "data_step": 32.2e9}
# the clip's norm sums each rank's blocks of the gradients (one all-reduce
# of the leaves' partial sums, no gradient gathered): (b)'s first clip
# factor against the world-1 witness's, whose gradients it holds bit for
# bit, in fp32 ulps (measured 0; 0 / 0 / 1 at steps 2-4, whose gradients
# were still the witness's: NVIDIA H100 80GB HBM3, 700.00 W; the CPU
# tests' bar, tests/torch_zero_ranks.py CLIP_ULPS)
CLIP_SCALE_ULPS = 4
# (b)'s losses after step 1, and (c)'s world-1 resume, against the world-1
# witness: the ranks' clip factors part from its by ulps and the later
# steps carry that (measured: steps 2-4 bit-equal, 9.7e-5 / 8.3e-5 at
# steps 5-6, the same card; phase 3's schedule moves losses by up to
# ZERO_LOSS_BARS where the gradients' order changes)
ZERO_WITNESS_LOSS_BARS = (0.0,) + (1e-3,) * (ZERO_CLI_STEPS - 1)
# (b)'s all-gathered bytes a step a rank: the layers' bf16 weights,
# gathered in the forward and again in the recomputation, and no gradient
# (measured 1.44e9; 5.40e9 when the clip's norm gathered each gradient
# whole and ZeRO's rows came from whole leaves; PERF.md §5)
ZERO_CLI_GATHER_BYTES = 3.0e9


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


def _sdpa(torch, q, k, v, window, causal=True):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the same tensors (``enable_gqa``; the window as a boolean mask)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        return lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    pos = torch.arange(q.shape[1], device=q.device)
    keep = (pos[:, None] >= pos[None, :]) \
        & (pos[:, None] - pos[None, :] < window)
    return lambda: sdpa(qt, kt, vt, attn_mask=keep, enable_gqa=True)


def _sdpa_backends(torch, q, k, v) -> dict:
    """Which of ``scaled_dot_product_attention``'s backends take these
    tensors (causal), and the one its dispatcher picks for them
    (``torch._fused_sdp_choice``; None where this torch lacks it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    call = _sdpa(torch, q, k, v, None)
    takes = {}
    for backend in (getattr(SDPBackend, n) for n in (
            "FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
            "MATH") if hasattr(SDPBackend, n)):
        try:
            with sdpa_kernel(backend):
                call()
            takes[backend.name] = True
        except RuntimeError:
            takes[backend.name] = False
    picked = None
    with contextlib.suppress(AttributeError, TypeError):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        picked = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, is_causal=True, enable_gqa=True)).name
    torch.cuda.synchronize()
    return {"takes": takes, "picked": picked}


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
    version at the model's bar; with keys of their own length (Skv != Sq),
    max |d| within ``LAYER_MAX_ULPS`` bf16 ulps of max |out| in place of
    ``BLOCKWISE_REL_TOL`` and ``BLOCKWISE_LONG_MIN_EQUAL`` bit-equal: over
    thousands of keys the outputs are small averages, max |out| may sit
    low in its binade, and one output rounded to its neighbour is then past
    4e-3 of it. Returns the errors."""
    kw = dict(causal=causal, window=window, kv_chunk=chunk)
    got = fa.flash_attention_blockwise(q, k, v, **kw)
    again = fa.flash_attention_blockwise(q, k, v, **kw)
    want = fa.blockwise_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype \
        and got.shape == (*q.shape[:3], v.shape[3]) \
        and torch.isfinite(got).all(), "flash_attention_blockwise output"
    assert torch.equal(got, again), "flash_attention_blockwise: relaunch differs"
    d = (got.float() - want.float()).abs()
    err = d.max().item()
    top = want.float().abs().max()
    rel = err / top.item()
    ulps = err / torch.ldexp(torch.ones_like(top),
                             torch.frexp(top)[1] - 8).item()
    equal = (d == 0).float().mean().item()
    long = k.shape[1] != q.shape[1]
    ok = ulps <= LAYER_MAX_ULPS if long else rel <= BLOCKWISE_REL_TOL
    assert ok and equal >= (BLOCKWISE_LONG_MIN_EQUAL if long
                            else BLOCKWISE_MIN_EQUAL), \
        f"flash_attention_blockwise: max |d| {rel} of max |out| " \
        f"({ulps} ulps), {equal} bit-equal"
    return {"max_abs_err": err, "rel_err": rel, "max_ulps_of_max_out": ulps,
            "bit_equal_share": equal}


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


def _offset_pairs(rows: int, off: int, window) -> int:
    """Unmasked (query, key) pairs of a causal slice of ``rows`` queries at
    absolute positions ``off ..`` (within ``window`` keys, if any)."""
    return sum(min(i + 1, window or i + 1) for i in range(off, off + rows))


def _offset_mask(torch, sq, skv, off, window, dev):
    pos = off + torch.arange(sq, device=dev)[:, None]
    key = torch.arange(skv, device=dev)[None, :]
    keep = key <= pos
    if window is not None:
        keep &= pos - key < window
    return keep


def _offset_case(torch, dev, fa, seed, b, s, hq, hkv, hd, vd, window, chunk,
                 off, rows, kernel: str) -> dict:
    """One kernel on a query slice at ``off``: twice (bit-identical)
    against its plain version at the offset (the blockwise kernel at the
    model's bar, flash_attention at FA_TOL_F32), and each slice row
    against the same row of the whole prefill's launch (bit-equal where
    ``off`` and ``rows`` are multiples of 64)."""
    dt = torch.bfloat16 if kernel == "blockwise" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(300 + seed)
    q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, s, hkv, vd), generator=gen, device=dev).to(dt)
    qs = q[:, off:off + rows]
    if kernel == "blockwise":
        kw = dict(causal=True, window=window, kv_chunk=chunk)
        run = lambda qq, o: fa.flash_attention_blockwise(  # noqa: E731
            qq, k, v, q_offset=o, **kw)
        plain = fa.blockwise_attention_ref(qs, k, v, q_offset=off, **kw)
    else:
        kw = dict(causal=True, window=window)
        run = lambda qq, o: fa.flash_attention(qq, k, v, q_offset=o,  # noqa
                                               **kw)
        plain = fa.flash_attention_ref(qs, k, v, q_offset=off, **kw)
    got, again = run(qs, off), run(qs, off)
    whole = run(q, 0)[:, off:off + rows]
    torch.cuda.synchronize()
    assert got.shape == (b, rows, hq, vd) and torch.isfinite(got).all()
    assert torch.equal(got, again), f"{kernel} at q_offset: relaunch differs"
    d = (got.float() - plain.float()).abs()
    err = d.max().item()
    out = {"shape": [b, s, hq, hkv, hd, vd], "window": window,
           "q_offset": off, "rows": rows, "max_abs_err": err,
           "bit_equal_share": (d == 0).float().mean().item(),
           "rows_bit_equal_to_whole_prefill": torch.equal(got, whole),
           "rows_share_equal_to_whole_prefill":
               (got == whole).float().mean().item()}
    if kernel == "blockwise":
        # the per-layer bar of phase 13 (LAYER_MAX_ULPS): a window's outputs
        # are averages of 100 keys, max |out| may sit low in its binade
        top = plain.float().abs().max()
        out["rel_err"] = err / top.item()
        out["max_ulps_of_max_out"] = err / torch.ldexp(
            torch.ones_like(top), torch.frexp(top)[1] - 8).item()
        assert out["max_ulps_of_max_out"] <= LAYER_MAX_ULPS \
            and out["bit_equal_share"] >= BLOCKWISE_MIN_EQUAL, out
    else:
        assert err <= FA_TOL_F32, out
    if off % 64 == 0 and rows % 64 == 0:
        assert out["rows_bit_equal_to_whole_prefill"], out
    return out


def _offset_timing(torch, dev, fa, kernel: str) -> dict:
    """The kernel at phase 22's SP prefill shape (qwen2.5-32b, rank 1's
    rows at q_offset S/2, its kv chunk) beside its plain version, one SDPA
    call with the offset's causal mask, and its bound."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen2.5-32b")
    b, s, tp = SP_PREFILL
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = off = s // tp
    bf = kernel == "blockwise"
    dt = torch.bfloat16 if bf else torch.float32
    gen = torch.Generator(device=dev).manual_seed(400)
    q = torch.randn((b, rows, hq, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
    if bf:
        call = lambda: fa.flash_attention_blockwise(  # noqa: E731
            q, k, v, kv_chunk=cfg.kv_chunk, q_offset=off)
        plain = lambda: fa.blockwise_attention_ref(  # noqa: E731
            q, k, v, causal=True, kv_chunk=cfg.kv_chunk, q_offset=off)
    else:
        call = lambda: fa.flash_attention(q, k, v, q_offset=off)  # noqa
        plain = lambda: fa.flash_attention_ref(q, k, v,  # noqa: E731
                                               q_offset=off)
    mask = _offset_mask(torch, rows, s, off, None, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - call().float()).abs().max()
    assert lib_err.item() <= 2e-2, f"SDPA at the offset differs: {lib_err}"
    pairs = b * hq * _offset_pairs(rows, off, None)
    flops = 4.0 * pairs * hd
    el = 2 if bf else 4
    nbytes = el * (2 * b * rows * hq * hd + 2 * b * s * hkv * hd)
    peak = PEAK_BF16_PER_S if bf else PEAK_TF32_PER_S / TF32_PASSES
    bound, by = _bound_ms(nbytes, flops, peak)
    ms = _time_ms(call)
    out = {"shape": [b, rows, hq, hkv, hd], "keys": s, "q_offset": off,
           "kv_chunk": cfg.kv_chunk if bf else None,
           "dtype": "bf16" if bf else "fp32", "ms": ms,
           "tflop_per_s": flops / ms / 1e9, "plain_ms": _time_ms(plain, 3),
           "library_ms": _time_ms(lib), "library": "SDPA, boolean mask of "
           "the offset's causal rows, enable_gqa", "bound_ms": bound,
           "bound_by": by, "unmasked_pairs": pairs, "bytes": nbytes}
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return out


def check_attention_offsets(torch, dev) -> dict:
    """Phase 12, query slices at an offset: both prefill kernels on
    ``OFFSET_CASES`` (the fp32 kernel without MLA's value dim) and timed at
    the SP prefill's shape. Returns ``{kernel: kernels-line addition}``."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    out = {}
    for kernel, name in (("blockwise", "flash_attention_blockwise"),
                         ("flash", "flash_attention")):
        cases = {}
        for i, (case, shape) in enumerate(OFFSET_CASES.items()):
            if kernel == "flash" and shape[4] != shape[5]:
                continue
            cases[case] = _offset_case(torch, dev, fa, i, *shape,
                                       kernel=kernel)
            torch.cuda.empty_cache()
        timing = _offset_timing(torch, dev, fa, kernel)
        out[name] = {"q_offset_cases": cases, "sp_prefill_shape": timing}
        print(json.dumps({"kernel_at_q_offset": name, "cases": cases,
                          "sp_prefill_shape": timing,
                          "tolerance": "against the plain version at the "
                                       "offset: fp32 FA_TOL_F32, bf16 "
                                       "LAYER_MAX_ULPS of max |out| and "
                                       "BLOCKWISE_MIN_EQUAL bit-equal; rows bit-"
                                       "equal to the whole prefill's at "
                                       "offsets and rows of a multiple of "
                                       "64; each launched twice, "
                                       "bit-identical",
                          "device": _device_line()}), flush=True)
    return out


def _gemma3_depth8():
    """gemma3-27b at full width, one repeat of each schedule segment: 7
    local layers and 1 global."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config("gemma3-27b")
    return dataclasses.replace(
        cfg, schedule=tuple((pattern, 1) for pattern, _ in cfg.schedule))


def _plain_route_last_logits(torch, T, params, batch, cfg):
    """The same forward with the route's device test saying "not the card":
    the model's attention runs the plain chunked loop, not the kernel (the
    same values as a forward with grad, without its saved activations).
    ``batch``: the tokens and the modality stubs."""
    from repro_torch.models import layers as L

    on_card = L._on_card
    L._on_card = lambda t: False
    try:
        with torch.inference_mode():
            logits, _ = T.forward(params, batch, cfg)
    finally:
        L._on_card = on_card
    return logits[:, -1].float()


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


def _prefill_attention_probe(torch, T, params, batch, cfg, mode: str):
    """One no-grad forward of the model with its attention wrapped: "gaps"
    runs the route (the kernel) and the plain loop on each attention call's
    own inputs and returns per call (share of elements that differ, max |d|
    / max |out|, max |d| in bf16 ulps of max |out|, whether the call was
    bf16), continuing with the kernel's output; "floor" runs the plain
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
                     (d.max() / ulp).item(), q.dtype == torch.bfloat16))
        return got

    T.blockwise_attention = T.sp_blockwise_attention = attn
    try:
        with torch.inference_mode():
            logits, _ = T.forward(params, batch, cfg)
    finally:
        T.blockwise_attention, T.sp_blockwise_attention = routes
    return gaps if mode == "gaps" else logits[:, -1].float()


def _attention_calls(cfg) -> int:
    """The attention calls of one forward: one a layer, two a ``dec`` layer
    (its self- and its cross-attention), one an encoder layer, none a
    recurrent layer."""
    from repro_torch.models import transformer as T

    per = {"dec": 2, **{k: 0 for k in T.RECURRENT_KINDS}}
    return cfg.encoder_layers + sum(r * per.get(k, 1)
                                    for pattern, r in cfg.schedule
                                    for k in pattern)


def run_dense_prefill(torch, dev, name: str, cfg=None, new=None,
                      prompts=None, kernel=None) -> dict:
    """Phase 13, dense engine: ``ServeEngine.generate`` of llama-350m (bf16,
    or fp32 compute) or gemma3-27b at depth 8, counters zeroed just before;
    phases 17, 19, 20 and 21: of ``cfg`` (``prompts`` (batch, length), 2 x
    2048 by default, with the stub frames or image embeddings of
    ``data.synthetic.stub_inputs`` where the config has them; ``new`` new
    tokens, GEMMA_NEW by default; ``kernel``, the blockwise kernel by
    default, for the route of an fp32 attention). The prefill launches its
    attention kernel once per attention call (``_attention_calls``: none
    in a recurrent layer: an attention-free model runs no kernel and skips
    the per-layer probes). Each call's kernel output is held to the loop's
    at the bar of its dtype (bf16: ``LAYER_MAX_ULPS``; fp32:
    ``FA_TOL_F32`` of max |out|). With MoE blocks the last logits' bar is
    ``MOE_LOGITS_FLOOR_FACTOR`` times the larger of their floor and
    PREFILL_LOGITS_RTOL, and the top-1 agreement is printed, not asserted:
    an ulp that moves a router's top-k sends a token to other experts.
    Returns the counts."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.data.synthetic import stub_inputs
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    if cfg is not None:
        (b, s), new = prompts or GEMMA_PROMPTS, new or GEMMA_NEW
    elif name == "llama-350m":
        cfg, (b, s), new = get_config(name), LLAMA_PROMPTS, LLAMA_NEW
    elif name == "llama-350m fp32":
        cfg = dataclasses.replace(get_config("llama-350m"),
                                  compute_dtype="float32")
        (b, s), new = LLAMA_F32_PROMPTS, LLAMA_NEW
    else:
        cfg, (b, s), new = _gemma3_depth8(), GEMMA_PROMPTS, GEMMA_NEW
    kernel = kernel or DENSE_RUNS.get(name, "flash_attention_blockwise")
    attn_layers = _attention_calls(cfg)
    params = T.init_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_len=s + new)
    del params
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    batch = {"tokens": tokens, **stub_inputs(
        cfg, b, torch.Generator(device=dev).manual_seed(1), dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(batch, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    assert counts[kernel] == attn_layers, counts
    assert sum(counts.values()) == attn_layers, counts
    assert out.shape == (b, new), out.shape
    again = eng.generate(batch, max_new_tokens=new)
    assert torch.equal(out, again), f"{name}: a rerun gave other tokens"

    # the prefill alone: its time, its last logits against the plain
    # route, and one run under the profiler
    with torch.inference_mode():
        T.prefill(eng.params, batch, cfg, max_len=s + new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _, _ = T.prefill(eng.params, batch, cfg, max_len=s + new)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        # an attention-free prefill (rwkv6's per-position scan) launches
        # tens of thousands of kernels, whose trace takes the profiler
        # minutes to digest: it is profiled by scripts/recurrent_probe.py
        prof = None
        if attn_layers:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                T.prefill(eng.params, batch, cfg, max_len=s + new)
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated()
    plain = _plain_route_last_logits(torch, T, eng.params, batch, cfg)
    last = last.float()
    assert torch.isfinite(last).all() and last.shape == (b, cfg.vocab_size)
    rel = ((last - plain).norm() / plain.norm()).item()
    top1 = (last.argmax(-1) == plain.argmax(-1)).float().mean().item()
    # each layer's kernel output against the loop on the same inputs
    gaps, floor = [], 0.0
    if attn_layers:
        gaps = _prefill_attention_probe(torch, T, eng.params, batch, cfg,
                                        "gaps")
        floor_logits = _prefill_attention_probe(torch, T, eng.params, batch,
                                                cfg, "floor")
        floor = ((floor_logits - plain).norm() / plain.norm()).item()
    moe = any(k in T.MOE_KINDS for k in cfg.block_kinds())
    print(json.dumps({"dense_prefill_checks": name, "moe": moe,
                      "last_logits_rel_to_plain_route": rel,
                      "plain_route_floor_rel": floor, "top1": top1,
                      "per_layer_gaps": gaps}), flush=True)
    if moe:
        bar = MOE_LOGITS_FLOOR_FACTOR * max(floor, PREFILL_LOGITS_RTOL)
        assert rel <= bar, f"{name}: prefill logits {rel} from the plain " \
            f"route, bar {bar} (floor {floor})"
    else:
        assert rel <= PREFILL_LOGITS_RTOL and top1 == 1.0, \
            f"{name}: prefill logits {rel} from the plain route, top-1 {top1}"
    for i, (share, gap, ulps, bf16) in enumerate(gaps):
        if bf16:
            assert ulps <= LAYER_MAX_ULPS \
                and 1.0 - share >= BLOCKWISE_MIN_EQUAL, \
                f"{name} layer {i}: {share} differ, by up to {ulps} ulps"
        else:
            assert gap <= FA_TOL_F32, f"{name} layer {i}: max |d| {gap}"
    profiled = {"prefill_device_time": "not measured here (no attention "
                                       "layer): scripts/recurrent_probe.py "
                                       "--prefill-once"}
    if prof is not None:
        kernels, busy_ms = _device_kernels(prof)
        profiled = {
            "profiled_prefill_wall_ms": prof_wall_ms,
            "prefill_device_busy_ms": busy_ms,
            "prefill_device_idle_share": 1.0 - busy_ms / prof_wall_ms,
            f"{kernel}_device_ms": sum(_dev_us(e) for e in kernels
                                       if f"{kernel}_fwd" in e.key) / 1e3,
            "prefill_kernel_launches": sum(e.count for e in kernels),
            "top_device_kernels": _top(kernels, 8)}
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
        "params": T.param_count(eng.params), **profiled}), flush=True)
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
def _cli_run(torch, argv, stop_at=None, steps=STEPS,
             per_step=LAUNCHES_PER_STEP):
    """One in-process run of the training CLI's path (``launch.train.run``),
    the counters zeroed just before it and read just after; each kernel of
    the step must have run ``per_step`` times per step (7: llama-350m's
    matrix leaves). Returns the history, the counts and the peak device
    memory."""
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
        assert n == per_step * steps, \
            f"{argv}: {name} ran {n} times in {steps} steps, expected " \
            f"{per_step * steps}"
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
    layers (``None``: the configuration's own depth): ``depth / len(pattern)``
    repeats of its pattern where that divides (a one-kind pattern; two
    repeats of llama-3.2-vision's five), else the first ``depth`` positions
    of the pattern (jamba's), once; a tuple of kinds is that pattern,
    once."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if isinstance(depth, tuple):
        return dataclasses.replace(cfg, schedule=((depth, 1),))
    if depth is None or depth == cfg.n_layers:
        return cfg
    (pattern, _), = cfg.schedule
    if depth % len(pattern):
        assert depth < len(pattern), (arch, depth)
        return dataclasses.replace(cfg, schedule=((pattern[:depth], 1),))
    return dataclasses.replace(cfg, schedule=((pattern,
                                               depth // len(pattern)),))


def _decode_case(torch, dev, fd, seed, hq, hkv, hd, launches) -> dict:
    """``flash_decode`` at (hq, hkv, hd) on the paged engine's slots (4,
    block 16, lengths ``CONFIG_DECODE_LENS``: up to a 2048-token prompt and
    32 new tokens, bf16 pools) against its plain version (q in fp32 and
    bf16, 1 and 2 splits, each launched twice), timed per call beside its
    bound and SDPA on the densified K/V (graph replays of ``launches``
    calls)."""
    f32, bf16 = torch.float32, torch.bfloat16
    maxb = -(-(GEMMA_PROMPT_LENS[1] + GEMMA_NEW) // BLOCK)
    run_blocks = sum(-(-n // BLOCK) for n in CONFIG_DECODE_LENS)
    args = _fd_case(torch, dev, seed, b=GEMMA_SLOTS, hq=hq, hkv=hkv, hd=hd,
                    bs=BLOCK, maxb=maxb, lengths=CONFIG_DECODE_LENS,
                    kv_dtype=bf16)
    assert fd.vector_path(args[1], args[2]), (hq, hkv, hd)
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
    return {
        "shape": [GEMMA_SLOTS, hq, hkv, hd], "lengths": CONFIG_DECODE_LENS,
        "splits": NUM_SPLITS, "max_abs_err": max(errs),
        "ms": _graph_ms(call, launches), "wrapper_ms": _time_ms(call),
        "plain_ms": _time_ms(lambda: fd.flash_decode_plain(
            q, k, v, table, ln, num_splits=NUM_SPLITS), 3),
        "library_ms": _graph_ms(_fd_sdpa(torch, q, k, v, table, ln),
                                launches),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops}


def _prefill_case(torch, dev, fa, seed, hq, hkv, hd, chunk,
                  vd=None, skv=None, causal=True) -> dict:
    """``flash_attention_blockwise`` at a prefill of ``GEMMA_PROMPTS`` (2 x
    2048, causal, kv chunk ``chunk``; v of head dim ``vd``, hd by default;
    ``skv`` keys of their own length, without a mask, with ``causal``
    False) against its plain version at the model's bar, timed per call
    beside its bound and SDPA on the same tensors."""
    b, s = GEMMA_PROMPTS
    vd, skv = vd or hd, skv or s
    gen = torch.Generator(device=dev).manual_seed(seed)
    qa, ka, va = (torch.randn((b, n, h, w), generator=gen, device=dev)
                  .to(torch.bfloat16) for n, h, w in (
                      (s, hq, hd), (skv, hkv, hd), (skv, hkv, vd)))
    gaps = _blockwise_compare(torch, fa, qa, ka, va, causal, None, chunk)
    pairs = b * hq * (_fa_pairs(s, True, None) if causal else s * skv)
    flops = 2.0 * pairs * (hd + vd)
    nbytes = 2 * (b * s * hq * (hd + vd) + b * skv * hkv * (hd + vd))
    bound, by = _bound_ms(nbytes, flops, PEAK_BF16_PER_S)
    ms = _time_ms(lambda: fa.flash_attention_blockwise(
        qa, ka, va, causal=causal, kv_chunk=chunk))
    sdpa = _sdpa(torch, qa, ka, va, None, causal)
    out = {
        "shape": [b, s, hq, hkv, hd], "keys": skv, "causal": causal,
        "v_head_dim": vd, "kv_chunk": chunk,
        "effective_kv_chunk": fa.effective_kv_chunk(skv, chunk),
        **gaps, "ms": ms, "tflop_per_s": flops / ms / 1e9,
        "plain_ms": _time_ms(lambda: fa.blockwise_attention_ref(
            qa, ka, va, causal=causal, kv_chunk=chunk), 3),
        "library_ms": _library_ms(sdpa), "bound_ms": bound, "bound_by": by,
        "bytes": nbytes, "flops": flops}
    if vd != hd:
        out["library_backends"] = _sdpa_backends(torch, qa, ka, va)
    del qa, ka, va, sdpa
    torch.cuda.empty_cache()
    return out


def check_config_kernels(torch, dev) -> dict:
    """Phase 17 (a): ``flash_decode`` and ``flash_attention_blockwise`` at
    the dense configurations' decode and prefill shapes against their plain
    versions, each timed per call beside its bound and SDPA on the same
    tensors. Returns ``{arch: {kernel: case}}``."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    out = {}
    for i, (arch, (hq, hkv, hd)) in enumerate(CONFIG_DECODE_SHAPES.items()):
        cfg = _config(arch)
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (hq, hkv, hd), arch
        decode = _decode_case(torch, dev, fd, 40 + i, hq, hkv, hd,
                              CONFIG_SERVE_DEPTHS[arch])
        torch.cuda.empty_cache()
        prefill = _prefill_case(torch, dev, fa, 50 + i, hq, hkv, hd,
                                cfg.kv_chunk)
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
def _registry_depth(arch: str, depth, cfg=None):
    """The registry's ``arch`` cut to ``depth`` layers (or replaced by
    ``cfg``) while the training CLI builds and runs (the CLI has no depth
    flag)."""
    from repro_torch.configs import registry

    full = registry.ARCHS[arch]
    registry.ARCHS[arch] = cfg or _config(arch, depth)
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


# ---------------------------------------------------------------------------
# phase 19: the DeepSeek MoE family
# ---------------------------------------------------------------------------
def _moe_config(arch: str, layers):
    """``arch`` at full width, its two schedule segments cut to ``layers``
    (a segment of 0 layers left out)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, schedule=tuple(
        (pattern, n) for (pattern, _), n in zip(cfg.schedule, layers) if n))


def _lowrank_shapes(cfg) -> dict:
    """``{path: oriented (..., m, n)}`` of the leaves DCT-AdamW projects:
    one launch of each training kernel per leaf and step."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.common import default_label_fn, oriented_dims

    return {k: (*p.shape[:-2], *oriented_dims(p.shape))
            for k, p in T.init_params(cfg, 0, "meta").items()
            if default_label_fn(k, p) == "lowrank"}


def _leaf_case(torch, dev, shape, per_step: int) -> dict:
    """The four DCT-AdamW kernels on one oriented leaf shape against their
    plain versions at phase 2's bars (``dct_project`` S within 1e-5 of max
    |S| and norms within 1e-5, the same top-r, relaunch bit-identical; the
    dual colgather within 1e-5 of max |out|, relaunch bit-identical; the
    quantizer's scales equal and codes within 1; ``dequant_add_ef``
    exact), r = min(128, n). Returns per-step times (``per_step``
    launches), bytes and flops of each kernel."""
    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.selection import select_top_r, take_columns
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    dp = importlib.import_module("repro_torch.kernels.dct_project")
    from repro_torch.kernels import quant_ef as qe

    *batch, m, n = shape
    nb, r = math.prod(batch), min(RANK, n)
    e = nb * m * n
    gen = torch.Generator(device=dev).manual_seed(19)
    q = dct2_matrix(n, device=dev)
    qt = q.T.contiguous()
    g = _planted(shape, q, gen, r)
    out = {}

    def row(name, err, kernel_ms, plain_ms, library_ms, nbytes, flops):
        bound, by = _bound_ms(per_step * nbytes, per_step * flops)
        out[name] = {"max_abs_err": err, "ms": per_step * kernel_ms,
                     "plain_ms": per_step * plain_ms,
                     "library_ms": None if library_ms is None
                     else per_step * library_ms,
                     "bound_ms": bound, "bound_by": by,
                     "launches_per_step": per_step}

    s_k, n_k = dp.dct_project(g, q)
    s_p, n_p = dp.dct_project_plain(g, q)
    again = dp.dct_project(g, q)
    torch.cuda.synchronize()
    err = (s_k - s_p).abs().max().item()
    norm_rel = ((n_k - n_p).abs() / n_p.clamp_min(1e-30)).max().item()
    idx_k = select_top_r(n_k, r)
    assert err <= 1e-5 * s_p.abs().max().item() and norm_rel <= 1e-5 \
        and torch.equal(idx_k, select_top_r(n_p, r)) \
        and torch.equal(again[0], s_k) and torch.equal(again[1], n_k), \
        f"dct_project {shape}: max |dS| {err}, norms {norm_rel}"
    del again, s_p
    row("dct_project", err, _time_ms(lambda: dp.dct_project(g, q), 3),
        _time_ms(lambda: dp.dct_project_plain(g, q), 3),
        _time_ms(lambda: torch.matmul(g, q), 3),
        4.0 * (2 * e + n * n + nb * n), 2.0 * e * n + 2.0 * e)

    b1 = take_columns(s_k, idx_k).contiguous()
    del s_k
    b2 = torch.randn(b1.shape, generator=gen, device=dev)
    o_k = cg.colgather_matmul_dual(b1, b2, qt, idx_k)
    o_p = cg.colgather_matmul_dual_plain(b1, b2, qt, idx_k)
    again = cg.colgather_matmul_dual(b1, b2, qt, idx_k)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(o_k, o_p))
    ref = max(b.abs().max().item() for b in o_p)
    assert err <= 1e-5 * ref and all(map(torch.equal, again, o_k)), \
        f"colgather_matmul_dual {shape}: {err} of {ref}"
    del again, o_p
    rows_needed = torch.unique(idx_k).numel()
    row("colgather_matmul_dual", err,
        _time_ms(lambda: cg.colgather_matmul_dual(b1, b2, qt, idx_k), 3),
        _time_ms(lambda: cg.colgather_matmul_dual_plain(b1, b2, qt, idx_k),
                 3), None,
        4.0 * (2 * nb * m * r + rows_needed * n + nb * r + 2 * e),
        2 * 2.0 * nb * m * n * r)

    resid = g - o_k[1]
    del o_k
    q_k, sc_k = qe.quantize_ef(resid)
    q_p, sc_p = qe.quantize_ef_plain(resid)
    torch.cuda.synchronize()
    dq = (q_k.int() - q_p.int()).abs().max().item()
    assert torch.equal(sc_k, sc_p) and dq <= 1, f"quantize_ef {shape}: {dq}"
    del q_p
    row("quantize_ef", float(dq), _time_ms(lambda: qe.quantize_ef(resid), 3),
        _time_ms(lambda: qe.quantize_ef_plain(resid), 3), None,
        5.0 * e + 4.0 * nb * m, 5.0 * e)
    out_k = qe.dequant_add_ef(g, q_k, sc_k)
    out_p = qe.dequant_add_ef_plain(g, q_k, sc_k)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    assert err == 0.0, f"dequant_add_ef {shape}: {err}"
    del out_k, out_p
    qf = q_k.float()
    row("dequant_add_ef", err,
        _time_ms(lambda: qe.dequant_add_ef(g, q_k, sc_k), 3),
        _time_ms(lambda: qe.dequant_add_ef_plain(g, q_k, sc_k), 3),
        _time_ms(lambda: torch.addcmul(g, qf, sc_k), 3),
        9.0 * e + 4.0 * nb * m, 2.0 * e)
    del g, b1, b2, resid, q_k, qf
    torch.cuda.empty_cache()
    return out


def check_moe_kernels(torch, dev) -> dict:
    """Phase 19 (a): ``flash_decode`` at deepseek-moe-16b's decode (16 / 16
    heads of 128: group 1), ``flash_attention_blockwise`` at its prefill and
    at deepseek-v3-671b's MLA prefill (128 heads, q / k head dim 192, v 128)
    and the four DCT-AdamW kernels at ``MOE_LEAF_SHAPES``, each against its
    plain version. Returns ``{kernel: {case: row}}``."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    dsm = _moe_config("deepseek-moe-16b", MOE_SERVE_LAYERS["deepseek-moe-16b"])
    v3 = _moe_config("deepseek-v3-671b", MOE_SERVE_LAYERS["deepseek-v3-671b"])
    out = {"flash_decode": {}, "flash_attention_blockwise": {}}
    out["flash_decode"]["deepseek-moe-16b"] = _decode_case(
        torch, dev, fd, 60, dsm.n_heads, dsm.n_kv_heads, dsm.hd,
        dsm.n_layers)
    out["flash_attention_blockwise"]["deepseek-moe-16b"] = _prefill_case(
        torch, dev, fa, 61, dsm.n_heads, dsm.n_kv_heads, dsm.hd,
        dsm.kv_chunk)
    out["flash_attention_blockwise"]["deepseek-v3-671b"] = _prefill_case(
        torch, dev, fa, 62, v3.n_heads, v3.n_heads,
        v3.qk_nope_dim + v3.qk_rope_dim, v3.kv_chunk, vd=v3.v_head_dim)
    for name, (shape, per_step) in MOE_LEAF_SHAPES.items():
        for kernel, case in _leaf_case(torch, dev, shape, per_step).items():
            out.setdefault(kernel, {})[name] = {"shape": list(shape), **case}
    print(json.dumps({"moe_kernels": out,
                      "tolerance": "flash_decode: phase 5's; blockwise: "
                                   "phase 12's; the training kernels: "
                                   "phase 2's; each launched twice, "
                                   "bit-identical"}), flush=True)
    return out


def run_moe_serving(torch, dev) -> dict:
    """Phase 19 (b): deepseek-moe-16b on the dense and the paged engine and
    deepseek-v3-671b on the dense engine (its latent-cache decode) at
    ``MOE_SERVE_LAYERS``, through phase 13's runs (their launch counts
    asserted there: one blockwise launch per layer and prefill, one
    ``flash_decode`` per layer and decode step). Returns the launches."""
    out = {}
    for arch, layers in MOE_SERVE_LAYERS.items():
        cfg = _moe_config(arch, layers)
        name = f"{arch} depth {cfg.n_layers}"
        new = MLA_DECODE_NEW if cfg.kv_lora_rank else None
        dense = run_dense_prefill(torch, dev, name, cfg, new)
        out[arch] = {"flash_attention_blockwise_per_prefill":
                     dense["flash_attention_blockwise"]}
        if arch == "deepseek-moe-16b":
            paged = run_paged(torch, dev, cfg, f"{name} bf16 "
                              "PagedServeEngine, flash_decode")
            out[arch].update(flash_decode_per_decode_step=cfg.n_layers,
                             flash_decode_in_paged_run=paged["flash_decode"])
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_moe_training(torch, dev, runs=None) -> dict:
    """Phase 19 (c): DCT-AdamW through the training CLI at
    ``MOE_TRAIN_RUNS``, counters zeroed just before each run and read just
    after: each of the four kernels once per projected leaf and step (the
    4-D expert leaves among them), no attention kernel (training runs the
    plain loop), finite losses (and MTP term). Returns ``{arch: launches
    per step}``. ``runs``: in place of ``MOE_TRAIN_RUNS``."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    out = {}
    for arch, layers, batch in runs or MOE_TRAIN_RUNS:
        cfg = _moe_config(arch, layers)
        leaves = _lowrank_shapes(cfg)
        argv = ["--arch", arch, "--optimizer", "dct_adamw", "--rank",
                str(RANK), "--steps", str(MOE_TRAIN_STEPS), "--warmup", "2",
                "--batch", str(batch), "--seq-len", str(SEQ),
                "--log-every", "1"]
        with _registry_depth(arch, None, cfg):
            t0 = time.perf_counter()
            hist, counts, peak = _cli_run(torch, argv, steps=MOE_TRAIN_STEPS,
                                          per_step=len(leaves))
            wall = time.perf_counter() - t0
        assert not any(ops.launch_counts(ops.ATTENTION).values()), arch
        losses = [h["loss"] for h in hist]
        mtp = [h["mtp_ce"] for h in hist if "mtp_ce" in h]
        assert all(math.isfinite(x) for x in losses + mtp), (arch, losses)
        assert len(mtp) == (MOE_TRAIN_STEPS if cfg.mtp else 0), (arch, mtp)
        ms = _ms_after_first(hist)
        gc.collect()
        torch.cuda.empty_cache()
        summary = {
            "moe_training": f"{arch} {dict(zip(cfg.block_kinds(), layers))} "
                            f"dct_adamw rank {RANK} fused auto->on",
            "param_dtype": cfg.param_dtype,
            "params": T.param_count(T.init_params(cfg, 0, "meta")),
            "projected_leaves": {k: list(v) for k, v in leaves.items()},
            "steps": MOE_TRAIN_STEPS, "batch": batch, "seq_len": SEQ,
            "losses": losses, "mtp_ce": mtp,
            "first_step_ms": hist[0]["s_per_step"] * 1e3,
            "ms_per_step_after_first": ms,
            "tokens_per_s": batch * SEQ / (ms / 1e3),
            "max_memory_allocated_bytes": peak, "wall_s": wall,
            "launches_per_step": {k: v / MOE_TRAIN_STEPS
                                  for k, v in counts.items()}}
        print(json.dumps(summary), flush=True)
        out[arch] = summary["launches_per_step"]
    return out


def run_moe_family(torch, dev) -> dict:
    """Phase 19: (a) the kernels at the family's shapes, (b) serving, (c)
    training. Returns the kernels line's additions."""
    t0 = time.perf_counter()
    cases = check_moe_kernels(torch, dev)
    serving = run_moe_serving(torch, dev)
    training = run_moe_training(torch, dev)
    print(json.dumps({"moe_phase_wall_s": time.perf_counter() - t0}),
          flush=True)
    return {"cases": cases, "serving": serving, "training": training}


def _fft_bf16_leaf_case(torch, dev, shape, bf16: bool) -> dict:
    """On one oriented leaf shape: the "fft" route's S (the Makhoul
    transform, at odd n too) within 1e-5 of max |S| of the fp32 kernel's;
    with ``bf16`` the bf16 ``dct_project`` and dual colgather (r = n)
    against their plain versions at ``LOWP_TC_RTOL`` of max |out|, each
    relaunched bit-identical."""
    from repro_torch.core.dct import dct2_matrix, makhoul_dct2
    from repro_torch.core.selection import select_top_r, take_columns
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    dp = importlib.import_module("repro_torch.kernels.dct_project")

    n = shape[-1]
    gen = torch.Generator(device=dev).manual_seed(20)
    q = dct2_matrix(n, device=dev)
    qt = q.T.contiguous()
    g = _planted(shape, q, gen, min(RANK, n))
    s32, _ = dp.dct_project(g, q)
    s_fft = makhoul_dct2(g)
    torch.cuda.synchronize()
    out = {"shape": list(shape), "fft_vs_kernel_rel": _rel(s_fft, s32)}
    assert out["fft_vs_kernel_rel"] <= 1e-5, out
    del s_fft, s32
    if not bf16:
        del g
        torch.cuda.empty_cache()
        return out
    s_bf, n_bf = dp.dct_project(g, q, compute_dtype="bf16")
    sp_bf, np_bf = dp.dct_project_plain(g, q, compute_dtype="bf16")
    again = dp.dct_project_bf16(g, q)
    torch.cuda.synchronize()
    out.update(rank=n, dct_project_bf16_rel_err=_rel(s_bf, sp_bf))
    assert out["dct_project_bf16_rel_err"] <= LOWP_TC_RTOL, out
    assert torch.equal(again[0], s_bf) and torch.equal(again[1], n_bf), \
        f"dct_project_bf16 {shape}: a relaunch differs"
    idx = select_top_r(n_bf, n)
    b1 = take_columns(s_bf, idx).contiguous()
    b2 = torch.randn(b1.shape, generator=gen, device=dev)
    o_k = cg.colgather_matmul_dual(b1, b2, qt, idx, compute_dtype="bf16")
    o_p = cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                         compute_dtype="bf16")
    again = cg.colgather_matmul_dual_bf16(b1, b2, qt, idx)
    torch.cuda.synchronize()
    out["colgather_matmul_dual_bf16_rel_err"] = max(
        _rel(a, b) for a, b in zip(o_k, o_p))
    assert out["colgather_matmul_dual_bf16_rel_err"] <= LOWP_TC_RTOL, out
    assert all(map(torch.equal, again, o_k)), \
        f"colgather_matmul_dual_bf16 {shape}: a relaunch differs"
    del g, s_bf, sp_bf, b1, b2, o_k, o_p, again
    torch.cuda.empty_cache()
    return out


def check_recurrent_kernels(torch, dev) -> dict:
    """Phase 20 (a): ``flash_attention_blockwise`` at jamba's prefill (64 /
    8 heads of 128, 2 x 2048, its kv chunk) and the four DCT-AdamW kernels
    in fp32 at ``RECURRENT_LEAF_SHAPES`` (r = min(128, n)) against their
    plain versions, and the "fft" route's S against the kernel's; at n =
    24, 16 and 9 (r = n) also int8 (phase 16's ``check_kernels_at_rank``)
    and bf16. Returns ``{kernel: {case: row}}``."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    jamba = _config("jamba-1.5-large-398b",
                              RECURRENT_SERVE["jamba-1.5-large-398b"])
    out = {"flash_attention_blockwise": {
        "jamba-1.5-large-398b": _prefill_case(
            torch, dev, fa, 63, jamba.n_heads, jamba.n_kv_heads, jamba.hd,
            jamba.kv_chunk)}}
    for name, (shape, per_step) in RECURRENT_LEAF_SHAPES.items():
        for kernel, case in _leaf_case(torch, dev, shape, per_step).items():
            out.setdefault(kernel, {})[name] = {"shape": list(shape), **case}
    lowp_cases = {}
    for name, (shape, _) in RECURRENT_LEAF_SHAPES.items():
        lowp = name in RECURRENT_LOWP_LEAVES
        lowp_cases[name] = {"fft_bf16": _fft_bf16_leaf_case(torch, dev,
                                                             shape, lowp)}
        if lowp:
            lowp_cases[name]["fp32_int8"] = check_kernels_at_rank(
                torch, dev, shape[-1], shape)
    print(json.dumps({"recurrent_kernels": out,
                      "recurrent_lowp_cases": lowp_cases,
                      "tolerance": "blockwise: phase 12's; the training "
                                   "kernels: phase 2's (fp32), phase 10's "
                                   "(bf16 LOWP_TC_RTOL, int8 bit-equal); "
                                   "fft S within 1e-5 of max |S|"}),
          flush=True)
    return out


def run_recurrent_serving(torch, dev) -> dict:
    """Phase 20 (b): jamba-1.5-large-398b and rwkv6-1.6b on the dense
    engine at ``RECURRENT_SERVE`` depths through phase 13's run (its
    checks: one blockwise launch per attention layer and prefill, none in a
    recurrent layer; the MoE bar for jamba's last logits; per-layer ulps at
    the attention layer), ``RECURRENT_NEW`` decode steps of the recurrent
    state. Returns the blockwise launches per prefill."""
    out = {}
    for arch, layers in RECURRENT_SERVE.items():
        cfg = _config(arch, layers)
        name = f"{arch} depth {cfg.n_layers}"
        counts = run_dense_prefill(torch, dev, name, cfg, RECURRENT_NEW,
                                   RECURRENT_PROMPTS[arch])
        out[arch] = {"flash_attention_blockwise_per_prefill":
                     counts["flash_attention_blockwise"]}
        gc.collect()
        torch.cuda.empty_cache()
    assert out["jamba-1.5-large-398b"][
        "flash_attention_blockwise_per_prefill"] >= 1, out
    return out


def run_recurrent_training(torch, dev, runs=None) -> dict:
    """Phase 20 (c): DCT-AdamW through the training CLI at
    ``RECURRENT_TRAIN_RUNS``, counters zeroed just before each run and read
    just after: each of the four kernels once per projected leaf and step
    (rwkv6's stacked mixes at n = 24 and ``bonus_u`` at n = 32 among them),
    no attention kernel, finite losses. Returns ``{arch: launches per
    step}``. ``runs``: in place of ``RECURRENT_TRAIN_RUNS``."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    out = {}
    for arch, layers, batch in runs or RECURRENT_TRAIN_RUNS:
        cfg = _config(arch, layers)
        leaves = _lowrank_shapes(cfg)
        argv = ["--arch", arch, "--optimizer", "dct_adamw", "--rank",
                str(RANK), "--steps", str(MOE_TRAIN_STEPS), "--warmup", "2",
                "--batch", str(batch), "--seq-len", str(SEQ),
                "--log-every", "1"]
        with _registry_depth(arch, None, cfg):
            t0 = time.perf_counter()
            hist, counts, peak = _cli_run(torch, argv, steps=MOE_TRAIN_STEPS,
                                          per_step=len(leaves))
            wall = time.perf_counter() - t0
        assert not any(ops.launch_counts(ops.ATTENTION).values()), arch
        assert all(counts.values()), (arch, counts)
        losses = [h["loss"] for h in hist]
        assert all(math.isfinite(x) for x in losses), (arch, losses)
        ms = _ms_after_first(hist)
        gc.collect()
        torch.cuda.empty_cache()
        summary = {
            "recurrent_training": f"{arch} {cfg.n_layers} layers "
                                  f"{list(cfg.block_kinds())} dct_adamw "
                                  f"rank {RANK} fused auto->on",
            "param_dtype": cfg.param_dtype,
            "params": T.param_count(T.init_params(cfg, 0, "meta")),
            "projected_leaves": {k: list(v) for k, v in leaves.items()},
            "steps": MOE_TRAIN_STEPS, "batch": batch, "seq_len": SEQ,
            "losses": losses,
            "first_step_ms": hist[0]["s_per_step"] * 1e3,
            "ms_per_step_after_first": ms,
            "tokens_per_s": batch * SEQ / (ms / 1e3),
            "max_memory_allocated_bytes": peak, "wall_s": wall,
            "launches_per_step": {k: v / MOE_TRAIN_STEPS
                                  for k, v in counts.items()},
            "device": _device_line()}
        print(json.dumps(summary), flush=True)
        out[arch] = summary["launches_per_step"]
    return out


def run_recurrent_family(torch, dev) -> dict:
    """Phase 20: (a) the kernels at the recurrent families' shapes, (b)
    serving, (c) training. Returns the kernels line's additions."""
    walls = [time.perf_counter()]
    cases = check_recurrent_kernels(torch, dev)
    walls.append(time.perf_counter())
    serving = run_recurrent_serving(torch, dev)
    walls.append(time.perf_counter())
    training = run_recurrent_training(torch, dev)
    walls.append(time.perf_counter())
    print(json.dumps({"recurrent_phase_wall_s": walls[-1] - walls[0],
                      "parts_wall_s": dict(zip("abc", (
                          b - a for a, b in zip(walls, walls[1:])))),
                      "device": _device_line()}), flush=True)
    return {"cases": cases, "serving": serving, "training": training}


def _fp32_attention_case(torch, dev, fa, seed, b, sq, skv, hq, hkv, hd,
                         causal) -> dict:
    """``flash_attention`` on fp32 inputs (the fp32 route) at (B, Sq, Hq,
    hd) queries against (B, Skv, Hkv, hd) keys (``causal``: Sq == Skv):
    twice (bit-identical) against its plain version within ``FA_TOL_F32``,
    and against the model's plain loop (``blockwise_attention_ref``, what
    the plain route runs); timed per call beside its bounds and fp32 SDPA
    on the same tensors."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, hq, hd), generator=gen, device=dev)
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen, device=dev)
            for _ in range(2))

    def call():
        return fa.flash_attention(q, k, v, causal=causal)

    got, again = call(), call()
    want = fa.flash_attention_ref(q, k, v, causal=causal)
    loop = fa.blockwise_attention_ref(q, k, v, causal=causal, kv_chunk=1024)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert torch.equal(got, again), "flash_attention: relaunch differs"
    err = (got - want).abs().max().item()
    loop_err = (got - loop).abs().max().item()
    assert err <= FA_TOL_F32 and loop_err <= FA_TOL_F32, (err, loop_err)
    lib = _sdpa(torch, q, k, v, None, causal)
    lib_err = (lib().transpose(1, 2) - want).abs().max().item()
    assert lib_err <= 2e-2, f"SDPA differs by {lib_err}"
    pairs = b * hq * (_fa_pairs(sq, True, None) if causal else sq * skv)
    flops = 4.0 * pairs * hd
    nbytes = 4 * (2 * b * sq * hq * hd + 2 * b * skv * hkv * hd)
    bound, by = _bound_ms(nbytes, flops, PEAK_TF32_PER_S / TF32_PASSES)
    ms = _time_ms(call)
    out = {"shape": [b, sq, hq, hkv, hd], "keys": skv, "causal": causal,
           "dtype": "fp32", "max_abs_err": err,
           "max_abs_err_vs_model_loop": loop_err, "sdpa_max_abs_err": lib_err,
           "ms": ms, "tflop_per_s": flops / ms / 1e9,
           "plain_ms": _time_ms(lambda: fa.flash_attention_ref(
               q, k, v, causal=causal), 3),
           "library_ms": _library_ms(lib), "bound_ms": bound, "bound_by": by,
           "bound_peak": "TF32 495 TFLOP/s / 3 passes",
           "bytes": nbytes, "flops": flops}
    del q, k, v, got, again, want, loop, lib
    torch.cuda.empty_cache()
    return out


def check_encdec_kernels(torch, dev) -> dict:
    """Phase 21 (a): the fp32 ``flash_attention`` at whisper's encoder,
    decoder self-attention and cross-attention (``ENCDEC_FA_CASES``), the
    blockwise kernel at vision's self- and cross-attention
    (``ENCDEC_BLOCKWISE_CASES``), and the four DCT-AdamW kernels at
    ``ENCDEC_LEAF_SHAPES``, each against its plain version. Returns
    ``{kernel: {case: row}}``."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    whisper = _config("whisper-large-v3")
    vision = _config("llama-3.2-vision-90b")
    out = {"flash_attention": {}, "flash_attention_blockwise": {}}
    for i, (name, (b, sq, skv, causal)) in enumerate(ENCDEC_FA_CASES.items()):
        out["flash_attention"][name] = _fp32_attention_case(
            torch, dev, fa, 70 + i, b, sq, skv, whisper.n_heads,
            whisper.n_kv_heads, whisper.hd, causal)
    for i, (name, (b, sq, skv, causal)) in enumerate(
            ENCDEC_BLOCKWISE_CASES.items()):
        assert (b, sq) == GEMMA_PROMPTS, name
        out["flash_attention_blockwise"][name] = _prefill_case(
            torch, dev, fa, 75 + i, vision.n_heads, vision.n_kv_heads,
            vision.hd, vision.kv_chunk, skv=skv, causal=causal)
    for name, (shape, per_step) in ENCDEC_LEAF_SHAPES.items():
        for kernel, case in _leaf_case(torch, dev, shape, per_step).items():
            out.setdefault(kernel, {})[name] = {"shape": list(shape), **case}
    print(json.dumps({"encdec_kernels": out,
                      "tolerance": f"flash_attention: {FA_TOL_F32} of its "
                                   "plain version and of the model's loop; "
                                   "blockwise: phase 12's; the training "
                                   "kernels: phase 2's; each launched "
                                   "twice, bit-identical",
                      "device": _device_line()}), flush=True)
    return out


def run_encdec_serving(torch, dev) -> dict:
    """Phase 21 (b): whisper-large-v3 and llama-3.2-vision-90b on the dense
    engine at ``ENCDEC_SERVE`` through phase 13's run with the stub frames
    and image embeddings (its checks: one attention launch per attention
    call of the prefill, whisper's on the fp32 ``flash_attention`` (96:
    its encoder, decoder and cross-attentions), vision's on the blockwise
    kernel (10); the last logits against the plain route; each call's
    kernel output at phase 13's bar), ``ENCDEC_NEW`` decode steps over the
    cross caches. Returns the launches per prefill."""
    out = {}
    for arch, (layers, prompts) in ENCDEC_SERVE.items():
        cfg = _config(arch, layers)
        kernel = ("flash_attention" if arch == "whisper-large-v3"
                  else "flash_attention_blockwise")
        counts = run_dense_prefill(torch, dev, f"{arch} depth {cfg.n_layers}",
                                   cfg, ENCDEC_NEW, prompts, kernel)
        out[arch] = {f"{kernel}_per_prefill": counts[kernel]}
        gc.collect()
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _expandable_segments(torch):
    """The caching allocator's expandable segments while the block runs
    (set back after), the earlier phases' bases dropped from the process
    cache first (a memo: a run rebuilds the ones it needs). A training step
    of vision's full-width embeddings (two 1.05 B-element tables, their
    fp32 gradients, old and new Adam moments) fills the card: a cross
    layer's step peaked at 81.9 GB allocated of 85.0, and without
    expandable segments 4-13 GB sat in cached blocks too small for the next
    3.9 GB request (scripts/encdec_probe.py, NVIDIA H100 80GB HBM3, 700
    W)."""
    from repro_torch.core.transforms import basis_cache

    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    basis_cache().clear()
    gc.collect()
    torch.cuda.empty_cache()
    setting("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        setting("expandable_segments:False")


def run_encdec_training(torch, dev, runs=None) -> dict:
    """Phase 21 (c): DCT-AdamW through the training CLI at
    ``ENCDEC_TRAIN_RUNS``, counters zeroed just before each run and read
    just after: each of the four kernels once per projected leaf and step,
    no attention kernel (training runs the plain loop: the encoder's and
    the cross-attentions' backward too), finite losses. Returns ``{arch:
    launches per step}``. ``runs``: in place of ``ENCDEC_TRAIN_RUNS``."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    out = {}
    for arch, layers, batch, seq in runs or ENCDEC_TRAIN_RUNS:
        cfg = _config(arch, layers)
        leaves = _lowrank_shapes(cfg)
        argv = ["--arch", arch, "--optimizer", "dct_adamw", "--rank",
                str(RANK), "--steps", str(ENCDEC_TRAIN_STEPS), "--warmup",
                "2", "--batch", str(batch), "--seq-len", str(seq),
                "--log-every", "1"]
        with _registry_depth(arch, None, cfg), _expandable_segments(torch):
            t0 = time.perf_counter()
            hist, counts, peak = _cli_run(torch, argv,
                                          steps=ENCDEC_TRAIN_STEPS,
                                          per_step=len(leaves))
            wall = time.perf_counter() - t0
        assert not any(ops.launch_counts(ops.ATTENTION).values()), arch
        assert all(counts.values()), (arch, counts)
        losses = [h["loss"] for h in hist]
        assert all(math.isfinite(x) for x in losses), (arch, losses)
        ms = _ms_after_first(hist)
        gc.collect()
        torch.cuda.empty_cache()
        summary = {
            "encdec_training": f"{arch} {cfg.n_layers} layers "
                               f"{list(cfg.block_kinds())} (encoder "
                               f"{cfg.encoder_layers}) dct_adamw rank "
                               f"{RANK} fused auto->on",
            "param_dtype": cfg.param_dtype,
            "params": T.param_count(T.init_params(cfg, 0, "meta")),
            "projected_leaves": len(leaves),
            "leaf_shapes": sorted({str(list(v)) for v in leaves.values()}),
            "steps": ENCDEC_TRAIN_STEPS, "batch": batch, "seq_len": seq,
            "losses": losses,
            "first_step_ms": hist[0]["s_per_step"] * 1e3,
            "ms_per_step_after_first": ms,
            "tokens_per_s": batch * seq / (ms / 1e3),
            "max_memory_allocated_bytes": peak, "wall_s": wall,
            "launches_per_step": {k: v / ENCDEC_TRAIN_STEPS
                                  for k, v in counts.items()},
            "device": _device_line()}
        print(json.dumps(summary), flush=True)
        out[arch] = summary["launches_per_step"]
    return out


def run_encdec_family(torch, dev) -> dict:
    """Phase 21: (a) the kernels at the modality families' shapes, (b)
    serving, (c) training. Returns the kernels line's additions."""
    walls = [time.perf_counter()]
    cases = check_encdec_kernels(torch, dev)
    walls.append(time.perf_counter())
    serving = run_encdec_serving(torch, dev)
    walls.append(time.perf_counter())
    training = run_encdec_training(torch, dev)
    walls.append(time.perf_counter())
    print(json.dumps({"encdec_phase_wall_s": walls[-1] - walls[0],
                      "parts_wall_s": dict(zip("abc", (
                          b - a for a, b in zip(walls, walls[1:])))),
                      "device": _device_line()}), flush=True)
    return {"cases": cases, "serving": serving, "training": training}


# ---------------------------------------------------------------------------
# phase 22: ZeRO-1 at world 2 on the one card
# ---------------------------------------------------------------------------
def _zero_select_spy(calls: list):
    """Record every ``select_top_r`` of the fused step (the selections of
    both the sharded and the replicated updates); returns the restorer."""
    from repro_torch.core import fused_step

    orig = fused_step.select_top_r

    def spy(norms, r, sort=True):
        calls.append(orig(norms, r, sort))
        return calls[-1]

    fused_step.select_top_r = spy
    return lambda: setattr(fused_step, "select_top_r", orig)


def _zero_api(torch, mesh) -> dict:
    """Part (a) on one rank: each of ``ZERO_API_RUNS`` sharded over the mesh
    and (rank 0) replicated on the same gradients, the gathered updates,
    selections and state held to the replicated ones; the fp32 run's state
    saved whole and restored at 2 ranks and at 1."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import get_optimizer
    from repro_torch.optim.common import default_label_fn, oriented_dims
    from repro_torch.parallel import sharding
    from repro_torch.parallel.zero import ZeroConfig, gather_updates
    from repro_torch.train.checkpoint import CheckpointManager, tree_items

    dev = torch.device("cuda")
    rank = mesh.rank
    meta = T.init_params(get_config("llama-350m"), 0, "meta")
    shapes = {k: tuple(p.shape) for k, p in meta.items()
              if default_label_fn(k, p) == "lowrank"}
    params = {k: torch.zeros(s, device=dev) for k, s in shapes.items()}
    zero = ZeroConfig("1")
    calls: list = []
    restore = _zero_select_spy(calls)
    out = {"g_block_shapes": sorted({str([*s[:-2], oriented_dims(s)[0]
                                           // ZERO_WORLD, oriented_dims(s)[1]])
                                     for s in shapes.values()})}
    try:
        for label, name, kw, steps in ZERO_API_RUNS:
            zopt = get_optimizer(name, lr=0.01, zero=zero, **kw)
            ropt = get_optimizer(name, lr=0.01, **kw)
            with sharding.set_mesh(mesh):
                zs = zopt.init(params)
            rs = ropt.init(params) if rank == 0 else None
            rec = {"updates": steps, "max_abs_diff": [], "max_abs_update": [],
                   "updates_bit_equal": [], "selections": [],
                   "selections_differing": [], "launches": {}}
            for t in range(steps):
                gen = torch.Generator(device=dev).manual_seed(7000 + t)
                g = {k: torch.randn(s, generator=gen, device=dev)
                     for k, s in shapes.items()}
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                calls.clear()
                with sharding.set_mesh(mesh):
                    u, zs = zopt.update(g, zs, params)
                torch.cuda.synchronize()
                for k, n in ops.launch_counts().items():
                    if n:
                        rec["launches"][k] = rec["launches"].get(k, 0) + n
                zsel = list(calls)
                with sharding.set_mesh(mesh):
                    uz = gather_updates(u)
                del u
                if rank == 0:
                    calls.clear()
                    ur, rs = ropt.update(g, rs, params)
                    rsel = list(calls)
                    assert len(zsel) == len(rsel), (len(zsel), len(rsel))
                    rec["selections"].append(sum(int(a[..., 0].numel())
                                                 for a in rsel))
                    rec["selections_differing"].append(sum(
                        int((a != b).any(dim=-1).sum())
                        for a, b in zip(zsel, rsel)))
                    rec["max_abs_diff"].append(max(
                        float((uz[k] - ur[k]).abs().max()) for k in shapes))
                    rec["max_abs_update"].append(max(
                        float(ur[k].abs().max()) for k in shapes))
                    rec["updates_bit_equal"].append(all(
                        _same_bits(uz[k], ur[k]) for k in shapes))
                    del ur
                del uz, g
            with sharding.set_mesh(mesh):
                specs = sharding.optimizer_state_specs(zopt, params,
                                                       zero=zero)
                held, whole = sharding.state_bytes(zs, specs, mesh)
                zfull = sharding.gather_tree(zs, specs, mesh)
            rec["opt_state_bytes"], rec["opt_state_whole_bytes"] = held, whole
            if rank == 0:
                rec["replicated_opt_state_bytes"] = sum(
                    t.numel() * t.element_size() for _, t in tree_items(rs)
                    if isinstance(t, torch.Tensor))
                pairs = list(zip(tree_items(zfull), tree_items(rs)))
                rec["state_bit_equal"] = all(
                    pa == pb and (_same_bits(a, b) if isinstance(
                        a, torch.Tensor) else a == b)
                    for (pa, a), (pb, b) in pairs)
                rec["state_max_abs_diff"] = max(
                    float((a.float() - b.float()).abs().max())
                    for (_, a), (_, b) in pairs
                    if isinstance(a, torch.Tensor) and a.numel())
            if label == "fp32":
                # saved whole from the blocks, restored at 2 ranks (each
                # its blocks) and at 1 (the whole state)
                ck = ZERO_DIR / "api_ckpt"
                if rank == 0:
                    shutil.rmtree(ck, ignore_errors=True)
                    CheckpointManager(str(ck)).save(steps, zfull)
                dist.barrier()
                mgr = CheckpointManager(str(ck))
                with sharding.set_mesh(mesh):
                    target = zopt.init(params)
                    back = mgr.restore(steps, target, specs)
                rec["restored_blocks_bit_equal"] = all(
                    _same_bits(a, b) if isinstance(a, torch.Tensor)
                    else a == b for (_, a), (_, b) in zip(tree_items(back),
                                                          tree_items(zs)))
                if rank == 0:
                    whole_back = mgr.restore(steps, ropt.init(params))
                    rec["restored_whole_bit_equal"] = all(
                        _same_bits(a, b) if isinstance(a, torch.Tensor)
                        else a == b for (_, a), (_, b) in zip(
                            tree_items(whole_back), tree_items(zfull)))
                dist.barrier()
                if rank == 0:
                    shutil.rmtree(ck, ignore_errors=True)
            del zs, rs, zfull
            gc.collect()
            torch.cuda.empty_cache()
            out[label] = rec
    finally:
        restore()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _zero_restore(torch, mesh) -> dict:
    """Part (c) on one rank: the CLI run's step-2 checkpoint restored at 2
    ranks; the CRC32 of this rank's block of each split array."""
    import zlib

    from repro_torch.configs.registry import get_config
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.parallel.zero import ZeroConfig
    from repro_torch.train.checkpoint import CheckpointManager, tree_items
    from repro_torch.train.steps import init_state

    zero = ZeroConfig("1")
    cfg = get_config("llama-350m")
    opt = get_optimizer("dct_adamw", lr=0.01, rank=RANK, zero=zero)
    specs = sharding.train_state_specs(init_state(cfg, opt, 0, "meta"),
                                       zero=zero, mesh=mesh)
    with sharding.set_mesh(mesh):
        target = init_state(cfg, opt, 0, "cuda")
        st = CheckpointManager(str(ZERO_DIR / "ckpt")).restore(
            ZERO_CKPT_STEP, target, specs)
    placed = sharding.placements_by_path(specs)
    crcs, dims = {}, {}
    for path, leaf in tree_items(st):
        if placed[path].split:
            arr = leaf.detach().cpu().contiguous().numpy()
            crcs["||".join(path)] = zlib.crc32(arr) & 0xFFFFFFFF
            # the ("data",) mesh: one split dim, block = this rank's index
            dims["||".join(path)] = [d for d, e in enumerate(
                placed[path].entries) if e is not None]
    return {"block_crc32": crcs, "block_dims": dims}


@contextlib.contextmanager
def _held_spy(helds: list):
    """Keep the ``parallel.fsdp.Held`` of each train step's forward and
    backward (its ``log``: each site's route, every gather)."""
    from repro_torch.parallel import fsdp

    orig = fsdp.grad_fn

    def spy(*a, **kw):
        g, m, held = orig(*a, **kw)
        helds.append(held)
        return g, m, held

    fsdp.grad_fn = spy
    try:
        yield helds
    finally:
        fsdp.grad_fn = orig


def clip_scale_ulps(norm: float, whole: float) -> int:
    """The distance in fp32 ulps of the clip factors (max norm 1) of two
    norms."""
    import numpy as np

    a, b = (np.float32(min(1.0, np.float32(1.0) / np.float32(max(v, 1e-9))))
            for v in (norm, whole))
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def _site_routes(held) -> dict:
    """A Held's log as printed: each route's groups (forward), the bytes
    gathered over ``model`` and over the data axes only, and the Megatron
    leaves gathered over ``model`` (none is)."""
    routes, meg = {}, set()
    for e in held.log:
        if "route" in e and e["phase"] == "forward":
            routes.setdefault(e["route"], set()).add(e["group"])
            if e["route"] == "megatron":
                meg.update(e["paths"])
    model = [e for e in held.log if "route" not in e
             and "model" in e["axes"]]
    return {"groups_by_route": {k: sorted(v) for k, v in routes.items()},
            "megatron_groups": sum(1 for e in held.log
                                   if e.get("route") == "megatron"
                                   and e["phase"] == "forward"),
            "bytes_over_model": sum(e["bytes"] for e in model),
            "bytes_over_data_only": sum(e["bytes"] for e in held.log
                                        if "route" not in e and e["axes"]
                                        and "model" not in e["axes"]),
            "megatron_leaves_over_model": sorted(
                p for e in model for p in e["paths"] if p in meg),
            "peak_live_bytes": held.peak_live_bytes}


def _mesh_forward(torch, cfg, params: dict, batch: dict, mesh):
    """A no-grad forward of ``cfg`` on ``mesh`` with every use site handed
    as the train step hands it (``fsdp.Held.use``: the Megatron groups as
    this rank's blocks) on this rank's rows; its launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.parallel import fsdp, sharding

    whole = T.init_params(cfg, 0, "meta")
    specs = sharding.params_specs(whole, mesh)
    blocks = sharding.shard_tree(params, specs, mesh)
    held = fsdp.Held(blocks, specs, whole, mesh, (), torch.float32,
                     lambda path, t: T.cast_dtype(path, t, cfg))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with sharding.set_mesh(mesh), torch.no_grad():
        logits, _ = T.forward(blocks, {"tokens": batch["tokens"]}, cfg,
                              use=held.use)
    torch.cuda.synchronize()
    return logits, {k: n for k, n in ops.launch_counts().items() if n}


def _placed_step(torch) -> dict:
    """(a)'s ranks on a (data 1, model 2) mesh: one llama-350m DCT-AdamW
    step (phase 3's configuration, its first batch) with the state held
    as ``fsdp_tp`` blocks and the attention heads and MLP hidden units on
    each rank's ``model`` block (Megatron), then the same step with every
    site on the gather route (``megatron_sites`` patched to declare
    nothing: the parent's sites), then the one-process step cut to this
    rank's blocks; each site's route, the bytes gathered over ``model``
    and the bytes alive of both routes, the held bytes and launches; and
    a no-grad forward through the Megatron
    sites (the prefill kernel on the rank's 8 of 16 heads) against the
    one-process forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import init_state, make_train_step

    mesh = make_mesh(PLACED_MESH, ("data", "model"))
    cfg = get_config("llama-350m")
    opt = get_optimizer("dct_adamw", lr=0.01, rank=RANK)
    step = make_train_step(cfg, opt)
    batch = make_batch_fn(cfg, SEQ, BATCH, seed=0, device="cuda")(0)
    abstract = init_state(cfg, opt, 0, "meta")
    specs = sharding.train_state_specs(abstract, mesh=mesh)
    with sharding.use_policy(layout="decode_tp"):
        dspecs = sharding.params_specs(abstract.params, mesh)
    decode_held = sum(
        math.prod(sharding.block_shape(p.shape, dspecs[k], mesh))
        * p.element_size() for k, p in abstract.params.items())
    out = {}
    for route in ("megatron", "gather"):
        saved = T.megatron_sites
        if route == "gather":
            T.megatron_sites = lambda kind, cfg: {}
        helds = []
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with sharding.set_mesh(mesh):
                state = init_state(cfg, opt, 0, "cuda")
                out.update(param_bytes=sharding.state_bytes(
                    state.params, specs.params, mesh),
                    decode_tp_param_bytes=[decode_held, sharding.state_bytes(
                        state.params, specs.params, mesh)[1]])
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                mesh.reset_counts()
                with _held_spy(helds):
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    loss = float(m["loss"])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                rec = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                       "step_s": wall,
                       "collectives": {k: list(v)
                                       for k, v in mesh.counts.items()},
                       "launches": {k: n for k, n in
                                    ops.launch_counts().items() if n},
                       "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                       **_site_routes(helds[0])}
                if route == "megatron":
                    out["opt_state_bytes"] = sharding.state_bytes(
                        state.opt_state, specs.opt_state, mesh)
                    mine = state
        finally:
            T.megatron_sites = saved
        out[route] = rec
        del state
        gc.collect()
        torch.cuda.empty_cache()
    p0 = T.init_params(cfg, 0, "cuda")
    rstate, rm = step(init_state(cfg, opt, 0, "cuda"), batch)
    out["replicated_loss"] = float(rm["loss"])
    out["replicated_grad_norm"] = float(rm["grad_norm"])
    out["replicated_max_update"] = max(
        float((rstate.params[k].float() - p0[k].float()).abs().max())
        for k in p0)
    with sharding.set_mesh(mesh):
        cut = sharding.shard_tree(rstate.params, specs.params, mesh)
    del rstate
    out["params_max_abs_diff"] = max(
        float((mine.params[k].float() - cut[k].float()).abs().max())
        for k in cut)
    del mine, cut
    gc.collect()
    torch.cuda.empty_cache()
    # the Megatron sites without grad: bf16 compute, the blockwise
    # prefill kernel on this rank's heads
    logits, launches = _mesh_forward(torch, cfg, p0, batch, mesh)
    with torch.no_grad():
        want, _ = T.forward(p0, {"tokens": batch["tokens"]}, cfg)
    last, wlast = logits[:, -1].float(), want[:, -1].float()
    out["forward"] = {"launches": launches,
                      "last_logits_rel": float(torch.linalg.norm(
                          last - wlast) / torch.linalg.norm(wlast))}
    del p0, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_block_spy(calls: list):
    """Record the experts each ``_local_moe`` call holds (E / tp) and their
    hidden width; returns the restorer."""
    from repro_torch.models import moe

    orig = moe._local_moe

    def spy(x, router_w, wg, wu, wd, **kw):
        calls.append([int(wg.shape[0]), int(wg.shape[-1])])
        return orig(x, router_w, wg, wu, wd, **kw)

    moe._local_moe = spy
    return lambda: setattr(moe, "_local_moe", orig)


def _witness_step(torch, cfg, batch: dict) -> dict:
    """The one-process DCT-AdamW step of ``cfg`` on the global batch (each
    rank computes it, the two at once on the card): its parameters after
    the step, loss, gradient norm, largest update and launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train.steps import init_state, make_train_step

    opt = get_optimizer("dct_adamw", lr=0.01, rank=RANK)
    p0 = T.init_params(cfg, 0, "cuda")
    ops.reset_launch_counts()
    state, m = make_train_step(cfg, opt)(init_state(cfg, opt, 0, "cuda"),
                                         batch)
    torch.cuda.synchronize()
    out = {"params": state.params, "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]),
           "launches": {k: n for k, n in ops.launch_counts().items() if n},
           "max_update": max(float((state.params[k].float()
                                    - p0[k].float()).abs().max())
                             for k in p0)}
    del state, p0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_step(torch, cfg, mesh, layout: str, batch: dict,
               witness: dict) -> dict:
    """One DCT-AdamW step of ``cfg`` on ``mesh`` under ``layout`` (the state
    placed there): loss, gradient norm, this rank's parameter blocks
    against the one-process ``witness``'s cut to them, its launches,
    experts a ``_local_moe`` call, wall time and peak."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import init_state, make_train_step

    opt = get_optimizer("dct_adamw", lr=0.01, rank=RANK)
    step = make_train_step(cfg, opt)
    calls: list = []
    with sharding.use_policy(layout=layout), sharding.set_mesh(mesh):
        specs = sharding.params_specs(T.init_params(cfg, 0, "meta"), mesh)
        state = init_state(cfg, opt, 0, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        mesh.reset_counts()
        restore = _moe_block_spy(calls)
        try:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        collectives = {k: list(v) for k, v in mesh.counts.items()}
        launches = {k: n for k, n in ops.launch_counts().items() if n}
        want = {k: sharding.local_block(w, specs[k], mesh)
                for k, w in witness["params"].items()}
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "launches": launches, "experts_a_call": calls, "step_s": wall,
           "collectives": collectives,
           "routes": {"reduce_scatter": mesh.reduce_scatter},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "params_max_abs_diff": max(
               float((state.params[k].float() - want[k].float()).abs().max())
               for k in want),
           "params_bit_equal": all(_same_bits(state.params[k], want[k])
                                   for k in want),
           **{f"witness_{k}": witness[k] for k in (
               "loss", "grad_norm", "launches", "max_update")}}
    del state, want
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _mesh_decode(torch, cfg, mesh) -> dict:
    """``decode_step`` (position 0, MESH_DECODE_BATCH tokens) of ``cfg``
    under decode_tp on ``mesh``, and on rank 0 on one process: the logits'
    gap and the experts a call holds."""
    import torch.distributed as dist

    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding

    params = T.init_params(cfg, 3, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (MESH_DECODE_BATCH,),
                        generator=gen, device="cuda")
    calls: list = []
    restore = _moe_block_spy(calls)
    try:
        with sharding.use_policy(layout="decode_tp"), \
                sharding.set_mesh(mesh), torch.no_grad():
            logits, _ = T.decode_step(params, T.init_cache(
                cfg, MESH_DECODE_BATCH, 16, "cuda"), tok, 0, cfg)
    finally:
        restore()
    out = {"experts_a_call": calls}
    if mesh.rank == 0:
        with torch.no_grad():
            want, _ = T.decode_step(params, T.init_cache(
                cfg, MESH_DECODE_BATCH, 16, "cuda"), tok, 0, cfg)
        d = (logits.float() - want.float()).abs()
        out.update(max_abs_diff=float(d.max()),
                   max_abs_logit=float(want.abs().max()),
                   within_bar=bool((d <= 2e-5 + 1e-4 * want.float().abs())
                                   .all()),
                   bit_equal=_same_bits(logits, want))
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _mesh_prefill(torch, mesh) -> dict:
    """(f): qwen2.5-32b's no-grad prefill on ``mesh`` with its attn_sp, each
    blockwise launch's rows and q_offset recorded (a spy around the
    wrapper), and on rank 0 the one-process prefill's logits."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding

    cfg = _config("qwen2.5-32b", MESH_SP_DEPTH)
    assert cfg.attn_sp
    b, s, _ = SP_PREFILL
    params = T.init_params(cfg, 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    calls: list = []
    orig = L.flash_attention_blockwise

    def spy(q, k, v, **kw):
        calls.append([int(q.shape[1]), int(k.shape[1]), kw["q_offset"]])
        return orig(q, k, v, **kw)

    L.flash_attention_blockwise = spy
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with sharding.set_mesh(mesh), torch.inference_mode():
            logits, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        L.flash_attention_blockwise = orig
    out = {"launches": {k: n for k, n in ops.launch_counts().items() if n},
           "blockwise_calls": calls, "prefill_s": wall}
    if mesh.rank == 0:
        with torch.inference_mode():
            want, _ = T.forward(params, {"tokens": toks}, cfg)
        last, wlast = logits[:, -1].float(), want[:, -1].float()
        out.update(bit_equal=_same_bits(logits, want),
                   last_logits_rel=float(torch.linalg.norm(last - wlast)
                                         / torch.linalg.norm(wlast)),
                   max_abs_diff=float((logits.float() - want.float())
                                      .abs().max()))
        del want
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _mesh_models(torch, data_mesh) -> dict:
    """Parts (d)-(g) on (a)'s ranks (module constants)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_mesh

    out, walls = {}, {}
    tp_mesh = make_mesh((1, 2), ("data", "model"))
    dp_mesh = make_mesh((2, 1), ("data", "model"))
    t0 = time.perf_counter()
    cfg = _moe_config("deepseek-moe-16b", MESH_MOE_LAYERS)
    rows, seq = MESH_MOE_BATCH
    batch = make_batch_fn(cfg, seq, rows, seed=0, device="cuda")(0)
    witness = _witness_step(torch, cfg, batch)
    out["ep_step"] = _mesh_step(torch, cfg, tp_mesh, "fsdp_tp", batch,
                                witness)
    out["data_step"] = _mesh_step(torch, cfg, data_mesh, "fsdp_tp", batch,
                                  witness)
    # pure_dp with a model axis: the batch over both axes, each rank's
    # rows gathered over model for the MoE (its data shard's tokens)
    out["pure_step"] = _mesh_step(torch, cfg, tp_mesh, "pure_dp", batch,
                                  witness)
    del witness
    walls["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dcfg = dataclasses.replace(cfg, compute_dtype="float32")
    out["decode"] = {"1x2": _mesh_decode(torch, dcfg, tp_mesh),
                     "2x1": _mesh_decode(torch, dcfg, dp_mesh)}
    walls["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sp_prefill"] = _mesh_prefill(torch, tp_mesh)
    walls["f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lcfg = dataclasses.replace(get_config("llama-350m"), attn_sp=True)
    lbatch = make_batch_fn(lcfg, SEQ, BATCH, seed=0, device="cuda")(0)
    out["sp_step"] = _mesh_step(torch, lcfg, tp_mesh, "fsdp_tp", lbatch,
                                _witness_step(torch, lcfg, lbatch))
    walls["g"] = time.perf_counter() - t0
    out["walls"] = walls
    return out


def zero_rank(rank: int, task: str, restore: bool = False) -> None:
    """One spawned rank of phase 22: ``gloo`` from a file store under
    ``ZERO_DIR``, CUDA tensors on card 0 (the library the parent built is
    loaded, not rebuilt); part (a), then with ``restore`` (c)'s restore of
    (b)'s checkpoint, then (the phase's own spawn) the placed step on a
    (data 1, model 2) mesh; writes its result to ``<task>.rank<r>.json``,
    or its traceback to ``<task>.rank<r>.err``."""
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{ZERO_DIR / (task + '.pg')}",
            rank=rank, world_size=ZERO_WORLD)
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((ZERO_WORLD,), ("data",))
        out = {"rank": rank, "backend": mesh.backend,
               **_zero_api(torch, mesh)}
        if restore:
            out.update(_zero_restore(torch, mesh))
        if task == "api":
            out["placed"] = _placed_step(torch)
            out["mesh_models"] = _mesh_models(torch, mesh)
        (ZERO_DIR / f"{task}.rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()
    except BaseException:
        (ZERO_DIR / f"{task}.rank{rank}.err").write_text(
            traceback.format_exc())
        raise


def spawn_zero_ranks(task: str, restore: bool = False, target=None,
                     timeout: float = 600.0) -> list[dict]:
    """Run ``target`` (``zero_rank``, or a probe's function of the same
    arguments) on ``ZERO_WORLD`` spawned processes (CUDA is initialised
    here already: ``spawn``, not ``fork``); their results by rank. A rank
    that fails fails the phase with its traceback."""
    import multiprocessing

    ZERO_DIR.mkdir(parents=True, exist_ok=True)
    for f in ZERO_DIR.glob(f"{task}.*"):
        f.unlink()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or zero_rank, args=(r, task, restore))
             for r in range(ZERO_WORLD)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = "".join(f.read_text() for f in sorted(ZERO_DIR.glob(
        f"{task}.rank*.err")))
    assert not errs and all(p.exitcode == 0 for p in procs), \
        f"phase 22 {task}: exit codes {[p.exitcode for p in procs]}\n{errs}"
    return [json.loads((ZERO_DIR / f"{task}.rank{r}.json").read_text())
            for r in range(ZERO_WORLD)]


def run_zero_api(torch, check: bool = True, restore: bool = False,
                 target=None) -> tuple[dict, list]:
    """Phase 22 (a), and with ``restore`` the ranks' half of (c). Returns
    the ranks' launches of each run and the ranks' results. ``check=
    False`` with a probe's ``target`` (its A/B) prints without
    asserting."""
    task = "api" if target is None else f"api_{target.__name__}"
    t0 = time.perf_counter()
    ranks = spawn_zero_ranks(task, restore, target)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for label, name, kw, steps in ZERO_API_RUNS if check else ():
        rec = r0[label]
        assert not any(rec["selections_differing"]), (label, rec)
        assert all(rec["updates_bit_equal"]) and rec["state_bit_equal"], \
            (label, rec)
        for r in ranks:
            assert r[label]["launches"] == ZERO_API_LAUNCHES[label], \
                (label, r[label]["launches"], ZERO_API_LAUNCHES[label])
            assert r[label]["opt_state_bytes"] < \
                r[label]["opt_state_whole_bytes"], (label, r)
        if label == "fp32":
            assert rec["restored_whole_bit_equal"], rec
            assert all(r[label]["restored_blocks_bit_equal"] for r in ranks)
    placed = [r["placed"] for r in ranks if "placed" in r]
    if placed:
        print(json.dumps({
            "placed_fsdp_tp": f"llama-350m DCT-AdamW, one step at {BATCH} "
                              f"x {SEQ} on a (data, model) = {PLACED_MESH} "
                              "mesh, the state held as fsdp_tp blocks: the "
                              "attention heads and MLP hidden units on each "
                              "rank's model block (megatron), and every "
                              "site gathered whole (gather: the parent's "
                              "step), against the replicated step cut to "
                              "each rank's blocks",
            **{route: {k: [p[route][k] for p in placed] for k in (
                "loss", "grad_norm", "step_s", "groups_by_route",
                "megatron_groups", "bytes_over_model",
                "bytes_over_data_only", "megatron_leaves_over_model",
                "peak_live_bytes", "peak_memory_bytes", "collectives",
                "launches")} for route in ("megatron", "gather")},
            "replicated_loss": [p["replicated_loss"] for p in placed],
            "replicated_grad_norm": [p["replicated_grad_norm"]
                                     for p in placed],
            "rank_params_max_abs_diff": [p["params_max_abs_diff"]
                                         for p in placed],
            "replicated_max_update": [p["replicated_max_update"]
                                      for p in placed],
            "rank_forward": [p["forward"] for p in placed],
            "rank_param_bytes": [p["param_bytes"] for p in placed],
            "rank_opt_state_bytes": [p["opt_state_bytes"] for p in placed],
            "rank_decode_tp_param_bytes": [p["decode_tp_param_bytes"]
                                           for p in placed],
            "bars": f"loss rtol {MESH_STEP_LOSS_RTOL}, grad norm rtol "
                    f"1e-3, parameters within {MESH_STEP_UPDATE_BAR} x the "
                    f"replicated step's largest update, the forward's last "
                    f"logits within {PREFILL_LOGITS_RTOL}",
            "device": _device_line()}), flush=True)
    for pr in placed if check else ():
        meg = pr["megatron"]
        assert abs(meg["loss"] - pr["replicated_loss"]) <= \
            MESH_STEP_LOSS_RTOL * abs(pr["replicated_loss"]), pr
        assert abs(meg["grad_norm"] - pr["replicated_grad_norm"]) <= \
            1e-3 * pr["replicated_grad_norm"], pr
        assert pr["params_max_abs_diff"] <= \
            MESH_STEP_UPDATE_BAR * pr["replicated_max_update"], pr
        # every layer's attention and MLP on Megatron's route, none of
        # their weights gathered over model
        assert meg["groups_by_route"] == {"megatron": ["attn/", "mlp/"]}, \
            meg["groups_by_route"]
        assert meg["megatron_groups"] == 2 * LAYERS, meg
        assert not meg["megatron_leaves_over_model"], meg
        assert meg["bytes_over_model"] < pr["gather"]["bytes_over_model"]
        held, whole = pr["param_bytes"]
        assert held < 0.51 * whole, pr
        assert pr["opt_state_bytes"][0] < pr["opt_state_bytes"][1], pr
        for route in ("megatron", "gather"):
            for name in ("dct_project", "colgather_matmul_dual",
                         "quantize_ef", "dequant_add_ef"):
                assert pr[route]["launches"].get(name, 0) == \
                    LAUNCHES_PER_STEP, (route, name, pr[route]["launches"])
        fwd = pr["forward"]
        assert fwd["launches"].get("flash_attention_blockwise") == LAYERS, \
            fwd
        assert fwd["last_logits_rel"] <= PREFILL_LOGITS_RTOL, fwd
    mesh = [r["mesh_models"] for r in ranks if "mesh_models" in r]
    if mesh:
        _check_mesh_models(mesh, check)
    summary = {
        "zero_api": f"llama-350m's projected leaves, world {ZERO_WORLD} over "
                    f"('data',), {r0['backend']} with CUDA tensors on one "
                    f"card, ranks {task}",
        "g_block_shapes": r0["g_block_shapes"],
        "runs": {label: {
            **{k: r0[label][k] for k in (
                "updates", "updates_bit_equal", "max_abs_diff",
                "max_abs_update", "selections", "selections_differing",
                "state_bit_equal", "state_max_abs_diff",
                "replicated_opt_state_bytes")},
            "bar": "bit-equal",
            "rank_opt_state_bytes": [r[label]["opt_state_bytes"]
                                     for r in ranks],
            "rank_launches": [r[label]["launches"] for r in ranks],
            **({k: r0[label][k] for k in ("restored_whole_bit_equal",)}
               if label == "fp32" else {})}
            for label, *_ in ZERO_API_RUNS},
        "rank_peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
        "wall_s": wall, "device": _device_line()}
    print(json.dumps(summary), flush=True)
    return {label: [r[label]["launches"] for r in ranks]
            for label, *_ in ZERO_API_RUNS}, ranks


def _check_mesh_models(mm: list, check: bool = True) -> None:
    """Phase 22 (d)-(g) from the ranks' records: printed, then held to
    their bars (module constants)."""
    r0 = mm[0]
    summary = {"mesh_models": "phase 22 (d)-(g) at world 2 on one card "
                              "(gloo): the models' mesh bodies against one "
                              "process on the global batch",
               "walls_s": r0["walls"], "device": _device_line()}
    for part in ("ep_step", "data_step", "pure_step", "sp_step"):
        w = r0[part]
        summary[part] = {
            **{k: w[k] for k in (
                "loss", "witness_loss", "grad_norm", "witness_grad_norm",
                "witness_max_update", "witness_launches")},
            "rank_params_max_abs_diff": [r[part]["params_max_abs_diff"]
                                         for r in mm],
            "rank_params_bit_equal": [r[part]["params_bit_equal"]
                                      for r in mm],
            "rank_losses": [r[part]["loss"] for r in mm],
            "rank_launches": [r[part]["launches"] for r in mm],
            "rank_experts_a_call": [r[part]["experts_a_call"] for r in mm],
            "rank_step_s": [r[part]["step_s"] for r in mm],
            "rank_peak_memory_bytes": [r[part]["peak_memory_bytes"]
                                       for r in mm],
            "whole_gather_peak_bytes": WHOLE_GATHER_PEAKS.get(part),
            "rank_collectives": [r[part]["collectives"] for r in mm],
            "gloo_routes": w["routes"],
            "collectives_are": "[calls, bytes] of each kind in the step",
            "bars": f"loss rtol {MESH_STEP_LOSS_RTOL}, grad norm rtol "
                    f"1e-3, parameters "
                    f"within {MESH_STEP_UPDATE_BAR} x the witness's largest "
                    f"update"}
    summary["decode_tp"] = {
        k: {**{f: r0["decode"][k][f] for f in (
            "max_abs_diff", "max_abs_logit", "within_bar", "bit_equal")},
            "rank_experts_a_call": [r["decode"][k]["experts_a_call"]
                                    for r in mm],
            "bar": "atol 2e-5, rtol 1e-4 (tests/test_multidevice.py)"}
        for k in r0["decode"]}
    sp = r0["sp_prefill"]
    summary["sp_prefill"] = {
        **{f: sp[f] for f in ("bit_equal", "last_logits_rel",
                              "max_abs_diff")},
        "rank_blockwise_calls": [r["sp_prefill"]["blockwise_calls"]
                                 for r in mm],
        "rank_launches": [r["sp_prefill"]["launches"] for r in mm],
        "rank_prefill_s": [r["sp_prefill"]["prefill_s"] for r in mm],
        "calls_are": "[query rows, keys, q_offset] per launch",
        "bar": f"last logits' relative norm <= {PREFILL_LOGITS_RTOL}"}
    print(json.dumps(summary), flush=True)
    if not check:
        return
    training = ("dct_project", "colgather_matmul_dual", "quantize_ef",
                "dequant_add_ef")
    for part in ("ep_step", "data_step", "pure_step", "sp_step"):
        w = r0[part]
        assert abs(w["loss"] - w["witness_loss"]) <= \
            MESH_STEP_LOSS_RTOL * abs(w["witness_loss"]), (part, w)
        assert abs(w["grad_norm"] - w["witness_grad_norm"]) <= \
            1e-3 * w["witness_grad_norm"], (part, w)
        for r in mm:
            assert r[part]["params_max_abs_diff"] <= \
                MESH_STEP_UPDATE_BAR * w["witness_max_update"], (part, r)
            assert r[part]["loss"] == w["loss"], (part, r[part]["loss"])
            for name in training:
                assert r[part]["launches"].get(name) == \
                    w["witness_launches"].get(name), (part, name, r[part])
    for part in ("ep_step", "data_step"):
        for r in mm:
            assert r[part]["peak_memory_bytes"] < WHOLE_GATHER_PEAKS[part], \
                (part, r[part]["peak_memory_bytes"])
    for r in mm:
        assert r["ep_step"]["experts_a_call"] and all(
            e == [32, 1408] for e in r["ep_step"]["experts_a_call"]), r
        assert r["data_step"]["experts_a_call"] and all(
            e == [64, 1408] for e in r["data_step"]["experts_a_call"]), r
        assert r["pure_step"]["experts_a_call"] and all(
            e == [32, 1408] for e in r["pure_step"]["experts_a_call"]), r
        assert all(e == [32, 1408]
                   for e in r["decode"]["1x2"]["experts_a_call"]), r
        assert all(e == [64, 704]
                   for e in r["decode"]["2x1"]["experts_a_call"]), r
    for k in r0["decode"]:
        assert r0["decode"][k]["within_bar"], (k, r0["decode"][k])
    b, s, tp = SP_PREFILL
    for rank, r in enumerate(mm):
        want = [[s // tp, s, rank * s // tp]] * MESH_SP_DEPTH
        assert r["sp_prefill"]["blockwise_calls"] == want, (rank, r)
        assert r["sp_prefill"]["launches"].get(
            "flash_attention_blockwise") == MESH_SP_DEPTH, r["sp_prefill"]
    assert sp["last_logits_rel"] <= PREFILL_LOGITS_RTOL, sp


@contextlib.contextmanager
def _zero_microbatched():
    """llama-350m in microbatches of one rank's rows (``ZERO_MICROBATCH``)
    while the training CLI builds and runs in this process."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config("llama-350m")
    with _registry_depth("llama-350m", None, dataclasses.replace(
            cfg, train_microbatch=ZERO_MICROBATCH)):
        yield


def run_zero_cli(torch, main_losses) -> dict:
    """Phase 22 (b): the training CLI under torchrun at 2 ranks with
    ``--zero 1 --dist-backend gloo``, a checkpoint every 2 steps, and its
    world-1 witness in microbatches. Returns the ranks' lines."""
    shutil.rmtree(ZERO_DIR / "ckpt", ignore_errors=True)
    shutil.rmtree(ZERO_DIR / "obs", ignore_errors=True)
    argv = [*ZERO_CLI_ARGV, "--zero", "1", "--dist-backend", "gloo",
            "--ckpt-dir", str(ZERO_DIR / "ckpt"), "--ckpt-every",
            str(ZERO_CKPT_STEP), "--obs-dir", str(ZERO_DIR / "obs")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ZERO_WORLD), "-m",
         "repro_torch.launch.train", *argv], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    assert run.returncode == 0, (run.stdout[-3000:], run.stderr[-6000:])
    ranks = sorted((json.loads(line.split("[train] rank ", 1)[1])
                    for line in run.stdout.splitlines()
                    if line.startswith("[train] rank ")),
                   key=lambda r: r["rank"])
    assert [r["rank"] for r in ranks] == list(range(ZERO_WORLD)), \
        run.stdout[-3000:]
    losses = ranks[0]["losses"]
    diffs = [abs(a - b) for a, b in zip(losses, main_losses)]
    with _zero_microbatched():
        whist, _, _ = _cli_run(torch, ZERO_CLI_ARGV)
    witness = [h["loss"] for h in whist]
    wdiffs = [abs(a - b) for a, b in zip(losses, witness)]
    clip_ulps = [clip_scale_ulps(a, h["grad_norm"])
                 for a, h in zip(ranks[0]["grad_norms"], whist)]
    gc.collect()
    torch.cuda.empty_cache()
    obs = [_prom_means(ZERO_DIR / "obs" / "metrics.prom"),
           _prom_means(ZERO_DIR / "obs" / "rank1" / "metrics.prom")]
    summary = {
        "zero_cli": f"torchrun --nproc-per-node {ZERO_WORLD} "
                    f"repro_torch.launch.train {' '.join(argv)}",
        "losses": losses, "phase3_losses": main_losses[:ZERO_CLI_STEPS],
        "abs_diff_vs_phase3": diffs, "bars": list(ZERO_LOSS_BARS),
        "world1_microbatched_losses": witness,
        "abs_diff_vs_world1_microbatched": wdiffs,
        "witness_bars": list(ZERO_WITNESS_LOSS_BARS),
        "grad_norms": ranks[0]["grad_norms"],
        "world1_grad_norms": [h["grad_norm"] for h in whist],
        "clip_scale_ulps_vs_world1": clip_ulps,
        "clip_scale_ulps_bar": f"step 1: {CLIP_SCALE_ULPS}",
        "rank_all_gather_bytes": [r["step_collectives"]["all_gather"][1]
                                  for r in ranks],
        "all_gather_bytes_bar": ZERO_CLI_GATHER_BYTES,
        "ms_per_step_after_first": sum(ranks[0]["s_per_step"][1:])
        / (ZERO_CLI_STEPS - 1) * 1e3,
        "first_step_ms": ranks[0]["s_per_step"][0] * 1e3,
        "rank_peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
        "rank_step_peak_memory_bytes": [r["step_peak_memory_bytes"]
                                        for r in ranks],
        "whole_gather_peak_bytes": WHOLE_GATHER_PEAKS["cli"],
        "rank_step_collectives": [r["step_collectives"] for r in ranks],
        "collectives_are": "[calls, bytes] of each kind in the last step",
        "rank_opt_state_bytes": [r["opt_state_bytes"] for r in ranks],
        "opt_state_whole_bytes": ranks[0]["opt_state_whole_bytes"],
        "rank_param_bytes": [r["param_bytes"] for r in ranks],
        "param_whole_bytes": ranks[0]["param_whole_bytes"],
        "rank_launches": [r["launches"] for r in ranks],
        "rank_mean_s": [{k: m.get(f"train_{k}_seconds_mean") for k in (
            "data_wait", "dispatch", "host_sync", "step")} for m in obs],
        "subprocess_wall_s": wall, "device": _device_line()}
    print(json.dumps(summary), flush=True)
    assert len(losses) == ZERO_CLI_STEPS and \
        all(math.isfinite(x) for x in losses), losses
    assert all(r["losses"] == losses for r in ranks), ranks
    # step 1's gradients are the witness's bit for bit: its loss too, and
    # its clip factor within CLIP_SCALE_ULPS of the witness's
    assert all(d <= bar for d, bar in zip(wdiffs, ZERO_WITNESS_LOSS_BARS)), \
        (losses, witness)
    assert clip_ulps[0] <= CLIP_SCALE_ULPS, clip_ulps
    assert all(d <= bar for d, bar in zip(diffs, ZERO_LOSS_BARS)), \
        (diffs, ZERO_LOSS_BARS)
    for r in ranks:
        assert r["step_peak_memory_bytes"] < WHOLE_GATHER_PEAKS["cli"], \
            r["step_peak_memory_bytes"]
        assert r["step_collectives"]["all_gather"][1] < \
            ZERO_CLI_GATHER_BYTES, r["step_collectives"]
        assert r["backend"] == "gloo" and r["world"] == ZERO_WORLD, r
        assert r["opt_state_bytes"] < r["opt_state_whole_bytes"], r
        # fsdp_tp over ("data",): every matrix and embedding halves
        assert r["param_bytes"] < 0.51 * r["param_whole_bytes"], r
        for name in ("dct_project", "colgather_matmul_dual", "quantize_ef",
                     "dequant_add_ef"):
            assert r["launches"].get(name, 0) == \
                LAUNCHES_PER_STEP * ZERO_CLI_STEPS, (name, r["launches"])
    return {"ranks": ranks, "losses": losses}


def run_zero_restore(torch, cli: dict, ranks: list) -> None:
    """Phase 22 (c): (b)'s step-2 checkpoint restored at 2 ranks (each its
    blocks: ``ranks``, (a)'s spawn) and at 1, the whole moments and EF
    equal to the concatenation of the blocks (CRC32 of each block); then a
    world-1 run resumes from it and runs steps 3-6."""
    import zlib

    from repro_torch.configs.registry import get_config
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train.checkpoint import CheckpointManager, tree_items
    from repro_torch.train.steps import init_state

    t0 = time.perf_counter()
    opt = get_optimizer("dct_adamw", lr=0.01, rank=RANK)
    st = CheckpointManager(str(ZERO_DIR / "ckpt")).restore(
        ZERO_CKPT_STEP, init_state(get_config("llama-350m"), opt, 0, "cuda"))
    whole = {"||".join(p): t for p, t in tree_items(st)
             if isinstance(t, torch.Tensor)}
    keys = ranks[0]["block_crc32"]
    assert keys and all(".m" in k or ".v" in k or ".ef" in k
                        or k.startswith(".params") for k in keys)
    assert any(k.startswith(".params") for k in keys), keys
    for key in keys:
        t = whole[key]
        (dim,) = ranks[0]["block_dims"][key]
        block = t.shape[dim] // ZERO_WORLD
        for r, rk in enumerate(ranks):
            part = t.narrow(dim, r * block, block)
            crc = zlib.crc32(part.cpu().contiguous().numpy()) & 0xFFFFFFFF
            assert crc == rk["block_crc32"][key], (key, r)
    del st, whole
    gc.collect()
    torch.cuda.empty_cache()
    for step in range(ZERO_CKPT_STEP + 1, ZERO_CLI_STEPS + 1):
        shutil.rmtree(ZERO_DIR / "ckpt" / f"step_{step}", ignore_errors=True)
    with _zero_microbatched():
        hist, counts, peak = _cli_run(
            torch, [*ZERO_CLI_ARGV, "--ckpt-dir", str(ZERO_DIR / "ckpt"),
                    "--ckpt-every", str(ZERO_CKPT_STEP)],
            steps=ZERO_CLI_STEPS - ZERO_CKPT_STEP)
    losses = [h["loss"] for h in hist]
    resume_diffs = [abs(a - b) for a, b in zip(
        losses, cli["losses"][ZERO_CKPT_STEP:])]
    print(json.dumps({
        "zero_restore": f"step {ZERO_CKPT_STEP} of (b) restored at "
                        f"{ZERO_WORLD} ranks and at 1: the whole "
                        "parameters, moments and EF = the concatenation of "
                        "the blocks (CRC32 of each)",
        "arrays_checked": len(keys),
        "world1_resume_losses": losses,
        "world2_losses": cli["losses"][ZERO_CKPT_STEP:],
        "abs_diff": resume_diffs,
        "bars": list(ZERO_WITNESS_LOSS_BARS[ZERO_CKPT_STEP:]),
        "world1_resume_launches": counts,
        "max_memory_allocated_bytes": peak,
        "wall_s": time.perf_counter() - t0, "device": _device_line()}),
        flush=True)
    assert all(math.isfinite(x) for x in losses), losses
    # the world-1 resume runs the witness's clip (the whole gradients'
    # norm) from the 2 ranks' state: within (b)'s bars of their losses
    assert all(d <= bar for d, bar in zip(
        resume_diffs, ZERO_WITNESS_LOSS_BARS[ZERO_CKPT_STEP:])), \
        (losses, cli["losses"])


def run_zero(torch, main_losses) -> dict:
    """Phase 22: (b) the CLI under torchrun, then one spawn of two ranks
    for (a) the API and the ranks' half of (c), then (c)'s world-1 half.
    Returns the kernels line's additions."""
    walls = [time.perf_counter()]
    cli = run_zero_cli(torch, main_losses)
    walls.append(time.perf_counter())
    api, ranks = run_zero_api(torch, restore=True)
    walls.append(time.perf_counter())
    run_zero_restore(torch, cli, ranks)
    walls.append(time.perf_counter())
    shutil.rmtree(ZERO_DIR, ignore_errors=True)
    print(json.dumps({"zero_phase_wall_s": walls[-1] - walls[0],
                      "parts_wall_s": dict(zip(("b", "a + c ranks", "c"), (
                          b - a for a, b in zip(walls, walls[1:])))),
                      "device": _device_line()}), flush=True)
    return {"api": api, "cli": [r["launches"] for r in cli["ranks"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 14's planted dense-refresh leaf")
    opts = ap.parse_args(argv)
    start = time.perf_counter()
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
    offsets = check_attention_offsets(torch, dev)
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
    gc.collect()
    torch.cuda.empty_cache()
    moe = run_moe_family(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    recurrent = run_recurrent_family(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    encdec = run_encdec_family(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    zero = run_zero(torch, main_losses)
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
        # phase 19: the DeepSeek MoE family's shapes (attention: per call,
        # launches per decode step or prefill; training kernels: per
        # training step of the leaves of each shape) and training launches
        if name in moe["cases"]:
            extra["deepseek"] = moe["cases"][name]
            extra["deepseek_times_are"] = (
                "phase 19: attention kernels per call (flash_decode: graph "
                "replays), launches per decode step or prefill of the depth "
                "served; training kernels per DCT-AdamW step of the leaves "
                "of each shape (launches_per_step of them)")
            for arch, case in moe["cases"][name].items():
                if arch in moe["serving"]:
                    case["launches"] = moe["serving"][arch][
                        "flash_attention_blockwise_per_prefill"
                        if name == "flash_attention_blockwise"
                        else "flash_decode_per_decode_step"]
        if name in moe["training"].get("deepseek-moe-16b", {}):
            extra["deepseek_launches_per_step"] = {
                arch: per_step[name]
                for arch, per_step in moe["training"].items()}
        # phase 20: the recurrent families' shapes (as phase 19's) and
        # training launches per step
        if name in recurrent["cases"]:
            extra["recurrent"] = recurrent["cases"][name]
            extra["recurrent_times_are"] = (
                "phase 20: flash_attention_blockwise per call at jamba's "
                "prefill, launches per prefill of the depth served; "
                "training kernels per DCT-AdamW step of the leaves of each "
                "shape (launches_per_step of them; 1 for a shape held "
                "standalone)")
            for arch, case in recurrent["cases"][name].items():
                if arch in recurrent["serving"]:
                    case["launches"] = recurrent["serving"][arch][
                        "flash_attention_blockwise_per_prefill"]
        if name in recurrent["training"].get("rwkv6-1.6b", {}):
            extra["recurrent_launches_per_step"] = {
                arch: per_step[name]
                for arch, per_step in recurrent["training"].items()}
        # phase 21: the modality families' shapes (attention kernels per
        # call at keys of their own length, launches per prefill of the
        # served depth; training kernels as phase 20's) and training
        # launches per step
        if name in encdec["cases"]:
            extra["encdec"] = encdec["cases"][name]
            extra["encdec_times_are"] = (
                "phase 21: flash_attention (fp32) per call at whisper's "
                "encoder / decoder self- / cross-attention, blockwise per "
                "call at vision's self- / cross-attention; "
                "launches_per_prefill: whisper-large-v3 at full depth, "
                "llama-3.2-vision-90b at depth 10; training kernels per "
                "DCT-AdamW step of the leaves of each shape "
                "(launches_per_step of them; 1 for a shape held standalone)")
            if name in ops.ATTENTION:
                extra["encdec_launches_per_prefill"] = {
                    arch: n for arch, per in encdec["serving"].items()
                    for key, n in per.items() if key == f"{name}_per_prefill"}
        if name in encdec["training"].get("whisper-large-v3", {}):
            extra["encdec_launches_per_step"] = {
                arch: per_step[name]
                for arch, per_step in encdec["training"].items()}
        # phase 22: each rank's launches through the CLI (b) and the API
        # (a) at world 2
        if any(name in r for r in zero["cli"]):
            extra["zero_cli_rank_launches"] = [r.get(name, 0)
                                               for r in zero["cli"]]
        api = {label: [r.get(name, 0) for r in ranks]
               for label, ranks in zero["api"].items()
               if any(name in r for r in ranks)}
        if api:
            extra["zero_api_rank_launches"] = api
        # phase 12's query slices at an offset, and the kernel at phase
        # 22's SP prefill shape
        if name in offsets:
            extra["q_offset"] = offsets[name]
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
    print(json.dumps({"chip_smoke_wall_s": time.perf_counter() - start,
                      "device": device_line}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(device_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
