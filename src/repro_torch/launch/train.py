"""Training driver.

  python -m repro_torch.launch.train --arch llama-350m --optimizer trion \
      --rank 128 --steps 300 --seq-len 512 --batch 64 \
      [--ckpt-dir DIR] [--resilient] [--supervise] [--smoke] [--device cpu]

Runs on the CUDA card by default and raises if there is none; ``--device
cpu`` runs on the CPU (the tests). The JAX CLI's path: config -> data
pipeline -> train step with the chosen optimizer -> checkpoint manager ->
supervisor restarts. ``--optimizer`` is any preset of
the registry: ``trion`` (the default, as in the JAX CLI), ``muon``,
``dion``, the paper's ``dct_adamw`` and its baselines ``ldadamw``,
``galore``, ``frugal``, ``fira`` and the full-rank ``adamw``. ``--rank``
defaults to 128; ``adamw`` takes none, and for Muon no ``--rank`` means
full-space Newton–Schulz and ``--rank r`` the rank-r subspace. ``--fused``
applies to the projected-Adam family and the momentum families: with
``auto`` (the default) they run their CUDA kernels on the card and the
reference path on the CPU (the dense projectors of ldadamw / galore / frugal
/ fira run ``torch.linalg`` either way). For ``dct_adamw``,
``--compute-dtype bf16|int8`` sets the projection precision (it needs a
fused mode: on the CPU, ``--fused on`` or ``fft``); ``--basis
dct|dst|hadamard|randortho`` sets its predefined basis, and the projector of
galore / frugal / fira in place of their SVD.

``--ckpt-dir`` / ``--ckpt-every`` save verified checkpoints and resume from
the newest one. ``--resilient`` arms the guarded step and the escalation
ladder (skip -> rollback -> rollback + LR cut -> halt, exit code 86 with
``halt.json`` in the checkpoint directory), and builds the optimizer with
``lr_scale``; ``--max-skips``, ``--max-rollbacks`` and ``--lr-cut`` tune
it. ``--chaos plan.json`` injects the faults of a plan (the schema of
docs/resilience.md). ``--supervise`` runs this CLI again, without
``--supervise``, as a child of the restart supervisor. ``--obs-dir DIR``
turns on the obs layer and writes ``DIR/metrics.prom`` and
``DIR/trace.json`` at the end (halted runs included); ``--obs-sync-every
N`` also synchronizes the card every N steps.

``--telemetry jsonl|csv`` collects each matrix leaf's subspace stats
(captured energy, top-r margin, index overlap, EF norm, rank utilization)
in the optimizer update and writes a row every ``--telemetry-every`` steps
to ``--telemetry-path`` (default ``telemetry.<fmt>`` in ``--ckpt-dir``,
else in the working directory; appended to when the run resumes).
``--adaptive-rank`` (the projected-Adam family) reallocates the rank budget
across layers by captured energy, ``--adaptive-refresh`` (``dct_adamw``)
stretches or shrinks each leaf's refresh interval by index drift, each
every ``--control-every`` steps: the optimizer is rebuilt with per-leaf
overrides and its state migrated (``telemetry/adaptive.py``).

Data parallelism and ZeRO-1: under ``torchrun`` (``python -m
torch.distributed.run --nproc-per-node N -m repro_torch.launch.train ...``)
the process group comes from the environment it sets and the ranks form a
``("data",)`` mesh. The train state is held as blocks under the
reference's default layout, ``fsdp_tp`` (``parallel/sharding.py``): each
rank keeps its FSDP block of every matrix and embedding and of the
optimizer state that follows them. Each step runs the model on this
rank's slice of the global ``--batch``, gathers each layer's weights as
it runs (``parallel/fsdp.py``), reduces each gradient to this rank's
block and updates this rank's blocks. ``--zero 1`` also partitions the
low-rank optimizer state by rows (``parallel/zero.py``: dct_adamw / muon
/ trion / dion, or galore / frugal with ``--basis``). The
adaptive controllers run on one process only. ``--dist-backend`` (the
port's own flag) is ``nccl`` on the card (one card a rank) and ``gloo`` on
the CPU by default; ``gloo`` also lets several ranks share one card. Rank 0
logs, writes the checkpoints (whole arrays: a run resumes at another
width, or on one process) and the telemetry; ``--obs-dir`` gets rank r's
files under ``DIR/rank<r>`` (rank 0's in ``DIR``). At the end each rank
prints one ``[train] rank {...}`` JSON line: its parameter and
optimizer-state bytes (held, and of the whole arrays), peak device memory
(over the run, and the largest of a step's, each from a reset before
its step), the last step's collectives (calls and bytes), losses,
gradient norms, step times and kernel launches.
One process with ``--zero 1`` runs replicated and says so. A ``(data,
model)`` mesh is the API's (``launch.mesh.make_mesh``,
``sharding.set_mesh``).

Flags of the JAX CLI that this port does not support yet exit with
"not yet ported".
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.devices import resolve_device

# the presets built on ProjectedAdamRule
PROJECTED_ADAM_FAMILY = ("dct_adamw", "ldadamw", "galore", "frugal", "fira")
# presets with a fused-step dispatch field: the projected-Adam family plus
# the momentum-orthogonalization rules
FUSED_FAMILY = PROJECTED_ADAM_FAMILY + ("muon", "trion", "dion")
# presets whose rule is always zero_shardable; galore / frugal join when
# --basis swaps their dense svd projector for a registered basis backend
ZERO_ALWAYS = ("dct_adamw", "muon", "trion", "dion")

# flags of ``python -m repro.launch.train`` not ported yet
NOT_YET_PORTED = ("--tune-cache",)


def build(argv=None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    for a in argv:
        if a.split("=", 1)[0] in NOT_YET_PORTED:
            raise SystemExit(f"{a.split('=', 1)[0]} is not yet ported to "
                             f"repro_torch")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-350m",
                    help="one of repro_torch.configs.registry.list_archs(): "
                         "the llamas, gemma3-27b, qwen2.5-32b, "
                         "phi3-mini-3.8b, command-r-plus-104b, "
                         "deepseek-moe-16b, deepseek-v3-671b, "
                         "jamba-1.5-large-398b (--seq-len at most 128 or a "
                         "multiple of 128), rwkv6-1.6b, whisper-large-v3 "
                         "and llama-3.2-vision-90b (their batches carry "
                         "stub frames / image embeddings)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--optimizer", default="trion")
    ap.add_argument("--rank", type=int, default=None,
                    help="subspace rank of the low-rank families (default "
                         "128); for muon the default is full-space "
                         "Newton-Schulz and --rank opts into the subspace")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--fused", default=None,
                    choices=["auto", "on", "fft", "off"],
                    help="fused-step dispatch of the projected-Adam family "
                         "and muon/trion/dion: auto = the CUDA kernels for "
                         "tensors on the card, the reference path on the "
                         "CPU")
    ap.add_argument("--basis", default=None,
                    choices=["dct", "dst", "hadamard", "randortho"],
                    help="predefined orthogonal basis backend of dct_adamw "
                         "(or the projector of galore/frugal/fira)")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["fp32", "bf16", "int8"],
                    help="projection-matmul precision of dct_adamw: int8 = "
                         "quantized operands with exact integer "
                         "accumulation; needs a fused mode")
    ap.add_argument("--zero", default="off", choices=["off", "1"],
                    help="ZeRO-1 partitioning of the low-rank optimizer "
                         "state across the data-parallel ranks (torchrun); "
                         "each rank runs the fused step on its row block "
                         "and the updates are all-gathered (dct_adamw/muon/"
                         "trion/dion, or galore/frugal with --basis)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend under torchrun: nccl (the "
                         "default on the card, one card a rank) or gloo "
                         "(the default on the CPU; ranks may share a card)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--supervise", action="store_true",
                    help="run this CLI as a child of the restart supervisor "
                         "(crash -> resume from the latest checkpoint)")
    # telemetry and adaptive control
    ap.add_argument("--telemetry", default="off",
                    choices=["off", "jsonl", "csv"],
                    help="collect per-leaf SubspaceStats in the optimizer "
                         "update and write step-bucketed rows to "
                         "--telemetry-path")
    ap.add_argument("--telemetry-path", default=None,
                    help="output file (default telemetry.<fmt> in "
                         "--ckpt-dir, else ./telemetry.<fmt>)")
    ap.add_argument("--telemetry-every", type=int, default=10,
                    help="steps aggregated per telemetry row")
    ap.add_argument("--adaptive-rank", action="store_true",
                    help="closed-loop per-layer rank reallocation from "
                         "captured energy (projected-Adam family only)")
    ap.add_argument("--adaptive-refresh", action="store_true",
                    help="closed-loop per-layer refresh-interval control "
                         "from index-overlap drift (dct_adamw)")
    ap.add_argument("--control-every", type=int, default=50,
                    help="steps between controller decisions")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="enable the obs layer (host-side metrics + phase "
                         "spans) and write DIR/metrics.prom + "
                         "DIR/trace.json at the end of the run (halted "
                         "runs included)")
    ap.add_argument("--obs-sync-every", type=int, default=0,
                    help="with --obs-dir: every N steps also synchronize "
                         "the card into train_full_sync_seconds (0 = off)")
    ap.add_argument("--resilient", action="store_true",
                    help="arm the guarded step and the escalation ladder "
                         "(skip -> rollback -> rollback+LR-cut -> halt); "
                         "builds the optimizer with lr_scale")
    ap.add_argument("--max-skips", type=int, default=2,
                    help="consecutive non-finite steps skipped before the "
                         "ladder escalates to a rollback")
    ap.add_argument("--max-rollbacks", type=int, default=3,
                    help="rollbacks before the run halts (exit code 86)")
    ap.add_argument("--lr-cut", type=float, default=0.5,
                    help="LR factor applied on the 2nd+ rollback")
    ap.add_argument("--chaos", default=None, metavar="PLAN.json",
                    help="deterministic fault-injection plan "
                         "(train/chaos.py; schema in docs/resilience.md)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _optimizer_kwargs(args: argparse.Namespace, dev: torch.device) -> dict:
    """The optimizer keywords of the flags, with the JAX CLI's checks (and
    its messages)."""
    from repro_torch.core import fused_step

    kw = {"weight_decay": args.weight_decay}
    if args.resilient:
        # the ladder's LR-cut rung needs the injected lr_scale entry
        kw["lr_scale"] = True
    if args.optimizer == "muon":
        # full-space Newton-Schulz unless --rank asks for the subspace
        if args.rank is not None:
            kw["rank"] = args.rank
    elif args.optimizer != "adamw":
        kw["rank"] = args.rank if args.rank is not None else 128
    if args.fused is not None:
        if args.optimizer not in FUSED_FAMILY:
            raise SystemExit(f"--fused applies to "
                             f"{'/'.join(FUSED_FAMILY)}, "
                             f"not {args.optimizer!r}")
        kw["fused"] = args.fused
    if args.compute_dtype is not None:
        if args.optimizer != "dct_adamw":
            raise SystemExit("--compute-dtype applies to dct_adamw, not "
                             f"{args.optimizer!r}")
        if args.compute_dtype != "fp32" and \
                fused_step.resolve(args.fused or "auto", dev) == "off":
            raise SystemExit(
                f"--compute-dtype {args.compute_dtype} requires a fused "
                "dispatch mode; pass --fused on or --fused fft "
                "(the default --fused auto resolves to the reference "
                "path on this backend)")
        kw["compute_dtype"] = args.compute_dtype
    if args.basis is not None:
        if args.optimizer == "dct_adamw":
            kw["basis"] = args.basis
        elif args.optimizer in ("galore", "frugal", "fira"):
            kw["projector"] = args.basis
        else:
            # ldadamw is defined by its power-iteration projector; the
            # other presets have no predefined-basis plug point
            raise SystemExit("--basis applies to dct_adamw/galore/frugal/"
                             f"fira, not {args.optimizer!r}")
    return kw


def _zero_config(args: argparse.Namespace):
    """The ZeroConfig of ``--zero`` (None when off), with the JAX CLI's
    refusals and messages."""
    if args.zero == "off":
        return None
    zero_ok = (args.optimizer in ZERO_ALWAYS
               or (args.optimizer in ("galore", "frugal")
                   and args.basis is not None))
    if not zero_ok:
        # the other presets keep dense projector state (power / svd) whose
        # refresh is not row-decomposable, or (fira) sum norms over every
        # row in the update: every leaf would silently stay replicated
        raise SystemExit(
            "--zero needs a ZeRO-shardable optimizer: "
            f"{'/'.join(ZERO_ALWAYS)} (always), or galore/frugal with "
            "--basis <dct|dst|hadamard|randortho>; "
            f"{args.optimizer!r} would silently stay replicated")
    if args.adaptive_rank or args.adaptive_refresh:
        # a controller rebuild re-inits and migrates the state; with
        # partitioned state that composition is untested
        raise SystemExit("--zero cannot be combined with "
                         "--adaptive-rank/--adaptive-refresh yet")
    from repro_torch.parallel.zero import ZeroConfig
    return ZeroConfig(mode=args.zero)


def _data_parallel(args: argparse.Namespace, dev: torch.device, world: int):
    """The process group from torchrun's environment and the ``("data",)``
    mesh over it; on the card each rank takes card ``LOCAL_RANK`` modulo
    the cards there are. ``nccl`` needs one card for each of this node's
    ranks (torchrun's ``LOCAL_WORLD_SIZE``)."""
    from repro_torch.launch.mesh import make_mesh

    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise SystemExit("--dist-backend nccl runs on the card; pass "
                             "--dist-backend gloo with --device cpu")
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local > cards:
            raise SystemExit(f"--dist-backend nccl needs one card a rank: "
                             f"{local} ranks on this node, {cards} card(s); "
                             "pass --dist-backend gloo to share cards")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    dist.init_process_group(backend)
    return make_mesh((world,), ("data",))


def run(args: argparse.Namespace, stop_at: int | None = None):
    """Train as ``args`` say; returns the finished ``Trainer`` (its
    ``metrics_history`` holds one record per committed step). A halted run
    raises :class:`~repro_torch.train.resilience.TrainingHalted`.
    ``stop_at``: end after that step, as a preemption would; the LR
    schedule still spans ``--steps``, so a later run resumes on it. Under
    torchrun the process group lives for the run and is destroyed after
    it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.train.schedule import cosine_warmup

    zero_cfg = _zero_config(args)
    adaptive = args.adaptive_rank or args.adaptive_refresh
    if adaptive and args.optimizer not in PROJECTED_ADAM_FAMILY:
        raise SystemExit("--adaptive-rank/--adaptive-refresh apply to the "
                         f"projected-Adam family only, not "
                         f"{args.optimizer!r}")
    if args.adaptive_refresh and args.optimizer != "dct_adamw":
        # drift is measured from index overlap, which only index-based
        # projectors emit (the other presets of the family refresh dense
        # bases: the scheduler would be silently inert)
        raise SystemExit("--adaptive-refresh needs an index-based projector"
                         " (dct); use --optimizer dct_adamw")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    lr = cosine_warmup(args.lr, args.warmup, args.steps)
    opt_kw = _optimizer_kwargs(args, dev)
    telemetry_on = args.telemetry != "off" or adaptive
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and adaptive:
        # the controllers rebuild and migrate a whole state on one process
        raise SystemExit("--adaptive-rank/--adaptive-refresh run on one "
                         "process; the state is placed as blocks under "
                         "torchrun")
    mesh, rank = None, 0
    if world > 1:
        mesh = _data_parallel(args, dev, world)
        rank = dist.get_rank()
    elif zero_cfg is not None:
        print("[train] --zero requested with a single process; state stays "
              "replicated (run under torchrun with --nproc-per-node N to "
              "shard)")
    if zero_cfg is not None:
        opt_kw["zero"] = zero_cfg
    try:
        return _run(args, stop_at, cfg, lr, opt_kw, dev, telemetry_on,
                    adaptive, zero_cfg, mesh, rank)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(args, stop_at, cfg, lr, opt_kw, dev, telemetry_on, adaptive,
         zero_cfg, mesh, rank):
    """``run`` past the flags' checks, on ``mesh`` (None: one process)."""
    from repro_torch import obs
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import init_state, make_train_step

    def make_optimizer(overrides=None):
        kw = dict(opt_kw)
        if overrides:
            kw["overrides"] = overrides
        return get_optimizer(args.optimizer, lr=lr, **kw)

    chaos_plan = None
    if args.chaos is not None:
        from repro_torch.train.chaos import ChaosPlan
        chaos_plan = ChaosPlan.load(args.chaos)
        print(f"[train] chaos plan armed: {len(chaos_plan.faults)} faults "
              f"from {args.chaos}")
    resilience = None
    if args.resilient:
        from repro_torch.train.resilience import (ResilienceConfig,
                                                  ResilienceManager)
        resilience = ResilienceManager(ResilienceConfig(
            max_skips=args.max_skips, max_rollbacks=args.max_rollbacks,
            lr_cut=args.lr_cut))
    batch_fn = make_batch_fn(cfg, args.seq_len, args.batch, seed=args.seed,
                             device=dev)
    trainer_kw = {}
    if chaos_plan is not None:
        batch_fn = chaos_plan.wrap_batch_fn(batch_fn)
        if args.ckpt_dir:
            trainer_kw["ckpt_fault_hook"] = chaos_plan.bind_checkpoint_dir(
                args.ckpt_dir)

    def make_step(opt):
        return make_train_step(cfg, opt, telemetry=telemetry_on,
                               guard=args.resilient, chaos=chaos_plan)

    sink = None
    if args.telemetry != "off" and rank == 0:
        from repro_torch.telemetry.sink import TelemetrySink
        from repro_torch.train.checkpoint import CheckpointManager
        path = args.telemetry_path or (
            os.path.join(args.ckpt_dir, f"telemetry.{args.telemetry}")
            if args.ckpt_dir else f"telemetry.{args.telemetry}")
        # append exactly when this run resumes from a checkpoint: a restart
        # must not truncate the telemetry before it, a fresh run must not
        # inherit a stale file
        resuming = bool(args.ckpt_dir) and CheckpointManager(
            args.ckpt_dir).latest_step() is not None
        sink = TelemetrySink(path, fmt=args.telemetry,
                             every=args.telemetry_every, append=resuming)
        trainer_kw["log_metrics"] = sink.log_metrics

    allocator = None
    per_step = {"step_peak": 0, "collectives": None, "run_peak": 0}
    if adaptive:
        from repro_torch.models import transformer as T
        from repro_torch.telemetry.adaptive import AdaptiveOptimizerManager
        from repro_torch.telemetry.controllers import (
            RankAllocator, RankAllocatorConfig, RefreshScheduler,
            RefreshSchedulerConfig, leaf_inventory)

        leaves = leaf_inventory(T.init_params(cfg, args.seed, "meta"))
        scheduler = None
        if args.adaptive_rank:
            allocator = RankAllocator(
                RankAllocatorConfig(base_rank=opt_kw["rank"],
                                    decide_every=args.control_every),
                leaves)
        if args.adaptive_refresh:
            # the ladder starts from the preset's cadence (the dct_adamw
            # preset refreshes every step), so a stretch doubles it
            scheduler = RefreshScheduler(
                RefreshSchedulerConfig(base_interval=1,
                                       decide_every=args.control_every,
                                       cooldown=args.control_every),
                leaves)
        manager = AdaptiveOptimizerManager(
            make_optimizer=make_optimizer, make_step=make_step,
            make_train_state=lambda opt: init_state(cfg, opt, args.seed,
                                                    dev),
            rank_allocator=allocator, refresh_scheduler=scheduler)
        trainer_kw.update(train_step=manager.step,
                          init_state_fn=manager.init_state,
                          control_hook=manager.control_hook,
                          extra_state=manager)
    else:
        opt = make_optimizer()
        step_fn = make_step(opt)
        if mesh is not None:
            step_fn = _measured(step_fn, mesh, dev.type == "cuda", per_step)
        trainer_kw.update(train_step=step_fn,
                          init_state_fn=lambda: init_state(cfg, opt,
                                                           args.seed, dev))
    specs = None
    if mesh is not None:
        # placements from the whole state's shapes (meta tensors, built
        # outside the mesh: the port's jax.eval_shape), under the default
        # policy, "fsdp_tp", as the reference's CLI; init_state cuts the
        # blocks under the mesh (trainer.run)
        specs = sharding.train_state_specs(
            init_state(cfg, opt, args.seed, "meta"), zero=zero_cfg,
            mesh=mesh)
        trainer_kw["state_shardings"] = specs
        if rank:
            trainer_kw["log_fn"] = lambda line: None
    trainer = Trainer(
        batch_fn=batch_fn, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every,
        resilience=resilience, sync_sample_every=args.obs_sync_every,
        **trainer_kw)
    obs_dir = args.obs_dir
    if obs_dir and rank:
        obs_dir = os.path.join(obs_dir, f"rank{rank}")
    if obs_dir:
        obs.enable()
    try:
        with sharding.set_mesh(mesh):
            state = trainer.run(total_steps=args.steps if stop_at is None
                                else stop_at)
    finally:
        if sink is not None:
            sink.close()
        if obs_dir:
            # halted runs included
            os.makedirs(obs_dir, exist_ok=True)
            prom = obs.write_prometheus(os.path.join(obs_dir, "metrics.prom"))
            trace = obs.write_chrome_trace(os.path.join(obs_dir,
                                                        "trace.json"))
            print(f"[train] obs artifacts: {prom}, {trace}")
    if trainer.metrics_history and rank == 0:
        print(f"[train] done at step {state.step}: "
              f"loss {trainer.metrics_history[-1]['loss']:.4f}")
    if mesh is not None:
        from repro_torch.kernels import ops

        held, whole = sharding.state_bytes(state.opt_state, specs.opt_state,
                                           mesh)
        p_held, p_whole = sharding.state_bytes(state.params, specs.params,
                                               mesh)
        hist = trainer.metrics_history
        print("[train] rank " + json.dumps({
            "rank": rank, "world": mesh.size(mesh.axis_names),
            "backend": mesh.backend, "opt_state_bytes": held,
            "opt_state_whole_bytes": whole, "param_bytes": p_held,
            "param_whole_bytes": p_whole,
            "peak_memory_bytes": (max(torch.cuda.max_memory_allocated(),
                                      per_step["run_peak"])
                                  if dev.type == "cuda" else None),
            "step_peak_memory_bytes": (per_step["step_peak"]
                                       if dev.type == "cuda" else None),
            "step_collectives": per_step["collectives"],
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "s_per_step": [h["s_per_step"] for h in hist],
            "launches": {k: n for k, n in ops.launch_counts().items()
                         if n}}), flush=True)
    if allocator is not None:
        print(f"[train] final rank allocation: {allocator.alloc}")
    return trainer


def _measured(step_fn, mesh, cuda: bool, rec: dict):
    """``step_fn`` recording this rank's collectives in the last step
    (``mesh.counts``, reset before each step) and, on the card, the largest
    peak device memory of a step, each peak taken from a reset just before
    its step (``rec["run_peak"]`` keeps the peak before each reset). The
    allocator counts on the host as it allocates, so neither read waits
    for the card."""

    def step(state, batch):
        if cuda:
            rec["run_peak"] = max(rec["run_peak"],
                                  torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        mesh.reset_counts()
        out = step_fn(state, batch)
        if cuda:
            rec["step_peak"] = max(rec["step_peak"],
                                   torch.cuda.max_memory_allocated())
        rec["collectives"] = {k: list(v) for k, v in mesh.counts.items()}
        return out

    return step


def _supervise(args: argparse.Namespace, argv: list[str]) -> int:
    """``--supervise``: this CLI again, without the flag, as the child of
    the restart supervisor (progress-aware with ``--ckpt-dir``)."""
    from repro_torch.train.supervisor import checkpoint_progress_fn, supervise

    child = [sys.executable, "-m", "repro_torch.launch.train"] + [
        a for a in argv if a != "--supervise"]
    progress_fn = (checkpoint_progress_fn(args.ckpt_dir)
                   if args.ckpt_dir else None)
    return supervise(child, progress_fn=progress_fn)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build(argv)
    if args.supervise:
        return _supervise(args, argv)
    from repro_torch.train.resilience import HALT_EXIT_CODE, TrainingHalted

    try:
        run(args)
    except TrainingHalted as e:
        # rung 4: the diagnostic dump is on disk; the exit code tells the
        # supervisor not to restart
        print(f"[train] halted: {e}")
        return HALT_EXIT_CODE
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
