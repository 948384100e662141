"""Training driver.

  python -m repro_torch.launch.train --arch llama-350m --optimizer trion \
      --rank 128 --steps 300 --seq-len 512 --batch 64 [--smoke] [--device cpu]

Runs on the CUDA card by default and raises if there is none; ``--device
cpu`` runs on the CPU (the tests). config -> synthetic data -> train step
with the chosen optimizer -> ``Trainer``. ``--optimizer`` is any preset of
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

Flags of the JAX CLI that this port does not support yet exit with
"not yet ported".
"""
from __future__ import annotations

import argparse
import sys

import torch

# the presets built on ProjectedAdamRule
PROJECTED_ADAM_FAMILY = ("dct_adamw", "ldadamw", "galore", "frugal", "fira")
# presets with a fused-step dispatch field: the projected-Adam family plus
# the momentum-orthogonalization rules
FUSED_FAMILY = PROJECTED_ADAM_FAMILY + ("muon", "trion", "dion")

# flags of ``python -m repro.launch.train`` not ported yet
NOT_YET_PORTED = ("--tune-cache", "--zero",
                  "--ckpt-dir", "--ckpt-every", "--supervise", "--telemetry",
                  "--telemetry-path", "--telemetry-every", "--adaptive-rank",
                  "--adaptive-refresh", "--control-every", "--obs-dir",
                  "--obs-sync-every", "--resilient", "--max-skips",
                  "--max-rollbacks", "--lr-cut", "--chaos")


def build(argv=None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    for a in argv:
        if a.split("=", 1)[0] in NOT_YET_PORTED:
            raise SystemExit(f"{a.split('=', 1)[0]} is not yet ported to "
                             f"repro_torch")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-350m")
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
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def device_for(name: str) -> torch.device:
    """The run's device; ``cuda`` without a card raises rather than falling
    back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda was asked for but no CUDA "
                               "device is available (pass --device cpu to "
                               "run on the CPU)")
        # fp32 matmuls in full fp32 (the reference's numbers), stated here
        # rather than left to the library defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _optimizer_kwargs(args: argparse.Namespace, dev: torch.device) -> dict:
    """The optimizer keywords of the flags, with the JAX CLI's checks (and
    its messages)."""
    from repro_torch.core import fused_step

    kw = {"weight_decay": args.weight_decay}
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


def run(args: argparse.Namespace):
    """Train as ``args`` say; returns the finished ``Trainer`` (its
    ``metrics_history`` holds one record per step)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train.loop import Trainer
    from repro_torch.train.schedule import cosine_warmup
    from repro_torch.train.steps import init_state, make_train_step

    dev = device_for(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    lr = cosine_warmup(args.lr, args.warmup, args.steps)
    opt = get_optimizer(args.optimizer, lr=lr, **_optimizer_kwargs(args, dev))
    trainer = Trainer(
        train_step=make_train_step(cfg, opt),
        init_state_fn=lambda: init_state(cfg, opt, args.seed, dev),
        batch_fn=make_batch_fn(cfg, args.seq_len, args.batch, seed=args.seed,
                               device=dev),
        log_every=args.log_every)
    state = trainer.run(total_steps=args.steps)
    if trainer.metrics_history:
        print(f"[train] done at step {state.step}: "
              f"loss {trainer.metrics_history[-1]['loss']:.4f}")
    return trainer


def main(argv=None) -> int:
    run(build(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
