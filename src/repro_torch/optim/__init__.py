"""Low-rank adaptive optimizers built from composable gradient transforms:
the paper's DCT-AdamW, its baselines (LDAdamW, GaLore, FRUGAL, FIRA and
full-rank AdamW) and the momentum families Trion, Muon and Dion."""
from .adamw import adamw, adamw_transform
from .api import OPTIMIZERS, TRANSFORMS, get_optimizer, get_transform
from .common import Optimizer, apply_updates
from .dion import dion, dion_transform
from .muon import muon, muon_transform
from .projected_adam import (
    dct_adamw,
    dct_adamw_transform,
    fira,
    frugal,
    galore,
    ldadamw,
)
from .trion import trion, trion_transform
from .transform import (
    ChainState,
    GradientTransform,
    add_decayed_weights,
    as_optimizer,
    chain,
    clip_global_norm,
    inject_hyperparams,
    lowrank_project,
    matrix_optimizer,
    partition,
    scale_by_adam,
    scale_by_learning_rate,
    scale_by_schedule,
)

__all__ = [
    "OPTIMIZERS", "TRANSFORMS", "get_optimizer", "get_transform",
    "Optimizer", "apply_updates", "dct_adamw", "dct_adamw_transform",
    "ldadamw", "galore", "frugal", "fira", "adamw", "adamw_transform",
    "trion", "trion_transform", "muon", "muon_transform", "dion",
    "dion_transform",
    "GradientTransform", "ChainState", "chain", "partition",
    "inject_hyperparams", "as_optimizer",
    "matrix_optimizer", "lowrank_project", "scale_by_adam",
    "scale_by_learning_rate", "scale_by_schedule", "add_decayed_weights",
    "clip_global_norm",
]
