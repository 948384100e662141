"""The device an entry point of the port runs on.

The port runs on the CUDA card unless the caller asks for the CPU. Every
entry point that makes tensors from nothing (``models.transformer.
init_params`` and the caches and pools, ``train.steps.init_state``,
``serve.kv_cache.PagedKVCache``, the synthetic batches, ``convert``) takes
``device=None`` to mean the card and resolves it here; so do the CLIs'
``--device`` flags. Without a card that raises: nothing falls back to the
CPU without being asked. The low-level helpers (the basis matrices,
``MatrixRule.init``, the layers' inits) keep torch's own convention, since
their callers pass the device of the tensors they serve.
"""
from __future__ import annotations

import torch

NO_CARD = ("--device cuda was asked for but no CUDA device is available "
           "(pass --device cpu to run on the CPU)")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda``.

    A CUDA device raises when there is no card, and sets fp32 matmuls to
    full IEEE fp32 (no TF32: the reference's numbers), stated here rather
    than left to the library's defaults. ``cpu`` and ``meta`` (shapes
    without values) pass through; any other device type raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CARD)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
