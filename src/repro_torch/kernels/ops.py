"""The kernel entry points of the port, grouped by the path that runs them,
and their launch counts.

The JAX package's ``*_op`` wrappers exist to pick Pallas interpret mode off
the TPU. Here each wrapper chooses by its tensors' device (CUDA: launch the
kernel or raise; CPU: the plain version), so callers use the wrappers
themselves.

``TRAINING`` lists the CUDA kernels of the DCT-AdamW step, ``SERVING``
those of the paged decode step, ``KERNELS`` both. ``launch_counts`` /
``reset_launch_counts`` read and zero the counters of a group (all by
default).
"""
from __future__ import annotations

from .colgather_matmul import colgather_matmul_dual
from .dct_project import dct_project
from .flash_decode import flash_decode
from .quant_ef import dequant_add_ef, quantize_ef

TRAINING = {
    "dequant_add_ef": dequant_add_ef,
    "dct_project": dct_project,
    "colgather_matmul_dual": colgather_matmul_dual,
    "quantize_ef": quantize_ef,
}
SERVING = {
    "flash_decode": flash_decode,
}
KERNELS = {**TRAINING, **SERVING}


def launch_counts(group: dict | None = None) -> dict[str, int]:
    return {name: fn.launches for name, fn in (group or KERNELS).items()}


def reset_launch_counts(group: dict | None = None) -> None:
    for fn in (group or KERNELS).values():
        fn.launches = 0
