"""The kernel entry points the fused step calls, and their launch counts.

The JAX package's ``*_op`` wrappers exist to pick Pallas interpret mode off
the TPU. Here each wrapper chooses by its tensors' device (CUDA: launch the
kernel or raise; CPU: the plain version), so the fused step calls the
wrappers themselves.

``KERNELS`` lists the CUDA kernels of the training step by name;
``launch_counts`` / ``reset_launch_counts`` read and zero their counters.
"""
from __future__ import annotations

from .colgather_matmul import colgather_matmul_dual
from .dct_project import dct_project
from .quant_ef import dequant_add_ef, quantize_ef

KERNELS = {
    "dequant_add_ef": dequant_add_ef,
    "dct_project": dct_project,
    "colgather_matmul_dual": colgather_matmul_dual,
    "quantize_ef": quantize_ef,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
