"""The kernel entry points of the port, grouped by the path that runs them,
and their launch counts.

The JAX package's ``*_op`` dispatchers exist to pick Pallas interpret
mode off the TPU. Here each wrapper chooses by its tensors' device (CUDA:
launch the kernel or raise; CPU: the plain version), so the ``*_op`` names
below are the wrappers themselves, with the reference's argument order:
``dct_project_op(g, q)``, ``colgather_matmul_op(b, qt, idx)``,
``colgather_matmul_dual_op(b1, b2, qt, idx)``, ``newton_schulz_op(x)``
(the full NS: ``steps`` launches each of ``ns_gram`` and ``ns_apply``),
``ns_iteration_op(x)`` (one of each), ``flash_attention_op(q, k, v)``,
``flash_decode_op(q, k_pool, v_pool, block_table, lengths)``,
``quantize_ef_op(x)`` and ``dequant_add_ef_op(g, q, scale)``. Their
keywords are the port's (no ``interpret``, no ``block``). ``ON_TPU`` is not
ported: the port never runs on a TPU, and its dispatch is by device. The
tile defaults ``DEFAULT_BLOCK`` / ``DEFAULT_BM`` of the reference's kernels
wait for the port's tuner.

``TRAINING`` lists the CUDA kernels of the DCT-AdamW step, ``MOMENTUM``
those the momentum families add (Trion, Muon, Dion: the two Newton–Schulz
kernels and the single-operand back-projection; Trion and subspace Muon
also run ``dct_project``, and Trion ``colgather_matmul_dual``), ``SERVING``
those of the paged decode step, ``LOWP`` the bf16 and int8 variants of the
projection kernels that DCT-AdamW's ``compute_dtype`` runs (a launch of one
counts on its own name, not on the fp32 kernel's, so a run shows which
precision ran) with the int8 projections' operand quantizers
(``dct_project``'s ``quant_rows_q8`` and ``quant_cols_q8t``,
``colgather_matmul``'s ``quant_qt_q8`` and ``quant_fold_q8``),
``ATTENTION`` the dense attention
kernels of the model's no-grad forward (the dense prefill:
``flash_attention_blockwise`` in bf16, ``flash_attention`` in fp32),
``KERNELS`` all. ``launch_counts`` /
``reset_launch_counts`` read and zero the counters of a group (all by
default).
"""
from __future__ import annotations

from .colgather_matmul import (
    colgather_matmul,
    colgather_matmul_bf16,
    colgather_matmul_dual,
    colgather_matmul_dual_bf16,
    colgather_matmul_dual_q8,
    colgather_matmul_q8,
)
from .dct_project import dct_project, dct_project_bf16, dct_project_q8
from .flash_attention import flash_attention, flash_attention_blockwise
from .flash_decode import flash_decode
from .newton_schulz import (newton_schulz_kernel, ns_apply, ns_gram,
                            ns_iteration)
from .quant_ef import (dequant_add_ef, quant_cols_q8t, quant_fold_q8,
                       quant_qt_q8, quant_rows_q8, quantize_ef)

TRAINING = {
    "dequant_add_ef": dequant_add_ef,
    "dct_project": dct_project,
    "colgather_matmul_dual": colgather_matmul_dual,
    "quantize_ef": quantize_ef,
}
MOMENTUM = {
    "ns_gram": ns_gram,
    "ns_apply": ns_apply,
    "colgather_matmul": colgather_matmul,
}
SERVING = {
    "flash_decode": flash_decode,
}
LOWP = {
    "dct_project_bf16": dct_project_bf16,
    "dct_project_q8": dct_project_q8,
    "quant_rows_q8": quant_rows_q8,
    "quant_cols_q8t": quant_cols_q8t,
    "colgather_matmul_dual_bf16": colgather_matmul_dual_bf16,
    "colgather_matmul_dual_q8": colgather_matmul_dual_q8,
    "colgather_matmul_bf16": colgather_matmul_bf16,
    "colgather_matmul_q8": colgather_matmul_q8,
    "quant_qt_q8": quant_qt_q8,
    "quant_fold_q8": quant_fold_q8,
}
ATTENTION = {
    "flash_attention": flash_attention,
    "flash_attention_blockwise": flash_attention_blockwise,
}
KERNELS = {**TRAINING, **MOMENTUM, **SERVING, **LOWP, **ATTENTION}

# the JAX package's dispatcher names: each is its wrapper
dct_project_op = dct_project
colgather_matmul_op = colgather_matmul
colgather_matmul_dual_op = colgather_matmul_dual
newton_schulz_op = newton_schulz_kernel
ns_iteration_op = ns_iteration
flash_attention_op = flash_attention
flash_decode_op = flash_decode
quantize_ef_op = quantize_ef
dequant_add_ef_op = dequant_add_ef


def launch_counts(group: dict | None = None) -> dict[str, int]:
    return {name: fn.launches for name, fn in (group or KERNELS).items()}


def reset_launch_counts(group: dict | None = None) -> None:
    for fn in (group or KERNELS).values():
        fn.launches = 0
