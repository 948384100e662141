"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
``quantize_ef`` / ``dequant_add_ef``, ``dct_project`` and
``colgather_matmul_dual`` of the DCT-AdamW step, the Newton–Schulz
``ns_gram`` / ``ns_apply`` and the single-operand ``colgather_matmul`` of the
momentum families, ``flash_decode`` of serving, ``flash_attention`` of the
dense prefill. Importing builds nothing; the kernels are compiled at first
launch (``cuda_lib``).

Re-exports the names ``repro.kernels`` does (``ops`` with the reference's
``*_op`` dispatchers, ``newton_schulz_pallas`` as the name of
``newton_schulz_kernel``), apart from ``ref``: each kernel module's plain
version takes its place."""
from . import ops
from .colgather_matmul import colgather_matmul, colgather_matmul_dual
from .dct_project import dct_project
from .flash_attention import flash_attention
from .flash_decode import flash_decode
from .newton_schulz import newton_schulz_pallas, ns_iteration
from .quant_ef import dequant_add_ef, quantize_ef

__all__ = [
    "ops", "colgather_matmul", "colgather_matmul_dual", "dct_project",
    "flash_attention", "flash_decode", "newton_schulz_pallas", "ns_iteration",
    "dequant_add_ef", "quantize_ef",
]
