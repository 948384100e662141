"""Core math of the paper: orthogonal-basis backends (DCT/DST/Hadamard/
random-orthogonal), dynamic column selection, Newton-Schulz, quantized
error feedback, the pluggable projector family and the fused step layer
(``core.fused_step``). Re-exports the names ``repro.core`` does."""
from .dct import dct2, dct2_matrix, dct3_matrix, makhoul_dct2
from .error_feedback import QuantizedBuffer, dequantize_q8, quantize_q8, zeros_q8
from .newton_schulz import newton_schulz
from .projectors import (
    PROJECTOR_KINDS,
    Projector,
    projector_kinds,
    rotation_matrix,
    shared_basis_for,
)
from .selection import (
    back_project,
    column_norms,
    dynamic_column_selection,
    gather_columns,
    reconstruction_error_sq,
    select_top_r,
)
from .transforms import (
    BasisBackend,
    BasisCache,
    backend_kinds,
    basis_cache,
    dst2_matrix,
    fwht,
    get_backend,
    hadamard_matrix,
    is_backend,
    random_orthogonal_matrix,
    register_backend,
    shared_basis,
)

__all__ = [
    "dct2", "dct2_matrix", "dct3_matrix", "makhoul_dct2",
    "QuantizedBuffer", "dequantize_q8", "quantize_q8", "zeros_q8",
    "newton_schulz",
    "PROJECTOR_KINDS", "Projector", "projector_kinds", "rotation_matrix",
    "shared_basis_for",
    "back_project", "column_norms", "dynamic_column_selection",
    "gather_columns", "reconstruction_error_sq", "select_top_r",
    "BasisBackend", "BasisCache", "backend_kinds", "basis_cache",
    "dst2_matrix", "fwht", "get_backend", "hadamard_matrix", "is_backend",
    "random_orthogonal_matrix", "register_backend", "shared_basis",
]
