"""Core math of the paper: the DCT basis, dynamic column selection,
quantized error feedback, the projector and the fused step layer."""
from .selection import reconstruction_error_sq  # noqa: F401
