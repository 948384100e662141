"""Model configurations addressable by ``--arch``: ``get_config(arch_id)``.
``repro.configs`` also exports the dry-run cells of ``configs/shapes.py``
(``SHAPES``, ``input_specs``, ``cell_applicable``, ``skip_reason``); they
serve the HLO tooling and are not ported yet."""
from __future__ import annotations

from .registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "get_config", "list_archs"]
