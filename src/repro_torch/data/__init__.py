"""Synthetic language-model data and the prefetching pipeline."""
from .pipeline import DataPipeline
from .synthetic import SyntheticLM, make_batch_fn

__all__ = ["SyntheticLM", "make_batch_fn", "DataPipeline"]
