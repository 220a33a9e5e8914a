"""The data pipeline (``repro/data/`` in the reference)."""
from .pipeline import SyntheticLMDataset, Prefetcher, make_data_source

__all__ = ["SyntheticLMDataset", "Prefetcher", "make_data_source"]
