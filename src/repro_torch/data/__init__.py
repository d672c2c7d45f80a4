"""Synthetic, deterministic LM data with background prefetch (numpy)."""

from .pipeline import DataConfig, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData"]
