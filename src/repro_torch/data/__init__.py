"""The synthetic token pipeline of the training path (numpy, as the
reference's)."""

from .pipeline import DataConfig, SyntheticTokenPipeline

__all__ = ["DataConfig", "SyntheticTokenPipeline"]
