"""Synthetic data and the host -> device pipeline (port of ``repro.data``)."""

from . import pipeline, synthetic
from .pipeline import DataPipeline
from .synthetic import DataConfig, SyntheticTokens, stub_frontend_batch

__all__ = ["pipeline", "synthetic", "DataPipeline", "DataConfig",
           "SyntheticTokens", "stub_frontend_batch"]
