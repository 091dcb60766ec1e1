"""The synthetic token pipeline (numpy; a copy of the JAX package's, so
the port imports nothing of it)."""

from .pipeline import PipelineConfig, Prefetcher, SyntheticTokens, \
    make_pipeline

__all__ = ["PipelineConfig", "SyntheticTokens", "Prefetcher",
           "make_pipeline"]
