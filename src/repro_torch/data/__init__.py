"""Deterministic, checkpointable data pipelines (counterpart of
``repro.data``)."""
from .pipeline import LMDataPipeline, TraceDataPipeline, make_lm_batch_specs

__all__ = ["LMDataPipeline", "TraceDataPipeline", "make_lm_batch_specs"]
