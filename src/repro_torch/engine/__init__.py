"""The streaming simulation engine, its step cache and its metric registry
(PyTorch port of ``repro.engine``'s single-device inference path)."""
from .metrics import (
    DEFAULT_METRICS,
    METRIC_REGISTRY,
    MetricSpec,
    StepContext,
    register_metric,
    resolve_metrics,
    windowed_spec,
)
from .runner import (
    PRECISIONS,
    EngineConfig,
    MetricNotCollectedError,
    MetricNotComputedError,
    SimulationResult,
    StreamingEngine,
    cache_stats,
    clear_step_cache,
    simulate_trace_engine,
)

__all__ = [
    "DEFAULT_METRICS",
    "METRIC_REGISTRY",
    "PRECISIONS",
    "EngineConfig",
    "MetricNotCollectedError",
    "MetricNotComputedError",
    "MetricSpec",
    "SimulationResult",
    "StepContext",
    "StreamingEngine",
    "cache_stats",
    "clear_step_cache",
    "register_metric",
    "resolve_metrics",
    "simulate_trace_engine",
    "windowed_spec",
]
