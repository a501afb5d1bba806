"""The streaming simulation engine and its metric registry (PyTorch port
of ``repro.engine``'s single-device inference path)."""
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
    EngineConfig,
    MetricNotCollectedError,
    MetricNotComputedError,
    SimulationResult,
    StreamingEngine,
    simulate_trace_engine,
)

__all__ = [
    "DEFAULT_METRICS",
    "METRIC_REGISTRY",
    "EngineConfig",
    "MetricNotCollectedError",
    "MetricNotComputedError",
    "MetricSpec",
    "SimulationResult",
    "StepContext",
    "StreamingEngine",
    "register_metric",
    "resolve_metrics",
    "simulate_trace_engine",
    "windowed_spec",
]
