"""The streaming simulation engine, its step cache, its metric registry, the
execution plan, host->device prefetch, the kernel build cache and the
multi-trace sweep scheduler (PyTorch port of ``repro.engine``, one GPU)."""
from .metrics import (
    DEFAULT_METRICS,
    DEFAULT_PHASE_CHUNKS,
    METRIC_REGISTRY,
    MetricSpec,
    StepContext,
    register_metric,
    resolve_metrics,
    windowed_spec,
)
from .aot import (
    build_cache_counters,
    enable_persistent_cache,
    persistent_cache_status,
)
from .plan import AxisContext, ExecutionPlan
from .runner import (
    PER_INSTRUCTION_KEYS,
    PRECISIONS,
    EngineConfig,
    MetricNotCollectedError,
    MetricNotComputedError,
    SimulationResult,
    StreamingEngine,
    cache_stats,
    clear_step_cache,
    prefetch_to_device,
    simulate_trace_engine,
)
from .scheduler import ROUTES, SweepJob, SweepReport, TraceSweeper, sweep_traces

__all__ = [
    "AxisContext",
    "DEFAULT_METRICS",
    "DEFAULT_PHASE_CHUNKS",
    "ExecutionPlan",
    "METRIC_REGISTRY",
    "PER_INSTRUCTION_KEYS",
    "PRECISIONS",
    "ROUTES",
    "EngineConfig",
    "MetricNotCollectedError",
    "MetricNotComputedError",
    "MetricSpec",
    "SimulationResult",
    "StepContext",
    "StreamingEngine",
    "SweepJob",
    "SweepReport",
    "TraceSweeper",
    "build_cache_counters",
    "cache_stats",
    "clear_step_cache",
    "enable_persistent_cache",
    "persistent_cache_status",
    "prefetch_to_device",
    "register_metric",
    "resolve_metrics",
    "simulate_trace_engine",
    "sweep_traces",
    "windowed_spec",
]
