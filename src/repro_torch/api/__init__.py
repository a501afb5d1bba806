"""Top-level facade for the Tao workflow (PyTorch port of ``repro.api``).

    Session      capture traces, build datasets, train, sweep
    Trace        reusable functional-trace artifact
    TrainedModel simulate / transfer-fine-tune a trained model
    JointModel   §4.3 shared-embedding training result
    DesignSpace  design sampling + training-pair selection

``Session.dataset`` returns a materialized ``WindowDataset`` or — at and
above ``streaming_threshold`` instructions — an O(trace + batch)
``StreamingWindowDataset`` (bit-identical training trajectories), plus the
engine's pluggable metric surface (``MetricSpec`` / ``register_metric``)
and the sweep scheduler's report type.

Zero cold start: ``Session(store=...)`` attaches a content-addressed
``ArtifactStore`` so traces, features, detailed-sim summaries, trained
params and int8 trees persist across processes (and are shared with the
reference package where their keys use no ``TaoConfig``);
``Session.warmup`` captures a declared geometry set up front, and the
kernel build cache (``enable_persistent_cache``) keeps built kernels on
disk.

Serving: ``TraceServer``/``ModelRegistry`` (from ``repro_torch.serve``)
expose registered models to concurrent tenants with continuous batching
into the captured steps; the typed wire surface — ``ServeRequest``,
``ServeResult``, ``ServerStats``, ``ServeError`` — is re-exported here.
"""
from ..core.dataset import StreamingWindowDataset, WindowDataset
from ..engine.aot import enable_persistent_cache, persistent_cache_status
from ..engine.metrics import (
    DEFAULT_METRICS,
    METRIC_REGISTRY,
    MetricSpec,
    StepContext,
    register_metric,
    windowed_spec,
)
from ..engine.plan import ExecutionPlan
from ..engine.runner import (
    EngineConfig,
    MetricNotCollectedError,
    MetricNotComputedError,
    SimulationResult,
)
from ..engine.scheduler import SweepJob, SweepReport
from ..serve import (
    ModelRegistry,
    ServeError,
    ServeRequest,
    ServeResult,
    ServerStats,
    TraceServer,
)
from ..store import ArtifactStore
from .session import DesignSpace, JointModel, Session, Trace, TrainedModel

__all__ = [
    "ArtifactStore",
    "Session",
    "enable_persistent_cache",
    "persistent_cache_status",
    "Trace",
    "TrainedModel",
    "JointModel",
    "DesignSpace",
    "WindowDataset",
    "StreamingWindowDataset",
    "EngineConfig",
    "ExecutionPlan",
    "SimulationResult",
    "MetricSpec",
    "windowed_spec",
    "StepContext",
    "register_metric",
    "METRIC_REGISTRY",
    "DEFAULT_METRICS",
    "MetricNotCollectedError",
    "MetricNotComputedError",
    "SweepJob",
    "SweepReport",
    "TraceServer",
    "ModelRegistry",
    "ServeRequest",
    "ServeResult",
    "ServerStats",
    "ServeError",
]
