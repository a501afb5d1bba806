"""Feature specification, windowing (materialized and streaming),
alignment, the Tao model, its int8 W8A8 twin, its training with
crash-resume, joint multi-µarch training (Algorithm 1), µarch-pair
selection, the SimNet baseline and the legacy simulate loop (PyTorch port
of ``repro.core``)."""
from .align import AlignedTrace, build_adjusted_trace, verify_alignment
from .dataset import (
    INPUT_KEYS,
    StreamingWindowDataset,
    WindowDataset,
    build_windows,
    concat_datasets,
    iter_window_digests,
    num_windows,
    stream_batches,
    window_view,
)
from .features import (
    NUM_OPCODES,
    FeatureConfig,
    FeatureSet,
    extract_features,
    extract_features_reference,
    signed_log,
)
from .model import (
    LOSS_WEIGHTS,
    Tao,
    TaoConfig,
    apply_adapt,
    apply_embed,
    apply_pred,
    bucketize_latency,
    expected_latency,
    init_tao,
    multi_metric_loss,
    tao_forward,
)
from .quant import (
    QUANT_VERSION,
    QDense,
    QEmbed,
    QuantTao,
    int8_matmul,
    qdense,
    qembed,
    quantize_tao_params,
    tao_forward_int8,
)
from .multiarch import METHODS, MultiArch, eval_loss, init_multiarch, make_joint_step
from .selection import (
    mahalanobis_matrix,
    measure_design_metrics,
    select_pair_euclidean,
    select_pair_mahalanobis,
    select_random,
)
from .simnet import (
    SimNetConfig,
    init_simnet,
    make_simnet_step,
    simnet_features,
    simnet_forward,
    simnet_windows,
)
from .transfer import (
    TrainData,
    TrainResult,
    train_tao,
    train_tao_impl,
    transfer_finetune,
    warmup_train_step,
)

# .simulate imports engine.runner, and engine.runner imports this package
# (core.dataset / core.features / core.model) — so the simulate symbols are
# exposed lazily (PEP 562), as the reference's are, to keep
# `import repro_torch.engine` working as the FIRST import.
_SIMULATE_SYMBOLS = (
    "SimulationResult",
    "simulate_trace",
    "simulate_trace_legacy",
    "phase_curves",
)


def __getattr__(name):
    if name in _SIMULATE_SYMBOLS:
        from . import simulate as _simulate

        return getattr(_simulate, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AlignedTrace",
    "INPUT_KEYS",
    "LOSS_WEIGHTS",
    "METHODS",
    "NUM_OPCODES",
    "QUANT_VERSION",
    "FeatureConfig",
    "FeatureSet",
    "MultiArch",
    "QDense",
    "QEmbed",
    "QuantTao",
    "SimNetConfig",
    "SimulationResult",
    "StreamingWindowDataset",
    "Tao",
    "TaoConfig",
    "TrainData",
    "TrainResult",
    "WindowDataset",
    "apply_adapt",
    "apply_embed",
    "apply_pred",
    "build_adjusted_trace",
    "build_windows",
    "bucketize_latency",
    "concat_datasets",
    "eval_loss",
    "expected_latency",
    "extract_features",
    "extract_features_reference",
    "init_multiarch",
    "init_simnet",
    "init_tao",
    "int8_matmul",
    "iter_window_digests",
    "mahalanobis_matrix",
    "make_joint_step",
    "make_simnet_step",
    "measure_design_metrics",
    "multi_metric_loss",
    "num_windows",
    "phase_curves",
    "qdense",
    "qembed",
    "quantize_tao_params",
    "select_pair_euclidean",
    "select_pair_mahalanobis",
    "select_random",
    "signed_log",
    "simnet_features",
    "simnet_forward",
    "simnet_windows",
    "simulate_trace",
    "simulate_trace_legacy",
    "stream_batches",
    "tao_forward",
    "tao_forward_int8",
    "train_tao",
    "train_tao_impl",
    "transfer_finetune",
    "verify_alignment",
    "warmup_train_step",
    "window_view",
]
