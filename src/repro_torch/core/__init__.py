"""Feature specification, windowing and the Tao model (PyTorch port of
``repro.core``'s inference half)."""
from .dataset import INPUT_KEYS, num_windows, stream_batches, window_view
from .features import (
    NUM_OPCODES,
    FeatureConfig,
    FeatureSet,
    extract_features,
    extract_features_reference,
    signed_log,
)
from .model import (
    Tao,
    TaoConfig,
    apply_adapt,
    apply_embed,
    apply_pred,
    bucketize_latency,
    expected_latency,
    init_tao,
    tao_forward,
)

__all__ = [
    "INPUT_KEYS",
    "NUM_OPCODES",
    "FeatureConfig",
    "FeatureSet",
    "Tao",
    "TaoConfig",
    "apply_adapt",
    "apply_embed",
    "apply_pred",
    "bucketize_latency",
    "expected_latency",
    "extract_features",
    "extract_features_reference",
    "init_tao",
    "num_windows",
    "signed_log",
    "stream_batches",
    "tao_forward",
    "window_view",
]
