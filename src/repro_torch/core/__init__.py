"""Feature specification, windowing, the Tao model and its int8 W8A8 twin
(PyTorch port of ``repro.core``'s inference half)."""
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

__all__ = [
    "INPUT_KEYS",
    "NUM_OPCODES",
    "QUANT_VERSION",
    "FeatureConfig",
    "FeatureSet",
    "QDense",
    "QEmbed",
    "QuantTao",
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
    "int8_matmul",
    "num_windows",
    "qdense",
    "qembed",
    "quantize_tao_params",
    "signed_log",
    "stream_batches",
    "tao_forward",
    "tao_forward_int8",
    "window_view",
]
