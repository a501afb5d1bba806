"""The paper's own model at production scale: ROB-128 context windows
(W = 129), multi-metric heads, 6 layers of width 512.

Counterpart of ``repro/configs/tao.py``: a ``TaoConfig`` for the core, and
no ``ArchConfig`` (Tao trains and simulates through ``repro_torch.core``
and ``repro_torch.engine``, not through the model zoo)."""
from ..core.features import FeatureConfig
from ..core.model import TaoConfig

CONFIG = TaoConfig(
    window=129,
    d_model=512,
    n_heads=8,
    n_layers=6,
    d_ff=2048,
    d_cat=128,
    features=FeatureConfig(n_buckets=1024, n_queue=32, n_mem=64),
)
