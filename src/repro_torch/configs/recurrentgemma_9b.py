"""RecurrentGemma-9B [hybrid] — 38L d=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention (window 2048) in a 2:1 pattern.
[arXiv:2402.19427; unverified]"""
from ..models.config import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    rope="rope",
    mlp_act="gelu",
    norm="rmsnorm",
    hybrid=HybridConfig(rec_per_unit=2, attn_per_unit=1, window=2048, conv_kernel=4),
)
