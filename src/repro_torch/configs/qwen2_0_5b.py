"""Qwen2-0.5B [dense] — 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings.  [arXiv:2407.10671; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    rope="rope",
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
