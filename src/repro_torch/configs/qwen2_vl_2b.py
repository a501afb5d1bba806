"""Qwen2-VL-2B [vlm] — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE; vision frontend is a STUB (precomputed patch embeddings).
[arXiv:2409.12191; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    mlp_act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    frontend="vision_stub",
    frontend_dim=1280,
    vision_patches=64,
)
