"""Qwen1.5-32B [dense]  — 64L d=5120 40H (MHA, kv=40) d_ff=27392 vocab=152064,
QKV bias, RoPE, SwiGLU.  [hf:Qwen/Qwen1.5-32B; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope="rope",
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
)
