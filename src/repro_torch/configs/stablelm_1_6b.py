"""StableLM-2-1.6B [dense] — 24L d=2048 32H (MHA kv=32) d_ff=5632
vocab=100352.  LayerNorm, partial-rotary in the real model (full RoPE here;
noted in DESIGN.md).  [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    qkv_bias=False,
    rope="rope",
    mlp_act="swiglu",
    norm="layernorm",
)
