"""GLM-4-9B [dense] — 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
RoPE, QKV bias.  [hf:THUDM/glm-4-9b; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    qkv_bias=True,
    rope="rope",
    mlp_act="swiglu",
    norm="rmsnorm",
)
