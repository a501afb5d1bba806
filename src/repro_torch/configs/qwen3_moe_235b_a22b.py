"""Qwen3-235B-A22B [moe] — 94L d=4096 64H (GQA kv=4, head_dim=128, QK-norm)
128 experts top-8, expert d_ff=1536, vocab=151936.  [hf:Qwen/Qwen3-235B-A22B; hf]"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    qk_norm=True,
    d_ff=1536,
    vocab=151936,
    rope="rope",
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
)
