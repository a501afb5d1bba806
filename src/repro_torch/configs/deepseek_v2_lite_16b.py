"""DeepSeek-V2-Lite-16B [moe] — 27L d=2048 16H, MLA (kv_lora=512, rope
head 64, nope head 128, v head 128); MoE: 64 routed experts top-6 + 2 shared,
expert d_ff=1408, first layer dense; vocab=102400.  [arXiv:2405.04434; hf]

Assignment note: the inline note "2 shared+160 routed" describes full
DeepSeek-V2; the Lite spec (64e top-6) from the main entry is used here.
"""
from ..models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,           # dense first layer width
    vocab=102400,
    rope="rope",
    mlp_act="swiglu",
    norm="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared=2,
        d_ff_shared=2816,
        first_dense_layers=1,
    ),
)
