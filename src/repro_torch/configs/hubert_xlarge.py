"""HuBERT-XLarge [audio] — 48L d=1280 16H (MHA) d_ff=5120, encoder-only,
504 output classes.  Modality frontend is a STUB: input_specs() provides
precomputed frame embeddings; conv positional embedding replaced with RoPE
(DESIGN.md hardware-adaptation note).  [arXiv:2106.07447; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    rope="rope",
    mlp_act="gelu",
    norm="layernorm",
    encoder_only=True,
    frontend="audio_stub",
    frontend_dim=512,
)
