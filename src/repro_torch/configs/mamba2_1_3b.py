"""Mamba2-1.3B [ssm] — 48L d=2048, attention-free, SSD state=128,
head_dim=64, expand=2, vocab=50280.  [arXiv:2405.21060; unverified]"""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    rope="none",
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, n_groups=1, chunk=256),
)
