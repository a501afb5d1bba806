from .core import RMSNorm, dense, embed, gelu, layernorm, rmsnorm, trunc_normal_param, truncated_normal_

__all__ = ["RMSNorm", "dense", "embed", "gelu", "layernorm", "rmsnorm", "trunc_normal_param", "truncated_normal_"]
