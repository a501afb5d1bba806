from .core import (LayerNorm, RMSNorm, dense, embed, gelu, layernorm, rmsnorm, scaled_layernorm,
                   trunc_normal_param, truncated_normal_)

__all__ = ["LayerNorm", "RMSNorm", "dense", "embed", "gelu", "layernorm", "rmsnorm", "scaled_layernorm",
           "trunc_normal_param", "truncated_normal_"]
