from .core import dense, embed, gelu, layernorm, truncated_normal_

__all__ = ["dense", "embed", "gelu", "layernorm", "truncated_normal_"]
