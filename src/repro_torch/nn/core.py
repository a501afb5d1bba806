"""NN primitives of the Tao model, in PyTorch's idiom.

Counterpart of ``repro/nn/core.py``.  Layers are ``nn.Module``s whose
arithmetic matches the reference's pure functions: ``dense`` is
``nn.Linear`` (the reference's ``(in, out)`` weight ``w`` is this layer's
``weight.T``), ``layernorm`` uses the biased variance with eps 1e-5, and
``gelu`` is the tanh approximation.  Initialization draws from an explicit
``torch.Generator``: the distributions are the reference's, the numbers
are not (``jax.random`` cannot be reproduced in torch), so parity tests
load the reference's weights through ``repro_torch.convert``.  Layers are
built with ``skip_init``, so the global torch RNG is never drawn from.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

__all__ = ["dense", "embed", "gelu", "layernorm", "truncated_normal_"]

# std of a unit normal truncated to [-2, 2]: dividing by it keeps the
# requested stddev after truncation (as the reference's initializer does)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, stddev: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with a 2-sigma truncated normal of std ``stddev``."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(stddev / _TRUNC_STD)


def dense(in_dim: int, out_dim: int, generator: torch.Generator, *, scale: float = 1.0) -> nn.Linear:
    """Fan-in scaled linear layer (zero bias)."""
    layer = skip_init(nn.Linear, in_dim, out_dim)
    truncated_normal_(layer.weight, scale / math.sqrt(in_dim), generator)
    nn.init.zeros_(layer.bias)
    return layer


def embed(vocab: int, dim: int, generator: torch.Generator) -> nn.Embedding:
    layer = skip_init(nn.Embedding, vocab, dim)
    truncated_normal_(layer.weight, 1.0, generator)
    return layer


def layernorm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
