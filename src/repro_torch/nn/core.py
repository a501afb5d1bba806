"""NN primitives of the Tao model, in PyTorch's idiom.

Counterpart of ``repro/nn/core.py``.  Layers are ``nn.Module``s whose
arithmetic matches the reference's pure functions: ``dense`` is
``nn.Linear`` (the reference's ``(in, out)`` weight ``w`` is this layer's
``weight.T``), ``layernorm`` uses the biased variance with eps 1e-5,
``gelu`` is the tanh approximation, and ``rmsnorm`` normalizes in float32
with eps 1e-6.  Initialization draws from an explicit
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

__all__ = ["RMSNorm", "dense", "embed", "gelu", "layernorm", "rmsnorm", "softmax_cross_entropy",
           "trunc_normal_param", "truncated_normal_"]

# std of a unit normal truncated to [-2, 2]: dividing by it keeps the
# requested stddev after truncation (as the reference's initializer does)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, stddev: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with a 2-sigma truncated normal of std ``stddev``."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(stddev / _TRUNC_STD)


def trunc_normal_param(shape, stddev: float, generator: torch.Generator, *,
                       device, dtype) -> nn.Parameter:
    """A 2-sigma truncated normal of std ``stddev``, drawn in float32 on the
    generator's device and stored as ``dtype`` on ``device``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return nn.Parameter(truncated_normal_(t, stddev, generator).to(device=device, dtype=dtype))


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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element cross-entropy of integer ``labels`` under ``logits``
    (classes on the last axis), as the reference computes it:
    ``-sum(onehot * log_softmax)`` in float32, a label outside the classes
    matching no class (its one-hot row is zeros)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    classes = torch.arange(logits.shape[-1], device=labels.device)
    onehot = (labels[..., None] == classes).to(logp.dtype)
    return -(onehot * logp).sum(-1)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization over the last axis, computed in float32 whatever
    the input dtype and cast back to it (the reference's ``rmsnorm``)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """``rmsnorm`` with its scale (ones at init) as ``weight``."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight)
