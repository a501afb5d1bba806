"""Dense MLP blocks (SwiGLU / tanh-GELU), in PyTorch.

Counterpart of ``repro/models/mlp.py``: ``init_mlp``'s distributions and
``mlp_forward``'s cast points (``mlp.py:41-52``): the input and each
weight are cast to the compute dtype, then ``up = x W_up``, ``h =
silu(x W_gate) * up`` (SwiGLU) or ``gelu_tanh(up)``, ``out = h W_down``.
The reference's ``(in, out)`` weights are these layers' ``weight.T``
(``convert.lm_params_from_jax``).  The products are ``F.linear`` (cuBLAS
on the card), as the reference leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import trunc_normal_param

__all__ = ["MLP"]


class MLP(nn.Module):
    """``w_up`` and ``w_down`` (and ``w_gate`` for SwiGLU), each a
    bias-free ``nn.Linear`` drawn from the reference's fan-in truncated
    normal (std 1/sqrt(d_model) in, 1/sqrt(d_ff) out)."""

    def __init__(self, d_model: int, d_ff: int, act: str, generator: torch.Generator, *,
                 param_dtype: torch.dtype, compute_dtype: torch.dtype, device):
        super().__init__()
        if act not in ("swiglu", "gelu"):
            raise ValueError(f"mlp_act {act!r}: have 'swiglu' and 'gelu'")
        self.act, self.cd = act, compute_dtype

        def linear(n_in, n_out, std):
            layer = nn.Linear(n_in, n_out, bias=False, device="meta")
            layer.weight = trunc_normal_param((n_out, n_in), std, generator, device=device,
                                              dtype=param_dtype)
            return layer

        self.w_up = linear(d_model, d_ff, 1.0 / math.sqrt(d_model))
        self.w_down = linear(d_ff, d_model, 1.0 / math.sqrt(d_ff))
        if act == "swiglu":
            self.w_gate = linear(d_model, d_ff, 1.0 / math.sqrt(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.cd
        x = x.to(cd)
        up = F.linear(x, self.w_up.weight.to(cd))
        if self.act == "swiglu":
            h = F.silu(F.linear(x, self.w_gate.weight.to(cd))) * up
        else:
            h = F.gelu(up, approximate="tanh")
        return F.linear(h, self.w_down.weight.to(cd))
