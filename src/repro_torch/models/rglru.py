"""Griffin / RecurrentGemma recurrent block (RG-LRU, arXiv:2402.19427), in
PyTorch.

Counterpart of ``repro/models/rglru.py``.  Block: x -> [branch 1: linear
-> tanh-GELU] ⊙ [branch 2: linear -> causal conv -> RG-LRU] -> out
projection.  The RG-LRU recurrence (diagonal, input-gated):

    r_t = sigmoid(u_t W_r);  i_t = sigmoid(u_t W_i)
    a_t = exp(-c · softplus(Λ) · r_t)            (0 < a_t < 1, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

The weights keep the reference's names and layout (``w_x`` / ``w_gate``
(d, w), ``conv_w`` (K, w), ``conv_b`` (w,), ``w_r`` / ``w_i`` (w, w),
float32 ``lambda`` (w,), ``out`` (w, d)) and multiply as ``x @ W``.

The reference scans with ``jax.lax.associative_scan``; the port runs the
same combine, ``(a1, b1) ∘ (a2, b2) = (a1 a2, b1 a2 + b2)``, as a
Hillis–Steele scan over the sequence (``linear_scan``): ceil(log2 S)
doubling steps on whole tensors, 11 at S = 2048.  The combination order
differs from ``associative_scan``'s, so the two agree within float32
rounding, not bitwise.  The scan multiplies the a's themselves: their
products may underflow to 0, which is then their value, where a
cumulative product in log space would not be exact.

Cast points follow the reference, since at bfloat16 they decide parity:
the projections and the forward's causal conv run in the compute dtype;
the gates, ``a`` and the scan in float32; ``h`` is cast to the compute
dtype before the gate branch multiplies it.  Decode convolves in float32
over the float32 conv state (``rglru.py:143-146``).  The states are
float32: ``h`` (B, w) and ``conv`` (B, K-1, w), the last K-1 pre-conv
rows (zeros before the sequence, where it is shorter than K-1).

The conv, the gates' elementwise part and the scan each run under a
``record_function`` range (``rglru.conv``, ``rglru.gates``,
``rglru.scan``), which a profile reads to split device time by stage;
the products run outside them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..nn.core import draw_device, trunc_normal_param
from .config import ArchConfig

__all__ = ["RGLRU", "causal_conv", "init_rglru_state", "linear_scan"]

_C = 8.0


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence: x (B, S, C), w (K, C), b
    (C,) -> sum_k pad[:, t + k] * w[k] + b, in x's dtype."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i : i + S, :] * w[i] for i in range(K)) + b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for a, b (B, S,
    ...): a Hillis–Steele scan of the reference's combine, each step
    ``h[t] += a[t] · h[t - s]`` and ``a[t] *= a[t - s]`` for s = 1, 2, 4,
    ... (the a's of the last step are not needed).  Two pairs of buffers
    take turns, so the inputs are not written; under autograd each step
    makes its tensors anew (the same operations, so the same values)."""
    S = a.shape[1]
    if S == 1:
        return b.clone()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        h, s = b, 1
        while s < S:
            h = torch.cat([h[:, :s], torch.addcmul(h[:, s:], a[:, s:], h[:, :-s])], dim=1)
            if 2 * s < S:
                a = torch.cat([a[:, :s], torch.mul(a[:, s:], a[:, :-s])], dim=1)
            s *= 2
        return h
    bufs_a = (torch.empty_like(a), torch.empty_like(a))
    bufs_h = (torch.empty_like(b), torch.empty_like(b))
    h, turn, s = b, 0, 1
    while s < S:
        nh = bufs_h[turn]
        nh[:, :s] = h[:, :s]
        torch.addcmul(h[:, s:], a[:, s:], h[:, :-s], out=nh[:, s:])
        if 2 * s < S:
            na = bufs_a[turn]
            na[:, :s] = a[:, :s]
            torch.mul(a[:, s:], a[:, :-s], out=na[:, s:])
            a = na
        h, turn, s = nh, 1 - turn, 2 * s
    return h


class RGLRU(nn.Module):
    """One recurrent block, drawn from ``generator`` with the reference's
    distributions (``init_rglru_block``): truncated normals of std
    1/sqrt(fan_in) (0.5 for ``conv_w``), ``conv_b`` zero, and Λ the inverse
    softplus of -log(a) / 8 for a = 0.9 + 0.099 · U(0, 1)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        hy = cfg.hybrid
        d = cfg.d_model
        w = hy.lru_width or d
        pd = getattr(torch, cfg.param_dtype)
        self.cd = getattr(torch, cfg.compute_dtype)

        def param(shape, std):
            return trunc_normal_param(shape, std, generator, device=device, dtype=pd)

        self.w_x = param((d, w), 1.0 / math.sqrt(d))
        self.w_gate = param((d, w), 1.0 / math.sqrt(d))
        self.conv_w = param((hy.conv_kernel, w), 0.5)
        self.conv_b = nn.Parameter(torch.zeros(w, dtype=pd, device=device))
        self.w_r = param((w, w), 1.0 / math.sqrt(w))
        self.w_i = param((w, w), 1.0 / math.sqrt(w))
        u = torch.rand(w, generator=generator, dtype=torch.float32,
                       device=draw_device(generator, device))
        a_init = 0.9 + 0.099 * u
        lam = torch.log(torch.expm1(-torch.log(a_init) / _C))
        self.register_parameter("lambda", nn.Parameter(lam.to(device)))
        self.out = param((w, d), 1.0 / math.sqrt(w))

    def _gates(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """u (B, S, w) in the compute dtype -> (a, gated input), float32."""
        cd = self.cd
        r_lin, i_lin = u @ self.w_r.to(cd), u @ self.w_i.to(cd)
        with record_function("rglru.gates"):
            r = torch.sigmoid(r_lin).float()
            i = torch.sigmoid(i_lin).float()
            a = torch.exp(-_C * F.softplus(getattr(self, "lambda")) * r)
            gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
        return a, gated

    def forward(self, x: torch.Tensor, return_state: bool = False):
        """x (B, S, d) -> (B, S, d) in the compute dtype; with
        ``return_state`` also {"h": (B, w), "conv": (B, K-1, w)} float32."""
        cd = self.cd
        x = x.to(cd)
        gate = F.gelu(x @ self.w_gate.to(cd), approximate="tanh")
        u_pre = x @ self.w_x.to(cd)
        with record_function("rglru.conv"):
            u = causal_conv(u_pre, self.conv_w.to(cd), self.conv_b.to(cd))
        a, gated = self._gates(u)
        with record_function("rglru.scan"):
            h = linear_scan(a, gated)
        out = (h.to(cd) * gate) @ self.out.to(cd)
        if not return_state:
            return out
        K, S = self.conv_w.shape[0], x.shape[1]
        conv = F.pad(u_pre[:, -(K - 1):], (0, 0, max(0, K - 1 - S), 0)).float()
        return out, {"h": h[:, -1].clone(), "conv": conv}

    def decode(self, x: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token: x (B, 1, d); state ``h`` (B, w) and ``conv`` (B, K-1,
        w), float32.  Returns (out (B, 1, d), the new state)."""
        cd = self.cd
        x = x.to(cd)
        gate = F.gelu(x @ self.w_gate.to(cd), approximate="tanh")
        u = x @ self.w_x.to(cd)  # (B, 1, w)
        with record_function("rglru.conv"):
            hist = torch.cat([state["conv"], u.float()], dim=1)  # (B, K, w)
            conv = (hist * self.conv_w.float()).sum(1) + self.conv_b.float()
        a, gated = self._gates(conv[:, None, :].to(cd))
        with record_function("rglru.scan"):
            h = a[:, 0] * state["h"] + gated[:, 0]
        out = (h[:, None, :].to(cd) * gate) @ self.out.to(cd)
        return out, {"h": h, "conv": hist[:, 1:]}


def init_rglru_state(cfg: ArchConfig, n_rec_layers: int, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    """Zero decode state of ``n_rec_layers`` recurrent blocks, float32:
    ``h`` (L, B, w) and ``conv`` (L, B, K-1, w)."""
    hy = cfg.hybrid
    w = hy.lru_width or cfg.d_model
    f32 = torch.float32
    return {"h": torch.zeros((n_rec_layers, batch, w), dtype=f32, device=device),
            "conv": torch.zeros((n_rec_layers, batch, hy.conv_kernel - 1, w), dtype=f32,
                                device=device)}
