"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060), in PyTorch.

Counterpart of ``repro/models/mamba2.py``.  Layout: x (B, S, d_model) ->
``in_proj`` -> [z | xBC | dt]; a depthwise causal conv + SiLU over xBC;
the SSD scan over H = d_inner / head_dim heads with state size N; the D
skip, a gated RMS norm and ``out_proj``.  The prefill path runs the chunked
scan through ``kernels/ssd/ops.ssd_scan`` — the hand-written kernel on the
card, whatever the reference's ``use_pallas`` would say — and the kernel
also writes the final state the decode path starts from.  Decode is the
O(1) state update in plain PyTorch, as in the reference (no kernel there).

Cast points follow the reference, since at bfloat16 they decide parity:
the projections run in the compute dtype, dt is float32 through softplus
and rounded to the compute dtype before the scan, A stays float32, y comes
back in the compute dtype and the states are float32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd.ops import ssd_scan
from ..nn.core import RMSNorm, draw_device, rmsnorm, trunc_normal_param
from .config import ArchConfig

__all__ = ["Mamba2", "init_ssm_state"]


def _linear(in_dim: int, out_dim: int, weight: nn.Parameter) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim, bias=False, device="meta")
    layer.weight = weight
    return layer


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, then SiLU.  xbc (B, S, C),
    w (K, C): sum_k pad[:, t + k, c] * w[k, c]."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i : i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], dim=1) if pad else t


class Mamba2(nn.Module):
    """One Mamba-2 mixer.  Parameters: ``in_proj`` / ``out_proj``
    (``nn.Linear``, the reference's ``(in, out)`` weights transposed),
    ``conv_w`` (K, C), ``conv_b`` (C,), float32 ``A_log``, ``dt_bias`` and
    ``D`` (H,), and ``gate_norm``.  Initialization draws from ``generator``
    with the reference's distributions (``init_mamba2``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        self.cfg = cfg
        self.d_inner = din = s.d_inner(d)
        self.n_heads = H = s.n_heads(d)
        G, N = s.n_groups, s.d_state
        self.conv_dim = din + 2 * G * N
        pd = getattr(torch, cfg.param_dtype)
        f32 = torch.float32
        self.in_proj = _linear(d, 2 * din + 2 * G * N + H, trunc_normal_param(
            (2 * din + 2 * G * N + H, d), 1.0 / math.sqrt(d), generator, device=device, dtype=pd))
        self.conv_w = trunc_normal_param((s.conv_kernel, self.conv_dim), 0.5, generator,
                                         device=device, dtype=pd)
        self.conv_b = nn.Parameter(torch.zeros(self.conv_dim, dtype=pd, device=device))
        self.A_log = nn.Parameter(torch.log(torch.arange(1, H + 1, dtype=f32, device=device)))
        # dt bias such that softplus(dt_bias) spans [dt_min, dt_max]
        u = torch.rand(H, generator=generator, dtype=f32, device=draw_device(generator, device))
        u = u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min)
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(torch.exp(u))).to(device))
        self.D = nn.Parameter(torch.ones(H, dtype=f32, device=device))
        self.gate_norm = RMSNorm(din, dtype=pd, device=device)
        self.out_proj = _linear(din, d, trunc_normal_param(
            (d, din), 1.0 / math.sqrt(din), generator, device=device, dtype=pd))

    @property
    def _cd(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _split_proj(self, x: torch.Tensor):
        s = self.cfg.ssm
        din, GN = self.d_inner, s.n_groups * s.d_state
        zxbcdt = F.linear(x.to(self._cd), self.in_proj.weight.to(self._cd))
        return zxbcdt[..., :din], zxbcdt[..., din : 2 * din + 2 * GN], zxbcdt[..., 2 * din + 2 * GN :]

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        y = rmsnorm(y * F.silu(z), self.gate_norm.weight)
        return F.linear(y, self.out_proj.weight.to(self._cd))

    def forward(self, x: torch.Tensor, return_state: bool = False):
        """x (B, S, d_model) -> (B, S, d_model); with ``return_state`` also
        the layer's decode state {"ssm": (B,H,N,P), "conv": (B,K-1,C)}."""
        s, cd = self.cfg.ssm, self._cd
        B, S, _ = x.shape
        din, H, G, N = self.d_inner, self.n_heads, s.n_groups, s.d_state
        z, xbc_raw, dt_raw = self._split_proj(x)
        xbc = _causal_conv(xbc_raw, self.conv_w.to(cd), self.conv_b.to(cd))
        xh = xbc[..., :din].reshape(B, S, H, s.head_dim)
        Bm = xbc[..., din : din + G * N].reshape(B, S, G, N)
        Cm = xbc[..., din + G * N :].reshape(B, S, G, N)
        dt = F.softplus(dt_raw.float() + self.dt_bias)  # (B, S, H)
        A = -torch.exp(self.A_log)
        # pad to a chunk multiple: dt = 0 rows are exact no-ops (decay
        # exp(0) = 1, no contribution to the state or the output)
        pad = (-S) % s.chunk
        out = ssd_scan(
            _pad_seq(xh, pad), _pad_seq(dt, pad).to(cd), A, _pad_seq(Bm, pad), _pad_seq(Cm, pad),
            chunk=s.chunk, return_state=return_state,
        )
        y, state = out if return_state else (out, None)
        y = y[:, :S] + xh * self.D[None, None, :, None].to(cd)
        out = self._out(y.reshape(B, S, din), z)
        if not return_state:
            return out
        # conv state: the last K-1 pre-conv rows (zeros before the sequence)
        K = s.conv_kernel
        conv_state = F.pad(xbc_raw[:, -(K - 1):], (0, 0, max(0, K - 1 - S), 0)).float()
        return out, {"ssm": state, "conv": conv_state}

    def decode(self, x: torch.Tensor, state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """One token: x (B, 1, d_model); state["ssm"] (B,H,N,P) and
        state["conv"] (B,K-1,C), float32.  Returns (out, new state)."""
        s, cd = self.cfg.ssm, self._cd
        B = x.shape[0]
        din, H, G, N = self.d_inner, self.n_heads, s.n_groups, s.d_state
        z, xbc, dt_raw = self._split_proj(x)
        # broadcasts and one matmul rather than einsums: a step is ~30 host
        # calls per layer, and the host sets its time
        hist = torch.cat([state["conv"], xbc.float()], dim=1)  # (B, K, C)
        conv_out = (hist * self.conv_w.float()).sum(1) + self.conv_b.float()
        xbc1 = F.silu(conv_out)[:, None, :].to(cd)
        xh = xbc1[..., :din].reshape(B, H, s.head_dim)
        rep = H // G
        Bh = xbc1[..., din : din + G * N].reshape(B, G, 1, N).expand(B, G, rep, N).reshape(B, H, N)
        Ch = xbc1[..., din + G * N :].reshape(B, G, 1, N).expand(B, G, rep, N).reshape(B, H, 1, N)
        dt = F.softplus(dt_raw[:, 0].float() + self.dt_bias)  # (B, H)
        decay = torch.exp(dt * -torch.exp(self.A_log)[None, :])
        st = state["ssm"] * decay[..., None, None] + (dt[..., None] * Bh.float())[..., None] * xh.float()[:, :, None, :]
        y = (Ch.float() @ st)[:, :, 0].to(cd)
        y = y + xh * self.D[None, :, None].to(cd)
        return self._out(y.reshape(B, 1, din), z), {"ssm": st, "conv": hist[:, 1:]}


def init_ssm_state(cfg: ArchConfig, n_layers: int, batch: int, device) -> Dict[str, torch.Tensor]:
    """Zero decode state of ``n_layers`` Mamba-2 layers, float32."""
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    f32 = torch.float32
    return {
        "ssm": torch.zeros((n_layers, batch, H, s.d_state, s.head_dim), dtype=f32, device=device),
        "conv": torch.zeros((n_layers, batch, s.conv_kernel - 1, conv_dim), dtype=f32, device=device),
    }
