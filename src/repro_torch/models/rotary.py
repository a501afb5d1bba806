"""Rotary position embeddings (RoPE), in PyTorch.

Counterpart of ``repro/models/rotary.py:16-42`` (``rope_freqs``,
``apply_rope``).  The angles are float32; ``cos`` and ``sin`` are cast to
``x``'s dtype before the products, as the reference casts them, so a
bfloat16 ``x`` rotates in bfloat16.  M-RoPE (``apply_mrope``) comes with
the ``vlm`` family (ROADMAP A10.3).
"""
from __future__ import annotations

import torch

__all__ = ["apply_rope", "rope_freqs"]


def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); angles: broadcastable (..., S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) or (S,) integers."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].to(torch.float32) * freqs  # (B,1,S,D/2)
    return _rotate(x, angles)
