"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE, in
PyTorch.

Counterpart of ``repro/models/rotary.py`` (``rope_freqs``, ``apply_rope``,
``text_mrope_positions``, ``apply_mrope``).  The angles are float32;
``cos`` and ``sin`` are cast to ``x``'s dtype before the products, as the
reference casts them, so a bfloat16 ``x`` rotates in bfloat16.  M-RoPE
splits the head_dim/2 frequencies into (temporal, height, width) sections,
each rotated by its own position stream; on text the three streams
coincide and M-RoPE is RoPE, bitwise.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["apply_mrope", "apply_rope", "rope_freqs", "text_mrope_positions"]


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


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, S) or (S,) -> (3, B, S): the t / h / w streams coincide for text."""
    if positions.ndim == 1:
        positions = positions[None, :]
    return positions[None].expand(3, *positions.shape)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: Tuple[int, int, int],
                theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, S, D); positions3: (3, B, S); ``sections`` sum to D/2: the
    first ``sections[0]`` frequencies take stream 0's angles, the next
    ``sections[1]`` stream 1's, the last stream 2's."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions3[..., None].to(torch.float32) * freqs  # (3,B,S,D/2)
    bounds = [0, sections[0], sections[0] + sections[1], half]
    angles = torch.cat([ang[i, ..., bounds[i] : bounds[i + 1]] for i in range(3)], dim=-1)
    return _rotate(x, angles[:, None])
