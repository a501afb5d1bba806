"""Plain PyTorch version of the attention kernel.

Materializes the full score matrix; the CPU path and the on-card check of
``csrc/attention.cu``.  Same semantics as the reference's
``repro/kernels/attention/ref.py::attention_ref``: masked scores are filled
with -1e30 (the kernel's NEG_INF), and rows that see no key finalize to 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "attention_plain"]

NEG_INF = -1e30


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """q,k,v: (B,H,S,D); returns (B,H,Sq,Dv) float32.  Optional
    ``segment_ids`` (B, Sk): rows attend only within their own segment; a
    query row whose absolute position ``q_offset + row`` is past Sk has
    segment -2."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    if causal:
        kpos = torch.arange(Sk, device=q.device)
        mask &= (qpos[:, None] >= kpos[None, :])[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32)
        segq = torch.full((B, Sq), -2, dtype=torch.int32, device=q.device)
        inside = qpos < Sk
        segq[:, inside] = seg[:, qpos[inside]]
        mask &= (segq[:, :, None] == seg[:, None, :])[:, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros((), device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())
