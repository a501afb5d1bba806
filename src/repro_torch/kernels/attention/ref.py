"""Plain PyTorch versions of the attention kernel and its backward.

Materializes the full score matrix; the CPU path and the on-card check of
``csrc/attention.cu``.  Same semantics as the reference's
``repro/kernels/attention/ref.py::attention_ref``: masked scores are filled
with -1e30 (the kernel's NEG_INF), and rows that see no key finalize to 0.
``attention_lse_plain`` is the kernel's optional second output, each row's
log-sum-exp in base 2 (+inf for a row that sees no key), and
``attention_bwd_plain`` the gradients from the explicit formulas, what
``csrc/attention_bwd.cu`` is held to.  On the CPU the trainer needs
neither: autograd differentiates ``attention_plain``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "attention_bwd_plain", "attention_lse_plain", "attention_plain"]

NEG_INF = -1e30
LOG2E = 1.4426950408889634


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
    s, mask = _scores(q, k, segment_ids, causal, q_offset)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros((), device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def attention_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """(B,H,Sq) base-2 log-sum-exp of each row's visible scores,
    ``log2(sum 2^(s log2(e)))``; +inf for a row that sees no key."""
    s, mask = _scores(q, k, segment_ids, causal, q_offset)
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1) * LOG2E
    return torch.where(mask.any(dim=-1), lse, torch.full((), math.inf, device=q.device))


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
):
    """(dq, dk, dv) of ``o = attention_plain(q, k, v, causal=causal)``
    given ``lse`` and ``do``, the gradient of ``o``; (B,H,S,D) operands,
    no segment ids, q_offset 0.  The explicit formulas the kernel
    computes: P = 2^(s log2(e) - lse), delta = rowsum(do o), dv = Pᵀ do,
    dS = P (do vᵀ - delta), dq = dS k / sqrt(D), dk = dSᵀ q / sqrt(D)."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s, mask = _scores(q, k, None, causal, 0)
    p = torch.where(mask, torch.exp2(s * LOG2E - lse[..., None]), torch.zeros((), device=q.device))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq, dk, dv


def _scores(q, k, segment_ids, causal, q_offset):
    """Scaled scores q kᵀ / sqrt(D) and the visibility mask (B|1,1,Sq,Sk)."""
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
    return s, mask
