"""Public attention entry point: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro/kernels/attention/ops.py::flash_attention``.  The
choice follows the tensors' device only: a CUDA tensor always launches the
hand-written kernel (or raises), a CPU tensor takes the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_cuda
from .ref import attention_plain

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention over (B, H, S, D) operands; ``segment_ids`` ((B, Sk) int32,
    optional) confines attention to equal-id spans."""
    if q.is_cuda:
        return flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            causal=causal, q_offset=q_offset,
        )
    return attention_plain(q, k, v, segment_ids, causal=causal, q_offset=q_offset)
