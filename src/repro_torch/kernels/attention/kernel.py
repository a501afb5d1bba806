"""ctypes binding of the hand-written attention kernel (``csrc/attention.cu``).

The CUDA counterpart of ``repro/kernels/attention/kernel.py``
(``flash_attention_kernel``); the source's header says how it is laid out
and what bounds it.  ``FLASH_ATTENTION.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._cuda import CudaKernel

__all__ = ["FLASH_ATTENTION", "MAX_HEAD_DIM", "flash_attention_cuda"]

# widest q/k and v head the kernel takes (its register accumulators)
MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
FLASH_ATTENTION = CudaKernel(
    "attention.cu",
    "tao_flash_attention",
    [_P] * 5 + [_I] * 8 + [ctypes.c_float],
)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """q (B,H,Sq,D), k (B,H,Sk,D), v (B,H,Sk,Dv): contiguous float32 CUDA
    tensors; ``segment_ids`` (B,Sk) int32 or None.  Returns (B,H,Sq,Dv)."""
    B, H, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
    if k.shape != (B, H, Sk, D) or v.shape != (B, H, Sk, Dv):
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv} outside 1..{MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    seg_ptr = None
    if segment_ids is not None:
        if segment_ids.shape != (B, Sk):
            raise ValueError(f"segment_ids must be (B, Sk)=({B}, {Sk}), got {tuple(segment_ids.shape)}")
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        seg_ptr = segment_ids.data_ptr()
    out = torch.empty((B, H, Sq, Dv), device=q.device, dtype=torch.float32)
    FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, out.data_ptr(),
        B, H, Sq, Sk, D, Dv, int(causal), q_offset, 1.0 / math.sqrt(D),
    )
    return out
