"""ctypes binding of the hand-written attention kernel (``csrc/attention.cu``).

The CUDA counterpart of ``repro/kernels/attention/kernel.py:38``
(``flash_attention_kernel``).  Both products, ``Q Kᵀ`` and ``P V``, run on
the tensor cores as ``mma.sync.m16n8k8`` TF32 tiles in the 3xTF32 split
(each float32 operand as a TF32 high part plus its TF32 remainder, three
products accumulated in float32): float32-level error, where plain TF32's
10-bit mantissa would break the port's rule that parity paths keep full
float32 products.  A warp owns 16 query rows and a block up to 9 warps, so
a Tao window of 129 rows is one block; keys stream through shared memory
in double-buffered 64-key ``cp.async`` tiles, and the online softmax runs
on the accumulator fragments.  At the Tao shape neither the bytes (5.0 µs
for q, k, v and out over 3.35 TB/s) nor the tensor cores bound it, but the
latency of the longest warp's chain of dependent steps; the source's
header says why and ``PERF.md`` what it measured.

q, k and v are taken at their strides (the last dimension contiguous), and
the output is allocated as (B, Sq, H, Dv) and returned as its
(B, H, Sq, Dv) view, so the Tao block neither copies its packed projection
apart nor its output back together.  ``FLASH_ATTENTION.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .._cuda import CudaKernel

__all__ = ["FLASH_ATTENTION", "MAX_HEAD_DIM", "flash_attention_cuda", "launch_info"]

# widest q/k and v head the kernel takes (its register accumulators)
MAX_HEAD_DIM = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH_ATTENTION = CudaKernel(
    "attention.cu",
    "tao_flash_attention",
    [_P] * 5 + [_L] * 12 + [_I] * 8 + [ctypes.c_float],
)
_LAUNCH_INFO = CudaKernel(
    "attention.cu", "tao_flash_attention_info", [_I] * 4 + [ctypes.POINTER(ctypes.c_int)]
)
_INFO_KEYS = ("regs_per_thread", "smem_bytes_per_block", "threads_per_block",
              "blocks_per_sm", "spill_bytes_per_thread", "query_blocks")


def _check(name: str, t: torch.Tensor) -> None:
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension, got strides {t.stride()}")
    if not (t.is_cuda and t.dtype == torch.float32):
        raise ValueError(f"{name} must be a float32 CUDA tensor")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """q (B,H,Sq,D), k (B,H,Sk,D), v (B,H,Sk,Dv): float32 CUDA tensors at
    any strides with a contiguous last dimension; ``segment_ids`` (B,Sk)
    int32 or None.  Returns (B,H,Sq,Dv), the transposed view of a
    contiguous (B,Sq,H,Dv) tensor."""
    B, H, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t)
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
    out = torch.empty((B, Sq, H, Dv), device=q.device, dtype=torch.float32).transpose(1, 2)
    FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, H, Sq, Sk, D, Dv, int(causal), q_offset, 1.0 / math.sqrt(D),
    )
    return out


def launch_info(Sq: int, D: int, Dv: int, segmented: bool = False) -> Dict[str, int]:
    """What a launch of the kernel for (Sq, D, Dv) gets on the current
    device, without launching it: registers and spill bytes per thread
    (``cudaFuncGetAttributes``), dynamic shared memory and threads per
    block, resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    and query blocks per (batch, head)."""
    info = (ctypes.c_int * len(_INFO_KEYS))()
    err = _LAUNCH_INFO._entry()(Sq, D, Dv, int(segmented), info, None)
    if err != 0:
        raise RuntimeError(f"tao_flash_attention_info: CUDA error {err}")
    return dict(zip(_INFO_KEYS, info))
