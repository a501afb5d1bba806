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
launches.  With ``return_lse`` the kernel also writes each row's
log-sum-exp in base 2 (``m + log2(l)`` in the units of the scores it
exponentiates, +inf for a row that sees no key), what the backward needs.

``flash_attention_bwd_cuda`` binds the backward (``csrc/attention_bwd.cu``),
the port's own kernel, for what the Tao trainer gives it (causal or not,
no segment ids, q_offset 0, Sq == Sk, D == Dv <= 128): three kernels on
one stream (delta = rowsum(dO o), dK / dV per key tile, dQ per query
tile), plain float32 FMAs, no atomics, so two calls give the same bits.
``FLASH_ATTENTION_BWD.launches`` counts its calls.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .._cuda import CudaKernel, check_cuda_tensor

__all__ = [
    "FLASH_ATTENTION",
    "FLASH_ATTENTION_BWD",
    "MAX_HEAD_DIM",
    "flash_attention_bwd_cuda",
    "flash_attention_cuda",
    "launch_info",
]

# widest q/k and v head the kernel takes (its register accumulators)
MAX_HEAD_DIM = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH_ATTENTION = CudaKernel(
    "attention.cu",
    "tao_flash_attention",
    [_P] * 6 + [_L] * 12 + [_I] * 8 + [ctypes.c_float],
)
FLASH_ATTENTION_BWD = CudaKernel(
    "attention_bwd.cu",
    "tao_flash_attention_bwd",
    [_P] * 10 + [ctypes.POINTER(_L)] + [_I] * 5 + [ctypes.c_float],
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
    return_lse: bool = False,
):
    """q (B,H,Sq,D), k (B,H,Sk,D), v (B,H,Sk,Dv): float32 CUDA tensors at
    any strides with a contiguous last dimension; ``segment_ids`` (B,Sk)
    int32 or None.  Returns (B,H,Sq,Dv), the transposed view of a
    contiguous (B,Sq,H,Dv) tensor, and with ``return_lse`` also the
    (B,H,Sq) float32 base-2 log-sum-exp of each row."""
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
    lse = torch.empty((B, H, Sq), device=q.device, dtype=torch.float32) if return_lse else None
    FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, H, Sq, Sk, D, Dv, int(causal), q_offset, 1.0 / math.sqrt(D),
    )
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of the attention ``out = flash_attention_cuda(
    q, k, v, causal=causal)`` given ``lse`` (its ``return_lse``) and the
    gradient ``dout`` of ``out``.  All (B,H,S,D) float32 CUDA tensors at
    any strides with a contiguous last dimension (``lse`` (B,H,S)
    contiguous); each gradient is the (B,H,S,D) view of a contiguous
    (B,S,H,D) tensor."""
    B, H, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        _check(name, t)
        if t.shape != (B, H, S, D):
            raise ValueError(f"{name} must have shape {(B, H, S, D)}, got {tuple(t.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim D={D} outside 1..{MAX_HEAD_DIM}")
    check_cuda_tensor("lse", lse, torch.float32, (B, H, S))
    grads = [torch.empty((B, S, H, D), device=q.device, dtype=torch.float32).transpose(1, 2)
             for _ in range(3)]
    delta = torch.empty((B, H, S), device=q.device, dtype=torch.float32)
    tensors = (q, k, v, out, dout, *grads)
    strides = (_L * 24)(*(s for t in tensors for s in t.stride()[:3]))
    FLASH_ATTENTION_BWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), *(g.data_ptr() for g in grads), delta.data_ptr(), strides,
        B, H, S, D, int(causal), 1.0 / math.sqrt(D),
    )
    return tuple(grads)


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
