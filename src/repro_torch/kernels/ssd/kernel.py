"""ctypes binding of the hand-written SSD scan kernel (``csrc/ssd.cu``).

The CUDA counterpart of ``repro/kernels/ssd/kernel.py`` (``ssd_kernel``).
Its four products run on the tensor cores as ``mma.sync.m16n8k8`` TF32
tiles in a split scheme (each float32 operand as a TF32 high part plus its
TF32 remainder), at float32-level error; bfloat16 operands are exact in
TF32 and need no remainder.  The source's header says how it is laid out
and what bounds it.  ``SSD_SCAN.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .._cuda import CudaKernel, check_cuda_tensor

__all__ = ["MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE", "SSD_SCAN", "launch_info", "ssd_scan_cuda"]

# what one block holds in shared memory (see csrc/ssd.cu)
MAX_STATE = 128    # d_state N
MAX_HEAD_DIM = 64  # head_dim P
MAX_CHUNK = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
SSD_SCAN = CudaKernel("ssd.cu", "tao_ssd_scan", [_P] * 7 + [_I] * 8)
_LAUNCH_INFO = CudaKernel("ssd.cu", "tao_ssd_scan_info", [_I] * 3 + [ctypes.POINTER(ctypes.c_int)])
_INFO_KEYS = ("regs_per_thread", "smem_bytes_per_block", "threads_per_block",
              "blocks_per_sm", "spill_bytes_per_thread")


def ssd_scan_cuda(
    xh: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int,
    return_state: bool = False,
):
    """xh (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,G,N): contiguous CUDA tensors
    of one dtype (float32 or bfloat16); A (H,) float32.  Returns y
    (B,S,H,P) in that dtype, and with ``return_state`` also the final
    (B,H,N,P) float32 state."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if xh.dtype not in _DTYPES:
        raise ValueError(f"xh must be float32 or bfloat16, got {xh.dtype}")
    check_cuda_tensor("xh", xh, xh.dtype, (B, S, H, P))
    check_cuda_tensor("dt", dt, xh.dtype, (B, S, H))
    check_cuda_tensor("A", A, torch.float32, (H,))
    check_cuda_tensor("Bm", Bm, xh.dtype, (B, S, G, N))
    check_cuda_tensor("Cm", Cm, xh.dtype, (B, S, G, N))
    if not (1 <= N <= MAX_STATE and 1 <= P <= MAX_HEAD_DIM and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(
            f"N={N}, P={P}, chunk={chunk} outside the kernel's limits "
            f"(N <= {MAX_STATE}, P <= {MAX_HEAD_DIM}, chunk <= {MAX_CHUNK})"
        )
    if S % chunk or H % G:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk} and H={H} of G={G}")
    y = torch.empty_like(xh)
    state = torch.empty((B, H, N, P), device=xh.device, dtype=torch.float32) if return_state else None
    SSD_SCAN.launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), None if state is None else state.data_ptr(),
        B, S, H, G, N, P, chunk, _DTYPES[xh.dtype],
    )
    return (y, state) if return_state else y


def launch_info(N: int, chunk: int, dtype: torch.dtype) -> Dict[str, int]:
    """What a launch of the kernel for d_state ``N``, ``chunk`` and I/O
    ``dtype`` gets on the current device, without launching it: registers
    and spill bytes per thread (``cudaFuncGetAttributes``), dynamic shared
    memory and threads per block, and resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    info = (ctypes.c_int * len(_INFO_KEYS))()
    err = _LAUNCH_INFO._entry()(N, chunk, _DTYPES[dtype], info, None)
    if err != 0:
        raise RuntimeError(f"tao_ssd_scan_info: CUDA error {err}")
    return dict(zip(_INFO_KEYS, info))
