"""ctypes bindings of the hand-written SSD scan kernel (``csrc/ssd.cu``)
and of its backward (``csrc/ssd_bwd.cu``).

The CUDA counterpart of ``repro/kernels/ssd/kernel.py`` (``ssd_kernel``).
Its four products run on the tensor cores as ``mma.sync.m16n8k8`` TF32
tiles in a split scheme (each float32 operand as a TF32 high part plus its
TF32 remainder), at float32-level error; bfloat16 operands are exact in
TF32 and need no remainder.  The source's header says how it is laid out
and what bounds it.  ``SSD_SCAN.launches`` counts launches.

The backward (``ssd_scan_bwd_cuda``, ``SSD_SCAN_BWD.launches``) has no
TPU counterpart: the reference differentiates its jnp chunked oracle.
One C call runs its five kernels (``BWD_KERNEL_NAMES``: each chunk's share
of the state recurrences, the recurrences over the chunks, the gradients
inside each chunk, the reverse scan of dcums, the group and dA sums) on
float32 scratch that the wrapper allocates; in bfloat16 the products run
on ``wgmma``, in float32 on split-TF32 ``mma.sync``.  Its source's header
says how.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .._cuda import CudaKernel, check_cuda_tensor

__all__ = [
    "BWD_HEADS_PER_BLOCK", "BWD_KERNEL_NAMES", "BWD_VEC_ROWS", "MAX_CHUNK", "MAX_HEAD_DIM",
    "MAX_STATE", "SSD_SCAN", "SSD_SCAN_BWD", "bwd_heads_per_block", "bwd_launch_info",
    "launch_info", "ssd_scan_bwd_cuda", "ssd_scan_cuda",
]

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
SSD_SCAN_BWD = CudaKernel("ssd_bwd.cu", "tao_ssd_scan_bwd", [_P] * 16 + [_I] * 8)
_BWD_LAUNCH_INFO = CudaKernel("ssd_bwd.cu", "tao_ssd_scan_bwd_info", [_I, ctypes.POINTER(ctypes.c_int)])
# The backward's kernels in launch order: the one list of their names.
# Each is a piece of its kernel's name in either dtype (the profiler finds
# them by it; the bfloat16 chunk kernel is ssd_bwd_chunk_wgmma).
BWD_KERNEL_NAMES = ("ssd_bwd_local", "ssd_bwd_recur", "ssd_bwd_chunk", "ssd_bwd_tail", "ssd_bwd_reduce")
# rows of `chunk` float32 per (batch, chunk, head) in the backward's vecs
# scratch (csrc/ssd_bwd.cu, kVecRows): cums, dt, four per-row sums, ⟨S0,
# dS⟩ and a partial sum per 64-row column tile and warp
BWD_VEC_ROWS = 6 + 4 * (MAX_CHUNK // 64)
# heads a bfloat16 chunk block takes at most (kHeadsPerBlock), its dB and
# dC summed over them before the group sums
BWD_HEADS_PER_BLOCK = 4


def bwd_heads_per_block(H: int, G: int, dtype: torch.dtype) -> int:
    """Heads of one group that a block of the backward's chunk kernel
    takes: in bfloat16 the largest power of two up to BWD_HEADS_PER_BLOCK
    dividing H / G, in float32 one (csrc/ssd_bwd.cu, run)."""
    hpb = 1
    while dtype == torch.bfloat16 and hpb < BWD_HEADS_PER_BLOCK and (H // G) % (2 * hpb) == 0:
        hpb *= 2
    return hpb


def _check_shapes(xh, dt, A, Bm, Cm, chunk):
    """(B, S, H, P, G, N) of the scan's operands; raises unless they are
    contiguous CUDA tensors of one dtype (A float32) that the kernels take."""
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
    return B, S, H, P, G, N


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
    B, S, H, P, G, N = _check_shapes(xh, dt, A, Bm, Cm, chunk)
    y = torch.empty_like(xh)
    state = torch.empty((B, H, N, P), device=xh.device, dtype=torch.float32) if return_state else None
    SSD_SCAN.launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), None if state is None else state.data_ptr(),
        B, S, H, G, N, P, chunk, _DTYPES[xh.dtype],
    )
    return (y, state) if return_state else y


def ssd_scan_bwd_cuda(
    xh: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dy: torch.Tensor,
    *,
    chunk: int,
):
    """Gradients (dx, ddt, dA, dB, dC) of ``ssd_scan_cuda(xh, dt, A, Bm, Cm,
    chunk=chunk)`` against ``dy`` (B,S,H,P), all contiguous CUDA tensors of
    xh's dtype but A (float32); dA comes back float32, the rest in that
    dtype.  The function of ``ref.ssd_chunked_bwd_plain``."""
    B, S, H, P, G, N = _check_shapes(xh, dt, A, Bm, Cm, chunk)
    check_cuda_tensor("dy", dy, xh.dtype, (B, S, H, P))
    nc = S // chunk
    f32 = dict(device=xh.device, dtype=torch.float32)
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (xh, dt, Bm, Cm))
    dA = torch.empty(H, **f32)
    local = torch.empty((2, B, nc, H, N, P), **f32)   # each chunk's share of the states
    states = torch.empty((2, B, nc, H, N, P), **f32)  # S0 and dS of every chunk
    # dB and dC summed over each chunk block's heads, before the group sums
    per_head = torch.empty((2, B, S, H // bwd_heads_per_block(H, G, xh.dtype), N), **f32)
    da_part = torch.empty((B * nc, H), **f32)
    vecs = torch.empty((B * nc * H, BWD_VEC_ROWS, chunk), **f32)  # per-row sums of each chunk
    SSD_SCAN_BWD.launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        local.data_ptr(), states.data_ptr(), per_head.data_ptr(), da_part.data_ptr(),
        vecs.data_ptr(), B, S, H, G, N, P, chunk, _DTYPES[xh.dtype],
    )
    return dx, ddt, dA, dB, dC


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


def bwd_launch_info(dtype: torch.dtype) -> Dict[str, Dict[str, int]]:
    """What each kernel of a backward call in ``dtype`` gets on the current
    device, without launching it: {kernel name (every one of
    ``BWD_KERNEL_NAMES``): the keys of ``launch_info``}.  Shared memory
    does not depend on the shapes (tiles are padded to the limits)."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    n = len(_INFO_KEYS)
    info = (ctypes.c_int * (n * len(BWD_KERNEL_NAMES)))()
    err = _BWD_LAUNCH_INFO._entry()(_DTYPES[dtype], info, None)
    if err != 0:
        raise RuntimeError(f"tao_ssd_scan_bwd_info: CUDA error {err}")
    return {name: dict(zip(_INFO_KEYS, info[i * n:(i + 1) * n]))
            for i, name in enumerate(BWD_KERNEL_NAMES)}
