"""ctypes binding of the hand-written fused feature kernel
(``csrc/fused_features.cu``).

The CUDA counterpart of ``repro/kernels/fused/kernel.py``
(``fused_feature_kernel``); the source's header says how the two scans are
laid out on the card and what bounds the kernel.  One call of the C entry
point enqueues ``KERNELS_PER_CALL`` kernels on the current stream and is
counted once by ``FUSED_FEATURES.launches``.  The wrapper allocates the
outputs and the passes' scratch; the scratch size mirrors the source's
``fused_scratch_bytes`` (the entry point refuses less).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ...uarch.isa import NUM_REGS
from .._cuda import CudaKernel, check_cuda_tensor

__all__ = [
    "COLUMN_KEYS",
    "FUSED_FEATURES",
    "KERNELS_PER_CALL",
    "N_FLAGS",
    "RANK_TILE",
    "SMEM_BUCKETS",
    "fused_features_cuda",
]

# the raw trace columns of one pass, in kernel argument order
COLUMN_KEYS = (
    "bucket", "addr", "opcode", "dst", "src1", "src2",
    "is_branch", "taken", "is_mem", "is_store",
)
_DTYPES = {"addr": torch.int64, "bucket": torch.int32, "opcode": torch.int32,
           "dst": torch.int32, "src1": torch.int32, "src2": torch.int32}
N_FLAGS = 5

# the source's kRankTile and kSmemBuckets (tests hold them equal)
RANK_TILE = 256         # positions per rank tile
SMEM_BUCKETS = 49152    # up to this N_b the per-bucket counters sit in shared memory
KERNELS_PER_CALL = 5    # fx_rank, fx_offsets, fx_scan, fx_place, fx_write

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
FUSED_FEATURES = CudaKernel(
    "fused_features.cu", "tao_fused_features", [_P] * 19 + [_S] + [_I] * 4
)


def _scratch_bytes(n: int, n_buckets: int) -> int:
    tiles = -(-n // RANK_TILE)
    return 8 * n + 4 * (3 * n + tiles * n_buckets + tiles + 2 * n_buckets + 1)


def fused_features_cuda(
    cols: Dict[str, torch.Tensor], table: torch.Tensor, mq: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """One pass over ``n`` positions.  ``cols``: the ten (n,) columns
    (``addr`` int64, the other four ids int32, torch.bool for the four
    flags); ``table`` (N_b, N_q) float32 and ``mq`` (1, N_m + 1) int64,
    both read only.  Returns ``(regbits, flags, brhist, memdist,
    table_out, mq_out)`` — memdist signed-log compressed, then the
    outgoing state — as ``ref.fused_features_plain`` does."""
    n = cols["bucket"].shape[0]
    n_buckets, n_queue = table.shape
    n_mem = mq.shape[1] - 1
    for k in COLUMN_KEYS:
        check_cuda_tensor(k, cols[k], _DTYPES.get(k, torch.bool), (n,))
    check_cuda_tensor("table", table, torch.float32, (n_buckets, n_queue))
    check_cuda_tensor("mq", mq, torch.int64, (1, n_mem + 1))
    if min(n_buckets, n_queue, n_mem) < 1:
        raise ValueError(
            f"n_buckets, n_queue and n_mem must be >= 1, got {n_buckets}, {n_queue}, {n_mem}"
        )
    dev = table.device
    outs = [
        torch.empty((n, w), device=dev, dtype=torch.float32)
        for w in (NUM_REGS, N_FLAGS, n_queue, n_mem)
    ]
    if n == 0:
        return (*outs, table.clone(), mq.clone())
    table_out = torch.empty_like(table)
    mq_out = torch.empty_like(mq)
    scratch = torch.empty(_scratch_bytes(n, n_buckets), device=dev, dtype=torch.uint8)
    FUSED_FEATURES.launch(
        *(cols[k].data_ptr() for k in COLUMN_KEYS),
        table.data_ptr(), table_out.data_ptr(), mq.data_ptr(), mq_out.data_ptr(),
        *(o.data_ptr() for o in outs),
        scratch.data_ptr(), scratch.numel(),
        n, n_buckets, n_queue, n_mem,
    )
    return (*outs, table_out, mq_out)
