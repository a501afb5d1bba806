"""ctypes binding of the hand-written fused feature kernel
(``csrc/fused_features.cu``).

The CUDA counterpart of ``repro/kernels/fused/kernel.py``
(``fused_feature_kernel``); the source's header says how the two scans are
laid out on the card and what bounds the kernel.  ``FUSED_FEATURES.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ...uarch.isa import NUM_REGS
from .._cuda import CudaKernel

__all__ = ["COLUMN_KEYS", "FUSED_FEATURES", "N_FLAGS", "fused_features_cuda"]

# the raw trace columns of one pass, in kernel argument order
COLUMN_KEYS = (
    "bucket", "addr", "opcode", "dst", "src1", "src2",
    "is_branch", "taken", "is_mem", "is_store",
)
_DTYPES = {"addr": torch.int64, "bucket": torch.int32, "opcode": torch.int32,
           "dst": torch.int32, "src1": torch.int32, "src2": torch.int32}
N_FLAGS = 5

_P, _I = ctypes.c_void_p, ctypes.c_int
FUSED_FEATURES = CudaKernel(
    "fused_features.cu", "tao_fused_features", [_P] * 18 + [_I] * 4
)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


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
        _check(k, cols[k], _DTYPES.get(k, torch.bool), (n,))
    _check("table", table, torch.float32, (n_buckets, n_queue))
    _check("mq", mq, torch.int64, (1, n_mem + 1))
    if not 1 <= n_queue <= 32:
        raise ValueError(f"the kernel holds one queue slot per lane: n_queue={n_queue} must be 1..32")
    if n_mem < 1:
        raise ValueError(f"n_mem must be >= 1, got {n_mem}")
    dev = table.device
    outs = [
        torch.empty((n, w), device=dev, dtype=torch.float32)
        for w in (NUM_REGS, N_FLAGS, n_queue, n_mem)
    ]
    if n == 0:
        return (*outs, table.clone(), mq.clone())
    table_out = torch.empty_like(table)
    mq_out = torch.empty_like(mq)
    FUSED_FEATURES.launch(
        *(cols[k].data_ptr() for k in COLUMN_KEYS),
        table.data_ptr(), table_out.data_ptr(), mq.data_ptr(), mq_out.data_ptr(),
        *(o.data_ptr() for o in outs),
        n, n_buckets, n_queue, n_mem,
    )
    return (*outs, table_out, mq_out)
