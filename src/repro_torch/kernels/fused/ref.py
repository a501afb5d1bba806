"""Plain PyTorch version of the fused feature kernel.

The CPU path and the on-card check of ``csrc/fused_features.cu``.  Both
scans are the vectorized lag gathers of ``kernels/features/ref.py``
(``branch_scan`` / ``memory_scan``) with the carried state threaded
through, and the per-instruction features are the staged path's
(``kernels/features/ops.py::_per_instruction_device``).  The outputs are
copies and int64 subtractions rounded to float32 through float64, so they
are bitwise the reference's sequential scan
(``repro/kernels/fused/ref.py::fused_scan_ref``) wherever that scan's int32
deltas are exact, and the NumPy specification's for any address.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..features.ops import _per_instruction_device
from ..features.ref import branch_scan, memory_scan, signed_log

__all__ = ["fused_features_plain", "fused_scan_plain"]


def fused_scan_plain(
    bucket: torch.Tensor,
    addr: torch.Tensor,
    is_branch: torch.Tensor,
    taken: torch.Tensor,
    is_mem: torch.Tensor,
    table: torch.Tensor,
    mq: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both scans over one pass with the state threaded explicitly: returns
    ``(brhist, memdist_raw, table_out, mq_out)`` (raw int64 deltas rounded
    to float32; the inputs are not modified)."""
    brhist, table_out = branch_scan(bucket, is_branch, taken, table)
    raw, mq_out = memory_scan(addr, is_mem, mq)
    return brhist, raw, table_out, mq_out


def fused_features_plain(
    cols: Dict[str, torch.Tensor], table: torch.Tensor, mq: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """What ``fused_features_cuda`` computes, on any device: returns
    ``(regbits, flags, brhist, memdist, table_out, mq_out)`` with memdist
    signed-log compressed; the inputs are not modified."""
    regbits, flags, _, _ = _per_instruction_device(
        cols["opcode"], cols["dst"], cols["src1"], cols["src2"],
        cols["is_branch"], cols["taken"], cols["is_mem"], cols["is_store"],
    )
    brhist, raw, table_out, mq_out = fused_scan_plain(
        cols["bucket"], cols["addr"], cols["is_branch"], cols["taken"],
        cols["is_mem"], table, mq,
    )
    return regbits, flags, brhist, signed_log(raw), table_out, mq_out
