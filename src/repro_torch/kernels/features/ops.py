"""Host-side trace preparation and the eager torch signed-log.

``trace_columns`` is the host prep of the device feature path (bucket hash
on the int64 pc; addresses stay int64, so the deltas are exact for any
address, as in the NumPy specification).  ``signed_log`` is the op-per-kernel torch
twin of ``core.features.signed_log``: one rounded float32 op per statement,
never compiled, so it matches the NumPy specification bit for bit on any
device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.features import SIGNED_LOG_COEFFS, SIGNED_LOG_SQRT2, FeatureConfig

__all__ = ["signed_log", "trace_columns"]


# tao: bitwise
def signed_log(d: torch.Tensor) -> torch.Tensor:
    """Bit-exact torch twin of ``core.features.signed_log``.

    Each statement is one eagerly dispatched, individually rounded float32
    op.  Never wrap it in ``torch.compile``: a fused kernel may contract
    `a*b + c` into an fma and differ in the last ulp.
    """
    d = d.to(torch.float32)
    a = torch.abs(d)
    x = a + 1.0
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > float(SIGNED_LOG_SQRT2)
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = torch.full_like(z, float(SIGNED_LOG_COEFFS[-1]))
    for c in SIGNED_LOG_COEFFS[-2::-1]:
        p = p * z
        p = p + float(c)
    r = p * s
    r = r + e
    r = r * (1.0 / 32.0)
    return torch.where(d < 0, -r, r)


def trace_columns(trace: np.ndarray, cfg: FeatureConfig) -> Dict[str, np.ndarray]:
    """Host-side prep of the device extraction inputs (~32 B/instr): the
    bucket hash and narrowed ids, with ``addr`` kept int64."""
    return {
        "bucket": ((trace["pc"] >> 2) % cfg.n_buckets).astype(np.int32),
        "addr": trace["addr"].astype(np.int64),
        "opcode": trace["opcode"].astype(np.int32),
        "dst": trace["dst"].astype(np.int32),
        "src1": trace["src1"].astype(np.int32),
        "src2": trace["src2"].astype(np.int32),
        "is_branch": trace["is_branch"],
        "taken": trace["taken"],
        "is_mem": trace["is_mem"],
        "is_store": trace["is_store"],
    }
