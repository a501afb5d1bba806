"""Plain PyTorch versions of the whole-trace feature scans.

The CPU path and the on-card check of ``csrc/feature_scans.cu``; the
counterparts of the reference's scan oracles
``repro/kernels/features/ref.py::branch_history_scan_ref`` /
``memdist_delta_scan_ref``.  Both scans are vectorized lag gathers — the
grouped formulation of ``core/features.py::_branch_history`` /
``::_memory_distance`` — with a carried state prepended:

  * ``branch_scan``: a branch with ``j`` earlier branches of its bucket in
    this pass reads slot ``k`` from the ``k``-th previous of them while
    ``k < j`` and from the carried row's slot ``k - j`` after;
  * ``memory_scan``: an access of rank ``r`` reads the ``k``-th previous
    access of the pass while ``k < r`` and the carried queue's slot
    ``k - r`` (while that is within the fill) after.

The outputs are copies and int64 subtractions rounded to float32 through
float64 — the NumPy specification's ``core/features.py::_memory_distance``
— so they are bitwise the reference's scans wherever the reference's int32
deltas are exact, and the NumPy specification's for any address.  The
staged plain versions run them from an empty state and drop the outgoing
one; the fused pass (``kernels/fused/ref.py``) threads the state.

``signed_log`` is the op-per-kernel torch twin of
``core.features.signed_log``, bitwise on any device: the plain epilogue of
the memory distance (``memdist_feature_plain``, the signed-log of the raw
``memdist_delta_plain``) and of the fused pass.
``signed_log_edge_addresses`` builds addresses whose deltas sit where the
signed-log rounds tightly, the edge case of every memory-distance check.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...core.features import SIGNED_LOG_COEFFS, SIGNED_LOG_SQRT2

__all__ = [
    "branch_history_plain",
    "branch_scan",
    "memdist_delta_plain",
    "memdist_feature_plain",
    "memory_scan",
    "signed_log",
    "signed_log_edge_addresses",
]


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


def branch_scan(
    bucket: torch.Tensor, is_branch: torch.Tensor, taken: torch.Tensor, table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branch history over one pass from the carried ``table`` (N_b, N_q):
    returns ``(brhist, table_out)``; ``table`` is not modified."""
    n = bucket.shape[0]
    n_queue = table.shape[1]
    dev = bucket.device
    brhist = torch.zeros((n, n_queue), dtype=torch.float32, device=dev)
    table_out = table.clone()
    br_idx = torch.nonzero(is_branch).flatten()
    m = br_idx.numel()
    if m == 0:
        return brhist, table_out
    b_sorted, order = torch.sort(bucket[br_idx].long(), stable=True)
    o_sorted = torch.where(taken[br_idx][order], 1.0, -1.0).to(torch.float32)
    pos = torch.arange(m, device=dev)
    is_head = torch.ones(m, dtype=torch.bool, device=dev)
    is_head[1:] = b_sorted[1:] != b_sorted[:-1]
    group_start = torch.cummax(torch.where(is_head, pos, 0), dim=0).values
    slot = torch.arange(n_queue, device=dev)[None, :]

    def rows(last, seen, buckets):
        # queue row after ``seen`` pushes of this pass, the latest at ``last``
        from_pass = slot < seen[:, None]
        lag = (last[:, None] - slot).clamp(min=0)
        carried = table[buckets[:, None], (slot - seen[:, None]).clamp(min=0)]
        return torch.where(from_pass, o_sorted[lag], carried)

    j = pos - group_start  # earlier branches of the bucket in this pass
    brhist[br_idx[order]] = rows(pos - 1, j, b_sorted)
    is_tail = torch.ones(m, dtype=torch.bool, device=dev)
    is_tail[:-1] = is_head[1:]
    tail = pos[is_tail]
    table_out[b_sorted[tail]] = rows(tail, j[tail] + 1, b_sorted[tail])
    return brhist, table_out


def memory_scan(
    addr: torch.Tensor, is_mem: torch.Tensor, mq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw memory deltas over one pass from the carried ``mq`` (1, N_m + 1)
    int64 (queue slots, then the fill count): returns ``(raw, mq_out)``;
    ``mq`` is not modified."""
    n = addr.shape[0]
    n_mem = mq.shape[1] - 1
    dev = addr.device
    queue, fill = mq[0, :n_mem], mq[0, n_mem]
    raw = torch.zeros((n, n_mem), dtype=torch.float32, device=dev)
    mem_idx = torch.nonzero(is_mem).flatten()
    m = mem_idx.numel()
    a = addr[mem_idx]
    slot = torch.arange(n_mem, device=dev)
    if m:
        r = torch.arange(m, device=dev)[:, None]
        src = r - 1 - slot[None, :]
        from_pass = src >= 0
        back = slot[None, :] - r  # carried-queue slot once the pass runs out
        prev = torch.where(
            from_pass, a[src.clamp(min=0)], queue[back.clamp(0, n_mem - 1)]
        )
        valid = from_pass | (back < fill)
        delta = torch.where(valid, a[:, None] - prev, 0)  # int64, as NumPy
        raw[mem_idx] = delta.to(torch.float64).to(torch.float32)
    s = m - 1 - slot
    new_q = torch.where(
        s >= 0,
        a[s.clamp(min=0)] if m else queue,
        queue[(slot - m).clamp(0, n_mem - 1)],
    )
    new_fill = torch.clamp(fill + m, max=n_mem)
    return raw, torch.cat([new_q, new_fill[None]])[None].to(torch.int64)


def branch_history_plain(
    bucket: torch.Tensor, outcome: torch.Tensor, n_buckets: int, n_queue: int
) -> torch.Tensor:
    """What ``branch_history_cuda`` computes, on any device: (n, n_queue)
    rows from an all-zero table.  A position is a branch where its outcome
    is nonzero and its bucket lies in ``[0, n_buckets)``, as in the kernel."""
    bucket = bucket.to(torch.int32)
    is_branch = (outcome != 0) & (bucket >= 0) & (bucket < n_buckets)
    table = torch.zeros((n_buckets, n_queue), dtype=torch.float32, device=bucket.device)
    return branch_scan(bucket, is_branch, outcome > 0, table)[0]


def memdist_delta_plain(addr: torch.Tensor, mem: torch.Tensor, n_mem: int) -> torch.Tensor:
    """(n, n_mem) raw deltas from an empty address queue, on any device:
    what the reference's ``memdist_delta_scan`` returns."""
    mq = torch.zeros((1, n_mem + 1), dtype=torch.int64, device=addr.device)
    return memory_scan(addr.to(torch.int64), mem != 0, mq)[0]


def memdist_feature_plain(addr: torch.Tensor, mem: torch.Tensor, n_mem: int) -> torch.Tensor:
    """What ``memdist_delta_cuda`` computes, on any device: the signed-log
    of ``memdist_delta_plain``, the (n, n_mem) ``memdist`` features."""
    return signed_log(memdist_delta_plain(addr, mem, n_mem))


def signed_log_edge_addresses(k_max: int = 63, huge: bool = True) -> np.ndarray:
    """int64 addresses whose consecutive deltas are +d and -d for each d
    of: 0 (duplicate addresses); x * 2^k - 1 for the float32 x just below,
    at and just above sqrt(2) and k < ``k_max``, where 1 + |d| in float32
    has a mantissa next to sqrt(2) (exactly x at k = 23 and from k = 25
    on); with ``huge``, 2^62 (two steps back: 2^63, which wraps in int64)."""
    xs = (np.nextafter(SIGNED_LOG_SQRT2, np.float32(0)), SIGNED_LOG_SQRT2,
          np.nextafter(SIGNED_LOG_SQRT2, np.float32(2)))
    mants = [int(np.float64(x) * 2**23) for x in xs]  # x * 2^23, exact
    deltas = [0] + [(m << (k - 23) if k >= 23 else round(m / 2 ** (23 - k))) - 1
                    for m in mants for k in range(k_max)] + ([2**62] if huge else [])
    return np.array([0] + [a for d in deltas for a in (d, 0, -d, 0)], dtype=np.int64)
