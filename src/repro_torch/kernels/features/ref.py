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
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["branch_history_plain", "branch_scan", "memdist_delta_plain", "memory_scan"]


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
    """What ``memdist_delta_cuda`` computes, on any device: (n, n_mem) raw
    deltas from an empty address queue."""
    mq = torch.zeros((1, n_mem + 1), dtype=torch.int64, device=addr.device)
    return memory_scan(addr.to(torch.int64), mem != 0, mq)[0]
