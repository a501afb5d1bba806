"""Plain PyTorch version of the fused feature kernel.

The CPU path and the on-card check of ``csrc/fused_features.cu``.  Both
scans are written as vectorized lag gathers — the grouped formulation of
``core/features.py::_branch_history`` / ``::_memory_distance`` — with the
carried state prepended: a branch with ``j`` earlier branches of its bucket
in this pass reads slot ``k`` from the ``k``-th previous of them while
``k < j`` and from the carried row's slot ``k - j`` after; an access of rank
``r`` reads the ``k``-th previous access of the pass while ``k < r`` and the
carried queue's slot ``k - r`` (while that is within the fill) after.  The
outputs are copies and int64 subtractions rounded to float32 through
float64 — the NumPy specification's ``core/features.py::_memory_distance``
— so they are bitwise the reference's sequential scan
(``repro/kernels/fused/ref.py::fused_scan_ref``) wherever that scan's int32
deltas are exact, and the NumPy specification's for any address.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ...core.features import FP_OPS
from ...uarch.isa import NUM_REGS
from ..features.ops import signed_log

__all__ = ["fused_features_plain", "fused_scan_plain"]


def _branch_scan(bucket, is_branch, taken, table):
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


def _memory_scan(addr, is_mem, mq):
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
    brhist, table_out = _branch_scan(bucket, is_branch, taken, table)
    raw, mq_out = _memory_scan(addr, is_mem, mq)
    return brhist, raw, table_out, mq_out


def fused_features_plain(
    cols: Dict[str, torch.Tensor], table: torch.Tensor, mq: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """What ``fused_features_cuda`` computes, on any device: returns
    ``(regbits, flags, brhist, memdist, table_out, mq_out)`` with memdist
    signed-log compressed; the inputs are not modified."""
    reg = torch.arange(NUM_REGS, device=table.device, dtype=torch.int32)[None, :]
    regbits = (
        (reg == cols["dst"][:, None])
        | (reg == cols["src1"][:, None])
        | (reg == cols["src2"][:, None])
    ).to(torch.float32)
    op = cols["opcode"]
    is_fp = (op == FP_OPS[0]) | (op == FP_OPS[1]) | (op == FP_OPS[2])
    flags = torch.stack(
        [cols["is_branch"], cols["taken"], cols["is_mem"], cols["is_store"], is_fp],
        dim=1,
    ).to(torch.float32)
    brhist, raw, table_out, mq_out = fused_scan_plain(
        cols["bucket"], cols["addr"], cols["is_branch"], cols["taken"],
        cols["is_mem"], table, mq,
    )
    return regbits, flags, brhist, signed_log(raw), table_out, mq_out
