"""§4.1 Training-dataset construction: detailed↔functional trace alignment.

The detailed trace differs from the functional trace by (i) per-instruction
performance metrics and (ii) extra dynamic records — squashed speculative
instructions and stall nops.  We remove the extra records and re-attribute
their timing impact to the *fetch latency of the next committed instruction*
(paper Figure 2), producing an "adjusted trace": functional-trace order,
detailed-trace labels, with the total-cycle invariant preserved exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..uarch.isa import KIND_NOP, KIND_REAL, KIND_SQUASHED

__all__ = ["AlignedTrace", "build_adjusted_trace", "verify_alignment"]


# Adjusted-trace layout: functional static fields + supervised labels.
ADJ_DTYPE = np.dtype(
    [
        ("pc", np.int64),
        ("opcode", np.int16),
        ("dst", np.int8),
        ("src1", np.int8),
        ("src2", np.int8),
        ("is_branch", np.bool_),
        ("taken", np.bool_),
        ("is_mem", np.bool_),
        ("is_store", np.bool_),
        ("addr", np.int64),
        # labels
        ("fetch_lat", np.int32),   # adjusted: absorbs squashed/nop impact
        ("exec_lat", np.int32),
        ("mispred", np.bool_),
        ("dlevel", np.int8),
        ("icache_miss", np.bool_),
        ("tlb_miss", np.bool_),
    ]
)

_STATIC_FIELDS = (
    "pc",
    "opcode",
    "dst",
    "src1",
    "src2",
    "is_branch",
    "taken",
    "is_mem",
    "is_store",
    "addr",
)
_LABEL_FIELDS = ("exec_lat", "mispred", "dlevel", "icache_miss", "tlb_miss")


@dataclasses.dataclass
class AlignedTrace:
    """Adjusted trace + bookkeeping for invariant checks."""

    adjusted: np.ndarray          # ADJ_DTYPE records, committed order
    total_cycles_detailed: int    # max retire_clock over committed records
    num_squashed: int
    num_nops: int

    @property
    def total_cycles_adjusted(self) -> int:
        """Reconstruct total cycles from the adjusted trace alone:
        fetch clocks are the running sum of adjusted fetch latencies and the
        makespan is max(fetch_clock + exec_lat) (paper's retire-clock defn)."""
        if len(self.adjusted) == 0:
            return 0
        fetch_clock = np.cumsum(self.adjusted["fetch_lat"].astype(np.int64))
        return int(np.max(fetch_clock + self.adjusted["exec_lat"]))


def build_adjusted_trace(det_trace: np.ndarray) -> AlignedTrace:
    """Drop squashed/nop records, fold their timing into the next committed
    instruction's fetch latency."""
    kinds = det_trace["kind"]
    real_mask = kinds == KIND_REAL
    real = det_trace[real_mask]
    n = len(real)
    adj = np.zeros(n, dtype=ADJ_DTYPE)
    for f in _STATIC_FIELDS + _LABEL_FIELDS:
        adj[f] = real[f]

    # Adjusted fetch latency: delta between consecutive *committed* fetch
    # clocks.  Any squashed/nop records in between contributed to that delta,
    # which is precisely the re-attribution of Figure 2.
    fc = real["fetch_clock"].astype(np.int64)
    adj_fetch = np.empty(n, dtype=np.int64)
    if n:
        adj_fetch[0] = fc[0]
        adj_fetch[1:] = np.diff(fc)
    adj["fetch_lat"] = adj_fetch

    total_detailed = int(real["retire_clock"].max()) if n else 0
    return AlignedTrace(
        adjusted=adj,
        total_cycles_detailed=total_detailed,
        num_squashed=int((kinds == KIND_SQUASHED).sum()),
        num_nops=int((kinds == KIND_NOP).sum()),
    )


def verify_alignment(aligned: AlignedTrace, func_trace: np.ndarray) -> Dict:
    """Check the two §4.1 invariants:

    1. static-stream identity: the adjusted trace's committed instruction
       stream equals the functional trace (pc/opcode/regs/addr all match);
    2. cycle preservation: total cycles reconstructed from adjusted fetch
       latencies equal the detailed simulation's committed makespan.
    """
    adj = aligned.adjusted
    n = min(len(adj), len(func_trace))
    stream_ok = all(
        np.array_equal(adj[f][:n], func_trace[f][:n]) for f in _STATIC_FIELDS
    )
    cycles_ok = aligned.total_cycles_adjusted == aligned.total_cycles_detailed
    return {
        "stream_match": bool(stream_ok),
        "cycles_match": bool(cycles_ok),
        "total_cycles_adjusted": aligned.total_cycles_adjusted,
        "total_cycles_detailed": aligned.total_cycles_detailed,
        "n": n,
    }
