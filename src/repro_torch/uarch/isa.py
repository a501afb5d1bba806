"""Tiny RISC ISA for the µarch simulation substrate.

The paper (Tao, SIGMETRICS'24) builds its datasets from gem5 traces of ARM
SPEC CPU2017 binaries.  Neither gem5 nor SPEC is available here, so we define
a small register machine whose functional/detailed simulators expose the same
observable interface gem5 does in the paper: functional traces carrying static
instruction properties, and detailed traces carrying per-instruction
performance metrics plus squashed-speculative and stall-nop records.
"""
from __future__ import annotations

import enum

import numpy as np

__all__ = [
    "Op",
    "NUM_REGS",
    "EXEC_LATENCY",
    "FUNC_TRACE_DTYPE",
    "DET_TRACE_DTYPE",
    "KIND_REAL",
    "KIND_SQUASHED",
    "KIND_NOP",
    "DLEVEL_NONE",
    "DLEVEL_L1",
    "DLEVEL_L2",
    "DLEVEL_MEM",
    "NUM_DLEVELS",
]

NUM_REGS = 32  # r0..r31; r0 is hardwired zero (writes ignored).


class Op(enum.IntEnum):
    """Opcode space.  Order is stable: feature engineering uses the int value."""

    IALU = 0    # dst = src1 op src2 (add/sub/and/or/xor/shift collapse here)
    IMUL = 1
    IDIV = 2
    FALU = 3
    FMUL = 4
    FDIV = 5
    LOAD = 6    # dst = mem[src1 + imm]
    STORE = 7   # mem[src1 + imm] = src2
    BEQ = 8     # branch if src1 == src2
    BNE = 9
    BLT = 10
    BGE = 11
    JMP = 12    # unconditional
    MOVI = 13   # dst = imm
    NOP = 14    # real nop in programs (distinct from pipeline stall nops)


# Conditional branch opcodes (used by predictors / feature engineering).
BRANCH_OPS = frozenset({Op.BEQ, Op.BNE, Op.BLT, Op.BGE})
MEM_OPS = frozenset({Op.LOAD, Op.STORE})

# Base execution latency (cycles) per opcode class, before memory effects.
EXEC_LATENCY = {
    Op.IALU: 1,
    Op.IMUL: 3,
    Op.IDIV: 12,
    Op.FALU: 2,
    Op.FMUL: 4,
    Op.FDIV: 14,
    Op.LOAD: 1,   # + data access latency from the memory hierarchy
    Op.STORE: 1,
    Op.BEQ: 1,
    Op.BNE: 1,
    Op.BLT: 1,
    Op.BGE: 1,
    Op.JMP: 1,
    Op.MOVI: 1,
    Op.NOP: 1,
}

EXEC_LATENCY_ARR = np.zeros(len(Op), dtype=np.int32)
for _op, _lat in EXEC_LATENCY.items():
    EXEC_LATENCY_ARR[int(_op)] = _lat

# ---------------------------------------------------------------------------
# Trace record layouts.
# ---------------------------------------------------------------------------

# Functional trace: static properties + architectural outcome only.  This is
# the µarch-agnostic input Tao consumes at inference time.
FUNC_TRACE_DTYPE = np.dtype(
    [
        ("pc", np.int64),
        ("opcode", np.int16),
        ("dst", np.int8),
        ("src1", np.int8),
        ("src2", np.int8),
        ("is_branch", np.bool_),
        ("taken", np.bool_),       # architectural branch outcome
        ("is_mem", np.bool_),
        ("is_store", np.bool_),
        ("addr", np.int64),        # byte address for mem ops, else 0
    ]
)

# Detailed trace record kinds.
KIND_REAL = 0       # committed instruction
KIND_SQUASHED = 1   # wrong-path instruction, squashed on branch resolution
KIND_NOP = 2        # pipeline stall bubble

# Data access levels (softmax target in the multi-metric model).
DLEVEL_NONE = 0
DLEVEL_L1 = 1
DLEVEL_L2 = 2
DLEVEL_MEM = 3
NUM_DLEVELS = 4

# Detailed trace: everything in the functional record, plus µarch metrics.
DET_TRACE_DTYPE = np.dtype(
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
        ("kind", np.int8),          # KIND_*
        ("fetch_clock", np.int64),  # cycle the instruction was fetched
        ("fetch_lat", np.int32),    # fetch_clock delta vs previous fetched record
        ("exec_lat", np.int32),     # issue->complete latency
        ("retire_clock", np.int64), # fetch_clock + fetch_lat + exec_lat (paper defn)
        ("mispred", np.bool_),      # conditional branch was mispredicted
        ("dlevel", np.int8),        # DLEVEL_* for loads/stores
        ("icache_miss", np.bool_),
        ("tlb_miss", np.bool_),
    ]
)


def empty_func_trace(n: int) -> np.ndarray:
    return np.zeros(n, dtype=FUNC_TRACE_DTYPE)


def empty_det_trace(n: int) -> np.ndarray:
    return np.zeros(n, dtype=DET_TRACE_DTYPE)
