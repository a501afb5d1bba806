"""Functional simulator — the AtomicSimpleCPU analogue.

Executes a Program architecturally (no timing, no speculation) and emits the
µarch-agnostic functional trace Tao consumes.  This is the fast path: the
paper measures functional trace generation at ~25x the throughput of detailed
trace generation, a ratio our benchmark harness re-validates on this
substrate.
"""
from __future__ import annotations

import numpy as np

from .isa import FUNC_TRACE_DTYPE, Op
from .program import PC_STRIDE, Program

__all__ = ["run_functional"]

_WORD = 8  # bytes per memory word; trace addresses are byte addresses


def run_functional(program: Program, max_instructions: int) -> np.ndarray:
    """Run `program` for up to `max_instructions` committed instructions.

    Returns a structured array with FUNC_TRACE_DTYPE.  Execution wraps to the
    entry point if the program runs off the end (benchmarks are loop-shaped,
    so this models re-invoking the kernel, keeping traces arbitrarily long).
    """
    code = program.code
    n_static = len(code)
    regs = program.init_regs.astype(np.int64).copy()
    mem = program.init_mem.astype(np.int64).copy()
    mem_words = len(mem)

    # Unpack static code into parallel arrays for speed.
    ops = np.array([int(i.op) for i in code], dtype=np.int16)
    dsts = np.array([i.dst for i in code], dtype=np.int8)
    src1s = np.array([i.src1 for i in code], dtype=np.int8)
    src2s = np.array([i.src2 for i in code], dtype=np.int8)
    imms = np.array([i.imm for i in code], dtype=np.int64)
    targets = np.array([i.target for i in code], dtype=np.int64)

    out = np.zeros(max_instructions, dtype=FUNC_TRACE_DTYPE)
    o_pc = out["pc"]
    o_op = out["opcode"]
    o_dst = out["dst"]
    o_s1 = out["src1"]
    o_s2 = out["src2"]
    o_isbr = out["is_branch"]
    o_taken = out["taken"]
    o_ismem = out["is_mem"]
    o_isst = out["is_store"]
    o_addr = out["addr"]

    OP_IALU, OP_IMUL, OP_IDIV = int(Op.IALU), int(Op.IMUL), int(Op.IDIV)
    OP_FALU, OP_FMUL, OP_FDIV = int(Op.FALU), int(Op.FMUL), int(Op.FDIV)
    OP_LOAD, OP_STORE = int(Op.LOAD), int(Op.STORE)
    OP_BEQ, OP_BNE, OP_BLT, OP_BGE = (
        int(Op.BEQ),
        int(Op.BNE),
        int(Op.BLT),
        int(Op.BGE),
    )
    OP_JMP, OP_MOVI, OP_NOP = int(Op.JMP), int(Op.MOVI), int(Op.NOP)

    MASK = (1 << 40) - 1  # keep register values bounded

    pc = program.entry
    i = 0
    while i < max_instructions:
        if pc >= n_static:
            pc = program.entry
        op = int(ops[pc])
        dst = int(dsts[pc])
        s1 = int(src1s[pc])
        s2 = int(src2s[pc])
        imm = int(imms[pc])

        o_pc[i] = pc * PC_STRIDE
        o_op[i] = op
        o_dst[i] = dst
        o_s1[i] = s1
        o_s2[i] = s2

        next_pc = pc + 1
        if op == OP_IALU:
            if dst:
                regs[dst] = (regs[s1] + regs[s2] + imm) & MASK
        elif op == OP_MOVI:
            if dst:
                regs[dst] = imm & MASK
        elif op == OP_LOAD:
            w = (regs[s1] + imm) % mem_words
            if dst:
                regs[dst] = mem[w]
            o_ismem[i] = True
            o_addr[i] = w * _WORD
        elif op == OP_STORE:
            w = (regs[s1] + imm) % mem_words
            mem[w] = regs[s2]
            o_ismem[i] = True
            o_isst[i] = True
            o_addr[i] = w * _WORD
        elif op == OP_BEQ or op == OP_BNE or op == OP_BLT or op == OP_BGE:
            a = regs[s1]
            b = regs[s2]
            if op == OP_BEQ:
                taken = a == b
            elif op == OP_BNE:
                taken = a != b
            elif op == OP_BLT:
                taken = a < b
            else:
                taken = a >= b
            o_isbr[i] = True
            o_taken[i] = taken
            if taken:
                next_pc = int(targets[pc])
        elif op == OP_JMP:
            next_pc = int(targets[pc])
        elif op == OP_IMUL:
            if dst:
                # int() avoids int64 overflow for 2^40-range operands
                regs[dst] = (int(regs[s1]) * int(regs[s2])) & MASK
        elif op == OP_IDIV:
            if dst:
                d = regs[s2]
                regs[dst] = (regs[s1] // d) & MASK if d else 0
        elif op == OP_FALU:
            if dst:
                regs[dst] = ((regs[s1] + regs[s2]) >> 1) & MASK
        elif op == OP_FMUL:
            if dst:
                regs[dst] = ((int(regs[s1]) * 3 + int(regs[s2])) >> 2) & MASK
        elif op == OP_FDIV:
            if dst:
                d = regs[s2] | 1
                regs[dst] = (regs[s1] // d) & MASK
        elif op == OP_NOP:
            pass
        else:  # pragma: no cover - unreachable with a valid Program
            raise ValueError(f"bad opcode {op}")

        pc = next_pc
        i += 1

    return out
