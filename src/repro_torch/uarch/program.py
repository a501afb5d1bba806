"""Program representation + a tiny assembler DSL for the benchmark suite.

A Program is straight-line static code with labels resolved to instruction
indices (the "pc" is the instruction index; byte PCs are pc*4 to mimic a RISC
encoding for the branch-history hash features).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .isa import Op

PC_STRIDE = 4  # byte distance between consecutive instructions


@dataclasses.dataclass
class Instr:
    op: Op
    dst: int = 0
    src1: int = 0
    src2: int = 0
    imm: int = 0          # memory offset (words) or MOVI immediate
    target: int = -1      # branch/jump target (instruction index)


@dataclasses.dataclass
class Program:
    """Static code + initial machine state."""

    name: str
    code: List[Instr]
    init_regs: np.ndarray            # (NUM_REGS,) int64
    init_mem: np.ndarray             # (mem_words,) int64
    entry: int = 0

    @property
    def num_static(self) -> int:
        return len(self.code)

    def byte_pc(self, idx: int) -> int:
        return idx * PC_STRIDE


class ProgramBuilder:
    """Minimal assembler: emit instructions, reference labels forward."""

    def __init__(self, name: str, mem_words: int = 1 << 16, seed: int = 0):
        self.name = name
        self.code: List[Instr] = []
        self.labels: Dict[str, int] = {}
        self.fixups: List[tuple] = []  # (instr_index, label)
        self.rng = np.random.default_rng(seed)
        self.init_regs = np.zeros(32, dtype=np.int64)
        self.init_mem = np.zeros(mem_words, dtype=np.int64)

    # -- label handling ------------------------------------------------
    def label(self, name: str) -> None:
        self.labels[name] = len(self.code)

    def _emit(self, instr: Instr, label: Optional[str] = None) -> None:
        if label is not None:
            self.fixups.append((len(self.code), label))
        self.code.append(instr)

    # -- instruction emitters -------------------------------------------
    def ialu(self, dst, s1, s2):
        self._emit(Instr(Op.IALU, dst, s1, s2))

    def imul(self, dst, s1, s2):
        self._emit(Instr(Op.IMUL, dst, s1, s2))

    def idiv(self, dst, s1, s2):
        self._emit(Instr(Op.IDIV, dst, s1, s2))

    def falu(self, dst, s1, s2):
        self._emit(Instr(Op.FALU, dst, s1, s2))

    def fmul(self, dst, s1, s2):
        self._emit(Instr(Op.FMUL, dst, s1, s2))

    def fdiv(self, dst, s1, s2):
        self._emit(Instr(Op.FDIV, dst, s1, s2))

    def load(self, dst, addr_reg, off=0):
        self._emit(Instr(Op.LOAD, dst, addr_reg, 0, imm=off))

    def store(self, addr_reg, val_reg, off=0):
        self._emit(Instr(Op.STORE, 0, addr_reg, val_reg, imm=off))

    def movi(self, dst, imm):
        self._emit(Instr(Op.MOVI, dst, 0, 0, imm=int(imm)))

    def beq(self, s1, s2, label):
        self._emit(Instr(Op.BEQ, 0, s1, s2), label)

    def bne(self, s1, s2, label):
        self._emit(Instr(Op.BNE, 0, s1, s2), label)

    def blt(self, s1, s2, label):
        self._emit(Instr(Op.BLT, 0, s1, s2), label)

    def bge(self, s1, s2, label):
        self._emit(Instr(Op.BGE, 0, s1, s2), label)

    def jmp(self, label):
        self._emit(Instr(Op.JMP), label)

    def nop(self):
        self._emit(Instr(Op.NOP))

    # -- finalize --------------------------------------------------------
    def build(self) -> Program:
        for idx, label in self.fixups:
            if label not in self.labels:
                raise KeyError(f"undefined label {label!r} in {self.name}")
            self.code[idx].target = self.labels[label]
        return Program(
            name=self.name,
            code=self.code,
            init_regs=self.init_regs,
            init_mem=self.init_mem,
        )
