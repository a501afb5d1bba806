"""Synthetic benchmark suite — stand-ins for the paper's SPEC CPU2017 subset.

Each generator builds a real Program (static code + initial state) whose
dynamic behaviour mimics the qualitative personality the paper attributes to
its SPEC counterpart:

  train:  dee (deepsjeng: branchy int, game tree),  rom (roms: fp streaming),
          nab (nab: fp gather/strided),              lee (leela: int pointer-chase,
                                                          small working set)
  test:   mcf (mcf: pointer-chase, cache-hostile),   xal (xalancbmk: irregular
                                                          branchy mixed),
          wrf (wrf: fp loops, medium locality),      cac (cactuBSSN: fp, heavy
                                                          sequential stores, few
                                                          branches)

The register conventions: r1-r9 scratch, r10-r15 loop counters/limits,
r16-r25 data pointers/values, r26-r31 constants.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .program import Program, ProgramBuilder

__all__ = [
    "TRAIN_BENCHMARKS",
    "TEST_BENCHMARKS",
    "ALL_BENCHMARKS",
    "get_benchmark",
]


def _rand_mem(b: ProgramBuilder, words: int, hi: int) -> None:
    b.init_mem[:words] = b.rng.integers(0, hi, size=words, dtype=np.int64)


def build_dee() -> Program:
    """Branchy integer workload: data-dependent branches over a PRNG stream
    with a small evaluation 'table' — deepsjeng-ish."""
    b = ProgramBuilder("dee", mem_words=1 << 14, seed=11)
    _rand_mem(b, 1 << 14, 1 << 20)
    b.movi(26, 1)                 # const 1
    b.movi(27, 8191)              # index mask
    b.movi(28, 613)               # multiplier for lcg-ish update
    b.movi(16, 12345)             # state
    b.movi(10, 0)                 # i
    b.movi(11, 4096)              # limit
    b.label("outer")
    b.movi(10, 0)
    b.label("loop")
    # state = state*613 + i (mod); idx = state & mask
    b.imul(16, 16, 28)
    b.ialu(16, 16, 10)
    b.ialu(1, 16, 0)
    # idx = state & mask  (emulated: load from mem[state % words])
    b.load(17, 1)                 # table lookup
    # two data-dependent branches on value parity/threshold
    b.movi(29, 1 << 19)
    b.blt(17, 29, "small")
    b.ialu(18, 18, 26)            # score++
    b.jmp("join1")
    b.label("small")
    b.ialu(19, 19, 26)
    b.label("join1")
    b.movi(30, 3)
    b.idiv(2, 17, 30)
    b.imul(3, 2, 30)
    b.bne(3, 17, "notdiv")
    b.ialu(20, 20, 17)
    b.label("notdiv")
    # nested short loop — tree expansion flavour
    b.movi(12, 0)
    b.movi(13, 3)
    b.label("inner")
    b.ialu(4, 17, 12)
    b.load(21, 4)
    b.blt(21, 29, "iskip")
    b.ialu(18, 18, 21)
    b.label("iskip")
    b.ialu(12, 12, 26)
    b.blt(12, 13, "inner")
    b.ialu(10, 10, 26)
    b.blt(10, 11, "loop")
    b.jmp("outer")
    return b.build()


def build_rom() -> Program:
    """FP streaming stencil over a large array: predictable branches,
    sequential memory — roms-ish."""
    b = ProgramBuilder("rom", mem_words=1 << 18, seed=22)
    _rand_mem(b, 1 << 18, 1 << 30)
    b.movi(26, 1)
    b.movi(10, 0)
    b.movi(11, (1 << 18) - 8)
    b.label("loop")
    b.load(16, 10, 0)
    b.load(17, 10, 1)
    b.load(18, 10, 2)
    b.falu(19, 16, 17)
    b.fmul(20, 19, 18)
    b.falu(21, 20, 16)
    b.fmul(22, 21, 17)
    b.store(10, 22, 3)
    b.ialu(10, 10, 26)
    b.blt(10, 11, "loop")
    b.movi(10, 0)
    b.jmp("loop")
    return b.build()


def build_nab() -> Program:
    """FP with strided + gathered access and divides — nab-ish (MD forces)."""
    b = ProgramBuilder("nab", mem_words=1 << 16, seed=33)
    _rand_mem(b, 1 << 16, 1 << 16)
    b.movi(26, 1)
    b.movi(27, 7)        # stride
    b.movi(10, 0)
    b.movi(11, 1 << 15)
    b.label("loop")
    b.imul(1, 10, 27)            # strided index
    b.load(16, 1)                # position
    b.load(17, 16)               # gather via index stored in memory
    b.falu(18, 16, 17)
    b.fmul(19, 18, 18)
    b.fdiv(20, 19, 18)           # 1/r^2 flavour
    b.falu(21, 21, 20)           # accumulate force
    b.store(1, 21, 1)
    b.ialu(10, 10, 26)
    b.blt(10, 11, "loop")
    b.movi(10, 0)
    b.jmp("loop")
    return b.build()


def build_lee() -> Program:
    """Int pointer chasing on a SMALL working set with branchy evaluation —
    leela-ish (fits in L1/L2, branch-limited)."""
    b = ProgramBuilder("lee", mem_words=1 << 10, seed=44)
    # build a random cycle over the small arena
    perm = b.rng.permutation(1 << 10).astype(np.int64)
    b.init_mem[perm] = np.roll(perm, 1)
    b.movi(26, 1)
    b.movi(16, 0)                 # cursor
    b.movi(10, 0)
    b.movi(11, 1 << 12)
    b.label("loop")
    b.load(16, 16)                # chase
    b.movi(29, 1 << 9)
    b.blt(16, 29, "low")
    b.ialu(18, 18, 16)
    b.jmp("j1")
    b.label("low")
    b.ialu(19, 19, 26)
    b.label("j1")
    b.movi(30, 5)
    b.idiv(2, 16, 30)
    b.imul(3, 2, 30)
    b.beq(3, 16, "mul5")
    b.ialu(20, 20, 26)
    b.label("mul5")
    b.ialu(10, 10, 26)
    b.blt(10, 11, "loop")
    b.movi(10, 0)
    b.jmp("loop")
    return b.build()


def build_mcf() -> Program:
    """Pointer chasing over a LARGE arena — cache hostile, memory-bound."""
    b = ProgramBuilder("mcf", mem_words=1 << 19, seed=55)
    perm = b.rng.permutation(1 << 19).astype(np.int64)
    b.init_mem[perm] = np.roll(perm, 1)
    b.movi(26, 1)
    b.movi(16, 0)
    b.movi(10, 0)
    b.movi(11, 1 << 14)
    b.label("loop")
    b.load(16, 16)               # long-latency chase
    b.load(17, 16, 1)            # dependent neighbour
    b.ialu(18, 18, 17)           # reduce
    b.movi(29, 1 << 18)
    b.blt(16, 29, "skip")
    b.ialu(19, 19, 26)
    b.label("skip")
    b.ialu(10, 10, 26)
    b.blt(10, 11, "loop")
    b.movi(10, 0)
    b.jmp("loop")
    return b.build()


def build_xal() -> Program:
    """Irregular mixed int: many unpredictable branches over hashed lookups —
    xalancbmk-ish."""
    b = ProgramBuilder("xal", mem_words=1 << 15, seed=66)
    _rand_mem(b, 1 << 15, 1 << 24)
    b.movi(26, 1)
    b.movi(28, 2654435761 % (1 << 30))
    b.movi(16, 777)
    b.movi(10, 0)
    b.movi(11, 1 << 13)
    b.label("loop")
    b.imul(16, 16, 28)
    b.load(17, 16)
    b.movi(29, 1 << 23)
    b.blt(17, 29, "c1")
    b.ialu(18, 18, 26)
    b.jmp("m1")
    b.label("c1")
    b.movi(30, 1 << 22)
    b.blt(17, 30, "c2")
    b.ialu(19, 19, 26)
    b.jmp("m1")
    b.label("c2")
    b.movi(31, 1 << 21)
    b.blt(17, 31, "c3")
    b.ialu(20, 20, 26)
    b.jmp("m1")
    b.label("c3")
    b.ialu(21, 21, 26)
    b.label("m1")
    b.store(16, 18)
    b.ialu(10, 10, 26)
    b.blt(10, 11, "loop")
    b.movi(10, 0)
    b.jmp("loop")
    return b.build()


def build_wrf() -> Program:
    """FP loops with medium locality and blocked access — wrf-ish."""
    b = ProgramBuilder("wrf", mem_words=1 << 17, seed=77)
    _rand_mem(b, 1 << 17, 1 << 28)
    b.movi(26, 1)
    b.movi(27, 64)      # block
    b.movi(10, 0)
    b.movi(11, 1 << 11) # outer
    b.label("outer")
    b.imul(1, 10, 27)
    b.movi(12, 0)
    b.label("inner")
    b.ialu(2, 1, 12)
    b.load(16, 2)
    b.load(17, 2, 1)
    b.fmul(18, 16, 17)
    b.falu(19, 19, 18)
    b.fdiv(20, 18, 16)
    b.store(2, 19, 2)
    b.ialu(12, 12, 26)
    b.blt(12, 27, "inner")
    b.ialu(10, 10, 26)
    b.blt(10, 11, "outer")
    b.movi(10, 0)
    b.jmp("outer")
    return b.build()


def build_cac() -> Program:
    """FP with heavy sequential STORES and few branches — cactuBSSN-ish
    (the paper notes cac has more stores, fewer branches)."""
    b = ProgramBuilder("cac", mem_words=1 << 18, seed=88)
    _rand_mem(b, 1 << 18, 1 << 28)
    b.movi(26, 1)
    b.movi(10, 0)
    b.movi(11, (1 << 18) - 16)
    b.label("loop")
    b.load(16, 10, 0)
    b.falu(17, 16, 16)
    b.fmul(18, 17, 16)
    b.fmul(19, 18, 17)
    b.falu(20, 19, 18)
    b.store(10, 17, 4)
    b.store(10, 18, 5)
    b.store(10, 19, 6)
    b.store(10, 20, 7)
    b.ialu(10, 10, 26)
    b.blt(10, 11, "loop")
    b.movi(10, 0)
    b.jmp("loop")
    return b.build()


TRAIN_BENCHMARKS: Dict[str, Callable[[], Program]] = {
    "dee": build_dee,
    "rom": build_rom,
    "nab": build_nab,
    "lee": build_lee,
}
TEST_BENCHMARKS: Dict[str, Callable[[], Program]] = {
    "mcf": build_mcf,
    "xal": build_xal,
    "wrf": build_wrf,
    "cac": build_cac,
}
ALL_BENCHMARKS: Dict[str, Callable[[], Program]] = {
    **TRAIN_BENCHMARKS,
    **TEST_BENCHMARKS,
}

_CACHE: Dict[str, Program] = {}


def get_benchmark(name: str) -> Program:
    if name not in ALL_BENCHMARKS:
        raise KeyError(f"unknown benchmark {name!r}; have {sorted(ALL_BENCHMARKS)}")
    if name not in _CACHE:
        _CACHE[name] = ALL_BENCHMARKS[name]()
    return _CACHE[name]
