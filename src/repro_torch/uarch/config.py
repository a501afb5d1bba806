"""Microarchitecture design space (paper Table 3) and named presets."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = [
    "MicroArchConfig",
    "DESIGN_SPACE",
    "UARCH_A",
    "UARCH_B",
    "UARCH_C",
    "enumerate_design_space",
    "sample_design_space",
]


@dataclasses.dataclass(frozen=True)
class MicroArchConfig:
    """Single-core superscalar OoO design point (Table 3)."""

    name: str = "custom"
    fetch_width: int = 2
    rob_size: int = 32
    branch_predictor: str = "Local"  # Local | BiMode | Tournament | TAGE_SC_L
    l1d_assoc: int = 2
    l1d_size: int = 16 * 1024
    l1i_assoc: int = 2
    l1i_size: int = 8 * 1024
    l2_assoc: int = 2
    l2_size: int = 256 * 1024

    # Fixed timing parameters (not part of the swept space).
    l1_extra_lat: int = 2
    l2_extra_lat: int = 12
    mem_extra_lat: int = 80
    tlb_miss_lat: int = 20
    icache_l2_lat: int = 10
    icache_mem_lat: int = 50
    mispredict_restart: int = 2  # front-end refill after squash

    def key(self) -> tuple:
        """Design-space coordinates (excludes fixed timing params)."""
        return (
            self.fetch_width,
            self.rob_size,
            self.branch_predictor,
            self.l1d_assoc,
            self.l1d_size,
            self.l1i_assoc,
            self.l1i_size,
            self.l2_assoc,
            self.l2_size,
        )


# Table 3 parameter ranges.
DESIGN_SPACE: Dict[str, List] = {
    "fetch_width": [2, 3, 4],
    "rob_size": [32, 64, 96, 128],
    "branch_predictor": ["Local", "BiMode", "TAGE_SC_L", "Tournament"],
    "l1d_assoc": [2, 4, 6, 8],
    "l1d_size": [16 * 1024, 32 * 1024, 64 * 1024, 128 * 1024],
    "l1i_assoc": [2, 4, 6, 8],
    "l1i_size": [8 * 1024, 16 * 1024, 32 * 1024],
    "l2_assoc": [2, 4, 6, 8],
    "l2_size": [256 * 1024, 512 * 1024, 1024 * 1024, 2 * 1024 * 1024, 4 * 1024 * 1024],
}
# Note: cache sizes must stay divisible by assoc*64B; assoc=6 with 16KB etc.
# all satisfy this (16384 / (6*64) is not integral -> the Cache class would
# reject it, so assoc 6 is paired with sizes divisible by 6*64=384).  gem5
# allows this by padding; we round the set count down instead (see _mk_cache).


UARCH_A = MicroArchConfig(
    name="uArchA",
    fetch_width=2,
    rob_size=32,
    branch_predictor="Local",
    l1d_assoc=2,
    l1d_size=16 * 1024,
    l1i_assoc=2,
    l1i_size=8 * 1024,
    l2_assoc=2,
    l2_size=256 * 1024,
)

UARCH_B = MicroArchConfig(
    name="uArchB",
    fetch_width=3,
    rob_size=96,
    branch_predictor="BiMode",
    l1d_assoc=4,
    l1d_size=32 * 1024,
    l1i_assoc=4,
    l1i_size=16 * 1024,
    l2_assoc=4,
    l2_size=1024 * 1024,
)

UARCH_C = MicroArchConfig(
    name="uArchC",
    fetch_width=4,
    rob_size=128,
    branch_predictor="Tournament",
    l1d_assoc=8,
    l1d_size=64 * 1024,
    l1i_assoc=8,
    l1i_size=32 * 1024,
    l2_assoc=8,
    l2_size=4 * 1024 * 1024,
)


def enumerate_design_space() -> int:
    """Total number of design points (the paper reports 184,320... our space
    is 3*4*4*4*4*4*3*4*5 = 184,320 as well)."""
    n = 1
    for v in DESIGN_SPACE.values():
        n *= len(v)
    return n


def sample_design_space(n: int, seed: int = 0) -> List[MicroArchConfig]:
    """Randomly sample `n` distinct design points."""
    rng = np.random.default_rng(seed)
    keys = list(DESIGN_SPACE)
    seen = set()
    out: List[MicroArchConfig] = []
    while len(out) < n:
        kw = {k: DESIGN_SPACE[k][rng.integers(len(DESIGN_SPACE[k]))] for k in keys}
        cfg = MicroArchConfig(name=f"design{len(out)}", **kw)
        if cfg.key() in seen:
            continue
        seen.add(cfg.key())
        out.append(cfg)
    return out
