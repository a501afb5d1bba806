"""Registry of the architectures the port runs: one module per id.

Counterpart of ``repro/configs/__init__.py``.  ``get_arch("mamba2-1.3b")``
-> ArchConfig; ``get_arch(..., reduced=True)`` -> the CPU test variant.
Only ported architectures are known; the rest of the reference's zoo is
ROADMAP item A10.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ArchConfig

__all__ = ["ARCH_IDS", "get_arch"]

_MODULES = {
    "mamba2-1.3b": "mamba2_1_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(
            f"architecture {name!r} is not ported (have {ARCH_IDS}); the rest "
            "of the reference's zoo is ROADMAP item A10"
        )
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    cfg: ArchConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg
