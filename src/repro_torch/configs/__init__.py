"""Registry of the architectures the port runs: one module per id.

Counterpart of ``repro/configs/__init__.py``.  ``get_arch("qwen2-0.5b")``
-> ArchConfig; ``get_arch(..., reduced=True)`` -> the CPU test variant.
``get_arch("tao")`` -> the paper's ``TaoConfig`` (not an ``ArchConfig``, so
not in ``ARCH_IDS``; it has no reduced variant, and ``reduced=True``
raises ``AttributeError`` as the reference's does).  ``ARCH_IDS`` lists
the ported ids in the reference's order: the ``dense`` family,
``mamba2-1.3b``, ``hubert-xlarge`` (``audio``), ``qwen2-vl-2b`` (``vlm``),
``qwen3-moe-235b-a22b`` and ``deepseek-v2-lite-16b`` (``moe``) and
``recurrentgemma-9b`` (``hybrid``): every id of the reference's.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ArchConfig

__all__ = ["ARCH_IDS", "get_arch"]

_MODULES = {
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "stablelm-1.6b": "stablelm_1_6b",
    "glm4-9b": "glm4_9b",
    "mamba2-1.3b": "mamba2_1_3b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "tao": "tao",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "tao"]


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r} (have {sorted(_MODULES)})")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    cfg: ArchConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg
