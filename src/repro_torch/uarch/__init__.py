"""The NumPy µarch substrate: traces and their detailed-simulator labels.

``isa``, ``program``, ``programs``, ``functional``, ``config``, ``cache``,
``branch`` and ``detailed`` are copies of the reference package's
pure-NumPy modules of the same names: the port keeps its own copy so that
it never imports the reference package, and ``tests/test_torch_uarch.py``
holds the copies to the originals on every benchmark.  ``run_functional``
captures the functional trace the model reads; ``run_detailed`` is the
timing simulator whose records, aligned by ``core.align``, label the
training windows.
"""
from .config import (
    DESIGN_SPACE,
    UARCH_A,
    UARCH_B,
    UARCH_C,
    MicroArchConfig,
    enumerate_design_space,
    sample_design_space,
)
from .detailed import run_detailed, summarize_detailed
from .functional import run_functional
from .programs import ALL_BENCHMARKS, TEST_BENCHMARKS, TRAIN_BENCHMARKS, get_benchmark

__all__ = [
    "MicroArchConfig",
    "DESIGN_SPACE",
    "UARCH_A",
    "UARCH_B",
    "UARCH_C",
    "enumerate_design_space",
    "sample_design_space",
    "run_functional",
    "run_detailed",
    "summarize_detailed",
    "get_benchmark",
    "ALL_BENCHMARKS",
    "TRAIN_BENCHMARKS",
    "TEST_BENCHMARKS",
]
