"""The NumPy half of the µarch substrate the port needs to capture traces.

``isa``, ``program``, ``programs`` and ``functional`` are copies of the
reference package's pure-NumPy modules of the same names: the port keeps
its own copy so that it never imports the reference package, and
``tests/test_torch_uarch.py`` holds the copies to the originals on every
benchmark.  The detailed (timing) simulator is not part of the port yet.
"""
from .functional import run_functional
from .programs import ALL_BENCHMARKS, TEST_BENCHMARKS, TRAIN_BENCHMARKS, get_benchmark

__all__ = [
    "run_functional",
    "get_benchmark",
    "ALL_BENCHMARKS",
    "TRAIN_BENCHMARKS",
    "TEST_BENCHMARKS",
]
