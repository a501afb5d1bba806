"""§4.3 Training-dataset (µarch pair) selection for agnostic embeddings.

Counterpart of ``repro/core/selection.py``, in NumPy on the host with the
same semantics, over the port's own ``uarch``: measure per-design
performance vectors (CPI, L1 miss rate, L2 miss rate, branch mispredict
rate) averaged over benchmarks, then pick the pair of designs with the
largest Mahalanobis distance.  Euclidean and random selection are the
Fig. 14 baselines.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..uarch import MicroArchConfig, get_benchmark, run_detailed, run_functional

__all__ = [
    "METRIC_NAMES",
    "measure_design_metrics",
    "mahalanobis_matrix",
    "select_pair_mahalanobis",
    "select_pair_euclidean",
    "select_random",
]

METRIC_NAMES = ("cpi", "l1d_miss_rate", "l2_miss_rate", "branch_mispred_rate")


def measure_design_metrics(
    designs: Sequence[MicroArchConfig],
    benchmarks: Sequence[str],
    instructions: int = 20000,
) -> np.ndarray:
    """Simulate each design over the benchmarks; returns (n_designs, 4)."""
    out = np.zeros((len(designs), len(METRIC_NAMES)))
    for i, cfg in enumerate(designs):
        accum = np.zeros(len(METRIC_NAMES))
        for bname in benchmarks:
            prog = get_benchmark(bname)
            ft = run_functional(prog, instructions)
            _, summ = run_detailed(prog, ft, cfg)
            accum += np.array([summ[m] for m in METRIC_NAMES])
        out[i] = accum / len(benchmarks)
    return out


def mahalanobis_matrix(metrics: np.ndarray) -> np.ndarray:
    """Pairwise Mahalanobis distances between design metric vectors."""
    cov = np.cov(metrics.T)
    # the pseudo-inverse guards against a singular covariance of few designs
    s_inv = np.linalg.pinv(np.atleast_2d(cov))
    n = len(metrics)
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            diff = metrics[i] - metrics[j]
            d[i, j] = d[j, i] = float(np.sqrt(max(0.0, diff @ s_inv @ diff)))
    return d


def select_pair_mahalanobis(metrics: np.ndarray) -> Tuple[int, int]:
    """The pair of designs farthest apart by Mahalanobis distance."""
    d = mahalanobis_matrix(metrics)
    i, j = np.unravel_index(np.argmax(d), d.shape)
    return int(min(i, j)), int(max(i, j))


def select_pair_euclidean(metrics: np.ndarray) -> Tuple[int, int]:
    """The pair of designs farthest apart by Euclidean distance (the first
    such pair in (i, j) order)."""
    n = len(metrics)
    best, pair = -1.0, (0, 1)
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.linalg.norm(metrics[i] - metrics[j]))
            if d > best:
                best, pair = d, (i, j)
    return pair


def select_random(n_designs: int, k: int, seed: int = 0) -> List[int]:
    """``k`` distinct design indices drawn by a NumPy generator of ``seed``."""
    rng = np.random.default_rng(seed)
    return list(rng.choice(n_designs, size=k, replace=False))
