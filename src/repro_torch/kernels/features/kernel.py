"""ctypes bindings of the hand-written whole-trace feature scans
(``csrc/feature_scans.cu``).

The CUDA counterparts of ``repro/kernels/features/kernel.py``
(``branch_history_kernel`` and ``memdist_delta_kernel``); the source's
header says how the scans are laid out on the card and what bounds them.
Each wrapper is one launch of its C entry point (several passes on one
stream), counted by ``BRANCH_HISTORY.launches`` / ``MEMDIST_DELTA.launches``.
The branch history's passes rank each tile's branches by bucket (each
warp walking its run of keys held in registers), turn the tiles' counts
into offsets and bucket starts, place each branch in the bucket-sorted
list with one thread, and gather each row from that list.  The memory distance writes
the finished signed-log features, where the reference's kernel writes raw
deltas.
The wrappers allocate the output and the passes' scratch; scratch sizes
mirror the source's ``*_scratch_bytes`` (the entry point refuses less).
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaKernel, check_cuda_tensor

__all__ = [
    "BRANCH_HISTORY",
    "BR_TILE",
    "KERNELS_PER_CALL",
    "MAX_POSITIONS",
    "MEMDIST_DELTA",
    "MEM_TILE",
    "SMEM_BUCKETS",
    "branch_history_cuda",
    "memdist_delta_cuda",
]

# the source's kBrTile, kMemTile, kSmemBuckets and kMaxPositions (tests hold
# them equal)
BR_TILE = 1024        # positions per branch rank tile
MEM_TILE = 2048       # positions per address compaction tile
SMEM_BUCKETS = 49152  # up to this N_b the per-bucket counters sit in shared memory
# kernels one branch_history_cuda call enqueues: br_rank, br_tile_offsets,
# scan_exclusive, br_place, br_gather
KERNELS_PER_CALL = 5
# positions are int32 on the card, with headroom for a tile past the end
# (2^30 positions of features would need ~580 GB at the default config)
MAX_POSITIONS = 2**30

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
BRANCH_HISTORY = CudaKernel(
    "feature_scans.cu", "tao_branch_history", [_P] * 4 + [_S] + [_I] * 3
)
MEMDIST_DELTA = CudaKernel(
    "feature_scans.cu", "tao_memdist_delta", [_P] * 4 + [_S] + [_I] * 2
)


def _branch_scratch_bytes(n: int, n_buckets: int) -> int:
    tiles = -(-n // BR_TILE)
    return 4 * (tiles * n_buckets + n_buckets + 2 * n)


def _memdist_scratch_bytes(n: int) -> int:
    tiles = -(-n // MEM_TILE)
    return 8 * n + 4 * (n + tiles)


def _positions(t: torch.Tensor) -> int:
    n = t.numel()
    if n > MAX_POSITIONS:
        raise ValueError(f"{n} positions: the kernels take at most {MAX_POSITIONS}")
    return n


def branch_history_cuda(
    bucket: torch.Tensor, outcome: torch.Tensor, n_buckets: int, n_queue: int
) -> torch.Tensor:
    """``bucket`` (n,) int32 and ``outcome`` (n,) float32 in {-1, 0, +1},
    contiguous on the card -> (n, n_queue) float32: each branch's bucket
    queue before its own push, most recent first, from an all-zero table;
    0 rows off branches.  What ``ref.branch_history_plain`` computes."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    if n_queue < 1:
        raise ValueError(f"n_queue must be >= 1, got {n_queue}")
    n = _positions(bucket)
    check_cuda_tensor("bucket", bucket, torch.int32, (n,))
    check_cuda_tensor("outcome", outcome, torch.float32, (n,))
    out = torch.empty((n, n_queue), device=bucket.device, dtype=torch.float32)
    if n == 0:
        return out
    scratch = torch.empty(
        _branch_scratch_bytes(n, n_buckets), device=bucket.device, dtype=torch.uint8
    )
    BRANCH_HISTORY.launch(
        bucket.data_ptr(), outcome.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), n, n_buckets, n_queue,
    )
    return out


def memdist_delta_cuda(addr: torch.Tensor, mem: torch.Tensor, n_mem: int) -> torch.Tensor:
    """``addr`` (n,) int64 and ``mem`` (n,) bool, contiguous on the card ->
    (n, n_mem) float32 ``memdist`` features: the signed-log of the deltas
    to the previous ``n_mem`` memory addresses (int64 delta rounded through
    float64), 0 off memory ops and past the fill.  What
    ``ref.memdist_feature_plain`` computes."""
    if n_mem < 1:
        raise ValueError(f"n_mem must be >= 1, got {n_mem}")
    n = _positions(addr)
    check_cuda_tensor("addr", addr, torch.int64, (n,))
    check_cuda_tensor("mem", mem, torch.bool, (n,))
    out = torch.empty((n, n_mem), device=addr.device, dtype=torch.float32)
    if n == 0:
        return out
    scratch = torch.empty(_memdist_scratch_bytes(n), device=addr.device, dtype=torch.uint8)
    MEMDIST_DELTA.launch(
        addr.data_ptr(), mem.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), n, n_mem,
    )
    return out
