"""§4.2 feature engineering from the µarch-agnostic functional trace (NumPy).

The port's copy of the reference's NumPy feature specification
(``repro/core/features.py``): per-instruction features (opcode id, register
bitmap, five flags) and the two cross-instruction features — the N_b × N_q
branch-history hash table and the N_m-deep memory access-distance queue of
signed-log-compressed deltas.  It serves the engine's ``"numpy"`` backend
and is the specification the fused CUDA kernel is held to bitwise.

``extract_features`` is the vectorized form (lag gathers over the queue
depth); ``extract_features_reference`` keeps the per-branch / per-access
interpreter loops as the executable specification.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from ..uarch.isa import NUM_REGS, Op

__all__ = [
    "FeatureConfig",
    "FeatureSet",
    "extract_features",
    "extract_features_reference",
    "signed_log",
    "SIGNED_LOG_COEFFS",
    "SIGNED_LOG_SQRT2",
    "NUM_OPCODES",
]

NUM_OPCODES = len(Op)


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    n_buckets: int = 1024   # N_b
    n_queue: int = 32       # N_q
    n_mem: int = 64         # N_m

    @property
    def flags_dim(self) -> int:
        return 5  # is_branch, taken, is_mem, is_store, is_fp


@dataclasses.dataclass
class FeatureSet:
    """Model inputs (+ labels when built from an adjusted trace)."""

    opcode: np.ndarray      # (N,) int32
    regbits: np.ndarray     # (N, NUM_REGS) float32
    flags: np.ndarray       # (N, 5) float32
    brhist: np.ndarray      # (N, N_q) float32 in {-1, 0, +1}
    memdist: np.ndarray     # (N, N_m) float32 signed-log deltas
    labels: Optional[Dict[str, np.ndarray]] = None

    def __len__(self) -> int:
        return len(self.opcode)

    @property
    def digest(self) -> str:
        """Stable content digest (blake2b over every array, labels
        included) — the identity the artifact store keys on, the
        reference's for the same arrays.  Cached on first use; treat the
        arrays as immutable once hashed."""
        d = getattr(self, "_digest", None)
        if d is None:
            from ..store.content import tree_digest  # lazy: keep features import light

            d = tree_digest(
                {
                    "opcode": self.opcode,
                    "regbits": self.regbits,
                    "flags": self.flags,
                    "brhist": self.brhist,
                    "memdist": self.memdist,
                    "labels": self.labels,
                }
            )
            self._digest = d
        return d

    def slice(self, lo: int, hi: int) -> "FeatureSet":
        lab = None
        if self.labels is not None:
            lab = {k: v[lo:hi] for k, v in self.labels.items()}
        return FeatureSet(
            opcode=self.opcode[lo:hi],
            regbits=self.regbits[lo:hi],
            flags=self.flags[lo:hi],
            brhist=self.brhist[lo:hi],
            memdist=self.memdist[lo:hi],
            labels=lab,
        )


FP_OPS = (int(Op.FALU), int(Op.FMUL), int(Op.FDIV))


def _per_instruction(trace: np.ndarray, opcode: np.ndarray):
    n = len(trace)
    regbits = np.zeros((n, NUM_REGS), dtype=np.float32)
    rows = np.arange(n)
    regbits[rows, trace["src1"].astype(np.int64)] = 1.0
    regbits[rows, trace["src2"].astype(np.int64)] = 1.0
    regbits[rows, trace["dst"].astype(np.int64)] = 1.0

    is_fp = np.isin(opcode, FP_OPS)
    flags = np.stack(
        [
            trace["is_branch"].astype(np.float32),
            trace["taken"].astype(np.float32),
            trace["is_mem"].astype(np.float32),
            trace["is_store"].astype(np.float32),
            is_fp.astype(np.float32),
        ],
        axis=1,
    )
    return regbits, flags


def _labels(trace: np.ndarray, with_labels: bool):
    if not (with_labels and "fetch_lat" in trace.dtype.names):
        return None
    return {
        "fetch_lat": trace["fetch_lat"].astype(np.float32),
        "exec_lat": trace["exec_lat"].astype(np.float32),
        "mispred": trace["mispred"].astype(np.float32),
        "dlevel": trace["dlevel"].astype(np.int32),
        "icache_miss": trace["icache_miss"].astype(np.float32),
        "tlb_miss": trace["tlb_miss"].astype(np.float32),
        "is_branch": trace["is_branch"].astype(np.float32),
        "is_mem": trace["is_mem"].astype(np.float32),
    }


# ---------------------------------------------------------------------------
# Deterministic signed-log compression.
#
# sign(d) * log2(1 + |d|) / 32 evaluated as a FIXED sequence of exactly
# rounded float32 operations: exponent/mantissa split by bit manipulation,
# then an atanh-series polynomial (Horner) for log2 of the mantissa.  Every
# step is an individually rounded IEEE-754 float32 op, so this NumPy form,
# the eager op-per-kernel torch form (``kernels/features/ops.signed_log``)
# and the CUDA form (``csrc/fused_features.cu``, ``__fmul_rn``/``__fadd_rn``)
# give identical bits.  A form that contracts `a*b + c` into one fma would
# not.
# ---------------------------------------------------------------------------

# 2/ln2 * s^(2k) atanh-series coefficients: log2(m) = (2/ln2)·atanh(s) with
# s = (m-1)/(m+1); degree 13 keeps the error ≈1 ulp over m ∈ [√2/2, √2].
SIGNED_LOG_COEFFS = tuple(
    np.float32(2.0 / math.log(2.0) / k) for k in (1, 3, 5, 7, 9, 11, 13)
)
SIGNED_LOG_SQRT2 = np.float32(math.sqrt(2.0))


# tao: bitwise
def signed_log(d: np.ndarray) -> np.ndarray:
    """Signed-log-compress deltas to float32, bit-reproducibly (see above)."""
    d = np.asarray(d).astype(np.float32)
    a = np.abs(d)
    x = np.float32(1.0) + a
    bits = x.view(np.int32)
    e = ((bits >> 23) & np.int32(0xFF)) - np.int32(127)
    m = ((bits & np.int32(0x007FFFFF)) | np.int32(0x3F800000)).view(np.float32)
    big = m > SIGNED_LOG_SQRT2
    m = np.where(big, m * np.float32(0.5), m)
    e = (e + big).astype(np.float32)
    s = (m - np.float32(1.0)) / (m + np.float32(1.0))
    z = s * s
    p = np.full_like(z, SIGNED_LOG_COEFFS[-1])
    for c in SIGNED_LOG_COEFFS[-2::-1]:
        p = p * z
        p = p + c
    r = p * s
    r = r + e
    r = r * np.float32(1.0 / 32.0)
    return np.where(d < 0, -r, r)


def _branch_history(trace: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Grouped (per-bucket) formulation of the branch-history hash table:
    a stable sort by bucket makes every bucket's branches contiguous, so the
    lookup becomes lag-k gathers looped over the queue depth only."""
    n = len(trace)
    brhist = np.zeros((n, cfg.n_queue), dtype=np.float32)
    br_idx = np.nonzero(trace["is_branch"])[0]
    m = len(br_idx)
    if m == 0:
        return brhist
    bucket = ((trace["pc"][br_idx] >> 2) % cfg.n_buckets).astype(np.int64)
    taken = np.where(trace["taken"][br_idx], 1.0, -1.0).astype(np.float32)

    order = np.argsort(bucket, kind="stable")
    b_sorted = bucket[order]
    t_sorted = taken[order]
    pos = np.arange(m)
    is_head = np.empty(m, dtype=bool)
    is_head[0] = True
    is_head[1:] = b_sorted[1:] != b_sorted[:-1]
    group_start = np.maximum.accumulate(np.where(is_head, pos, 0))

    rows = np.zeros((m, cfg.n_queue), dtype=np.float32)
    for k in range(cfg.n_queue):
        src = pos - 1 - k
        valid = src >= group_start
        rows[valid, k] = t_sorted[src[valid]]
    brhist[br_idx[order]] = rows
    return brhist


def _memory_distance(trace: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """Lag-k formulation of the access-distance queue: slot k of access j is
    the signed-log delta to access j-1-k.  Loops over N_m, not the trace."""
    n = len(trace)
    memdist = np.zeros((n, cfg.n_mem), dtype=np.float32)
    mem_idx = np.nonzero(trace["is_mem"])[0]
    m = len(mem_idx)
    if m < 2:
        return memdist
    addrs = trace["addr"][mem_idx].astype(np.int64)
    for k in range(min(cfg.n_mem, m - 1)):
        d = (addrs[k + 1 :] - addrs[: m - 1 - k]).astype(np.float64)
        memdist[mem_idx[k + 1 :], k] = signed_log(d)
    return memdist


def extract_features(
    trace: np.ndarray, cfg: FeatureConfig = FeatureConfig(), with_labels: bool = True
) -> FeatureSet:
    """``trace`` is an adjusted trace (labels available) or a raw
    functional trace (FUNC_TRACE_DTYPE, the inference path)."""
    opcode = trace["opcode"].astype(np.int32)
    regbits, flags = _per_instruction(trace, opcode)
    return FeatureSet(
        opcode=opcode,
        regbits=regbits,
        flags=flags,
        brhist=_branch_history(trace, cfg),
        memdist=_memory_distance(trace, cfg),
        labels=_labels(trace, with_labels),
    )


def extract_features_reference(
    trace: np.ndarray, cfg: FeatureConfig = FeatureConfig(), with_labels: bool = True
) -> FeatureSet:
    """Interpreter-loop implementation: the executable specification
    ``extract_features`` is held to."""
    n = len(trace)
    opcode = trace["opcode"].astype(np.int32)
    regbits, flags = _per_instruction(trace, opcode)

    brhist = np.zeros((n, cfg.n_queue), dtype=np.float32)
    table = np.zeros((cfg.n_buckets, cfg.n_queue), dtype=np.float32)
    br_idx = np.nonzero(trace["is_branch"])[0]
    br_pc = (trace["pc"][br_idx] >> 2) % cfg.n_buckets
    br_taken = np.where(trace["taken"][br_idx], 1.0, -1.0).astype(np.float32)
    for j in range(len(br_idx)):
        row = table[br_pc[j]]
        brhist[br_idx[j]] = row
        row[1:] = row[:-1]  # push most-recent-first
        row[0] = br_taken[j]

    memdist = np.zeros((n, cfg.n_mem), dtype=np.float32)
    queue = np.zeros(cfg.n_mem, dtype=np.int64)
    filled = 0
    mem_idx = np.nonzero(trace["is_mem"])[0]
    addrs = trace["addr"][mem_idx].astype(np.int64)
    for j in range(len(mem_idx)):
        a = addrs[j]
        if filled:
            d = (a - queue[:filled]).astype(np.float64)
            memdist[mem_idx[j], :filled] = signed_log(d)
        queue[1:] = queue[:-1]
        queue[0] = a
        if filled < cfg.n_mem:
            filled += 1

    return FeatureSet(
        opcode=opcode,
        regbits=regbits,
        flags=flags,
        brhist=brhist,
        memdist=memdist,
        labels=_labels(trace, with_labels),
    )
