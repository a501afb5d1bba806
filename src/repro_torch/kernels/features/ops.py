"""The staged whole-trace feature path, the host prep and the eager
torch signed-log.

Counterpart of ``repro/kernels/features/ops.py``.  The contract is the
reference's: the device extraction is BITWISE the NumPy specification
(``core.features.extract_features``):

  * ``trace_columns`` is the host prep of both device feature paths (bucket
    hash on the int64 pc, narrowed ids, ~32 B/instr);
  * ``branch_history_scan`` / ``memdist_feature_scan`` run the whole-trace
    scans — the CUDA kernels (``kernel.py``, ``csrc/feature_scans.cu``)
    for tensors on the card, their plain versions (``ref.py``) on the
    CPU.  Branch-history rows are copies of {-1, 0, +1}; memory features
    are the signed-log of int64 deltas rounded to float32 through float64,
    written by the scan itself (the reference's ``memdist_delta_scan``
    returns the raw deltas and its caller applies ``signed_log_device``);
  * ``signed_log`` (from ``ref.py``) is the op-per-kernel torch twin of
    ``core.features.signed_log``: one rounded float32 op per statement,
    never compiled, so it matches the NumPy specification bit for bit on
    any device;
  * ``device_feature_arrays`` extracts a whole trace once and keeps every
    model input on the device — what the engine's staged route
    (``simulate(trace, features=arrays)``) batches from, and what one
    extraction shared by several models reuses;
    ``extract_features_device`` is its host ``FeatureSet`` twin of
    ``extract_features``.

Two deliberate differences from the reference: there is no ``chunk`` or
``interpret`` parameter (nothing in the port reads such a setting), and no
``ValueError`` for |addr| >= 2^30 — addresses stay int64 and the deltas are
exact for any address, as in the fused path.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ... import resolve_device
from ...core.features import FP_OPS, FeatureConfig, FeatureSet, _labels
from ...uarch.isa import NUM_REGS
from .kernel import branch_history_cuda, memdist_delta_cuda
from .ref import branch_history_plain, memdist_feature_plain, signed_log

__all__ = [
    "branch_history_scan",
    "device_feature_arrays",
    "extract_features_device",
    "memdist_feature_scan",
    "signed_log",
    "trace_columns",
]


def trace_columns(trace: np.ndarray, cfg: FeatureConfig) -> Dict[str, np.ndarray]:
    """Host-side prep of the device extraction inputs (~32 B/instr): the
    bucket hash and narrowed ids, with ``addr`` kept int64."""
    return {
        "bucket": ((trace["pc"] >> 2) % cfg.n_buckets).astype(np.int32),
        "addr": trace["addr"].astype(np.int64),
        "opcode": trace["opcode"].astype(np.int32),
        "dst": trace["dst"].astype(np.int32),
        "src1": trace["src1"].astype(np.int32),
        "src2": trace["src2"].astype(np.int32),
        "is_branch": trace["is_branch"],
        "taken": trace["taken"],
        "is_mem": trace["is_mem"],
        "is_store": trace["is_store"],
    }


def branch_history_scan(bucket, outcome, *, n_buckets: int, n_queue: int) -> torch.Tensor:
    """(n,) bucket ids + ±1/0 outcomes -> (n, n_queue) float32 branch-history
    rows from an all-zero table, on the inputs' device (the kernel on the
    card, the plain version on the CPU)."""
    bucket = torch.as_tensor(bucket).to(torch.int32).contiguous()
    outcome = torch.as_tensor(outcome).to(torch.float32).contiguous()
    run = branch_history_cuda if bucket.is_cuda else branch_history_plain
    return run(bucket, outcome, n_buckets, n_queue)


def memdist_feature_scan(addr, mem, *, n_mem: int) -> torch.Tensor:
    """(n,) addresses + memory mask -> (n, n_mem) float32 ``memdist``
    features, the signed-log of the deltas, on the inputs' device (one
    kernel launch on the card, no raw deltas in device memory; the plain
    version on the CPU).  Addresses are taken as int64: any address is
    exact."""
    addr = torch.as_tensor(addr).to(torch.int64).contiguous()
    mem = torch.as_tensor(mem).to(torch.bool).contiguous()
    run = memdist_delta_cuda if addr.is_cuda else memdist_feature_plain
    return run(addr, mem, n_mem)


def _per_instruction_device(opcode, dst, src1, src2, is_branch, taken, is_mem, is_store):
    """Register bitmap, flags, and the scans' inputs (±1/0 branch outcomes,
    the memory mask): exact integer / boolean -> float32 elementwise ops on
    the inputs' device."""
    reg = torch.arange(NUM_REGS, device=opcode.device, dtype=torch.int32)[None, :]
    regbits = (
        (reg == dst[:, None]) | (reg == src1[:, None]) | (reg == src2[:, None])
    ).to(torch.float32)
    is_fp = (opcode == FP_OPS[0]) | (opcode == FP_OPS[1]) | (opcode == FP_OPS[2])
    flags = torch.stack([is_branch, taken, is_mem, is_store, is_fp], dim=1).to(torch.float32)
    outcome = torch.where(is_branch, torch.where(taken, 1.0, -1.0), 0.0).to(torch.float32)
    return regbits, flags, outcome, is_mem.to(torch.bool)


def device_feature_arrays(
    cols: Dict[str, Union[np.ndarray, torch.Tensor]],
    cfg: FeatureConfig,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """The whole-trace extraction on ``device`` (default ``cuda``): the
    ``trace_columns`` dict goes there once, and the result is (n, ·)
    tensors keyed like ``core.dataset.INPUT_KEYS`` plus the ``is_branch`` /
    ``is_mem`` bool columns the engine's step masks with, all on the
    device: 538 B/instr at the default ``FeatureConfig`` (532 B of them
    features)."""
    dev = resolve_device(device)
    c = {
        k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))).to(dev)
        for k, v in cols.items()
    }
    regbits, flags, outcome, mem = _per_instruction_device(
        c["opcode"], c["dst"], c["src1"], c["src2"],
        c["is_branch"], c["taken"], c["is_mem"], c["is_store"],
    )
    brhist = branch_history_scan(c["bucket"], outcome, n_buckets=cfg.n_buckets, n_queue=cfg.n_queue)
    memdist = memdist_feature_scan(c["addr"], mem, n_mem=cfg.n_mem)
    return {
        "opcode": c["opcode"].to(torch.int32),
        "regbits": regbits,
        "flags": flags,
        "brhist": brhist,
        "memdist": memdist,
        "is_branch": c["is_branch"],
        "is_mem": c["is_mem"],
    }


def extract_features_device(
    trace: np.ndarray,
    cfg: FeatureConfig = FeatureConfig(),
    with_labels: bool = True,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> FeatureSet:
    """Twin of ``core.features.extract_features`` through the staged device
    path: features extracted on ``device`` (default ``cuda``) and copied to
    the host; labels (from an adjusted trace) are passed through."""
    arrays = device_feature_arrays(trace_columns(trace, cfg), cfg, device=device)
    host = {k: arrays[k].cpu().numpy() for k in ("opcode", "regbits", "flags", "brhist", "memdist")}
    return FeatureSet(**host, labels=_labels(trace, with_labels))
