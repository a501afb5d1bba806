"""Public wrappers of the fused feature extraction.

Counterpart of ``repro/kernels/fused/ops.py``.  ``fused_feature_columns``
runs one pass — the CUDA kernel for columns on the card, the plain version
for columns on the CPU — and ``FusedExtractor`` is the streaming driver of
the engine's feature path: the raw columns go to the device once
(~32 B/instr), then every ``next_batch`` is one kernel launch whose scan
state carries into the next batch.  Features exist only at batch
granularity.

The state is the reference's layout, ``table`` (N_b, N_q) float32 and
``mq`` (1, N_m + 1) (queue slots, then the fill count), with ``mq`` int64
because the port takes address deltas in int64.  It is functional on
every device: a pass reads the state it is given and returns a new one,
so one state may be passed more than once.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ... import resolve_device
from ...core.features import FeatureConfig
from .kernel import COLUMN_KEYS, fused_features_cuda
from .ref import fused_features_plain

__all__ = ["FusedExtractor", "fused_feature_columns", "init_fused_state"]


def init_fused_state(
    cfg: FeatureConfig, device: Optional[torch.device] = None
) -> Dict[str, torch.Tensor]:
    """The scan carry threaded across passes: the (N_b, N_q) branch-outcome
    table and the address queue + fill counter packed into one int32 row
    (``mq[0, :n_mem]`` = queue, ``mq[0, n_mem]`` = fill)."""
    dev = resolve_device(device)
    return {
        "table": torch.zeros((cfg.n_buckets, cfg.n_queue), dtype=torch.float32, device=dev),
        "mq": torch.zeros((1, cfg.n_mem + 1), dtype=torch.int64, device=dev),
    }


def fused_feature_columns(
    cols: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    cfg: FeatureConfig,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One fused pass over (a slice of) the raw trace columns.

    Returns ``(features, new_state)``: the model inputs (``opcode`` /
    ``regbits`` / ``flags`` / ``brhist`` / ``memdist``) for exactly these
    positions, and the scan carry for the next slice.  Bitwise equal to one
    pass over the concatenated slices; ``state`` is not modified.
    """
    table, mq = state["table"], state["mq"]
    if table.shape != (cfg.n_buckets, cfg.n_queue) or mq.shape != (1, cfg.n_mem + 1):
        raise ValueError("fused state does not match the FeatureConfig")
    run = fused_features_cuda if cols["bucket"].is_cuda else fused_features_plain
    regbits, flags, brhist, memdist, table, mq = run(cols, table, mq)
    feats = {
        "opcode": cols["opcode"],
        "regbits": regbits,
        "flags": flags,
        "brhist": brhist,
        "memdist": memdist,
    }
    return feats, {"table": table, "mq": mq}


class FusedExtractor:
    """Streams fixed-size feature batches out of device-resident raw trace
    columns, carrying the scan state across batches.

    ``cols`` is the host dict from ``kernels.features.ops.trace_columns``;
    it goes to ``device`` once, zero-padded to ``pad_to`` positions so every
    ``next_batch(m)`` slice is uniform (pad rows are non-branch / non-memory
    and leave the carry untouched).  Each call returns the model-input dict
    for the next ``m`` positions plus the sliced ``is_branch`` / ``is_mem``
    columns the engine's step masks with.
    """

    def __init__(
        self,
        cols: Dict[str, np.ndarray],
        cfg: FeatureConfig,
        *,
        pad_to: Optional[int] = None,
        device: Optional[torch.device] = None,
    ):
        n = len(cols["bucket"])
        pad_to = n if pad_to is None else pad_to
        if pad_to < n:
            raise ValueError(f"pad_to ({pad_to}) < column length ({n})")
        dev = resolve_device(device)
        self._cols: Dict[str, torch.Tensor] = {}
        for k in COLUMN_KEYS:
            a = np.pad(cols[k], (0, pad_to - n))
            self._cols[k] = torch.from_numpy(a).to(dev)
        self._cfg = cfg
        self._pos = 0
        self._limit = pad_to
        self.state = init_fused_state(cfg, dev)

    def next_batch(self, m: int) -> Dict[str, torch.Tensor]:
        lo = self._pos
        if lo + m > self._limit:
            raise ValueError(
                f"next_batch({m}) past the padded column end "
                f"({lo} + {m} > {self._limit})"
            )
        self._pos = lo + m
        sl = {k: v[lo : lo + m] for k, v in self._cols.items()}
        feats, self.state = fused_feature_columns(sl, self.state, self._cfg)
        feats["is_branch"] = sl["is_branch"]
        feats["is_mem"] = sl["is_mem"]
        return feats
