"""DL-based simulation (inference) entry points.

Counterpart of ``repro/core/simulate.py``.  Streams a functional trace
through a Tao model and aggregates the predicted performance metrics:

  CPI          = (sum of predicted fetch latencies + final exec latency) / N
                 (retire-clock formulation of §4.2)
  branch MPKI  = predicted mispredictions per 1000 instructions
  L1D MPKI     = predicted accesses with level >= L2 per 1000 instructions
  phase curves = per-chunk averages (Fig. 11)

``simulate_trace`` is a DEPRECATED compatibility wrapper over the
streaming engine (``engine.simulate_trace_engine``).  It has no
``feature_backend``: the engine's route follows from ``features``.  The
original host-side batch loop survives as ``simulate_trace_legacy`` — the
executable specification the engine is tested against, and the baseline
the engine's speedup is measured over: one eager ``tao_forward`` per
ragged batch (on the card, attention's kernel once per layer), the
predictions copied back per batch and the sums taken on the host.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..engine.runner import SimulationResult, simulate_trace_engine
from ..uarch.isa import DLEVEL_L2
from .dataset import stream_batches
from .features import FeatureSet, extract_features_reference
from .model import Tao, TaoConfig, tao_forward

__all__ = [
    "SimulationResult",
    "simulate_trace",
    "simulate_trace_legacy",
    "phase_curves",
]

Device = Optional[Union[str, torch.device]]


def simulate_trace(
    params: Tao,
    func_trace: np.ndarray,
    cfg: TaoConfig,
    batch_size: int = 64,
    features: Optional[FeatureSet] = None,
    collect: bool = True,
    *,
    device: Device = None,
) -> SimulationResult:
    """Deprecated engine-backed simulation — use
    ``repro_torch.api.TrainedModel.simulate`` (same engine, same results).
    ``collect=False`` keeps all metrics on the device (per-instruction
    arrays are then not collected).  ``features`` picks the engine's
    route, as in ``StreamingEngine.simulate``."""
    warnings.warn(
        "repro_torch.core.simulate_trace is deprecated; use repro_torch.api: "
        "TrainedModel(params, cfg).simulate(trace) or Session.sweep(...)",
        DeprecationWarning,
        stacklevel=2,
    )
    return simulate_trace_engine(
        params,
        func_trace,
        cfg,
        batch_size=batch_size,
        features=features,
        collect=collect,
        device=device,
    )


def simulate_trace_legacy(
    params: Tao,
    func_trace: np.ndarray,
    cfg: TaoConfig,
    batch_size: int = 64,
    features: Optional[FeatureSet] = None,
    *,
    device: Device = None,
) -> SimulationResult:
    """Pre-engine host batch loop (reference implementation), on
    ``device`` (default ``cuda``; raises without it unless
    ``device="cpu"``).

    Numerically the reference's loop: ``stream_batches`` over zero-copy
    views with ``pad=False`` (ragged batches, no validity mask), one
    ``tao_forward`` per batch on ``device``, the predictions copied back
    per batch, and the masks and sums taken on the host.  Without
    ``features`` it extracts them with the interpreter-loop
    ``extract_features_reference``, as the reference does; ``params`` must
    already be on ``device``.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    fs = features if features is not None else extract_features_reference(
        func_trace, cfg.features, with_labels=False
    )

    fetch, execl, misp, dlev = [], [], [], []
    with torch.inference_mode():
        for batch in stream_batches(fs, cfg.window, batch_size, stride=cfg.window, pad=False):
            batch.pop("valid")  # the legacy loop never padded: batches are ragged
            out = tao_forward(params, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg)
            # the loop's per-batch reads, as the reference's np.asarray calls
            fetch.append(out["fetch_lat"].float().cpu().numpy())
            execl.append(out["exec_lat"].float().cpu().numpy())
            misp.append(torch.sigmoid(out["mispred_logit"]).float().cpu().numpy())
            dlev.append(torch.argmax(out["dlevel_logits"], -1).to(torch.int32).cpu().numpy())

    fetch = np.maximum(np.concatenate(fetch).reshape(-1), 0.0)
    execl = np.maximum(np.concatenate(execl).reshape(-1), 0.0)
    misp = np.concatenate(misp).reshape(-1)
    dlev = np.concatenate(dlev).reshape(-1)
    n = len(fetch)

    # Masks from the trace itself (branch/memory heads only count where
    # valid).  The window grid covers the first n trace positions, so one
    # length-safe slice is all that is needed.
    covered = min(n, len(func_trace))
    is_branch = np.zeros(n, bool)
    is_mem = np.zeros(n, bool)
    is_branch[:covered] = func_trace["is_branch"][:covered]
    is_mem[:covered] = func_trace["is_mem"][:covered]

    total = float(fetch.sum() + (execl[-1] if n else 0.0))
    mispred_count = float((misp > 0.5)[is_branch].sum())
    l1d_miss_count = float((dlev >= DLEVEL_L2)[is_mem].sum())
    secs = time.perf_counter() - t0
    return SimulationResult(
        num_instructions=n,
        seconds=secs,
        mips=n / 1e6 / secs,
        metrics={
            "cpi": total / max(n, 1),
            "total_cycles": total,
            "branch_mpki": 1000.0 * mispred_count / max(n, 1),
            "l1d_mpki": 1000.0 * l1d_miss_count / max(n, 1),
        },
        arrays={"fetch_lat": fetch, "exec_lat": execl, "mispred_prob": misp, "dlevel": dlev},
    )


def phase_curves(
    result: SimulationResult, chunk: int = 10_000
) -> Dict[str, np.ndarray]:
    """Per-chunk CPI / branch MPKI / L1D MPKI curves (Fig. 11)."""
    if "fetch_lat" not in result.available_metrics:
        raise ValueError(
            "phase_curves needs per-instruction predictions: simulate with "
            "collect=True (EngineConfig.collect)"
        )
    n = result.num_instructions
    m = n // chunk
    cpi = np.zeros(m)
    br = np.zeros(m)
    l1 = np.zeros(m)
    for i in range(m):
        s = slice(i * chunk, (i + 1) * chunk)
        cpi[i] = result.fetch_lat[s].mean()
        br[i] = 1000.0 * (result.mispred_prob[s] > 0.5).mean()
        l1[i] = 1000.0 * (result.dlevel[s] >= DLEVEL_L2).mean()
    return {"cpi": cpi, "branch_mpki": br, "l1d_mpki": l1}
