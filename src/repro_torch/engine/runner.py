"""Device-resident streaming simulation engine, in PyTorch.

Counterpart of ``repro/engine/runner.py`` on one device.  A functional
trace flows through

  features  ->  fixed-shape (batch_size, W) windows + validity mask  ->
  the Tao forward  ->  device-resident metric accumulators
  (``MetricSpec`` registry)  ->  one host sync  ->  ``SimulationResult``.

Where the features come from follows from what ``simulate`` is given:

  * a raw trace — its columns go to the device once, then each batch is
    ONE launch of the fused feature kernel (``kernels/fused``; its plain
    version on the CPU) with the scan state carried across batches.
    Features exist only at batch granularity and are bitwise the NumPy
    specification's for any address (the deltas are taken in int64).
  * precomputed ``features=`` (a ``FeatureSet``) — batches are cut on the
    host and copied to the device one at a time.

The reference's ``feature_backend`` switch is therefore not needed here;
its staged ``"pallas"`` kernels are still to port (ROADMAP B2, B3).
Carries stay on the device; the only device-to-host transfer is one
packed copy of every carry (and collected array) after the last batch.
``precision="int8"`` is not ported yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..core.dataset import INPUT_KEYS, num_windows, stream_batches
from ..core.features import FeatureSet
from ..core.model import Tao, TaoConfig, tao_forward
from ..kernels.features.ops import trace_columns
from ..kernels.fused.ops import FusedExtractor
from .metrics import DEFAULT_METRICS, MetricSpec, StepContext, resolve_metrics

__all__ = [
    "EngineConfig",
    "PRECISIONS",
    "PER_INSTRUCTION_KEYS",
    "MetricNotCollectedError",
    "MetricNotComputedError",
    "SimulationResult",
    "StreamingEngine",
    "device_get",
    "simulate_trace_engine",
]

PRECISIONS = ("fp32", "int8")

# per-instruction prediction arrays the step can emit under collect=True
PER_INSTRUCTION_KEYS = ("fetch_lat", "exec_lat", "mispred_prob", "dlevel")

# SimulationResult instance attributes that would shadow a same-named
# metric (instance dict wins over __getattr__)
_RESERVED_RESULT_ATTRS = frozenset(
    ("num_instructions", "seconds", "mips", "metrics")
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_size: int = 64
    collect: bool = False        # also return per-instruction predictions
    precision: str = "fp32"
    # device-side accumulators: registry names or MetricSpec instances
    metrics: Tuple[Union[str, MetricSpec], ...] = DEFAULT_METRICS


class MetricNotCollectedError(AttributeError):
    """A per-instruction array was requested but the engine kept metrics on
    device (``EngineConfig.collect=False``)."""


class MetricNotComputedError(AttributeError):
    """A scalar metric was requested whose ``MetricSpec`` was not part of
    the simulation's ``EngineConfig.metrics``."""


class SimulationResult:
    """Aggregated metrics of one simulated trace.

    Scalar metrics (``cpi``, ``total_cycles``, ``branch_mpki``,
    ``l1d_mpki`` with the default set) are attributes and live in
    ``.metrics``; per-instruction arrays (``fetch_lat``, ``exec_lat``,
    ``mispred_prob``, ``dlevel``) are attributes only when the run
    collected them.  An uncollected array raises ``MetricNotCollectedError``
    and a metric that was never computed ``MetricNotComputedError`` (both
    ``AttributeError`` subclasses).
    """

    def __init__(
        self,
        num_instructions: int,
        seconds: float,
        mips: float,
        metrics: Optional[Dict[str, float]] = None,
        arrays: Optional[Dict[str, Optional[np.ndarray]]] = None,
    ):
        self.num_instructions = num_instructions
        self.seconds = seconds
        self.mips = mips
        self.metrics: Dict[str, float] = dict(metrics or {})
        self._arrays: Dict[str, Optional[np.ndarray]] = (
            dict(arrays)
            if arrays is not None
            else {k: None for k in PER_INSTRUCTION_KEYS}
        )

    @property
    def available_metrics(self) -> Tuple[str, ...]:
        """Scalar metric names plus whichever per-instruction arrays were
        actually collected."""
        return tuple(self.metrics) + tuple(
            k for k, v in self._arrays.items() if v is not None
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        d = self.__dict__
        metrics = d.get("metrics", {})
        if name in metrics:
            return metrics[name]
        arrays = d.get("_arrays", {})
        if name in arrays:
            v = arrays[name]
            if v is None:
                raise MetricNotCollectedError(
                    f"per-instruction array {name!r} was not collected "
                    f"(metrics stayed on device): simulate with collect=True "
                    f"(EngineConfig.collect). available_metrics="
                    f"{self.available_metrics}"
                )
            return v
        raise MetricNotComputedError(
            f"metric {name!r} was not computed by this simulation; "
            f"available_metrics={self.available_metrics} (request its "
            f"MetricSpec via EngineConfig.metrics)"
        )

    def error_vs(self, truth_cpi: float) -> float:
        return abs(self.cpi - truth_cpi) / truth_cpi * 100.0

    def to_dict(self, *, arrays: bool = False) -> Dict:
        """Stable JSON-clean form (the reference's wire contract): scalar
        metrics as floats, phase curves as lists, collected per-instruction
        arrays only under ``arrays=True``."""
        out = {
            "num_instructions": int(self.num_instructions),
            "seconds": float(self.seconds),
            "mips": float(self.mips),
            "metrics": {
                k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else float(v))
                for k, v in self.metrics.items()
            },
            "available_metrics": list(self.available_metrics),
        }
        if arrays:
            out["arrays"] = {
                k: np.asarray(v).tolist()
                for k, v in self._arrays.items()
                if v is not None
            }
        return out

    def __repr__(self) -> str:
        scalars = ", ".join(
            f"{k}=curve{v.shape}" if isinstance(v, np.ndarray) else f"{k}={v:.4g}"
            for k, v in self.metrics.items()
        )
        collected = [k for k, v in self._arrays.items() if v is not None]
        return (
            f"SimulationResult(n={self.num_instructions}, {scalars}, "
            f"mips={self.mips:.4g}, collected={collected})"
        )


# the leaf types a carry or collected array may have: exact through float64
_HOST_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def device_get(tree: Any) -> Any:
    """A nested dict of tensors -> the same tree of NumPy arrays, in ONE
    device-to-host copy: every leaf is packed into a float64 buffer (exact
    for float32 and int32) and unpacked on the host."""
    leaves: List[torch.Tensor] = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        else:
            leaves.append(node)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves]).cpu().numpy()
    it = iter(leaves)
    offset = 0

    def rebuild(node):
        nonlocal offset
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        t = next(it)
        n = t.numel()
        host = flat[offset : offset + n].astype(_HOST_DTYPES[t.dtype])
        offset += n
        return host.reshape(tuple(t.shape))

    return rebuild(tree)


class StreamingEngine:
    """Stream any number of traces through one model on one device.

    ``params`` (a ``core.model.Tao``) is moved to ``device`` in place, as
    ``nn.Module.to`` does (default ``cuda``; without CUDA this raises
    unless ``device="cpu"``).
    """

    def __init__(
        self,
        params: Tao,
        cfg: TaoConfig,
        ecfg: EngineConfig = EngineConfig(),
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if ecfg.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {ecfg.batch_size}")
        if ecfg.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {ecfg.precision!r}"
            )
        if ecfg.precision == "int8":
            raise NotImplementedError(
                "precision='int8' needs the W8A8 quantized forward "
                "(ROADMAP A6), not ported yet"
            )
        self._specs: Tuple[MetricSpec, ...] = resolve_metrics(ecfg.metrics)
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.ecfg = ecfg

    def init_carry(self, n: int) -> Dict[str, Any]:
        """Every requested spec's ``init()`` on the engine's device, for a
        trace of ``n`` instructions."""
        if n < 1:
            raise ValueError("cannot simulate an empty trace")
        nw = num_windows(n, self.cfg.window, self.cfg.window)
        for s in self._specs:
            # chunk_of's bucket math (win_index * num_chunks) is int32;
            # refuse traces that would silently wrap
            if s.num_chunks is not None and nw * s.num_chunks > 2**31 - 1:
                raise ValueError(
                    f"windowed spec {s.name!r}: num_windows ({nw}) * "
                    f"num_chunks ({s.num_chunks}) exceeds the int32 "
                    "chunk-index envelope; reduce num_chunks or split "
                    "the trace"
                )
        return {s.name: s.init(self.device) for s in self._specs}

    def _step(
        self, carry: Dict, batch: Dict[str, torch.Tensor], seen: int, total: int, w_eff: int
    ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """Fold one (batch_size, W) batch into the carry; ``seen`` is the
        trace-global index of the batch's first window, ``total`` the
        trace's window count."""
        dev = self.device
        valid = batch["valid"].reshape(-1)
        out = tao_forward(self.params, {k: batch[k] for k in INPUT_KEYS}, self.cfg)
        fetch = torch.clamp(out["fetch_lat"], min=0.0).reshape(-1)
        execl = torch.clamp(out["exec_lat"], min=0.0).reshape(-1)
        misp = torch.sigmoid(out["mispred_logit"]).reshape(-1)
        dlev = torch.argmax(out["dlevel_logits"], dim=-1).to(torch.int32).reshape(-1)
        on = valid > 0
        gidx = torch.arange(valid.shape[0], dtype=torch.float32, device=dev)
        b_local = batch["valid"].shape[0]
        ctx = StepContext(
            valid=valid,
            on=on,
            is_branch=batch["is_branch"].reshape(-1) & on,
            is_mem=batch["is_mem"].reshape(-1) & on,
            fetch_lat=fetch,
            exec_lat=execl,
            mispred_prob=misp,
            dlevel=dlev,
            gidx=gidx,
            last_key=torch.max(torch.where(on, gidx, -1.0)),
            batch=batch,
            window=w_eff,
            win_index=torch.arange(seen, seen + b_local, dtype=torch.int32, device=dev),
            num_windows=total,
        )
        new_carry = {s.name: s.update(carry[s.name], ctx) for s in self._specs}
        per = {}
        if self.ecfg.collect:
            per = {"fetch_lat": fetch, "exec_lat": execl, "mispred_prob": misp, "dlevel": dlev}
        return new_carry, per

    def _host_batches(self, fs: FeatureSet, func_trace: np.ndarray) -> Iterator[Dict]:
        """Precomputed features: host batches copied to the device."""
        for b in stream_batches(
            fs,
            self.cfg.window,
            self.ecfg.batch_size,
            stride=self.cfg.window,
            extra={"is_branch": func_trace["is_branch"], "is_mem": func_trace["is_mem"]},
        ):
            yield {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def _fused_batches(self, cols: Dict, w_eff: int, count: int) -> Iterator[Dict]:
        """A raw trace: columns on the device once, then one fused kernel
        launch per batch.  Window / padding / validity layout is the host
        path's (non-overlapping windows, ragged tail zero-padded)."""
        bsz = self.ecfg.batch_size
        nw = count // w_eff
        nb = -(-nw // bsz)
        per = bsz * w_eff
        extractor = FusedExtractor(
            {k: v[:count] for k, v in cols.items()},
            self.cfg.features,
            pad_to=nb * per,
            device=self.device,
        )
        valid = torch.zeros((nb * bsz, w_eff), dtype=torch.float32)
        valid[:nw] = 1.0
        valid = valid.reshape(nb, bsz, w_eff).to(self.device)
        for i in range(nb):
            feats = extractor.next_batch(per)
            batch = {k: v.reshape((bsz, w_eff) + v.shape[1:]) for k, v in feats.items()}
            batch["valid"] = valid[i]
            yield batch

    def simulate(
        self, func_trace: np.ndarray, features: Optional[FeatureSet] = None
    ) -> SimulationResult:
        t0 = time.perf_counter()
        cfg = self.cfg
        n = len(features) if features is not None else len(func_trace)
        if n == 0:
            raise ValueError("cannot simulate an empty trace")
        w_eff = min(cfg.window, n)
        nw = num_windows(n, cfg.window, cfg.window)
        # exact instruction count from the window grid (the tail past the
        # last whole window is not simulated, as in the reference)
        count = nw * w_eff
        carry = self.init_carry(n)

        if features is None:
            batches = self._fused_batches(trace_columns(func_trace, cfg.features), w_eff, count)
        else:
            batches = self._host_batches(features, func_trace)

        pers: List[Dict[str, torch.Tensor]] = []
        with torch.inference_mode():
            for i, batch in enumerate(batches):
                seen = i * self.ecfg.batch_size
                carry, per = self._step(carry, batch, seen, nw, w_eff)
                if self.ecfg.collect:
                    pers.append(per)
            collected = {}
            if pers:
                collected = {
                    k: torch.cat([p[k] for p in pers])[:count] for k in PER_INSTRUCTION_KEYS
                }
            host = device_get({"carry": carry, "arrays": collected})

        metrics: Dict[str, Any] = {}
        for s in self._specs:
            out = s.finalize(host["carry"][s.name], count)
            clash = set(out) & set(metrics)
            if clash:
                raise ValueError(
                    f"metric spec {s.name!r} finalized key(s) {sorted(clash)} "
                    "already emitted by an earlier spec in this run"
                )
            reserved = set(out) & _RESERVED_RESULT_ATTRS
            if reserved:
                raise ValueError(
                    f"metric spec {s.name!r} finalized reserved key(s) "
                    f"{sorted(reserved)}: SimulationResult instance "
                    "attributes would shadow them"
                )
            metrics.update(out)
        secs = time.perf_counter() - t0
        arrays: Dict[str, Optional[np.ndarray]] = {k: None for k in PER_INSTRUCTION_KEYS}
        arrays.update(host["arrays"])
        return SimulationResult(
            num_instructions=count,
            seconds=secs,
            mips=count / 1e6 / secs,
            metrics=metrics,
            arrays=arrays,
        )


def simulate_trace_engine(
    params: Tao,
    func_trace: np.ndarray,
    cfg: TaoConfig,
    batch_size: int = 64,
    features: Optional[FeatureSet] = None,
    collect: bool = False,
    precision: str = "fp32",
    metrics: Tuple[Union[str, MetricSpec], ...] = DEFAULT_METRICS,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> SimulationResult:
    """One-shot convenience wrapper: build an engine, stream one trace."""
    engine = StreamingEngine(
        params,
        cfg,
        EngineConfig(
            batch_size=batch_size,
            collect=collect,
            precision=precision,
            metrics=metrics,
        ),
        device=device,
    )
    return engine.simulate(func_trace, features=features)
