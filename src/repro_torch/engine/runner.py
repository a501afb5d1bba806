"""Device-resident streaming simulation engine, in PyTorch.

Counterpart of ``repro/engine/runner.py`` on one device.  A functional
trace flows through

  features  ->  fixed-shape (batch_size, W) windows + validity mask  ->
  the Tao forward  ->  device-resident metric accumulators
  (``MetricSpec`` registry)  ->  one host sync  ->  ``SimulationResult``.

Where the features come from follows from what ``simulate`` is given;
there is no ``feature_backend`` setting:

  * a raw trace alone (``features=None``) — the fused route: its columns
    go to the device once, then each batch is ONE launch of the fused
    feature kernel (``kernels/fused``; its plain version on the CPU) with
    the scan state carried across batches.  Features exist only at batch
    granularity.
  * ``features=`` the dict of ``kernels.features.ops.device_feature_arrays``
    — the staged route (the reference's ``"pallas"`` backend): the whole
    trace was extracted once by the staged kernels (``kernels/features``)
    and stays on the engine's device; batches are views of windows cut by
    device-side reshapes, and only the ragged last batch is padded.  One
    extraction serves any number of models.  A tensor on another device
    raises; nothing is copied silently.
  * ``features=`` a ``FeatureSet`` — batches are cut on the host and copied
    to the device one at a time; under ``EngineConfig.prefetch`` (the
    default) through ``prefetch_to_device``, which on the card copies each
    one pinned and without blocking, a batch ahead of the step.

Every route's features are bitwise the NumPy specification's for any
address (the deltas are taken in int64).  Carries stay on the device; the
only device-to-host transfer is one packed copy of every carry (and
collected array) after the last batch.  The carry holds, beside the
specs', the reserved ``"__grid__"`` slot: the trace's running window
offset and window count as int32 device scalars, so the step's shapes and
code do not depend on the trace's length.

The step is built once per geometry and kept in a process-wide cache
(``_STEP_CACHE``; ``cache_stats`` / ``clear_step_cache``), keyed on what it
depends on — the config, batch size, ``collect``, precision, metric specs,
effective window, device and ``ExecutionPlan`` (``engine/plan.py``,
resolved once per engine: on the port always the single-device plan,
whose reducers the step's ``StepContext`` takes) — and not on the
weights, so engines of one shape share an entry.  On a CUDA device the
entry holds the step captured as one CUDA graph (``engine/aot.py``):
``warmup(n)`` captures ahead of time, a first ``simulate`` of a geometry
captures lazily (before its first batch is drawn), and every batch of
every route is copied into the graph's static inputs and replayed.  On
the CPU the entry runs the eager step.  A capture or replay that fails on
CUDA raises; nothing falls back to the eager step.

``precision="int8"`` runs the same forward over the W8A8 quantized
parameters (``core/quant.py``): the step reads a ``QuantTao``, quantized
once per engine on its device, or the pre-quantized ``qparams=`` the
caller passes (the counterpart of the reference's registry / store
injection).  The precision is in the cache key, so int8 has its own entry
and, on the card, its own graph, shared across routes.

Two fault-injection sites (``resilience.faults``) sit where the
reference's do, outside the captured graph and no-ops unless a plan is
injected: ``engine.compile`` on a step-cache miss and ``engine.simulate``
at the top of ``simulate``.
"""
from __future__ import annotations

import dataclasses
import functools
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..analysis.sanitize import allowed_sync
from ..core.dataset import INPUT_KEYS, num_windows, stream_batches
from ..core.features import FeatureSet
from ..core.model import Tao, TaoConfig, tao_forward
from ..core.quant import QuantTao, quantize_tao_params
from ..kernels.features.ops import trace_columns
from ..kernels.fused.ops import FusedExtractor
from ..resilience.faults import fault_point
from ..uarch.isa import NUM_REGS
from .aot import CapturedStep
from .metrics import DEFAULT_METRICS, MetricSpec, StepContext, resolve_metrics
from .plan import ExecutionPlan

__all__ = [
    "EngineConfig",
    "PRECISIONS",
    "PER_INSTRUCTION_KEYS",
    "MetricNotCollectedError",
    "MetricNotComputedError",
    "SimulationResult",
    "StreamingEngine",
    "cache_stats",
    "clear_step_cache",
    "device_get",
    "prefetch_to_device",
    "simulate_trace_engine",
]


# ---------------------------------------------------------------------------
# Host->device prefetch, shared by the engine's host route and the trainer
# (core/transfer.py).
# ---------------------------------------------------------------------------

_PREFETCH_STOP = object()


def _threaded_prefetch(host_batches: Iterable, put: Callable, depth: int) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    error: list = []

    def produce():
        try:
            for b in host_batches:
                dev = put(b)
                while not stop.is_set():
                    try:
                        q.put(dev, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # raised again in the consumer
            error.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_PREFETCH_STOP, timeout=0.1)
                    break
                except queue.Full:
                    continue

    producer = threading.Thread(target=produce, name="batch-prefetch", daemon=True)
    producer.start()
    try:
        while True:
            item = q.get()
            if item is _PREFETCH_STOP:
                break
            yield item
    finally:
        # exhaustion, a consumer error or an abandoned generator: unpark
        # the producer and drop the batches it made that nobody took
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        producer.join()
        if error:
            raise error[0]


def prefetch_to_device(
    host_batches: Iterable,
    device_put: Optional[Callable] = None,
    *,
    device: Union[str, torch.device],
    threaded: Optional[bool] = None,
    depth: int = 2,
) -> Iterator:
    """Host->device prefetch over an iterator of host batches (trees of
    NumPy arrays), yielding each batch on ``device`` in order.

    ``device_put(batch)`` places one batch (default: the single plan's
    ``ExecutionPlan.device_put`` onto ``device``: on the card pinned and
    copied without blocking).  Two modes:

    * **inline** (the CPU's default): batch i+1 is placed before batch i
      is yielded, on the consumer's thread — one ahead, no thread.
    * **threaded** (the default on a CUDA device, as in the reference): a
      daemon producer thread cuts and places batches into a queue
      ``depth`` deep, so the host work of batch i+1 overlaps the
      consumer's work on batch i where that work releases the interpreter
      lock.  The engine's host route and the trainer pass
      ``threaded=False``: on the card their producer's work and the
      consumer's replay loop are both short Python-level calls that take
      turns at the lock, and the thread measured slower than inline
      (chip_smoke.py, phases sweep and train).

    Nothing runs until the first batch is asked for: a caller that
    captures a CUDA graph does so before that, while no producer makes
    CUDA calls (a capture forbids them on every thread).  A producer
    error is raised again in the consumer; ``close()`` or an early
    ``break`` stops the producer.  ``depth < 1`` raises.
    """
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    device = torch.device(device)
    put = device_put if device_put is not None else functools.partial(
        ExecutionPlan.single().device_put, device=device)
    if threaded is None:
        threaded = device.type == "cuda"
    if threaded:
        return _threaded_prefetch(host_batches, put, depth)

    def inline():
        it = iter(host_batches)
        try:
            cur = put(next(it))
        except StopIteration:
            return
        for nxt in it:
            nxt_dev = put(nxt)
            yield cur
            cur = nxt_dev
        yield cur

    return inline()

PRECISIONS = ("fp32", "int8")

# per-instruction prediction arrays the step can emit under collect=True
PER_INSTRUCTION_KEYS = ("fetch_lat", "exec_lat", "mispred_prob", "dlevel")

# what the step reads of the staged route's device feature arrays
_DEVICE_ARRAY_KEYS = INPUT_KEYS + ("is_branch", "is_mem")

# SimulationResult instance attributes that would shadow a same-named
# metric (instance dict wins over __getattr__)
_RESERVED_RESULT_ATTRS = frozenset(
    ("num_instructions", "seconds", "mips", "metrics")
)

# reserved carry slot threading the trace's window grid (running window
# offset + total windows) through the step for windowed MetricSpecs
_GRID_KEY = "__grid__"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_size: int = 64
    collect: bool = False        # also return per-instruction predictions
    # host route: cut and copy batches ahead of the step (prefetch_to_device)
    prefetch: bool = True
    # partitioning: None resolves to the single-device plan (the only one)
    plan: Optional[ExecutionPlan] = None
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
    for float32 and int32) and unpacked on the host.  The copy is the
    sanctioned end-of-trace sync: it passes ``analysis.sanitize``'s guard
    (``allowed_sync``)."""
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
    packed = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    with allowed_sync():  # the sanctioned pull: passes a sanitized block's guard
        flat = packed.cpu().numpy()
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


class _CachedStep:
    """The step of one geometry, shared across engines with identical
    (cfg, ecfg, device): params are an argument, so engines of one shape
    reuse one entry.

    ``fn`` is the eager step.  ``aot`` holds the ``CapturedStep`` (one CUDA
    graph) once ``StreamingEngine.warmup`` or a first ``simulate`` on a
    CUDA device captured the geometry; ``compiles`` counts captures and
    ``est_bytes`` is the device bytes the capture retains
    (``capture_bytes_estimate``).  On the CPU ``aot`` stays None.
    """

    __slots__ = ("fn", "compiles", "aot", "est_bytes")

    def __init__(self):
        self.fn = None
        self.compiles = 0
        self.aot: Optional[CapturedStep] = None
        self.est_bytes: Optional[int] = None

    def __call__(self, params, carry, batch):
        # code that runs the step directly (tests, custom loops) calls the
        # entry like a bare step: always the eager ``fn``, on any device;
        # engines replay ``aot`` themselves in simulate()
        return self.fn(params, carry, batch)


_STEP_CACHE: Dict[tuple, _CachedStep] = {}

# entry-reuse counters behind cache_stats(): a hit means an engine needed a
# step and an already-built entry (its own or the process cache's) served
# it; a miss means a new step was built
_STEP_STATS: Dict[str, int] = {"hits": 0, "misses": 0}


def cache_stats() -> Dict[str, int]:
    """Inspect the process-wide step cache: entry count, hit/miss
    counters, captures, and the estimated device bytes the captured
    entries retain (``entries_unmeasured`` counts entries with no capture,
    whose retained bytes the estimate does not see)."""
    measured = [e.est_bytes for e in _STEP_CACHE.values() if e.est_bytes]
    return {
        "entries": len(_STEP_CACHE),
        "hits": _STEP_STATS["hits"],
        "misses": _STEP_STATS["misses"],
        "compiles": sum(e.compiles for e in _STEP_CACHE.values()),
        "aot_compiled": sum(1 for e in _STEP_CACHE.values() if e.aot is not None),
        "retained_bytes_est": sum(measured),
        "entries_unmeasured": sum(1 for e in _STEP_CACHE.values() if not e.est_bytes),
    }


def clear_step_cache() -> int:
    """Drop every cached step (returns how many were dropped).  Engines
    already holding an entry keep it alive until they are collected; new
    engines re-build.  Hit/miss counters keep accumulating — snapshot
    ``cache_stats()`` around a region to attribute its traffic."""
    n = len(_STEP_CACHE)
    _STEP_CACHE.clear()
    return n


class StreamingEngine:
    """Stream any number of traces through one model on one device.

    ``params`` (a ``core.model.Tao``) is moved to ``device`` in place, as
    ``nn.Module.to`` does (default ``cuda``; without CUDA this raises
    unless ``device="cpu"``), and so is ``qparams``, a pre-quantized
    ``QuantTao`` of ``params`` that ``precision="int8"`` then uses in place
    of quantizing them itself.  ``num_compiles`` counts the captures of the
    steps this engine used (shared with engines of the same shape: at most
    one per effective window either way; 0 on the CPU).  ``plan`` is the
    ``ExecutionPlan`` resolved once from ``ecfg.plan``.
    """

    def __init__(
        self,
        params: Tao,
        cfg: TaoConfig,
        ecfg: EngineConfig = EngineConfig(),
        *,
        device: Optional[Union[str, torch.device]] = None,
        qparams: Optional[QuantTao] = None,
    ):
        if ecfg.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {ecfg.batch_size}")
        if ecfg.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {ecfg.precision!r}"
            )
        self.plan = ExecutionPlan.resolve(batch_size=ecfg.batch_size, plan=ecfg.plan)
        self._specs: Tuple[MetricSpec, ...] = resolve_metrics(ecfg.metrics)
        for s in self._specs:
            if s.name == _GRID_KEY:
                raise ValueError(
                    f"metric name {_GRID_KEY!r} is reserved for the "
                    "engine's window-grid carry"
                )
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self._qparams = None if qparams is None else qparams.to(self.device)
        self.cfg = cfg
        self.ecfg = ecfg
        self._steps: Dict[int, _CachedStep] = {}  # effective window -> step

    @property
    def num_compiles(self) -> int:
        """Captures of the steps this engine used (shared with engines of
        identical shape: at most one per effective window either way)."""
        return sum(e.compiles for e in self._steps.values())

    # ---- the step ---------------------------------------------------------

    def _build_step(self, w_eff: int):
        """The eager step ``(params, carry, batch) -> (carry, per)`` for
        (batch_size, ``w_eff``) batches.  It reads nothing of the engine
        but its shape, and nothing back to the host, so it is shared and
        captured as it is."""
        cfg = self.cfg
        specs = self._specs
        collect = self.ecfg.collect
        bsz = self.ecfg.batch_size
        actx = self.plan.axis_context()

        @torch.inference_mode()
        def step(params: Union[Tao, QuantTao], carry: Dict, batch: Dict[str, torch.Tensor]):
            valid = batch["valid"].reshape(-1)
            dev = valid.device
            out = tao_forward(params, {k: batch[k] for k in INPUT_KEYS}, cfg)
            fetch = torch.clamp(out["fetch_lat"], min=0.0).reshape(-1)
            execl = torch.clamp(out["exec_lat"], min=0.0).reshape(-1)
            misp = torch.sigmoid(out["mispred_logit"]).reshape(-1)
            dlev = torch.argmax(out["dlevel_logits"], dim=-1).to(torch.int32).reshape(-1)
            on = valid > 0
            gidx = torch.arange(valid.shape[0], dtype=torch.float32, device=dev)
            # trace-global window index of each row, from the grid carry
            grid = carry[_GRID_KEY]
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
                win_index=grid["seen"] + torch.arange(b_local, dtype=torch.int32, device=dev),
                num_windows=grid["total"],
                psum=actx.psum,
                pmax=actx.pmax,
            )
            new_carry = {s.name: s.update(carry[s.name], ctx) for s in specs}
            new_carry[_GRID_KEY] = {"seen": grid["seen"] + bsz, "total": grid["total"]}
            per = {}
            if collect:
                per = {"fetch_lat": fetch, "exec_lat": execl, "mispred_prob": misp, "dlevel": dlev}
            return new_carry, per

        return step

    def _get_step(self, w_eff: int) -> _CachedStep:
        entry = self._steps.get(w_eff)
        if entry is None:
            # keyed on exactly what the step depends on; the weights are
            # not in the key (they are an argument, copied in per simulate)
            key = (
                self.cfg,
                self.ecfg.batch_size,
                self.ecfg.collect,
                self.ecfg.precision,
                self.device,
                self.plan,
                self._specs,
                w_eff,
            )
            entry = _STEP_CACHE.get(key)
            if entry is None:
                fault_point("engine.compile", payload=f"w{w_eff}")
                _STEP_STATS["misses"] += 1
                entry = _CachedStep()
                entry.fn = self._build_step(w_eff)
                _STEP_CACHE[key] = entry
            else:
                _STEP_STATS["hits"] += 1
            self._steps[w_eff] = entry
        else:
            _STEP_STATS["hits"] += 1
        return entry

    def init_carry(self, n: int) -> Dict[str, Any]:
        """The initial carry for a trace of ``n`` instructions: every
        requested spec's ``init()`` on the engine's device plus the
        reserved window-grid slot (``seen``: the running window offset,
        ``total``: the trace's windows; int32 device scalars).  Code driving
        the step directly (``step_entry_for(n)(params, carry, batch)``)
        starts from this."""
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
        carry = {s.name: s.init(self.device) for s in self._specs}
        carry[_GRID_KEY] = {
            "seen": torch.zeros((), dtype=torch.int32, device=self.device),
            # a fill, not torch.tensor's copy from the host (a sync on the card)
            "total": torch.full((), nw, dtype=torch.int32, device=self.device),
        }
        return carry

    def step_entry_for(self, n: int) -> _CachedStep:
        """The cached step entry ``simulate`` uses for a trace of length
        ``n`` (created lazily; its ``compiles`` counter attributes
        captures)."""
        if n < 1:
            raise ValueError("cannot simulate an empty trace")
        return self._get_step(min(self.cfg.window, n))

    # ---- ahead-of-time capture ------------------------------------------

    def _abstract_batch(self, w_eff: int) -> Dict[str, torch.Tensor]:
        """``meta`` tensors of one step batch: the shapes and dtypes every
        route's batches have for this engine's geometry."""
        b = self.ecfg.batch_size
        f = self.cfg.features

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        return {
            "opcode": meta((b, w_eff), torch.int32),
            "regbits": meta((b, w_eff, NUM_REGS), torch.float32),
            "flags": meta((b, w_eff, f.flags_dim), torch.float32),
            "brhist": meta((b, w_eff, f.n_queue), torch.float32),
            "memdist": meta((b, w_eff, f.n_mem), torch.float32),
            "valid": meta((b, w_eff), torch.float32),
            "is_branch": meta((b, w_eff), torch.bool),
            "is_mem": meta((b, w_eff), torch.bool),
        }

    def _capture(self, entry: _CachedStep, n: int) -> CapturedStep:
        w_eff = min(self.cfg.window, n)
        captured = CapturedStep(entry.fn, self._run_params(), self.init_carry(n),
                                self._abstract_batch(w_eff))
        entry.aot = captured
        entry.compiles += 1
        entry.est_bytes = captured.bytes_estimate
        return captured

    def _run_params(self) -> Union[Tao, QuantTao]:
        """The parameters the step reads: the engine's ``Tao``, or under
        ``precision="int8"`` its ``QuantTao`` — the injected ``qparams``, or
        quantized here once per engine on its device."""
        if self.ecfg.precision != "int8":
            return self.params
        if self._qparams is None:
            self._qparams = quantize_tao_params(self.params)
        return self._qparams

    def warmup(self, n: int) -> _CachedStep:
        """Capture the step for traces of length ``n`` ahead of time, so the
        first real batch replays a ready graph.  On the CPU there is no
        graph: the entry is returned with ``aot`` None.  Idempotent per
        geometry; raises if the capture fails."""
        entry = self.step_entry_for(n)
        if entry.aot is None and self.device.type == "cuda":
            self._capture(entry, n)
        return entry

    def _host_batches(self, fs: FeatureSet, func_trace: np.ndarray) -> Iterator[Dict]:
        """Precomputed features: host batches copied to the device, through
        ``prefetch_to_device`` under ``ecfg.prefetch`` (inline, placed by the
        plan: pinned and copied without blocking, one batch ahead), else one
        synchronous copy at a time."""
        host = stream_batches(
            fs,
            self.cfg.window,
            self.ecfg.batch_size,
            stride=self.cfg.window,
            extra={"is_branch": func_trace["is_branch"], "is_mem": func_trace["is_mem"]},
        )
        if self.ecfg.prefetch:
            # one batch ahead on this thread: a producer thread measured
            # slower on the card (it and the replay loop take turns at the
            # interpreter lock; chip_smoke.py, phase sweep)
            return prefetch_to_device(
                host, functools.partial(self.plan.device_put, device=self.device), device=self.device,
                threaded=False)
        return ({k: torch.from_numpy(v).to(self.device) for k, v in b.items()} for b in host)

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
        # made on the device: a copy from the host would wait for the card
        valid = torch.zeros((nb * bsz, w_eff), dtype=torch.float32, device=self.device)
        valid[:nw] = 1.0
        valid = valid.reshape(nb, bsz, w_eff)
        for i in range(nb):
            feats = extractor.next_batch(per)
            batch = {k: v.reshape((bsz, w_eff) + v.shape[1:]) for k, v in feats.items()}
            batch["valid"] = valid[i]
            yield batch

    def _check_device_arrays(self, arrays: Dict[str, torch.Tensor]) -> int:
        """The staged route's arrays: every key the step reads, one length,
        all on this engine's device.  Returns the length."""
        missing = [k for k in _DEVICE_ARRAY_KEYS if k not in arrays]
        if missing:
            raise ValueError(f"device feature arrays lack {missing}")
        n = arrays["opcode"].shape[0]
        for k in _DEVICE_ARRAY_KEYS:
            t = arrays[k]
            if t.device.type != self.device.type or (
                self.device.index is not None and t.device.index != self.device.index
            ):
                raise ValueError(
                    f"device feature array {k!r} is on {t.device}, the engine "
                    f"on {self.device}: extract with device_feature_arrays(..., "
                    "device=<the engine's device>)"
                )
            if t.shape[0] != n:
                raise ValueError(f"device feature array {k!r} has {t.shape[0]} rows, opcode {n}")
        return n

    def _device_batches(
        self, arrays: Dict[str, torch.Tensor], w_eff: int, count: int
    ) -> Iterator[Dict]:
        """Whole-trace features already on the device: windows are
        device-side reshapes (non-overlapping, stride == window), a batch is
        a slice of them, and only the ragged last batch is zero-padded.
        Layout and validity are the other routes'."""
        bsz = self.ecfg.batch_size
        nw = count // w_eff
        wins = {
            k: arrays[k][:count].reshape((nw, w_eff) + arrays[k].shape[1:])
            for k in _DEVICE_ARRAY_KEYS
        }
        valid = torch.ones((bsz, w_eff), dtype=torch.float32, device=self.device)
        for lo in range(0, nw, bsz):
            rows = min(bsz, nw - lo)
            batch = {k: v[lo : lo + rows] for k, v in wins.items()}
            if rows < bsz:
                batch = {
                    k: torch.cat([v, v.new_zeros((bsz - rows,) + v.shape[1:])])
                    for k, v in batch.items()
                }
                batch["valid"] = torch.cat([valid[:rows], valid.new_zeros((bsz - rows, w_eff))])
            else:
                batch["valid"] = valid
            yield batch

    def _batches(
        self,
        func_trace: np.ndarray,
        features: Optional[Union[FeatureSet, Dict[str, torch.Tensor]]],
    ) -> Tuple[int, int, Iterator[Dict]]:
        """``(n, count, batches)`` of one trace on the route ``features``
        picks: its length, the instructions the window grid simulates (the
        tail past the last whole window is not, as in the reference) and
        the iterator of its step batches."""
        cfg = self.cfg
        if features is None:
            n = len(func_trace)
        elif isinstance(features, FeatureSet):
            n = len(features)
        elif isinstance(features, dict):
            n = self._check_device_arrays(features)
        else:
            raise TypeError(
                "features must be None, a FeatureSet or the dict of "
                f"device_feature_arrays, got {type(features).__name__}"
            )
        if n == 0:
            raise ValueError("cannot simulate an empty trace")
        w_eff = min(cfg.window, n)
        count = num_windows(n, cfg.window, cfg.window) * w_eff
        if features is None:
            batches = self._fused_batches(trace_columns(func_trace, cfg.features), w_eff, count)
        elif isinstance(features, FeatureSet):
            batches = self._host_batches(features, func_trace)
        else:
            batches = self._device_batches(features, w_eff, count)
        return n, count, batches

    def _result(
        self, carry: Dict, pers: List[Dict[str, torch.Tensor]], count: int, t0: float
    ) -> SimulationResult:
        """One packed device-to-host copy of the final carry and the
        collected arrays, then every spec's ``finalize``."""
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

    def simulate(
        self,
        func_trace: np.ndarray,
        features: Optional[Union[FeatureSet, Dict[str, torch.Tensor]]] = None,
    ) -> SimulationResult:
        """Simulate one trace; ``features`` picks the route (module note):
        None (the fused route from ``func_trace``), the dict of
        ``device_feature_arrays`` on this engine's device, or a host
        ``FeatureSet``.  On a CUDA device every batch replays the step's
        graph, captured at the geometry's first simulate unless ``warmup``
        captured it."""
        t0 = time.perf_counter()
        fault_point("engine.simulate")
        n, count, batches = self._batches(func_trace, features)
        entry = self._get_step(min(self.cfg.window, n))
        carry = self.init_carry(n)
        params = self._run_params()
        pers: List[Dict[str, torch.Tensor]] = []
        with torch.inference_mode():
            if self.device.type == "cuda":
                graph = entry.aot if entry.aot is not None else self._capture(entry, n)
                graph.load(params, carry)
                for batch in batches:
                    per = graph.replay(batch)
                    if self.ecfg.collect:
                        pers.append({k: v.clone() for k, v in per.items()})
                carry = graph.carry
            else:
                for batch in batches:
                    carry, per = entry(params, carry, batch)
                    if self.ecfg.collect:
                        pers.append(per)
            return self._result(carry, pers, count, t0)


def simulate_trace_engine(
    params: Tao,
    func_trace: np.ndarray,
    cfg: TaoConfig,
    batch_size: int = 64,
    features: Optional[Union[FeatureSet, Dict[str, torch.Tensor]]] = None,
    collect: bool = False,
    precision: str = "fp32",
    metrics: Tuple[Union[str, MetricSpec], ...] = DEFAULT_METRICS,
    *,
    plan: Optional[ExecutionPlan] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> SimulationResult:
    """One-shot convenience wrapper: build an engine, stream one trace
    (``features`` picks the route, as in ``StreamingEngine.simulate``)."""
    engine = StreamingEngine(
        params,
        cfg,
        EngineConfig(
            batch_size=batch_size,
            collect=collect,
            plan=plan,
            precision=precision,
            metrics=metrics,
        ),
        device=device,
    )
    return engine.simulate(func_trace, features=features)
