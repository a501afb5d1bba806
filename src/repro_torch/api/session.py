"""The ``repro_torch.api`` Session facade — Tao's paper workflow as one
surface (PyTorch port of ``repro/api/session.py``).

The paper's three contributions are workflow-level: functional traces that
are *reusable* across microarchitectures, one model that predicts *many*
performance metrics, and *fast transfer* between µarch configs.  This
module owns that workflow end to end:

    from repro_torch.api import Session
    from repro_torch.uarch import UARCH_A

    s = Session(cfg)                                # one model config, on cuda
    tr = s.capture("dee", 20_000)                   # reusable func trace
    model = s.train(UARCH_A, [tr], epochs=8)        # §4.2 multi-metric model
    res = model.simulate(s.capture("mcf", 10_000))  # CPI / MPKI on device
    res.cpi, res.branch_mpki, res.available_metrics

    joint = s.train_joint(ua, ub, [tr])             # §4.3 Algorithm 1
    fast = joint.transfer(s.dataset(uc, [tr]))      # frozen-embed fine-tune

    report = s.sweep({"a": model, "b": fast}, [tr1, tr2])   # async DSE sweep
    report.traces_per_s, report.num_compiles        # <= 1 capture per geometry

Everything underneath is the port's machinery — ``core.transfer`` /
``core.multiarch`` for training, the streaming engine (with its pluggable
``MetricSpec`` registry) for simulation, and ``engine.scheduler`` for
double-buffered multi-trace sweeps.  Where the reference picks a
``feature_backend``, the port picks a ``route`` (``engine.ROUTES``):
``"fused"`` (the default: one fused feature kernel per batch), ``"staged"``
(whole-trace device feature arrays) or ``"host"`` (NumPy features, through
the artifact store when there is one).  Every entry runs on the Session's
``device`` (default ``cuda``; without CUDA it raises unless
``device="cpu"``).  Models hold ``core.model.Tao`` modules (joint models a
``core.multiarch.MultiArch``); store entries that use no ``TaoConfig`` in
their keys (traces, detailed-sim summaries, labelled features, int8 trees)
are shared with the reference package both ways.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..convert import params_from_jax, params_to_jax, qparams_from_jax, qparams_to_jax
from ..core.align import build_adjusted_trace
from ..core.dataset import (
    StreamingWindowDataset,
    WindowDataset,
    build_windows,
    concat_datasets,
)
from ..core.features import FeatureSet, extract_features
from ..core.model import Tao, TaoConfig, init_tao
from ..core.multiarch import METHODS, MultiArch, eval_loss, init_multiarch, make_joint_step
from ..core.quant import QUANT_VERSION, QuantTao, quantize_tao_params
from ..core.selection import (
    measure_design_metrics,
    select_pair_euclidean,
    select_pair_mahalanobis,
    select_random,
)
from ..core.transfer import (
    TrainResult,
    train_tao_impl,
    transfer_finetune,
    warmup_train_step,
)
from ..engine.aot import enable_persistent_cache, persistent_cache_status
from ..engine.metrics import DEFAULT_METRICS, MetricSpec
from ..engine.plan import ExecutionPlan
from ..engine.runner import EngineConfig, SimulationResult, StreamingEngine, prefetch_to_device
from ..engine.scheduler import ROUTES, SweepJob, SweepReport, TraceSweeper
from ..kernels.features.ops import device_feature_arrays, trace_columns
from ..store import (
    ArtifactStore,
    array_digest,
    config_token,
    content_key,
    features_to_tree,
    tree_digest,
    tree_to_features,
)
from ..train.optim import AdamWConfig, adamw_init
from ..uarch import (
    MicroArchConfig,
    get_benchmark,
    run_detailed,
    run_functional,
    sample_design_space,
)
from ..uarch.program import Program

__all__ = [
    "Trace",
    "TrainedModel",
    "JointModel",
    "DesignSpace",
    "Session",
]

Metrics = Tuple[Union[str, MetricSpec], ...]
# Session.dataset returns either flavor; both feed train/train_joint/transfer
Dataset = Union[WindowDataset, StreamingWindowDataset]
Device = Optional[Union[str, torch.device]]

# warn when one model accumulates this many engine configs (usually a sign
# of per-call inline MetricSpec construction — each config = a CUDA graph
# capture on the card)
_ENGINE_CACHE_WARN = 8


def _named(kind: str, items, name_of) -> Dict:
    """Sequence -> {name: item}, refusing silent collisions (a dict input
    passes through — its keys are already unique)."""
    if isinstance(items, dict):
        return items
    out: Dict = {}
    for i, item in enumerate(items):
        name = name_of(item) or f"{kind}{i}"
        if name in out:
            raise ValueError(
                f"duplicate {kind} name {name!r}; pass a dict with unique "
                f"keys or give each {kind} a distinct .name"
            )
        out[name] = item
    return out


# what a model made from another (a transfer, a joint model's head)
# inherits from it
_STAMP = ("sim_batch_size", "sim_route", "sim_precision", "sim_plan", "store", "device")


def _stamp(model) -> Dict:
    return {k: getattr(model, k) for k in _STAMP}


def _check_route(route: str) -> str:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    return route


# ---------------------------------------------------------------------------
# Artifacts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Trace:
    """A reusable functional-trace artifact (µarch-agnostic by §4.1): one
    capture serves training datasets, ground truth, and simulation on every
    design point."""

    name: str
    functional: np.ndarray                     # FUNC_TRACE_DTYPE
    program: Program = dataclasses.field(repr=False)
    benchmark: Optional[str] = None

    def __len__(self) -> int:
        return len(self.functional)

    @property
    def num_instructions(self) -> int:
        return len(self.functional)

    @functools.cached_property
    def digest(self) -> str:
        """Stable blake2b content identity of the functional trace — the
        same scheme the sweep scheduler's feature dedup and the artifact
        store key on (the reference's, bitwise), so a trace re-captured in
        another process, or by the reference package, maps to the same
        cached artifacts."""
        return array_digest(self.functional)


def quantized_params_key(params: Union[Tao, Mapping[str, torch.Tensor]]) -> str:
    """Content key a model's int8 quantization is stored under: derived
    from the fp32 weights' digest in the reference's tree layout plus the
    scheme version (``core.quant.QUANT_VERSION``), so for the same weights
    it is the reference's key, string for string, and a scheme bump
    invalidates stale trees instead of silently reusing them."""
    return content_key("params_int8", tree_digest(params_to_jax(params)), f"v{QUANT_VERSION}")


@dataclasses.dataclass
class TrainedModel:
    """Trained Tao parameters (a ``core.model.Tao``, moved to ``device``)
    bound to their config: the simulate/transfer half of the workflow.
    Engines are cached per EngineConfig, so repeated ``simulate`` calls
    (and every model of the same shape, via the process-wide step cache)
    reuse one captured step."""

    params: Tao
    cfg: TaoConfig
    name: str = "tao"
    uarch: Optional[MicroArchConfig] = None
    losses: List[float] = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    steps: int = 0
    # simulate() defaults: Session.train stamps its batch_size, route,
    # precision, and ExecutionPlan here so simulate() and Session.sweep()
    # replay the same captured step and take the same feature path
    sim_batch_size: int = 64
    sim_route: str = "fused"
    sim_precision: str = "fp32"
    sim_plan: Optional[ExecutionPlan] = None
    # artifact store stamped by the owning Session: simulate() loads/saves
    # host-route features through it, so a warm store skips extraction
    store: Optional[ArtifactStore] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # None resolves to cuda (and raises without it)
    device: Device = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device)
        _check_route(self.sim_route)
        self._engines: Dict[EngineConfig, StreamingEngine] = {}
        self._qparams: Optional[QuantTao] = None

    def engine(self, ecfg: Optional[EngineConfig] = None, **kw) -> StreamingEngine:
        """The cached StreamingEngine for an EngineConfig (or kwargs)."""
        if ecfg is None:
            ecfg = EngineConfig(**kw)
        elif kw:
            ecfg = dataclasses.replace(ecfg, **kw)
        engine = self._engines.get(ecfg)
        if engine is None:
            # int8 engines get the stored quantized tree so every process
            # shares one set of scales instead of re-deriving them per
            # engine
            qp = self.quantized_params() if ecfg.precision == "int8" else None
            engine = StreamingEngine(self.params, self.cfg, ecfg, device=self.device, qparams=qp)
            self._engines[ecfg] = engine
            if len(self._engines) == _ENGINE_CACHE_WARN:
                warnings.warn(
                    f"{len(self._engines)} engine configurations cached on "
                    f"model {self.name!r} — each costs a CUDA graph capture. "
                    "Inline-constructed MetricSpecs hash by identity; reuse "
                    "module-level spec instances (register_metric) instead "
                    "of building them per call.",
                    RuntimeWarning,
                    stacklevel=3,
                )
        return engine

    def simulate(
        self,
        trace: Union[Trace, np.ndarray],
        *,
        metrics: Optional[Metrics] = None,
        collect: bool = False,
        batch_size: Optional[int] = None,
        route: Optional[str] = None,
        precision: Optional[str] = None,
        features: Optional[Union[FeatureSet, Dict[str, torch.Tensor]]] = None,
        plan: Optional[ExecutionPlan] = None,
    ) -> SimulationResult:
        """Stream one functional trace through the model; ``metrics`` picks
        the device-side ``MetricSpec``s (default CPI + branch/L1D MPKI).
        ``plan=``, ``route=`` and ``precision=`` override the stamped
        ``sim_plan`` / ``sim_route`` / ``sim_precision``; explicit
        ``features`` (a ``FeatureSet`` or ``device_feature_arrays``) go to
        the engine as they are."""
        route = _check_route(route or self.sim_route)
        engine = self.engine(
            batch_size=batch_size if batch_size is not None else self.sim_batch_size,
            collect=collect,
            precision=precision or self.sim_precision,
            plan=plan if plan is not None else self.sim_plan,
            metrics=tuple(metrics) if metrics is not None else DEFAULT_METRICS,
        )
        ft = trace.functional if isinstance(trace, Trace) else trace
        if features is None and route == "staged":
            fcfg = self.cfg.features
            features = device_feature_arrays(trace_columns(ft, fcfg), fcfg, device=self.device)
        elif features is None and route == "host":
            if self.store is not None:
                features = self._stored_features(trace, ft)
            else:
                features = extract_features(ft, self.cfg.features, with_labels=False)
        return engine.simulate(ft, features=features)

    def _stored_features(self, trace, ft: np.ndarray) -> FeatureSet:
        """Inference features through the artifact store (same key the
        sweep scheduler uses, so simulate() and sweeps share entries)."""
        dg = trace.digest if isinstance(trace, Trace) else array_digest(ft)
        key = content_key("features", dg, self.cfg.features)
        hit = self.store.get("features", key)
        if hit is not None:
            return tree_to_features(hit[0])
        fs = extract_features(ft, self.cfg.features, with_labels=False)
        self.store.put("features", key, features_to_tree(fs))
        return fs

    def quantized_params(self) -> QuantTao:
        """The W8A8 quantized twin of ``params`` (``core/quant.py``):
        per-channel int8 weights + scales, computed once per model and —
        when the owning Session stamped an artifact store — persisted
        content-addressed under ``quantized_params_key`` in the
        reference's tree layout, so any process of either package
        resolving this model reuses the stored scales instead of
        re-deriving them."""
        if self._qparams is not None:
            return self._qparams
        # the module of the model's shape; a stored tree replaces its
        # codes and scales
        q = quantize_tao_params(self.params)
        if self.store is not None:
            key = quantized_params_key(self.params)
            hit = self.store.get("params_int8", key)
            if hit is not None:
                q.load_state_dict(qparams_from_jax(hit[0]))
            else:
                self.store.put(
                    "params_int8", key, qparams_to_jax(q), {"scheme": "w8a8-per-channel"}
                )
        self._qparams = q
        return q

    @property
    def num_compiles(self) -> int:
        # engines of different routes share one engine per EngineConfig,
        # and engines of other configs may share cached steps, so dedupe
        # the underlying entries before summing
        entries = {}
        for engine in self._engines.values():
            for entry in engine._steps.values():
                entries[id(entry)] = entry
        return sum(e.compiles for e in entries.values())

    def transfer(
        self,
        dataset: "Dataset",
        *,
        freeze_embed: bool = True,
        epochs: int = 10,
        batch_size: int = 16,
        lr: float = 3e-4,
        seed: int = 0,
        target_loss: Optional[float] = None,
        name: Optional[str] = None,
        uarch: Optional[MicroArchConfig] = None,
    ) -> "TrainedModel":
        """Fine-tune this model onto a new µarch's (small) dataset.
        ``freeze_embed=True`` is Tao's scheme (§4.3): the µarch-agnostic
        embedding stays fixed, only adaptation + prediction layers train."""
        res = train_tao_impl(
            self.cfg,
            dataset,
            epochs=epochs,
            batch_size=batch_size,
            lr=lr,
            init_params=self.params,
            freeze_embed=freeze_embed,
            seed=seed,
            target_loss=target_loss,
            device=self.device,
        )
        return _model_from_result(res, self.cfg, name or f"{self.name}-transfer", uarch,
                                  **_stamp(self))


def _model_from_result(res: TrainResult, cfg: TaoConfig, name: str,
                       uarch: Optional[MicroArchConfig], **stamp) -> TrainedModel:
    return TrainedModel(params=res.params, cfg=cfg, name=name, uarch=uarch, losses=res.losses,
                        seconds=res.seconds, steps=res.steps, **stamp)


@dataclasses.dataclass
class JointModel:
    """Result of §4.3 Algorithm-1 joint training over two µarchs: the
    µarch-agnostic embedding plus per-µarch adaptation/prediction heads
    (a ``core.multiarch.MultiArch``: ``embed``, ``A``, ``B``)."""

    params: MultiArch
    cfg: TaoConfig
    method: str
    losses: List[Tuple[float, float]]  # per-epoch (loss_a, loss_b)
    seconds: float = 0.0
    steps: int = 0
    sim_batch_size: int = 64          # inherited by head()/transfer() models
    sim_route: str = "fused"
    sim_precision: str = "fp32"
    sim_plan: Optional[ExecutionPlan] = None
    store: Optional[ArtifactStore] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    device: Device = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device)

    @property
    def embedding(self):
        """The frozen, µarch-agnostic embedding parameters (a ``TaoEmbed``)."""
        return self.params.embed

    def head(self, arch: str = "A", name: Optional[str] = None) -> TrainedModel:
        """Assemble one µarch's full model (copies of the shared embedding
        and its heads)."""
        if arch not in ("A", "B"):
            raise ValueError(f"arch must be 'A' or 'B', got {arch!r}")
        if self.method != "tao":
            # only Algorithm 1 trains the adaptation layers; the other
            # methods' heads were trained on NON-adapted embeddings, and
            # tao_forward applies adapt unconditionally — simulating would
            # route through random weights and silently skew predictions
            raise ValueError(
                f"head() needs trained adaptation layers, which method="
                f"{self.method!r} does not produce; use transfer(...) "
                "(which fine-tunes them) or method='tao'"
            )
        state = {f"embed.{k}": v for k, v in self.params.embed.state_dict().items()}
        state.update(getattr(self.params, arch).state_dict())  # adapt.*, pred.*
        model = init_tao(self.cfg, device=self.device)
        model.load_state_dict(state)
        return TrainedModel(params=model, cfg=self.cfg, name=name or f"joint-{self.method}-{arch}",
                            **_stamp(self))

    def transfer(
        self,
        dataset: "Dataset",
        *,
        donor: str = "A",
        epochs: int = 10,
        batch_size: int = 16,
        lr: float = 3e-4,
        seed: int = 0,
        target_loss: Optional[float] = None,
        name: Optional[str] = None,
        uarch: Optional[MicroArchConfig] = None,
    ) -> TrainedModel:
        """Tao's fast enablement of an unseen µarch: frozen shared
        embeddings + donor-initialized heads, fine-tuned on a small
        dataset (paper Table 5's 29.5x-cheaper regime)."""
        if donor not in ("A", "B"):
            raise ValueError(f"donor must be 'A' or 'B', got {donor!r}")
        res = transfer_finetune(
            self.cfg,
            self.params.embed,
            getattr(self.params, donor),
            dataset,
            epochs=epochs,
            batch_size=batch_size,
            lr=lr,
            seed=seed,
            target_loss=target_loss,
            device=self.device,
        )
        return _model_from_result(res, self.cfg, name or f"transfer-{self.method}", uarch,
                                  **_stamp(self))

    def eval_loss(self, batches, arch: str = "A") -> float:
        # evaluation must mirror training: only method="tao" trains the
        # adaptation layers, so only it routes eval through them
        return eval_loss(
            self.params, batches, self.cfg, arch, use_adapt=self.method == "tao"
        )


# ---------------------------------------------------------------------------
# Design space
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DesignSpace:
    """A set of µarch design points plus the paper's training-pair
    selection (§4.3 Mahalanobis distance over quick detailed-sim metrics)."""

    designs: List[MicroArchConfig]
    # the detailed-sim measurement pass is the expensive half of selection;
    # cache it so comparing selection methods measures once
    _metrics: Dict[tuple, np.ndarray] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @classmethod
    def sample(cls, n: int, seed: int = 0) -> "DesignSpace":
        return cls(designs=list(sample_design_space(n, seed=seed)))

    @classmethod
    def vary(
        cls,
        base: MicroArchConfig,
        field: str,
        values: Sequence,
        name_fmt: str = "{field}{value}",
    ) -> "DesignSpace":
        """Axis sweep: replace one config field across ``values``."""
        return cls(designs=[
            dataclasses.replace(
                base, **{field: v},
                name=name_fmt.format(field=field, value=v),
            )
            for v in values
        ])

    def __len__(self) -> int:
        return len(self.designs)

    def __iter__(self):
        return iter(self.designs)

    def __getitem__(self, i: int) -> MicroArchConfig:
        return self.designs[i]

    def select_pair(
        self,
        benchmarks: Sequence[str],
        *,
        method: str = "mahalanobis",
        instructions: int = 3000,
        seed: int = 0,
    ) -> Tuple[int, int]:
        """Pick the joint-training pair (paper Fig. 14: MD > Euclid > rand).
        Returns indices into ``self.designs``."""
        if method == "random":
            i, j = select_random(len(self.designs), 2, seed=seed)
            return int(i), int(j)
        mkey = (tuple(benchmarks), instructions)
        metrics = self._metrics.get(mkey)
        if metrics is None:
            metrics = measure_design_metrics(
                self.designs, benchmarks, instructions=instructions
            )
            self._metrics[mkey] = metrics
        if method == "mahalanobis":
            return select_pair_mahalanobis(metrics)
        if method == "euclidean":
            return select_pair_euclidean(metrics)
        raise ValueError(
            f"method must be mahalanobis|euclidean|random, got {method!r}"
        )


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------


class Session:
    """One Tao workflow: a model configuration plus the paper's verbs.

    ``capture`` -> reusable functional traces; ``dataset`` -> §4.1 adjusted
    windows for a design point; ``train``/``train_joint`` -> models;
    ``model.simulate``/``sweep`` -> device-resident multi-metric inference.
    Everything runs on ``device`` (default ``cuda``; without CUDA the
    constructor raises unless ``device="cpu"``).
    """

    def __init__(
        self,
        cfg: Optional[TaoConfig] = None,
        *,
        batch_size: int = 64,
        route: str = "fused",
        precision: str = "fp32",
        seed: int = 0,
        streaming_threshold: Optional[int] = 1_000_000,
        plan: Optional[ExecutionPlan] = None,
        store: Optional[Union[ArtifactStore, str]] = None,
        compile_cache: Union[None, bool, str] = None,
        device: Device = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else TaoConfig()
        self.batch_size = batch_size
        # the feature route stamped onto trained models and used by sweeps
        self.route = _check_route(route)
        # Default inference precision stamped onto trained models
        # ("fp32" | "int8"); training itself always runs fp32.
        self.precision = precision
        self.seed = seed
        # Content-addressed artifact store (repro_torch.store): captured
        # traces, labeled/inference FeatureSets, detailed-sim summaries, and
        # trained params persist across processes through it — the second
        # process running the same workflow recomputes none of them.
        if isinstance(store, str):
            store = ArtifactStore(store)
        self.store = store
        # The kernel build cache: built libraries always persist in its
        # directory, so None leaves it where it is (the store holds no
        # compiled code).  True points it at its default directory, a path
        # at that path; False leaves it alone.
        if compile_cache is True:
            enable_persistent_cache()
        elif compile_cache is not None and compile_cache is not False:
            enable_persistent_cache(compile_cache)
        # One partitioning decision for the whole workflow: models trained
        # by this session simulate under it, and Session.sweep composes the
        # trace queue with it.  None (the default) means the single-device
        # path; the port has no other.
        self.plan: Optional[ExecutionPlan] = None
        if plan is not None:
            self.plan = ExecutionPlan.resolve(batch_size=batch_size, plan=plan)
        # dataset()/train() switch to the O(trace + batch) streaming
        # pipeline when the traces hold at least this many instructions
        # combined (None disables the automatic switch); pass
        # ``streaming=True/False`` per call to override.
        self.streaming_threshold = streaming_threshold
        self._traces: Dict[tuple, Trace] = {}
        # key -> (pinned traces, dataset); see Session.dataset
        self._datasets: Dict[tuple, Tuple[Tuple[Trace, ...], Dataset]] = {}
        # (uarch key, id(trace)) -> (pinned trace, detailed trace, summary):
        # ground_truth and dataset share one detailed-sim run per pair (the
        # most expensive operation in the workflow)
        self._detailed: Dict[tuple, tuple] = {}

    def _stamp(self) -> Dict:
        """What every model this session makes inherits."""
        return dict(sim_batch_size=self.batch_size, sim_route=self.route,
                    sim_precision=self.precision, sim_plan=self.plan, store=self.store,
                    device=self.device)

    # ---- step 1: reusable functional traces ----------------------------

    def capture(
        self,
        benchmark: Union[str, Program],
        n: int,
        name: Optional[str] = None,
    ) -> Trace:
        """Run the functional (AtomicSimpleCPU-analogue) simulator once;
        the artifact is reusable across every µarch (paper Fig. 10)."""
        if isinstance(benchmark, Program):
            # key on the object: two Programs sharing a .name must not
            # alias (the cached Trace pins the Program, so its id is
            # stable for the life of the entry)
            prog, bench, source = benchmark, benchmark.name, id(benchmark)
        else:
            prog, bench, source = get_benchmark(benchmark), benchmark, benchmark
        name = name or f"{bench}:{n}"
        key = (source, n, name)  # a custom name never shadows the default
        cached = self._traces.get(key)
        if cached is not None:
            return cached
        # named benchmarks are pure functions of (benchmark, n): store-
        # backed (custom Program objects are not serializable — skip them)
        skey = None
        if self.store is not None and isinstance(source, str):
            skey = content_key("trace", bench, n)
            hit = self.store.get("trace", skey)
            if hit is not None:
                tr = Trace(
                    name=name, functional=hit[0]["functional"],
                    program=prog, benchmark=bench,
                )
                self._traces[key] = tr
                return tr
        tr = Trace(
            name=name,
            functional=run_functional(prog, n),
            program=prog,
            benchmark=bench,
        )
        if skey is not None:
            self.store.put("trace", skey, {"functional": tr.functional})
        self._traces[key] = tr
        return tr

    def _run_detailed(self, uarch: MicroArchConfig, trace: Trace):
        key = (uarch.key(), id(trace))
        cached = self._detailed.get(key)
        if cached is None:
            det, summ = run_detailed(trace.program, trace.functional, uarch)
            cached = (trace, det, summ)  # pin the trace so id() stays valid
            self._detailed[key] = cached
        return cached[1], cached[2]

    def ground_truth(self, uarch: MicroArchConfig, trace: Trace) -> Dict[str, float]:
        """Detailed-simulator metrics for a trace on one design point."""
        skey = None
        if self.store is not None:
            skey = content_key(
                "detail_summary", trace.digest, config_token(uarch)
            )
            hit = self.store.get("detail_summary", skey)
            if hit is not None:
                return dict(hit[1]["summary"])
        _, summ = self._run_detailed(uarch, trace)
        if skey is not None:
            # pure-JSON payload: rides in the manifest, no array files
            self.store.put("detail_summary", skey, {}, {"summary": dict(summ)})
        return summ

    def _adjusted_features(self, uarch: MicroArchConfig, tr: Trace) -> FeatureSet:
        """Labeled per-trace FeatureSet for (trace, µarch): detailed sim →
        §4.1 cycle re-attribution → feature extraction.  Store-backed — a
        warm artifact store skips all three (the expensive half of
        building a training dataset)."""
        skey = None
        if self.store is not None:
            skey = content_key(
                "features_labeled", tr.digest, config_token(uarch),
                self.cfg.features,
            )
            hit = self.store.get("features_labeled", skey)
            if hit is not None:
                return tree_to_features(hit[0])
        det, _ = self._run_detailed(uarch, tr)
        al = build_adjusted_trace(det)
        fs = extract_features(al.adjusted, self.cfg.features)
        if skey is not None:
            self.store.put("features_labeled", skey, features_to_tree(fs))
        return fs

    # ---- datasets (§4.1 adjusted traces -> windows) --------------------

    def dataset(
        self,
        uarch: MicroArchConfig,
        traces: Union[Trace, Iterable[Trace]],
        *,
        dedup: bool = True,
        streaming: Optional[bool] = None,
        dedup_scope: str = "trace",
    ) -> Dataset:
        """Detailed-sim each trace on ``uarch``, re-attribute squash/nop
        cycles (§4.1), extract features, window, and concatenate.

        ``streaming=None`` (default) picks the pipeline by size: at or above
        ``Session.streaming_threshold`` combined instructions the result is
        a ``StreamingWindowDataset`` — zero-copy window views + streaming
        dedup, O(trace + batch) host memory, bit-identical training
        trajectory — otherwise a materialized ``WindowDataset``.
        ``dedup_scope="global"`` (streaming pipeline only) shares the dedup
        reservoir across traces; the default per-trace scope matches the
        materialized pipeline exactly."""
        if isinstance(traces, Trace):
            traces = [traces]
        traces = list(traces)
        if streaming is None:
            streaming = (
                self.streaming_threshold is not None
                and sum(len(t) for t in traces) >= self.streaming_threshold
            )
        if dedup_scope != "trace" and not streaming:
            raise ValueError(
                "dedup_scope is a streaming-pipeline option; the "
                "materialized pipeline always dedups per trace (pass "
                "streaming=True for cross-trace dedup)"
            )
        # key on the trace objects themselves (captures are session-cached,
        # so the normal path hits) — names alone could collide across
        # different traces and hand back the wrong windows.  The cache entry
        # pins the Trace objects so an id() is never recycled while its key
        # is live.
        key = (uarch.key(), tuple(id(t) for t in traces), dedup,
               bool(streaming), dedup_scope, self.cfg.features,
               self.cfg.window)
        cached = self._datasets.get(key)
        if cached is not None:
            return cached[1]
        if streaming:
            # keep only the per-trace FeatureSets (O(trace)); windowing,
            # dedup, and batch materialization all stream from views
            fsets = [self._adjusted_features(uarch, tr) for tr in traces]
            ds: Dataset = StreamingWindowDataset(
                fsets, self.cfg.window, dedup=dedup, dedup_scope=dedup_scope
            )
        else:
            ds = concat_datasets([
                build_windows(
                    self._adjusted_features(uarch, tr),
                    self.cfg.window,
                    dedup=dedup,
                )
                for tr in traces
            ])
        self._datasets[key] = (tuple(traces), ds)
        return ds

    # ---- step 2: training ----------------------------------------------

    def train(
        self,
        uarch: Optional[MicroArchConfig] = None,
        traces: Optional[Union[Trace, Iterable[Trace]]] = None,
        *,
        dataset: Optional[Dataset] = None,
        streaming: Optional[bool] = None,
        epochs: int = 10,
        batch_size: int = 16,
        lr: float = 3e-4,
        init: Optional[Union[TrainedModel, Tao, Mapping[str, torch.Tensor]]] = None,
        freeze_embed: bool = False,
        seed: Optional[int] = None,
        target_loss: Optional[float] = None,
        eval_fn=None,
        name: Optional[str] = None,
        plan: Optional[ExecutionPlan] = None,
    ) -> TrainedModel:
        """Train (or fine-tune) a single-µarch model.  Give ``traces`` and
        the session builds the adjusted dataset for ``uarch`` — streaming
        (O(trace + batch) memory) at or above ``streaming_threshold``
        combined instructions, materialized below; ``streaming=`` forces
        either pipeline.  Or pass a prebuilt ``dataset`` directly.
        ``init`` is a ``TrainedModel``, a ``Tao`` or its state dict.
        ``plan=`` keys the cached train step (the port runs one device)."""
        if dataset is not None and streaming is not None:
            raise ValueError(
                "streaming= only controls how the session builds a dataset "
                "from traces; it cannot change an explicit dataset= (pass "
                "the right flavor directly)"
            )
        init_params = init.params if isinstance(init, TrainedModel) else init
        model_name = name or (uarch.name if uarch is not None else "tao")
        # Trained params are a pure function of the full recipe when the
        # session builds the dataset itself (streaming and materialized
        # pipelines are bit-identical, so streaming= stays out of the key).
        # An explicit dataset= or eval_fn= has state the key cannot see —
        # those train unconditionally.
        skey = None
        if (
            self.store is not None
            and dataset is None
            and eval_fn is None
            and uarch is not None
            and traces is not None
        ):
            trs = [traces] if isinstance(traces, Trace) else list(traces)
            skey = content_key(
                "params",
                config_token(self.cfg),
                config_token(uarch),
                tuple(t.digest for t in trs),
                epochs,
                batch_size,
                lr,
                freeze_embed,
                self.seed if seed is None else seed,
                target_loss,
                tree_digest(params_to_jax(init_params)) if init_params is not None else None,
                plan.cache_token() if plan is not None else None,
            )
            hit = self.store.get("params", skey)
            if hit is not None:
                tree, extra = hit
                params = init_tao(self.cfg, device=self.device)
                params.load_state_dict(params_from_jax(tree))  # the reference's layout
                return TrainedModel(
                    params=params, cfg=self.cfg, name=model_name, uarch=uarch,
                    losses=[float(x) for x in extra.get("losses", [])],
                    seconds=0.0, steps=int(extra.get("steps", 0)),
                    **self._stamp(),
                )
        if dataset is None:
            if uarch is None or traces is None:
                raise ValueError(
                    "train needs (uarch, traces) to build a dataset, or an "
                    "explicit dataset="
                )
            dataset = self.dataset(uarch, traces, streaming=streaming)
        # skey doubles as the crash-resume identity: with a store, every
        # epoch checkpoints a progress manifest, so a SIGKILLed train
        # resumes from the last completed epoch (bit-identical losses and
        # params) instead of starting over
        res = train_tao_impl(
            self.cfg,
            dataset,
            epochs=epochs,
            batch_size=batch_size,
            lr=lr,
            init_params=init_params,
            freeze_embed=freeze_embed,
            eval_fn=eval_fn,
            seed=self.seed if seed is None else seed,
            target_loss=target_loss,
            plan=plan,
            store=self.store if skey is not None else None,
            resume_key=skey,
            device=self.device,
        )
        if skey is not None:
            self.store.put(
                "params", skey, params_to_jax(res.params),
                {"losses": [float(x) for x in res.losses],
                 "steps": int(res.steps)},
            )
        return _model_from_result(res, self.cfg, model_name, uarch, **self._stamp())

    def init_model(self, seed: Optional[int] = None, name: str = "init") -> TrainedModel:
        """An untrained model (random init from a ``torch.Generator``
        seeded by ``seed``) — engine smoke tests, sweeps."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        return TrainedModel(params=init_tao(self.cfg, g, device=self.device), cfg=self.cfg,
                            name=name, **self._stamp())

    def train_joint(
        self,
        uarch_a: MicroArchConfig,
        uarch_b: MicroArchConfig,
        traces: Optional[Union[Trace, Iterable[Trace]]] = None,
        *,
        datasets: Optional[Tuple[Dataset, Dataset]] = None,
        streaming: Optional[bool] = None,
        method: str = "tao",
        epochs: int = 6,
        batch_size: int = 16,
        lr: float = 1e-3,
        seed: Optional[int] = None,
        on_epoch=None,
    ) -> JointModel:
        """§4.3 Algorithm 1: jointly train the µarch-agnostic embedding
        over two design points (``method`` picks the gradient-combination
        rule: {'tao', 'tao_no_adapt', 'granite', 'gradnorm'}).
        ``on_epoch(epoch, params, steps)`` runs after every epoch —
        checkpointing hook."""
        if method not in METHODS:
            raise ValueError(f"method {method!r} not in {METHODS}")
        if datasets is not None:
            if streaming is not None:
                raise ValueError(
                    "streaming= only controls how the session builds "
                    "datasets from traces; it cannot change explicit "
                    "datasets= (pass the right flavor directly)"
                )
            ds_a, ds_b = datasets
        else:
            if traces is None:
                raise ValueError("train_joint needs traces= or datasets=")
            ds_a = self.dataset(uarch_a, traces, streaming=streaming)
            ds_b = self.dataset(uarch_b, traces, streaming=streaming)
        short = min(len(ds_a), len(ds_b))
        if short < batch_size:
            raise ValueError(
                f"joint datasets have {short} windows < batch_size="
                f"{batch_size}: no full batch, training would be a no-op "
                "(shrink batch_size or capture longer traces)"
            )
        seed = self.seed if seed is None else seed
        dev = self.device
        params = init_multiarch(self.cfg, torch.Generator().manual_seed(seed), device=dev)
        opt = adamw_init(dict(params.named_parameters()))
        step = make_joint_step(self.cfg, AdamWConfig(lr=lr), method=method)
        ones = torch.ones(2, device=dev)
        w = torch.ones(2, device=dev)
        initial = None
        rng = np.random.default_rng(seed)
        losses: List[Tuple[float, float]] = []
        steps = 0
        t0 = time.perf_counter()
        for ep in range(epochs):
            m = None
            # inline (depth-1) prefetch for BOTH datasets: batch i+1's
            # host gather + copy is enqueued before step(i) runs.
            # Deliberately not the threaded mode: the two generators share
            # one rng (shuffle drawn lazily at first next, A then B), and
            # producer threads would race on it — inline wrapping consumes
            # the rng in exactly the pre-prefetch order, keeping the batch
            # streams bit-identical.
            for ba, bb in zip(
                prefetch_to_device(ds_a.batches(batch_size, rng=rng), device=dev, threaded=False),
                prefetch_to_device(ds_b.batches(batch_size, rng=rng), device=dev, threaded=False),
            ):
                opt, w, m = step(params, opt, w, initial if initial is not None else ones, ba, bb)
                if initial is None:
                    initial = torch.stack([m["loss_a"], m["loss_b"]])
                steps += 1
            if m is not None:
                losses.append((float(m["loss_a"]), float(m["loss_b"])))
            if on_epoch is not None:
                on_epoch(ep, params, steps)
        return JointModel(
            params=params,
            cfg=self.cfg,
            method=method,
            losses=losses,
            seconds=time.perf_counter() - t0,
            steps=steps,
            **self._stamp(),
        )

    # ---- step 3: multi-trace simulation --------------------------------

    def sweep(
        self,
        models: Union[Sequence[TrainedModel], Dict[str, TrainedModel]],
        traces: Union[Sequence[Trace], Dict[str, Trace]],
        *,
        metrics: Optional[Metrics] = None,
        batch_size: Optional[int] = None,
        route: Optional[str] = None,
        precision: Optional[str] = None,
        collect: bool = False,
        depth: int = 2,
        async_prepare: Optional[bool] = None,
        plan: Optional[ExecutionPlan] = None,
        resume_key: Optional[str] = None,
    ) -> SweepReport:
        """Async DSE sweep: every (model, trace) pair streams through one
        shared captured step; on the host route each distinct trace is
        prepared once (shared across models), and on the card the next
        job's host-side prep is double-buffered behind the device
        execution of the current one.  Result keys are ``model/trace``.

        ``resume_key=`` (any stable string naming the sweep; needs the
        session store) makes the sweep crash-resumable: each completed job
        publishes a progress manifest, and a re-run with the same key
        skips finished jobs entirely (``report.jobs_skipped``) with
        bit-identical results."""
        models = _named("model", models, lambda m: m.name)
        traces = _named("trace", traces, lambda t: t.name)
        for name, m in models.items():
            if m.cfg != self.cfg:
                raise ValueError(
                    f"model {name!r} was built for a different TaoConfig; "
                    "sweeps share one captured step per session config"
                )
        ecfg = EngineConfig(
            batch_size=batch_size or self.batch_size,
            precision=precision or self.precision,
            collect=collect,
            plan=plan if plan is not None else self.plan,
            metrics=tuple(metrics) if metrics is not None else DEFAULT_METRICS,
        )
        jobs = [
            SweepJob(f"{mn}/{tn}", model.params, tr.functional)
            for mn, model in models.items()
            for tn, tr in traces.items()
        ]
        return TraceSweeper(
            self.cfg, ecfg, route=route or self.route, depth=depth,
            async_prepare=async_prepare, store=self.store, device=self.device,
        ).run(jobs, resume_key=resume_key)

    # ---- zero cold start ------------------------------------------------

    def warmup(
        self,
        geometries: Iterable[Union[int, Tuple[int, int]]],
        *,
        plans: Optional[Iterable[Optional[ExecutionPlan]]] = None,
        train: Union[None, bool, Iterable[Dict]] = None,
        metrics: Optional[Metrics] = None,
        collect: bool = False,
    ) -> Dict[str, object]:
        """Capture the session's steps for a declared geometry set before
        any trace, params, or dataset exists.

        ``geometries`` lists trace lengths (``int``, simulated at the
        session batch size) or ``(length, batch_size)`` pairs; ``plans``
        extends the set over extra ExecutionPlans (default: the session's
        own).  ``train=True`` additionally captures the default train step
        (``train=[{"batch_size": ..., "lr": ..., ...}]`` for specific
        recipes).  On the card each geometry's step becomes one CUDA graph
        in the process-wide step cache, so the first ``simulate``/``train``
        replays a ready graph; on the CPU the entries are built and
        nothing is captured (``sim_aot`` 0)."""
        mets = tuple(metrics) if metrics is not None else DEFAULT_METRICS
        plan_list = list(plans) if plans is not None else [self.plan]
        geos = []
        for g in geometries:
            if isinstance(g, (tuple, list)):
                n, bs = g
            else:
                n, bs = g, self.batch_size
            geos.append((int(n), int(bs)))
        # weights of the config's shape, never used: a model's are copied
        # in at each simulate
        shape = init_tao(self.cfg, device=self.device)
        engines: Dict[tuple, StreamingEngine] = {}
        compiled = 0
        aot = 0
        for plan in plan_list:
            for n, bs in sorted(set(geos)):
                ekey = (bs, plan)
                eng = engines.get(ekey)
                if eng is None:
                    ecfg = EngineConfig(
                        batch_size=bs,
                        precision=self.precision,
                        collect=collect,
                        plan=plan,
                        metrics=mets,
                    )
                    eng = StreamingEngine(shape, self.cfg, ecfg, device=self.device)
                    engines[ekey] = eng
                entry = eng.warmup(n)
                compiled += 1
                aot += entry.aot is not None
        trained = 0
        if train:
            recipes = [{}] if train is True else list(train)
            for r in recipes:
                warmup_train_step(
                    self.cfg,
                    batch_size=r.get("batch_size", 16),
                    lr=r.get("lr", 3e-4),
                    freeze_embed=r.get("freeze_embed", False),
                    plan=r.get("plan"),
                    window=r.get("window"),
                    device=self.device,
                )
                trained += 1
        return {
            "sim_geometries": compiled,
            "sim_aot": aot,
            "train_steps": trained,
            "compile_cache": persistent_cache_status(),
        }
