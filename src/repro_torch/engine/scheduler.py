"""Async multi-trace sweep scheduler (design-space exploration fast path).

Counterpart of ``repro/engine/scheduler.py`` on one GPU.  The engine
already reuses one captured step across traces and, because the weights
are an argument of the step, across every model of one shape.  This
module adds the double-buffered trace queue of a DSE sweep: a producer
prepares the jobs' host work into a bounded queue (``depth`` slots, 2 =
double buffering) while the consumer streams each prepared job through a
per-model ``StreamingEngine`` whose step comes from the process-wide step
cache, so the whole sweep captures once per window geometry however many
(model, trace) pairs it covers.

    sweeper = TraceSweeper(cfg, EngineConfig(batch_size=64))
    report = sweeper.run([
        SweepJob("l1d16/mcf", model_16, trace_mcf),
        SweepJob("l1d32/mcf", model_32, trace_mcf),
        ...
    ])
    report.results["l1d16/mcf"].l1d_mpki
    report.num_compiles, report.mips, report.queue_occupancy_mean

The port's engine has no ``feature_backend`` setting (the route follows
from what ``simulate`` is given), so the route is an argument of the
sweeper (``ROUTES``):

  * ``"fused"`` (the default, the port engine's own default route; the
    reference's ``"fused"``): nothing is prepared; the consumer simulates
    the raw trace, one fused feature launch per batch.
  * ``"staged"`` (the reference's ``"pallas"``): the consumer extracts
    each job's trace on the device (``device_feature_arrays``, the B2 and
    B3 kernels), then simulates from those arrays.
  * ``"host"`` (the reference's ``"numpy"``): the producer runs the NumPy
    ``extract_features`` once per distinct trace — deduplicated by content
    digest, and through the ``ArtifactStore`` when one is given — and
    shares the result across every model.

The producer runs on a thread (``async_prepare``, the default on a CUDA
device) or inline before each job (the CPU's default: there the step's
compute takes the same cores).  It makes no CUDA call, so it never meets
the consumer's graph captures.  Crash-resume: with a ``store`` and a
``resume_key``, every finished job publishes a progress manifest
(``resilience/manifest.py``) and a re-run skips the jobs already done.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..core.features import FeatureSet, extract_features
from ..core.model import Tao, TaoConfig, init_tao
from ..kernels.features.ops import device_feature_arrays, trace_columns
from ..resilience.faults import fault_point
from ..store.content import array_digest, config_token, content_key, tree_digest
from .metrics import resolve_metrics
from .plan import ExecutionPlan
from .runner import EngineConfig, SimulationResult, StreamingEngine, cache_stats

__all__ = ["ROUTES", "SweepJob", "SweepReport", "TraceSweeper", "sweep_traces"]

ROUTES = ("fused", "staged", "host")


@dataclasses.dataclass(frozen=True)
class SweepJob:
    """One (model, trace) pair of a sweep."""

    key: str                 # e.g. "l1d32KB/mcf"
    params: Tao              # the model (one TaoConfig shape for the sweep)
    trace: np.ndarray        # functional trace (FUNC_TRACE_DTYPE)


@dataclasses.dataclass
class SweepReport:
    """Results plus the scheduler's own performance counters."""

    results: Dict[str, SimulationResult]
    seconds: float           # wall clock for the whole sweep
    num_traces: int
    num_instructions: int
    # step builds during this sweep: captures on the card, step entries
    # built on the CPU (where nothing is captured); at most 1 per window
    # geometry, 0 when an earlier run warmed the shared step cache
    num_compiles: int
    traces_per_s: float
    mips: float              # aggregate instructions/s over the sweep wall clock
    queue_occupancy_mean: float  # prepared jobs waiting when the consumer polls
    queue_occupancy_max: int
    queue_depth: int
    prepared_async: bool = False  # threaded producer (False = inline)
    plan_kind: str = "single"     # ExecutionPlan kind the sweep ran under
    num_shards: int = 1           # devices each step fanned out over
    # host feature pre-passes this sweep ran vs loaded from the artifact
    # store (both 0 on the fused and staged routes, which extract on the
    # device per job)
    features_extracted: int = 0
    features_from_store: int = 0
    # jobs satisfied from crash-resume progress manifests: skipped entirely
    jobs_skipped: int = 0

    def stats(self) -> Dict[str, Union[float, int, str]]:
        return {
            "traces_per_s": self.traces_per_s,
            "mips": self.mips,
            "num_compiles": self.num_compiles,
            "queue_occupancy_mean": self.queue_occupancy_mean,
            "queue_occupancy_max": self.queue_occupancy_max,
            "plan_kind": self.plan_kind,
            "num_shards": self.num_shards,
            "features_extracted": self.features_extracted,
            "features_from_store": self.features_from_store,
            "jobs_skipped": self.jobs_skipped,
        }

    def to_dict(self) -> Dict:
        """Stable JSON-clean form (the reference's wire contract):
        scheduler counters plus every result's ``SimulationResult.to_dict()``."""
        return {
            "seconds": self.seconds,
            "num_traces": self.num_traces,
            "num_instructions": self.num_instructions,
            "queue_depth": self.queue_depth,
            "prepared_async": self.prepared_async,
            **self.stats(),
            "results": {k: r.to_dict() for k, r in self.results.items()},
        }


_STOP = object()


class TraceSweeper:
    """Double-buffer a queue of (model, trace) jobs through the shared
    cached step on ``device`` (default ``cuda``; raises without it unless
    ``device="cpu"``).  ``route`` is one of ``ROUTES`` (module note)."""

    def __init__(
        self,
        cfg: TaoConfig,
        ecfg: EngineConfig = EngineConfig(),
        *,
        route: str = "fused",
        depth: int = 2,
        async_prepare: Optional[bool] = None,
        store=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        self.device = resolve_device(device)
        # resolved eagerly, so a bad (plan, batch) combination fails here
        self.plan = ExecutionPlan.resolve(batch_size=ecfg.batch_size, plan=ecfg.plan)
        self.cfg = cfg
        self.ecfg = ecfg
        self.route = route
        self.depth = depth
        # thread the preparation only where a device runs the step: on the
        # CPU the step's compute takes the same cores
        if async_prepare is None:
            async_prepare = self.device.type == "cuda"
        self.async_prepare = async_prepare
        # content-addressed artifact store (store.ArtifactStore): host
        # features persist and load across processes through it
        self.store = store

    def warmup(self, trace_lengths: Iterable[int]) -> Dict[str, int]:
        """Capture the sweep's step for a declared set of trace lengths
        before any jobs: an engine over a ``Tao`` of ``cfg``'s shape made
        on the device (its weights are never used: a job's are copied in
        at each simulate).  Returns ``{"geometries": ..., "aot_compiled":
        ...}`` (nothing is captured on the CPU)."""
        engine = StreamingEngine(init_tao(self.cfg, device=self.device), self.cfg, self.ecfg,
                                 device=self.device)
        entries = [engine.warmup(n) for n in sorted(set(trace_lengths))]
        return {
            "geometries": len(entries),
            "aot_compiled": sum(1 for e in entries if e.aot is not None),
        }

    # producer-thread / inline preparation: host NumPy on the raw trace,
    # before the job's first dispatch
    # tao: cold
    def _prepare(
        self,
        job: SweepJob,
        cache: Dict[str, FeatureSet],
        digests: Dict[int, str],
        counts: Dict[str, int],
    ) -> Optional[FeatureSet]:
        fault_point("scheduler.prepare", payload=job.key)
        if self.route != "host":
            # the fused and staged routes extract on the device, in the
            # consumer; nothing to compute on the host ahead of them
            return None
        # features are a pure function of (trace, FeatureConfig): extract
        # each distinct trace once, deduplicated by content digest (the
        # store's identity scheme), and share it across every model
        dg = digests.get(id(job.trace))
        if dg is None:
            dg = array_digest(job.trace)
            digests[id(job.trace)] = dg
        fs = cache.get(dg)
        if fs is not None:
            return fs
        key = content_key("features", dg, self.cfg.features)
        if self.store is not None:
            hit = self.store.get("features", key)
            if hit is not None:
                from ..store.store import tree_to_features

                fs = tree_to_features(hit[0])
                counts["from_store"] += 1
                cache[dg] = fs
                return fs
        fs = extract_features(job.trace, self.cfg.features, with_labels=False)
        counts["extracted"] += 1
        if self.store is not None:
            from ..store.store import features_to_tree

            self.store.put("features", key, features_to_tree(fs))
        cache[dg] = fs
        return fs

    def _progress_token(self) -> str:
        """Everything a sweep result is a function of besides (params,
        trace): model config, batch size, collect flag, precision, metric
        specs — part of every progress-manifest key, so a resumed run of
        another recipe never reuses stale results."""
        specs = resolve_metrics(self.ecfg.metrics)
        return "|".join((
            str(config_token(self.cfg)),
            f"b{self.ecfg.batch_size}",
            f"c{int(self.ecfg.collect)}",
            f"p{self.ecfg.precision}",
            ",".join(s.name for s in specs),
        ))

    # tao: hot
    def run(
        self, jobs: Iterable[SweepJob], *, resume_key: Optional[str] = None
    ) -> SweepReport:
        jobs = list(jobs)
        if not jobs:
            raise ValueError("sweep needs at least one job")
        keys = [j.key for j in jobs]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate sweep job keys: {keys}")
        if resume_key is not None and self.store is None:
            raise ValueError("resume_key needs a store to hold the manifests")

        feat_cache: Dict[str, FeatureSet] = {}  # trace digest -> features
        digests: Dict[int, str] = {}            # id(trace) -> digest (memo)
        feat_counts = {"extracted": 0, "from_store": 0}
        occ: List[int] = []
        results: Dict[str, SimulationResult] = {}
        n_instr = 0
        n_total = len(jobs)

        # crash-resume: load the done set up front and feed only the rest
        # to the producer — finished jobs cost no extraction, no device work
        skipped = 0
        progress_keys: Dict[str, str] = {}
        if resume_key is not None:
            from ..resilience import manifest as _manifest

            token = self._progress_token()
            pdigests: Dict[int, str] = {}       # id(params) -> digest (memo)
            remaining: List[SweepJob] = []
            for job in jobs:
                dg = digests.get(id(job.trace))
                if dg is None:
                    dg = array_digest(job.trace)
                    digests[id(job.trace)] = dg
                pd = pdigests.get(id(job.params))
                if pd is None:
                    pd = tree_digest(dict(job.params.state_dict()))
                    pdigests[id(job.params)] = pd
                pkey = _manifest.sweep_progress_key(resume_key, job.key, dg, pd, token)
                progress_keys[job.key] = pkey
                res = _manifest.load_sweep_result(self.store, pkey)
                if res is not None:
                    results[job.key] = res
                    n_instr += res.num_instructions
                    skipped += 1
                else:
                    remaining.append(job)
            jobs = remaining

        # consumer state: one engine per model, reused across its traces;
        # the engines share steps through the process-wide cache
        engines: Dict[int, StreamingEngine] = {}
        entries: Dict[int, object] = {}   # id(_CachedStep) -> _CachedStep
        baseline: Dict[int, int] = {}     # its captures before this sweep used it
        built: Dict[int, bool] = {}       # whether this sweep built it
        fcfg = self.cfg.features

        def consume(job: SweepJob, features: Optional[FeatureSet]) -> None:
            nonlocal n_instr
            fault_point("scheduler.consume", payload=job.key)
            engine = engines.get(id(job.params))
            if engine is None:
                engine = StreamingEngine(job.params, self.cfg, self.ecfg, device=self.device)
                engines[id(job.params)] = engine
            # snapshot the shared step entry BEFORE simulating, so the
            # report counts only the builds this sweep made
            misses = cache_stats()["misses"]
            entry = engine.step_entry_for(len(job.trace))
            if id(entry) not in entries:
                entries[id(entry)] = entry
                baseline[id(entry)] = entry.compiles
                built[id(entry)] = cache_stats()["misses"] > misses
            if self.route == "staged":
                features = device_feature_arrays(trace_columns(job.trace, fcfg), fcfg,
                                                 device=self.device)
            res = engine.simulate(job.trace, features=features)
            results[job.key] = res
            n_instr += res.num_instructions
            if resume_key is not None:
                from ..resilience import manifest as _manifest

                _manifest.publish_sweep_result(self.store, progress_keys[job.key], res)

        t0 = time.perf_counter()
        if not self.async_prepare:
            # inline: no producer thread to contend with the step's compute;
            # the feature dedup still applies
            for job in jobs:
                consume(job, self._prepare(job, feat_cache, digests, feat_counts))
        else:
            q: "queue.Queue" = queue.Queue(maxsize=self.depth)
            error: List[BaseException] = []
            stop = threading.Event()  # set when the consumer bails out early

            def produce():
                try:
                    for job in jobs:
                        prepared = self._prepare(job, feat_cache, digests, feat_counts)
                        while not stop.is_set():
                            try:
                                q.put((job, prepared), timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                except BaseException as e:  # surfaced in the consumer
                    error.append(e)
                finally:
                    while True:  # always deliver _STOP without blocking
                        try:
                            q.put(_STOP, timeout=0.1)
                            break
                        except queue.Full:
                            if stop.is_set():
                                break

            producer = threading.Thread(target=produce, name="trace-sweep-producer", daemon=True)
            producer.start()
            try:
                while True:
                    occ.append(q.qsize())
                    item = q.get()
                    if item is _STOP:
                        break
                    consume(*item)
            finally:
                # unpark the producer (it may wait on a full queue), drop
                # any prepared but unconsumed features, and let no producer
                # outlive the run, whichever way it ends
                stop.set()
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                producer.join()
            if error:
                raise error[0]
        secs = time.perf_counter() - t0

        if self.device.type == "cuda":
            compiles = sum(e.compiles - baseline[i] for i, e in entries.items())
        else:
            compiles = sum(built.values())
        return SweepReport(
            results=results,
            seconds=secs,
            num_traces=n_total,
            num_instructions=n_instr,
            num_compiles=compiles,
            traces_per_s=n_total / secs,
            mips=n_instr / 1e6 / secs,
            queue_occupancy_mean=float(np.mean(occ)) if occ else 0.0,  # tao: noqa[TAO002] occ is a host list of queue depths; runs once after the sweep loop
            queue_occupancy_max=int(np.max(occ)) if occ else 0,
            queue_depth=self.depth,
            prepared_async=self.async_prepare,
            plan_kind=self.plan.kind,
            num_shards=self.plan.num_shards,
            features_extracted=feat_counts["extracted"],
            features_from_store=feat_counts["from_store"],
            jobs_skipped=skipped,
        )


def sweep_traces(
    cfg: TaoConfig,
    jobs: Iterable[Tuple[str, Tao, np.ndarray]],
    ecfg: EngineConfig = EngineConfig(),
    *,
    route: str = "fused",
    depth: int = 2,
    async_prepare: Optional[bool] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> SweepReport:
    """One-shot convenience wrapper over ``TraceSweeper``."""
    return TraceSweeper(cfg, ecfg, route=route, depth=depth, async_prepare=async_prepare,
                        device=device).run(SweepJob(k, p, t) for k, p, t in jobs)
