"""Continuous-batching trace server over the streaming engine (PyTorch port
of ``repro/serve/server.py``).

The product surface the paper implies: many tenants submit (trace, model)
requests, the server returns device-computed metrics.  What "continuous
batching" means for THIS engine: the captured step is keyed by window
geometry, not by request or weights, so the multi-tenant scheduling
problem reduces to routing every admitted request into the per-geometry
step pool the engine already maintains —

  * a request NEVER triggers a CUDA graph capture if any tenant has
    already paid for its geometry (process-wide step cache), and a server
    that ran ``warmup()`` over a declared geometry set starts at **0
    captures**;
  * on the host route, same-trace requests coalesce through the
    scheduler's content-digest feature dedup: one host feature pre-pass
    (or one store load) serves every request for that trace, across
    tenants and models;
  * admission is bounded (``max_queue``): past the bound, ``submit``
    rejects with ``ServeError(QUEUE_FULL, retry_after_s=...)`` — the
    HTTP-429 analogue — instead of growing memory;
  * service order is fair: round-robin across geometry buckets, and
    round-robin across tenants inside each bucket, so a tenant flooding
    one geometry can neither starve other geometries nor other tenants.

Request lifecycle::

    submit() ─ validate (model / metrics / trace) ──► per-geometry bucket
                                                      (per-tenant FIFOs)
    scheduler loop ─ fairness pick ─► features (host route: digest-
    coalesced, store-backed) ─► engine + step entry (dispatch thread) ─►
    simulate (dispatch thread) ─► ServeResult future

Where the reference picks a ``feature_backend``, the port picks a
``route`` (``engine.ROUTES``): ``"fused"`` (the default: the raw trace,
one fused feature kernel per batch), ``"staged"`` (whole-trace device
feature arrays, built per request on the dispatch thread, as the
reference's ``"pallas"`` extracts per simulate) or ``"host"`` (the NumPy
pre-pass above, the reference's ``"numpy"``).  Results are bit-identical
to ``TrainedModel.simulate(route=...)`` because they run the same engines
and captured steps.  ``set_plan`` swaps the (single-device) plan between
requests; sharded plans are not ported.

**One device lock per server.**  Every model of one config and geometry
shares one captured step, whose static buffers ``simulate`` loads with its
model's weights and carry and then replays, and a capture (global capture
mode) forbids CUDA calls on every other thread.  So every call that can
touch the card runs under ``device_lock``: placing a store-resolved
model's weights (``registry.resolve``), building or fetching an engine
(weights moved, int8 quantization) and its step entry, the staged
extraction, ``engine.simulate`` and ``warmup``.  Engines are built on the
dispatch thread, not the event loop; the extract pool does NumPy and
store reads only.  A dispatch thread abandoned on a deadline (see below)
checks the server's generation token under the lock before each request
and drops its work once it is stale, so it never replays beside the
fresh thread's re-runs.  Code of the same process that simulates beside a
running server takes ``server.device_lock`` too.

The server is asyncio-native and single-loop: ``submit``/``stats`` must
run on the event loop thread; feature extraction and device dispatch are
pushed to small executors (host-route extraction eagerly at admission
when the server's device is CUDA, inline with dispatch on the CPU — the
sweep scheduler's policy).

Failure handling: requests carry deadlines (queued-too-long or
hung-on-device both fail ``DEADLINE_EXCEEDED``, and a hung dispatch thread
is abandoned, not joined); transient dispatch failures retry with bounded
exponential backoff (``RetryPolicy``); deterministic failures are
isolated by batch bisection — the poison trace's digest is quarantined
and rejected with ``TRACE_REJECTED`` while cohabitant requests of the
same dispatch group re-run bit-identically; and a per-``model/geometry``
circuit breaker sheds admissions with ``CIRCUIT_OPEN`` +
``retry_after_s`` after repeated hard failures instead of queueing doomed
work.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..core.dataset import num_windows
from ..core.features import extract_features
from ..engine.metrics import DEFAULT_METRICS, resolve_metrics
from ..engine.plan import ExecutionPlan
from ..engine.runner import EngineConfig, cache_stats
from ..engine.scheduler import ROUTES
from ..kernels.features.ops import device_feature_arrays, trace_columns
from ..resilience.breaker import CircuitBreaker
from ..resilience.faults import fault_point
from ..resilience.retry import RetryPolicy, is_transient
from ..store.content import array_digest, content_key
from .registry import ModelRegistry
from .types import ServeError, ServeRequest, ServeResult, ServerStats

__all__ = ["TraceServer"]


@dataclasses.dataclass
class _Pending:
    """One admitted request plus everything resolved at admission."""

    req: ServeRequest
    future: "asyncio.Future"
    model: object                    # resolved TrainedModel
    trace_arr: np.ndarray
    n: int
    digest: str
    specs: tuple                     # resolved MetricSpec tuple
    geometry: str                    # bucket label
    t_submit: float
    coalesced: bool = False
    extract_s: float = 0.0
    attempts: int = 0                # dispatch tries so far (retry counter)
    deadline_at: Optional[float] = None   # perf_counter() bound, or None


class _Bucket:
    """Per-geometry queue: tenant FIFOs served round-robin."""

    __slots__ = ("label", "tenants", "trr", "served", "fill_sum",
                 "occ_sum", "occ_n", "occ_max")

    def __init__(self, label: str):
        self.label = label
        self.tenants: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        self.trr = 0
        self.served = 0
        self.fill_sum = 0.0
        self.occ_sum = 0
        self.occ_n = 0
        self.occ_max = 0

    def push(self, p: _Pending) -> None:
        dq = self.tenants.get(p.req.tenant)
        if dq is None:
            dq = collections.deque()
            self.tenants[p.req.tenant] = dq
        dq.append(p)

    def pop_next(self) -> Optional[_Pending]:
        names = list(self.tenants)
        for i in range(len(names)):
            t = names[(self.trr + i) % len(names)]
            dq = self.tenants[t]
            if dq:
                self.trr = (self.trr + i + 1) % len(names)
                p = dq.popleft()
                if not dq:
                    del self.tenants[t]  # keep the tenant map bounded
                return p
        return None

    def depth(self) -> int:
        return sum(len(dq) for dq in self.tenants.values())

    def sample_occupancy(self) -> None:
        d = self.depth()
        self.occ_sum += d
        self.occ_n += 1
        self.occ_max = max(self.occ_max, d)


_LATENCY_WINDOW = 4096   # completions kept for the percentile estimators
_FEATURE_CACHE = 64      # trace digests whose features stay resident
_QUARANTINE_CAP = 256    # poison trace digests remembered (LRU)


class TraceServer:
    """Persistent asyncio serving layer over the engine's captured steps.

    ::

        registry = ModelRegistry(store)
        registry.register("base", model)
        server = TraceServer(registry, batch_size=8, store=store)
        async with server:
            fut = server.submit(ServeRequest(model="base", trace=tr))
            result = await fut            # ServeResult
        server.stats()                    # ServerStats snapshot

    ``device`` (default ``cuda``; without CUDA it raises unless
    ``device="cpu"``) decides the extraction policy; each request runs on
    its model's device.
    """

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        batch_size: int = 64,
        route: str = "fused",
        precision: str = "fp32",
        max_queue: int = 64,
        metrics: Tuple = DEFAULT_METRICS,
        store=None,
        plan: Optional[ExecutionPlan] = None,
        extract_async: Optional[bool] = None,
        deadline_s: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        breaker_threshold: int = 8,
        breaker_cooldown_s: float = 1.0,
        group_size: int = 1,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        self.device = resolve_device(device)
        self.registry = registry
        self.batch_size = batch_size
        self.route = route
        self.precision = precision
        self.max_queue = max_queue
        self.default_metrics = resolve_metrics(metrics)
        self.store = store if store is not None else getattr(registry, "store", None)
        # one partitioning decision, swappable at runtime via set_plan()
        self._plan: Optional[ExecutionPlan] = None
        if plan is not None:
            self._plan = ExecutionPlan.resolve(batch_size=batch_size, plan=plan)
        # eager (admission-time) extraction overlaps host feature work with
        # device compute; on the CPU the threads would contend with the
        # step's own compute (the sweep scheduler's policy), so extraction
        # runs inline in the dispatch path there.
        if extract_async is None:
            extract_async = self.device.type == "cuda"
        self.extract_async = extract_async

        # every call that can touch the card holds this (module note);
        # re-entrant, so warmup can resolve models under it
        self.device_lock = threading.RLock()
        # bumped when a hung dispatch pool is abandoned: a thread of the old
        # pool finds its token stale under the lock and drops its work
        self._generation = 0

        # resilience: deadlines, bounded retry, per-key breakers, poison
        # quarantine, and the dispatch group size batch bisection splits
        self.deadline_s = deadline_s
        self.retry = retry if retry is not None else RetryPolicy()
        self.group_size = group_size
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._quarantine: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        self._requeues = 0                  # backoff timers not yet re-queued

        self._buckets: "collections.OrderedDict[tuple, _Bucket]" = (
            collections.OrderedDict()
        )
        self._brr = 0                       # bucket round-robin cursor
        self._depth = 0                     # total queued (admitted, unserved)
        self._seq = itertools.count()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._draining = False
        self._killing = False               # stop(drain=False): fail requeues
        self._started_at: Optional[float] = None

        # feature coalescing: trace digest -> executor future of FeatureSet
        self._feat_cache: "collections.OrderedDict[str, object]" = (
            collections.OrderedDict()
        )
        self._extract_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="serve-extract"
        )
        # one dispatch thread: the device is the serialized resource; the
        # step pool is shared so ordering, not parallelism, is what the
        # scheduler controls
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-dispatch"
        )

        # observability
        self.counters: Dict[str, int] = {
            "admitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "features_extracted": 0, "features_from_store": 0,
            "features_coalesced": 0, "retries": 0, "deadline_exceeded": 0,
            "quarantined": 0, "bisections": 0, "breaker_sheds": 0,
        }
        self._tenants: Dict[str, Dict[str, int]] = {}
        self._lat_total: "collections.deque" = collections.deque(
            maxlen=_LATENCY_WINDOW
        )
        self._lat_queue: "collections.deque" = collections.deque(
            maxlen=_LATENCY_WINDOW
        )
        self._service_ema: Optional[float] = None
        self._step_entries: Dict[int, object] = {}   # id -> _CachedStep
        self._step_baseline: Dict[int, int] = {}     # captures at first sight
        self._step_built: Dict[int, bool] = {}       # built by a request

    # ---- lifecycle -------------------------------------------------------

    async def start(self) -> "TraceServer":
        if self._task is not None:
            raise RuntimeError("server already started")
        self._started_at = time.perf_counter()
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self, *, drain: bool = True) -> None:
        """Stop admitting; ``drain=True`` serves the queue out first
        (including retries still waiting on their backoff timers),
        ``drain=False`` fails queued requests with SHUTTING_DOWN."""
        self._stopping = True
        if not drain:
            self._killing = True
            while True:
                p = self._next()
                if p is None:
                    break
                self._fail(p, ServeError(
                    "SHUTTING_DOWN", "server is shutting down",
                    request_id=p.req.request_id,
                ))
        self._draining = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        self._extract_pool.shutdown(wait=True)
        self._dispatch_pool.shutdown(wait=True)

    async def shutdown(self, *, drain: bool = True) -> None:
        """Alias for :meth:`stop` (the operator-facing verb)."""
        await self.stop(drain=drain)

    async def __aenter__(self) -> "TraceServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ---- admission -------------------------------------------------------

    # tao: hot
    def submit(self, req: ServeRequest) -> "asyncio.Future":
        """Admit one request (event-loop thread only).  Returns a future
        resolving to a ``ServeResult``; raises ``ServeError`` — QUEUE_FULL
        (with ``retry_after_s``), UNKNOWN_MODEL, BAD_REQUEST,
        TRACE_REJECTED (quarantined poison digest), CIRCUIT_OPEN,
        SHUTTING_DOWN — when the request is not admitted at all."""
        if self._stopping:
            raise ServeError("SHUTTING_DOWN", "server is shutting down")
        if self._depth >= self.max_queue:
            self.counters["rejected"] += 1
            t = self._tenant(req.tenant)
            t["rejected"] += 1
            raise ServeError(
                "QUEUE_FULL",
                f"admission queue at capacity ({self.max_queue})",
                retry_after_s=self._retry_after(),
                request_id=req.request_id,
            )
        # UNKNOWN_MODEL; a store-resolved model is placed under the lock
        model = self.registry.resolve(req.model, device_lock=self.device_lock)
        trace = req.trace
        arr = trace.functional if hasattr(trace, "functional") else np.asarray(trace)  # tao: noqa[TAO002] admission-time view of the tenant's host trace array, no device data exists yet
        n = len(arr)
        if n < 1:
            raise ServeError(
                "BAD_REQUEST", "trace is empty", request_id=req.request_id
            )
        try:
            specs = (
                self.default_metrics
                if req.metrics is None
                else resolve_metrics(tuple(req.metrics))
            )
        except (KeyError, TypeError, ValueError) as e:
            raise ServeError(
                "BAD_REQUEST", f"bad metrics: {e}", request_id=req.request_id
            ) from None
        if req.request_id is None:
            req.request_id = f"r{next(self._seq)}"
        w_eff = min(model.cfg.window, n)
        label = f"w{w_eff}b{self.batch_size}"
        digest = (
            trace.digest if hasattr(trace, "digest") else array_digest(arr)
        )
        if digest in self._quarantine:
            self.counters["rejected"] += 1
            self._tenant(req.tenant)["rejected"] += 1
            raise ServeError(
                "TRACE_REJECTED",
                f"trace {digest[:12]} is quarantined "
                f"({self._quarantine[digest]})",
                request_id=req.request_id,
            )
        br = self._breakers.get(f"{req.model}/{label}")
        if br is not None and not br.allow():
            self.counters["breaker_sheds"] += 1
            self.counters["rejected"] += 1
            self._tenant(req.tenant)["rejected"] += 1
            raise ServeError(
                "CIRCUIT_OPEN",
                f"circuit open for {req.model}/{label} "
                f"({br.failures} consecutive failures)",
                retry_after_s=br.retry_after_s,
                request_id=req.request_id,
            )
        dl = req.deadline_s if req.deadline_s is not None else self.deadline_s
        p = _Pending(
            req=req,
            future=asyncio.get_running_loop().create_future(),
            model=model,
            trace_arr=arr,
            n=n,
            digest=digest,
            specs=specs,
            geometry=label,
            t_submit=time.perf_counter(),
        )
        if dl is not None:
            p.deadline_at = p.t_submit + dl
        bkey = (model.cfg, w_eff, specs)
        bucket = self._buckets.get(bkey)
        if bucket is None:
            bucket = _Bucket(label)
            self._buckets[bkey] = bucket
        bucket.push(p)
        self._depth += 1
        self.counters["admitted"] += 1
        self._tenant(req.tenant)["admitted"] += 1
        if self.extract_async and self.route == "host":
            self._feature_entry(p)       # start the pre-pass immediately
        self._wake.set()
        return p.future

    def _tenant(self, name: str) -> Dict[str, int]:
        t = self._tenants.get(name)
        if t is None:
            t = {"admitted": 0, "completed": 0, "failed": 0, "rejected": 0}
            self._tenants[name] = t
        return t

    def _retry_after(self) -> float:
        est = self._service_ema if self._service_ema is not None else 0.05
        return max(0.01, est * max(1, self._depth))

    # ---- fairness pick ---------------------------------------------------

    def _next(self) -> Optional[_Pending]:
        if self._depth == 0:
            return None
        buckets = list(self._buckets.values())
        nb = len(buckets)
        for i in range(nb):
            b = buckets[(self._brr + i) % nb]
            p = b.pop_next()
            if p is not None:
                self._brr = (self._brr + i + 1) % nb
                self._depth -= 1
                return p
        return None

    # ---- features (host route: digest-coalesced, store-backed) -----------

    def _feature_entry(self, p: _Pending):
        """The shared executor future computing ``p``'s FeatureSet; one
        per trace digest, LRU-bounded.  Marks ``p.coalesced`` when some
        earlier request already owns the pre-pass."""
        ent = self._feat_cache.get(p.digest)
        if ent is not None:
            self._feat_cache.move_to_end(p.digest)
            if not p.coalesced:
                p.coalesced = True
                self.counters["features_coalesced"] += 1
            return ent
        loop = asyncio.get_running_loop()
        ent = loop.run_in_executor(
            self._extract_pool, self._extract_sync, p.trace_arr,
            p.digest, p.model.cfg,
        )
        self._feat_cache[p.digest] = ent
        while len(self._feat_cache) > _FEATURE_CACHE:
            self._feat_cache.popitem(last=False)
        return ent

    # feature-pool thread: host NumPy pre-pass before any device work (no
    # CUDA call: the features stay NumPy until the engine copies them)
    # tao: cold
    def _extract_sync(self, arr: np.ndarray, digest: str, cfg):
        """Runs on the extract pool: store lookup, else extract + publish
        (the identical key scheme as TraceSweeper / TrainedModel, so the
        server shares warm entries with every other consumer)."""
        fault_point("serve.extract", payload=digest)
        key = content_key("features", digest, cfg.features)
        if self.store is not None:
            hit = self.store.get("features", key)
            if hit is not None:
                from ..store.store import tree_to_features

                self.counters["features_from_store"] += 1
                return tree_to_features(hit[0])
        fs = extract_features(arr, cfg.features, with_labels=False)
        self.counters["features_extracted"] += 1
        if self.store is not None:
            from ..store.store import features_to_tree

            self.store.put("features", key, features_to_tree(fs))
        return fs

    # ---- dispatch --------------------------------------------------------

    def _engine_for(self, p: _Pending):
        try:
            return p.model.engine(EngineConfig(
                batch_size=self.batch_size,
                precision=self.precision,
                plan=self._plan,
                metrics=p.specs,
            ))
        except ValueError as e:
            # plan/batch divisibility, bad geometry: the tenant's request
            # cannot run under the server's current partitioning
            raise ServeError(
                "GEOMETRY_MISMATCH", str(e), request_id=p.req.request_id
            ) from None

    def _see_entry(self, entry, built: bool) -> None:
        """Remember a step entry at first sight: its captures then (what
        ``num_compiles`` counts from) and whether a request built it."""
        if id(entry) not in self._step_entries:
            self._step_entries[id(entry)] = entry
            self._step_baseline[id(entry)] = entry.compiles
            self._step_built[id(entry)] = built

    # dispatch-pool thread: the engines (weights on the device, under int8
    # the quantized tree) and their step entries, per request
    def _engines_sync(self, group: List[_Pending]) -> List[object]:
        """``(engine, entry, built)`` per request, or the exception that
        request's engine raised (it fails alone, as in the reference)."""
        out: List[object] = []
        with self.device_lock:
            for p in group:
                try:
                    engine = self._engine_for(p)
                    misses = cache_stats()["misses"]
                    entry = engine.step_entry_for(p.n)
                    out.append((engine, entry, cache_stats()["misses"] > misses))
                except Exception as e:  # classified per request on the loop
                    out.append(e)
        return out

    def _next_group(self) -> List[_Pending]:
        """The next dispatch group: the fairness pick plus up to
        ``group_size - 1`` more requests from the same bucket (they share
        a step, so they form one continuous batch — and one bisection
        domain when something in it fails)."""
        group: List[_Pending] = []
        p = self._next()
        if p is None:
            return group
        group.append(p)
        if self.group_size > 1:
            b = self._buckets.get(
                (p.model.cfg, min(p.model.cfg.window, p.n), p.specs)
            )
            while b is not None and len(group) < self.group_size:
                q = b.pop_next()
                if q is None:
                    break
                self._depth -= 1
                group.append(q)
        return group

    # dispatch-pool thread: the whole group runs as one unit — a failure
    # anywhere aborts the batch (as a real poisoned device batch would),
    # and the async side bisects to isolate the culprit
    def _simulate_group(self, items: List[tuple], generation: int) -> Optional[List[object]]:
        out = []
        for p, features, engine in items:
            fault_point("serve.dispatch", payload=p.digest)
            with self.device_lock:
                if generation != self._generation:
                    # this thread's pool was abandoned while it waited:
                    # its requests were expired or re-run elsewhere
                    return None
                if self.route == "staged":
                    fcfg = p.model.cfg.features
                    features = device_feature_arrays(
                        trace_columns(p.trace_arr, fcfg), fcfg, device=engine.device
                    )
                out.append(engine.simulate(p.trace_arr, features))
        return out

    def _breaker_for(self, p: _Pending) -> CircuitBreaker:
        key = f"{p.req.model}/{p.geometry}"
        br = self._breakers.get(key)
        if br is None:
            br = CircuitBreaker(
                failure_threshold=self._breaker_threshold,
                cooldown_s=self._breaker_cooldown_s,
            )
            self._breakers[key] = br
        return br

    def _expire(self, p: _Pending) -> None:
        self.counters["deadline_exceeded"] += 1
        self._breaker_for(p).record_failure()
        self._fail(p, ServeError(
            "DEADLINE_EXCEEDED",
            f"request exceeded its deadline after {p.attempts + 1} "
            "dispatch attempt(s)",
            request_id=p.req.request_id,
        ))

    def _requeue(self, p: _Pending) -> None:
        """Backoff timer fired: put the request back in its bucket (or
        fail it when the server was killed without draining)."""
        self._requeues -= 1
        if self._killing:
            self._fail(p, ServeError(
                "SHUTTING_DOWN", "server is shutting down",
                request_id=p.req.request_id,
            ))
            return
        bkey = (p.model.cfg, min(p.model.cfg.window, p.n), p.specs)
        bucket = self._buckets.get(bkey)
        if bucket is None:
            bucket = _Bucket(p.geometry)
            self._buckets[bkey] = bucket
        bucket.push(p)
        self._depth += 1
        self._wake.set()

    def _on_failure(self, p: _Pending, exc: BaseException) -> None:
        """Classify a singleton dispatch failure: fatal (ServeError) /
        transient (bounded backoff retry) / poison (quarantine digest,
        reject TRACE_REJECTED)."""
        if isinstance(exc, ServeError):
            self._fail(p, exc)
            return
        if is_transient(exc):
            p.attempts += 1
            now = time.perf_counter()
            delay = self.retry.delay(p.attempts)
            budget_ok = (
                p.deadline_at is None or now + delay < p.deadline_at
            )
            if p.attempts < self.retry.max_attempts and budget_ok:
                self.counters["retries"] += 1
                self._requeues += 1
                asyncio.get_running_loop().call_later(
                    delay, self._requeue, p
                )
                return
            self._breaker_for(p).record_failure()
            self._fail(p, ServeError.wrap(exc, request_id=p.req.request_id))
            return
        # deterministic poison: remember the digest so resubmits are shed
        # at admission (the tenant's input is at fault, not capacity — the
        # breaker does not count it)
        self._quarantine[p.digest] = type(exc).__name__
        while len(self._quarantine) > _QUARANTINE_CAP:
            self._quarantine.popitem(last=False)
        self.counters["quarantined"] += 1
        self._fail(p, ServeError(
            "TRACE_REJECTED",
            f"trace {p.digest[:12]} poisons its batch "
            f"({type(exc).__name__}) and was quarantined",
            request_id=p.req.request_id,
        ))

    def _abandon_pool(self, pool: ThreadPoolExecutor) -> None:
        """A dispatch hung past its deadline: abandon the pool (and the
        thread stuck inside it) so the next dispatch is not head-of-line
        blocked behind the hang.  The generation moves on, so that thread,
        when it wakes, replays nothing."""
        if pool is self._dispatch_pool:
            self._generation += 1
            self._dispatch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-dispatch"
            )
        pool.shutdown(wait=False)

    def _complete(self, p: _Pending, res, t_start: float, t_done: float) -> None:
        bucket = self._buckets.get(
            (p.model.cfg, min(p.model.cfg.window, p.n), p.specs)
        )
        if bucket is not None:
            bucket.served += 1
            nw = num_windows(p.n, p.model.cfg.window, p.model.cfg.window)
            nb = -(-nw // self.batch_size)
            bucket.fill_sum += nw / (nb * self.batch_size)
        br = self._breakers.get(f"{p.req.model}/{p.geometry}")
        if br is not None:
            br.record_success()
        self.counters["completed"] += 1
        self._tenant(p.req.tenant)["completed"] += 1
        self._lat_total.append(t_done - p.t_submit)
        self._lat_queue.append(t_start - p.t_submit)
        result = ServeResult(
            request_id=p.req.request_id,
            model=p.req.model,
            tenant=p.req.tenant,
            geometry=p.geometry,
            num_instructions=res.num_instructions,
            metrics=dict(res.metrics),
            queue_s=t_start - p.t_submit,
            extract_s=p.extract_s,
            compute_s=t_done - t_start,
            total_s=t_done - p.t_submit,
            coalesced=p.coalesced,
        )
        if not p.future.done():
            p.future.set_result(result)

    async def _run_batch(self, group: List[_Pending]) -> None:
        """Resolve features/engines for a dispatch group and execute it.
        Per-request failures here (feature extraction, engine resolution)
        go through the retry/quarantine classifier without touching the
        group's healthy members."""
        t_start = time.perf_counter()
        ready: List[tuple] = []
        for p in group:
            if p.deadline_at is not None and t_start >= p.deadline_at:
                self._expire(p)          # spent its budget in the queue
                continue
            try:
                features = None
                if self.route == "host":
                    t_f = time.perf_counter()
                    features = await self._feature_entry(p)
                    p.extract_s += time.perf_counter() - t_f
                ready.append((p, features))
            except BaseException as e:
                # a failed extraction future must not poison the cache
                # for later requests of the same digest
                self._feat_cache.pop(p.digest, None)
                self._on_failure(p, e)
        if not ready:
            return
        # engines touch the card (weights, int8 trees): dispatch thread
        engines = await asyncio.get_running_loop().run_in_executor(
            self._dispatch_pool, self._engines_sync, [p for p, _ in ready]
        )
        items: List[tuple] = []
        for (p, features), eng in zip(ready, engines):
            if isinstance(eng, BaseException):
                self._feat_cache.pop(p.digest, None)
                self._on_failure(p, eng)
                continue
            engine, entry, built = eng
            self._see_entry(entry, built)
            items.append((p, features, engine))
        if items:
            await self._run_items(items, t_start)

    async def _run_items(self, items: List[tuple], t_start: float) -> None:
        loop = asyncio.get_running_loop()
        timeout = None
        for p, _, _ in items:
            if p.deadline_at is not None:
                rem = p.deadline_at - time.perf_counter()
                timeout = rem if timeout is None else min(timeout, rem)
        pool = self._dispatch_pool
        fut = loop.run_in_executor(pool, self._simulate_group, items, self._generation)
        try:
            if timeout is not None:
                results = await asyncio.wait_for(fut, max(timeout, 0.001))
            else:
                results = await fut
        except asyncio.TimeoutError as e:
            if timeout is None:
                # an injected/engine TimeoutError, not the deadline guard
                await self._on_group_error(items, e, t_start)
                return
            self._abandon_pool(pool)
            now = time.perf_counter()
            for p, features, engine in items:
                if p.deadline_at is not None and now >= p.deadline_at:
                    self._expire(p)
                else:
                    # cohabitant of the hung request: re-run on the fresh
                    # pool (the abandoned thread drops its copy, so the
                    # shared step replays for one thread at a time)
                    await self._run_items([(p, features, engine)], t_start)
            return
        except BaseException as e:
            await self._on_group_error(items, e, t_start)
            return
        t_done = time.perf_counter()
        self._service_ema = (
            (t_done - t_start) if self._service_ema is None
            else 0.8 * self._service_ema + 0.2 * (t_done - t_start)
        )
        for (p, _, _), res in zip(items, results):
            self._complete(p, res, t_start, t_done)

    async def _on_group_error(
        self, items: List[tuple], exc: BaseException, t_start: float
    ) -> None:
        """Batch bisection: a group failure names no culprit (a poisoned
        device batch aborts wholesale), so split and re-run each half —
        re-simulation is deterministic, so survivors stay bit-identical —
        until the failure pins to a singleton, which the classifier
        handles."""
        if len(items) == 1:
            self._on_failure(items[0][0], exc)
            return
        self.counters["bisections"] += 1
        mid = len(items) // 2
        await self._run_items(items[:mid], t_start)
        await self._run_items(items[mid:], t_start)

    def _fail(self, p: _Pending, err: ServeError) -> None:
        self.counters["failed"] += 1
        self._tenant(p.req.tenant)["failed"] += 1
        if not p.future.done():
            p.future.set_exception(err)

    # tao: hot
    async def _run(self) -> None:
        while True:
            group = self._next_group()
            if not group:
                if self._draining:
                    if self._requeues == 0:
                        break
                    # retries are parked on backoff timers; let them land
                    await asyncio.sleep(0.005)
                    continue
                self._wake.clear()
                await self._wake.wait()
                continue
            for b in self._buckets.values():
                b.sample_occupancy()
            await self._run_batch(group)

    # ---- operations ------------------------------------------------------

    def set_plan(self, *, plan: Optional[ExecutionPlan] = None) -> ExecutionPlan:
        """Swap the partitioning plan without a restart: subsequent
        requests resolve engines under the new plan (plan=None reverts to
        the default single-device one).  In-flight requests finish under
        the plan they started with.  Only the single plan is ported: a
        sharded one raises ``NotImplementedError``."""
        if plan is None:
            self._plan = None
        else:
            self._plan = ExecutionPlan.resolve(batch_size=self.batch_size, plan=plan)
        return self._plan if self._plan is not None else ExecutionPlan.single()

    def warmup(
        self,
        trace_lengths: Iterable[int],
        models: Optional[Iterable[str]] = None,
    ) -> Dict[str, int]:
        """Capture the serving steps for a declared geometry set (every
        registry model × every length) before any tenant connects, under
        the device lock.  On the CPU nothing is captured
        (``aot_compiled`` 0)."""
        names = list(models) if models is not None else list(self.registry.names())
        compiled = 0
        aot = 0
        with self.device_lock:
            for name in names:
                model = self.registry.resolve(name, device_lock=self.device_lock)
                engine = model.engine(EngineConfig(
                    batch_size=self.batch_size,
                    precision=self.precision,
                    plan=self._plan,
                    metrics=self.default_metrics,
                ))
                for n in sorted(set(trace_lengths)):
                    entry = engine.warmup(n)
                    self._see_entry(entry, False)
                    compiled += 1
                    aot += entry.aot is not None
        return {"geometries": compiled, "aot_compiled": aot}

    # ---- observability ---------------------------------------------------

    @property
    def num_compiles(self) -> int:
        """Step captures attributable to requests served by THIS server
        (0 on a warm server — the multi-tenant one-capture guarantee).  On
        the CPU, where nothing is captured, the step entries its requests
        built (as ``SweepReport.num_compiles``)."""
        if self.device.type == "cuda":
            return sum(
                e.compiles - self._step_baseline[i]
                for i, e in self._step_entries.items()
            )
        return sum(self._step_built.values())

    @staticmethod
    def _pct(samples, q: float) -> float:
        return float(np.percentile(np.asarray(samples), q)) if samples else 0.0

    def stats(self) -> ServerStats:
        uptime = (
            time.perf_counter() - self._started_at
            if self._started_at is not None
            else 0.0
        )
        per_geo: Dict[str, Dict] = {}
        for b in self._buckets.values():
            g = per_geo.setdefault(b.label, {
                "queued": 0, "served": 0, "fill_sum": 0.0,
                "occ_max": 0, "occ_n": 0, "occ_sum": 0,
            })
            g["queued"] += b.depth()
            g["served"] += b.served
            g["fill_sum"] += b.fill_sum
            g["occ_sum"] += b.occ_sum
            g["occ_n"] += b.occ_n
            g["occ_max"] = max(g["occ_max"], b.occ_max)
        for g in per_geo.values():
            fill_sum = g.pop("fill_sum")
            occ_sum, occ_n = g.pop("occ_sum"), g.pop("occ_n")
            g["batch_fill_ratio"] = fill_sum / g["served"] if g["served"] else 0.0
            g["queue_occupancy_mean"] = occ_sum / occ_n if occ_n else 0.0
            g["queue_occupancy_max"] = g.pop("occ_max")
        served = self.counters["completed"]
        fills: List[float] = [
            g["batch_fill_ratio"] * g["served"]
            for g in per_geo.values() if g["served"]
        ]
        plan = self._plan if self._plan is not None else ExecutionPlan.single()
        return ServerStats(
            uptime_s=uptime,
            admitted=self.counters["admitted"],
            completed=served,
            failed=self.counters["failed"],
            rejected=self.counters["rejected"],
            queue_depth=self._depth,
            max_queue=self.max_queue,
            num_compiles=self.num_compiles,
            features_extracted=self.counters["features_extracted"],
            features_from_store=self.counters["features_from_store"],
            features_coalesced=self.counters["features_coalesced"],
            traces_per_s=served / uptime if uptime > 0 else 0.0,
            latency_p50_s=self._pct(self._lat_total, 50),
            latency_p99_s=self._pct(self._lat_total, 99),
            queue_p50_s=self._pct(self._lat_queue, 50),
            queue_p99_s=self._pct(self._lat_queue, 99),
            batch_fill_ratio=sum(fills) / served if served else 0.0,
            plan_kind=plan.kind,
            num_shards=plan.num_shards,
            retries=self.counters["retries"],
            deadline_exceeded=self.counters["deadline_exceeded"],
            quarantined=self.counters["quarantined"],
            bisections=self.counters["bisections"],
            breaker_sheds=self.counters["breaker_sheds"],
            breakers={k: b.snapshot() for k, b in self._breakers.items()},
            per_geometry=per_geo,
            per_tenant={k: dict(v) for k, v in self._tenants.items()},
        )
