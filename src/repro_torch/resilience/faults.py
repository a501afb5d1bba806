"""Deterministic, seedable fault injection for chaos testing.

The port's own copy of ``repro/resilience/faults.py`` (standard library
only), kept verbatim so that one seeded plan fires at the same calls in
both packages.  ``SITES`` lists the reference's sites; the port threads
every one of them.

The harness is two tiny pieces:

  * ``fault_point("site", payload=...)`` — a named hook threaded through
    the production code paths (store loads, step compiles, serve
    dispatch, TCP replies, ...).  With no plan active it is one global
    read and a ``None`` check — cheap enough for hot paths.

  * ``FaultPlan`` + ``inject(plan)`` — a context manager that arms a list
    of ``FaultSpec``s.  Each spec names a site and describes what happens
    there (raise an exception, sleep past a deadline), *when* it happens
    (after N clean hits, at most M times, only for payloads containing a
    substring, or with seeded probability ``p``), so every chaos test is
    reproducible from its plan alone.

Faults raised here carry a ``transient`` flag the serving layer's retry
classifier reads: transient faults model flaky infrastructure (worth a
backoff retry), non-transient ones model poison inputs (quarantine, do
not retry).  Sites are plain strings; the canonical set lives in
``SITES`` purely as documentation — ``fault_point`` accepts any name.

Thread-safe: sites fire from the serve dispatch/extract pools and the
sweep producer thread, so plan state is mutated under a lock (the sleep
of a ``delay`` fault happens outside it).
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SITES",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "fault_point",
    "inject",
]


# the sites the repo threads through its layers (documentation, not an
# enforced registry — tests grep this when naming new hooks)
SITES: Tuple[str, ...] = (
    "store.load",          # ArtifactStore.get deserialization
    "engine.compile",      # StreamingEngine step-cache miss (jit/AOT build)
    "engine.simulate",     # StreamingEngine.simulate entry
    "scheduler.prepare",   # TraceSweeper producer-thread feature prep
    "scheduler.consume",   # TraceSweeper per-job device consume
    "serve.extract",       # TraceServer feature pre-pass (extract pool)
    "serve.dispatch",      # TraceServer per-request device dispatch
    "tcp.reply",           # launch.serve response write
)


class FaultError(RuntimeError):
    """An injected failure.  ``transient=True`` models flaky
    infrastructure (retry-worthy), ``False`` a deterministic poison."""

    def __init__(self, site: str, message: str = "injected fault", *,
                 transient: bool = False):
        super().__init__(f"{message} [site={site}]")
        self.site = site
        self.transient = transient


# exception classes a spec may raise instead of FaultError — kept to a
# closed set so env-supplied plans cannot name arbitrary types
_EXC_TYPES: Dict[str, type] = {
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "OSError": OSError,
    "ConnectionResetError": ConnectionResetError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "MemoryError": MemoryError,
}


class FaultSpec:
    """One arming rule: at ``site``, after ``after`` clean hits, fire at
    most ``times`` times (None = every hit), optionally only when
    ``match`` is a substring of the payload, optionally with seeded
    probability ``p``.  ``kind`` is ``"error"`` (raise) or ``"delay"``
    (sleep ``delay_s`` — models a hung step/worker)."""

    __slots__ = ("site", "kind", "times", "after", "match", "p",
                 "delay_s", "transient", "exc", "message")

    def __init__(
        self,
        site: str,
        *,
        kind: str = "error",
        times: Optional[int] = 1,
        after: int = 0,
        match: Optional[str] = None,
        p: Optional[float] = None,
        delay_s: float = 0.0,
        transient: bool = True,
        exc: Optional[str] = None,
        message: str = "injected fault",
    ):
        if kind not in ("error", "delay"):
            raise ValueError(f"fault kind must be 'error' or 'delay', got {kind!r}")
        if exc is not None and exc not in _EXC_TYPES:
            raise ValueError(
                f"unknown fault exception {exc!r}; one of {sorted(_EXC_TYPES)}"
            )
        self.site = site
        self.kind = kind
        self.times = times
        self.after = after
        self.match = match
        self.p = p
        self.delay_s = delay_s
        self.transient = transient
        self.exc = exc
        self.message = message

    def build_exception(self) -> BaseException:
        if self.exc is None:
            return FaultError(self.site, self.message, transient=self.transient)
        return _EXC_TYPES[self.exc](f"{self.message} [site={self.site}]")

    def to_dict(self) -> Dict[str, Any]:
        return {s: getattr(self, s) for s in self.__slots__}


class FaultPlan:
    """An armed set of specs plus its deterministic firing state.

    The plan records every fired fault in ``fired`` (site, payload, spec
    index) so a failing chaos test prints exactly which injections the
    run saw; ``hits`` counts per-site traffic whether or not anything
    fired.
    """

    def __init__(self, *faults: FaultSpec, seed: int = 0):
        self.faults: List[FaultSpec] = list(faults)
        self.seed = seed
        self.hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []
        self._seen: List[int] = [0] * len(self.faults)   # matched hits/spec
        self._shot: List[int] = [0] * len(self.faults)   # fires/spec
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    # called from fault_point under no assumption about the thread
    def hit(self, site: str, payload: Any = None) -> None:
        action: Optional[FaultSpec] = None
        with self._lock:
            self.hits[site] = self.hits.get(site, 0) + 1
            text = "" if payload is None else str(payload)
            for i, spec in enumerate(self.faults):
                if spec.site != site:
                    continue
                if spec.match is not None and spec.match not in text:
                    continue
                self._seen[i] += 1
                if self._seen[i] <= spec.after:
                    continue
                if spec.times is not None and self._shot[i] >= spec.times:
                    continue
                if spec.p is not None and self._rng.random() >= spec.p:
                    continue
                self._shot[i] += 1
                self.fired.append((site, text, i))
                action = spec
                break
        if action is None:
            return
        if action.kind == "delay":
            time.sleep(action.delay_s)
            return
        raise action.build_exception()

    @classmethod
    def from_env(cls, var: str = "REPRO_FAULT_PLAN") -> Optional["FaultPlan"]:
        """Build a plan from a JSON env knob (the CI chaos-smoke hook)::

            REPRO_FAULT_PLAN='{"seed": 7, "faults": [
                {"site": "store.load", "times": 2}]}'

        Returns None when the variable is unset/empty."""
        raw = os.environ.get(var, "").strip()
        if not raw:
            return None
        obj = json.loads(raw)
        specs = [FaultSpec(f.pop("site"), **f) for f in obj.get("faults", [])]
        return cls(*specs, seed=int(obj.get("seed", 0)))


_ACTIVE: Optional[FaultPlan] = None
_ARM_LOCK = threading.Lock()


def fault_point(site: str, payload: Any = None) -> None:
    """Production-side hook: no-op unless a plan is injected."""
    plan = _ACTIVE
    if plan is None:
        return
    plan.hit(site, payload)


@contextlib.contextmanager
def inject(plan: Optional[FaultPlan]):
    """Arm ``plan`` for the duration of the block (process-global, not
    reentrant — chaos tests run one plan at a time).  ``inject(None)``
    is a no-op pass-through so call sites can be unconditional."""
    global _ACTIVE
    if plan is None:
        yield None
        return
    with _ARM_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already injected")
        _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None
