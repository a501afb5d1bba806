"""Fault injection and resilience primitives (PyTorch port of
``repro.resilience``), each standard-library only:

  * :mod:`.faults` — ``FaultPlan`` / ``inject()`` / ``fault_point()``: the
    deterministic, seedable chaos harness, armed over named sites threaded
    through the port's store, engine, scheduler, trace server and TCP
    front end.
  * :mod:`.retry` — ``RetryPolicy`` (bounded exponential backoff) and the
    transient-vs-poison failure classifier the server's dispatch uses.
  * :mod:`.breaker` — a per-``model/geometry`` ``CircuitBreaker`` that
    sheds load with ``retry_after_s`` instead of queueing doomed work.
  * :mod:`.manifest` — crash-resume progress manifests for training and
    sweeps, published through the artifact store.  (Imported lazily —
    ``from repro_torch.resilience import manifest`` — because it pulls in
    the store package, which itself hooks ``fault_point``.)
"""
from __future__ import annotations

from .breaker import CircuitBreaker
from .faults import SITES, FaultError, FaultPlan, FaultSpec, fault_point, inject
from .retry import RetryPolicy, is_transient

__all__ = [
    "SITES",
    "CircuitBreaker",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "RetryPolicy",
    "fault_point",
    "inject",
    "is_transient",
]
