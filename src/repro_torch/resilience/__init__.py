"""Fault injection and crash-resume manifests (PyTorch port of
``repro.resilience``).

  * :mod:`.faults` — ``FaultPlan`` / ``inject()`` / ``fault_point()``: the
    deterministic, seedable chaos harness, armed over named sites threaded
    through the port's store and engine.
  * :mod:`.manifest` — crash-resume progress manifests for training and
    sweeps, published through the artifact store.  (Imported lazily —
    ``from repro_torch.resilience import manifest`` — because it pulls in
    the store package, which itself hooks ``fault_point``.)

The reference's ``retry`` (``RetryPolicy``, ``is_transient``) and
``breaker`` (``CircuitBreaker``) serve its trace server; they are ported
with the server (ROADMAP A.11).
"""
from __future__ import annotations

from .faults import SITES, FaultError, FaultPlan, FaultSpec, fault_point, inject

__all__ = [
    "SITES",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "fault_point",
    "inject",
]
