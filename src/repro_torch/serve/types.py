"""Typed request/response surface of the trace server (PyTorch port of
``repro/serve/types.py``, its code verbatim: the wire contract is the
reference's, key for key and code for code).

The wire contract in one place: what a client submits (``ServeRequest``),
what it gets back (``ServeResult``), what an operator scrapes
(``ServerStats``), and the only exception a server lets escape
(``ServeError`` — every internal failure maps to one of its stable codes,
so engine internals never leak to tenants).  All response types have a
``to_dict()`` that is ``json.dumps``-clean; the TCP front-end
(``repro_torch.launch.serve``) and any future HTTP shim serialize exactly these
dicts.

Functional traces are structured NumPy arrays; ``encode_trace`` /
``decode_trace`` round-trip them through JSON (dtype descr + shape +
base64 payload) for clients that submit raw traces over the wire.
"""
from __future__ import annotations

import base64
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "ERROR_CODES",
    "ServeError",
    "ServeRequest",
    "ServeResult",
    "ServerStats",
    "decode_trace",
    "encode_trace",
]


# ---------------------------------------------------------------------------
# Wire codec for functional traces (structured arrays)
# ---------------------------------------------------------------------------


def encode_trace(arr: np.ndarray) -> Dict[str, Any]:
    """A functional trace as a JSON-clean dict (descr + shape + base64)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.names:
        dtype: Any = [list(x) for x in arr.dtype.descr]
    else:
        dtype = arr.dtype.str
    return {
        "dtype": dtype,
        "shape": list(arr.shape),
        "data": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def decode_trace(payload: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`encode_trace`."""
    rec = payload["dtype"]
    dtype = np.dtype([tuple(x) for x in rec] if isinstance(rec, list) else rec)
    raw = base64.b64decode(payload["data"])
    shape = tuple(payload["shape"])
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(raw) != expect:
        raise ValueError(
            f"trace payload is {len(raw)} bytes, expected {expect} for "
            f"dtype={dtype} shape={shape}"
        )
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


# ---------------------------------------------------------------------------
# Errors: the stable failure surface
# ---------------------------------------------------------------------------

# Every way a request can fail, as a closed vocabulary.  Codes — not
# exception reprs — are the tenant-visible contract:
#   QUEUE_FULL          admission queue at capacity (back off retry_after_s)
#   UNKNOWN_MODEL       model name not in the registry
#   BAD_REQUEST         malformed request (empty trace, unknown metric, ...)
#   GEOMETRY_MISMATCH   trace/batch geometry the server's plan cannot run
#   METRIC_NOT_COMPUTED requested metric absent from the run's spec set
#   METRIC_NOT_COLLECTED per-instruction array kept on device
#   SHUTTING_DOWN       server draining; request not admitted
#   DEADLINE_EXCEEDED   the per-request deadline elapsed before completion
#   TRACE_REJECTED      trace quarantined: it deterministically poisons a
#                       batch (bisection isolated it; resubmits are shed)
#   CIRCUIT_OPEN        the model/geometry breaker is open; shed with
#                       retry_after_s instead of queueing doomed work
#   INTERNAL            anything else (detail stays in server logs)
ERROR_CODES = (
    "QUEUE_FULL",
    "UNKNOWN_MODEL",
    "BAD_REQUEST",
    "GEOMETRY_MISMATCH",
    "METRIC_NOT_COMPUTED",
    "METRIC_NOT_COLLECTED",
    "SHUTTING_DOWN",
    "DEADLINE_EXCEEDED",
    "TRACE_REJECTED",
    "CIRCUIT_OPEN",
    "INTERNAL",
)


class ServeError(Exception):
    """The one exception a server surfaces to clients.

    ``code`` is from :data:`ERROR_CODES`; ``retry_after_s`` is set on
    QUEUE_FULL rejections (the 429-style backoff hint).  ``to_dict()``
    is the wire form.
    """

    def __init__(
        self,
        code: str,
        message: str,
        *,
        retry_after_s: Optional[float] = None,
        request_id: Optional[str] = None,
    ):
        if code not in ERROR_CODES:
            raise ValueError(f"unknown ServeError code {code!r}")
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.retry_after_s = retry_after_s
        self.request_id = request_id

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "error": self.code,
            "message": self.message,
        }
        if self.retry_after_s is not None:
            out["retry_after_s"] = round(float(self.retry_after_s), 6)
        if self.request_id is not None:
            out["request_id"] = self.request_id
        return out

    @classmethod
    def wrap(cls, exc: BaseException, request_id: Optional[str] = None) -> "ServeError":
        """Map an arbitrary internal exception onto the stable surface.
        Unrecognized exception types become INTERNAL with a generic
        message — tracebacks and engine internals never reach a tenant."""
        # local import: engine pulls in torch; keep types importable alone
        from ..engine.runner import (
            MetricNotCollectedError,
            MetricNotComputedError,
        )

        if isinstance(exc, ServeError):
            return exc
        if isinstance(exc, MetricNotCollectedError):
            return cls("METRIC_NOT_COLLECTED", str(exc), request_id=request_id)
        if isinstance(exc, MetricNotComputedError):
            return cls("METRIC_NOT_COMPUTED", str(exc), request_id=request_id)
        return cls(
            "INTERNAL",
            f"internal server error ({type(exc).__name__})",
            request_id=request_id,
        )


# ---------------------------------------------------------------------------
# Request / response
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeRequest:
    """One tenant's ask: simulate ``trace`` under registry model ``model``.

    ``trace`` is a functional trace array or a ``repro_torch.api.Trace`` (whose
    content digest then feeds the server's same-trace coalescing without a
    re-hash).  ``metrics=None`` means the server's default spec set —
    sticking to it keeps the request inside the warm executable pool;
    bespoke tuples are honored but capture their own step on first use.
    """

    model: str
    trace: Any                          # np.ndarray | repro_torch.api.Trace
    tenant: str = "default"
    metrics: Optional[Tuple] = None     # names / MetricSpec instances
    request_id: Optional[str] = None    # assigned at admission when None
    # per-request deadline (seconds from admission; None = the server's
    # default).  Past it the request fails DEADLINE_EXCEEDED — whether it
    # is still queued or hung on the device.
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class ServeResult:
    """What a completed request returns: the metrics plus where the time
    went (queue wait vs feature prep vs device compute) and whether the
    feature pre-pass was shared with another request (``coalesced``)."""

    request_id: str
    model: str
    tenant: str
    geometry: str                       # bucket label, e.g. "w9b8"
    num_instructions: int
    metrics: Dict[str, Any]             # scalars + phase-curve arrays
    queue_s: float
    compute_s: float
    total_s: float
    extract_s: float = 0.0
    coalesced: bool = False

    def to_dict(self) -> Dict[str, Any]:
        metrics = {
            k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in self.metrics.items()
        }
        return {
            "request_id": self.request_id,
            "model": self.model,
            "tenant": self.tenant,
            "geometry": self.geometry,
            "num_instructions": self.num_instructions,
            "metrics": metrics,
            "queue_s": round(self.queue_s, 6),
            "extract_s": round(self.extract_s, 6),
            "compute_s": round(self.compute_s, 6),
            "total_s": round(self.total_s, 6),
            "coalesced": self.coalesced,
        }


@dataclasses.dataclass
class ServerStats:
    """Point-in-time observability snapshot (``TraceServer.stats()``).

    ``per_geometry`` keys are bucket labels; each value carries the
    bucket's current queue occupancy, served count, and mean batch fill
    ratio (real windows / padded batch slots — 1.0 means every executable
    replay was full).  Latency percentiles are over a bounded window of
    recent completions.

    Degradation is observable, not silent: ``retries`` (transient-failure
    redispatches), ``deadline_exceeded``, ``quarantined`` (poison traces
    isolated by batch bisection), ``bisections`` (split rounds run),
    ``breaker_sheds`` (admissions refused by an open circuit), and
    ``breakers`` (per ``model/geometry`` breaker snapshots) count every
    resilience action the server took.
    """

    uptime_s: float
    admitted: int
    completed: int
    failed: int
    rejected: int
    queue_depth: int
    max_queue: int
    num_compiles: int
    features_extracted: int
    features_from_store: int
    features_coalesced: int
    traces_per_s: float
    latency_p50_s: float
    latency_p99_s: float
    queue_p50_s: float
    queue_p99_s: float
    batch_fill_ratio: float
    plan_kind: str
    num_shards: int
    retries: int
    deadline_exceeded: int
    quarantined: int
    bisections: int
    breaker_sheds: int
    breakers: Dict[str, Dict[str, Any]]
    per_geometry: Dict[str, Dict[str, Any]]
    per_tenant: Dict[str, Dict[str, int]]

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        for k, v in out.items():
            if isinstance(v, float):
                out[k] = round(v, 6)
        return out
