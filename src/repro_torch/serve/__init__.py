"""Simulation-as-a-service: continuous batching over the streaming engine
(PyTorch port of ``repro.serve``).

``TraceServer`` admits concurrent (trace, model) requests from many
tenants and routes them into the engine's per-geometry captured steps —
so concurrency never multiplies captures, same-trace requests share one
feature pre-pass on the host route, admission is bounded with 429-style
rejection, service order is fair across tenants and geometries, and every
call that touches the card holds the server's device lock.
``ModelRegistry`` resolves names to trained/transfer-adapted heads
through the artifact store, in entries the reference package reads too.
"""
from .registry import ModelRegistry
from .server import TraceServer
from .types import (
    ERROR_CODES,
    ServeError,
    ServeRequest,
    ServeResult,
    ServerStats,
    decode_trace,
    encode_trace,
)

__all__ = [
    "ERROR_CODES",
    "ModelRegistry",
    "ServeError",
    "ServeRequest",
    "ServeResult",
    "ServerStats",
    "TraceServer",
    "decode_trace",
    "encode_trace",
]
