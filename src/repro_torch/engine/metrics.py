"""Device-side metric accumulators for the streaming engine, in PyTorch.

Counterpart of ``repro/engine/metrics.py`` on one device: a ``MetricSpec``
declares an accumulator — an ``init`` tree of device tensors, an
``update`` that folds one batch into it on the device, and a host-side
``finalize`` that runs after the engine's single end-of-trace sync.  The
reference's cross-shard reducers ``psum`` / ``pmax`` are the identity here.

The built-in specs follow the reference's semantics: CPI by retire clock
(the fetch-latency sum plus the exec latency of the trace's last valid
instruction), branch and L1D MPKI as exact int32 counts, the predicted
data-level histogram, and the ``cpi_phase`` / ``l1d_phase`` curves over a
fixed number of trace phases.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..uarch.isa import DLEVEL_L2, NUM_DLEVELS

__all__ = [
    "StepContext",
    "MetricSpec",
    "METRIC_REGISTRY",
    "DEFAULT_METRICS",
    "DEFAULT_PHASE_CHUNKS",
    "register_metric",
    "resolve_metrics",
    "windowed_spec",
    "CPI",
    "BRANCH_MPKI",
    "L1D_MPKI",
    "DLEVEL_HIST",
    "CPI_PHASE",
    "L1D_PHASE",
]


def _identity(x):
    return x


@dataclasses.dataclass(frozen=True)
class StepContext:
    """Everything a metric's ``update`` may read, for one (B, W) batch.

    Arrays are flattened to ``(B * W,)`` device tensors.  ``is_branch`` /
    ``is_mem`` are already masked to valid positions; the raw batch is in
    ``batch``.
    """

    valid: torch.Tensor         # float32 validity mask (0.0 on padding)
    on: torch.Tensor            # bool, valid > 0
    is_branch: torch.Tensor     # bool, trace is_branch & on
    is_mem: torch.Tensor        # bool, trace is_mem & on
    fetch_lat: torch.Tensor     # float32, clamped >= 0
    exec_lat: torch.Tensor      # float32, clamped >= 0
    mispred_prob: torch.Tensor  # float32 sigmoid(mispred_logit)
    dlevel: torch.Tensor        # int32 argmax(dlevel_logits)
    gidx: torch.Tensor          # float32 position key within the batch
    last_key: torch.Tensor      # scalar: key of the last valid position
                                # of the batch (-1.0 when all padding)
    batch: Dict[str, torch.Tensor]
    window: int = 0             # effective window length W
    win_index: Optional[torch.Tensor] = None  # (B,) int32 trace-global
                                # window index of each row (>= num_windows
                                # on padding rows)
    num_windows: int = 0        # real windows in the whole trace
    # the reference's cross-shard reducers: the identity on one device
    psum: Callable[[Any], Any] = _identity
    pmax: Callable[[Any], Any] = _identity

    def at_last(self, x: torch.Tensor) -> torch.Tensor:
        """Value of ``x`` at the last valid position of the batch
        (meaningful only when ``last_key >= 0``)."""
        return x[torch.argmax(torch.where(self.on, self.gidx, -1.0))]

    def per_window(self, x: torch.Tensor) -> torch.Tensor:
        """``(B*W,)`` -> ``(B, W)``."""
        return x.reshape(-1, self.window)

    def chunk_of(self, num_chunks: int) -> torch.Tensor:
        """Each window's phase-chunk bucket in ``[0, num_chunks)``: the
        trace's window grid cut into ``num_chunks`` contiguous phases.
        Padding windows clamp into the last bucket (their contribution is
        masked).  int32 math: the engine enforces
        ``num_windows * num_chunks < 2^31``."""
        b = (self.win_index * num_chunks) // max(self.num_windows, 1)
        return torch.clamp(b, 0, num_chunks - 1)

    def windowed_sum(self, values: torch.Tensor, num_chunks: int) -> torch.Tensor:
        """Scatter already-masked per-position ``values`` into a
        ``(num_chunks,)`` phase accumulator."""
        per_win = self.per_window(values).sum(dim=1, dtype=values.dtype)
        seg = torch.zeros(num_chunks, dtype=per_win.dtype, device=per_win.device)
        return self.psum(seg.index_add_(0, self.chunk_of(num_chunks), per_win))


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One device-side metric accumulator.

    ``init``     (device) -> carry tree of device tensors (zeros)
    ``update``   (carry, StepContext) -> carry; once per batch, on device
    ``finalize`` (host carry tree of NumPy arrays, num_instructions) ->
                 {metric: value}; floats for scalars, ndarrays for curves
    """

    name: str
    init: Callable[[torch.device], Any]
    update: Callable[[Any, "StepContext"], Any]
    finalize: Callable[[Any, int], Dict[str, Any]]
    # windowed (phase-curve) specs declare their carry length here so the
    # engine can enforce the int32 chunk-index envelope
    num_chunks: Optional[int] = None


# ---------------------------------------------------------------------------
# Built-in specs
# ---------------------------------------------------------------------------


def _cpi_init(device):
    return {
        "fetch_sum": torch.zeros((), dtype=torch.float32, device=device),
        "last_exec": torch.zeros((), dtype=torch.float32, device=device),
    }


def _cpi_update(carry, ctx: StepContext):
    part = ctx.psum((ctx.fetch_lat * ctx.valid).sum(dtype=torch.float32))
    return {
        "fetch_sum": carry["fetch_sum"] + part,
        # retire-clock formulation: total cycles end at the last valid
        # instruction's exec latency, so track it across batches
        "last_exec": torch.where(
            ctx.last_key >= 0, ctx.at_last(ctx.exec_lat), carry["last_exec"]
        ),
    }


def _cpi_finalize(carry, n: int) -> Dict[str, float]:
    total = float(carry["fetch_sum"] + carry["last_exec"])
    return {"cpi": total / max(n, 1), "total_cycles": total}


CPI = MetricSpec("cpi", _cpi_init, _cpi_update, _cpi_finalize)  # tao: noqa[TAO004] the port's counterpart of the reference spec: each package keeps its own registry


def _int_count_init(device):
    # exact int32 counts (good to 2^31 instructions per trace)
    return torch.zeros((), dtype=torch.int32, device=device)


def _branch_update(carry, ctx: StepContext):
    return carry + ctx.psum(
        ((ctx.mispred_prob > 0.5) & ctx.is_branch).sum(dtype=torch.int32)
    )


def _branch_finalize(carry, n: int) -> Dict[str, float]:
    return {"branch_mpki": 1000.0 * float(carry) / max(n, 1)}


BRANCH_MPKI = MetricSpec("branch_mpki", _int_count_init, _branch_update, _branch_finalize)  # tao: noqa[TAO004] the port's counterpart of the reference spec: each package keeps its own registry


def _l1d_update(carry, ctx: StepContext):
    return carry + ctx.psum(
        ((ctx.dlevel >= DLEVEL_L2) & ctx.is_mem).sum(dtype=torch.int32)
    )


def _l1d_finalize(carry, n: int) -> Dict[str, float]:
    return {"l1d_mpki": 1000.0 * float(carry) / max(n, 1)}


L1D_MPKI = MetricSpec("l1d_mpki", _int_count_init, _l1d_update, _l1d_finalize)  # tao: noqa[TAO004] the port's counterpart of the reference spec: each package keeps its own registry


def _dlevel_hist_init(device):
    return torch.zeros((NUM_DLEVELS,), dtype=torch.int32, device=device)


def _dlevel_hist_update(carry, ctx: StepContext):
    onehot = F.one_hot(ctx.dlevel.long(), NUM_DLEVELS).to(torch.int32)
    return carry + ctx.psum(
        (onehot * ctx.is_mem[:, None].to(torch.int32)).sum(dim=0, dtype=torch.int32)
    )


_DLEVEL_NAMES = ("none", "l1", "l2", "dram")


def _dlevel_hist_finalize(carry, n: int) -> Dict[str, float]:
    return {
        f"dlevel_{_DLEVEL_NAMES[i]}": float(carry[i]) for i in range(NUM_DLEVELS)
    }


DLEVEL_HIST = MetricSpec(  # tao: noqa[TAO004] the port's counterpart of the reference spec: each package keeps its own registry
    "dlevel_hist", _dlevel_hist_init, _dlevel_hist_update, _dlevel_hist_finalize
)


# ---------------------------------------------------------------------------
# Windowed (phase-curve) specs: a declared (num_chunks,) device carry
# ---------------------------------------------------------------------------

DEFAULT_PHASE_CHUNKS = 32


def windowed_spec(
    name: str,
    value: Callable[["StepContext"], torch.Tensor],
    *,
    num_chunks: int = DEFAULT_PHASE_CHUNKS,
    count: Optional[Callable[["StepContext"], torch.Tensor]] = None,
) -> MetricSpec:
    """A phase-curve MetricSpec: mean of ``value(ctx)`` per trace phase.

    ``value`` returns per-position contributions (valid positions only are
    counted — the factory masks with ``ctx.valid``); ``count`` picks the
    denominator population (a bool mask; default every valid instruction).
    The carry is ``{"sum": (num_chunks,) f32, "count": (num_chunks,) i32}``
    and ``finalize`` emits ``{name: (num_chunks,) float32 ndarray}``
    (phases with an empty population report 0).
    """
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")

    def init(device):
        return {
            "sum": torch.zeros((num_chunks,), dtype=torch.float32, device=device),
            "count": torch.zeros((num_chunks,), dtype=torch.int32, device=device),
        }

    def update(carry, ctx: "StepContext"):
        vals = value(ctx).to(torch.float32) * ctx.valid
        pop = ctx.on if count is None else count(ctx)
        return {
            "sum": carry["sum"] + ctx.windowed_sum(vals, num_chunks),
            "count": carry["count"]
            + ctx.windowed_sum(pop.to(torch.int32), num_chunks),
        }

    def finalize(carry, n: int) -> Dict[str, Any]:
        cnt = np.asarray(carry["count"], dtype=np.int64)
        curve = np.asarray(carry["sum"], dtype=np.float32) / np.maximum(cnt, 1)
        return {name: curve.astype(np.float32)}

    return MetricSpec(name, init, update, finalize, num_chunks=num_chunks)


# Fig. 11-style phase curves: per-phase CPI (mean fetch cycles per
# instruction) and per-phase L1D miss rate over memory ops.  Registered,
# not default.
CPI_PHASE = windowed_spec("cpi_phase", lambda ctx: ctx.fetch_lat)  # tao: noqa[TAO004] the port's counterpart of the reference spec: each package keeps its own registry
L1D_PHASE = windowed_spec(  # tao: noqa[TAO004] the port's counterpart of the reference spec: each package keeps its own registry
    "l1d_phase",
    lambda ctx: ((ctx.dlevel >= DLEVEL_L2) & ctx.is_mem).to(torch.float32),
    count=lambda ctx: ctx.is_mem,
)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

METRIC_REGISTRY: Dict[str, MetricSpec] = {}

DEFAULT_METRICS: Tuple[str, ...] = ("cpi", "branch_mpki", "l1d_mpki")


def register_metric(spec: MetricSpec, *, overwrite: bool = False) -> MetricSpec:
    if not overwrite and spec.name in METRIC_REGISTRY:
        raise ValueError(
            f"metric {spec.name!r} already registered "
            f"(pass overwrite=True to replace it)"
        )
    METRIC_REGISTRY[spec.name] = spec
    return spec


for _spec in (CPI, BRANCH_MPKI, L1D_MPKI, DLEVEL_HIST, CPI_PHASE, L1D_PHASE):
    register_metric(_spec)


def resolve_metrics(
    metrics: Tuple[Union[str, MetricSpec], ...],
) -> Tuple[MetricSpec, ...]:
    """Names -> registry lookup; MetricSpec instances pass through."""
    specs = []
    seen = set()
    for m in metrics:
        spec = m
        if isinstance(m, str):
            spec = METRIC_REGISTRY.get(m)
            if spec is None:
                raise KeyError(
                    f"unknown metric {m!r}; registered: "
                    f"{sorted(METRIC_REGISTRY)} (register_metric() adds more)"
                )
        elif not isinstance(m, MetricSpec):
            raise TypeError(f"metrics entries must be str or MetricSpec, got {m!r}")
        if spec.name in seen:
            raise ValueError(f"duplicate metric {spec.name!r}")
        seen.add(spec.name)
        specs.append(spec)
    if not specs:
        raise ValueError("at least one metric is required")
    return tuple(specs)
