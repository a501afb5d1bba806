"""ExecutionPlan: one partitioning decision, consumed everywhere.

Counterpart of ``repro/engine/plan.py`` on one GPU.  The reference
resolves four answers once — how a host batch lands on the device(s)
(``device_put``), whether a step body runs under ``shard_map``
(``wrap``), how a shard-local row maps to a global one
(``AxisContext.shard_index``) and how partial sums cross shards
(``AxisContext.psum`` / ``pmax``) — into a frozen, hashable plan that
joins the step-cache keys.  The port runs on one GPU: its only plan is
the single-device one, whose answers are a plain copy to the device, the
body as it is, shard 0 and the identity.  A sharded plan, or any mesh,
raises ``NotImplementedError``: the reference's sharded-plan tests fail
on this tree, so there is nothing to hold a port of them to (ROADMAP
A.14, §C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from .aot import _leaves, tree_map

__all__ = ["AxisContext", "ExecutionPlan"]

# byte alignment of each leaf in device_put's staging buffer: every dtype
# view of it starts aligned
_ALIGN = 16

_SINGLE_ONLY = (
    "the port runs on one GPU: sharded plans and meshes are not ported "
    "(ROADMAP A.14, §C; the reference's sharded-plan tests fail on this tree)"
)


def _pack(host: Any, pin: bool) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """The leaves of a tree of tensors packed into one uint8 buffer (pinned
    with ``pin``), each at an ``_ALIGN``-byte offset, and the function that
    views a copy of that buffer as the tree again."""
    spans: List[Tuple[int, int]] = []
    total = 0
    for t in _leaves(host):
        nbytes = t.numel() * t.element_size()
        spans.append((total, nbytes))
        total += -(-nbytes // _ALIGN) * _ALIGN
    staging = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    buf = staging.numpy()
    it = iter(spans)

    def pack(t: torch.Tensor) -> None:
        # a NumPy copy: no torch dispatch per leaf on the host's hot path
        start, nbytes = next(it)
        a = t.numpy()
        np.copyto(buf[start:start + nbytes].view(a.dtype).reshape(a.shape), a)

    tree_map(pack, host)

    def unpack(buf: torch.Tensor) -> Any:
        views = iter(spans)

        def view(t: torch.Tensor) -> torch.Tensor:
            start, nbytes = next(views)
            return buf[start:start + nbytes].view(t.dtype).view(t.shape)

        return tree_map(view, host)

    return staging, unpack


@dataclasses.dataclass(frozen=True)
class AxisContext:
    """The step-side face of a plan: cross-shard reducers and the shard
    index.  On one device (the only context the port has) the reducers
    are the identity and the index is 0; ``StepContext`` takes its
    ``psum`` / ``pmax`` from here."""

    axes: Tuple[str, ...] = ()   # mesh axes carrying the batch dimension
    sizes: Tuple[int, ...] = ()  # their extents

    def __post_init__(self):
        if self.axes or self.sizes:
            raise NotImplementedError(_SINGLE_ONLY)

    @property
    def num_shards(self) -> int:
        return 1

    def psum(self, x):
        """Cross-shard sum: the identity on one device."""
        return x

    def pmax(self, x):
        """Cross-shard max: the identity on one device."""
        return x

    def shard_index(self, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
        """This shard's linear index over the batch axes, as an int32 0-dim
        tensor on ``device`` (default the CPU): always 0."""
        return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """How one step executes: on the port, always on one device.

    Frozen and hashable, so it joins the step-cache keys as the
    reference's does; ``EngineConfig(plan=ExecutionPlan.single())`` and
    ``EngineConfig()`` resolve to equal plans and share one entry.
    """

    kind: str = "single"                # "single"; "sharded" is not ported
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.kind not in ("single", "sharded"):
            raise ValueError(f"plan kind must be single|sharded, got {self.kind!r}")
        if self.kind == "sharded" or self.mesh is not None or self.batch_axes:
            raise NotImplementedError(_SINGLE_ONLY)

    # ---- construction ---------------------------------------------------

    @classmethod
    def single(cls) -> "ExecutionPlan":
        """The trivial plan: one device, identity reducers."""
        return cls(kind="single")

    @classmethod
    def resolve(
        cls,
        mesh: Optional[Any] = None,
        *,
        batch_size: int,
        plan: Optional["ExecutionPlan"] = None,
    ) -> "ExecutionPlan":
        """The plan for a batch size: ``plan`` after validation, else the
        single-device plan.  Any ``mesh`` raises (not ported)."""
        if mesh is not None:
            raise NotImplementedError(_SINGLE_ONLY)
        if plan is None:
            return cls.single()
        plan.validate_batch(batch_size)
        return plan

    @classmethod
    def auto(cls, batch_size: int) -> "ExecutionPlan":
        """The single-device plan, even where several GPUs are visible:
        the reference shards over all of them, the port does not (one
        GPU per process)."""
        return cls.single()

    # ---- queries --------------------------------------------------------

    @property
    def sharded(self) -> bool:
        return False

    @property
    def num_shards(self) -> int:
        return 1

    def validate_batch(self, batch_size: int) -> None:
        """Reject batch sizes the plan cannot split evenly over its shards
        (on one shard, none)."""
        if batch_size % self.num_shards:
            raise ValueError(
                f"batch_size={batch_size} does not divide over the plan's "
                f"{self.num_shards} shards"
            )

    def local_batch(self, batch_size: int) -> int:
        """Rows of a global batch each shard sees."""
        return batch_size // self.num_shards

    # ---- the four answers ----------------------------------------------

    def device_put(self, batch: Any, device: Union[str, torch.device]) -> Any:
        """A host batch (a tree of NumPy arrays, or CPU tensors of NumPy
        dtypes) on
        ``device``.  On the CPU each leaf is a tensor over the array's own
        memory (no copy).  On a CUDA device the leaves are packed into one
        pinned staging buffer and copied with one ``non_blocking=True``
        copy on the calling thread's current stream; the leaves are views
        of the device copy.  The host does not wait for the device, and the
        copy is ordered after the work already queued on that stream (the
        staging buffer is held until the copy ends by PyTorch's pinned
        allocator)."""
        device = torch.device(device)
        host = tree_map(torch.as_tensor, batch)
        if device.type != "cuda":
            return tree_map(lambda t: t.to(device), host)
        staging, unpack = _pack(host, pin=True)
        return unpack(staging.to(device, non_blocking=True))

    def replicate(self, tree: Any) -> Any:
        """Place a tree on every device of the plan: on one device, the
        tree as it is."""
        return tree

    def wrap(self, fn: Callable, in_specs: Any = None, out_specs: Any = None) -> Callable:
        """The step body over the plan's shards: on one device, ``fn``."""
        return fn

    def axis_context(self) -> AxisContext:
        """The step-side reducers and index mapping (see ``AxisContext``)."""
        return AxisContext()

    def describe(self) -> dict:
        """JSON-friendly summary: the reference's keys and values."""
        return {
            "kind": self.kind,
            "num_shards": self.num_shards,
            "batch_axes": list(self.batch_axes),
            "mesh_shape": {},
        }

    def cache_token(self) -> tuple:
        """Serializable identity for content-addressed keys: the
        reference's token of the single plan."""
        return ("plan", self.kind, tuple(self.batch_axes), ())
