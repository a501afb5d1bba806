"""Runtime sanitizer: the port's counterpart of ``repro/analysis/sanitize.py``.

``sanitized(*, transfer_guard="disallow", debug_nans=True,
compile_budget=None)`` runs a block with the main path's invariants
hard-enforced, in PyTorch's idiom:

  * ``transfer_guard`` — ``torch.cuda.set_sync_debug_mode("error")`` for
    the block, the previous mode restored on its exit (also when it
    raises): an operation that makes the host wait for the card (a
    ``.item()``, ``float()``, ``.cpu()`` or ``.numpy()`` of a CUDA tensor,
    a blocking copy in either direction, ``nonzero``, a stream
    synchronize) raises a ``RuntimeError`` instead of silently stalling the
    launch queue.  The sanctioned pulls pass: ``engine.runner.device_get``,
    the end-of-trace copy (the reference's ``jax.device_get``), and this
    module's own read of the NaN flag, each inside ``allowed_sync()``, the
    one place that suspends the guard.  ``"disallow"`` arms it (``"log"``
    warns, ``"allow"`` and None leave syncs alone).  PyTorch keeps one mode
    for the whole process: the guard also covers what other threads
    launch during the block (the trace server's dispatch thread among
    them), and an ``allowed_sync`` in one thread lifts it for all of them
    for the length of its copy.
    **CPU caveat**: the mode acts on CUDA work only.  Without a card there
    is no launch queue to stall and no synchronizing CUDA call, so the
    guard arms and cannot fire, as the reference's cannot on its CPU
    backend; on the CPU the teeth of a sanitized block are ``debug_nans``
    and the compile budget.
  * ``debug_nans`` — a NaN in a floating output of an op run in the block
    raises ``FloatingPointError`` (the reference's type) naming the first
    op that made one.  A ``TorchDispatchMode`` sees each op: on the CPU it
    checks the outputs as the op returns; on the card a check per op would
    itself be a sync the guard forbids, so it keeps a flag on the device
    (the index of the first op whose output held a NaN, one reduction per
    output) and reads it once at the block's exit, through
    ``allowed_sync``.  Autograd carries the mode into its backward, so
    backward ops are checked too; ``torch.autograd.detect_anomaly
    (check_nan=True)``, the backward's usual NaN check, reads each
    function's outputs back to the host, a sync per function on the card,
    and is not entered.  Limits: ops of a CUDA-graph replay and the port's
    ctypes kernels are not dispatched, so a NaN they make is seen only at
    the next op that reads it; ops run while a graph is captured are not
    checked (the check would be captured with them); views and the
    uninitialized outputs of ``empty``-like ops are not checked; ops of
    other threads are not seen (the mode belongs to the thread that
    entered the block).
  * ``compile_budget`` — snapshots ``compiles_now()`` on entry and raises
    ``CompileBudgetExceeded`` if the block compiled more than allowed:
    the one-compile-per-geometry invariant as a hard runtime check
    (``None``: unbounded; ``0``: the warm-cache contract).  The port's
    compiles are the engine's step captures
    (``engine.runner.cache_stats()["compiles"]``), the trainer's
    (``train.trainer.train_step_compiles()``) and ``nvcc`` builds
    (``engine.aot.build_cache_counters()["misses"]``).

The reference arms its sanitizer for tests marked ``sanitize`` through
``tests/conftest.py``; that marker stays the reference's, and the port's
tests enter ``sanitized`` directly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CompileBudgetExceeded", "allowed_sync", "compiles_now", "sanitized"]

# the reference's transfer-guard levels -> torch.cuda's sync debug modes
_GUARD_MODES = {"disallow": "error", "log": "warn", "allow": "default"}
# one mode per process: its reads and writes pair up under this lock
_MODE_LOCK = threading.RLock()
# ops whose outputs are not checked for NaNs: fresh, uninitialized memory
_UNCHECKED = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                        "resize_", "set_"})
_NO_NAN = torch.iinfo(torch.int64).max


class CompileBudgetExceeded(AssertionError):
    """A sanitized block compiled more step executables than budgeted."""


def compiles_now() -> int:
    """Total compiles so far, process-wide: engine step captures, train
    step compiles and ``nvcc`` builds."""
    from ..engine import aot as _aot
    from ..engine import runner as _runner
    from ..train import trainer as _trainer

    return (int(_runner.cache_stats()["compiles"]) + int(_trainer.train_step_compiles())
            + int(_aot.build_cache_counters()["misses"]))


@contextlib.contextmanager
def _sync_debug_mode(mode: str) -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, the previous
    mode restored after it, also when it raises; nothing without a card."""
    if not torch.cuda.is_available():
        yield
        return
    with _MODE_LOCK:
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        with _MODE_LOCK:
            torch.cuda.set_sync_debug_mode(previous)


@contextlib.contextmanager
def allowed_sync() -> Iterator[None]:
    """The sanctioned host sync: the guard suspended for the block (the
    lock held, so that no other thread's guard changes in between), then
    restored."""
    with _MODE_LOCK, _sync_debug_mode("default"):
        yield


def _deferred(t: torch.Tensor) -> bool:
    """Whether a tensor's NaN check is kept on its device for the block's
    exit (a CUDA tensor) rather than read as its op returns."""
    return t.is_cuda


class _NanCheck(TorchDispatchMode):
    """The ``debug_nans`` mode (module note)."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []                     # the deferred checks' ops, by index
        self.first: Dict[torch.device, torch.Tensor] = {}  # per device: first index, or _NO_NAN

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _UNCHECKED:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                self._check(func, t)
        return out

    def _check(self, func, t: torch.Tensor) -> None:
        if not _deferred(t):
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(f"sanitized block: NaN in the output of {func}")
            return
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        flag = self.first.get(t.device)
        if flag is None:
            # a plain tensor, which ops in and out of inference mode may update
            with torch.inference_mode(False):
                flag = torch.full((), _NO_NAN, dtype=torch.int64, device=t.device)
            self.first[t.device] = flag
        torch.minimum(flag, torch.where(torch.isnan(t).any(), len(self.ops), _NO_NAN), out=flag)
        self.ops.append(str(func))

    def raise_deferred(self) -> None:
        """Read the device flags (one read each, through ``allowed_sync``)
        and raise for the first op whose output held a NaN."""
        if not self.first:
            return
        with allowed_sync():
            first = min(int(f) for f in self.first.values())
        if first != _NO_NAN:
            raise FloatingPointError(
                f"sanitized block: NaN in the output of {self.ops[first]}, the first of the "
                f"{len(self.ops)} ops checked on the device to make one")


@contextlib.contextmanager
def sanitized(
    *,
    transfer_guard: Optional[str] = "disallow",
    debug_nans: bool = True,
    compile_budget: Optional[int] = None,
) -> Iterator[None]:
    """Run a block with the repo's runtime invariants hard-enforced.

    ``transfer_guard`` refuses hidden host syncs (see the module note for
    the sanctioned pulls and the CPU caveat): ``"disallow"`` raises,
    ``"log"`` warns, ``"allow"`` or None leave them alone, e.g. for code
    paths that legitimately sync mid-stream.

    ``debug_nans`` raises ``FloatingPointError`` for a NaN made in the
    block (on the card: at the block's exit).

    ``compile_budget`` bounds *new* compiles inside the block (``None`` =
    unbounded; ``0`` = the warm-cache contract: everything was compiled
    before the block started).
    """
    if transfer_guard is not None and transfer_guard not in _GUARD_MODES:
        raise ValueError(f"transfer_guard={transfer_guard!r}; have {sorted(_GUARD_MODES)} or None")
    start = compiles_now() if compile_budget is not None else 0
    check = _NanCheck() if debug_nans else None
    with contextlib.ExitStack() as stack:
        if transfer_guard is not None:
            stack.enter_context(_sync_debug_mode(_GUARD_MODES[transfer_guard]))
        if check is not None:
            stack.enter_context(check)
        yield
    if check is not None:
        check.raise_deferred()
    if compile_budget is not None:
        spent = compiles_now() - start
        if spent > compile_budget:
            raise CompileBudgetExceeded(
                f"sanitized block compiled {spent} step(s), budget was "
                f"{compile_budget} — a cache key miss or geometry change "
                "slipped into the hot path"
            )
