"""The process-wide train-step cache: one entry per recipe, one CUDA graph
per batch geometry on the card.

Counterpart of the step cache of ``repro/train/trainer.py`` (its LLM
trainer is not ported yet).  The reference jits each trainer's step once
per (model config, optimizer config, trainable set) and traces it once
per (batch, window) geometry; parameters and optimizer state are
arguments, so every run of one recipe shares the executable.  Here an
entry holds the eager step ``fn(params, carry, batch) -> (new_carry,
out)`` and, on a CUDA device, one ``engine.aot.CapturedStep`` per
geometry, captured in grad mode from ``fn``.  ``compiles`` counts the
geometries an entry has met: captures on the card, first sightings on
the CPU (where nothing is captured), so it is one per geometry on both.

A trainer drives a captured geometry in three moves: ``load`` its
parameters and optimizer state into the graph's static buffers once a
run, ``replay`` per batch, ``store`` the static state back before anything
reads it (an eval, a checkpoint, the end of the run).  Calling the entry
does all three per call on a CUDA device (the caller's tensors updated in
place) and runs ``fn`` on the CPU.  A capture or replay error raises:
nothing falls back to the eager step on the card.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

__all__ = [
    "CachedTrainStep",
    "cached_train_step",
    "cache_stats",
    "clear_train_step_cache",
    "train_step_compiles",
]


def _shapes(tree: Any, path: str = ""):
    """(path, shape, dtype name) of every leaf of a tree of dicts of
    tensors or NumPy arrays, sorted by path."""
    if isinstance(tree, dict):
        return sorted(x for k, v in tree.items() for x in _shapes(v, f"{path}/{k}"))
    return [(path, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


def geometry(batch: Any, device: torch.device) -> Tuple:
    """The key of a batch's geometry: the device, and each input's shape
    and dtype (NumPy arrays and tensors of one shape and dtype agree)."""
    return (str(device), *_shapes(batch))


class CachedTrainStep:
    """A train step plus its capture counter.

    ``fn(params, carry, batch) -> (new_carry, out)`` is the eager step
    (it updates ``params`` in place); ``aot`` maps each captured geometry
    to its ``CapturedStep`` (None until the first capture); ``est_bytes``
    is the device bytes the captures retain; ``compiles`` counts the
    geometries met (see the module note).
    """

    __slots__ = ("fn", "compiles", "aot", "est_bytes", "_seen")

    def __init__(self):
        self.fn: Optional[Callable] = None
        self.compiles = 0
        self.aot: Optional[Dict[Tuple, Any]] = None
        self.est_bytes: Optional[int] = None
        self._seen: set = set()

    def note(self, batch: Any, device: torch.device) -> Tuple:
        """Count ``batch``'s geometry once (the CPU's side of ``compiles``);
        returns its key."""
        key = geometry(batch, device)
        if key not in self._seen:
            self._seen.add(key)
            self.compiles += 1
        return key

    def graph(self, params: nn.Module, carry: Any, batch: Any):
        """The ``CapturedStep`` of ``batch``'s geometry on ``params``'
        device, captured from ``fn`` on first use (``params`` and ``carry``
        give the shapes of the static state; ``batch`` may hold ``meta``
        tensors).  Raises if the capture fails."""
        from ..engine.aot import CapturedStep  # lazy: engine imports core

        device = next(params.parameters()).device
        key = geometry(batch, device)
        captured = (self.aot or {}).get(key)
        if captured is None:
            captured = CapturedStep(self.fn, params, carry, batch, train=True)
            self.aot = {**(self.aot or {}), key: captured}
            self._seen.add(key)
            self.compiles += 1
            self.est_bytes = sum(c.bytes_estimate for c in self.aot.values())
        return captured

    def __call__(self, params: nn.Module, carry: Any, batch: Any):
        """One step: on a CUDA device the geometry's graph (the caller's
        parameters and carry copied in, the graph replayed, the new state
        copied back into them; the outputs cloned off the graph's), on the
        CPU ``fn``.  ``batch`` may hold NumPy arrays."""
        from ..engine.aot import tree_map  # lazy: engine imports core

        device = next(params.parameters()).device
        batch = tree_map(torch.as_tensor, batch)
        if device.type != "cuda":
            self.note(batch, device)
            return self.fn(params, carry, batch)
        g = self.graph(params, carry, batch)
        g.load(params, carry)
        out = g.replay(batch)
        g.store(params, carry)
        return carry, tree_map(torch.clone, out)


_TRAIN_STEP_CACHE: Dict[tuple, CachedTrainStep] = {}

# entry-reuse counters behind cache_stats(): a hit means a trainer
# invocation found its step already built, a miss that a new one was built
_TRAIN_STEP_STATS: Dict[str, int] = {"hits": 0, "misses": 0}

# warn when the cache holds this many entries: each pins its graphs (and
# their memory pools) for the process' lifetime — usually a sign of a
# hyperparameter sweep varying the optimizer config per call
_TRAIN_CACHE_WARN = 16


def cached_train_step(key: tuple, build: Callable[[CachedTrainStep], Callable]) -> CachedTrainStep:
    """The cached step entry for ``key``, built once via ``build(entry)``
    (which returns the eager step).  The key must cover everything the
    step depends on (configs, trainable set, method — not the parameters,
    which are arguments)."""
    entry = _TRAIN_STEP_CACHE.get(key)
    if entry is None:
        _TRAIN_STEP_STATS["misses"] += 1
        entry = CachedTrainStep()
        entry.fn = build(entry)
        _TRAIN_STEP_CACHE[key] = entry
        if cache_stats()["entries"] == _TRAIN_CACHE_WARN:
            warnings.warn(
                f"{len(_TRAIN_STEP_CACHE)} train-step configurations cached "
                "process-wide — each pins its CUDA graphs for the process' "
                "lifetime. Sweeping lr/optimizer settings per call creates "
                "one entry each; reuse configs where possible.",
                RuntimeWarning,
                stacklevel=3,
            )
    else:
        _TRAIN_STEP_STATS["hits"] += 1
    return entry


def cache_stats() -> Dict[str, int]:
    """The process-wide train-step cache, in the reference's keys:
    entries, hit / miss counters, geometries met (``compiles``), entries
    with a capture, and the device bytes the captures retain
    (``entries_unmeasured``: entries with none)."""
    entries = _TRAIN_STEP_CACHE.values()
    return {
        "entries": len(_TRAIN_STEP_CACHE),
        "hits": _TRAIN_STEP_STATS["hits"],
        "misses": _TRAIN_STEP_STATS["misses"],
        "compiles": sum(e.compiles for e in entries),
        "aot_compiled": sum(1 for e in entries if e.aot is not None),
        "retained_bytes_est": sum(e.est_bytes for e in entries if e.est_bytes),
        "entries_unmeasured": sum(1 for e in entries if not e.est_bytes),
    }


def clear_train_step_cache() -> int:
    """Drop every cached train step (returns how many).  Counters keep
    accumulating; snapshot ``cache_stats()`` to attribute a region."""
    n = len(_TRAIN_STEP_CACHE)
    _TRAIN_STEP_CACHE.clear()
    return n


def train_step_compiles() -> int:
    """Geometries met across the cache's entries — snapshot before and
    after a training run to attribute the captures it made."""
    return sum(e.compiles for e in _TRAIN_STEP_CACHE.values())
