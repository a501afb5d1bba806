"""The LLM trainer, and the process-wide train-step cache: one entry per
recipe, one CUDA graph per batch geometry on the card.

Counterpart of ``repro/train/trainer.py``.  Its LLM half
(``TrainConfig``, ``TrainState``, ``init_state``, ``make_train_step``,
``batch_axes``; ``:155-263``) trains a ``models.Model``:

  * ``TrainState(step, params, opt)``: ``params`` is the module's
    ``named_parameters()`` as a name -> tensor dict, the module's own
    tensors, so that ``adamw_update`` updates the model in place and
    ``ckpt.CheckpointManager`` saves and (with ``restore_into``) restores
    the run; ``opt`` is ``train/optim.py``'s ``AdamWState`` with the first
    moment in ``opt_m_dtype`` (bfloat16 by default, as the reference's);
  * ``make_train_step(model, tcfg)`` returns ``(state, batch) -> (state,
    metrics)``: ``Model.loss`` under autograd, ``torch.autograd.grad``
    for the gradients (in the parameters' dtype), then one in-place AdamW
    at the schedule's lr, with no host read.  With ``microbatches`` > 1
    the batch is cut along its leading axis and each microbatch's
    gradients are summed into float32 buffers (the reference sums them in
    float32, ``:229-238``), then divided by their number; ``metrics`` then
    hold no loss parts, as the reference's.  The reference jits its LLM
    step directly (``launch/train.py:79``), not through the step cache, so
    this step runs eagerly; on the card attention runs B4 and its
    hand-written backward (``kernels/attention/ops.py``), and Mamba-2's
    SSD scan runs B5 and its hand-written backward
    (``kernels/ssd/ops.py``).  The model's ``cfg.remat`` (``"full"`` in
    every full config) sets what the forward keeps: under "full" and
    "dots" ``torch.autograd.grad`` recomputes each layer's forward from
    its input, B4 and B5 included, before that layer's backward (their
    ``autograd.Function``s save tensors only through
    ``save_for_backward``, which the checkpoint drops and recomputes), so
    a step launches each forward kernel twice and each backward once.
  * ``state_axes`` / ``state_shardings`` raise: the port runs on one
    device (ROADMAP A.14), as ``engine/plan.py`` refuses a mesh.

The step cache serves the Tao trainers.  The reference jits each trainer's step once
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

import dataclasses
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .optim import AdamWConfig, AdamWState, adamw_init, adamw_update, make_lr_schedule

__all__ = [
    "CachedTrainStep",
    "TrainConfig",
    "TrainState",
    "batch_axes",
    "cached_train_step",
    "cache_stats",
    "clear_train_step_cache",
    "init_state",
    "make_train_step",
    "restore_into",
    "state_axes",
    "state_shardings",
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


# ---------------------------------------------------------------------------
# The LLM trainer (reference ``trainer.py:155-263``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    microbatches: int = 1
    opt_m_dtype: str = "bfloat16"  # low-precision Adam first moment


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 device scalar
    params: Dict[str, torch.Tensor]  # the module's own parameters, by name
    opt: AdamWState


def init_state(model: nn.Module, tcfg: TrainConfig) -> TrainState:
    """The state of a run that starts from ``model``'s weights: its
    parameters by name (shared, not copied), zero moments, step 0."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        opt=adamw_init(params, m_dtype=tcfg.opt_m_dtype),
    )


@torch.no_grad()
def restore_into(state: TrainState, restored: TrainState) -> TrainState:
    """Copy a restored state (``CheckpointManager.restore_latest(state)``'s,
    whose tensors are new) into ``state``'s tensors in place, so that the
    module's parameters hold the restored weights; returns ``state``."""
    dst = [state.step, state.opt.step]
    src = [restored.step, restored.opt.step]
    for name in state.params:
        dst += [state.params[name], state.opt.mu[name], state.opt.nu[name]]
        src += [restored.params[name], restored.opt.mu[name], restored.opt.nu[name]]
    torch._foreach_copy_(dst, src)
    return state


def state_axes(model: nn.Module):
    raise NotImplementedError(
        "state_axes: the port trains on one device; sharded training states are ROADMAP A.14"
    )


def state_shardings(model: nn.Module, state, mesh):
    raise NotImplementedError(
        "state_shardings: the port trains on one device; meshes and sharded training states "
        "are ROADMAP A.14"
    )


def make_train_step(
    model: nn.Module, tcfg: TrainConfig
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """The train step of ``model`` (module note): ``(state, batch) ->
    (new_state, metrics)``, ``metrics`` device scalars ``loss``,
    ``grad_norm``, ``lr`` and, with one microbatch, the loss parts."""
    opt_cfg = AdamWConfig(
        lr=tcfg.lr, weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
        m_dtype=tcfg.opt_m_dtype,
    )
    sched = make_lr_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)

    def grads_of(params: Dict[str, torch.Tensor], batch: Dict):
        """(loss, parts, gradients in the parameters' dtype) of one batch."""
        with torch.enable_grad():
            loss, parts = model.loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        nm = tcfg.microbatches
        if nm > 1:
            # the batch cut on its leading axis; gradients summed in float32
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in state.params.values()]
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for i in range(nm):
                mb = {k: v[i * (v.shape[0] // nm):(i + 1) * (v.shape[0] // nm)]
                      for k, v in batch.items()}
                mloss, _, g = grads_of(state.params, mb)
                torch._foreach_add_(acc, [x.float() for x in g])
                loss = loss + mloss
            torch._foreach_div_(acc, float(nm))
            grads, loss, parts = acc, loss / nm, {}
        else:
            loss, parts, grads = grads_of(state.params, batch)
        lr = sched(state.step)
        params, opt, gnorm = adamw_update(state.params, dict(zip(state.params, grads)),
                                          state.opt, opt_cfg, lr=lr)
        new_state = TrainState(step=state.step + 1, params=params, opt=opt)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr, **parts}

    return train_step


def batch_axes(model: nn.Module) -> Dict:
    """Logical axes of the input batch (the reference's names, as data)."""
    cfg = model.cfg
    if cfg.family == "audio":
        return {"frames": ("batch", "seq", None), "labels": ("batch", "seq")}
    b = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family == "vlm":
        b["patches"] = ("batch", None, None)
    return b
