"""§4.3/§5.5 Training a single-µarch Tao model, and transfer to an unseen
microarchitecture.

Counterpart of ``repro/core/transfer.py``.  Three regimes (paper Table 5):

  * scratch              — the whole model trained from random init
  * direct fine-tuning   — every parameter initialized from a donor model
  * shared + fine-tune   — Tao's scheme: the µarch-agnostic embeddings
                           FROZEN, adaptation + prediction layers fine-tuned
                           on a small dataset

The step is forward, ``multi_metric_loss``, the gradients through autograd
(on the card the attention's gradient is the hand-written B4 backward,
``kernels/attention/ops.FlashAttentionFn``), then the hand-written
``train.optim.adamw_update``.  It is cached process-wide as the
reference's is (``train.trainer.cached_train_step``, keyed on the config,
the optimizer config and the trainable set).  On the CPU the entry runs
the step eagerly; on the card ``train_tao_impl`` replays the entry's CUDA
graph of the batch geometry, captured at the first run of a geometry or
ahead of any data by ``warmup_train_step``: the run's parameters and
AdamW state are copied into the graph's static buffers once, each batch's
arrays into its static inputs, and the state is copied back before each
``eval_fn``, before each checkpoint and at the end.  Batches are drawn on
the host from a NumPy generator seeded as the reference's, so both sides
see the same windows in the same order; each step's loss stays a device
scalar until the epoch ends, when the host sums them in step order as
Python floats, as the reference does.

With ``prefetch`` (the default, as in the reference) each epoch's batches
go through ``engine.runner.prefetch_to_device``, one batch ahead: on the
card each is packed into pinned memory and copied to the device without
blocking, so the replay's input copies run on the device and the host no
longer waits for the previous step inside pageable copies.  The
reference's producer thread measured slower here (chip_smoke.py, phase
train), so the batches are drawn inline.  The graph of the run's geometry
is captured before the first batch is drawn, so a producer thread, where
one runs, never meets a capture (which forbids CUDA calls on every
thread).  The losses, parameters and AdamW state are bitwise those of a
run without it.  ``plan`` (an ``engine.ExecutionPlan``; on the port only
the single-device plan) keys the step cache as the reference's does; None
and the single plan are one key.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..train.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from ..engine.aot import tree_map
from ..engine.plan import ExecutionPlan
from ..train.trainer import CachedTrainStep, cached_train_step, geometry
from ..uarch.isa import NUM_REGS
from .dataset import INPUT_KEYS, StreamingWindowDataset, WindowDataset
from .model import Tao, TaoConfig, TaoEmbed, init_tao, multi_metric_loss, tao_forward

__all__ = ["TrainData", "TrainResult", "train_tao", "train_tao_impl", "transfer_finetune",
           "warmup_train_step"]

Params = Union[Tao, Mapping[str, torch.Tensor]]
# both dataset flavors draw bit-identical batch streams for the same rng;
# everything below is agnostic to which one it is handed
TrainData = Union[WindowDataset, StreamingWindowDataset]
# the parameter groups the "headonly" step trains; "embed" stays frozen
HEAD_GROUPS = ("adapt", "pred")


@dataclasses.dataclass
class TrainResult:
    params: Tao
    losses: List[float]
    eval_losses: List[float]
    seconds: float
    steps: int


def to_device(batch: Dict, device: torch.device) -> Dict:
    """A batch of ``WindowDataset.batches`` (NumPy arrays, or tensors from
    ``prefetch_to_device``) as tensors on ``device``."""
    out = {k: torch.as_tensor(batch[k]).to(device) for k in INPUT_KEYS}
    if "labels" in batch:
        out["labels"] = {k: torch.as_tensor(v).to(device) for k, v in batch["labels"].items()}
    return out


def trainable_params(model: Tao, trainable: str) -> Dict[str, torch.Tensor]:
    """The parameters a step of ``trainable`` ("all" or "headonly")
    updates, by state-dict name."""
    if trainable not in ("all", "headonly"):
        raise ValueError(f"trainable must be 'all' or 'headonly', got {trainable!r}")
    return {k: p for k, p in model.named_parameters()
            if trainable == "all" or k.split(".")[0] in HEAD_GROUPS}


# tao: step-builder[train-step]
def _make_step(cfg: TaoConfig, opt_cfg: AdamWConfig, trainable: str,
               plan: Optional[ExecutionPlan] = None) -> CachedTrainStep:
    """The cached train step of ``trainable`` ("all" or "headonly": freeze
    the shared embeddings).  Its eager step ``step(model, opt, batch) ->
    (opt, loss)`` updates the model's trainable parameters in place (under
    "headonly" the caller has the embeddings not require grad, so autograd
    computes nothing for them); calling the entry runs it on the CPU and
    replays its graph on the card (``train.trainer``).  ``plan`` only keys
    the cache, as in the reference."""
    # the single-device plan keys as None: both spellings share one entry
    plan = None if plan is None or not plan.sharded else plan

    def build(entry):
        def step(model: Tao, opt: AdamWState, batch: Dict) -> Tuple[AdamWState, torch.Tensor]:
            params = trainable_params(model, trainable)
            preds = tao_forward(model, batch, cfg)
            loss, _ = multi_metric_loss(preds, batch["labels"])
            grads = torch.autograd.grad(loss, list(params.values()))
            _, opt, _ = adamw_update(params, dict(zip(params, grads)), opt, opt_cfg)
            return opt, loss.detach()

        return step

    return cached_train_step(  # tao: step-key[train-step]
        ("tao", cfg, opt_cfg, trainable, plan), build
    )


def batch_like(cfg: TaoConfig, batch_size: int, window: int) -> Dict:
    """``meta`` tensors of the shapes and dtypes every training batch of
    this geometry has: ``INPUT_KEYS`` plus the labels of
    ``features._labels``."""

    def t(*shape, dtype=torch.float32):
        return torch.empty((batch_size, window, *shape), dtype=dtype, device="meta")

    f = cfg.features
    labels = {k: t() for k in ("fetch_lat", "exec_lat", "mispred", "icache_miss", "tlb_miss",
                                "is_branch", "is_mem")}
    labels["dlevel"] = t(dtype=torch.int32)
    return {"opcode": t(dtype=torch.int32), "regbits": t(NUM_REGS), "flags": t(f.flags_dim),
            "brhist": t(f.n_queue), "memdist": t(f.n_mem), "labels": labels}


def warmup_train_step(
    cfg: TaoConfig,
    *,
    batch_size: int = 16,
    lr: float = 3e-4,
    freeze_embed: bool = False,
    plan: Optional[ExecutionPlan] = None,
    window: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> CachedTrainStep:
    """Capture the cached train step of a training recipe ahead of any
    data, so its first batch replays a ready graph: the parameters and
    optimizer state of the recipe's shapes come from ``init_tao`` on
    ``device`` (default ``cuda``; their values are never used, a run copies
    its own in), the batch is ``meta`` tensors of the geometry
    (``window`` defaults to ``cfg.window``: pass the effective window of
    traces shorter than it).  Sets the entry's ``aot`` and ``est_bytes``.
    On the CPU the entry is built and nothing is captured.  ``plan`` keys
    the entry as ``train_tao_impl``'s does.  Idempotent per (recipe,
    geometry); raises if the capture fails."""
    dev = resolve_device(device)
    plan = ExecutionPlan.resolve(batch_size=batch_size, plan=plan)
    trainable = "headonly" if freeze_embed else "all"
    entry = _make_step(cfg, AdamWConfig(lr=lr), trainable, plan)
    if dev.type == "cuda":
        model, opt = _new_state(cfg, None, freeze_embed, 0, dev)
        entry.graph(model, opt, batch_like(cfg, batch_size, window or cfg.window))
    return entry


def _new_state(cfg: TaoConfig, init_params: Optional[Params], freeze_embed: bool, seed: int,
               dev: torch.device) -> Tuple[Tao, AdamWState]:
    """A run's model (from ``init_params``, else ``init_tao`` seeded by
    ``seed``) and its zero AdamW state over the trainable parameters."""
    model = init_tao(cfg, torch.Generator().manual_seed(seed), device=dev)
    if init_params is not None:
        model.load_state_dict(_state_dict(init_params))
    # frozen embeddings get no gradient and no optimizer state
    model.embed.requires_grad_(not freeze_embed)
    trainable = "headonly" if freeze_embed else "all"
    return model, adamw_init(trainable_params(model, trainable))


class _EagerRun:
    """Drives the entry's eager step over one run's state (the CPU's path,
    and the card's eager reference): ``step`` per batch, ``state`` the
    run's model and optimizer state as they stand."""

    def __init__(self, entry: CachedTrainStep, model: Tao, opt: AdamWState):
        self.entry, self.model, self.opt = entry, model, opt
        self.device = next(model.parameters()).device

    def step(self, batch: Dict) -> torch.Tensor:
        self.entry.note(batch, self.device)
        self.opt, loss = self.entry.fn(self.model, self.opt, to_device(batch, self.device))
        return loss

    def state(self) -> Tuple[Tao, AdamWState]:
        return self.model, self.opt


class _GraphRun:
    """Drives the entry's graph of the run's geometry: the run's state
    copied in once, each batch (NumPy arrays, or device tensors from
    ``prefetch_to_device``) into the static inputs, and each step's loss
    copied out on the device (the next replay overwrites it).  With
    ``like`` (a batch of the geometry; ``meta`` tensors will do) the graph
    is taken, or captured, here; else at the first batch."""

    def __init__(self, entry: CachedTrainStep, model: Tao, opt: AdamWState,
                 like: Optional[Dict] = None):
        self.entry, self.model, self.opt, self.graph = entry, model, opt, None
        self.device = next(model.parameters()).device
        self._unchecked = like is not None  # the first batch's geometry
        if like is not None:
            self._load(like)

    def _load(self, batch: Dict) -> None:
        self._geometry = geometry(batch, self.device)
        self.graph = self.entry.graph(self.model, self.opt, batch)
        self.graph.load(self.model, self.opt)

    def step(self, batch: Dict) -> torch.Tensor:
        batch = tree_map(torch.as_tensor, batch)  # host tensors over the arrays
        if self.graph is None:
            self._load(batch)
        elif self._unchecked:
            # a graph taken from ``like``: the data must have its geometry
            # (a copy into the static inputs would cast another dtype)
            if geometry(batch, self.device) != self._geometry:
                raise ValueError(f"batch geometry {geometry(batch, self.device)} is not the "
                                 f"graph's {self._geometry}")
            self._unchecked = False
        return self.graph.replay(batch).clone()

    def state(self) -> Tuple[Tao, AdamWState]:
        if self.graph is not None:
            self.graph.store(self.model, self.opt)
        return self.model, self.opt


# tao: hot
def _run_epochs(
    run,
    dataset: TrainData,
    epochs: int,
    batch_size: int,
    eval_fn: Optional[Callable] = None,
    seed: int = 0,
    target_loss: Optional[float] = None,
    start_epoch: int = 0,
    rng_state: Optional[Dict] = None,
    losses: Optional[List[float]] = None,
    evals: Optional[List[float]] = None,
    steps: int = 0,
    checkpoint_cb: Optional[Callable] = None,
    prefetch: bool = False,
) -> Tuple[List[float], List[float], int]:
    # lazy: engine.runner imports core.dataset, whose package imports this
    # module
    from ..engine.runner import prefetch_to_device

    rng = np.random.default_rng(seed)
    if rng_state is not None:
        # crash-resume: fast-forward the shuffle stream to where the
        # checkpointed epoch left it, so the remaining epochs draw exactly
        # the batches an uninterrupted run would have drawn
        rng.bit_generator.state = rng_state
    losses = list(losses) if losses else []
    evals = list(evals) if evals else []
    for ep in range(start_epoch, epochs):
        ep_losses: List[torch.Tensor] = []
        batches = dataset.batches(batch_size, rng=rng)
        if prefetch:
            # the same arrays, drawn and placed a batch ahead of the step
            # (inline: see the module note); the epoch's generator runs to
            # its end before the epoch closes, so the rng state a checkpoint
            # reads is the same as without
            batches = prefetch_to_device(batches, device=run.device, threaded=False)
        for batch in batches:
            # a device scalar: reading it here would wait for the step
            ep_losses.append(run.step(batch))
            steps += 1
        # one read per epoch, summed on the host in step order
        ep_loss = 0.0
        for x in torch.stack(ep_losses).cpu().tolist() if ep_losses else ():  # tao: noqa[TAO002] the epoch's one read of its step losses, after its last step
            ep_loss += x
        ep_loss /= max(len(ep_losses), 1)
        losses.append(ep_loss)
        if eval_fn is not None:
            evals.append(float(eval_fn(run.state()[0])))  # tao: noqa[TAO002] one eval read per epoch, as the reference's
        if checkpoint_cb is not None:
            # rng state captured AFTER this epoch's batches were drawn —
            # exactly what the next epoch of a resumed run must start from
            checkpoint_cb(ep, *run.state(), losses, evals, steps, rng.bit_generator.state)
        if target_loss is not None and ep_loss <= target_loss:
            break
    return losses, evals, steps


def _state_dict(params: Params) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, torch.nn.Module) else params


def _host_tree(tree):
    """A nested dict of tensors as host copies (the step updates the
    originals in place)."""
    if isinstance(tree, Mapping):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _load_state(model: Tao, opt: AdamWState, params: Mapping, opt_tree: Mapping) -> AdamWState:
    """A manifest's host trees loaded back: the state dict into ``model``
    (in place, on its device), the optimizer state as a new ``AdamWState``
    on the device and in the dtypes of ``opt``'s tensors."""

    def like(arr, ref: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype)

    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return AdamWState(
        step=like(opt_tree["step"], opt.step),
        mu={k: like(opt_tree["mu"][k], v) for k, v in opt.mu.items()},
        nu={k: like(opt_tree["nu"][k], v) for k, v in opt.nu.items()},
    )


def train_tao_impl(
    cfg: TaoConfig,
    dataset: TrainData,
    *,
    epochs: int = 10,
    batch_size: int = 16,
    lr: float = 3e-4,
    init_params: Optional[Params] = None,
    freeze_embed: bool = False,
    eval_fn: Optional[Callable] = None,
    seed: int = 0,
    target_loss: Optional[float] = None,
    store=None,
    resume_key: Optional[str] = None,
    manifest_every: int = 1,
    prefetch: bool = True,
    plan: Optional[ExecutionPlan] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> TrainResult:
    """Train (or fine-tune) a single-µarch Tao model on ``device``
    (default ``cuda``; raises without it unless ``device="cpu"``).

    scratch            -> init_params=None,  freeze_embed=False
    direct fine-tune   -> init_params=donor, freeze_embed=False
    shared + fine-tune -> init_params=donor with the shared embed, freeze_embed=True

    ``dataset`` is a ``WindowDataset`` or a ``StreamingWindowDataset``;
    both give bit-identical runs for the same seed and keep-set.
    ``init_params`` is a ``Tao`` module or its state dict, copied into a
    new module (the caller's is left alone); when None the params come from
    ``init_tao`` with a ``torch.Generator`` seeded by ``seed``.  ``seed``
    also seeds the NumPy generator that shuffles the batches, as in the
    reference.  Stops early once an epoch's mean loss is at or below
    ``target_loss``.  On the card every batch replays the recipe's CUDA
    graph (module note); the run is bitwise the eager step's.

    With ``store`` (an ``ArtifactStore``) and ``resume_key`` (the run's
    recipe identity), every ``manifest_every``-th epoch and the last one
    publish a crash-resume manifest (``resilience.manifest``): the model's
    state dict, the AdamW state, the loss history and the shuffle rng's
    state, as host copies.  A re-run after a SIGKILL loads the latest one
    back into the model and the optimizer on ``device`` and goes on from
    the next epoch: its losses, step count, parameters and optimizer state
    are bitwise those of an uninterrupted run on the same device.  A
    recipe that has finished replays its last manifest and runs no step.

    ``prefetch`` sends each epoch's batches through
    ``prefetch_to_device`` (module note); ``plan`` keys the step cache
    (module note; validated against ``batch_size``).
    """
    if manifest_every < 1:
        raise ValueError(f"manifest_every must be >= 1, got {manifest_every}")
    dev = resolve_device(device)
    plan = ExecutionPlan.resolve(batch_size=batch_size, plan=plan)
    model, opt = _new_state(cfg, init_params, freeze_embed, seed, dev)
    trainable = "headonly" if freeze_embed else "all"
    entry = _make_step(cfg, AdamWConfig(lr=lr), trainable, plan)

    start_epoch, rng_state, steps0 = 0, None, 0
    losses0: List[float] = []
    evals0: List[float] = []
    checkpoint_cb = None
    if store is not None and resume_key is not None:
        # lazy: resilience.manifest pulls in the store package
        from ..resilience.manifest import load_train_epoch, publish_train_epoch

        state = load_train_epoch(store, resume_key, epochs)
        if state is not None and state.get("rng_state") is not None:
            opt = _load_state(model, opt, state["params"], state["opt"])
            start_epoch = state["epoch"] + 1
            rng_state = state["rng_state"]
            losses0 = state["losses"]
            evals0 = state["eval_losses"]
            steps0 = state["steps"]

        def checkpoint_cb(ep, m, o, ls, ev, st, rs):
            if (ep + 1) % manifest_every and ep != epochs - 1:
                return
            publish_train_epoch(store, resume_key, ep, _host_tree(m.state_dict()),
                                _host_tree(o._asdict()), ls, ev, st, rs)

    t0 = time.perf_counter()
    if dev.type == "cuda":
        # the run's graph taken (or captured) before any batch is drawn
        run = _GraphRun(entry, model, opt, like=batch_like(cfg, batch_size, dataset.window))
    else:
        run = _EagerRun(entry, model, opt)
    losses, evals, steps = _run_epochs(
        run, dataset, epochs, batch_size, eval_fn, seed, target_loss,
        start_epoch=start_epoch, rng_state=rng_state, losses=losses0, evals=evals0,
        steps=steps0, checkpoint_cb=checkpoint_cb, prefetch=prefetch,
    )
    model, _ = run.state()
    return TrainResult(params=model, losses=losses, eval_losses=evals,
                       seconds=time.perf_counter() - t0, steps=steps)


def train_tao(cfg: TaoConfig, dataset: TrainData, **kw) -> TrainResult:
    """Deprecated alias for :func:`train_tao_impl` — use the
    ``repro_torch.api`` facade instead (``Session.train`` /
    ``TrainedModel.transfer``)."""
    warnings.warn(
        "repro_torch.core.train_tao is deprecated; use "
        "repro_torch.api.Session.train(...) (or TrainedModel.transfer for "
        "fine-tuning)",
        DeprecationWarning,
        stacklevel=2,
    )
    return train_tao_impl(cfg, dataset, **kw)


def transfer_finetune(
    cfg: TaoConfig,
    shared_embed: Union[TaoEmbed, Mapping[str, torch.Tensor]],
    donor_arch_params: Params,
    small_dataset: TrainData,
    *,
    prefetch: bool = True,
    plan: Optional[ExecutionPlan] = None,
    **kw,
) -> TrainResult:
    """Tao's fast path: the shared embeddings (a ``TaoEmbed`` or its state
    dict) frozen, the adapt and pred groups initialized from the donor (a
    ``Tao`` or its state dict) and fine-tuned on a reduced dataset.
    ``prefetch``, ``plan`` and the other keyword arguments go to
    ``train_tao_impl``."""
    init = {f"embed.{k}": v for k, v in _state_dict(shared_embed).items()}
    init.update({k: v for k, v in _state_dict(donor_arch_params).items()
                 if k.split(".")[0] in HEAD_GROUPS})
    return train_tao_impl(cfg, small_dataset, init_params=init, freeze_embed=True,
                          prefetch=prefetch, plan=plan, **kw)
