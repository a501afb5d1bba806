"""§4.3/§5.5 Training a single-µarch Tao model, and transfer to an unseen
microarchitecture.

Counterpart of ``repro/core/transfer.py``.  Three regimes (paper Table 5):

  * scratch              — the whole model trained from random init
  * direct fine-tuning   — every parameter initialized from a donor model
  * shared + fine-tune   — Tao's scheme: the µarch-agnostic embeddings
                           FROZEN, adaptation + prediction layers fine-tuned
                           on a small dataset

The step is eager: forward, ``multi_metric_loss``, ``backward`` through
autograd (on the card the attention's gradient is the hand-written B4
backward, ``kernels/attention/ops.FlashAttentionFn``), then the
hand-written ``train.optim.adamw_update``.  Batches are drawn on the host
from a NumPy generator seeded as the reference's, so both sides see the
same windows in the same order; each step's loss stays a device scalar
until the epoch ends, when the host sums them in step order as Python
floats, as the reference does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..train.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from .dataset import INPUT_KEYS, WindowDataset
from .model import Tao, TaoConfig, TaoEmbed, init_tao, multi_metric_loss, tao_forward

__all__ = ["TrainResult", "train_tao_impl", "transfer_finetune"]

Params = Union[Tao, Mapping[str, torch.Tensor]]
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
    """A NumPy batch of ``WindowDataset.batches`` as tensors on ``device``."""
    out = {k: torch.from_numpy(batch[k]).to(device) for k in INPUT_KEYS}
    if "labels" in batch:
        out["labels"] = {k: torch.from_numpy(v).to(device) for k, v in batch["labels"].items()}
    return out


def trainable_params(model: Tao, trainable: str) -> Dict[str, torch.Tensor]:
    """The parameters a step of ``trainable`` ("all" or "headonly")
    updates, by state-dict name."""
    if trainable not in ("all", "headonly"):
        raise ValueError(f"trainable must be 'all' or 'headonly', got {trainable!r}")
    return {k: p for k, p in model.named_parameters()
            if trainable == "all" or k.split(".")[0] in HEAD_GROUPS}


def _make_step(cfg: TaoConfig, opt_cfg: AdamWConfig, trainable: str):
    """The train step of ``trainable`` ("all" or "headonly": freeze the
    shared embeddings).  ``step(model, opt, batch) -> (opt, loss)`` updates
    the model's trainable parameters in place (under "headonly" the
    caller has the embeddings not require grad, so autograd computes
    nothing for them)."""

    def step(model: Tao, opt: AdamWState, batch: Dict) -> Tuple[AdamWState, torch.Tensor]:
        params = trainable_params(model, trainable)
        preds = tao_forward(model, batch, cfg)
        loss, _ = multi_metric_loss(preds, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt, _ = adamw_update(params, dict(zip(params, grads)), opt, opt_cfg)
        return opt, loss.detach()

    return step


def _run_epochs(
    model: Tao,
    step: Callable,
    dataset: WindowDataset,
    epochs: int,
    batch_size: int,
    opt: AdamWState,
    device: torch.device,
    eval_fn: Optional[Callable] = None,
    seed: int = 0,
    target_loss: Optional[float] = None,
) -> Tuple[List[float], List[float], int]:
    rng = np.random.default_rng(seed)
    losses: List[float] = []
    evals: List[float] = []
    steps = 0
    for _ in range(epochs):
        ep_losses: List[torch.Tensor] = []
        for batch in dataset.batches(batch_size, rng=rng):
            opt, loss = step(model, opt, to_device(batch, device))
            # a device scalar: reading it here would wait for the step
            ep_losses.append(loss)
            steps += 1
        # one read per epoch, summed on the host in step order
        ep_loss = 0.0
        for x in torch.stack(ep_losses).cpu().tolist() if ep_losses else ():
            ep_loss += x
        ep_loss /= max(len(ep_losses), 1)
        losses.append(ep_loss)
        if eval_fn is not None:
            evals.append(float(eval_fn(model)))
        if target_loss is not None and ep_loss <= target_loss:
            break
    return losses, evals, steps


def _state_dict(params: Params) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, torch.nn.Module) else params


def train_tao_impl(
    cfg: TaoConfig,
    dataset: WindowDataset,
    *,
    epochs: int = 10,
    batch_size: int = 16,
    lr: float = 3e-4,
    init_params: Optional[Params] = None,
    freeze_embed: bool = False,
    eval_fn: Optional[Callable] = None,
    seed: int = 0,
    target_loss: Optional[float] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> TrainResult:
    """Train (or fine-tune) a single-µarch Tao model on ``device``
    (default ``cuda``; raises without it unless ``device="cpu"``).

    scratch            -> init_params=None,  freeze_embed=False
    direct fine-tune   -> init_params=donor, freeze_embed=False
    shared + fine-tune -> init_params=donor with the shared embed, freeze_embed=True

    ``init_params`` is a ``Tao`` module or its state dict, copied into a
    new module (the caller's is left alone); when None the params come from
    ``init_tao`` with a ``torch.Generator`` seeded by ``seed``.  ``seed``
    also seeds the NumPy generator that shuffles the batches, as in the
    reference.  Stops early once an epoch's mean loss is at or below
    ``target_loss``.
    """
    dev = resolve_device(device)
    model = init_tao(cfg, torch.Generator().manual_seed(seed), device=dev)
    if init_params is not None:
        model.load_state_dict(_state_dict(init_params))
    trainable = "headonly" if freeze_embed else "all"
    # frozen embeddings get no gradient and no optimizer state
    model.embed.requires_grad_(not freeze_embed)
    opt_cfg = AdamWConfig(lr=lr)
    step = _make_step(cfg, opt_cfg, trainable)
    opt = adamw_init(trainable_params(model, trainable), opt_cfg.m_dtype)
    t0 = time.perf_counter()
    losses, evals, steps = _run_epochs(
        model, step, dataset, epochs, batch_size, opt, dev, eval_fn, seed, target_loss
    )
    return TrainResult(params=model, losses=losses, eval_losses=evals,
                       seconds=time.perf_counter() - t0, steps=steps)


def transfer_finetune(
    cfg: TaoConfig,
    shared_embed: Union[TaoEmbed, Mapping[str, torch.Tensor]],
    donor_arch_params: Params,
    small_dataset: WindowDataset,
    **kw,
) -> TrainResult:
    """Tao's fast path: the shared embeddings (a ``TaoEmbed`` or its state
    dict) frozen, the adapt and pred groups initialized from the donor (a
    ``Tao`` or its state dict) and fine-tuned on a reduced dataset.
    Keyword arguments go to ``train_tao_impl``."""
    init = {f"embed.{k}": v for k, v in _state_dict(shared_embed).items()}
    init.update({k: v for k, v in _state_dict(donor_arch_params).items()
                 if k.split(".")[0] in HEAD_GROUPS})
    return train_tao_impl(cfg, small_dataset, init_params=init, freeze_embed=True, **kw)
