"""§4.3 Microarchitecture-agnostic embedding training (Algorithm 1) and the
two baselines the paper compares against (Granite-style gradient
averaging, GradNorm loss weighting).

Counterpart of ``repro/core/multiarch.py``.  The joint parameters are a
``MultiArch`` module whose state-dict names are the reference tree's
paths — ``embed.*`` (the µarch-agnostic layers), ``A.adapt.*``,
``A.pred.*``, ``B.adapt.*``, ``B.pred.*`` (each µarch's adaptation and
prediction networks) — so ``convert.params_from_jax`` / ``params_to_jax``
carry the tree both ways.

Algorithm 1 (Tao), one joint step:
  1. the forward and loss of each µarch, L_A and L_B;
  2. each µarch's gradients of its own pred / adapt, applied as they are;
  3. each µarch's gradient of the shared embedding, g_X = dL_X/d(embed),
     its own ``autograd.grad`` (through the adaptation layer: G_X W_Xᵀ of
     the paper);
  4. each g_X normalized per matrix: (g - mean) / (max - min);
  5. the shared gradient the average of the normalized ones.

The step is cached process-wide on (config, optimizer config, method) as
the reference's is, and on the card replays one CUDA graph per batch
geometry (``train.trainer``).  On the card each µarch's forward and
gradient launch the attention kernel and its backward once per layer, so
a joint step launches each 2 × ``n_layers`` times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..train.optim import AdamWConfig, AdamWState, adamw_update
from ..train.trainer import cached_train_step
from .model import (
    TaoConfig,
    TaoEmbed,
    TaoPred,
    adapt_layer,
    apply_adapt,
    apply_embed,
    apply_pred,
    multi_metric_loss,
)
from .transfer import to_device

__all__ = [
    "METHODS",
    "ArchHeads",
    "MultiArch",
    "MultiArchState",
    "eval_loss",
    "init_multiarch",
    "joint_grads",
    "make_joint_step",
]

METHODS = ("tao", "tao_no_adapt", "granite", "gradnorm")
# which methods run each µarch's adaptation layer; the no-adapt baselines
# keep the layer (the same capacity) but it gets zero gradients, so AdamW
# leaves it unchanged, as in the reference
_USE_ADAPT = {"tao": True, "tao_no_adapt": False, "granite": False, "gradnorm": False}
GRADNORM_ALPHA = 0.5   # GradNorm's asymmetry
GRADNORM_LR = 0.025    # the loss weights' step
GRADNORM_MIN_W = 0.05  # the weights' floor before they are renormalized to sum to 2


class ArchHeads(nn.Module):
    """One µarch's own layers: ``adapt`` and ``pred``."""

    def __init__(self, cfg: TaoConfig, g: torch.Generator):
        super().__init__()
        self.adapt = adapt_layer(cfg, g)
        self.pred = TaoPred(cfg, g)


class MultiArch(nn.Module):
    """The joint parameters: the shared ``embed`` and µarchs ``A`` and ``B``."""

    def __init__(self, cfg: TaoConfig, g: torch.Generator):
        super().__init__()
        self.embed = TaoEmbed(cfg, g)
        self.A = ArchHeads(cfg, g)
        self.B = ArchHeads(cfg, g)


@dataclasses.dataclass
class MultiArchState:
    params: MultiArch
    opt: AdamWState
    gradnorm_w: torch.Tensor      # (2,) learnable loss weights (GradNorm only)
    initial_losses: torch.Tensor  # (2,) L_X(0) for GradNorm's rate term


def init_multiarch(
    cfg: TaoConfig,
    generator: Optional[torch.Generator] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> MultiArch:
    """Random joint parameters drawn from ``generator`` (seed 0 when None)
    in the order embed, A, B; made on the CPU and moved to ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    return MultiArch(cfg, g).to(dev)


def _forward_loss(embed: TaoEmbed, arch: ArchHeads, batch: Dict, cfg: TaoConfig,
                  use_adapt: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = apply_embed(embed, batch, cfg)
    if use_adapt:
        h = apply_adapt(arch.adapt, h)
    preds = apply_pred(arch.pred, h, cfg)
    return multi_metric_loss(preds, batch["labels"])


def _normalize_grad(g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The paper's normalization, (x - mean) / (max - min + 1e-8), per
    gradient matrix, in float32."""

    def n(x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        return ((x32 - x32.mean()) / (x32.max() - x32.min() + 1e-8)).to(x.dtype)

    return {k: n(v) for k, v in g.items()}


def _global_norm(g: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in g.values()))


def _gradnorm(ga: Dict, gb: Dict, w: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
              initial: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """GradNorm: the embedding gradient weighted by the weights before
    their update, then the weights moved to match each task's gradient
    norm to the mean norm scaled by its relative inverse training rate,
    floored at ``GRADNORM_MIN_W`` and renormalized to sum to 2."""
    wa, wb = w[0], w[1]
    g = {k: 0.5 * (wa * ga[k] + wb * gb[k]) for k in ga}
    norm_a, norm_b = _global_norm(ga), _global_norm(gb)
    gna, gnb = wa * norm_a, wb * norm_b
    mean_gn = 0.5 * (gna + gnb)
    rate_a = la / torch.clamp(initial[0], min=1e-6)
    rate_b = lb / torch.clamp(initial[1], min=1e-6)
    mean_rate = 0.5 * (rate_a + rate_b)
    tgt_a = mean_gn * (rate_a / mean_rate) ** GRADNORM_ALPHA
    tgt_b = mean_gn * (rate_b / mean_rate) ** GRADNORM_ALPHA
    # d|gn_i - tgt_i| / dw_i with gn_i = w_i * ||g_i||
    wa = torch.clamp(wa - GRADNORM_LR * (torch.sign(gna - tgt_a) * norm_a), min=GRADNORM_MIN_W)
    wb = torch.clamp(wb - GRADNORM_LR * (torch.sign(gnb - tgt_b) * norm_b), min=GRADNORM_MIN_W)
    s = (wa + wb) / 2.0
    return g, torch.stack([wa / s, wb / s])


def make_joint_step(cfg: TaoConfig, opt_cfg: AdamWConfig, method: str = "tao"):
    """The joint training step over µarchs A and B:

        step(params, opt, gradnorm_w, initial_losses, batch_a, batch_b)
          -> (opt, gradnorm_w, metrics)

    ``params`` (a ``MultiArch``) is updated in place; ``metrics`` holds
    ``loss_a``, ``loss_b`` and the global gradient norm ``gnorm`` as device
    scalars.  Batches are NumPy or tensor dicts of ``WindowDataset``'s
    layout.  Cached process-wide on (cfg, opt_cfg, method): on the card one
    CUDA graph per batch geometry, replayed per call (the caller's
    parameters, AdamW state and ``gradnorm_w`` copied in and back); on the
    CPU the eager step.  ``step.entry`` is the cache entry (``entry.fn``
    the eager step, in the entry's ``(params, carry, inputs)`` form)."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    entry = cached_train_step(  # tao: step-key[joint-step]
        ("joint", cfg, opt_cfg, method),
        lambda entry: _build_joint_step(cfg, opt_cfg, method, entry),
    )

    def step(params: MultiArch, opt: AdamWState, gradnorm_w: torch.Tensor,
             initial_losses: torch.Tensor, batch_a: Dict, batch_b: Dict):
        carry, metrics = entry(params, {"opt": opt, "w": gradnorm_w},
                               {"initial": initial_losses, "a": batch_a, "b": batch_b})
        return carry["opt"], carry["w"], metrics

    step.entry = entry
    return step


def _arch_grads(params: MultiArch, arch: ArchHeads, batch: Dict, cfg: TaoConfig, use_adapt: bool):
    """One µarch's loss and its gradients of the embedding and of its own
    layers, each its own ``autograd.grad``; a layer the loss does not reach
    (``adapt`` without ``use_adapt``) gets zeros, as JAX gives it."""
    embed, own = dict(params.embed.named_parameters()), dict(arch.named_parameters())
    wrt = [*embed.values(), *own.values()]
    loss, _ = _forward_loss(params.embed, arch, batch, cfg, use_adapt)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(wrt, grads)]
    return loss.detach(), dict(zip(embed, grads)), dict(zip(own, grads[len(embed):]))


def joint_grads(params: MultiArch, gradnorm_w: torch.Tensor, initial_losses: torch.Tensor,
                batch_a: Dict, batch_b: Dict, cfg: TaoConfig, method: str):
    """Algorithm 1's gradients (or a baseline's) of one joint step: both
    µarchs' losses, every parameter's gradient by state-dict name (the
    embedding's combined by ``method``) and the new GradNorm weights.
    Returns ``(loss_a, loss_b, grads, gradnorm_w)``."""
    use_adapt = _USE_ADAPT[method]
    la, ga_embed, ga_own = _arch_grads(params, params.A, batch_a, cfg, use_adapt)
    lb, gb_embed, gb_own = _arch_grads(params, params.B, batch_b, cfg, use_adapt)
    w = gradnorm_w
    if method == "granite":
        g_embed = {k: 0.5 * (ga_embed[k] + gb_embed[k]) for k in ga_embed}
    elif method in ("tao", "tao_no_adapt"):
        # Algorithm 1, lines 5-6: normalize each µarch's embedding
        # gradient, average
        na, nb = _normalize_grad(ga_embed), _normalize_grad(gb_embed)
        g_embed = {k: 0.5 * (na[k] + nb[k]) for k in na}
    else:
        g_embed, w = _gradnorm(ga_embed, gb_embed, w, la, lb, initial_losses)
    grads = {**{f"embed.{k}": g for k, g in g_embed.items()},
             **{f"A.{k}": g for k, g in ga_own.items()},
             **{f"B.{k}": g for k, g in gb_own.items()}}
    return la, lb, grads, w


# tao: step-builder[joint-step] ignore=entry
def _build_joint_step(cfg: TaoConfig, opt_cfg: AdamWConfig, method: str, entry):
    def step(params: MultiArch, carry: Dict, inputs: Dict):
        la, lb, grads, w = joint_grads(params, carry["w"], inputs["initial"], inputs["a"],
                                       inputs["b"], cfg, method)
        _, opt, gnorm = adamw_update(dict(params.named_parameters()), grads, carry["opt"], opt_cfg)
        return {"opt": opt, "w": w}, {"loss_a": la, "loss_b": lb, "gnorm": gnorm}

    return step


@torch.no_grad()
def eval_loss(params: MultiArch, batches: Iterable[Dict], cfg: TaoConfig, arch: str,
              use_adapt: bool = True) -> float:
    """Average loss of one µarch head (``arch``: "A" or "B") over a list of
    batches (NumPy or tensor dicts)."""
    device = next(params.parameters()).device
    total, count = 0.0, 0
    for b in batches:
        if isinstance(b["opcode"], np.ndarray):
            b = to_device(b, device)
        loss, _ = _forward_loss(params.embed, getattr(params, arch), b, cfg, use_adapt)
        total += float(loss)
        count += 1
    return total / max(count, 1)
