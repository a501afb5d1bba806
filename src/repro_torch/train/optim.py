"""AdamW with decoupled weight decay, global-norm clipping and a
linear-warmup cosine-decay schedule, written out by hand.

Counterpart of ``repro/train/optim.py``.  ``torch.optim.AdamW`` places eps
after dividing ``sqrt(v)`` by ``sqrt(bc2)`` and decays ``p`` before the
step; the reference adds eps to ``sqrt(vhat)`` and ``wd * p`` to the step
itself, so the update is spelled out here in its order, in float32 math:

    m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p;  p = p - lr delta

with ``bc = 1 - b ** step`` taken in float32 from the step counter, a
device scalar, so the update never reads the device back.  Each line is
rounded as the reference's compiled update rounds it: XLA fuses the last
multiply and add of the moment, decay and parameter lines into one
fused multiply-add (``addcmul`` here) and divides m by the product
``bc1 (sqrt(v / bc2) + eps)``; the moments then come out bitwise the
reference's.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name (the trainable subset of a module's ``named_parameters``).  The
update runs over them laid end to end in one float32 vector each, so a
step launches a few dozen kernels on the card, not a few per tensor, and
the global norm is one reduction.  Unlike the reference's pure functions,
``adamw_update`` writes the new parameters and moments back in place, so
the caller's tensors (a module's parameters) are the updated ones; it runs
after ``backward``, outside autograd.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "make_lr_schedule",
]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    # storage type of the first moment (its math is float32); the second
    # moment stays float32 (wide dynamic range)
    m_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 device scalar: updates taken
    mu: Tensors
    nu: Tensors


def adamw_init(params: Tensors, m_dtype: str = "float32") -> AdamWState:
    """Zero moments for every tensor of ``params``, on its device."""
    mdt = getattr(torch, m_dtype)
    device = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu={k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()},
    )


def _flat(tensors: Tensors, keys) -> torch.Tensor:
    """The tensors of ``keys``, in that order, as one float32 vector."""
    return torch.cat([tensors[k].reshape(-1).float() for k in keys])


def _norm(flat: torch.Tensor) -> torch.Tensor:
    """The global norm: one float32 reduction over the tensors laid end to
    end."""
    return torch.sqrt(torch.sum(torch.square(flat)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: ``float / tensor`` is a reciprocal times the float
    return torch.clamp(gnorm.new_full((), max_norm) / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``;
    returns the scaled gradients and the norm before scaling."""
    gnorm = _norm(_flat(grads, list(grads)))
    scale = _clip_scale(gnorm, max_norm)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(
    params: Tensors,
    grads: Tensors,
    state: AdamWState,
    cfg: AdamWConfig,
    lr: Optional[Union[float, torch.Tensor]] = None,
) -> Tuple[Tensors, AdamWState, torch.Tensor]:
    """One AdamW step over ``params`` (updated in place, as are the
    moments).  Returns ``(params, new_state, grad_norm)``; the norm is the
    gradients' before clipping."""
    keys = list(params)
    g = _flat(grads, keys)
    gnorm = _norm(g)
    if cfg.clip_norm is not None:
        g = g * _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)
    lr_t = torch.as_tensor(cfg.lr if lr is None else lr, dtype=torch.float32)

    p, m, v = _flat(params, keys), _flat(state.mu, keys), _flat(state.nu, keys)
    # the reference's compiled update contracts each line's last multiply
    # and add into one fused multiply-add, which addcmul is
    m = torch.addcmul(g * (1 - cfg.b1), m, torch.tensor(cfg.b1))
    v = torch.addcmul(g * (1 - cfg.b2) * g, v, torch.tensor(cfg.b2))
    # (m / bc1) / (sqrt(v / bc2) + eps), as the reference's compiler
    # rewrites it: one division by the product
    delta = m / (bc1 * (torch.sqrt(v / bc2) + cfg.eps))
    if cfg.weight_decay:
        delta = torch.addcmul(delta, p, torch.tensor(cfg.weight_decay))
    p = torch.addcmul(p, delta, -lr_t)
    sizes = [params[k].numel() for k in keys]
    for tensors, new in ((params, p), (state.mu, m), (state.nu, v)):
        dst = [tensors[k] for k in keys]
        torch._foreach_copy_(dst, [s.view_as(d) for s, d in zip(new.split(sizes), dst)])
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm


def make_lr_schedule(
    base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``: a float32 tensor
    of the step tensor given."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp(step / max(1.0, warmup_steps), max=1.0)
        frac = torch.clamp((step - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return sched
