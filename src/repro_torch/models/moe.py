"""Mixture-of-Experts MLP: top-k routing, capacity-bounded sort-based
dispatch per token group, the experts as batched products, optional
shared experts (DeepSeek), and the load-balance and router-z auxiliary
losses, in PyTorch.

Counterpart of ``repro/models/moe.py`` (``init_moe``, ``_route``,
``_dispatch_group``, ``_combine_group``, ``moe_forward``).  What decides
which slots are kept is the reference's, exactly:

  * the tokens (T = B·S) split into G = ``DISPATCH_GROUPS`` groups when
    G divides T, else one group; the capacity is per group, C =
    max(1, int(capacity_factor · Tg · k / E));
  * the router's logits are ``x.float() @ router`` (the router stays
    float32 in a bfloat16 model); the top k of their softmax, ties to the
    lower expert (a stable descending sort, as ``lax.top_k`` breaks
    ties), the weights renormalized by max(sum, 1e-9);
  * within a group the (token, slot) pairs are sorted by expert with a
    stable sort (``jnp.argsort`` is stable), a slot's position in its
    expert is its rank there, and a slot at position >= C is dropped.

The reference ``vmap``s one group's dispatch over the groups; here the
group is a batch axis.  The dispatch buffer is laid out (E, G·C, d)
rather than the reference's (G, E, C, d), so the three expert products
(the reference's einsums over (G, E)) are ``torch.bmm`` over the experts
with no transpose; a dropped slot is written to a spare row past the
buffer's end, which the products never read.  The combine has no
atomics: every token has exactly k slots, so the expert outputs are
gathered back through the inverse of the sort's permutation into (T, k, d)
and summed over k, each slot's output first weighted in the compute dtype
(a dropped slot contributes 0).  The reference scatter-adds the slots into
a zeroed buffer in the compute dtype; the sums agree to rounding.

The stages run under ``torch.profiler.record_function`` ranges
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``) so a
profile can split a layer's device time by stage.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..nn.core import trunc_normal_param
from .config import ArchConfig, MoEConfig
from .mlp import MLP

__all__ = ["DISPATCH_GROUPS", "MoE", "capacity", "combine", "dispatch", "dispatch_meta", "route"]

DISPATCH_GROUPS = 16  # the reference's: dispatch is local per group


def capacity(m: MoEConfig, T: int) -> Tuple[int, int]:
    """(groups G, per-group capacity C) for T tokens (``moe.py:133-135``)."""
    G = DISPATCH_GROUPS if T % DISPATCH_GROUPS == 0 else 1
    return G, max(1, int(m.capacity_factor * (T // G) * m.top_k / m.num_experts))


def route(logits: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """logits (T, E) float32 -> (weights (T, k), ids (T, k), aux losses
    ``load_balance`` and ``router_z``)."""
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: largest first, ties to the lower index
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[:, : m.top_k], ids[:, : m.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    E = logits.shape[-1]
    pe = probs.mean(0)
    flat = ids.reshape(-1)
    # counts by scatter_add (exact, and no host sync, as bincount has on CUDA)
    fe = torch.zeros(E, dtype=torch.long, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float() / (ids.shape[0] * m.top_k)
    aux = {"load_balance": E * torch.sum(fe * pe),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return weights, ids, aux


def dispatch_meta(ids: torch.Tensor, E: int, C: int):
    """ids (G, Tg, k) -> the reference's per-group ``(rows, cols, keep,
    token_idx, order)``, each (G, Tg·k) in sorted order: a kept slot goes
    to row ``rows`` (its expert) and column ``cols`` (its rank there) of the
    group's (E, C) buffer; a dropped one has row E and column 0."""
    G, Tg, k = ids.shape
    flat = ids.reshape(G, Tg * k).long()
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_ids = flat.gather(1, order)
    counts = torch.zeros(G, E, dtype=torch.long, device=ids.device)
    counts.scatter_add_(1, sorted_ids, torch.ones_like(sorted_ids))
    seg_start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(Tg * k, device=ids.device) - seg_start.gather(1, sorted_ids)
    keep = pos < C
    rows = torch.where(keep, sorted_ids, E)
    cols = torch.where(keep, pos, 0)
    return rows, cols, keep, order // k, order


def _slots(rows: torch.Tensor, cols: torch.Tensor, keep: torch.Tensor, E: int, C: int):
    """Each slot's row in the (E·G·C + 1, d) buffer: expert e, group g,
    column c at (e·G + g)·C + c; a dropped slot at the spare last row."""
    G = rows.shape[0]
    g = torch.arange(G, device=rows.device)[:, None]
    return torch.where(keep, (rows * G + g) * C + cols, E * G * C)


def dispatch(x: torch.Tensor, meta, E: int, C: int) -> torch.Tensor:
    """x (G, Tg, d) -> the experts' inputs (E, G·C, d): slot (g, p) of the
    sorted order writes token ``token_idx`` at its (row, col); unfilled
    places stay 0."""
    rows, cols, keep, token_idx, _ = meta
    G, _, d = x.shape
    buf = x.new_zeros(E * G * C + 1, d)
    g = torch.arange(G, device=x.device)[:, None]
    buf[_slots(rows, cols, keep, E, C)] = x[g, token_idx]
    return buf[:-1].view(E, G * C, d)


def combine(y: torch.Tensor, meta, weights: torch.Tensor, C: int) -> torch.Tensor:
    """y (E, G·C, d) the experts' outputs, weights (G, Tg, k) -> (G, Tg, d):
    each token's k slots, read back through the inverse of the sort, times
    their weights in y's dtype, summed over k."""
    rows, cols, keep, _, order = meta
    G, Tg, k = weights.shape
    E = y.shape[0]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tg * k, device=order.device).expand(G, -1))
    at = _slots(rows, cols, keep, E, C).gather(1, inv)  # (G, Tg*k), token-major
    slot_out = y.reshape(E * G * C, -1)[at.clamp(max=E * G * C - 1)]
    slot_out = torch.where(keep.gather(1, inv)[..., None], slot_out, 0.0)
    slot_out = slot_out * weights.reshape(G, Tg * k, 1).to(y.dtype)
    return slot_out.view(G, Tg, k, -1).sum(2)


class MoE(nn.Module):
    """``router`` (d, E) float32, the experts' ``w_gate`` / ``w_up`` (E, d,
    f) and ``w_down`` (E, f, d) in the reference's layout, and ``shared``
    (a SwiGLU ``MLP``) when the config has shared experts; drawn from the
    reference's fan-in truncated normals (``moe.py:37-54``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        pd = getattr(torch, cfg.param_dtype)
        self.m = m
        self.cd = getattr(torch, cfg.compute_dtype)
        std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(m.d_ff_expert)
        E, f = m.num_experts, m.d_ff_expert
        self.router = trunc_normal_param((d, E), std_in, generator, device=device, dtype=torch.float32)
        self.w_gate = trunc_normal_param((E, d, f), std_in, generator, device=device, dtype=pd)
        self.w_up = trunc_normal_param((E, d, f), std_in, generator, device=device, dtype=pd)
        self.w_down = trunc_normal_param((E, f, d), std_out, generator, device=device, dtype=pd)
        if m.num_shared:
            self.shared = MLP(d, m.d_ff_shared or f * m.num_shared, "swiglu", generator,
                              param_dtype=pd, compute_dtype=self.cd, device=device)

    def route(self, xt: torch.Tensor):
        """Tokens (T, d) -> ``route`` of their router logits."""
        return route(xt.float() @ self.router, self.m)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """x (B, S, d) -> (out (B, S, d) in the compute dtype, aux losses)."""
        m, cd = self.m, self.cd
        B, S, d = x.shape
        T, k, E = B * S, m.top_k, m.num_experts
        xt = x.reshape(T, d)
        G, C = capacity(m, T)
        with record_function("moe.route"):
            weights, ids, aux = self.route(xt)
        with record_function("moe.dispatch"):
            meta = dispatch_meta(ids.view(G, T // G, k), E, C)
            buf = dispatch(xt.to(cd).view(G, T // G, d), meta, E, C)
        with record_function("moe.experts"):
            h = F.silu(torch.bmm(buf, self.w_gate.to(cd))) * torch.bmm(buf, self.w_up.to(cd))
            y = torch.bmm(h, self.w_down.to(cd))
        with record_function("moe.combine"):
            out = combine(y, meta, weights.view(G, T // G, k), C).reshape(T, d)
        if m.num_shared:
            out = out + self.shared(xt)
        return out.reshape(B, S, d), aux
