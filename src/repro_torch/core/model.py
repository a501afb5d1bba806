"""§4.2 The Tao multi-metric model, in PyTorch.

Counterpart of ``repro/core/model.py``.  Two-level embedding (opcode table
plus linear layers for register bitmap, flags, branch history and access
distance, combined into per-instruction embeddings), a per-µarch
adaptation layer, and the prediction network: pre-LN causal self-attention
blocks over a window of N+1 instructions and five per-metric heads.

The parameters are a ``Tao`` module with the reference's three groups as
submodules — ``embed`` (shared, µarch-agnostic), ``adapt`` (per-µarch
adaptation) and ``pred`` (per-µarch attention network + heads) — so the
state-dict paths follow the reference's param tree (see ``convert``).
Attention goes through ``kernels/attention/ops.flash_attention``: the
hand-written CUDA kernel on the card (and, when autograd records the call,
its hand-written backward), its plain version on the CPU.
``multi_metric_loss`` is the reference's training loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from .. import resolve_device
from ..kernels.attention.ops import flash_attention
from ..nn.core import dense, embed, gelu, layernorm, softmax_cross_entropy
from ..uarch.isa import NUM_DLEVELS, NUM_REGS
from .features import NUM_OPCODES, FeatureConfig

__all__ = [
    "TaoConfig",
    "Tao",
    "init_tao",
    "apply_embed",
    "apply_adapt",
    "apply_pred",
    "tao_forward",
    "multi_metric_loss",
    "expected_latency",
    "bucketize_latency",
    "LAT_EDGES",
    "LAT_REPS",
    "LAT_SCALE",
    "LOSS_WEIGHTS",
    "NUM_LAT_BUCKETS",
]


@dataclasses.dataclass(frozen=True)
class TaoConfig:
    window: int = 129          # N+1, N = max ROB = 128 (paper §4.2)
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    d_cat: int = 64            # per-category embedding width
    features: FeatureConfig = FeatureConfig()
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# Discretized latency: geometric buckets, decoded by the representative of
# the most likely bucket (see the reference module for the design history).
LAT_EDGES = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192], np.float32
)
NUM_LAT_BUCKETS = len(LAT_EDGES)
LAT_REPS = np.concatenate(
    [LAT_EDGES[:-1] + (np.diff(LAT_EDGES) - 1) / 2.0, [256.0]]
).astype(np.float32)
LAT_SCALE = 1.0  # kept beside the reference's; expectations are in cycles

# Linear combination ratios of the multi-metric loss (all heads trained
# jointly with a linear ratio).
LOSS_WEIGHTS = {
    "fetch_lat": 1.0,
    "exec_lat": 1.0,
    "mispred": 0.5,
    "dlevel": 0.5,
    "icache_miss": 0.25,
    "tlb_miss": 0.25,
}


def bucketize_latency(x: torch.Tensor) -> torch.Tensor:
    """Map latency cycles -> bucket index."""
    edges = torch.as_tensor(LAT_EDGES, device=x.device)
    return torch.clamp(
        torch.searchsorted(edges, x, right=True) - 1, 0, NUM_LAT_BUCKETS - 1
    )


def expected_latency(logits: torch.Tensor, reps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode latency = representative of the most likely bucket (argmax,
    the first maximum winning ties)."""
    if reps is None:
        reps = torch.as_tensor(LAT_REPS, device=logits.device)
    return reps[torch.argmax(logits, dim=-1)]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class TaoEmbed(nn.Module):
    """Shared embedding layers: five category embeddings -> d_model."""

    def __init__(self, cfg: TaoConfig, g: torch.Generator):
        super().__init__()
        f = cfg.features
        self.opcode = embed(NUM_OPCODES, cfg.d_cat, g)
        self.regbits = dense(NUM_REGS, cfg.d_cat, g)
        self.flags = dense(f.flags_dim, cfg.d_cat, g)
        self.brhist = dense(f.n_queue, cfg.d_cat, g)
        self.memdist = dense(f.n_mem, cfg.d_cat, g)
        self.combine = dense(5 * cfg.d_cat, cfg.d_model, g)


class TaoBlock(nn.Module):
    """Pre-LN self-attention block."""

    def __init__(self, cfg: TaoConfig, g: torch.Generator):
        super().__init__()
        d = cfg.d_model
        out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
        self.ln1 = layernorm(d)
        self.qkv = dense(d, 3 * d, g)
        self.proj = dense(d, d, g, scale=out_scale)
        self.ln2 = layernorm(d)
        self.up = dense(d, cfg.d_ff, g)
        self.down = dense(cfg.d_ff, d, g, scale=out_scale)


class TaoPred(nn.Module):
    """Prediction network: positions, attention blocks, per-metric heads."""

    def __init__(self, cfg: TaoConfig, g: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.blocks = nn.ModuleList(TaoBlock(cfg, g) for _ in range(cfg.n_layers))
        self.pos = nn.Parameter(0.02 * torch.randn(cfg.window, d, generator=g))
        self.ln_f = layernorm(d)
        self.head_lat = dense(d, 2 * NUM_LAT_BUCKETS, g)  # fetch + exec buckets
        self.head_branch = dense(d, 1, g)
        self.head_dlevel = dense(d, NUM_DLEVELS, g)
        self.head_icache = dense(d, 1, g)
        self.head_tlb = dense(d, 1, g)
        self.register_buffer("lat_reps", torch.from_numpy(LAT_REPS.copy()), persistent=False)


class Tao(nn.Module):
    """The Tao parameters: ``embed`` / ``adapt`` / ``pred`` groups."""

    def __init__(self, cfg: TaoConfig, g: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.embed = TaoEmbed(cfg, g)
        # near-identity adaptation: starts as a gentle projection
        self.adapt = skip_init(nn.Linear, d, d)
        with torch.no_grad():
            self.adapt.weight.copy_(torch.eye(d) + 0.01 * torch.randn(d, d, generator=g))
            self.adapt.bias.zero_()
        self.pred = TaoPred(cfg, g)


def init_tao(
    cfg: TaoConfig,
    generator: Optional[torch.Generator] = None,
    *,
    device: Optional[torch.device] = None,
) -> Tao:
    """Random Tao parameters drawn from ``generator`` (seed 0 when None),
    made on the CPU and moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    return Tao(cfg, g).to(dev)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_embed(p: TaoEmbed, batch: Dict[str, torch.Tensor], cfg: TaoConfig) -> torch.Tensor:
    """batch -> (B, W, d_model) instruction embeddings (shared layers)."""
    cats = [
        p.opcode(batch["opcode"]),
        p.regbits(batch["regbits"]),
        p.flags(batch["flags"]),
        p.brhist(batch["brhist"]),
        p.memdist(batch["memdist"]),
    ]
    return gelu(p.combine(torch.cat(cats, dim=-1)))


def apply_adapt(p: nn.Linear, h: torch.Tensor) -> torch.Tensor:
    return p(h)


def _block(p: TaoBlock, h: torch.Tensor, cfg: TaoConfig, causal: bool) -> torch.Tensor:
    B, W, d = h.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    # q, k, v: (B, nh, W, hd) views of the packed projection; on the card
    # the kernel reads them at these strides and returns the (B, nh, W, hd)
    # view of a (B, W, nh, hd) output, so neither side copies
    qkv = p.qkv(p.ln1(h)).reshape(B, W, 3, nh, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    o = flash_attention(q, k, v, causal=causal)
    h = h + p.proj(o.transpose(1, 2).reshape(B, W, d))
    return h + p.down(gelu(p.up(p.ln2(h))))


def apply_pred(
    p: TaoPred, h: torch.Tensor, cfg: TaoConfig, causal: bool = True
) -> Dict[str, torch.Tensor]:
    """Prediction network over adapted embeddings -> per-position metrics."""
    h = h + p.pos[: h.shape[1]]
    for blk in p.blocks:
        h = _block(blk, h, cfg, causal)
    h = p.ln_f(h)
    lat = p.head_lat(h)
    nb = NUM_LAT_BUCKETS
    return {
        "fetch_lat_logits": lat[..., :nb],
        "exec_lat_logits": lat[..., nb:],
        "fetch_lat": expected_latency(lat[..., :nb], p.lat_reps),
        "exec_lat": expected_latency(lat[..., nb:], p.lat_reps),
        "mispred_logit": p.head_branch(h)[..., 0],
        "dlevel_logits": p.head_dlevel(h),
        "icache_logit": p.head_icache(h)[..., 0],
        "tlb_logit": p.head_tlb(h)[..., 0],
    }


def tao_forward(params: Tao, batch: Dict[str, torch.Tensor], cfg: TaoConfig) -> Dict[str, torch.Tensor]:
    """The whole model over one batch.  ``params`` may also be the int8
    ``core.quant.QuantTao``: its layers are called as the float32 ones."""
    h = apply_embed(params.embed, batch, cfg)
    h = apply_adapt(params.adapt, h)
    return apply_pred(params.pred, h, cfg)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _masked_bce(logit: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over ``mask`` of the logistic loss, in the reference's stable
    form ``max(l, 0) - l t + log1p(exp(-|l|))``."""
    per = torch.clamp(logit, min=0) - logit * target + torch.log1p(torch.exp(-logit.abs()))
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def multi_metric_loss(
    preds: Dict[str, torch.Tensor],
    labels: Dict[str, torch.Tensor],
    weights: Optional[Dict[str, float]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's combined loss (linear ratio ``LOSS_WEIGHTS``):
    cross-entropy over the latency buckets, the branch head masked to
    branches, the data-level and TLB heads to memory ops.  Returns the
    total and its parts."""
    w = weights or LOSS_WEIGHTS
    br_mask = labels["is_branch"]
    mem_mask = labels["is_mem"]
    lat_f = softmax_cross_entropy(
        preds["fetch_lat_logits"], bucketize_latency(labels["fetch_lat"])
    ).mean()
    lat_e = softmax_cross_entropy(
        preds["exec_lat_logits"], bucketize_latency(labels["exec_lat"])
    ).mean()
    bce_br = _masked_bce(preds["mispred_logit"], labels["mispred"], br_mask)
    ce_dl = (
        softmax_cross_entropy(preds["dlevel_logits"], labels["dlevel"]) * mem_mask
    ).sum() / torch.clamp(mem_mask.sum(), min=1.0)
    bce_ic = _masked_bce(preds["icache_logit"], labels["icache_miss"], torch.ones_like(br_mask))
    bce_tlb = _masked_bce(preds["tlb_logit"], labels["tlb_miss"], mem_mask)
    parts = {
        "fetch_lat": lat_f,
        "exec_lat": lat_e,
        "mispred": bce_br,
        "dlevel": ce_dl,
        "icache_miss": bce_ic,
        "tlb_miss": bce_tlb,
    }
    total = sum(w[k] * v for k, v in parts.items())
    return total, parts
