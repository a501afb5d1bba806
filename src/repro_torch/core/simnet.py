"""SimNet baseline (Li et al., SIGMETRICS'22), the state of the art Tao
compares against.

Counterpart of ``repro/core/simnet.py``.  Its contrasts with Tao:
  * input: µarch-specific detailed-trace features — the model reads
    branch-mispredict flags and data-access levels, so a new µarch needs a
    new detailed trace (the regeneration cost Table 4 charges it);
  * model: a 1-D CNN (the paper's "C3 hybrid") over the instruction
    context window, numerical feature rows instead of learned embeddings;
  * output: instruction latency only.

The parameters are a ``SimNet`` module: ``convs`` (``nn.Conv1d``, weight
(cout, cin, k), the reference's (k, cin, cout) ``w`` transposed, so
``convert.params_from_jax`` carries it), ``fc1`` and ``head``.  The causal
convolution is ``F.conv1d`` over the window left-padded by k - 1, which is
the reference's ``lax.conv_general_dilated`` (a library convolution on
both sides; the reference runs no Pallas kernel here).  The train step is
eager, as the reference's plain ``jax.jit`` step is not cached.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from .. import resolve_device
from ..nn.core import dense, gelu
from ..train.optim import AdamWConfig, AdamWState, adamw_update
from .model import LAT_SCALE

__all__ = [
    "SimNet",
    "SimNetConfig",
    "init_simnet",
    "make_simnet_step",
    "simnet_features",
    "simnet_forward",
    "simnet_windows",
]


@dataclasses.dataclass(frozen=True)
class SimNetConfig:
    window: int = 129
    channels: int = 128
    n_conv: int = 3          # the C3 configuration
    kernel_size: int = 5
    feat_dim: int = 44       # opcode one-hot (15) + registers + flags + metrics, padded


def simnet_features(adj_trace: np.ndarray) -> Dict[str, np.ndarray]:
    """µarch-specific input rows: static properties plus the detailed
    trace's metrics (what makes SimNet's inputs non-reusable across
    µarchs), and the fetch / exec latency labels."""
    n = len(adj_trace)
    op = adj_trace["opcode"].astype(np.int64)
    onehot = np.zeros((n, 15), np.float32)
    onehot[np.arange(n), op] = 1.0
    regs = np.stack(
        [
            adj_trace["dst"].astype(np.float32) / 32.0,
            adj_trace["src1"].astype(np.float32) / 32.0,
            adj_trace["src2"].astype(np.float32) / 32.0,
        ],
        axis=1,
    )
    flags = np.stack(
        [
            adj_trace["is_branch"].astype(np.float32),
            adj_trace["taken"].astype(np.float32),
            adj_trace["is_mem"].astype(np.float32),
            adj_trace["is_store"].astype(np.float32),
        ],
        axis=1,
    )
    # the µarch-specific metric inputs (SimNet's defining dependence)
    dlevel = np.zeros((n, 4), np.float32)
    dlevel[np.arange(n), adj_trace["dlevel"].astype(np.int64)] = 1.0
    metrics = np.concatenate(
        [
            dlevel,
            adj_trace["mispred"].astype(np.float32)[:, None],
            adj_trace["icache_miss"].astype(np.float32)[:, None],
            adj_trace["tlb_miss"].astype(np.float32)[:, None],
        ],
        axis=1,
    )
    addr = (adj_trace["addr"].astype(np.float64) % (1 << 20)) / float(1 << 20)
    x = np.concatenate([onehot, regs, flags, metrics, addr[:, None].astype(np.float32)], axis=1)
    want = SimNetConfig().feat_dim
    if x.shape[1] < want:
        x = np.pad(x, ((0, 0), (0, want - x.shape[1])))
    labels = np.stack(
        [adj_trace["fetch_lat"].astype(np.float32), adj_trace["exec_lat"].astype(np.float32)],
        axis=1,
    )
    return {"x": x, "labels": labels}


def simnet_windows(feats: Dict[str, np.ndarray], window: int) -> Dict[str, np.ndarray]:
    """Non-overlapping windows of the rows (one truncated window when the
    trace is shorter than ``window``)."""
    n = len(feats["x"])
    starts = range(0, max(1, n - window + 1), window)
    return {
        "x": np.stack([feats["x"][s : s + window] for s in starts]),
        "labels": np.stack([feats["labels"][s : s + window] for s in starts]),
    }


class SimNet(nn.Module):
    """The C3 CNN: ``n_conv`` causal convolutions, ``fc1``, ``head``."""

    def __init__(self, cfg: SimNetConfig, g: torch.Generator):
        super().__init__()
        convs, cin = [], cfg.feat_dim
        for _ in range(cfg.n_conv):
            conv = skip_init(nn.Conv1d, cin, cfg.channels, cfg.kernel_size)
            with torch.no_grad():
                conv.weight.copy_(0.02 * torch.randn(conv.weight.shape, generator=g))
                conv.bias.zero_()
            convs.append(conv)
            cin = cfg.channels
        self.convs = nn.ModuleList(convs)
        self.fc1 = dense(cfg.channels, cfg.channels, g)
        self.head = dense(cfg.channels, 2, g)


def init_simnet(
    cfg: SimNetConfig,
    generator: Optional[torch.Generator] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> SimNet:
    """Random SimNet parameters (the reference's distributions) drawn from
    ``generator`` (seed 0 when None), moved to ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    return SimNet(cfg, g).to(dev)


def simnet_forward(params: SimNet, x: torch.Tensor, cfg: SimNetConfig) -> torch.Tensor:
    """x: (B, W, F) -> (B, W, 2) latency predictions.  Each convolution is
    causal: left-padded so that position i sees only positions <= i."""
    h = x.transpose(1, 2)  # (B, F, W), conv1d's layout
    for conv in params.convs:
        h = gelu(conv(F.pad(h, (conv.kernel_size[0] - 1, 0))))
    h = gelu(params.fc1(h.transpose(1, 2)))
    return params.head(h)


def make_simnet_step(cfg: SimNetConfig, opt_cfg: AdamWConfig):
    """``step(params, opt, batch) -> (opt, loss)``: the mean squared error
    of the latencies (the linear-space regression Tao's reference uses),
    its gradients, and AdamW, updating ``params`` in place.  ``batch``
    holds ``x`` and ``labels`` tensors (or NumPy arrays) of
    ``simnet_windows``."""

    def step(params: SimNet, opt: AdamWState, batch: Dict) -> Tuple[AdamWState, torch.Tensor]:
        device = next(params.parameters()).device
        x, labels = (torch.as_tensor(batch[k]).to(device) for k in ("x", "labels"))
        named = dict(params.named_parameters())
        loss = torch.mean(torch.square(simnet_forward(params, x, cfg) - labels / LAT_SCALE))
        grads = torch.autograd.grad(loss, list(named.values()))
        _, opt, _ = adamw_update(named, dict(zip(named, grads)), opt, opt_cfg)
        return opt, loss.detach()

    return step
