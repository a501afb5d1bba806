"""int8 W8A8 quantized inference for the Tao model, in PyTorch.

Counterpart of ``repro/core/quant.py``; the scheme is the reference's:

  * **weights** — symmetric per-output-channel int8, ``scale_j =
    max|w[:, j]| / 127`` (a unit scale for an all-zero channel), computed
    once per engine (``quantize_tao_params``);
  * **embedding table** — symmetric per-row int8;
  * **activations** — symmetric per-row dynamic int8, the scale ``max|x|``
    over the feature axis at run time;
  * **matmuls** — int8 x int8 accumulated in int32 (``int8_matmul``),
    dequantized by the outer product of the two scales plus the bias;
  * layernorms, softmax, gelu, attention, biases and the decode stay
    float32.

The arithmetic follows what the reference computes where it runs, bit for
bit.  Its engine quantizes the weights eagerly, so a weight scale is a
true division ``amax / 127``.  Inside the jitted step XLA rewrites the
activation scale's division into a multiply by ``float32(1 / 127)`` and
contracts the dequantization into one fused multiply-add,
``fma(acc, sx * scale, b)``: ``qdense`` does the same (``torch.addcmul``).
Where a layer has one output channel, XLA also folds the constant into
the scalar weight scale, ``amax * (scale * (1/127))``, and so does
``qdense``.
Codes round half to even on both sides and int32 sums are exact, so the
quantized tree, the codes and the accumulations are the reference's
exactly; the float32 parts around them (layernorm, GELU, softmax,
attention) differ in the last bits, which can flip an activation's code
and so spread through the causal windows (see the tests' band).

The int8 product is a library call, as the reference leaves it to XLA's
``dot_general`` outside any Pallas kernel: cuBLASLt's IMMA through
``torch._int_mm`` on the card, the same int32 product on the CPU.  IMMA
takes K and N in multiples of 8 and more than 16 rows; Tao's ``flags``
layer has K = 5 and three heads have N = 1, so each ``QDense`` keeps a
zero-padded copy of its weight (``w_mm``, a derived buffer made at
quantization and not saved) beside the canonical ``w_q``, which keeps the
reference's ``(in, out)`` shape.  Zero padding is exact.

There is one forward: a ``QuantTao`` keeps the ``Tao``'s paths, and its
``QDense`` / ``QEmbed`` layers are called as the ``nn.Linear`` /
``nn.Embedding`` they replace, so ``core.model.tao_forward`` runs either
(``tao_forward_int8`` is another name for it).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .model import Tao, tao_forward

__all__ = [
    "QUANT_VERSION",
    "QDense",
    "QEmbed",
    "QuantTao",
    "dense_layers",
    "dense_shapes",
    "int8_matmul",
    "qdense",
    "qdense_acc",
    "qdense_device_vs_cpu",
    "qembed",
    "quantize_dense",
    "quantize_embed",
    "quantize_rows",
    "quantize_tao_params",
    "tao_forward_int8",
]

# The reference versions its stored quantized trees with it; bump on any
# scheme change.
QUANT_VERSION = 1

# the activation scale's multiplier: XLA's rewrite of ``amax / 127`` inside
# the jitted step (float32(1/127) = 0.00787401572)
_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

# cuBLASLt IMMA (torch._int_mm): K and N in multiples of this, rows past
# _IMMA_MIN_ROWS
_IMMA_ALIGN = 8
_IMMA_MIN_ROWS = 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _weight_scale(amax: torch.Tensor) -> torch.Tensor:
    # all-zero channels quantize to zeros either way; a unit scale avoids
    # the 0/0 and keeps the dequant exact.  A true division, as the
    # reference engine's eager quantization computes it: by a tensor, since
    # CUDA divides by a Python scalar as a multiply by its reciprocal.
    amax = torch.where(amax > 0.0, amax, 1.0).to(torch.float32)
    return amax / torch.full_like(amax, 127.0)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


class QDense(nn.Module):
    """A quantized dense layer: ``w_q`` int8 ``(in, out)`` (the reference's
    layout), per-output-channel ``scale`` ``(out,)`` and the float32
    ``bias``; ``w_mm`` is ``w_q`` transposed to ``(out, in)`` and
    zero-padded to multiples of 8, the layout IMMA reads (derived, not in
    the state dict; refreshed whenever a state dict is loaded)."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.register_buffer("w_q", torch.zeros((in_dim, out_dim), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_dim, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(out_dim, dtype=torch.float32, device=device))
        self.register_buffer(
            "w_mm",
            torch.zeros((_round_up(out_dim, _IMMA_ALIGN), _round_up(in_dim, _IMMA_ALIGN)),
                        dtype=torch.int8, device=device),
            persistent=False,
        )

    def refresh(self) -> None:
        """Rewrite ``w_mm`` from ``w_q``."""
        k, n = self.w_q.shape
        with torch.no_grad():
            self.w_mm.zero_()
            self.w_mm[:n, :k].copy_(self.w_q.t())

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.refresh()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qdense(self, x)


class QEmbed(nn.Module):
    """A quantized embedding table: ``table_q`` int8 ``(vocab, d)`` and its
    per-row ``scale`` ``(vocab,)``."""

    def __init__(self, vocab: int, dim: int, *, device=None):
        super().__init__()
        self.register_buffer("table_q", torch.zeros((vocab, dim), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(vocab, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return qembed(self, ids)


@torch.no_grad()
def quantize_dense(layer: nn.Linear) -> QDense:
    """An ``nn.Linear`` (weight ``(out, in)``, the reference's ``w``
    transposed) -> its ``QDense``, on the layer's device."""
    w = layer.weight.detach().t()
    q = QDense(*w.shape, device=w.device)
    q.scale.copy_(_weight_scale(w.abs().amax(dim=0)))
    q.w_q.copy_(_codes(w, q.scale))
    q.bias.copy_(layer.bias)
    q.refresh()
    return q


@torch.no_grad()
def quantize_embed(table: nn.Embedding) -> QEmbed:
    """An ``nn.Embedding`` -> its per-row int8 ``QEmbed``."""
    t = table.weight.detach()
    q = QEmbed(*t.shape, device=t.device)
    q.scale.copy_(_weight_scale(t.abs().amax(dim=1)))
    q.table_q.copy_(_codes(t, q.scale[:, None]))
    return q


def _layernorm_copy(ln: nn.LayerNorm) -> nn.LayerNorm:
    return copy.deepcopy(ln).requires_grad_(False)


class _QuantEmbed(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.opcode = quantize_embed(e.opcode)
        for name in ("regbits", "flags", "brhist", "memdist", "combine"):
            setattr(self, name, quantize_dense(getattr(e, name)))


class _QuantBlock(nn.Module):
    def __init__(self, b):
        super().__init__()
        self.ln1 = _layernorm_copy(b.ln1)
        self.qkv = quantize_dense(b.qkv)
        self.proj = quantize_dense(b.proj)
        self.ln2 = _layernorm_copy(b.ln2)
        self.up = quantize_dense(b.up)
        self.down = quantize_dense(b.down)


class _QuantPred(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.register_buffer("pos", p.pos.detach().clone())
        self.blocks = nn.ModuleList(_QuantBlock(b) for b in p.blocks)
        self.ln_f = _layernorm_copy(p.ln_f)
        for name in ("head_lat", "head_branch", "head_dlevel", "head_icache", "head_tlb"):
            setattr(self, name, quantize_dense(getattr(p, name)))
        self.register_buffer("lat_reps", p.lat_reps.clone(), persistent=False)


class QuantTao(nn.Module):
    """The W8A8 inference twin of a ``Tao``: its paths follow the
    reference's quantized tree (``embed.{opcode,regbits,flags,brhist,
    memdist,combine}``, ``adapt``, ``pred.{pos,blocks.{i}.{ln1,qkv,proj,
    ln2,up,down},ln_f,head_*}``); layernorms and ``pos`` stay float32.
    ``core.model.tao_forward`` runs it as it runs a ``Tao``.  Build one with ``quantize_tao_params``; ``convert.qparams_from_jax``
    gives the state dict of the reference's tree."""

    def __init__(self, model: Tao):
        super().__init__()
        self.embed = _QuantEmbed(model.embed)
        self.adapt = quantize_dense(model.adapt)
        self.pred = _QuantPred(model.pred)


def quantize_tao_params(model: Tao) -> QuantTao:
    """fp32 ``Tao`` -> its ``QuantTao``, on the model's device."""
    return QuantTao(model)


# ---------------------------------------------------------------------------
# the quantized ops
# ---------------------------------------------------------------------------


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 -> (M, N) int32``, exact.  On the card
    cuBLASLt's IMMA (``torch._int_mm``): K and N must be multiples of 8
    (it raises otherwise; nothing falls back), and M of 16 rows or fewer
    is zero-padded past 16 here.  On the CPU the same int32 product."""
    m = a.shape[0]
    if a.is_cuda and m <= _IMMA_MIN_ROWS:
        return torch._int_mm(F.pad(a, (0, 0, 0, _IMMA_MIN_ROWS + 1 - m)), b)[:m]
    return torch._int_mm(a, b)


def quantize_rows(x: torch.Tensor):
    """Dynamic per-row activation int8 of ``(M, K)`` rows: ``(codes, sx,
    amax)``, ``amax`` the row's ``max|x|`` (1 for an all-zero row) and
    ``sx`` that times ``float32(1/127)`` (both keepdim), as in the
    reference's jitted step."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    amax = torch.where(amax > 0.0, amax, 1.0)
    sx = amax * _INV_127
    return _codes(x, sx), sx, amax


def qdense_acc(p: QDense, xq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums ``(M, N)`` of ``(M, K)`` codes with the layer's
    weight, through its zero-padded IMMA copy."""
    k_mm = p.w_mm.shape[1]
    if k_mm != xq.shape[1]:
        xq = F.pad(xq, (0, k_mm - xq.shape[1]))
    return int8_matmul(xq, p.w_mm.t())[:, : p.w_q.shape[1]]


def qdense(p: QDense, x: torch.Tensor) -> torch.Tensor:
    """Quantized twin of a dense layer: per-row int8 activations, the
    int32 product, and ``fma(acc, sx * scale, bias)`` in float32."""
    lead = x.shape[:-1]
    k, n = p.w_q.shape
    xq, sx, amax = quantize_rows(x.reshape(-1, k))
    acc = qdense_acc(p, xq)
    # with one output channel the scale is a scalar, and XLA folds the
    # constant into it: amax * (scale * (1/127)) in place of sx * scale
    deq = amax * (p.scale * _INV_127) if n == 1 else sx * p.scale
    y = torch.addcmul(p.bias, acc.to(torch.float32), deq)
    return y.reshape(lead + (n,))


def qembed(p: QEmbed, ids: torch.Tensor) -> torch.Tensor:
    return p.table_q[ids].to(torch.float32) * p.scale[ids][..., None]


# The quantized forward is the float32 one: a ``QuantTao`` has the same
# paths, and its ``QDense`` / ``QEmbed`` are called as ``nn.Linear`` /
# ``nn.Embedding`` are.
tao_forward_int8 = tao_forward


# ---------------------------------------------------------------------------
# checks shared by the card's tests and chip_smoke.py
# ---------------------------------------------------------------------------


def dense_layers(qparams: QuantTao) -> List[QDense]:
    """A ``QuantTao``'s projections, each called once per forward."""
    return [m for m in qparams.modules() if isinstance(m, QDense)]


def dense_shapes(qparams: QuantTao) -> List[Tuple[int, int]]:
    """The distinct ``(in, out)`` shapes of its projections, sorted."""
    return sorted({tuple(m.w_q.shape) for m in dense_layers(qparams)})


@torch.no_grad()
def qdense_device_vs_cpu(k: int, n: int, rows: int, device) -> Dict[str, bool]:
    """Whether a random ``(k, n)`` layer on ``rows`` rows (seeded by the
    shape) gives on ``device`` bitwise what it gives on the CPU: its
    quantized buffers, the codes, the int32 sums and the output."""
    g = torch.Generator().manual_seed(k * 1000 + n + rows)
    layer = nn.Linear(k, n)
    layer.weight.copy_(torch.randn(n, k, generator=g) / k**0.5)
    layer.bias.copy_(torch.randn(n, generator=g))
    x = torch.randn(rows, k, generator=g) * torch.rand(rows, 1, generator=g) * 30

    def parts(layer, x):
        q = quantize_dense(layer)
        xq = quantize_rows(x)[0]
        return [*q.buffers()], xq, qdense_acc(q, xq), qdense(q, x)

    cpu = parts(layer, x)
    dev = parts(copy.deepcopy(layer).to(device), x.to(device))

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))

    return {
        "weights": all(same(a, b) for a, b in zip(dev[0], cpu[0])),
        "codes": same(dev[1], cpu[1]),
        "acc": same(dev[2], cpu[2]),
        "out": same(dev[3], cpu[3]),
    }
