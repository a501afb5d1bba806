"""Public SSD scan entry point: the CUDA kernels on the card, the plain
chunked version on the CPU.

Counterpart of ``repro/kernels/ssd/ops.py::ssd_scan``.  The choice follows
the tensors' device only: a CUDA tensor always launches the hand-written
kernel (or raises), a CPU tensor takes ``ssd_chunked_ref``, which autograd
differentiates, as the reference's trainer differentiates its own.  Both
also give the final state on request, the function the reference's model
takes from ``ssd_chunked_ref(..., return_state=True)`` when it prefills.

On the card, a call that autograd records (grad mode on and an input that
requires grad) goes through ``SSDScanFn``: B5's forward, then the
hand-written backward ``csrc/ssd_bwd.cu`` for the gradients of every input.
The forward saves its inputs only; the backward recomputes the states.
Training never asks for the final state, so a recorded call with
``return_state`` raises.  Under ``no_grad`` or ``inference_mode``, as in
prefill, the call is the forward launch alone.
"""
from __future__ import annotations

import torch

from .kernel import ssd_scan_bwd_cuda, ssd_scan_cuda
from .ref import ssd_chunked_ref

__all__ = ["SSDScanFn", "ssd_scan"]


class SSDScanFn(torch.autograd.Function):
    """The SSD scan over CUDA tensors with the hand-written backward."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk: int):
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ssd_scan_cuda(xh, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        xh, dt, A, Bm, Cm = ctx.saved_tensors
        return (*ssd_scan_bwd_cuda(xh, dt, A, Bm, Cm, dy.contiguous(), chunk=ctx.chunk), None)


def ssd_scan(
    xh: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int,
    return_state: bool = False,
):
    """Chunked SSD scan: xh (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N);
    S a multiple of ``chunk``.  Returns y (B,S,H,P), and with
    ``return_state`` also the final (B,H,N,P) float32 state."""
    S, H = xh.shape[1], xh.shape[2]
    G = Bm.shape[2]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of chunk={chunk}: pad first")
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    recorded = torch.is_grad_enabled() and any(t.requires_grad for t in (xh, dt, A, Bm, Cm))
    if recorded and return_state:
        raise ValueError("ssd_scan under autograd gives y only: return_state is for prefill")
    if not xh.is_cuda:
        return ssd_chunked_ref(xh, dt, A, Bm, Cm, chunk, return_state=return_state)
    c = torch.Tensor.contiguous
    if recorded:
        return SSDScanFn.apply(c(xh), c(dt), c(A), c(Bm), c(Cm), chunk)
    return ssd_scan_cuda(c(xh), c(dt), c(A), c(Bm), c(Cm), chunk=chunk, return_state=return_state)
