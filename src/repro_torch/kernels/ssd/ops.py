"""Public SSD scan entry point: the CUDA kernel on the card, the plain
chunked version on the CPU.

Counterpart of ``repro/kernels/ssd/ops.py::ssd_scan``.  The choice follows
the tensors' device only: a CUDA tensor always launches the hand-written
kernel (or raises), a CPU tensor takes ``ssd_chunked_ref``.  Both also give
the final state on request, the function the reference's model takes from
``ssd_chunked_ref(..., return_state=True)`` when it prefills.
"""
from __future__ import annotations

import torch

from .kernel import ssd_scan_cuda
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan"]


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
    ``return_state`` also the final (B,H,N,P) float32 state.  Forward only."""
    S, H = xh.shape[1], xh.shape[2]
    G = Bm.shape[2]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of chunk={chunk}: pad first")
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    if any(t.requires_grad for t in (xh, dt, A, Bm, Cm)):
        raise RuntimeError(
            "ssd_scan is forward only: the SSD backward kernel comes with Mamba-2's "
            "training, ROADMAP item A.12a"
        )
    if xh.is_cuda:
        c = torch.Tensor.contiguous
        return ssd_scan_cuda(c(xh), c(dt), c(A), c(Bm), c(Cm), chunk=chunk, return_state=return_state)
    return ssd_chunked_ref(xh, dt, A, Bm, Cm, chunk, return_state=return_state)
