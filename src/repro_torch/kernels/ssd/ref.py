"""Plain PyTorch versions of the SSD scan.

Counterparts of ``repro/kernels/ssd/ref.py::ssd_sequential_ref`` (the
literal per-token recurrence) and ``repro/models/mamba2.py::ssd_chunked_ref``
(the chunked formulation).  The port's CPU path and the tests use them,
and ``chip_smoke.py`` holds ``csrc/ssd.cu`` to them on the card.  All
arithmetic is float32, as in the kernel and in the reference's Pallas
kernel: inputs of a narrower dtype are widened first, ``y`` comes back in
``xh``'s dtype and the state in float32.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_chunked_ref", "ssd_sequential_ref"]


def _heads(m: torch.Tensor, H: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N): head h reads group h // (H / G)."""
    return m.float().repeat_interleave(H // m.shape[-2], dim=-2)


def ssd_sequential_ref(
    xh: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,   # (H,) negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
) -> torch.Tensor:
    """Literal recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ;
    y_t = C_t · h_t."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Bh, Ch = _heads(Bm, H), _heads(Cm, H)
    x, d, a = xh.float(), dt.float(), A.float()
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        decay = torch.exp(d[:, t] * a[None, :])
        upd = torch.einsum("bh,bhn,bhp->bhnp", d[:, t], Bh[:, t], x[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1).to(xh.dtype)


def ssd_chunked_ref(
    xh: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), post-softplus
    A: torch.Tensor,   # (H,) negative decay rates
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    return_state: bool = False,
):
    """Chunked SSD scan: per chunk the masked quadratic term, plus the
    carried (N, P) state between chunks.  S must be a multiple of
    ``chunk``.  Returns y (B, S, H, P); with ``return_state`` also the final
    (B, H, N, P) float32 state."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.float().reshape(B, nc, chunk, H, P)
    dtc = dt.float().reshape(B, nc, chunk, H)
    Bh = _heads(Bm, H).reshape(B, nc, chunk, H, N)
    Ch = _heads(Cm, H).reshape(B, nc, chunk, H, N)

    cums = torch.cumsum(dtc * A.float(), dim=2)  # (B, nc, c, H), decreasing
    # L[i, j] = exp(cums_i - cums_j) for i >= j: one difference, never a
    # ratio of two exponentials (exp(-cums_j) overflows); the upper
    # triangle is selected away, not multiplied by 0 (inf * 0 = NaN)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (B, nc, i, j, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=xh.device).tril()
    L = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    del diff
    w = torch.einsum("bnihd,bnjhd->bnijh", Ch, Bh) * L * dtc[:, :, None, :, :]
    del L
    y = torch.einsum("bnijh,bnjhp->bnihp", w, xc)
    del w

    # per-chunk states: sum_j exp(cums_last - cums_j) dt_j B_j x_jᵀ
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)  # (B, nc, c, H)
    states = torch.einsum("bnchd,bnchp->bnhdp", Bh * (decay_to_end * dtc)[..., None], xc)
    chunk_decay = torch.exp(cums[:, :, -1, :])  # (B, nc, H)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    prev = []
    for n in range(nc):
        prev.append(state)  # the state entering chunk n
        state = state * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    # inter-chunk term: C_i · (exp(cums_i) * state entering the chunk)
    y = y + torch.einsum("bnchd,bnhdp->bnchp", Ch, prev_states) * torch.exp(cums)[..., None]
    y = y.reshape(B, S, H, P).to(xh.dtype)
    return (y, state) if return_state else y
