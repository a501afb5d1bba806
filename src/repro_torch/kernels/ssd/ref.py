"""Plain PyTorch versions of the SSD scan.

Counterparts of ``repro/kernels/ssd/ref.py::ssd_sequential_ref`` (the
literal per-token recurrence) and ``repro/models/mamba2.py::ssd_chunked_ref``
(the chunked formulation).  The port's CPU path and the tests use them,
and ``chip_smoke.py`` holds ``csrc/ssd.cu`` to them on the card.  All
arithmetic is float32, as in the kernel and in the reference's Pallas
kernel: inputs of a narrower dtype are widened first, ``y`` comes back in
``xh``'s dtype and the state in float32.

``ssd_chunked_bwd_plain`` is the scan's backward written out in the same
chunked form (the reference has none: it differentiates
``ssd_chunked_ref``); ``csrc/ssd_bwd.cu`` is held to it.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_chunked_bwd_plain", "ssd_chunked_ref", "ssd_sequential_ref"]


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


def ssd_chunked_bwd_plain(
    xh: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,   # (H,) float32
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    dy: torch.Tensor,  # (B, S, H, P), the gradient of ssd_chunked_ref's y
    chunk: int,
):
    """Gradients (dx, ddt, dA, dB, dC) of ``ssd_chunked_ref(xh, dt, A, Bm,
    Cm, chunk)`` against ``dy``, in the inputs' dtypes (dA float32).  Per
    (batch, head) and chunk, with cums the inclusive prefix sum of dt·A,
    L[i,j] = exp(cums_i - cums_j) for j <= i, e_j = exp(cums_last - cums_j),
    S0 the state entering the chunk and dS the gradient of the one leaving
    it (0 after the last chunk):

      dx_j = dt_j [sum_{i>=j} L_ij (C_i·B_j) dy_i + e_j B_j dS]
      dC_i = sum_{j<=i} L_ij dt_j (dy_i·x_j) B_j + exp(cums_i) S0 dy_i
      dB_j = sum_{i>=j} L_ij dt_j (dy_i·x_j) C_i + dt_j e_j dS x_j
      dcums_i = sum_j K_ij dt_j - sum_k K_ki dt_i + exp(cums_i) (C_i S0)·dy_i
                - e_i dt_i q_i  (+ exp(cums_last) <S0, dS> + sum_j e_j dt_j q_j
                on the last row), K_ij = L_ij (C_i·B_j)(dy_i·x_j),
                q_j = B_j·(dS x_j)
      ddt_j = sum_i K_ij + e_j q_j + A r_j,  dA = sum dt_j r_j,
              r the reverse prefix sum of dcums
      dS <- exp(cums_last) dS + (exp(cums) ⊙ C)ᵀ dy  (one chunk back)

    dB and dC sum over the heads of a group, dA over batch and sequence."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    nc = S // chunk
    xc = xh.float().reshape(B, nc, chunk, H, P)
    dyc = dy.float().reshape(B, nc, chunk, H, P)
    dtc = dt.float().reshape(B, nc, chunk, H)
    a = A.float()
    Bh = _heads(Bm, H).reshape(B, nc, chunk, H, N)
    Ch = _heads(Cm, H).reshape(B, nc, chunk, H, N)

    cums = torch.cumsum(dtc * a, dim=2)  # (B, nc, c, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=xh.device).tril()
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (B, nc, i, j, H)
    L = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    del diff
    e = torch.exp(cums[:, :, -1:, :] - cums)  # (B, nc, c, H)
    ecums = torch.exp(cums)
    decay = torch.exp(cums[:, :, -1, :])  # (B, nc, H)

    # the state entering each chunk (S0) and the gradient of the state
    # leaving it (dS), the forward's recurrence and its reverse
    upd = torch.einsum("bnchd,bnchp->bnhdp", Bh * (e * dtc)[..., None], xc)
    back = torch.einsum("bnchd,bnchp->bnhdp", Ch * ecums[..., None], dyc)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    grad = torch.zeros_like(state)
    S0, dS = [], [None] * nc
    for n in range(nc):
        S0.append(state)
        state = state * decay[:, n, :, None, None] + upd[:, n]
    for n in reversed(range(nc)):
        dS[n] = grad
        grad = grad * decay[:, n, :, None, None] + back[:, n]
    S0, dS = torch.stack(S0, dim=1), torch.stack(dS, dim=1)  # (B, nc, H, N, P)
    del upd, back

    s = torch.einsum("bnihd,bnjhd->bnijh", Ch, Bh)   # C_i · B_j
    g = torch.einsum("bnihp,bnjhp->bnijh", dyc, xc)  # dy_i · x_j
    W = L * s
    M = L * g * dtc[:, :, None, :, :]
    K = W * g
    del L, s, g
    BdS = torch.einsum("bnjhd,bnhdp->bnjhp", Bh, dS)   # B_j dS
    dSx = torch.einsum("bnhdp,bnjhp->bnjhd", dS, xc)   # dS x_j
    S0dy = torch.einsum("bnhdp,bnihp->bnihd", S0, dyc)  # S0 dy_i
    q = (Bh * dSx).sum(-1)      # B_j·(dS x_j)
    cS = (Ch * S0dy).sum(-1)    # (C_i S0)·dy_i

    dx = dtc[..., None] * (torch.einsum("bnijh,bnihp->bnjhp", W, dyc) + e[..., None] * BdS)
    dCh = torch.einsum("bnijh,bnjhd->bnihd", M, Bh) + ecums[..., None] * S0dy
    dBh = torch.einsum("bnijh,bnihd->bnjhd", M, Ch) + (dtc * e)[..., None] * dSx
    col = K.sum(dim=2)                                      # sum_i K_ij
    row = (K * dtc[:, :, None, :, :]).sum(dim=3)            # sum_j K_ij dt_j
    del W, M, K
    dcums = row - dtc * col + ecums * cS - e * dtc * q
    dcums[:, :, -1] += decay * (S0 * dS).sum((-2, -1)) + (e * dtc * q).sum(dim=2)
    r = torch.flip(torch.cumsum(torch.flip(dcums, (2,)), dim=2), (2,))
    ddt = col + e * q + a * r
    dA = (dtc * r).sum((0, 1, 2))

    def groups(t):  # (B, nc, c, H, N) -> (B, S, G, N), heads of a group summed
        return t.reshape(B, S, G, H // G, N).sum(dim=3)

    return (dx.reshape(B, S, H, P).to(xh.dtype), ddt.reshape(B, S, H).to(dt.dtype), dA,
            groups(dBh).to(Bm.dtype), groups(dCh).to(Cm.dtype))
