"""Standard attention (MHA / GQA / MQA) with RoPE or M-RoPE, QKV bias and
QK-norm, DeepSeek-V2's MLA, and their cache decode paths, in PyTorch.

Counterpart of ``repro/models/attention.py`` without a mesh: the
standard half, ``init_attention``'s distributions, ``_project_qkv``,
``_attend``, ``attention_forward(return_kv=)`` (``:55-275``),
``init_kv_cache``, ``_quantize_kv``, ``attention_decode`` and
``apply_kv_cache_update`` (``:278-459``), the int8 KV cache included;
and MLA, ``init_mla``, ``mla_forward``, ``init_mla_cache``, ``mla_decode``
and ``apply_mla_cache_update`` (``:462-610``), with ``flash_ref``
(``:122-203``), which MLA's prefill and every windowed attention run.  A
local window (the ``hybrid`` family's) masks the keys ``window`` or more
positions behind the query, and ``Attention.decode``'s ``exclude_slot``
leaves out the ring-buffer slot the step is about to overwrite.

The projections are packed: ``qkv`` is one ``nn.Linear`` whose weight is
the reference's ``wq``, ``wk`` and ``wv`` ``(d, H, hd)`` flattened to
``(d, H·hd)``, transposed and stacked along the output axis, and whose
bias is ``bq``, ``bk`` and ``bv`` concatenated; ``wo`` is the reference's
``(H, hd, d)`` flattened to ``(H·hd, d)`` and transposed
(``convert.lm_params_from_jax``).  q, k and v are views of the one
projection, and the attention kernel reads them at their strides.

Full-sequence attention launches the hand-written kernel B4
(``kernels/attention``) on the card wherever there is no window, once per
layer; the reference reaches its Pallas kernel only under ``use_pallas``
and otherwise runs ``flash_ref``, which computes the same function.  GQA
repeats k / v over the query heads before the launch (query head ``h``
uses kv head ``h // (H // Hkv)``), as the reference does.  A windowed
attention runs ``flash_ref`` after the same repeat, as the reference's
does even under ``use_pallas`` (``attention.py:237-242``), under the
profiler range ``attention.windowed``: B4 takes no window (and
recurrentgemma's heads are 256 wide, past B4's D ≤ 128).  Decoding runs
plain torch, as the reference's decode runs plain jnp.

MLA keeps its weights in the reference's layout (``wq`` (d, H, nope +
rope), ``w_dkv`` (d, r), ``w_kr`` (d, rope), ``kv_norm``, ``w_uk`` (r, H,
nope), ``w_uv`` (r, H, v), ``wo`` (H, v, d)) and multiplies by their
flattened views.  Its prefill attends with ``flash_ref``, plain torch,
as the reference does even under ``use_pallas`` (``attention.py:523``):
q / k are nope + rope wide and v is v_head_dim wide, which B4 (D == Dv)
does not take.  ``flash_ref`` keeps the reference's blocked online
softmax, so a 2048-token prefill holds one (B, H, 512, 512) block of
scores at a time, and rounds P to the compute dtype before ``P V``; it
skips the key blocks a causal query block cannot see and those wholly
before a window, which changes no bit (such a block leaves the running
max, sum and output as they were).
Its decode is weight-absorbed, over the compressed cache ``c_kv`` (L, B,
S, r) and ``k_rope`` (L, B, S, rope), bfloat16 when ``kv_cache_dtype``
is int8, written in place by ``apply_mla_cache_update``.

The KV cache is a dict of stacked-layer tensors ``k`` / ``v`` (L, B, S,
Hkv, hd), plus float32 ``k_scale`` / ``v_scale`` (L, B, S, Hkv) when it is
int8.  ``apply_kv_cache_update`` writes the new rows into the cache's
tensors in place (the reference donates its cache to the same effect) and
drops a write at ``pos`` outside ``[0, S)``, as the reference's clipped
write does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..kernels.attention.ops import flash_attention
from ..nn.core import RMSNorm, rmsnorm, trunc_normal_param
from .config import ArchConfig
from .rotary import apply_mrope, apply_rope, text_mrope_positions

__all__ = ["Attention", "MLA", "apply_kv_cache_update", "apply_mla_cache_update", "flash_ref",
           "init_kv_cache", "init_mla_cache", "quantize_kv"]

NEG_INF = -1e30  # the reference decode's mask value


class Attention(nn.Module):
    """``qkv`` (packed q / k / v projection, bias when ``qkv_bias``),
    ``wo``, and ``q_norm`` / ``k_norm`` when ``qk_norm``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        pd = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.cd = getattr(torch, cfg.compute_dtype)
        self.H, self.Hkv, self.hd = H, Hkv, hd
        self.qkv = nn.Linear(d, (H + 2 * Hkv) * hd, bias=cfg.qkv_bias, device="meta")
        self.qkv.weight = trunc_normal_param(((H + 2 * Hkv) * hd, d), 1.0 / math.sqrt(d), generator,
                                             device=device, dtype=pd)
        if cfg.qkv_bias:
            self.qkv.bias = nn.Parameter(torch.zeros((H + 2 * Hkv) * hd, dtype=pd, device=device))
        self.wo = nn.Linear(H * hd, d, bias=False, device="meta")
        self.wo.weight = trunc_normal_param((d, H * hd), 1.0 / math.sqrt(H * hd), generator,
                                            device=device, dtype=pd)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dtype=pd, device=device)
            self.k_norm = RMSNorm(hd, dtype=pd, device=device)

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B,S,d) -> q (B,H,S,hd), k / v (B,Hkv,S,hd), RoPE applied;
        v is a view of the packed projection."""
        cd, cfg = self.cd, self.cfg
        bias = self.qkv.bias.to(cd) if cfg.qkv_bias else None
        qkv = F.linear(x.to(cd), self.qkv.weight.to(cd), bias)
        q, k, v = qkv.split([self.H * self.hd, self.Hkv * self.hd, self.Hkv * self.hd], dim=-1)
        q = q.unflatten(-1, (self.H, self.hd))
        k = k.unflatten(-1, (self.Hkv, self.hd))
        v = v.unflatten(-1, (self.Hkv, self.hd))
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm.weight)
            k = rmsnorm(k, self.k_norm.weight)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if cfg.rope == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        elif cfg.rope == "mrope":
            pos3 = text_mrope_positions(positions)
            q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, causal: bool = True,
                window: Optional[int] = None, return_kv: bool = False):
        """Full-sequence attention (prefill / loss), x (B,S,d) -> (B,S,d),
        over the keys fewer than ``window`` positions back where it is
        given; with ``return_kv`` also (k, v) in cache layout (B,S,Hkv,hd)."""
        B, S = x.shape[:2]
        q, k, v = self.project_qkv(x, positions)
        o = attend(q, k, v, causal=causal, window=window)
        o = o.transpose(1, 2).reshape(B, S, self.H * self.hd)
        out = F.linear(o, self.wo.weight.to(self.cd))
        if return_kv:
            return out, (k.transpose(1, 2), v.transpose(1, 2))
        return out

    def decode(self, x: torch.Tensor, layer_cache: Dict[str, torch.Tensor], pos: int,
               exclude_slot: Optional[int] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One token per sequence, read-only over ``layer_cache`` (k / v
        (B,S,Hkv,hd)): attends over the cache's slots < ``pos`` but
        ``exclude_slot`` (a ring buffer's stale slot, which this step
        overwrites) and the token's own k / v inline.  x (B,1,d) -> (out
        (B,1,d), (k_row, v_row) (B,1,Hkv,hd)); the caller writes the rows
        (``apply_kv_cache_update``)."""
        cd = self.cd
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q, k_new, v_new = self.project_qkv(x, positions)  # (B,H,1,hd)
        k_row, v_row = k_new.transpose(1, 2), v_new.transpose(1, 2)  # (B,1,Hkv,hd)
        if "k_scale" in layer_cache:
            k_all = layer_cache["k"].to(cd) * layer_cache["k_scale"][..., None].to(cd)
            v_all = layer_cache["v"].to(cd) * layer_cache["v_scale"][..., None].to(cd)
        else:
            k_all = layer_cache["k"].to(cd)
            v_all = layer_cache["v"].to(cd)
        S, Hkv, H = k_all.shape[1], k_all.shape[2], self.H
        scale = 1.0 / math.sqrt(self.hd)
        qh = q[:, :, 0]  # (B,H,hd)
        slots = torch.arange(S, device=x.device)
        valid = slots < pos
        if exclude_slot is not None:
            valid &= slots != exclude_slot
        if H != Hkv:
            qg = qh.reshape(B, Hkv, H // Hkv, self.hd)
            s_cache = torch.einsum("bgrd,bsgd->bgrs", qg, k_all).float() * scale
            s_new = torch.einsum("bgrd,bgd->bgr", qg, k_row[:, 0].to(cd)).float()[..., None] * scale
        else:
            s_cache = torch.einsum("bhd,bshd->bhs", qh, k_all).float() * scale
            s_new = torch.einsum("bhd,bhd->bh", qh, k_row[:, 0].to(cd)).float()[..., None] * scale
        s_cache = s_cache.masked_fill(~valid, NEG_INF)
        probs = torch.softmax(torch.cat([s_cache, s_new], dim=-1), dim=-1).to(cd)
        if H != Hkv:
            ctx = torch.einsum("bgrs,bsgd->bgrd", probs[..., :S], v_all)
            ctx = (ctx + probs[..., S:] * v_row[:, 0, :, None, :]).reshape(B, H, self.hd)
        else:
            ctx = torch.einsum("bhs,bshd->bhd", probs[..., :S], v_all)
            ctx = ctx + probs[..., S][..., None] * v_row[:, 0].to(cd)
        out = F.linear(ctx.reshape(B, H * self.hd), self.wo.weight.to(cd))[:, None]
        return out, (k_row, v_row)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
           q_offset: int = 0, window: Optional[int] = None) -> torch.Tensor:
    """Attention over q (B,H,Sq,D) and k / v (B,Hkv,Sk,D), k and v repeated
    over the query heads: B4 (the plain version on the CPU) without a
    window, ``flash_ref`` with one.  Returns (B,H,Sq,D) in q's dtype."""
    if window is not None:
        with record_function("attention.windowed"):
            k, v = _repeat_kv(q, k, v)
            return flash_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    k, v = _repeat_kv(q, k, v)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """k and v repeated over q's heads (GQA / MQA)."""
    H, Hkv = q.shape[1], k.shape[1]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    return k, v


def init_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                  device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Zero stacked-layer KV cache (L,B,S,Hkv,hd) in ``kv_cache_dtype``;
    int8 codes with float32 scales (L,B,S,Hkv) for ``"int8"``."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    dt = getattr(torch, cfg.kv_cache_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 codes and a float32 scale per row: scale =
    max(amax, 1e-6) / 127, codes = round-half-even(x / scale) in
    [-127, 127] (the reference's ``_quantize_kv``)."""
    amax = x.abs().amax(dim=-1)
    scale = amax.float().clamp(min=1e-6) / 127.0
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def apply_kv_cache_update(cache: Dict[str, torch.Tensor], new_kv, write_slot: int
                          ) -> Dict[str, torch.Tensor]:
    """Write the stacked rows ``new_kv = (k_rows, v_rows)`` (L,B,1,Hkv,hd)
    at sequence position ``write_slot`` of every layer, in place (quantized
    first for an int8 cache); a slot outside [0, S) writes nothing.
    Returns ``cache``."""
    k_rows, v_rows = new_kv
    if "k_scale" in cache:
        kq, ks = quantize_kv(k_rows)
        vq, vs = quantize_kv(v_rows)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k_rows, "v": v_rows}
    _write_rows(cache, rows, write_slot)
    return cache


def _write_rows(cache: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor], slot: int) -> None:
    """Write (L, B, 1, ...) rows at sequence position ``slot`` (dim 2) of each
    cache tensor, in place; nothing when ``slot`` is outside [0, S)."""
    if 0 <= slot < next(iter(cache.values())).shape[2]:
        for name, r in rows.items():
            cache[name][:, :, slot : slot + 1] = r.to(cache[name].dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-KV attention
# ---------------------------------------------------------------------------


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, q_offset: int = 0, block_q: int = 512,
              block_k: int = 512) -> torch.Tensor:
    """The reference's ``flash_ref``: q (B,H,Sq,D), k (B,H,Sk,D), v
    (B,H,Sk,Dv) -> (B,H,Sq,Dv) in q's dtype.  Per block of ``block_q``
    queries, an online softmax over blocks of ``block_k`` keys: scores
    ``q kᵀ`` in q's dtype, then float32 times 1/sqrt(D); P rounded to q's
    dtype before ``P V``; running max, sum and output float32.  A key is
    masked past the query when ``causal`` and ``window`` or more positions
    behind it when ``window`` is given (``q_pos - k_pos < window``).
    ``q_offset`` is the absolute position of q's first row."""
    B, H, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[-1]
    scale = 1.0 / math.sqrt(D)
    out = q.new_empty(B, H, Sq, Dv)
    for q0 in range(0, Sq, block_q):
        qb = q[:, :, q0 : q0 + block_q]
        qpos = q_offset + q0 + torch.arange(qb.shape[2], device=q.device)
        m = torch.full(qb.shape[:3], -math.inf, dtype=torch.float32, device=q.device)
        ls = torch.zeros_like(m)
        acc = torch.zeros(qb.shape[:3] + (Dv,), dtype=torch.float32, device=q.device)
        k_end = min(Sk, q_offset + q0 + qb.shape[2]) if causal else Sk
        # the block holding the first query's first key in the window
        k_start = 0 if window is None else max(0, q_offset + q0 - window + 1) // block_k * block_k
        for k0 in range(k_start, k_end, block_k):
            kb, vb = k[:, :, k0 : k0 + block_k], v[:, :, k0 : k0 + block_k]
            s = (qb @ kb.transpose(-1, -2)).float() * scale
            if causal or window is not None:
                dist = qpos[:, None] - (k0 + torch.arange(kb.shape[2], device=q.device))[None, :]
                mask = dist >= 0 if causal else torch.ones_like(dist, dtype=torch.bool)
                if window is not None:
                    mask &= dist < window
                s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])  # exp(-inf) = 0 where masked
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            ls = ls * corr + p.sum(-1)
            acc = acc * corr[..., None] + (p.to(q.dtype) @ vb).float()
            m = m_new
        out[:, :, q0 : q0 + block_q] = (acc / ls.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out


class MLA(nn.Module):
    """Multi-head latent attention: ``wq``, ``w_dkv``, ``w_kr``, ``kv_norm``,
    ``w_uk``, ``w_uv``, ``wo`` in the reference's layout, each drawn from
    the fan-in truncated normal of ``init_mla`` (``attention.py:462-476``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        pd = getattr(torch, cfg.param_dtype)
        self.cfg, self.H = cfg, H
        self.cd = getattr(torch, cfg.compute_dtype)
        self.nope, self.rope_d, self.dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
        r = m.kv_lora_rank

        def param(shape, fan_in):
            return trunc_normal_param(shape, 1.0 / math.sqrt(fan_in), generator, device=device,
                                      dtype=pd)

        self.wq = param((d, H, self.nope + self.rope_d), d)
        self.w_dkv = param((d, r), d)
        self.w_kr = param((d, self.rope_d), d)
        self.kv_norm = RMSNorm(r, dtype=pd, device=device)
        self.w_uk = param((r, H, self.nope), r)
        self.w_uv = param((r, H, self.dv), r)
        self.wo = param((H, self.dv, d), H * self.dv)

    def _project(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B,S,d) in the compute dtype -> q_nope, q_rope (B,H,S,·) with
        RoPE on q_rope, c_kv (B,S,r) normalized, k_rope (B,1,S,rope)."""
        cd, B, S = self.cd, x.shape[0], x.shape[1]
        q = (x @ self.wq.to(cd).flatten(1)).view(B, S, self.H, -1).transpose(1, 2)
        q_nope, q_rope = q[..., : self.nope], q[..., self.nope :]
        q_rope = apply_rope(q_rope, positions, self.cfg.rope_theta)
        c_kv = rmsnorm(x @ self.w_dkv.to(cd), self.kv_norm.weight)
        k_rope = apply_rope((x @ self.w_kr.to(cd))[:, None], positions, self.cfg.rope_theta)
        return q_nope, q_rope, c_kv, k_rope

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, return_kv: bool = False):
        """Full-sequence causal MLA (prefill / loss), x (B,S,d) -> (B,S,d);
        with ``return_kv`` also the compressed cache rows (c_kv (B,S,r),
        k_rope (B,S,rope))."""
        cd = self.cd
        x = x.to(cd)
        B, S, H = x.shape[0], x.shape[1], self.H
        q_nope, q_rope, c_kv, k_rope = self._project(x, positions)
        k_nope = (c_kv @ self.w_uk.to(cd).flatten(1)).view(B, S, H, -1).transpose(1, 2)
        v = (c_kv @ self.w_uv.to(cd).flatten(1)).view(B, S, H, -1).transpose(1, 2)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, k_rope.expand(B, H, S, self.rope_d)], dim=-1)
        with record_function("mla.attention"):
            o = flash_ref(qf, kf, v, causal=True)
        out = o.transpose(1, 2).reshape(B, S, H * self.dv) @ self.wo.to(cd).flatten(0, 1)
        if return_kv:
            return out, (c_kv, k_rope[:, 0])
        return out

    def decode(self, x: torch.Tensor, layer_cache: Dict[str, torch.Tensor], pos: int
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Weight-absorbed decode of one token per sequence, read-only over
        ``layer_cache`` (c_kv (B,S,r), k_rope (B,S,rope)): the scores of
        ``q_nope W_uk`` against c_kv plus q_rope against k_rope over the
        positions < ``pos`` and the token's own rows inline, the context
        over c_kv then through ``W_uv``.  x (B,1,d) -> (out (B,1,d),
        (c_row (B,1,r), kr_row (B,1,rope))); the caller writes the rows
        (``apply_mla_cache_update``)."""
        cd = self.cd
        x = x.to(cd)
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q_nope, q_rope, c_new, kr_new = self._project(x, positions)
        q_nope, q_rope, kr_new = q_nope[:, :, 0], q_rope[:, :, 0], kr_new[:, 0]  # (B,H,·), (B,1,rope)
        c_all = layer_cache["c_kv"].to(cd)
        kr_all = layer_cache["k_rope"].to(cd)
        S = c_all.shape[1]
        q_c = torch.einsum("bhk,rhk->bhr", q_nope, self.w_uk.to(cd))
        s_c = torch.einsum("bhr,bsr->bhs", q_c, c_all)
        s_r = torch.einsum("bhk,bsk->bhs", q_rope, kr_all)
        scale = 1.0 / math.sqrt(self.nope + self.rope_d)
        scores = (s_c + s_r).float() * scale
        scores = scores.masked_fill(~(torch.arange(S, device=x.device) < pos), NEG_INF)
        s_new = (torch.einsum("bhr,br->bh", q_c, c_new[:, 0])
                 + torch.einsum("bhk,bk->bh", q_rope, kr_new[:, 0])).float()[..., None] * scale
        probs = torch.softmax(torch.cat([scores, s_new], dim=-1), dim=-1).to(cd)
        ctx_c = torch.einsum("bhs,bsr->bhr", probs[..., :S], c_all)
        ctx_c = ctx_c + probs[..., S][..., None] * c_new[:, 0][:, None, :]
        ctx = torch.einsum("bhr,rhk->bhk", ctx_c, self.w_uv.to(cd))
        out = (ctx.reshape(B, -1) @ self.wo.to(cd).flatten(0, 1))[:, None]
        return out, (c_new, kr_new)


def init_mla_cache(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                   device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Zero stacked-layer MLA cache: ``c_kv`` (L,B,S,r) and ``k_rope``
    (L,B,S,rope) in ``kv_cache_dtype``, bfloat16 for ``"int8"``
    (``attention.py:532-538``)."""
    m = cfg.mla
    dt = torch.bfloat16 if cfg.kv_cache_dtype == "int8" else getattr(torch, cfg.kv_cache_dtype)
    return {"c_kv": torch.zeros(n_layers, batch, max_len, m.kv_lora_rank, dtype=dt, device=device),
            "k_rope": torch.zeros(n_layers, batch, max_len, m.qk_rope_head_dim, dtype=dt,
                                  device=device)}


def apply_mla_cache_update(cache: Dict[str, torch.Tensor], new_rows, pos: int
                           ) -> Dict[str, torch.Tensor]:
    """Write the stacked rows ``new_rows = (c_rows, kr_rows)`` (L,B,1,·) at
    sequence position ``pos`` of every layer, in place; a position outside
    [0, S) writes nothing.  Returns ``cache``."""
    c_rows, kr_rows = new_rows
    _write_rows(cache, {"c_kv": c_rows, "k_rope": kr_rows}, pos)
    return cache
