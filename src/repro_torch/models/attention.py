"""Standard attention (MHA / GQA / MQA) with RoPE or M-RoPE, QKV bias and
QK-norm, and its KV-cache decode path, in PyTorch.

Counterpart of the standard half of ``repro/models/attention.py``:
``init_attention``'s distributions, ``_project_qkv``, ``_attend``,
``attention_forward(return_kv=)`` (``:55-275``), ``init_kv_cache``,
``_quantize_kv``, ``attention_decode`` and ``apply_kv_cache_update``
without a mesh (``:278-459``), the int8 KV cache included.  MLA, a local
window and ``exclude_slot`` come with the ``moe`` and ``hybrid`` families
(ROADMAP A10.4-A10.5).

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
uses kv head ``h // (H // Hkv)``), as the reference does.  Decoding runs
plain torch, as the reference's decode runs plain jnp.

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

from ..kernels.attention.ops import flash_attention
from ..nn.core import RMSNorm, rmsnorm, trunc_normal_param
from .config import ArchConfig
from .rotary import apply_mrope, apply_rope, text_mrope_positions

__all__ = ["Attention", "apply_kv_cache_update", "init_kv_cache", "quantize_kv"]

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
                return_kv: bool = False):
        """Full-sequence attention (prefill / loss), x (B,S,d) -> (B,S,d);
        with ``return_kv`` also (k, v) in cache layout (B,S,Hkv,hd)."""
        B, S = x.shape[:2]
        q, k, v = self.project_qkv(x, positions)
        o = attend(q, k, v, causal=causal)
        o = o.transpose(1, 2).reshape(B, S, self.H * self.hd)
        out = F.linear(o, self.wo.weight.to(self.cd))
        if return_kv:
            return out, (k.transpose(1, 2), v.transpose(1, 2))
        return out

    def decode(self, x: torch.Tensor, layer_cache: Dict[str, torch.Tensor], pos: int
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One token per sequence, read-only over ``layer_cache`` (k / v
        (B,S,Hkv,hd)): attends over the cache's positions < ``pos`` and the
        token's own k / v inline.  x (B,1,d) -> (out (B,1,d), (k_row,
        v_row) (B,1,Hkv,hd)); the caller writes the rows
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
        valid = torch.arange(S, device=x.device) < pos
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
           q_offset: int = 0) -> torch.Tensor:
    """Windowless attention over q (B,H,Sq,D) and k / v (B,Hkv,Sk,D): k and
    v repeated over the query heads, then B4 (the plain version on the
    CPU).  Returns (B,H,Sq,D) in q's dtype."""
    H, Hkv = q.shape[1], k.shape[1]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


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
    if 0 <= write_slot < cache["k"].shape[2]:
        for name, r in rows.items():
            cache[name][:, :, write_slot : write_slot + 1] = r.to(cache[name].dtype)
    return cache
