"""Analytic FLOP / HBM-traffic counters for the roofline analysis.

The port's copy of ``repro/launch/roofline.py``, reading the port's
``ArchConfig``: the same counts, term for term and in the same order, so
the two agree exactly (``tests/test_torch_roofline.py``).  The reference
counts analytically because XLA's ``cost_analysis()`` counts a scanned
layer once; the port keeps the counts as the bound beside its measured
times (``chip_smoke.py``'s LLM phases).

Conventions:
  * matmul (m,k)x(k,n): 2*m*k*n flops.
  * training flops = fwd * (2 bwd + 1 fwd) = 3x, and 4x under
    ``remat="full"`` (each layer's forward runs again in the backward).
  * causal attention context factor 1/2; local window uses min(window, S).
  * HBM traffic: parameter bytes x passes + optimizer state traffic +
    per-layer activation read/write estimate + cache traffic for decode.
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ArchConfig

__all__ = ["analytic_flops", "analytic_hbm_bytes", "count_params"]


def _attn_flops_per_token(cfg: ArchConfig, ctx: int, window=None) -> float:
    """Projections + score/context matmuls for one token with `ctx` visible
    keys (already averaged for causality by the caller)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla:
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = 2 * d * H * qd              # q
        proj += 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)  # compress
        proj += 2 * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
        proj += 2 * H * m.v_head_dim * d   # output
        scores = 2 * H * qd * ctx + 2 * H * m.v_head_dim * ctx
        return proj + scores
    proj = 2 * d * H * hd + 2 * 2 * d * Hkv * hd + 2 * H * hd * d
    scores = 2 * H * hd * ctx * 2  # qk + pv
    return proj + scores


def _mlp_flops_per_token(cfg: ArchConfig, d_ff: int) -> float:
    mats = 3 if cfg.mlp_act == "swiglu" else 2
    return mats * 2 * cfg.d_model * d_ff


def _moe_flops_per_token(cfg: ArchConfig) -> float:
    m = cfg.moe
    f = 2 * cfg.d_model * m.num_experts            # router
    f += m.top_k * 3 * 2 * cfg.d_model * m.d_ff_expert
    if m.num_shared:
        f += 3 * 2 * cfg.d_model * (m.d_ff_shared or m.d_ff_expert * m.num_shared)
    return f


def _ssd_flops_per_token(cfg: ArchConfig) -> float:
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    H = s.n_heads(d)
    G, N, P, c = s.n_groups, s.d_state, s.head_dim, s.chunk
    proj = 2 * d * (2 * din + 2 * G * N + H) + 2 * din * d
    conv = 2 * s.conv_kernel * (din + 2 * G * N)
    # intra-chunk: scores (c x N x c)/c per token = 2*c*N (G groups -> heads
    # share), y_diag 2*c*H*P; inter-chunk: states 2*N*P*H/c per token *c ≈
    # 2*N*P*H (build) + 2*N*P*H (apply)
    ssd = 2 * c * G * N + 2 * c * H * P + 4 * N * P * H
    return proj + conv + ssd


def _rglru_flops_per_token(cfg: ArchConfig) -> float:
    d = cfg.d_model
    w = cfg.hybrid.lru_width or d
    return 2 * d * w * 2 + 2 * w * w * 2 + 2 * w * d + 10 * w


def fwd_flops_per_token(cfg: ArchConfig, seq: int, kind: str) -> float:
    """Average forward flops per token at sequence length `seq`."""
    d, V = cfg.d_model, cfg.vocab
    if kind == "decode":
        ctx_full = seq            # decode sees the whole cache
    else:
        ctx_full = seq / 2        # causal average

    total = 0.0
    if cfg.family == "ssm":
        total += cfg.n_layers * _ssd_flops_per_token(cfg)
    elif cfg.family == "hybrid":
        hy = cfg.hybrid
        unit = hy.rec_per_unit + hy.attn_per_unit
        n_units = cfg.n_layers // unit
        n_rec = n_units * hy.rec_per_unit + (cfg.n_layers - n_units * unit)
        n_attn = n_units * hy.attn_per_unit
        ctx = min(hy.window, ctx_full)
        total += n_rec * (_rglru_flops_per_token(cfg) + _mlp_flops_per_token(cfg, cfg.d_ff))
        total += n_attn * (
            _attn_flops_per_token(cfg, ctx) + _mlp_flops_per_token(cfg, cfg.d_ff)
        )
    else:
        n_moe = 0
        n_dense = cfg.n_layers
        if cfg.moe is not None:
            n_moe = cfg.n_layers - cfg.moe.first_dense_layers
            n_dense = cfg.moe.first_dense_layers
        attn = _attn_flops_per_token(cfg, ctx_full)
        total += cfg.n_layers * attn
        total += n_dense * _mlp_flops_per_token(cfg, cfg.d_ff)
        if n_moe:
            total += n_moe * _moe_flops_per_token(cfg)
    total += 2 * d * V  # logits head (embedding gather ~ free)
    return total


def analytic_flops(cfg: ArchConfig, meta: Dict) -> float:
    """Global FLOPs for one step of the cell."""
    B, S, kind = meta["batch"], meta["seq"], meta["kind"]
    if kind == "decode":
        per_tok = fwd_flops_per_token(cfg, S, kind)
        return B * per_tok
    per_tok = fwd_flops_per_token(cfg, S, kind)
    tokens = B * S
    if kind == "train":
        mult = 4.0 if cfg.remat == "full" else 3.0
        return mult * tokens * per_tok
    return tokens * per_tok  # prefill


def count_params(cfg: ArchConfig) -> int:
    """Not counted from the config, as in the reference: count a built
    model's parameters (``sum(p.numel() for p in model.parameters())``)."""
    raise NotImplementedError("count the parameters of a built Model")


def analytic_hbm_bytes(cfg: ArchConfig, meta: Dict, n_params: int,
                       cache_bytes: int = 0) -> float:
    """Global HBM traffic estimate for one step."""
    B, S, kind = meta["batch"], meta["seq"], meta["kind"]
    pdt = 2 if cfg.param_dtype == "bfloat16" else 4
    adt = 2 if cfg.compute_dtype == "bfloat16" else 4
    tokens = B * (1 if kind == "decode" else S)
    # per-token per-layer activation traffic: ~8 residual-sized tensors rw
    act = tokens * cfg.n_layers * cfg.d_model * adt * 8
    if kind == "train":
        # params: fwd read + bwd read + remat read; grads write+read; adam
        # m/v read+write (fp32); param write
        p_traffic = n_params * (3 * pdt + 2 * 4 + 4 * 4 + pdt)
        return p_traffic + 3 * act
    if kind == "prefill":
        return n_params * pdt + act + cache_bytes
    # decode: all params + whole cache read once, small writes
    return n_params * pdt + cache_bytes + act
