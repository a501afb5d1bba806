"""Architecture configuration of the port's language models.

Counterpart of ``repro/models/config.py``, cut to the fields the ported
families read: ``ssm`` (Mamba-2), ``dense`` (a causal decoder of MHA /
GQA attention with RoPE and a SwiGLU or GELU MLP), ``vlm`` (the same
decoder with M-RoPE and a vision stub: precomputed patch embeddings
projected over the first positions) and ``audio`` (a bidirectional
encoder over projected frame embeddings) and ``moe`` (the decoder with a
mixture-of-experts MLP, ``MoEConfig``, and for DeepSeek-V2 MLA attention,
``MLAConfig``) and ``hybrid`` (RecurrentGemma: units of RG-LRU layers
and one local-attention layer, ``HybridConfig``).  The reference's
``use_pallas`` and ``scan_layers`` are left out: the port always launches
its kernels on the card (B4 on every windowless attention, B5 on every SSD
scan) and runs its layers eagerly.  Its memory policies are the
reference's: ``remat`` ("full" by default, "dots" or "none") picks what
each layer keeps for the backward (``models/backbone.py::_remat``), and
``prefill_chunks`` cuts a prefill's batch.  ``reduced()`` gives the
reference's smoke-test numbers by the reference's rules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "HybridConfig", "MLAConfig", "MoEConfig", "SSMConfig"]

REMAT_MODES = ("full", "dots", "none")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # layers before this index use a dense MLP (DeepSeek: first layer dense)
    first_dense_layers: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style: repeating (recurrent × rec_per_unit, attention)."""

    rec_per_unit: int = 2            # RG-LRU layers per unit
    attn_per_unit: int = 1           # local-attention layers per unit
    window: int = 2048               # local attention window
    lru_width: Optional[int] = None  # defaults to d_model
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # explicit; else d_model / n_heads
    qkv_bias: bool = False
    qk_norm: bool = False            # per-head RMSNorm on q, k
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    mlp_act: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    encoder_only: bool = False       # hubert: bidirectional, no decode
    frontend: Optional[str] = None   # audio_stub | vision_stub
    frontend_dim: int = 512          # stub embedding dim
    vision_patches: int = 64         # patches prepended per sample (vlm stub)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | float32 | int8
    remat: str = "full"              # full | dots | none
    # prefill the prompt batch in this many chunks, one after another, to
    # bound the prefill's transient memory (MoE dispatch / combine buffers
    # scale with the live tokens)
    prefill_chunks: int = 1

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"{self.name}: remat={self.remat!r}; have {REMAT_MODES}")

    @property
    def sub_quadratic(self) -> bool:
        """Supports the long_500k cell (state-space or windowed attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU tests, by the reference's
        rules: 4 layers, d_model 64, d_ff 128, vocab 512, float32; at most
        4 heads, kv heads at most the heads and 1 where they do not divide
        them, head_dim 16 where it is explicit; frontend_dim 32, 4 vision
        patches and M-RoPE sections (2, 3, 3) (summing to the reduced
        head_dim / 2 = 8) under ``rope="mrope"``; for ``ssm`` d_state 16,
        head_dim 16, chunk 32; for ``moe`` at most 8 experts, top_k at
        most 2, d_ff_expert 64, d_ff_shared 64 where there are shared
        experts, and capacity_factor 8.0 (dropless: C >= Tg * k for any
        routing); for ``mla`` ranks 32 / 16 / 8 / 16 (kv_lora, nope,
        rope, v); for ``hybrid`` window 32, ``lru_width`` None and
        ``rec_per_unit + attn_per_unit + 1`` layers (one unit and a
        one-layer tail) in place of 4; ``remat`` "none".
        ``kv_cache_dtype`` and ``prefill_chunks`` are kept."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else n_heads
        if n_kv and n_heads % n_kv:
            n_kv = 1
        return dataclasses.replace(
            self,
            mrope_sections=(2, 3, 3) if self.rope == "mrope" else self.mrope_sections,
            moe=dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_shared=64 if self.moe.num_shared else 0,
                capacity_factor=8.0,
            )
            if self.moe
            else None,
            mla=dataclasses.replace(self.mla, kv_lora_rank=32, qk_nope_head_dim=16,
                                    qk_rope_head_dim=8, v_head_dim=16)
            if self.mla
            else None,
            ssm=dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=32)
            if self.ssm
            else None,
            hybrid=dataclasses.replace(self.hybrid, window=32, lru_width=None)
            if self.hybrid
            else None,
            n_layers=min(self.n_layers, 4)
            if not self.hybrid
            else self.hybrid.rec_per_unit + self.hybrid.attn_per_unit + 1,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=128,
            vocab=512,
            head_dim=16 if self.head_dim is not None else None,
            frontend_dim=32,
            vision_patches=4,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
