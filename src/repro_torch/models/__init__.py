"""Language models of the port (counterpart of ``repro.models``): the
Mamba-2 ``ssm`` family, the ``dense`` family, ``vlm``, ``audio``,
``moe`` (MoE MLPs, and MLA attention) and ``hybrid`` (RG-LRU and local
attention)."""
from .attention import (
    MLA,
    Attention,
    apply_kv_cache_update,
    apply_mla_cache_update,
    flash_ref,
    init_kv_cache,
    init_mla_cache,
    quantize_kv,
)
from .backbone import VOCAB_CHUNK, Model
from .config import ArchConfig, HybridConfig, MLAConfig, MoEConfig, SSMConfig
from .mamba2 import Mamba2, init_ssm_state
from .mlp import MLP
from .moe import MoE
from .rglru import RGLRU, init_rglru_state, linear_scan
from .rotary import apply_mrope, apply_rope, rope_freqs, text_mrope_positions

__all__ = ["ArchConfig", "Attention", "HybridConfig", "MLA", "MLAConfig", "MLP", "Mamba2", "Model",
           "MoE", "MoEConfig", "RGLRU", "SSMConfig", "VOCAB_CHUNK", "apply_kv_cache_update",
           "apply_mla_cache_update", "apply_mrope", "apply_rope", "flash_ref", "init_kv_cache",
           "init_mla_cache", "init_rglru_state", "init_ssm_state", "linear_scan", "quantize_kv",
           "rope_freqs", "text_mrope_positions"]
