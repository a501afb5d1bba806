"""Language models of the port (counterpart of ``repro.models``): the
Mamba-2 ``ssm`` family, the ``dense`` family, ``vlm`` and ``audio``."""
from .attention import Attention, apply_kv_cache_update, init_kv_cache, quantize_kv
from .backbone import VOCAB_CHUNK, Model
from .config import ArchConfig, SSMConfig
from .mamba2 import Mamba2, init_ssm_state
from .mlp import MLP
from .rotary import apply_mrope, apply_rope, rope_freqs, text_mrope_positions

__all__ = ["ArchConfig", "Attention", "MLP", "Mamba2", "Model", "SSMConfig", "VOCAB_CHUNK",
           "apply_kv_cache_update", "apply_mrope", "apply_rope", "init_kv_cache", "init_ssm_state",
           "quantize_kv", "rope_freqs", "text_mrope_positions"]
