"""Language models of the port (counterpart of ``repro.models``): the
Mamba-2 ``ssm`` family so far."""
from .backbone import VOCAB_CHUNK, Model
from .config import ArchConfig, SSMConfig
from .mamba2 import Mamba2, init_ssm_state

__all__ = ["ArchConfig", "Mamba2", "Model", "SSMConfig", "VOCAB_CHUNK", "init_ssm_state"]
