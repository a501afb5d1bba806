"""Architecture configuration of the port's language models.

Counterpart of ``repro/models/config.py``, cut to the fields the ported
``ssm`` (Mamba-2) family reads.  The reference's ``use_pallas``,
``remat``, ``scan_layers`` and ``prefill_chunks`` are left out: the port
always launches its SSD kernel on the card, runs eagerly and does not
rematerialize.  So are ``norm`` and ``tie_embeddings``: every ``ssm``
config of the reference uses rmsnorm and a head tied to the embedding,
and the port's ``Model`` builds exactly that.  ``reduced()`` gives the
reference's smoke-test numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SSMConfig", "ArchConfig"]


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
class ArchConfig:
    name: str
    family: str                      # only "ssm" is ported (ROADMAP A10)
    n_layers: int
    d_model: int
    vocab: int
    ssm: Optional[SSMConfig] = None
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU tests (the reference's
        numbers: 4 layers, d_model 64, vocab 512, float32; for ``ssm``
        d_state 16, head_dim 16, chunk 32)."""
        return dataclasses.replace(
            self,
            ssm=dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=32)
            if self.ssm
            else None,
            n_layers=min(self.n_layers, 4),
            d_model=64,
            vocab=512,
            param_dtype="float32",
            compute_dtype="float32",
        )
