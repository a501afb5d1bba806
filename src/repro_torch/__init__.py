"""PyTorch/CUDA port of the Tao reproduction, for one NVIDIA H100.

The package mirrors the layout of the JAX reference package ``repro``
(``repro_torch/core/model.py`` is the counterpart of
``repro/core/model.py``) and imports neither it nor ``jax``.  The Pallas
TPU kernels on the inference path are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use with ``nvcc`` into
``build/`` at the checkout root and bound with ``ctypes``
(``kernels/_cuda.py``).  Every kernel keeps a plain PyTorch version beside
it; a wrapper takes that plain version only for tensors on the CPU.

Device policy: entry points take ``device=`` and default to ``"cuda"``.
Without CUDA they raise unless the caller asked for ``device="cpu"`` —
there is no silent CPU fallback.  float32 matrix products run at full
precision (TF32 off for matmuls and cuDNN), the precision the parity
tests hold the port to.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for (or
    defaulted to) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
