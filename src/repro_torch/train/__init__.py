"""Training utilities of the port (counterpart of ``repro.train``): the
hand-written AdamW, its global-norm clip and the lr schedule."""
from .optim import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_lr_schedule,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "make_lr_schedule",
]
