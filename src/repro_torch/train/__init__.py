"""Training utilities of the port (counterpart of ``repro.train``): the
hand-written AdamW, its global-norm clip, the lr schedule, and the
process-wide train-step cache (one CUDA graph per geometry on the card)."""
from .optim import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_lr_schedule,
)
from .trainer import (
    CachedTrainStep,
    cache_stats,
    cached_train_step,
    clear_train_step_cache,
    train_step_compiles,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "CachedTrainStep",
    "adamw_init",
    "adamw_update",
    "cache_stats",
    "cached_train_step",
    "clear_train_step_cache",
    "clip_by_global_norm",
    "make_lr_schedule",
    "train_step_compiles",
]
