"""Training utilities of the port (counterpart of ``repro.train``): the
hand-written AdamW, its global-norm clip, the lr schedule, the LLM
trainer (``TrainConfig``, ``TrainState``, ``init_state``,
``make_train_step``) and the process-wide train-step cache of the Tao
trainers (one CUDA graph per geometry on the card)."""
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
    TrainConfig,
    TrainState,
    batch_axes,
    cache_stats,
    cached_train_step,
    clear_train_step_cache,
    init_state,
    make_train_step,
    restore_into,
    state_axes,
    state_shardings,
    train_step_compiles,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "CachedTrainStep",
    "TrainConfig",
    "TrainState",
    "adamw_init",
    "adamw_update",
    "batch_axes",
    "cache_stats",
    "cached_train_step",
    "clear_train_step_cache",
    "clip_by_global_norm",
    "init_state",
    "make_lr_schedule",
    "make_train_step",
    "restore_into",
    "state_axes",
    "state_shardings",
    "train_step_compiles",
]
