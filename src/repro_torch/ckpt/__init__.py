"""Checkpoints and the typed-path array trees the artifact store
serializes through (PyTorch port of ``repro.ckpt``)."""
from .checkpoint import (
    CheckpointManager,
    latest_step,
    load_array_tree,
    read_extra,
    restore_pytree,
    save_array_tree,
    save_pytree,
    write_array_tree,
)

__all__ = [
    "CheckpointManager",
    "save_pytree",
    "restore_pytree",
    "save_array_tree",
    "load_array_tree",
    "write_array_tree",
    "read_extra",
    "latest_step",
]
