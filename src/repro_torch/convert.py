"""Weights from the reference's param tree to the port's modules.

``jax.random`` initialization cannot be reproduced in torch, so weights
cross from the reference as data: the reference's nested param dict, its
leaves as NumPy arrays (``jax.tree.map(np.asarray, params)``), becomes a
state dict for ``core.model.Tao``.  The paths are the same; the leaf names
map ``table`` -> ``weight`` (embeddings), ``w`` -> ``weight`` TRANSPOSED
(the reference applies a dense layer as ``x @ w`` with ``w`` (in, out);
``nn.Linear`` stores (out, in)), ``b`` -> ``bias``, and the layernorm's
``scale`` / ``bias`` -> ``weight`` / ``bias``; lists (``blocks``) index
like ``nn.ModuleList``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]

_LEAF_NAMES = {"table": "weight", "w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}


def params_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference param tree of NumPy arrays -> ``Tao`` state dict (CPU
    float32 tensors); load it with ``model.load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            a = np.asarray(node, dtype=np.float32)
            leaf = path[-1]
            if leaf == "w":
                a = a.T
            name = ".".join(path[:-1] + [_LEAF_NAMES.get(leaf, leaf)])
            out[name] = torch.from_numpy(np.array(a, copy=True, order="C"))

    walk(np_tree, [])
    return out
