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

``lm_params_from_jax`` does the same for the reference's language-model
tree (``repro/models/backbone.py::Model.init``), whose layer params are
stacked on a leading axis: it unstacks them into ``layers.{i}``, maps
``table`` / ``scale`` -> ``weight`` and the mixer's ``in_proj`` /
``out_proj`` ``(in, out)`` arrays to ``nn.Linear`` weights, transposed.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["lm_params_from_jax", "params_from_jax"]

# reference leaf name -> the port's, and the leaves stored (in, out) that
# become nn.Linear weights, transposed
_TAO_LEAVES = {"table": "weight", "w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
_TAO_TRANSPOSED = frozenset({"w"})
_LM_LEAVES = {"table": "weight", "scale": "weight",
              "in_proj": "in_proj.weight", "out_proj": "out_proj.weight"}
_LM_TRANSPOSED = frozenset({"in_proj", "out_proj"})


def _state_dict(np_tree: Mapping, leaf_names: Mapping[str, str],
                transposed: frozenset) -> Dict[str, torch.Tensor]:
    """Walk the tree: dict keys and list indices join with dots, arrays under
    a top-level ``layers`` key are unstacked on their first axis into
    ``layers.{i}``, and each leaf is renamed and transposed as told."""
    out: Dict[str, torch.Tensor] = {}

    def put(path, a):
        leaf = path[-1]
        if leaf in transposed:
            a = a.T
        name = ".".join(path[:-1] + [leaf_names.get(leaf, leaf)])
        out[name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif path[0] == "layers":
            for i, a in enumerate(np.asarray(node)):
                put(["layers", str(i)] + path[1:], a)
        else:
            put(path, np.asarray(node))

    walk(np_tree, [])
    return out


def params_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference param tree of NumPy arrays -> ``Tao`` state dict (CPU
    float32 tensors); load it with ``model.load_state_dict``."""
    return _state_dict(np_tree, _TAO_LEAVES, _TAO_TRANSPOSED)


def lm_params_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference LM param tree of NumPy arrays (layer axis first under
    ``layers``) -> ``models.Model`` state dict (CPU float32 tensors)."""
    return _state_dict(np_tree, _LM_LEAVES, _LM_TRANSPOSED)
