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

``qparams_from_jax`` does it for the reference's quantized tree
(``repro/core/quant.py::quantize_tao_params``) and the port's
``core.quant.QuantTao``: int8 leaves (``w_q``, ``table_q``) stay int8 and
untransposed, a quantized layer's ``scale`` keeps its name, ``b`` becomes
``bias``, and the layernorms map as in ``params_from_jax``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["lm_params_from_jax", "params_from_jax", "qparams_from_jax"]

# reference leaf name -> the port's, and the leaves stored (in, out) that
# become nn.Linear weights, transposed
_TAO_LEAVES = {"table": "weight", "w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
_TAO_TRANSPOSED = frozenset({"w"})
_LM_LEAVES = {"table": "weight", "scale": "weight",
              "in_proj": "in_proj.weight", "out_proj": "out_proj.weight"}
_LM_TRANSPOSED = frozenset({"in_proj", "out_proj"})
# the leaves that mark a quantized layer, whose leaves are renamed by
# _QUANT_LEAVES alone (its ``scale`` is the quantization scale, not a
# layernorm's)
_QUANT_MARKS = frozenset({"w_q", "table_q"})
_QUANT_LEAVES = {"b": "bias"}


def _state_dict(np_tree: Mapping, leaf_names: Mapping[str, str],
                transposed: frozenset) -> Dict[str, torch.Tensor]:
    """Walk the tree: dict keys and list indices join with dots, arrays under
    a top-level ``layers`` key are unstacked on their first axis into
    ``layers.{i}``, and each leaf is renamed and transposed as told (in a
    node holding one of ``_QUANT_MARKS``, by ``_QUANT_LEAVES`` alone).
    Integer leaves keep their dtype, the others become float32."""
    out: Dict[str, torch.Tensor] = {}

    def put(path, a, names):
        leaf = path[-1]
        if leaf in transposed:
            a = a.T
        dtype = a.dtype if np.issubdtype(a.dtype, np.integer) else np.float32
        name = ".".join(path[:-1] + [names.get(leaf, leaf)])
        out[name] = torch.from_numpy(np.array(a, dtype=dtype, order="C"))

    def walk(node, path, names):
        if isinstance(node, Mapping):
            sub = _QUANT_LEAVES if _QUANT_MARKS & set(node) else leaf_names
            for k, v in node.items():
                walk(v, path + [str(k)], sub)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)], names)
        elif path[0] == "layers":
            for i, a in enumerate(np.asarray(node)):
                put(["layers", str(i)] + path[1:], a, names)
        else:
            put(path, np.asarray(node), names)

    walk(np_tree, [], leaf_names)
    return out


def params_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference param tree of NumPy arrays -> ``Tao`` state dict (CPU
    float32 tensors); load it with ``model.load_state_dict``."""
    return _state_dict(np_tree, _TAO_LEAVES, _TAO_TRANSPOSED)


def lm_params_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference LM param tree of NumPy arrays (layer axis first under
    ``layers``) -> ``models.Model`` state dict (CPU float32 tensors)."""
    return _state_dict(np_tree, _LM_LEAVES, _LM_TRANSPOSED)


def qparams_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference quantized Tao tree of NumPy arrays -> ``QuantTao`` state
    dict (CPU tensors: int8 codes, float32 scales, biases, norms and
    ``pos``); load it with ``qparams.load_state_dict``."""
    return _state_dict(np_tree, _TAO_LEAVES, _TAO_TRANSPOSED)
