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
stacked on a leading axis: it unstacks ``layers`` into ``layers.{i}``
(and a MoE model's ``dense_layers`` into ``dense_layers.{i}``, a hybrid
model's ``tail`` into ``tail.{i}``; a hybrid unit's ``recs``, stacked
``(n_units, rec_per_unit, …)``, into ``layers.{i}.recs.{j}``) and maps
``table`` / ``scale`` -> ``weight`` (a layernorm's ``bias`` keeps its
name).  The ``(in, out)`` arrays become ``nn.Linear`` weights,
TRANSPOSED: the Mamba-2 mixer's ``in_proj`` / ``out_proj``, the MLP's
``w_up`` / ``w_gate`` / ``w_down``, an untied ``lm_head`` ``(d, V)`` and
the modality stub's ``frontend`` / ``proj`` ``(frontend_dim, d)``, which
becomes ``frontend.proj.weight``.
The dense attention's projections are RESHAPED as well: ``wq`` / ``wk`` /
``wv`` ``(d, H, hd)`` are flattened to ``(d, H·hd)``, transposed and
CONCATENATED along the output axis into the port's packed ``qkv.weight``
(q rows first, then k, then v), ``bq`` / ``bk`` / ``bv`` ``(H, hd)``
flattened and concatenated into ``qkv.bias``, and ``wo`` ``(H, hd, d)``
flattened to ``(H·hd, d)`` and transposed into ``wo.weight``.  An
``attn`` holding ``w_dkv`` is MLA, whose leaves keep their names and
layout (``kv_norm``'s ``scale`` -> ``weight``).  A ``moe`` node (it holds
``router``) keeps its leaves' names and layout: ``router`` (d, E), which
the port keeps float32 in any model, and the experts' ``w_gate`` /
``w_up`` (E, d, f) and ``w_down`` (E, f, d); its ``shared`` experts are
an MLP, mapped as one.  So does an RG-LRU block (it holds ``lambda``):
``w_x``, ``w_gate``, ``conv_w``, ``conv_b``, ``w_r``, ``w_i``,
``lambda`` and ``out``.

``params_to_jax`` is the inverse of ``params_from_jax``: a ``Tao`` state
dict back to the reference's nested tree of NumPy arrays, each layer
named by what its leaves are (a 1-D ``weight`` is a layernorm's
``scale``, a 2-D ``weight`` beside a ``bias`` a dense layer's ``w``,
untransposed, and one without a bias an embedding's ``table``), so that
the tests can compare params trained on both sides.

``qparams_from_jax`` does it for the reference's quantized tree
(``repro/core/quant.py::quantize_tao_params``) and the port's
``core.quant.QuantTao``: int8 leaves (``w_q``, ``table_q``) stay int8 and
untransposed, a quantized layer's ``scale`` keeps its name, ``b`` becomes
``bias``, and the layernorms map as in ``params_from_jax``.
``qparams_to_jax`` is its inverse, bitwise both ways: the layout in which
the artifact store holds a quantized tree that either package reads.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

__all__ = ["lm_params_from_jax", "params_from_jax", "params_to_jax", "qparams_from_jax",
           "qparams_to_jax"]

# reference leaf name -> the port's, and the leaves stored (in, out) that
# become nn.Linear weights, transposed
_TAO_LEAVES = {"table": "weight", "w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
_TAO_TRANSPOSED = frozenset({"w"})
_LM_LINEAR = ("in_proj", "out_proj", "w_up", "w_gate", "w_down", "lm_head", "proj")
_LM_LEAVES = {"table": "weight", "scale": "weight", **{k: f"{k}.weight" for k in _LM_LINEAR}}
_LM_TRANSPOSED = frozenset(_LM_LINEAR)
# the leaves that mark a quantized layer, whose leaves are renamed by
# _QUANT_LEAVES alone (its ``scale`` is the quantization scale, not a
# layernorm's)
_QUANT_MARKS = frozenset({"w_q", "table_q"})
_QUANT_LEAVES = {"b": "bias"}
# the leaves that mark a MoE node and an RG-LRU block, whose leaves keep
# their names and layout
_KEEP_MARKS = frozenset({"router", "lambda"})
# top-level keys whose arrays are stacked layers, and the key under them
# whose arrays are stacked twice (a hybrid unit's recurrent layers)
_STACKED = ("layers", "dense_layers", "tail")
_STACKED_TWICE = "recs"


def _state_dict(np_tree: Mapping, leaf_names: Mapping[str, str],
                transposed: frozenset) -> Dict[str, torch.Tensor]:
    """Walk the tree: dict keys and list indices join with dots, arrays under
    a top-level ``_STACKED`` key are unstacked on their first axis into
    ``{key}.{i}``, and each leaf is renamed and transposed as told (in a
    node holding one of ``_QUANT_MARKS``, renamed by ``_QUANT_LEAVES``
    alone; in a node holding one of ``_KEEP_MARKS``, kept as it is; under
    ``{key}.recs`` unstacked on their first two axes into
    ``{key}.{i}.recs.{j}``).  Integer leaves
    keep their dtype, the others become float32."""
    out: Dict[str, torch.Tensor] = {}

    def put(path, a, names, trans):
        leaf = path[-1]
        if leaf in trans:
            a = a.T
        dtype = a.dtype if np.issubdtype(a.dtype, np.integer) else np.float32
        name = ".".join(path[:-1] + [names.get(leaf, leaf)])
        out[name] = torch.from_numpy(np.array(a, dtype=dtype, order="C"))

    def walk(node, path, names, trans):
        if isinstance(node, Mapping):
            if _QUANT_MARKS & set(node):
                names = _QUANT_LEAVES
            elif _KEEP_MARKS & set(node):
                names, trans = {}, frozenset()
            for k, v in node.items():
                if isinstance(v, Mapping):  # a sub-node is named by its own leaves
                    walk(v, path + [str(k)], leaf_names, transposed)
                else:
                    walk(v, path + [str(k)], names, trans)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)], names, trans)
        elif path[0] in _STACKED:
            for i, a in enumerate(np.asarray(node)):
                if path[1:2] == [_STACKED_TWICE]:
                    for j, b in enumerate(a):
                        put([path[0], str(i), path[1], str(j)] + path[2:], b, names, trans)
                else:
                    put([path[0], str(i)] + path[1:], a, names, trans)
        else:
            put(path, np.asarray(node), names, trans)

    walk(np_tree, [], leaf_names, transposed)
    return out


def params_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference param tree of NumPy arrays -> ``Tao`` state dict (CPU
    float32 tensors); load it with ``model.load_state_dict``."""
    return _state_dict(np_tree, _TAO_LEAVES, _TAO_TRANSPOSED)


def params_to_jax(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> Dict:
    """``Tao`` module or state dict -> the reference's param tree of NumPy
    float32 arrays (``blocks`` a list); ``params_from_jax`` of it gives the
    state dict back bitwise.  A quantized layer (one of ``_QUANT_MARKS``
    among its leaves) keeps its leaf names but ``bias`` -> ``b``."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    layers: Dict[tuple, Dict[str, np.ndarray]] = {}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        layers.setdefault(tuple(path), {})[leaf] = t.detach().cpu().numpy()
    tree: Dict = {}
    for path, leaves in layers.items():
        w = leaves.get("weight")
        if _QUANT_MARKS & set(leaves):
            node = {("b" if k == "bias" else k): v for k, v in leaves.items()}
        elif w is None:
            node = dict(leaves)  # bare parameters (``pos``) keep their names
        elif w.ndim == 1:
            node = {"scale": w, "bias": leaves["bias"]}
        elif "bias" in leaves:
            node = {"w": np.ascontiguousarray(w.T), "b": leaves["bias"]}
        else:
            node = {"table": w}
        parent = tree
        for key in path:
            parent = parent.setdefault(key, {})
        parent.update(node)
    return _lists(tree)


def _lists(node):
    """Nested dicts whose keys are all indices become lists, in order."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def lm_params_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference LM param tree of NumPy arrays (layer axis first under
    ``layers``) -> ``models.Model`` state dict (CPU float32 tensors)."""
    sd = _state_dict(np_tree, _LM_LEAVES, _LM_TRANSPOSED)
    for name in [n for n in sd if n.endswith(".attn.wq")]:
        pre = name[: -len("wq")]
        if pre + "w_dkv" in sd:  # MLA: its leaves are the port's as they are
            continue
        wq, wk, wv, wo = (sd.pop(pre + w) for w in ("wq", "wk", "wv", "wo"))
        sd[pre + "qkv.weight"] = torch.cat([w.flatten(1).T for w in (wq, wk, wv)]).contiguous()
        sd[pre + "wo.weight"] = wo.flatten(0, 1).T.contiguous()
        if pre + "bq" in sd:
            sd[pre + "qkv.bias"] = torch.cat([sd.pop(pre + b).flatten() for b in ("bq", "bk", "bv")])
    return sd


def qparams_from_jax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Reference quantized Tao tree of NumPy arrays -> ``QuantTao`` state
    dict (CPU tensors: int8 codes, float32 scales, biases, norms and
    ``pos``); load it with ``qparams.load_state_dict``."""
    return _state_dict(np_tree, _TAO_LEAVES, _TAO_TRANSPOSED)


def qparams_to_jax(qparams: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> Dict:
    """``QuantTao`` module or state dict -> the reference's quantized tree
    of NumPy arrays (int8 codes, float32 scales, biases, norms and
    ``pos``); ``qparams_from_jax`` of it gives the state dict back
    bitwise."""
    return params_to_jax(qparams)
