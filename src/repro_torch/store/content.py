"""Content addressing for the artifact store.

Counterpart of ``repro/store/content.py`` (NumPy and hashlib only), giving
the same keys for the same content.  One identity scheme for everything
the store holds: a blake2b digest over the *content* of an object (arrays
hashed as dtype + shape + raw bytes, configs as a canonical recursive
token), never over object identity or repr strings.  ``FeatureSet.digest``
and the store's on-disk keys derive from here.

A torch tensor hashes as its host NumPy view; a ``torch.bfloat16`` tensor
under the dtype string an ``ml_dtypes`` bfloat16 array gives (``"<V2"``),
so a bfloat16 leaf digests as the reference's does.  ``config_token``
keeps a dataclass's *type name* and fields: the port's ``FeatureConfig``,
which has the reference's name and fields, keys the same; the port's
``TaoConfig``, which has no ``use_pallas``, keys differently.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Tuple, Union

import numpy as np
import torch

__all__ = [
    "DIGEST_BYTES",
    "array_digest",
    "config_token",
    "content_key",
    "tree_digest",
]

# blake2b digest width — matches iter_window_digests (core/dataset.py),
# which pins 16 bytes as plenty for dedup at any realistic trace count.
DIGEST_BYTES = 16

# np.dtype(ml_dtypes.bfloat16).str: what the reference hashes a bf16 leaf as
_BF16_DTYPE_STR = "<V2"


def array_digest(arr: Union[np.ndarray, torch.Tensor]) -> str:
    """Stable hex digest of an array's dtype, shape, and raw bytes.

    Works for structured arrays (functional traces) and bfloat16 leaves
    (``torch.bfloat16`` tensors, ``ml_dtypes`` arrays) alike: the dtype
    enters the hash via ``np.dtype.str`` / ``descr`` so e.g. an int32 and
    a float32 view of the same bytes get different digests.
    """
    dtype_str = None
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:  # no NumPy dtype: its 2-byte words
            arr, dtype_str = arr.contiguous().view(torch.int16).numpy(), _BF16_DTYPE_STR
        else:
            arr = arr.numpy()
    arr = np.asarray(arr)
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    if arr.dtype.names:  # structured dtype: .str is opaque ("|V35")
        h.update(repr(arr.dtype.descr).encode())
    else:
        h.update((dtype_str or arr.dtype.str).encode())
    h.update(repr(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def tree_digest(tree: Any) -> str:
    """Digest of a nested dict/list/tuple pytree of arrays (params trees).

    Structure and leaf positions are part of the hash; device tensors are
    pulled to the host.
    """
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (("k", k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (("i", i),))
        elif node is None:
            h.update(repr((path, None)).encode())
        else:
            h.update(repr(path).encode())
            h.update(array_digest(node).encode())

    walk(tree, ())
    return h.hexdigest()


def config_token(obj: Any) -> Tuple:
    """Canonical, hashable, order-stable token of a config-like value.

    Recurses through dataclasses (field order), dicts (sorted keys),
    tuples/lists; arrays collapse to their ``array_digest``.  The token is
    what ``content_key`` serializes, so two configs compare equal iff
    their tokens do — object identity and repr formatting never leak in.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (
            "dc",
            type(obj).__name__,
            tuple(
                (f.name, config_token(getattr(obj, f.name)))
                for f in dataclasses.fields(obj)
            ),
        )
    if isinstance(obj, dict):
        return ("d", tuple((k, config_token(v)) for k, v in sorted(obj.items())))
    if isinstance(obj, (tuple, list)):
        return ("t", tuple(config_token(v) for v in obj))
    if isinstance(obj, np.ndarray):
        return ("nd", array_digest(obj))
    if isinstance(obj, (str, bytes, bool, type(None))):
        return obj
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        # repr round-trips float64 exactly; avoids 0.1 vs 0.1000...01 drift
        return ("f", repr(float(obj)))
    raise TypeError(
        f"config_token: cannot canonicalize {type(obj).__name__!r} — "
        "pass dataclasses, dicts, sequences, arrays, or primitives"
    )


def content_key(kind: str, *parts: Any) -> str:
    """The store key for an object: blake2b over (kind, token(parts)).

    ``kind`` namespaces the key ("trace", "features", "params", ...) so
    identical payload tokens of different kinds never collide.
    """
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    h.update(repr((kind, tuple(config_token(p) for p in parts))).encode())
    return h.hexdigest()
