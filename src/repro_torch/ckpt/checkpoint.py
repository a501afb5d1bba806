"""Crash-consistent checkpointing with async writes and auto-resume.

Counterpart of ``repro/ckpt/checkpoint.py``, without JAX.  Trees are nested
dicts, lists and tuples (and, for ``save_pytree`` only, NamedTuples) whose
leaves are NumPy arrays, NumPy or Python scalars, or torch tensors on any
device.  They are walked in ``jax.tree_util``'s order — dict keys sorted,
sequences in order, ``None`` dropped — so one tree gives the same
``manifest.json`` and the same ``arr_{i}.bin`` numbering from both
packages, byte for byte.

Layout: ``<dir>/step_<N>/`` holding one raw ``.bin`` per leaf plus a
manifest; a step directory is written under a tmp name and renamed on
commit, so a crash mid-write never corrupts the latest checkpoint, and
restore picks the newest *committed* step.

bfloat16 without ``ml_dtypes``: a ``torch.bfloat16`` tensor is written as
its raw 2-byte words under the reference's dtype record ``"bfloat16"``,
and such a record is read back as a CPU ``torch.bfloat16`` tensor (the
``uint16`` words viewed as bfloat16).  Every other dtype comes back as a
NumPy array; structured dtypes (functional traces) through their
``descr``, as in the reference.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "save_pytree",
    "restore_pytree",
    "save_array_tree",
    "load_array_tree",
    "write_array_tree",
    "read_extra",
    "latest_step",
    "CheckpointManager",
]

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"

Leaf = Union[np.ndarray, torch.Tensor]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path``'s
    order: dict keys sorted, sequences in order, NamedTuple fields in
    order, ``None`` dropped (an empty subtree).  A path entry is
    ``("k", key)``, ``("i", index)`` or ``("a", field name)``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (("k", k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), path + (("a", name),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (("i", i),))
    else:
        yield path, tree


def _rebuild(template, leaves: Iterator):
    """``template``'s structure with its leaves taken from ``leaves`` in
    ``_walk``'s order (dicts come back with sorted keys, as
    ``jax.tree_util.tree_unflatten`` builds them)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f), leaves) for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    return _rebuild(tree, (fn(leaf) for _, leaf in _walk(tree)))


def _path_key(path: Tuple) -> str:
    # the reference's string key: each entry's key / index / field name
    return "/".join(str(p[1]) for p in path)


def _host(leaf) -> Tuple[np.ndarray, Union[str, list]]:
    """A leaf as a host NumPy array of its bytes and its dtype record:
    ``descr`` for a structured dtype, else the dtype's name (a bfloat16
    tensor: its 2-byte words as ``uint16`` under ``"bfloat16"``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, (arr.dtype.descr if arr.dtype.names else str(arr.dtype))


def _dtype_from_record(rec) -> np.dtype:
    """The NumPy dtype a record's bytes are read as (``uint16`` words for
    bfloat16, viewed as ``torch.bfloat16`` by ``_read_leaf``)."""
    if isinstance(rec, list):
        return np.dtype([tuple(x) for x in rec])
    if rec == _BF16:
        return np.dtype(np.uint16)
    return np.dtype(rec)


def _write_bin(directory: str, fname: str, arr: np.ndarray) -> None:
    with open(os.path.join(directory, fname), "wb") as f:
        f.write(np.ascontiguousarray(arr).tobytes())


def _read_leaf(directory: str, rec: Dict) -> Leaf:
    """One array file as its record says; raises ``ValueError`` when the
    file holds another number of bytes than the record's shape needs."""
    dtype = _dtype_from_record(rec["dtype"])
    with open(os.path.join(directory, rec["file"]), "rb") as f:
        buf = f.read()
    expect = int(np.prod(rec["shape"], dtype=np.int64)) * dtype.itemsize
    if len(buf) != expect:
        raise ValueError(
            f"truncated array file {rec['file']} in {directory}: "
            f"{len(buf)} bytes, expected {expect}"
        )
    arr = np.frombuffer(buf, dtype=dtype).reshape(rec["shape"]).copy()
    if rec["dtype"] == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def save_pytree(tree, directory: str, extra: Optional[Dict] = None) -> None:
    """Atomic: writes to <dir>.tmp then renames."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    names = {}
    for i, (path, leaf) in enumerate(_walk(tree)):
        arr, rec = _host(leaf)
        fname = f"arr_{i}.bin"
        _write_bin(tmp, fname, arr)
        # the reference records str(dtype) here, structured dtypes included
        names[_path_key(path)] = {
            "file": fname,
            "dtype": rec if isinstance(rec, str) else str(arr.dtype),
            "shape": list(arr.shape),
        }
    manifest = {"arrays": names, "extra": extra or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _like(arr: Leaf, leaf) -> Leaf:
    """A restored array on ``leaf``'s device and in its dtype: a torch
    tensor for a tensor leaf, a NumPy array for an array leaf, as read for
    anything else."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray) and not isinstance(arr, torch.Tensor):
        return arr.astype(leaf.dtype, copy=False)
    return arr


def restore_pytree(template, directory: str):
    """Restore into the structure of ``template``: each leaf comes back on
    its template leaf's device and in its dtype (the reference's sharding
    stands here as the device; the port is single-device)."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = []
    for path, leaf in _walk(template):
        rec = manifest["arrays"][_path_key(path)]
        leaves.append(_like(_read_leaf(directory, rec), leaf))
    return _rebuild(template, iter(leaves))


# ---------------------------------------------------------------------------
# Template-free (typed-path) tree serialization.
#
# ``save_pytree``/``restore_pytree`` flatten paths to strings, which is fine
# when the reader holds a template of the tree but ambiguous without one:
# "pred/blocks/0" cannot say whether ``blocks`` is a dict with key "0" or a
# list.  The artifact store restores trees in processes that never built
# the model, so these variants record each path segment *typed* —
# ["k", name] for a dict key, ["i", idx] for a sequence index — and rebuild
# the exact container structure on load.  None leaves are not representable
# (the walk drops them); trees holding None must encode absence as a
# missing dict key instead.
# ---------------------------------------------------------------------------


def _typed_paths(tree) -> List[Tuple[List, Leaf]]:
    recs = []
    for path, leaf in _walk(tree):
        for kind, name in path:
            if kind == "a":
                raise TypeError(
                    f"typed-path serialization supports dict/list/tuple "
                    f"trees only; cannot encode path entry {name!r}"
                )
        recs.append(([[kind, name] for kind, name in path], leaf))
    return recs


def write_array_tree(tree, directory: str, extra: Optional[Dict] = None) -> None:
    """Write a typed-path manifest + raw array files directly into
    ``directory`` (caller owns atomicity — see ``save_array_tree`` for the
    tmp-and-rename variant)."""
    os.makedirs(directory, exist_ok=True)
    arrays = []
    for i, (tp, leaf) in enumerate(_typed_paths(tree)):
        arr, rec = _host(leaf)
        fname = f"arr_{i}.bin"
        _write_bin(directory, fname, arr)
        arrays.append(
            {
                "path": tp,
                "file": fname,
                "dtype": rec,
                "shape": list(arr.shape),
                "bytes": int(arr.nbytes),
            }
        )
    manifest = {"format": "typed-paths-v1", "arrays": arrays, "extra": extra or {}}
    tmp_manifest = os.path.join(directory, _MANIFEST + ".tmp")
    with open(tmp_manifest, "w") as f:
        json.dump(manifest, f)
    # manifest lands last and atomically: a partial write is detectable as
    # "no manifest" rather than a truncated one
    os.replace(tmp_manifest, os.path.join(directory, _MANIFEST))


def save_array_tree(tree, directory: str, extra: Optional[Dict] = None) -> None:
    """Atomic template-free save: typed paths, raw bytes, tmp-then-rename."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    write_array_tree(tree, tmp, extra)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_array_tree(directory: str):
    """Rebuild ``(tree, extra)`` from a typed-path manifest — no template.

    Raises (FileNotFoundError / json / ValueError) on missing, truncated,
    or inconsistent entries; the artifact store treats any failure here as
    a cache miss and drops the entry.
    """
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != "typed-paths-v1":
        raise ValueError(f"not a typed-path tree: {directory}")
    leaves = [
        (tuple(tuple(p) for p in rec["path"]), _read_leaf(directory, rec))
        for rec in manifest["arrays"]
    ]

    if not leaves:  # extra-only entry (e.g. a ground-truth summary)
        return {}, manifest.get("extra", {})
    if len(leaves) == 1 and not leaves[0][0]:  # single leaf at the root
        return leaves[0][1], manifest.get("extra", {})

    root: Dict = {}
    for path, arr in leaves:
        node = root
        for depth, seg in enumerate(path):
            if depth == len(path) - 1:
                node[tuple(seg)] = arr
            else:
                node = node.setdefault(tuple(seg), {})

    def finalize(node):
        if not isinstance(node, dict):
            return node
        tags = {t for t, _ in node}
        if tags == {"i"}:
            idxs = sorted(k for _, k in node)
            if idxs != list(range(len(idxs))):
                raise ValueError(f"non-contiguous sequence indices {idxs}")
            return [finalize(node[("i", i)]) for i in idxs]
        if tags != {"k"}:
            raise ValueError(f"mixed container tags {tags} in typed-path tree")
        return {k: finalize(v) for (_, k), v in sorted(node.items())}

    return finalize(root), manifest.get("extra", {})


def read_extra(directory: str) -> Dict:
    with open(os.path.join(directory, _MANIFEST)) as f:
        return json.load(f)["extra"]


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _host_copy(leaf):
    """A host copy of one leaf, which the caller may overwrite afterwards
    (the port's optimizer updates parameters in place)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class CheckpointManager:
    """Async checkpointing with bounded retention + preemption hook."""

    def __init__(self, root: str, keep: int = 3, use_async: bool = True):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._async = use_async
        if use_async:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                tree, step, extra = item
                self._save_now(tree, step, extra)
            except BaseException as e:  # surfaced on next save()
                self._err = e
            finally:
                self._q.task_done()

    def _save_now(self, tree, step: int, extra):
        save_pytree(tree, os.path.join(self.root, f"step_{step}"), extra)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"), ignore_errors=True)

    def save(self, tree, step: int, extra: Optional[Dict] = None, block: bool = False):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err
        # host copies before enqueueing: the training loop overwrites its
        # tensors (in place, here) after this point
        host_tree = _tree_map(_host_copy, tree)
        if self._async and not block:
            self._q.put((host_tree, step, extra))
        else:
            self._save_now(host_tree, step, extra)

    def restore_latest(self, template):
        step = latest_step(self.root)
        if step is None:
            return None, None
        d = os.path.join(self.root, f"step_{step}")
        return restore_pytree(template, d), {"step": step, **read_extra(d)}

    def wait(self):
        if self._async:
            self._q.join()

    def close(self):
        if self._async:
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=5)
