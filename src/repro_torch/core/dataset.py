"""Windowing of extracted features into fixed-shape model batches (NumPy).

The port's copy of ``repro/core/dataset.py``: the model consumes windows
of W = N+1 instructions, built as zero-copy strided views.  Inference
materializes them one padded batch at a time (``stream_batches``);
training either stacks them into a ``WindowDataset`` (``build_windows``)
or keeps only the views and the kept indices (``StreamingWindowDataset``,
O(trace + batch) host memory), dropping windows whose bytes repeat
(blake2b digests of the same contiguous rows the reference hashes, so the
keep-set is the reference's), and draws shuffled batches from a NumPy
``Generator``, in the reference's order for the same generator state —
the same stream from either dataset.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .features import FeatureSet

__all__ = [
    "INPUT_KEYS",
    "StreamingWindowDataset",
    "WindowDataset",
    "build_windows",
    "concat_datasets",
    "iter_window_digests",
    "num_windows",
    "stream_batches",
    "window_view",
]

INPUT_KEYS = ("opcode", "regbits", "flags", "brhist", "memdist")
_LABEL_KEYS = (
    "fetch_lat",
    "exec_lat",
    "mispred",
    "dlevel",
    "icache_miss",
    "tlb_miss",
    "is_branch",
    "is_mem",
)


def num_windows(n: int, window: int, stride: int) -> int:
    """Number of windows the grid ``range(0, max(1, n - window + 1), stride)``
    produces — the single source of truth shared by every windowing path."""
    return len(range(0, max(1, n - window + 1), stride))


def window_view(arr: np.ndarray, window: int, stride: int) -> np.ndarray:
    """(N, ...) -> zero-copy (num_windows, window, ...) strided view; a trace
    shorter than the window gives one truncated window."""
    if len(arr) < window:
        return arr[np.newaxis]
    view = np.lib.stride_tricks.sliding_window_view(arr, window, axis=0)
    # sliding_window_view appends the window axis last; put it after the
    # window-count axis (still a view — only strides change)
    view = np.moveaxis(view, -1, 1)
    return view[::stride]


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def stream_batches(
    fs: FeatureSet,
    window: int,
    batch_size: int,
    stride: Optional[int] = None,
    pad: bool = True,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape window batches without materializing all windows.

    Every batch carries a float32 ``valid`` mask of shape (batch_size, W);
    with ``pad`` the final ragged batch is zero-padded to ``batch_size``
    rows (mask rows 0).  ``extra`` arrays (the trace's is_branch / is_mem
    columns) are windowed on the same grid and yielded alongside.
    """
    stride = stride or window
    views = {k: window_view(getattr(fs, k), window, stride) for k in INPUT_KEYS}
    if extra:
        views.update({k: window_view(v, window, stride) for k, v in extra.items()})
    nw = len(views["opcode"])
    w_eff = views["opcode"].shape[1]
    for lo in range(0, nw, batch_size):
        hi = min(lo + batch_size, nw)
        rows = batch_size if pad else hi - lo
        batch = {k: _pad_rows(v[lo:hi], rows) for k, v in views.items()}
        valid = np.zeros((rows, w_eff), dtype=np.float32)
        valid[: hi - lo] = 1.0
        batch["valid"] = valid
        yield batch


@dataclasses.dataclass
class WindowDataset:
    """Stacked windows: inputs[k] has shape (num_windows, W, ...)."""

    inputs: Dict[str, np.ndarray]
    labels: Optional[Dict[str, np.ndarray]]

    def __len__(self) -> int:
        return len(self.inputs["opcode"])

    @property
    def window(self) -> int:
        return self.inputs["opcode"].shape[1]

    def batches(
        self, batch_size: int, rng: Optional[np.random.Generator] = None, drop_last: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of ``batch_size`` windows (a ``labels`` dict beside the
        inputs), in an order shuffled by ``rng`` when one is given."""
        n = len(self)
        order = np.arange(n)
        if rng is not None:
            rng.shuffle(order)
        stop = n - (n % batch_size) if drop_last else n
        for lo in range(0, stop, batch_size):
            idx = order[lo : lo + batch_size]
            out = {k: v[idx] for k, v in self.inputs.items()}
            if self.labels is not None:
                out["labels"] = {k: v[idx] for k, v in self.labels.items()}
            yield out

    def subsample(self, n: int, seed: int = 0) -> "WindowDataset":
        """``n`` windows drawn without replacement (all when ``n`` >= len)."""
        if n >= len(self):
            return self
        idx = np.random.default_rng(seed).choice(len(self), size=n, replace=False)
        return WindowDataset(
            inputs={k: v[idx] for k, v in self.inputs.items()},
            labels=None if self.labels is None else {k: v[idx] for k, v in self.labels.items()},
        )


def build_windows(
    fs: FeatureSet,
    window: int,
    stride: Optional[int] = None,
    dedup: bool = True,
) -> WindowDataset:
    """Every window of the trace on the grid of ``window_view`` (labels
    too when ``fs`` has them), byte-identical windows dropped."""
    stride = stride or window
    inputs = {k: window_view(getattr(fs, k), window, stride) for k in INPUT_KEYS}
    labels = None
    if fs.labels is not None:
        labels = {k: window_view(fs.labels[k], window, stride) for k in _LABEL_KEYS}
    if dedup:
        keep = _dedup_mask(inputs, labels)
        inputs = {k: v[keep] for k, v in inputs.items()}
        if labels is not None:
            labels = {k: v[keep] for k, v in labels.items()}
    return WindowDataset(inputs=inputs, labels=labels)


# windows hashed per contiguous block by iter_window_digests
_DEDUP_CHUNK = 2048


def iter_window_digests(
    inputs: Dict, labels: Optional[Dict], chunk: int = _DEDUP_CHUNK
) -> Iterator[bytes]:
    """Per-window 16-byte blake2b digest of the window's bytes: opcode,
    memdist, brhist, then fetch / exec latencies when labels are present,
    each in C order.  ``chunk`` windows at a time are copied into one
    (rows, row_bytes) uint8 matrix and each row hashed in one call, so the
    strided views are never materialized whole."""
    arrays = [inputs["opcode"], inputs["memdist"], inputs["brhist"]]
    if labels is not None:
        arrays += [labels["fetch_lat"], labels["exec_lat"]]
    n = len(arrays[0])
    row_bytes = [a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64)) for a in arrays]
    total = sum(row_bytes)
    blake2b = hashlib.blake2b
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = hi - lo
        buf = np.empty((rows, total), np.uint8)
        col = 0
        for a, rb in zip(arrays, row_bytes):
            blk = np.ascontiguousarray(a[lo:hi])
            buf[:, col : col + rb] = blk.view(np.uint8).reshape(rows, rb)
            col += rb
        mv = memoryview(buf).cast("B")
        for i in range(rows):
            yield blake2b(mv[i * total : (i + 1) * total], digest_size=16).digest()


def _dedup_mask(inputs: Dict, labels: Optional[Dict], seen: Optional[set] = None) -> np.ndarray:
    """True for the first window of each distinct digest.  ``seen`` — a
    digest reservoir (16 B per unique window) — carries the keep-set across
    calls; by default each call dedups on its own."""
    if seen is None:
        seen = set()
    keep = np.zeros(len(inputs["opcode"]), dtype=bool)
    for i, d in enumerate(iter_window_digests(inputs, labels)):
        if d not in seen:
            seen.add(d)
            keep[i] = True
    return keep


@dataclasses.dataclass
class _StreamPart:
    """One trace's zero-copy window views (and label views)."""

    inputs: Dict[str, np.ndarray]
    labels: Optional[Dict[str, np.ndarray]]


class StreamingWindowDataset:
    """O(trace + batch) stand-in for ``WindowDataset`` over 1..N feature
    sets.

    It keeps zero-copy ``window_view``s of the ``FeatureSet`` arrays and
    the kept window indices (the dedup's digest reservoir, bit-identical
    to ``_dedup_mask``'s keep-set).  ``batches`` shuffles a window-index
    permutation and gathers each batch from the views, so nothing beyond
    the yielded batch is materialized; its stream is bit-identical to
    ``WindowDataset.batches`` for the same rng.

    ``dedup_scope="trace"`` (default) dedups each feature set on its own,
    as ``concat_datasets`` of per-trace ``build_windows`` does, so the
    keep-set, the batch stream and a training run equal the materialized
    path's; ``"global"`` shares one reservoir across traces.  Every trace
    must give one window geometry (a train step is captured per
    geometry).  ``materialize()`` copies every kept window into a
    ``WindowDataset``.
    """

    def __init__(
        self,
        features,
        window: int,
        stride: Optional[int] = None,
        dedup: bool = True,
        dedup_scope: str = "trace",
    ):
        if isinstance(features, FeatureSet):
            features = [features]
        features = list(features)
        if not features:
            raise ValueError("StreamingWindowDataset needs >= 1 FeatureSet")
        if dedup_scope not in ("trace", "global"):
            raise ValueError(f"dedup_scope must be 'trace' or 'global', got {dedup_scope!r}")
        stride = stride or window
        has_labels = features[0].labels is not None
        parts: List[_StreamPart] = []
        for fs in features:
            if (fs.labels is not None) != has_labels:
                raise ValueError("all feature sets of one dataset must agree on labels")
            inputs = {k: window_view(getattr(fs, k), window, stride) for k in INPUT_KEYS}
            labels = None
            if has_labels:
                labels = {k: window_view(fs.labels[k], window, stride) for k in _LABEL_KEYS}
            parts.append(_StreamPart(inputs=inputs, labels=labels))
        # the geometry before the dedup: views are free, hashing is not
        w_effs = {p.inputs["opcode"].shape[1] for p in parts}
        if len(w_effs) != 1:
            raise ValueError(
                f"feature sets produce mixed effective windows {sorted(w_effs)}: every "
                "trace of one dataset must share a window geometry (the train step is "
                "captured per geometry)"
            )
        keeps: List[np.ndarray] = []
        reservoir: set = set()
        for part in parts:
            if dedup:
                seen = reservoir if dedup_scope == "global" else set()
                keep = np.flatnonzero(_dedup_mask(part.inputs, part.labels, seen=seen))
            else:
                keep = np.arange(len(part.inputs["opcode"]), dtype=np.int64)
            keeps.append(keep.astype(np.int64))
        self._parts = parts
        # flat kept-window index -> (part, local window): O(windows)
        # integers, the only per-window state kept
        self._part_id = np.concatenate([np.full(len(k), i, np.int32) for i, k in enumerate(keeps)])
        self._local = np.concatenate(keeps)
        self.num_dropped = sum(len(p.inputs["opcode"]) for p in parts) - len(self._local)

    def __len__(self) -> int:
        return len(self._local)

    @property
    def window(self) -> int:
        return self._parts[0].inputs["opcode"].shape[1]

    @property
    def has_labels(self) -> bool:
        return self._parts[0].labels is not None

    @staticmethod
    def _gather_key(views: List[np.ndarray], part_id: np.ndarray, local: np.ndarray) -> np.ndarray:
        if len(views) == 1:
            return views[0][local]
        out = np.empty((len(part_id),) + views[0].shape[1:], dtype=views[0].dtype)
        for p in np.unique(part_id):
            m = part_id == p
            out[m] = views[p][local[m]]
        return out

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """The windows at kept positions ``idx``, materialized (the only
        copy the streaming path makes, one batch at a time)."""
        part_id, local = self._part_id[idx], self._local[idx]
        out = {k: self._gather_key([p.inputs[k] for p in self._parts], part_id, local)
               for k in INPUT_KEYS}
        if self.has_labels:
            out["labels"] = {k: self._gather_key([p.labels[k] for p in self._parts], part_id, local)
                             for k in _LABEL_KEYS}
        return out

    def batches(
        self, batch_size: int, rng: Optional[np.random.Generator] = None, drop_last: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        """``WindowDataset.batches``' contract and, for the same ``rng``
        state, its stream bit for bit, gathering one batch at a time."""
        n = len(self)
        order = np.arange(n)
        if rng is not None:
            rng.shuffle(order)
        stop = n - (n % batch_size) if drop_last else n
        for lo in range(0, stop, batch_size):
            yield self.gather(order[lo : lo + batch_size])

    def subsample(self, n: int, seed: int = 0) -> "StreamingWindowDataset":
        """``WindowDataset.subsample``'s selection (the same draw over the
        same length); only the kept-index lookup shrinks, the views are
        shared with the parent."""
        if n >= len(self):
            return self
        idx = np.random.default_rng(seed).choice(len(self), size=n, replace=False)
        out = object.__new__(StreamingWindowDataset)
        out._parts = self._parts
        out._part_id = self._part_id[idx]
        out._local = self._local[idx]
        out.num_dropped = self.num_dropped
        return out

    def materialize(self) -> WindowDataset:
        """Every kept window copied into a ``WindowDataset``."""
        full = self.gather(np.arange(len(self)))
        return WindowDataset(inputs={k: full[k] for k in INPUT_KEYS}, labels=full.get("labels"))


def concat_datasets(parts: Sequence[WindowDataset]) -> WindowDataset:
    """One dataset holding every part's windows, in order."""
    inputs = {k: np.concatenate([p.inputs[k] for p in parts]) for k in INPUT_KEYS}
    labels = None
    if parts[0].labels is not None:
        labels = {k: np.concatenate([p.labels[k] for p in parts]) for k in _LABEL_KEYS}
    return WindowDataset(inputs=inputs, labels=labels)
