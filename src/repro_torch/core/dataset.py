"""Windowing of extracted features into fixed-shape model batches (NumPy).

The port's copy of the inference half of ``repro/core/dataset.py``: the
model consumes non-overlapping windows of W = N+1 instructions, built as
zero-copy strided views and materialized one padded batch at a time.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .features import FeatureSet

__all__ = ["INPUT_KEYS", "num_windows", "window_view", "stream_batches"]

INPUT_KEYS = ("opcode", "regbits", "flags", "brhist", "memdist")


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
