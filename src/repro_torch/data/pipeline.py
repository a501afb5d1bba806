"""Deterministic, checkpointable data pipelines.

Counterpart of ``repro/data/pipeline.py``, without JAX: the batches are
NumPy arrays made by the reference's own NumPy code, so every batch is
bitwise the reference's for every (seed, index, host slice).

``LMDataPipeline``: a synthetic-token LM stream (a Zipfian unigram mixed
with an order-2 Markov relation, so that a model has something to learn)
from a counter-based PRNG: batch i is a pure function of (seed, i), so
restoring ``next_index`` from a checkpoint resumes the exact stream.  Per
host it slices the global batch by host id (host h feeds rows [h·b/H,
(h+1)·b/H)); the port runs one host.

``TraceDataPipeline``: Tao window batches over ``core.dataset.WindowDataset``
with the same counter-based determinism.

``make_lm_batch_specs``: ``(shape, torch dtype)`` of each input of one
global batch (the reference's ``ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..core.dataset import WindowDataset
from ..models.config import ArchConfig

__all__ = ["LMDataPipeline", "TraceDataPipeline", "make_lm_batch_specs"]


def make_lm_batch_specs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``(shape, dtype)`` of each input of one global batch."""
    if cfg.family == "audio":
        return {
            "frames": ((batch, seq, cfg.frontend_dim), torch.bfloat16),
            "labels": ((batch, seq), torch.int32),
        }
    specs = {
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
    }
    if cfg.family == "vlm":
        specs["patches"] = ((batch, cfg.vision_patches, cfg.frontend_dim), torch.bfloat16)
    return specs


@dataclasses.dataclass
class LMDataPipeline:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    next_index: int = 0          # checkpointable cursor
    host_id: int = 0
    num_hosts: int = 1

    def _host_slice(self) -> Tuple[int, int]:
        per = self.batch // self.num_hosts
        return self.host_id * per, (self.host_id + 1) * per

    def make_batch(self, index: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, index) -> global batch (host's slice)."""
        cfg = self.cfg
        lo, hi = self._host_slice()
        rng = np.random.default_rng((self.seed << 20) ^ index)
        b = hi - lo
        if cfg.family == "audio":
            frames = rng.standard_normal((b, self.seq, cfg.frontend_dim)).astype(np.float32)
            labels = rng.integers(0, cfg.vocab, size=(b, self.seq)).astype(np.int32)
            return {"frames": frames, "labels": labels}
        # Zipfian unigram mixed with a deterministic order-2 relation.
        v = cfg.vocab
        zipf = rng.zipf(1.3, size=(b, self.seq)).astype(np.int64)
        toks = np.minimum(zipf, v - 1)
        # second-order structure: with p=0.5, t[i] = f(t[i-1], t[i-2])
        mix = rng.random((b, self.seq)) < 0.5
        for i in range(2, self.seq):
            f = (toks[:, i - 1] * 31 + toks[:, i - 2] * 17 + 7) % v
            toks[:, i] = np.where(mix[:, i], f, toks[:, i])
        toks = toks.astype(np.int32)
        out = {"tokens": toks, "labels": toks.copy()}
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (b, cfg.vision_patches, cfg.frontend_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.make_batch(self.next_index)
            self.next_index += 1

    def state_dict(self) -> Dict:
        return {"next_index": self.next_index, "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.next_index = int(state["next_index"])
        self.seed = int(state["seed"])


@dataclasses.dataclass
class TraceDataPipeline:
    """Counter-deterministic batches over a Tao WindowDataset."""

    dataset: WindowDataset
    batch: int
    seed: int = 0
    next_index: int = 0

    def make_batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ index)
        idx = rng.choice(len(self.dataset), size=self.batch, replace=False)
        out = {k: v[idx] for k, v in self.dataset.inputs.items()}
        if self.dataset.labels is not None:
            out["labels"] = {k: v[idx] for k, v in self.dataset.labels.items()}
        return out

    def __iter__(self):
        while True:
            yield self.make_batch(self.next_index)
            self.next_index += 1

    def state_dict(self) -> Dict:
        return {"next_index": self.next_index, "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.next_index = int(state["next_index"])
        self.seed = int(state["seed"])
