"""Crash-resume progress manifests, published through the artifact store.

Counterpart of ``repro/resilience/manifest.py``.  Long-running work
checkpoints *progress* — not just final results — as ordinary
content-addressed store entries, so a SIGKILLed process resumes from the
last completed epoch (or sweep job):

  * ``train_tao_impl(..., store=..., resume_key=...)`` publishes one
    ``train_epoch`` entry per epoch — the model's state dict, the AdamW
    state as ``{"step", "mu", "nu"}`` (host copies), the loss history, and
    the NumPy bit-generator state, so the resumed epoch stream (shuffles
    included) is bit-identical to an uninterrupted run.
  * ``publish_sweep_result`` / ``load_sweep_result`` persist one
    ``SimulationResult``'s metrics per completed sweep job (the sweep
    scheduler, ``engine/scheduler.py``, publishes them).

Keys compose the caller's ``resume_key`` (the recipe identity) with the
per-unit identity, through the same ``store.content`` scheme as every
other artifact.  Entries are immutable and atomic like all store objects:
a kill mid-publish leaves a torn tmp dir for ``gc``, never a half-entry.
The port resumes its own manifests; one written by the reference holds
its own params tree, which the port does not load.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..store.content import content_key

__all__ = [
    "load_sweep_result",
    "load_train_epoch",
    "publish_sweep_result",
    "publish_train_epoch",
    "sweep_progress_key",
    "train_epoch_key",
]


# ---------------------------------------------------------------------------
# Sweep progress: one entry per completed (model, trace) job
# ---------------------------------------------------------------------------


def sweep_progress_key(
    resume_key: str, job_key: str, trace_digest: str, params_digest: str,
    geometry_token: str,
) -> str:
    return content_key(
        "sweep_progress", resume_key, job_key, trace_digest, params_digest,
        geometry_token,
    )


def publish_sweep_result(store, key: str, result) -> None:
    """Persist a ``SimulationResult``'s metrics (scalars + phase curves).
    Collected per-instruction arrays are NOT checkpointed — they are
    O(trace) large and recomputable; resumed results raise the usual
    ``MetricNotCollectedError`` on array access."""
    tree = {name: np.asarray(v) for name, v in result.metrics.items()}
    store.put(
        "sweep_progress", key, tree,
        {"num_instructions": int(result.num_instructions)},
    )


def load_sweep_result(store, key: str):
    """The checkpointed ``SimulationResult`` for ``key``, or None.
    ``seconds``/``mips`` are 0.0 — the resumed run did not simulate it."""
    hit = store.get("sweep_progress", key)
    if hit is None:
        return None
    from ..engine.runner import SimulationResult  # lazy: the engine pulls in the model stack

    tree, extra = hit
    metrics = {
        name: (arr if arr.ndim else arr[()]) for name, arr in tree.items()
    }
    return SimulationResult(
        num_instructions=int(extra.get("num_instructions", 0)),
        seconds=0.0,
        mips=0.0,
        metrics=metrics,
    )


# ---------------------------------------------------------------------------
# Training progress: one entry per completed epoch
# ---------------------------------------------------------------------------


def train_epoch_key(resume_key: str, epoch: int) -> str:
    return content_key("train_epoch", resume_key, str(epoch))


def publish_train_epoch(
    store,
    resume_key: str,
    epoch: int,
    params: Any,
    opt: Any,
    losses: List[float],
    eval_losses: List[float],
    steps: int,
    rng_state: Dict,
) -> None:
    """Checkpoint the state needed to continue bit-identically after
    ``epoch``: the host params and opt trees (dicts of host tensors), the loss
    history so far, and the dataset-shuffle rng's bit-generator state
    (JSON-clean by construction — plain ints)."""
    store.put(
        "train_epoch", train_epoch_key(resume_key, epoch),
        {"params": params, "opt": opt},
        {
            "epoch": int(epoch),
            "losses": [float(x) for x in losses],
            "eval_losses": [float(x) for x in eval_losses],
            "steps": int(steps),
            "rng_state": rng_state,
        },
    )


def load_train_epoch(
    store, resume_key: str, max_epochs: int
) -> Optional[Dict[str, Any]]:
    """The latest checkpointed epoch for ``resume_key`` strictly below
    ``max_epochs``, as a dict (params, opt, epoch, losses, eval_losses,
    steps, rng_state), or None when nothing is resumable."""
    for ep in range(max_epochs - 1, -1, -1):
        hit = store.get("train_epoch", train_epoch_key(resume_key, ep))
        if hit is None:
            continue
        tree, extra = hit
        return {
            "params": tree["params"],
            "opt": tree["opt"],
            "epoch": int(extra["epoch"]),
            "losses": [float(x) for x in extra.get("losses", [])],
            "eval_losses": [float(x) for x in extra.get("eval_losses", [])],
            "steps": int(extra.get("steps", 0)),
            "rng_state": extra.get("rng_state"),
        }
    return None
