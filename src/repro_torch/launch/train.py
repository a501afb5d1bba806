"""Training launcher: real steps on one device, with checkpointing,
auto-resume and preemption handling.

Counterpart of ``repro/launch/train.py``, with its flags and loop, on one
GPU: ``--device`` (``cuda`` by default; it raises without one unless
``--device cpu`` is given) takes the place of the reference's local
devices, and ``--mesh`` raises (one device; meshes are ROADMAP A.14).

    # CPU, the reference's reduced config (seconds):
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    # the card, qwen2-0.5b at full width and depth:
    PYTHONPATH=src python -m repro_torch.launch.train --full --batch 4 --seq 2048 \\
        --steps 20 --ckpt-dir /tmp/ckpt
    # the card, mamba2-1.3b at full width and depth, 4 x 2048 tokens a step
    # as one batch (its config's remat="full" keeps each layer's input only):
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --full --batch 4 \\
        --seq 2048 --steps 10 --ckpt-dir /tmp/ckpt
    # the card, hubert-xlarge (an encoder trained on LMDataPipeline's frames):
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge --full --batch 4 \\
        --seq 2048 --steps 10 --ckpt-dir /tmp/ckpt

There is no flag for the memory policy: the config carries it
(``ArchConfig.remat``, "full" in every full config, "none" under
``--reduced``), as the reference's launcher has none.  The model's
weights are drawn from ``--seed`` (a ``torch.Generator`` on the device),
the data from ``LMDataPipeline(seed=--seed)``.  Each step is
``train.trainer.make_train_step``'s, run eagerly as the reference jits its
step directly; a line is printed every 5 steps and at the last, a
checkpoint (``ckpt.CheckpointManager``: the ``TrainState`` and the
pipeline's cursor) every ``--ckpt-every`` steps and at once on SIGTERM,
after which the run stops.  A run with a ``--ckpt-dir`` holding a
checkpoint resumes from its latest step.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ckpt import CheckpointManager
from ..configs import get_arch
from ..data.pipeline import LMDataPipeline
from ..models import Model
from ..train.trainer import TrainConfig, init_state, make_train_step, restore_into

__all__ = ["batch_to_device", "build_parser", "main", "run"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, help="refused: the port trains on one device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A pipeline batch as tensors on ``device`` (integer arrays as int64,
    the index type of the model's gathers)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.to(device, dtype=torch.int64 if not t.is_floating_point() else None)
    return out


def run(args: argparse.Namespace,
        on_step: Optional[Callable[[int, object, Dict], None]] = None) -> Dict:
    """The launcher's loop for parsed ``args``.  ``on_step(i, state,
    metrics)`` is called after each step.  Returns the model, the final
    state, the first step run, the steps run, the loop's seconds and each
    step's metrics (device scalars)."""
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes are ROADMAP A.14"
        )
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(args.seed))
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
                       microbatches=args.microbatches)
    step_fn = make_train_step(model, tcfg)
    pipeline = LMDataPipeline(cfg, args.batch, args.seq, seed=args.seed)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = init_state(model, tcfg)
    start_step = 0
    if mgr is not None:
        restored, extra = mgr.restore_latest(state)
        if restored is not None:
            # the restored tree is a second copy of the state on the device:
            # copied in, then freed before the first step
            state = restore_into(state, restored)
            del restored
            start_step = extra["step"]
            pipeline.load_state_dict(extra.get("data", {"next_index": start_step, "seed": args.seed}))
            print(f"[resume] from step {start_step}", flush=True)

    # preemption hook: checkpoint at once on SIGTERM, then stop
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, _on_sigterm) if main_thread else None
    history: List[Dict] = []
    try:
        t0 = time.perf_counter()
        for i in range(start_step, args.steps):
            batch = batch_to_device(pipeline.make_batch(i), device)
            pipeline.next_index = i + 1
            state, metrics = step_fn(state, batch)
            history.append(metrics)
            if on_step is not None:
                on_step(i, state, metrics)
            if i % 5 == 0 or i == args.steps - 1:
                print(
                    f"step {i:5d} loss {float(metrics['loss']):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e}",
                    flush=True,
                )
            if mgr is not None and ((i + 1) % args.ckpt_every == 0 or preempted["flag"]):
                mgr.save(state, i + 1, extra={"data": pipeline.state_dict()},
                         block=preempted["flag"])
            if preempted["flag"]:
                print(f"[preempt] checkpointed at step {i + 1}, exiting", flush=True)
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        done = len(history)
        print(f"trained {done} steps in {dt:.1f}s ({done / max(dt, 1e-9):.2f} steps/s)", flush=True)
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
        if mgr is not None:
            mgr.close()
    return {"model": model, "state": state, "start_step": start_step, "steps_run": len(history),
            "seconds": dt, "metrics": history}


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
