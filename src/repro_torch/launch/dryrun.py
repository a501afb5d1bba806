"""One-card dry run: every (architecture x input shape) cell, measured on one GPU.

Counterpart of ``repro/launch/dryrun.py``, with ``launch/hloanalysis.py``
and ``launch/mesh.py`` folded in.  The reference lowers and compiles each
cell ahead of time for a 256- or 512-chip TPU mesh on ShapeDtypeStruct
stand-ins and reads the roofline terms from XLA's memory and cost analyses
and the compiled HLO.  One card has nothing to lower: the port builds each
cell's model on the ``meta`` device to count its parameters with nothing
allocated (``lower_cell``: the reference's ``jax.eval_shape``), estimates
the cell's bytes on the card, and runs each cell that fits at full width
and depth, random bfloat16 weights from a seeded ``torch.Generator``,
through the port's own entry points (``run_cell``):

  train_4k     -> train.trainer.make_train_step (forward, backward, AdamW;
                  microbatched, under the config's remat="full")
  prefill_32k  -> Model.prefill (hubert: Model.encode, no cache)
  decode_32k   -> Model.init_cache + Model.decode_step (one token over a
                  32k cache, at its last position)
  long_500k    -> the same at 524288 (state-space / hybrid state decode)

The cell matrix (``SHAPES``, ``cell_supported``, ``runnable_cells``) and
``model_flops`` are the reference's, kept exactly: 31 runnable cells over
the 10 ``ARCH_IDS``.  Per card, ``seq`` is the cell's own and ``batch`` the
reference's divided by its single-pod mesh's data axis (``DATA_WAYS``, 16):
one data-parallel replica, which the reference spreads over 16 model-axis
chips; ``global_batch`` is recorded beside it.  A train cell picks its
microbatches by the reference's rule (full-remat residuals at <= 2 GiB).

The roofline terms keep the reference's keys at the card's rates
(``PEAK_FLOPS`` 989 TFLOP/s bf16 dense, ``HBM_BW`` 3.35 TB/s: NVIDIA's data
sheet for the H100 SXM at 700 W); ``collective_s`` is 0 on one card.
``hloanalysis.py``'s loop-aware dot count has no HLO to parse here:
``counted_flops`` sums ``torch.utils.flop_counter.FlopCounterMode``'s
formulas over the aten products of one step instead.  The port's hand kernels (B4, B5 and their backwards) are
ctypes calls it cannot see, so ``flops_per_device`` = max(counted,
analytic), the reference's own rule.  ``mesh.py`` has no counterpart: one
card has no mesh, and one asked for raises (ROADMAP A.14 (c)).

A cell whose estimate exceeds the card's memory is recorded with its
estimate, ``"fits": false``, and not run.  Each cell that runs also
records its step's median and range over the timed steps (CUDA events on
the card; the host clock on the CPU), the device ms and idle share of one
profiled step, the peak bytes allocated, each hand kernel's launches (its
wrapper's counter) and the card's name and power limit; on the CPU the
device's numbers are None (not measured).

Usage (on the card):

  python -m repro_torch.launch.dryrun --out dryrun.json
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape prefill_32k --out dryrun.json
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import resolve_device
from ..configs import ARCH_IDS, get_arch
from ..kernels import launch_counters
from ..models.backbone import VOCAB_CHUNK
from ..models.config import ArchConfig
from .roofline import analytic_flops, analytic_hbm_bytes

__all__ = [
    "DATA_WAYS", "HBM_BW", "PEAK_FLOPS", "SHAPES", "cell_supported", "counted_flops",
    "estimate_bytes", "lower_cell", "main", "model_flops", "run_cell", "runnable_cells",
]

# ---------------------------------------------------------------------------
# cell definitions (the reference's)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit)
PEAK_FLOPS = 989e12      # bf16 on the tensor cores
HBM_BW = 3.35e12         # bytes/s

# the reference's single-pod mesh is (data=16, model=16) (mesh.py:17): a
# card runs one data-parallel replica, the global batch over 16
DATA_WAYS = 16
# AdamW's state and update per parameter (train/optim.py: bf16 weights and
# first moment, f32 second moment, gradients, and the flat float32 vectors
# of the update), about 38 bytes; PERF.md section 5's peaks agree
TRAIN_BYTES_PER_PARAM = 38
SLACK_BYTES = 1 << 30
# the weights' and the inputs' seed
SEED = 0
# the spin kernels that open a profiled step (the profiler loses a
# session's first kernel records; they take the loss and are left out)
PROFILE_PREFIX_KERNELS = 5000


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    cfg = get_arch(arch)
    if cfg.encoder_only and shape in ("decode_32k", "long_500k"):
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md)"
    return True, ""


def runnable_cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = cell_supported(arch, shape)
            if ok:
                yield arch, shape


def per_card_batch(shape: str) -> int:
    """The cell's batch on one card: the reference's over ``DATA_WAYS``."""
    return max(1, SHAPES[shape]["batch"] // DATA_WAYS)


def auto_microbatches(cfg: ArchConfig, batch: int, seq: int) -> int:
    """The reference's rule (``dryrun.py:109-117``): keep the saved
    per-layer residuals (batch/µb x seq x d x 2 B x n_layers under full
    remat) near 2 GiB."""
    resid = cfg.n_layers * batch * seq * cfg.d_model * 2
    microbatches = 1
    while resid / microbatches > 2 * 1024**3 and microbatches < batch:
        microbatches *= 2
    return microbatches


# ---------------------------------------------------------------------------
# "lowering": the model's shapes on the meta device
# ---------------------------------------------------------------------------


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def lower_cell(arch: str, shape: str, *, reduced: bool = False):
    """The analogue of the reference's ``lower_cell``: the cell's model
    built on ``meta`` (shapes only), and its meta record (kind, per-card
    batch, global batch, seq, parameter count, microbatches; the cache's
    bytes for decode and prefill cells).  Returns (model, meta, cfg)."""
    from ..models import Model

    spec = SHAPES[shape]
    cfg = get_arch(arch, reduced=reduced)
    kind, B, S = spec["kind"], per_card_batch(shape), spec["seq"]
    model = Model(cfg, device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    microbatches = auto_microbatches(cfg, B, S) if kind == "train" else 1
    meta = {"arch": arch, "shape": shape, "kind": kind, "batch": B,
            "global_batch": spec["batch"], "seq": S, "n_params": n_params,
            "microbatches": microbatches}
    if kind != "train" and not cfg.encoder_only:
        # a prefill writes the cache a decode reads: the same shapes
        meta["cache_bytes"] = _tensor_bytes(model.init_cache(B, S))
    return model, meta, cfg


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def model_flops(cfg, meta) -> float:
    """6·N·D (train) / 2·N·D (inference) with N_active for MoE.

    N excludes the input embedding table when it is untied (a gather, not a
    matmul); tied tables participate in the logits matmul and stay counted.
    """
    n = meta["n_params"]
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model
    if cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = cfg.n_layers - m.first_dense_layers
        routed = 3 * cfg.d_model * m.d_ff_expert * m.num_experts * n_moe_layers
        active = routed * (m.top_k / m.num_experts)
        n = n - routed + active
    if meta["kind"] == "train":
        tokens = meta["batch"] * meta["seq"]
        return 6.0 * n * tokens
    if meta["kind"] == "prefill":
        tokens = meta["batch"] * meta["seq"]
        return 2.0 * n * tokens
    return 2.0 * n * meta["batch"]  # decode: one token per sequence


def estimate_bytes(cfg: ArchConfig, meta: Dict, plain_attention: bool = False) -> int:
    """The cell's bytes on the card, before anything is allocated.  Train:
    ``TRAIN_BYTES_PER_PARAM`` a parameter, the full-remat residuals of a
    microbatch and its cross-entropy chunk's float32 (B, chunk, V) logits,
    three live at once; serving: the weights plus the cache, and for a prefill
    the working set of one layer over the whole prompt (the residual
    stream, the MLP's or the experts' hidden, the attention's q / k / v
    after the GQA repeat); each plus ``SLACK_BYTES``.  With
    ``plain_attention`` (B4's plain version, on the CPU) also its float32
    (B, H, S, S) scores, three live at once, for each layer that keeps them
    for the backward."""
    n = meta["n_params"]
    B, S = meta["batch"], meta["seq"]
    pdt = 2 if cfg.param_dtype == "bfloat16" else 4
    adt = 2 if cfg.compute_dtype == "bfloat16" else 4
    total = SLACK_BYTES
    if plain_attention and meta["kind"] != "decode" and cfg.family not in ("ssm", "hybrid") \
            and cfg.mla is None:
        kept = cfg.n_layers if meta["kind"] == "train" and cfg.remat == "none" else 1
        total += 3 * (B // meta["microbatches"]) * cfg.n_heads * S * S * 4 * kept
    if meta["kind"] == "train":
        b = B // meta["microbatches"]
        resid = cfg.n_layers * b * S * cfg.d_model * 2
        logits = 3 * b * min(VOCAB_CHUNK, S) * cfg.vocab * 4
        return total + n * TRAIN_BYTES_PER_PARAM + resid + logits
    total += n * pdt + meta.get("cache_bytes", 0)
    if meta["kind"] == "prefill":
        if cfg.family == "ssm":  # the in-projection's and the conv's outputs
            hidden = 6 * cfg.ssm.d_inner(cfg.d_model)
        elif cfg.moe is not None:  # each token's routed slots, in and hidden
            m = cfg.moe
            hidden = m.top_k * m.capacity_factor * (cfg.d_model + 3 * m.d_ff_expert)
        else:
            hidden = 3 * cfg.d_ff
        attn = 3 * cfg.n_heads * cfg.resolved_head_dim if cfg.n_heads else 0
        width = 6 * cfg.d_model + hidden + attn
        total += int(B * S * width * adt)
    return int(total)


def card_memory_bytes(device: torch.device) -> int:
    """What the cell may hold: the card's memory, or on the CPU the host's."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class _FlopCount(TorchDispatchMode):
    """Sums ``torch.utils.flop_counter``'s formula (``flop_registry``) of
    every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def counted_flops(fn: Callable[[], object]) -> int:
    """FLOPs of the aten products ``fn()`` runs, by the formulas of
    ``torch.utils.flop_counter.FlopCounterMode`` (the same counts).  Not
    through ``FlopCounterMode`` itself: its module tracker hangs gradient
    hooks on every module's outputs, which held tens of GB over a
    checkpointed train step.  The port's ctypes kernels are not dispatched
    and not counted."""
    with _FlopCount() as counter:
        fn()
    return int(counter.total)


def _roofline(cfg: ArchConfig, meta: Dict, flops_counted: Optional[int]) -> Dict:
    """The reference's flops / bytes / roofline keys on one card."""
    flops_analytic = analytic_flops(cfg, meta)
    flops_dev = max(flops_counted or 0, flops_analytic)
    bytes_dev = analytic_hbm_bytes(cfg, meta, meta["n_params"], meta.get("cache_bytes", 0))
    terms = {"compute_s": flops_dev / PEAK_FLOPS, "memory_s": bytes_dev / HBM_BW,
             "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    mf = model_flops(cfg, meta)
    return {
        "mesh": "1", "n_devices": 1,
        "flops_per_device": flops_dev,
        "flops_per_device_counted": flops_counted,
        "flops_per_device_analytic": flops_analytic,
        "bytes_per_device": bytes_dev,
        "collectives": {}, "collective_bytes_per_device": 0.0, "collective_wire_bytes": 0.0,
        "roofline": {
            **terms, "dominant": dominant, "step_time_s": step_s, "model_flops": mf,
            "useful_flops_ratio": mf / flops_dev if flops_dev else 0.0,
            "roofline_fraction": (mf / step_s) / PEAK_FLOPS if step_s > 0 else 0.0,
        },
    }


# ---------------------------------------------------------------------------
# running a cell
# ---------------------------------------------------------------------------


def _cell_step(model, cfg: ArchConfig, meta: Dict, device: torch.device):
    """(step, output check) of one cell: ``step()`` runs one train step,
    prefill / encode or decode step through the port's entry points;
    ``check()`` reads its last output back (finite, the expected shape)."""
    from ..data import LMDataPipeline
    from ..train import TrainConfig, init_state, make_train_step
    from .train import batch_to_device

    B, S = meta["batch"], meta["seq"]
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    last = {}
    if meta["kind"] == "train":
        tcfg = TrainConfig(microbatches=meta["microbatches"])
        step_fn = make_train_step(model, tcfg)
        holder = {"state": init_state(model, tcfg)}
        batch = batch_to_device(LMDataPipeline(cfg, B, S, seed=SEED).make_batch(0), device)

        def step():
            holder["state"], metrics = step_fn(holder["state"], batch)
            last["out"] = metrics["loss"]

        def check():
            return bool(torch.isfinite(last["out"])), []
        return step, check
    if cfg.encoder_only:
        frames = torch.randn(B, S, cfg.frontend_dim, generator=g, device=device).to(model.cd)

        def step():
            last["out"] = model.encode(frames)
    elif meta["kind"] == "prefill":
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=device)
        patches = None
        if cfg.family == "vlm":
            patches = torch.randn(B, cfg.vision_patches, cfg.frontend_dim, generator=g,
                                  device=device).to(model.cd)

        def step():
            last["out"] = model.prefill(tokens, patches)[0]
    else:
        cache = model.init_cache(B, S)
        tokens = torch.randint(0, cfg.vocab, (B,), generator=g, device=device)

        def step():
            last["out"] = model.decode_step(cache, tokens, S - 1)[0]

    def check():
        out = last["out"]
        return bool(torch.isfinite(out).all()), list(out.shape)
    return step, check


def _timed_steps(step: Callable[[], None], steps: int, device: torch.device) -> list:
    """Each step's ms: CUDA events on the card, the host clock on the CPU."""
    times = []
    for _ in range(steps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            stop.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def profile_step(step: Callable[[], None], device: torch.device) -> Dict:
    """Device ms and idle share of one ``step()`` from torch.profiler: busy
    is the summed self time of the card's kernels (one stream; the port's
    ``record_function`` ranges, laid on the device's timeline as spans,
    are not kernels), idle share 1 - busy / wall.  The session opens with
    ``PROFILE_PREFIX_KERNELS`` spin kernels, left out of the counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    # the card's activity only: a host op's events would cost the long
    # steps (a blocked plain attention's ~10^5 launches) minutes to average
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PREFIX_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and "spin_kernel" not in e.key
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("moe.", "mla.", "rglru.", "attention.windowed"))]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"wall_ms": wall * 1e3, "device_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3),
            "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]}


def _fits_record(meta: Dict, cfg: ArchConfig, device: torch.device) -> Dict:
    est = estimate_bytes(cfg, meta, plain_attention=device.type == "cpu")
    limit = card_memory_bytes(device)
    return {"estimate_bytes": est, "card_bytes": limit, "fits": est <= limit}


def run_cell(arch: str, shape: str, *, reduced: bool = False, device=None,
             steps: int = 3) -> Dict:
    """One cell: its meta record and memory estimate, then (where it fits
    the card) its model at full width and depth from ``SEED``, one warm-up
    step, ``steps`` timed steps, one profiled step (the card) and one
    counted (``counted_flops``); returns the cell's record (module note)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    _, meta, cfg = lower_cell(arch, shape, reduced=reduced)
    rec = {**meta, "lower_s": time.perf_counter() - t0, "device": str(dev),
           "dtype": cfg.compute_dtype, "remat": cfg.remat, "layers": cfg.n_layers}
    on_card = dev.type == "cuda"
    if on_card:
        rec["card"] = card_line()
    rec["memory"] = _fits_record(meta, cfg, dev)
    if not rec["memory"]["fits"]:
        return {**rec, **_roofline(cfg, meta, None),
                "skipped": "does not fit: the estimate exceeds the card's memory"}
    from ..models import Model

    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    step, check = _cell_step(model, cfg, meta, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    rec["build_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    _timed_steps(step, 1, dev)
    rec["warmup_s"] = time.perf_counter() - t1
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}  # a caller's counts left as they run
    times = _timed_steps(step, steps, dev)
    launches = {k: c.launches - before[k] for k, c in counters.items() if c.launches > before[k]}
    finite, out_shape = check()
    rec["step_ms_median"] = statistics.median(times)
    rec["step_ms_range"] = [min(times), max(times)]
    rec["step_ms"] = times
    rec["timer"] = "cuda_events" if on_card else "host_clock"
    rec["launches"] = launches
    rec["launches_per_step"] = {k: v / steps for k, v in launches.items()}
    rec["finite"] = finite
    rec["output_shape"] = out_shape
    t1 = time.perf_counter()
    rec["profile"] = profile_step(step, dev) if on_card else None
    rec["profile_s"] = time.perf_counter() - t1
    rec["memory"]["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else None
    t1 = time.perf_counter()
    counted = counted_flops(step)
    rec["counted_s"] = time.perf_counter() - t1
    rec.update(_roofline(cfg, meta, counted))
    step_s = rec["step_ms_median"] / 1e3
    rec["measured"] = {
        # on the CPU the host's time: no device metric
        "x_bound": step_s / rec["roofline"]["step_time_s"] if on_card else None,
        "mfu": rec["roofline"]["model_flops"] / step_s / PEAK_FLOPS if on_card else None,
    }
    rec["seconds"] = time.perf_counter() - t0
    del model, step, check
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--force", action="store_true", help="re-run the selected cells")
    ap.add_argument("--mesh", default=None, help="refused: the port runs on one card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port runs on one card; meshes are ROADMAP A.14 (c)")
    device = resolve_device(args.device)
    results = {}
    if os.path.exists(args.out):
        # always load: --force only re-runs the SELECTED cells (it must
        # never clobber the rest of the results file)
        with open(args.out) as f:
            results = json.load(f)

    cells = list(runnable_cells())
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    for arch, shape in cells:
        key = f"{arch}|{shape}"
        if key in results and not args.force:
            print(f"[skip] {key}")
            continue
        print(f"[run ] {key} ...", flush=True)
        try:
            rec = run_cell(arch, shape, device=device)
            results[key] = rec
            r, mem = rec["roofline"], rec["memory"]
            if "skipped" in rec:
                print(f"       does not fit: estimate {mem['estimate_bytes'] / 2**30:.1f} GiB > "
                      f"card {mem['card_bytes'] / 2**30:.1f} GiB", flush=True)
            else:
                print(f"       ok: dominant={r['dominant']} bound={r['step_time_s'] * 1e3:.2f}ms "
                      f"step={rec['step_ms_median']:.2f}ms launches={rec['launches_per_step']} "
                      f"peak={(mem['peak_bytes'] or 0) / 2**30:.2f}GiB "
                      f"({rec['seconds']:.0f}s)", flush=True)
        except Exception as e:  # a failed cell is recorded; the run goes on
            results[key] = {"error": f"{type(e).__name__}: {e}"}
            print(f"       FAILED: {type(e).__name__}: {str(e)[:300]}", flush=True)
            traceback.print_exc()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    n_ok = sum(1 for v in results.values() if "error" not in v)
    n_bad = sum(1 for v in results.values() if "error" in v)
    print(f"\ndone: {n_ok} ok, {n_bad} failed -> {args.out}")


if __name__ == "__main__":
    main()
