#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``.  Phases, one JSON line each:

  build    compile every kernel in src/repro_torch/csrc (one nvcc per
           source, all started together) and report the seconds and the
           ptxas register / spill lines;
  kernels  every kernel against its plain PyTorch version on the card, at
           the shapes the main paths give it, timed with CUDA events: the
           fused feature kernel (B1: state threaded over batches of a
           benchmark trace, with wide addresses, queues of 48 and 64, 20,000
           buckets, four batches in one launch and one-position launches;
           the kernels one call enqueues, by the profiler and by the
           nodes of a graph of one call), the staged whole-trace
           branch-history and memory-distance scans (B2; B3 writing the
           signed-log features) on whole benchmark traces, a
           collision-heavy config, wide addresses, 20,000 / 60,000
           buckets, deltas where the signed-log rounds tightly and
           all-branch traces around B2's rank tile (B2's passes timed
           apart), the staged extraction and the eager signed-log against
           the NumPy specification, attention (B4: the Tao shape on the packed
           q/k/v views the model hands over and on contiguous operands, 1024
           causal keys, q_offset / segment / masked-row cases, with its
           registers, shared memory and blocks per SM), its backward (the
           port's own kernel: the Tao training shapes at batch 16 and 64,
           S 17 / 200, D 16 / 64 / 128, causal and not, the edges of its
           16-row and 64-row tiles, widths and strides that are not
           multiples of 4 floats, against the plain formulas, two calls
           bitwise, the forward's output bitwise with and without its
           log-sum-exp; what each of its kernels gets, no spills; timed
           beside SDPA's backward, with each kernel's device time and one
           (batch, head) alone),
           and the Mamba-2
           SSD scan (B5) at the full mamba2-1.3b prefill shape in float32
           and bfloat16, with two groups, in one chunk, at chunk 200, at
           widths 40 / 72, and against the sequential recurrence, with its
           registers, shared memory, blocks per SM and the tensor-core
           (HMMA) instructions in its SASS;
  slice    the port's main paths at the default TaoConfig width on
           captured benchmark traces: the engine's step captured ahead of
           time (StreamingEngine.warmup: one CUDA graph, its capture time
           and retained bytes), then StreamingEngine.simulate of the raw
           traces (the fused route, replaying the graph per batch), then
           the staged route — one whole-trace device_feature_arrays per
           trace, then simulate(trace, features=arrays) — each with the
           kernels' launch counts read around it (attention's, run inside
           the graph, also from the graph's own kernel nodes times the
           replays); the kernels one extraction enqueues and its peak
           device memory; finite-metric checks, the staged route against
           the fused one, the fused route against the same engine on the
           CPU (the plain versions) on one trace, both routes timed side
           by side, a profile of one simulate (with the copy kernels per
           batch), and the graphed simulate against the eager step driven
           through its cache entry, in turns on both routes (MIPS, host
           and device ms per batch, idle share, results held); then the
           same under precision="int8" (the W8A8 forward, cuBLASLt IMMA
           products): qdense on the card against the CPU at every layer
           shape, the int8 step's own capture (seconds, bytes, kernel and
           IMMA nodes), both routes on the three traces with the launch
           counts (B4 also from the int8 graph's nodes), int8 beside fp32
           in turns (MIPS, device ms per batch, idle share, IMMA device
           ms) and int8 on the GPU against int8 on the CPU on one trace,
           beside a control that must fail (float32 on the GPU against
           int8 on the CPU);
  sweep    the sweep scheduler (engine.TraceSweeper) at the default
           TaoConfig width: 4 models (seeds 0-3) x the three 150k traces at
           batch 64, 12 jobs, on the fused, staged and host routes; every
           job bitwise its standalone simulate (a loop of simulates, one
           engine per model, timed as the baseline); captures (1 cold, 0
           warm); the kernels' launches by the counters and, for
           attention, by the graph's nodes times its replays (19 fused and
           38 attention launches a job on the fused route, 1 B2 and 1 B3 a
           job on the staged one, no feature kernel on the host route);
           the host route's extractions (3, then 3 from a warm store);
           crash-resume (a fault at scheduler.consume after 5 jobs, then a
           resume skipping 5, bitwise); sweep MIPS against the loop's and
           the queue's occupancy; the host route's prefetch on one trace
           (inline, off, threaded in turns; bitwise);
  train    the port's training path at the default TaoConfig width: the
           detailed simulator on lee and mcf (30,000 instructions each,
           UARCH_A), alignment, labelled features, windows; the train
           step of each recipe captured ahead of any data
           (warmup_train_step: one CUDA graph, its capture seconds,
           retained bytes and kernel nodes, B4 and its backward among
           them); train_tao_impl for 2 epochs at batch 16 on the card,
           then transfer_finetune (frozen embeddings) for 1 epoch on dee
           under UARCH_B, each batch one replay, with the launch counts
           read around both (2 attention forward and 2 backward launches
           a step, from the counters and from the graphs' nodes times
           their replays, no other kernel, no capture); the graphed run
           against the entry's eager step in turns (host ms per step,
           windows/s; losses, parameters and AdamW state bitwise), device
           ms and idle share of each from profiles that must show only
           the port's attention kernels; the graphed run with prefetch
           (prefetch_to_device: each batch packed into pinned memory and
           copied without blocking, a batch ahead), without, and with it
           on a producer thread, in turns (host ms per step, windows/s;
           device ms, idle share and the copies' device ms of one epoch
           with and without; bitwise);
           the losses (finite, falling),
           the embeddings bitwise unchanged by the fine-tune, and the
           first 3 steps on the card against the CPU's;
  persist  crash-resumable training and the legacy simulate loop: the
           train phase's windows and the three 150k traces' FeatureSets put
           into an ArtifactStore and read back bitwise (put / get ms and
           bytes, FeatureSet.digest stable); train_tao_impl for
           PERSIST_EPOCHS epochs at batch 16 with a manifest per epoch
           (publish ms, bytes per manifest), then the same recipe in a
           child process (PYTHONPATH=src, the same build/) that loads the
           windows from the store and is SIGKILLed once its first manifest
           lands, then resumed here: losses, steps, parameters and
           optimizer state bitwise the uninterrupted run's, the resume's
           load ms, and 2 + 2 attention launches per step run, none for
           the epochs skipped; then simulate_trace_legacy at batch 64 on
           the three traces (2 attention launches per ragged batch) held
           to the engine's fused route by the flip check, legacy MIPS
           beside the engine's and the engine's speedup;
  joint    the paper's workflow (§4.3): Mahalanobis pair selection over 8
           sampled designs on a 3,000-instruction trace; joint training of
           the embedding on the train phase's traces under UARCH_A and
           UARCH_B with each of the four methods (tao, tao_no_adapt,
           granite, gradnorm), 3 epochs at batch 16 and lr 1e-3, each
           method's step captured once and replayed (4 attention forward
           and 4 backward launches a step, counters and nodes × replays),
           losses finite and falling under tao, adapt unchanged without
           adaptation, GradNorm's weights summing to 2; the graphed joint
           step against its eager step in turns (bitwise; host and device
           ms per step, idle share); the first 3 steps of each method on
           the card against the CPU's; transfer_finetune of the jointly
           trained embedding (frozen, bitwise unchanged) with A's heads as
           donor onto dee under UARCH_C; 3 eager SimNet steps on the card
           against the CPU (no hand kernel launched);
  session  the facade (repro_torch.api) at the default TaoConfig width, as
           a user drives it, over an ArtifactStore in a temporary
           directory: Session.capture and train (UARCH_A, the train
           phase's traces and recipe); TrainedModel.simulate of the three
           150k traces on the fused route, cold then warm, each bitwise a
           direct StreamingEngine of the same weights, with B1 and B4
           launches (57 and 114 warm) and MIPS; int8 simulate, its
           quantized tree put in the store and found there by a second
           model of the same weights (bitwise); Session.sweep of 2 models x
           the 3 traces from a cleared step cache (1 capture) and warm (0),
           bitwise the single simulates; train_joint on UARCH_A and UARCH_B
           (1 epoch) and the simulate of A's head; a second Session on the
           store that captures, trains and detail-simulates nothing and
           returns the same weights; warmup at a batch size of its own,
           after which the first simulate captures nothing;
  mamba2   the port's Mamba-2 serving path at the full width of
           mamba2-1.3b (48 layers, bfloat16, random weights from a CUDA
           generator, seed 0): prefill of 4 prompts x 2048 tokens, then 32
           greedy decode steps, with the SSD launches read around each
           call (48 per prefill, 0 per decode step), prefill tokens/s,
           decode ms per step, peak device memory and a profile of one
           prefill; the prefill/decode handoff on a float32 copy of the
           same weights, and the card's path against the same model on
           the CPU (the plain versions) at 4 layers.

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main path, error, times and bound; the card's name and power limit as
``nvidia-smi`` prints them; and, last, the device line.  Any failed check
exits nonzero before the device line.  Without a CUDA device, or outside a
checkout (no ``src/repro_torch``), it exits nonzero and prints no result.
Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # float32 on the CUDA cores, no tensor cores
BF16_TENSOR_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores

SLICE_BENCHMARKS = ("dee", "mcf", "lee")
SLICE_INSTRUCTIONS = 150_000
KERNEL_LAUNCHES = 4        # state-threaded B1 launches checked bitwise
WIDE_ADDR_OFFSET = 1 << 40  # shifts a trace's addresses past the int32 window
# bucket counts past 8,192: shared-memory counters opted in past 48 KB,
# and counters in global scratch (past the kernels' SMEM_BUCKETS)
MANY_BUCKETS = (20_000, 60_000)
# (n_buckets, n_queue, n_mem) where many branches share few buckets (three:
# not a power of two) and the queues are short
COLLISION_SHAPE = (3, 5, 12)
# trace lengths around B2's 1,024-position rank tile: one short, one full,
# one past, and a lone position after three tiles
TILE_EDGE_LENGTHS = (1023, 1024, 1025, 3 * 1024 + 1)
PASS_CALLS = 20            # calls profiled for B2's per-pass device times
# FLOPs per valid memory-distance slot: one subtraction, two conversions
# and the ~27 float32 ops of the signed-log (B1 and B3)
SIGNED_LOG_SLOT_FLOPS = 30
# attention kernel vs its full-matrix plain version: 3xTF32 tensor-core
# products (float32-level error) and exp2 of pre-scaled scores in the
# kernel against float32 einsum and expf in the plain version
ATTN_ATOL = 1e-5
ATTN_RTOL = 1e-5
# attention backward vs its plain version (explicit formulas, einsum): both
# float32 sums over at most S keys or rows, in other orders; the forward's
# base-2 log-sum-exp (3xTF32 scores, ex2.approx, log2f) against
# logsumexp of the float32 scores, values up to ~10
ATTN_BWD_ATOL = 1e-5
ATTN_BWD_RTOL = 1e-5
LSE_ATOL = 2e-5
LSE_RTOL = 1e-5
# (B, H, S, D, causal) of the backward's checks: the Tao training shape at
# batch 16 and 64, short and long windows, narrow and wide heads, then the
# edges of the kernel's 16-row tiles and 64-row streamed tiles (S 1, 15,
# 16, 17, 144, 145) at widths 8 and 20, and a long window, whose sums run
# over 1,000 rows
ATTN_BWD_CASES = {
    "tao_b16_causal": (16, 4, 129, 32, True),
    "tao_b64_causal": (64, 4, 129, 32, True),
    "tao_b16_noncausal": (16, 4, 129, 32, False),
    "s17_d16_causal": (4, 4, 17, 16, True),
    "s17_d16_noncausal": (4, 4, 17, 16, False),
    "s200_d64_causal": (4, 4, 200, 64, True),
    "s200_d64_noncausal": (4, 4, 200, 64, False),
    "s200_d16_causal": (4, 4, 200, 16, True),
    "s129_d128_causal": (2, 2, 129, 128, True),
    **{f"tile_s{S}_d{D}_causal": (2, 3, S, D, True)
       for S in (1, 15, 16, 17, 144, 145) for D in (8, 20)},
    "tile_s145_d20_noncausal": (2, 3, 145, 20, False),
    "long_s1000_d64_causal": (1, 2, 1000, 64, True),
}
# the backward's unaligned case: widths and strides that are not multiples
# of 4 floats (the kernel's 4-byte copies), dO a strided view
ATTN_BWD_UNALIGNED = (2, 3, 77, 21)
# the train cell: detailed-simulator labels on UARCH_A for the training
# traces, on UARCH_B for the transfer trace, at the default TaoConfig and
# FeatureConfig; Adam's lr as the trainer's default
TRAIN_TRACES = ("lee", "mcf")
TRANSFER_TRACE = "dee"
TRAIN_INSTRUCTIONS = 30_000
TRAIN_EPOCHS, TRANSFER_EPOCHS, TRAIN_BATCH, TRAIN_LR = 2, 1, 16, 3e-4
# the persist cell: the train cell's windows and recipe for PERSIST_EPOCHS
# epochs (29 steps each), a manifest per epoch.  The killed child is sent
# SIGKILL once its first manifest lands: with six epochs of ~0.5 s each
# after it, at least one epoch is published and not all of them
PERSIST_EPOCHS = 6
PERSIST_POLL_S = 0.005
PERSIST_CHILD_TIMEOUT_S = 300
LEGACY_BATCH = 64
# the child of the persist phase: loads the windows from the store and runs
# the recipe under its resume key on the card (nothing of JAX)
PERSIST_CHILD = r"""
import sys
from repro_torch.core import TaoConfig, WindowDataset, train_tao_impl
from repro_torch.store import ArtifactStore
root, windows_key, resume_key, epochs, batch, lr = sys.argv[1:7]
store = ArtifactStore(root)
tree, _ = store.get("train_windows", windows_key)
ds = WindowDataset(inputs=tree["inputs"], labels=tree["labels"])
train_tao_impl(TaoConfig(), ds, epochs=int(epochs), batch_size=int(batch), lr=float(lr), seed=0,
               store=store, resume_key=resume_key, device="cuda")
"""
# the joint cell: Algorithm 1 and its baselines on the train cell's traces
# under UARCH_A and UARCH_B, at lr 1e-3 (Session.train_joint's default);
# the pair selection over 8 sampled designs on one short trace, as the
# reference's examples/train_tao_e2e.py does; a short SimNet run
JOINT_EPOCHS, JOINT_LR, JOINT_PROFILE_STEPS = 3, 1e-3, 10
JOINT_DESIGNS, JOINT_DESIGN_SEED = 8, 42
JOINT_SELECT_TRACE, JOINT_SELECT_INSTRUCTIONS = "lee", 3_000
SIMNET_STEPS = 3
# the session phase's warmup check: a batch size no earlier phase captured
SESSION_WARMUP_BATCH = 32
# the card's first joint steps against the CPU's: the tolerance the CPU
# tests hold three joint steps of the port to the reference's with
# (losses relative, GradNorm's weights absolute)
JOINT_CPU_RTOL = 1e-5
# the card's first steps against the same steps on the CPU: the forward
# differs in the last bits (cuBLAS vs CPU BLAS order, 3xTF32 attention), so
# the losses agree within 1e-4 relative; Adam moves each parameter by at
# most ~lr a step, and where a gradient is ~0 its sign can differ between
# the two, so a parameter may differ by up to 2 lr a step
TRAIN_CHECK_STEPS = 3
TRAIN_LOSS_RTOL = 1e-4
# the sweep phase: its models' seeds, its metrics (no cpi_phase: its float32
# per-chunk sums go through atomics whose order changes from run to run, so
# a job would not be bitwise its standalone simulate), the jobs a killed
# sweep finishes before its fault
SWEEP_SEEDS = (0, 1, 2, 3)
SWEEP_METRICS = ("cpi", "branch_mpki", "l1d_mpki", "l1d_phase", "dlevel_hist")
SWEEP_KILL_AFTER = 5

# GPU vs CPU engine on one trace.  Features are bitwise equal on both; the
# model's float32 logits differ in the last bits (cuBLAS vs CPU BLAS
# summation order), which flips an argmax / threshold decode only where
# two logits nearly tie.  At most 0.1% of positions may flip, and every
# metric difference must be explained by the flips that occurred.
FLIP_FRACTION = 1e-3
PROB_ATOL = 1e-4           # sigmoid(mispred_logit), logits differ ~1e-6
# int8 on the GPU vs int8 on the CPU: the float32 parts around the int8
# products differ in the last bits there too, and an activation that lands
# on the other side of a rounding boundary takes the neighbouring int8
# code; causal attention carries that to the rest of its window, so
# mispred_prob moves at most later positions of such a window and a few
# decodes flip.  Each limit lies between the sound run and a control that
# must fail: float32 on the card against int8 on the CPU (the step running
# float32 where int8 was asked for).  On dee on the H100: int8 against int8
# 0.127% of the decodes flipped, mispred_prob within 0.0107; the control
# 4.06% and 0.0445.
INT8_FLIP_FRACTION = 5e-3
INT8_PROB_ATOL = 0.02
# the int8 step's cuBLASLt IMMA kernels, by name (cutlass_80_tensorop_
# i16832gemm_s8_*, sm90_xmma_gemm_i8i32_*), and the float32 GEMM / GEMV
# kernels that must not be in its graph
INT8_GEMM_PIECES = ("gemm_s8", "gemm_i8")
FLOAT_GEMM_PIECES = ("gemm_f32", "gemv")
ROUTE_ROUNDS = 3           # turns of the fused / staged side-by-side timing
# graphed step vs eager step: cpi_phase's float32 per-chunk sums go
# through index_add_'s atomics, whose order changes from run to run; one
# batch adds its 64 window sums to a chunk in any order
GRAPH_PHASE_RTOL = 64 * 2.0**-24

# SSD kernel vs its plain chunked version, float32 on both sides: the
# summation order and the chunk's prefix sum differ.  bfloat16 outputs
# round nearly equal float32 values once; the float32 state is unrounded.
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_STATE_TOL = 1e-4
# the mamba2-1.3b serving cell: prompts x tokens, greedy decode steps
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_DECODE = 4, 2048, 32
MAMBA_CPU_LAYERS, MAMBA_CPU_SEQ = 4, 512
HANDOFF_REL = 2e-3         # prefill(p + t) vs prefill(p) + decode(t), float32
GPU_CPU_REL = 1e-3         # kernel path on the card vs plain path on the CPU


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back eager calls, by
    CUDA events: device time, or the host's launch overhead where that is
    longer."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device time of one ``fn()``: ``per_graph`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events (no host launch
    overhead in the window)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (per_graph * replays)


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_enqueued(fn, sessions: int = 3) -> int:
    """How many device kernels one ``fn()`` runs, from torch.profiler
    (copies and memsets not counted): the most over ``sessions`` profiled
    calls.  A session can miss a kernel but never counts one that did not
    run: in a process whose kernels were already built once, the first
    session counted B1's five kernels as four; why was not found."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                          and not e.key.startswith(("Memcpy", "Memset"))))
    return max(counts)


def captured_kernel_names(fn, piece: str) -> list:
    """The names of the kernel nodes holding ``piece`` in a CUDA graph of
    one ``fn()``, read from the graph (``engine/aot.py::graph_kernel_names``)."""
    import torch

    from repro_torch.engine.aot import graph_kernel_names

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return [k for k in graph_kernel_names(graph) if piece in k]


def random_trace(n: int, seed: int, pc_mod: int):
    """A functional trace of random instructions (40% branches, 40% memory
    ops) whose pcs spread over ``pc_mod`` buckets' worth of addresses."""
    import numpy as np

    from repro_torch.uarch.isa import FUNC_TRACE_DTYPE, Op

    rng = np.random.default_rng(seed)
    t = np.zeros(n, dtype=FUNC_TRACE_DTYPE)
    t["pc"] = rng.integers(0, pc_mod, n) * 4
    t["opcode"] = rng.integers(0, len(Op), n)
    for k in ("dst", "src1", "src2"):
        t[k] = rng.integers(0, 32, n)
    t["is_branch"] = rng.random(n) < 0.4
    t["taken"] = t["is_branch"] & (rng.random(n) < 0.5)
    t["is_mem"] = ~t["is_branch"] & (rng.random(n) < 0.67)
    t["is_store"] = t["is_mem"] & (rng.random(n) < 0.4)
    t["addr"] = np.where(t["is_mem"], rng.integers(0, 1 << 29, n), 0)
    return t


def tile_edge_trace(n: int, alternate: bool, seed: int):
    """Every position a branch at pc 0 (bucket 0 under any config), or at pcs
    0 and 4 in turn (buckets 0 and 1); random outcomes, no memory ops."""
    import numpy as np

    t = random_trace(n, seed, 1)
    t["is_branch"], t["is_mem"], t["is_store"], t["addr"] = True, False, False, 0
    t["taken"] = np.random.default_rng(seed).random(n) < 0.5
    t["pc"] = (np.arange(n) % 2) * 4 if alternate else 0
    return t


def edge_delta_trace(seed: int):
    """Memory ops at every other position, at ``signed_log_edge_addresses``
    (deltas of 0, x * 2^k - 1 with x next to sqrt(2), and 2^62); random
    ops between."""
    from repro_torch.kernels.features.ref import signed_log_edge_addresses

    addr = signed_log_edge_addresses()
    t = random_trace(2 * len(addr), seed, 64)
    t["is_mem"][::2], t["is_branch"][::2], t["taken"][::2], t["addr"][::2] = True, False, False, addr
    t["is_mem"][1::2] = False
    return t


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by the name the kernels line uses."""
    from repro_torch.kernels.attention.kernel import FLASH_ATTENTION, FLASH_ATTENTION_BWD
    from repro_torch.kernels.features.kernel import BRANCH_HISTORY, MEMDIST_DELTA
    from repro_torch.kernels.fused.kernel import FUSED_FEATURES
    from repro_torch.kernels.ssd.kernel import SSD_SCAN

    return {"fused_features": FUSED_FEATURES, "flash_attention": FLASH_ATTENTION,
            "branch_history": BRANCH_HISTORY, "memdist_delta": MEMDIST_DELTA, "ssd": SSD_SCAN,
            "flash_attention_bwd": FLASH_ATTENTION_BWD}


def zero_counts() -> None:
    for c in launch_counters().values():
        c.launches = 0


def read_counts() -> dict:
    return {name: c.launches for name, c in launch_counters().items()}


def profile_breakdown(fn, track: tuple = ()) -> dict:
    """Device time by kernel over one ``fn()``, from torch.profiler (CUPTI):
    busy = summed time of the device's kernel events (one stream: kernels
    do not overlap; the host ops that launched them are not counted again),
    idle share = 1 - busy / wall.  The profiler's own host overhead
    inflates the wall time here; the unprofiled runs report the real rates.
    ``track``: also the device ms of each kernel whose name holds one of
    these pieces, by the name from there to its argument list.  Raises when
    the profile
    cannot be taken or shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    tracked = {e.key[e.key.index(t):].split("(")[0]: e.self_device_time_total / 1e3
               for e in events for t in track if t in e.key}
    return {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        # PyTorch's copy / cast kernel (direct_copy_kernel_cuda): what a
        # .contiguous() or a layout-changing reshape launches
        "copy_kernels": sum(e.count for e in events if "copy_kernel" in e.key),
        "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top],
        **({"tracked_ms": tracked} if track else {}),
    }


def phase_build(failures, results, traces):
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    libs = _cuda.build()
    secs = time.perf_counter() - t0
    ptxas = {}
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[src.name] = [
            ln.split("ptxas info    :")[-1].strip()
            for ln in lines
            if "registers" in ln or "spill" in ln
        ]
    emit({"phase": "build", "seconds": secs, "sources": sorted(s.name for s in libs),
          "ptxas": ptxas})
    print(card_line(), flush=True)
    if not libs:
        failures.append("build: no CUDA sources found")


def phase_kernels(failures, results, traces):
    import numpy as np
    import torch

    from repro_torch.core.features import FeatureConfig, extract_features
    from repro_torch.kernels.features.ops import trace_columns
    from repro_torch.kernels.fused.kernel import COLUMN_KEYS, KERNELS_PER_CALL, fused_features_cuda
    from repro_torch.kernels.fused.ops import init_fused_state
    from repro_torch.kernels.fused.ref import fused_features_plain
    from repro_torch.uarch import get_benchmark, run_functional

    dev = torch.device("cuda")

    # ---- B1: fused features, the state threaded over the launches of each
    # case: (config, trace, positions per launch)
    fcfg = FeatureConfig()
    n = 64 * 129  # one engine batch: 64 windows of 129
    ft = run_functional(get_benchmark("mcf"), KERNEL_LAUNCHES * n)
    wide = ft.copy()
    wide["addr"][wide["is_mem"]] += WIDE_ADDR_OFFSET
    batches = (n,) * KERNEL_LAUNCHES
    cases = {
        "mcf": (fcfg, ft, batches),
        "mcf_wide_addresses": (fcfg, wide, batches),
        "mcf_queue_48": (FeatureConfig(n_queue=48), ft, batches),
        "mcf_queue_64": (FeatureConfig(n_queue=64), ft, batches),
        "random_buckets_20000": (FeatureConfig(n_buckets=MANY_BUCKETS[0]),
                                 random_trace(KERNEL_LAUNCHES * n, 1, 2 * MANY_BUCKETS[0]), batches),
        "mcf_four_batches_one_launch": (fcfg, ft, (KERNEL_LAUNCHES * n,)),
        "mcf_one_position_launches": (fcfg, ft[:n + 1], (1, n - 1, 1)),
    }
    bitwise, max_err = True, 0.0
    names = ("regbits", "flags", "brhist", "memdist")
    for case, (cfg, trace, slices) in cases.items():
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in trace_columns(trace, cfg).items()}
        spec = extract_features(trace, cfg, with_labels=False)
        st_k = init_fused_state(cfg, dev)
        table_k, mq_k = st_k["table"], st_k["mq"]
        table_p, mq_p = table_k.clone(), mq_k.clone()
        same, lo = True, 0
        for m in slices:
            sl = {k: cols[k][lo:lo + m] for k in COLUMN_KEYS}
            *outs_k, table_k, mq_k = fused_features_cuda(sl, table_k, mq_k)
            *outs_p, table_p, mq_p = fused_features_plain(sl, table_p, mq_p)
            torch.cuda.synchronize()
            for name, a, b in zip(names, outs_k, outs_p):
                ref = getattr(spec, name)[lo:lo + m]
                same &= torch.equal(a.view(torch.int32), b.view(torch.int32)) and np.array_equal(
                    a.cpu().numpy().view(np.int32), ref.view(np.int32))
                max_err = max(max_err, float((a - b).abs().max()))
            same &= torch.equal(table_k, table_p) and torch.equal(mq_k, mq_p)
            lo += m
        bitwise &= same
        emit({"phase": "kernels", "kernel": "fused_features", "case": case,
              "config": [cfg.n_buckets, cfg.n_queue, cfg.n_mem], "positions_per_launch": list(slices),
              "bitwise_vs_plain_and_numpy_spec": same})
    if not bitwise:
        failures.append("fused_features: kernel != plain version / NumPy spec")
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in trace_columns(ft, fcfg).items()}
    sl = {k: cols[k][:n] for k in COLUMN_KEYS}
    t_state = init_fused_state(fcfg, dev)
    ms = graph_ms(lambda: fused_features_cuda(sl, t_state["table"], t_state["mq"]))
    call_ms = cuda_ms(lambda: fused_features_cuda(sl, t_state["table"], t_state["mq"]), 200)
    per_call = kernels_enqueued(lambda: fused_features_cuda(sl, t_state["table"], t_state["mq"]))
    if per_call != KERNELS_PER_CALL:
        failures.append(f"fused_features: one call ran {per_call} kernels, not {KERNELS_PER_CALL}")
    # the same count from the kernel nodes of a graph of one call, in three
    # throwaway captures, as kernels_enqueued profiles three calls
    node_counts = [len(captured_kernel_names(
        lambda: fused_features_cuda(sl, t_state["table"], t_state["mq"]), "fx_")) for _ in range(3)]
    if node_counts != [KERNELS_PER_CALL] * 3:
        failures.append(f"fused_features: graphs of one call held {node_counts} kernels, "
                        f"not {KERNELS_PER_CALL}")
    p_state = init_fused_state(fcfg, dev)
    plain_ms = cuda_ms(lambda: fused_features_plain(sl, p_state["table"], p_state["mq"]), 10)
    col_bytes = n * (5 * 4 + 8 + 4 * 1)
    state_bytes = 2 * (fcfg.n_buckets * fcfg.n_queue * 4 + (fcfg.n_mem + 1) * 8)
    out_bytes = n * (32 + 5 + fcfg.n_queue + fcfg.n_mem) * 4
    n_mem_slots = int((extract_features(ft[:n], fcfg, with_labels=False).memdist != 0).sum())
    b_ms, b_by = bound(col_bytes + state_bytes + out_bytes, SIGNED_LOG_SLOT_FLOPS * n_mem_slots)
    results["fused_features"] = {
        "name": "fused_features", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_features.cu",
        "replaces": "src/repro/kernels/fused/kernel.py:49",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit({"phase": "kernels", "kernel": "fused_features", "cases": list(cases),
          "launches_checked": sum(len(c[2]) for c in cases.values()),
          "wide_address_offset": WIDE_ADDR_OFFSET,
          "positions_per_launch": n, "bitwise_vs_plain_and_numpy_spec": bitwise,
          "max_abs_err": max_err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by, "x_bound": ms / b_ms, "kernels_per_call": per_call,
          "kernels_per_call_graph_nodes": node_counts})

    check_staged_kernels(failures, results, traces)

    check_attention_kernel(failures, results)
    check_attention_bwd_kernel(failures, results)
    check_ssd_kernel(failures, results)


def packed_qkv(B, S, H, D, rand):
    """q, k, v as the Tao block makes them: (B, H, S, D) views of one
    packed (B, S, 3, H, D) projection, no copy."""
    return rand(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)


def check_attention_kernel(failures, results):
    """B4 against its plain version: the Tao shape on the packed views the
    model hands over and on contiguous tensors, a long causal problem of
    many key tiles, q_offset / segment / masked-row cases; then its times,
    bound and launch resources at the Tao shape."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_cuda, launch_info
    from repro_torch.kernels.attention.ref import attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def seg_ids(b, s):
        cuts = torch.sort(torch.randint(1, s, (b, 3), generator=g), dim=1).values
        pos = torch.arange(s)[None, :]
        return (pos[:, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32).to(dev)

    cases = {
        "tao_causal": (rand(64, 4, 129, 32), rand(64, 4, 129, 32), rand(64, 4, 129, 32),
                       None, True, 0),
        "tao_packed_qkv": (*packed_qkv(64, 129, 4, 32, rand), None, True, 0),
        "long_causal_1024": (rand(2, 2, 1024, 64), rand(2, 2, 1024, 64), rand(2, 2, 1024, 64),
                             None, True, 0),
        "q_offset_segments_dv48": (rand(2, 4, 40, 32), rand(2, 4, 129, 32),
                                   rand(2, 4, 129, 48), seg_ids(2, 129), True, 89),
        "masked_rows_noncausal": (rand(2, 4, 40, 32), rand(2, 4, 129, 32),
                                  rand(2, 4, 129, 32), seg_ids(2, 129), False, 100),
    }
    attn_err, attn_ok = 0.0, True
    for name, (q, k, v, seg, causal, off) in cases.items():
        a = flash_attention_cuda(q, k, v, seg, causal=causal, q_offset=off)
        b = attention_plain(q, k, v, seg, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        ok = bool(torch.all((a - b).abs() <= ATTN_ATOL + ATTN_RTOL * b.abs()))
        # the output is the (B, H, Sq, Dv) view of a contiguous (B, Sq, H, Dv)
        ok = ok and a.transpose(1, 2).is_contiguous()
        attn_err, attn_ok = max(attn_err, err), attn_ok and ok
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "shape": [*q.shape[:3], k.shape[2], q.shape[3], v.shape[3]],
              "q_strides": list(q.stride()), "max_abs_err": err, "atol": ATTN_ATOL,
              "rtol": ATTN_RTOL, "ok": ok})
    if not attn_ok:
        failures.append("flash_attention: kernel outside tolerance of the plain version")

    # times at the Tao shape on the operands the model gives it: the packed views
    q, k, v, *_ = cases["tao_packed_qkv"]
    qc, kc, vc, *_ = cases["tao_causal"]
    B, H, S, D = q.shape
    ms = graph_ms(lambda: flash_attention_cuda(q, k, v, causal=True))
    contiguous_ms = graph_ms(lambda: flash_attention_cuda(qc, kc, vc, causal=True))
    call_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True), 200)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=True), 20)
    # the library yardstick on contiguous operands, as before the kernel took
    # strided views, and on the packed views beside it
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True))
    lib_packed_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    visible = B * H * S * (S + 1) // 2  # causal (query, key) pairs
    b_ms, b_by = bound(4 * B * H * S * D * 4, visible * (2 * D + 2 * D))
    info = launch_info(S, D, D)
    if info["spill_bytes_per_thread"]:
        failures.append(f"flash_attention: {info['spill_bytes_per_thread']} spill bytes per thread")
    results["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:38",
        "max_abs_err": attn_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    }
    emit({"phase": "kernels", "kernel": "flash_attention", "shape": [B, H, S, D],
          "operands": "packed_qkv_views", "ms": ms, "contiguous_ms": contiguous_ms,
          "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_packed_ms": lib_packed_ms, "bound_ms": b_ms, "bound_by": b_by,
          "x_bound": ms / b_ms, "x_library": ms / lib_ms,
          **info})


def attention_bwd_bound(B, H, S, D, causal):
    """The backward's least time: 7 tensors of B H S D floats moved (q, k,
    v, o, dO in; dq, dk, dv out) against 10 D FLOPs per visible (query,
    key) pair: the five products the function needs (s, dP, dV, dQ, dK),
    2 D each.  The kernel's second pass recomputes s and dP; that is its
    choice, not the function's work."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return bound(7 * B * H * S * D * 4, pairs * 10 * D)


def check_attention_bwd_kernel(failures, results):
    """B4's backward (the port's own kernel) against its plain version at
    the Tao training shapes, around them and at the edges of its tiles,
    causal and not, and at widths and strides that are not multiples of 4
    floats: gradients within tolerance, two calls bitwise equal, the
    forward's output bitwise the same with and without its log-sum-exp,
    which is held to the plain one; then what each of its kernels gets
    (registers, spills, shared memory, blocks) and its times beside its
    bound, the plain version's and SDPA's backward at the training shape."""
    import torch

    from repro_torch.kernels.attention.kernel import (
        BWD_KERNEL_NAMES,
        bwd_launch_info,
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.attention.ref import attention_bwd_plain, attention_lse_plain

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    worst, all_ok, timed = 0.0, True, {}

    def held(q, k, v, do, causal):
        """The kernel against the plain version on one input: the line's
        checks, and the forward's (out, lse)."""
        out_only = flash_attention_cuda(q, k, v, causal=causal)
        out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        ref = attention_bwd_plain(q, k, v, out, lse, do, causal)
        lse_ref = attention_lse_plain(q, k, causal=causal)
        torch.cuda.synchronize()
        within = all(bool(torch.all((a - b).abs() <= ATTN_BWD_ATOL + ATTN_BWD_RTOL * b.abs()))
                     for a, b in zip(got, ref))
        lse_ok = bool(torch.all((lse - lse_ref).abs() <= LSE_ATOL + LSE_RTOL * lse_ref.abs()))
        r = {"max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
             "atol": ATTN_BWD_ATOL, "rtol": ATTN_BWD_RTOL,
             "lse_max_abs_err": float((lse - lse_ref).abs().max()), "lse_atol": LSE_ATOL,
             "two_calls_bitwise": all(torch.equal(a, b) for a, b in zip(got, again)),
             "forward_out_bitwise_with_and_without_lse": torch.equal(out, out_only)}
        r["ok"] = (within and lse_ok and r["two_calls_bitwise"]
                   and r["forward_out_bitwise_with_and_without_lse"])
        return r, out, lse

    for name, (B, H, S, D, causal) in ATTN_BWD_CASES.items():
        # q, k, v as the Tao block hands them over: views of one packed projection
        q, k, v = packed_qkv(B, S, H, D, lambda *shape: torch.randn(*shape, generator=g).to(dev))
        do = torch.randn(B, S, H, D, generator=g).to(dev).transpose(1, 2)
        r, out, lse = held(q, k, v, do, causal)
        worst, all_ok = max(worst, r["max_abs_err"]), all_ok and r["ok"]
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", "case": name,
              "shape": [B, H, S, D], "causal": causal, **r})
        if name.startswith("tao_b") and causal:
            timed[B] = (q, k, v, out, lse, do)
    # widths and strides that are not multiples of 4 floats: q, k, v cut
    # from one (B, H, S, 2D + 1) tensor, dO from a wider one
    B, H, S, D = ATTN_BWD_UNALIGNED
    base = torch.randn(B, H, S, 2 * D + 1, generator=g).to(dev)
    q, k, v = base[..., :D], base[..., D:2 * D], base[..., 1:D + 1]
    do = torch.randn(B, H, S, 2 * D + 1, generator=g).to(dev)[..., 2:D + 2]
    r, _, _ = held(q, k, v, do, True)
    worst, all_ok = max(worst, r["max_abs_err"]), all_ok and r["ok"]
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "case": "unaligned_strides",
          "shape": [B, H, S, D], "causal": True, "q_strides": list(q.stride()),
          "dout_strides": list(do.stride()), **r})
    # a row that sees no key (segments, q_offset past Sk): lse +inf, out 0
    q, k, v = (torch.randn(2, 2, 12, 16, generator=g).to(dev) for _ in range(3))
    seg = torch.zeros(2, 12, dtype=torch.int32, device=dev)
    out, lse = flash_attention_cuda(q, k, v, seg, causal=False, q_offset=6, return_lse=True)
    ref = attention_lse_plain(q, k, seg, causal=False, q_offset=6)
    torch.cuda.synchronize()
    past = lse[:, :, 6:]
    no_key_ok = bool(torch.all(torch.isinf(past) & (past > 0)) and torch.all(out[:, :, 6:] == 0)
                     and torch.equal(torch.isinf(ref), torch.isinf(lse)))
    emit({"phase": "kernels", "kernel": "flash_attention", "check": "lse_of_rows_without_keys",
          "rows": int(past[0, 0].numel()), "lse_plus_inf_and_out_zero": no_key_ok})
    if not (all_ok and no_key_ok):
        failures.append("flash_attention_bwd: kernel outside tolerance of the plain version, "
                        "not deterministic, or the forward's lse / out wrong")

    # what each kernel gets at the training shapes; no spills at batch 16
    info = {B: bwd_launch_info(B, *timed[B][0].shape[1:]) for B in sorted(timed)}
    spills = {n: i["spill_bytes_per_thread"] for n, i in info[TRAIN_BATCH].items()}
    if any(spills.values()):
        failures.append(f"flash_attention_bwd: spill bytes per thread {spills}")
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "check": "launch_info",
          "per_batch": {str(B): i for B, i in info.items()}})

    # times at the training shapes: the kernel (graph replay: device time),
    # its eager call, the device ms of each of its kernels (profiler, 20
    # calls), one (batch, head) alone (what a single block chain takes), the
    # plain version, and SDPA's backward (its kernels' device time from the
    # profiler, over 20 calls of autograd.grad)
    lines = {}
    for B, (q, k, v, out, lse, do) in sorted(timed.items()):
        _, H, S, D = q.shape
        ms = graph_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True))
        call_ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True), 100)
        kprof = profile_breakdown(
            lambda: [flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True) for _ in range(20)],
            track=BWD_KERNEL_NAMES)
        kernel_ms = {n: t / 20 for n, t in kprof["tracked_ms"].items()}
        one = tuple(x[:1, :1] for x in (q, k, v, out, lse, do))
        one_bh_ms = graph_ms(lambda: flash_attention_bwd_cuda(*one, causal=True))
        plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, out, lse, do, True), 20)
        qs, ks, vs = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        dc = do.contiguous()

        def sdpa_bwd():
            for _ in range(20):
                torch.autograd.grad(lib_out, (qs, ks, vs), dc, retain_graph=True)

        sdpa_bwd()
        prof = profile_breakdown(sdpa_bwd)
        lib_ms = prof["device_busy_s"] * 1e3 / 20
        b_ms, b_by = attention_bwd_bound(B, H, S, D, True)
        lines[B] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", "shape": [B, H, S, D],
              "causal": True, "operands": "packed_qkv_views", **lines[B], "x_bound": ms / b_ms,
              "x_library": ms / lib_ms, "kernel_ms": kernel_ms, "one_batch_head_ms": one_bh_ms,
              "library": "scaled_dot_product_attention backward",
              "library_kernels": [t[0] for t in prof["top_device_ms"][:4]]})
    at = lines[TRAIN_BATCH]
    results["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/attention_bwd.cu",
        # no TPU kernel: the reference's trainer differentiates its jnp attention
        "replaces": "src/repro/core/model.py:217",
        "max_abs_err": worst, "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"], "library_ms": at["library_ms"],
    }


def ssd_inputs(B, S, H, P, G, N, dtype, seed):
    """SSD inputs on the card in the model's regime: dt = softplus(noise
    - 4), mostly 0.002-0.3, and A = -(1..H), so a chunk's prefix sum
    reaches -10^3 on the fast heads."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    dt = F.softplus(torch.randn(B, S, H, generator=g, device="cuda") - 4.0).to(dtype)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    return rand(B, S, H, P), dt, A, rand(B, S, G, N, scale=0.5), rand(B, S, G, N, scale=0.5)


def sass_hmma_counts(library: Path, kernel: str) -> dict:
    """HMMA (tensor-core) instructions in each instantiation of ``kernel``
    in a built library's SASS, from ``cuobjdump -sass``: {mangled name: n}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


def check_ssd_kernel(failures, results):
    """B5 against its plain chunked version (y and the final state) at the
    full mamba2-1.3b prefill shape in float32 and bfloat16, with two
    groups, in one chunk, at chunk 200 and at widths 40 / 72, and against
    the sequential recurrence; its launch resources and the tensor-core
    instructions in its SASS; timed at the prefill shape in bfloat16, with
    the state written, as prefill launches it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels._cuda import build
    from repro_torch.kernels.ssd.kernel import SSD_SCAN, launch_info, ssd_scan_cuda
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_sequential_ref

    s = get_arch("mamba2-1.3b").ssm
    d = get_arch("mamba2-1.3b").d_model
    H, P, G, N, c = s.n_heads(d), s.head_dim, s.n_groups, s.d_state, s.chunk
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {  # name: (B, S, H, P, G, N, chunk, dtype), against the chunked version
        "prefill_f32": (MAMBA_BATCH, MAMBA_PROMPT, H, P, G, N, c, f32),
        "prefill_bf16": (MAMBA_BATCH, MAMBA_PROMPT, H, P, G, N, c, bf16),
        "two_groups_f32": (MAMBA_BATCH, 512, H, P, 2, N, c, f32),
        "single_chunk_f32": (MAMBA_BATCH, c, H, P, G, N, c, f32),
        "vs_sequential_f32": (2, 512, H, P, G, N, c, f32),
        # a chunk that is a multiple of neither 16 nor the 64-row tile, and
        # widths that are not multiples of the 16-wide fragments
        "chunk_200_f32": (2, 400, H, P, G, N, 200, f32),
        "chunk_200_bf16": (2, 400, H, P, G, N, 200, bf16),
        "widths_40_72_f32": (1, 256, 8, 40, G, 72, 64, f32),
        "widths_40_72_bf16": (1, 256, 8, 40, G, 72, 64, bf16),
    }
    ok, max_err = True, 0.0
    for i, (name, (B, S, h, p, g, n, cc, dtype)) in enumerate(cases.items()):
        inp = ssd_inputs(B, S, h, p, g, n, dtype, i)
        y, state = ssd_scan_cuda(*inp, chunk=cc, return_state=True)
        if name == "vs_sequential_f32":
            y_ref, state_ref = ssd_sequential_ref(*inp), None
        else:
            y_ref, state_ref = ssd_chunked_ref(*inp, cc, return_state=True)
        torch.cuda.synchronize()
        tol = SSD_TOL[str(dtype).split(".")[-1]]
        err = float((y.float() - y_ref.float()).abs().max())
        good = bool(torch.isfinite(y.float()).all()) and bool(
            torch.all((y.float() - y_ref.float()).abs() <= tol + tol * y_ref.float().abs()))
        line = {"phase": "kernels", "kernel": "ssd", "case": name, "shape": [B, S, h, p, g, n, cc],
                "dtype": str(dtype), "y_max_abs_err": err, "y_tol": tol,
                "y_max_abs": float(y_ref.float().abs().max())}
        if state_ref is not None:
            s_err = float((state - state_ref).abs().max())
            good &= bool(torch.all((state - state_ref).abs()
                                   <= SSD_STATE_TOL + SSD_STATE_TOL * state_ref.abs()))
            line.update(state_max_abs_err=s_err, state_tol=SSD_STATE_TOL)
            err = max(err, s_err)
        line["ok"] = good
        emit(line)
        ok &= good
        max_err = max(max_err, err)
        del inp, y, state, y_ref, state_ref
    if not ok:
        failures.append("ssd: kernel outside tolerance of its plain version")

    B, S = MAMBA_BATCH, MAMBA_PROMPT
    inp = ssd_inputs(B, S, H, P, G, N, bf16, 0)
    ms = graph_ms(lambda: ssd_scan_cuda(*inp, chunk=c, return_state=True), per_graph=5, replays=10)
    call_ms = cuda_ms(lambda: ssd_scan_cuda(*inp, chunk=c, return_state=True), 10)
    plain_ms = cuda_ms(lambda: ssd_chunked_ref(*inp, c, return_state=True), 3, warmup=1)
    nbytes = (2 * B * S * H * P + 2 * B * S * G * N + B * S * H) * 2 + H * 4 + B * H * N * P * 4
    # what the function needs: the causal scores C Bᵀ and the W X product
    # over the lower triangle only (c(c+1)/2 entries per chunk, per group
    # and per head), plus the state's apply and update, 4NPH per token
    flops = B * (S // c) * (c * (c + 1) // 2) * 2 * (G * N + H * P) + B * S * 4 * N * P * H
    # priced at the bf16 tensor-core rate: the kernel's products run there
    b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
    info = launch_info(N, c, bf16)
    if info["spill_bytes_per_thread"]:
        failures.append(f"ssd: {info['spill_bytes_per_thread']} spill bytes per thread")
    if info["blocks_per_sm"] < 1:
        failures.append("ssd: no block fits on an SM")
    hmma = sass_hmma_counts(build([SSD_SCAN.source])[SSD_SCAN.source], "ssd_kernel")
    if len(hmma) != 2 or not all(hmma.values()):
        failures.append(f"ssd: no tensor-core (HMMA) instructions in an instantiation: {hmma}")
    results["ssd"] = {
        "name": "ssd", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:26",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit({"phase": "kernels", "kernel": "ssd", "shape": [B, S, H, P, G, N, c], "dtype": "bfloat16",
          "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "x_bound": ms / b_ms, "fp32_cuda_core_bound_ms": flops / FP32_FLOPS_PER_S * 1e3,
          "bytes": nbytes, "flops": flops, "library_ms": None, **info,
          "sass_hmma": {("bfloat16" if "bfloat16" in k else "float32"): v for k, v in hmma.items()}})


def bitwise_equal(a, b) -> bool:
    """Same shape, dtype and float32 bit patterns (any device, or NumPy)."""
    import numpy as np
    import torch

    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(np.array_equal(a.view(np.int32), b.view(np.int32)) if a.dtype == np.float32
                else np.array_equal(a, b))


def b2_pass_ms(kern) -> dict:
    """Device ms per call of each of B2's kernels (named br_*, and the
    bucket starts' scan_exclusive), over PASS_CALLS profiled calls."""
    prof = profile_breakdown(lambda: [kern() for _ in range(PASS_CALLS)],
                             track=("br_", "scan_exclusive"))
    return {k: ms / PASS_CALLS for k, ms in prof["tracked_ms"].items()}


def check_staged_kernels(failures, results, traces):
    """B2 and B3 bitwise against their plain versions on whole traces, the
    staged extraction and the eager signed-log against the NumPy spec; the
    eager signed-log on a trace's raw deltas, which B3's gather replaced,
    timed beside B3; B2's passes timed apart, on the benchmark traces and
    the random-bucket cases."""
    import numpy as np
    import torch

    from repro_torch.core.features import FeatureConfig, extract_features, signed_log
    from repro_torch.kernels.features.kernel import (
        KERNELS_PER_CALL,
        branch_history_cuda,
        memdist_delta_cuda,
    )
    from repro_torch.kernels.features.ops import (
        _per_instruction_device,
        device_feature_arrays,
        signed_log as signed_log_torch,
        trace_columns,
    )
    from repro_torch.kernels.features.ref import (
        branch_history_plain,
        memdist_delta_plain,
        memdist_feature_plain,
    )

    dev = torch.device("cuda")
    fcfg = FeatureConfig()
    wide = traces["mcf"].copy()
    wide["addr"][wide["is_mem"]] += WIDE_ADDR_OFFSET
    cases = [(b, fcfg, traces[b]) for b in SLICE_BENCHMARKS]
    cases += [(f"{b}_collision", FeatureConfig(*COLLISION_SHAPE), traces[b]) for b in SLICE_BENCHMARKS]
    cases += [("mcf_wide_addresses", fcfg, wide)]
    cases += [(f"random_buckets_{nb}", FeatureConfig(n_buckets=nb), random_trace(SLICE_INSTRUCTIONS, i, 2 * nb))
              for i, nb in enumerate(MANY_BUCKETS)]
    cases += [("edge_deltas", fcfg, edge_delta_trace(2))]
    cases += [(f"tile_edge_{'two_buckets' if alt else 'one_bucket'}_{n}", fcfg, tile_edge_trace(n, alt, 3))
              for alt in (False, True) for n in TILE_EDGE_LENGTHS]
    ok = {"branch_history": True, "memdist_delta": True, "device_feature_arrays": True}
    err = {"branch_history": 0.0, "memdist_delta": 0.0}
    timing = {"branch_history": [], "memdist_delta": []}
    eager = []  # the eager signed-log on a benchmark trace's raw deltas
    b2_cases = {}  # B2 on the random-bucket cases
    b2_kernels = None  # kernels one B2 call enqueues
    for name, cfg, trace in cases:
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in trace_columns(trace, cfg).items()}
        _, _, outcome, mem = _per_instruction_device(
            cols["opcode"], cols["dst"], cols["src1"], cols["src2"],
            cols["is_branch"], cols["taken"], cols["is_mem"], cols["is_store"])
        runs = {
            "branch_history": (
                lambda: branch_history_cuda(cols["bucket"], outcome, cfg.n_buckets, cfg.n_queue),
                lambda: branch_history_plain(cols["bucket"], outcome, cfg.n_buckets, cfg.n_queue)),
            "memdist_delta": (
                lambda: memdist_delta_cuda(cols["addr"], mem, cfg.n_mem),
                lambda: memdist_feature_plain(cols["addr"], mem, cfg.n_mem)),
        }
        line = {"phase": "kernels", "check": "staged_scans", "case": name,
                "config": [cfg.n_buckets, cfg.n_queue, cfg.n_mem], "positions": len(trace)}
        for kname, (kern, plain) in runs.items():
            a, b = kern(), plain()
            torch.cuda.synchronize()
            same = bitwise_equal(a, b)
            ok[kname] &= same
            err[kname] = max(err[kname], float((a - b).abs().max()))
            line[f"{kname}_bitwise_vs_plain"] = same
            if cfg == fcfg and name in SLICE_BENCHMARKS:
                timing[kname].append({
                    "ms": graph_ms(kern), "call_ms": cuda_ms(kern, 50),
                    "plain_ms": cuda_ms(plain, 5), "n": len(trace),
                    "n_mem": int(trace["is_mem"].sum()),
                })
                if kname == "branch_history":
                    timing[kname][-1]["pass_ms"] = b2_pass_ms(kern)
                    b2_kernels = b2_kernels or kernels_enqueued(kern)
                if kname == "memdist_delta":
                    raw = memdist_delta_plain(cols["addr"], mem, cfg.n_mem)
                    eager.append({"ms": graph_ms(lambda: signed_log_torch(raw)),
                                  "kernels_enqueued": kernels_enqueued(lambda: signed_log_torch(raw))})
                    del raw
            if kname == "branch_history" and name.startswith("random_buckets"):
                b_ms = bound(len(trace) * (8 + 4 * cfg.n_queue), 0)[0]
                b2_cases[name] = {"ms": graph_ms(kern), "pass_ms": b2_pass_ms(kern),
                                  "bound_ms": b_ms}
                b2_cases[name]["x_bound"] = b2_cases[name]["ms"] / b_ms
                line["branch_history_ms"] = b2_cases[name]["ms"]
        spec = extract_features(trace, cfg, with_labels=False)
        arrays = device_feature_arrays(trace_columns(trace, cfg), cfg, device=dev)
        same = all(bitwise_equal(arrays[f], getattr(spec, f))
                   for f in ("opcode", "regbits", "flags", "brhist", "memdist"))
        ok["device_feature_arrays"] &= same
        line["device_feature_arrays_bitwise_vs_numpy_spec"] = same
        emit(line)
        del cols, arrays, spec

    # the eager signed-log on the card: edge values and mantissas around sqrt(2)
    rng = np.random.default_rng(0)
    x = np.array([np.nextafter(np.float32(np.sqrt(2)), np.float32(0)), np.float32(np.sqrt(2)),
                  np.nextafter(np.float32(np.sqrt(2)), np.float32(2))])
    near = (x * np.float32(2.0) ** np.arange(40, dtype=np.float32)[:, None] - np.float32(1)).ravel()
    d = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, 1e-45, -1e-45, 1e-38, 2.0**62, -(2.0**62), 3.4e38]),
        near, -near, rng.integers(-(2**62), 2**62, 100_000).astype(np.float64),
        rng.integers(-4096, 4096, 8192),
    ]).astype(np.float32)
    sl_ok = bitwise_equal(signed_log_torch(torch.from_numpy(d).to(dev)), signed_log(d))
    emit({"phase": "kernels", "check": "eager_signed_log_on_card", "values": int(d.size),
          "bitwise_vs_numpy_spec": sl_ok, "raw_deltas_of": list(SLICE_BENCHMARKS),
          "raw_deltas_per_trace_ms": [e["ms"] for e in eager],
          "raw_deltas_kernels_enqueued": [e["kernels_enqueued"] for e in eager]})
    if not sl_ok:
        failures.append("signed_log: eager torch CUDA ops differ from the NumPy spec")
    if not ok["device_feature_arrays"]:
        failures.append("device_feature_arrays: staged extraction != NumPy spec")

    fields = {"branch_history": fcfg.n_queue, "memdist_delta": fcfg.n_mem}
    sources = {"branch_history": "src/repro/kernels/features/kernel.py:39",
               "memdist_delta": "src/repro/kernels/features/kernel.py:71"}
    for kname, width in fields.items():
        if not ok[kname]:
            failures.append(f"{kname}: kernel != plain version")
        rows = timing[kname]
        bounds = []
        for r in rows:
            if kname == "branch_history":  # bucket + outcome in, (n, N_q) f32 out; copies only
                bounds.append(bound(r["n"] * (8 + 4 * width), 0))
            else:  # addr + mask in, (n, N_m) f32 out; the delta and its signed-log per valid slot
                slots = sum(min(k, width) for k in range(r["n_mem"]))
                bounds.append(bound(r["n"] * (9 + 4 * width), SIGNED_LOG_SLOT_FLOPS * slots))
        mean = lambda key: sum(r[key] for r in rows) / len(rows)  # noqa: E731
        b_ms = sum(b[0] for b in bounds) / len(bounds)
        results[kname] = {
            "name": kname, "route": "cuda", "source": "src/repro_torch/csrc/feature_scans.cu",
            "replaces": sources[kname], "max_abs_err": err[kname], "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": b_ms, "bound_by": bounds[0][1],
            "library_ms": None,
        }
        passes = {}
        if kname == "branch_history":
            if b2_kernels != KERNELS_PER_CALL:
                failures.append(f"branch_history: one call ran {b2_kernels} kernels, not {KERNELS_PER_CALL}")
            names = sorted({k for r in rows for k in r["pass_ms"]})
            passes = {"pass_ms": {k: sum(r["pass_ms"].get(k, 0.0) for r in rows) / len(rows) for k in names},
                      "kernels_per_call": b2_kernels, "per_case": b2_cases}
        emit({"phase": "kernels", "kernel": kname, "traces": list(SLICE_BENCHMARKS),
              "positions": rows[0]["n"], "bitwise_vs_plain": ok[kname],
              "per_trace_ms": [r["ms"] for r in rows], "ms": mean("ms"),
              "call_ms": mean("call_ms"), "plain_ms": mean("plain_ms"),
              "bound_ms": b_ms, "bound_by": bounds[0][1], "x_bound": mean("ms") / b_ms,
              "library_ms": None, **passes})


def flip_check(got, ref, trace, cfg, flip_fraction=FLIP_FRACTION, prob_atol=PROB_ATOL) -> dict:
    """Whether every metric difference between two collected runs of one
    trace is explained by the decodes that flipped (see FLIP_FRACTION): a
    fetch flip moves the cycle sum by at most the top bucket (256), the
    last exec latency by 256 once, a miss count by one per flip; a phase
    chunk holds at least its share of instructions / memory ops.
    ``flip_fraction`` and ``prob_atol``: the limits (int8: see
    INT8_FLIP_FRACTION)."""
    import numpy as np

    n = got.num_instructions
    prob_diff = np.abs(got.mispred_prob - ref.mispred_prob)
    flipped = {
        "fetch_lat": got.fetch_lat != ref.fetch_lat,
        "exec_lat": got.exec_lat != ref.exec_lat,
        "dlevel": got.dlevel != ref.dlevel,
        "mispredict": (got.mispred_prob > 0.5) != (ref.mispred_prob > 0.5),
        "l1d_miss": (got.dlevel >= 2) != (ref.dlevel >= 2),
    }
    flips = {k: int(v.sum()) for k, v in flipped.items()}
    prob_err = float(prob_diff.max())
    diffs = {
        "cpi_abs": abs(got.cpi - ref.cpi),
        "branch_mpki_abs": abs(got.branch_mpki - ref.branch_mpki),
        "l1d_mpki_abs": abs(got.l1d_mpki - ref.l1d_mpki),
    }
    tols = {
        "cpi_abs": 256.0 * (flips["fetch_lat"] + 1) / n,
        "branch_mpki_abs": 1000.0 * flips["mispredict"] / n,
        "l1d_mpki_abs": 1000.0 * flips["l1d_miss"] / n,
    }
    if "cpi_phase" in ref.metrics:  # the legacy loop computes no phase curves
        tr = trace[:n]
        chunk_of = (np.arange(n) // cfg.window) * 32 // (n // cfg.window)
        min_chunk = np.bincount(chunk_of, minlength=32).min()
        min_mem_chunk = max(1, np.bincount(chunk_of, weights=tr["is_mem"], minlength=32).min())
        diffs["cpi_phase_max_abs"] = float(np.abs(got.cpi_phase - ref.cpi_phase).max())
        diffs["l1d_phase_max_abs"] = float(np.abs(got.l1d_phase - ref.l1d_phase).max())
        tols["cpi_phase_max_abs"] = 256.0 * flips["fetch_lat"] / min_chunk
        tols["l1d_phase_max_abs"] = flips["l1d_miss"] / min_mem_chunk
    ok = (
        got.num_instructions == ref.num_instructions
        and max(flips.values()) <= flip_fraction * n
        and prob_err <= prob_atol
        and all(diffs[k] <= tols[k] * (1 + 1e-6) + 1e-9 for k in diffs)
    )
    return {"flips": flips, "flip_share": max(flips.values()) / n, "flip_limit": flip_fraction,
            "mispred_prob_max_abs": prob_err, "mispred_prob_limit": prob_atol,
            "mispred_prob_p99_abs": float(np.quantile(prob_diff, 0.99)),
            "mispred_prob_moved_share": float(np.mean(prob_diff > PROB_ATOL)),
            "diffs": diffs, "tols": tols, "ok": ok}


def same_metrics(a, b) -> bool:
    import numpy as np

    return a.metrics.keys() == b.metrics.keys() and all(
        np.array_equal(a.metrics[k], b.metrics[k]) for k in a.metrics)


def phase_slice(failures, results, traces):
    import numpy as np
    import torch

    from repro_torch.core.model import TaoConfig, init_tao
    from repro_torch.engine import EngineConfig, StreamingEngine, cache_stats
    from repro_torch.engine.aot import graph_kernel_names
    from repro_torch.kernels.attention.kernel import FLASH_ATTENTION
    from repro_torch.kernels.features.ops import device_feature_arrays, trace_columns

    cfg = TaoConfig()
    fcfg = cfg.features
    metrics = ("cpi", "branch_mpki", "l1d_mpki", "cpi_phase", "l1d_phase")
    ecfg = EngineConfig(metrics=metrics)
    ecfg_c = EngineConfig(metrics=metrics, collect=True)

    def extract(trace):
        arrays = device_feature_arrays(trace_columns(trace, fcfg), fcfg, device="cuda")
        torch.cuda.synchronize()
        return arrays

    model = init_tao(cfg, torch.Generator().manual_seed(0), device="cuda")
    engine = StreamingEngine(model, cfg, ecfg, device="cuda")
    # the step captured ahead of time: one CUDA graph for every trace
    t0 = time.perf_counter()
    entry = engine.warmup(SLICE_INSTRUCTIONS)
    capture_s = time.perf_counter() - t0
    emit({"phase": "slice", "check": "capture", "seconds": capture_s, "compiles": entry.compiles,
          "retained_bytes_est": entry.est_bytes,
          "launches_per_replay": {k.symbol: n for k, n in entry.aot.launches.items()},
          "cache_stats": cache_stats()})
    engine.simulate(traces["lee"])  # warm-up: allocator pools, the column copies
    engine.simulate(traces["lee"], features=extract(traces["lee"]))

    # ---- the fused route: raw traces
    zero_counts()
    replays = entry.aot.replays
    res = {b: engine.simulate(t) for b, t in traces.items()}
    launches = read_counts()
    replays = entry.aot.replays - replays
    batches = sum(-(-(r.num_instructions // cfg.window) // ecfg.batch_size) for r in res.values())
    for b, r in res.items():
        scalars = [r.cpi, r.total_cycles, r.branch_mpki, r.l1d_mpki]
        curves = [r.cpi_phase, r.l1d_phase]
        if not (all(math.isfinite(x) for x in scalars)
                and all(np.isfinite(c).all() and c.shape == (32,) for c in curves)):
            failures.append(f"slice: non-finite or misshapen metrics on {b}")
        emit({"phase": "slice", "route": "fused", "trace": b, "num_instructions": r.num_instructions,
              "seconds": r.seconds, "mips": r.mips, "cpi": r.cpi,
              "total_cycles": r.total_cycles, "branch_mpki": r.branch_mpki,
              "l1d_mpki": r.l1d_mpki})
    expected = {"fused_features": batches, "branch_history": 0, "memdist_delta": 0, "ssd": 0,
                "flash_attention_bwd": 0}
    got = {k: v for k, v in launches.items() if k != "flash_attention"}
    if got != expected:
        failures.append(f"slice: fused route launches {got}, expected {expected}")
    # B4 runs inside the replayed graph: its launches by the graph's own
    # kernel nodes and by the capture-time count, each times the replays,
    # against the wrapper's count (which the replays add to)
    attn_nodes = sum("attention_kernel" in k for k in graph_kernel_names(entry.aot.graph))
    b4 = {"counter": launches["flash_attention"], "graph_nodes_x_replays": attn_nodes * replays,
          "captured_x_replays": entry.aot.launches.get(FLASH_ATTENTION, 0) * replays}
    if not (attn_nodes == cfg.n_layers and replays == batches
            and set(b4.values()) == {cfg.n_layers * batches}):
        failures.append(f"slice: attention nodes {attn_nodes} per graph, {replays} replays for "
                        f"{batches} batches, launches {b4}")
    if engine.num_compiles != 1:
        failures.append(f"slice: {engine.num_compiles} captures, expected the warmup's one")
    for name in ("fused_features", "flash_attention"):
        results[name]["launches"] = launches[name]
    total_n = sum(r.num_instructions for r in res.values())
    total_s = sum(r.seconds for r in res.values())
    emit({"phase": "slice", "route": "fused", "traces": list(SLICE_BENCHMARKS),
          "instructions": total_n, "simulate_seconds": total_s, "mips": total_n / 1e6 / total_s,
          "batches": batches, "launches": launches, "replays": replays,
          "attention_nodes_per_graph": attn_nodes, "flash_attention_counts": b4,
          "captures": engine.num_compiles})

    # ---- the staged route: one whole-trace extraction per trace, on the card
    zero_counts()
    staged = {}
    for b, t in traces.items():
        t0 = time.perf_counter()
        arrays = extract(t)
        ext_s = time.perf_counter() - t0
        staged[b] = (ext_s, engine.simulate(t, features=arrays))
        del arrays
    s_launches = read_counts()
    expected = {"fused_features": 0, "flash_attention": cfg.n_layers * batches,
                "branch_history": len(traces), "memdist_delta": len(traces), "ssd": 0,
                "flash_attention_bwd": 0}
    if s_launches != expected:
        failures.append(f"slice: staged route launches {s_launches}, expected {expected}")
    for name in ("branch_history", "memdist_delta"):
        results[name]["launches"] = s_launches[name]
    for b, (ext_s, r) in staged.items():
        held = "exact" if same_metrics(r, res[b]) else None
        check = None
        if held is None:  # compare the decodes of both routes, collected
            eng_c = StreamingEngine(model, cfg, ecfg_c, device="cuda")
            check = flip_check(eng_c.simulate(traces[b], features=extract(traces[b])),
                               eng_c.simulate(traces[b]), traces[b], cfg)
            held = "flip_explained" if check["ok"] else "neither"
        if held == "neither":
            failures.append(f"slice: staged and fused routes disagree beyond the flips on {b}")
        emit({"phase": "slice", "route": "staged", "trace": b, "num_instructions": r.num_instructions,
              "extraction_seconds": ext_s, "simulate_seconds": r.seconds,
              "mips": r.num_instructions / 1e6 / (ext_s + r.seconds),
              "simulate_only_mips": r.mips, "fused_mips": res[b].mips, "cpi": r.cpi,
              "vs_fused": held, **({"flip_check": check} if check else {})})
    ext_total = sum(e for e, _ in staged.values())
    sim_total = sum(r.seconds for _, r in staged.values())

    # device memory the staged route holds for one trace
    n_lee = len(traces["lee"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    arrays = extract(traces["lee"])
    held_bytes = sum(v.numel() * v.element_size() for v in arrays.values())
    peak = torch.cuda.max_memory_allocated() - base
    del arrays
    per_extraction = kernels_enqueued(lambda: extract(traces["lee"]))
    emit({"phase": "slice", "route": "staged", "traces": list(SLICE_BENCHMARKS),
          "instructions": total_n, "extraction_seconds": ext_total, "simulate_seconds": sim_total,
          "mips": total_n / 1e6 / (ext_total + sim_total),
          "simulate_only_mips": total_n / 1e6 / sim_total,
          "fused_mips": total_n / 1e6 / total_s, "launches": s_launches,
          "held_bytes_per_instruction": held_bytes / n_lee,
          "peak_extraction_bytes_per_instruction": peak / n_lee,
          "kernels_enqueued_per_extraction": per_extraction})

    # ---- both routes side by side, in turns (fused, staged, staged, fused):
    # medians per trace of the fused simulate, the staged extraction and
    # the staged simulate reusing that extraction
    turns = {b: {"fused_s": [], "extraction_s": [], "staged_simulate_s": []} for b in traces}
    for _ in range(ROUTE_ROUNDS):
        for b, t in traces.items():
            turns[b]["fused_s"].append(engine.simulate(t).seconds)
            t0 = time.perf_counter()
            arrays = extract(t)
            turns[b]["extraction_s"].append(time.perf_counter() - t0)
            for _ in range(2):
                turns[b]["staged_simulate_s"].append(engine.simulate(t, features=arrays).seconds)
            del arrays
            turns[b]["fused_s"].append(engine.simulate(t).seconds)
    med = {b: {k: float(np.median(v)) for k, v in d.items()} for b, d in turns.items()}
    fused_s = sum(m["fused_s"] for m in med.values())
    ext_s = sum(m["extraction_s"] for m in med.values())
    sim_s = sum(m["staged_simulate_s"] for m in med.values())
    gain = fused_s - sim_s  # per model, once the extraction is shared
    emit({"phase": "slice", "check": "routes_side_by_side", "rounds": ROUTE_ROUNDS,
          "instructions": total_n, "per_trace_median_s": med,
          "fused_mips": total_n / 1e6 / fused_s,
          "staged_mips": total_n / 1e6 / (ext_s + sim_s),
          "staged_simulate_only_mips": total_n / 1e6 / sim_s,
          "models_to_amortize_extraction": ext_s / gain if gain > 0 else None})

    # ---- the same engine on the CPU (plain versions), one trace, same weights
    name = SLICE_BENCHMARKS[0]
    gpu = StreamingEngine(model, cfg, ecfg_c, device="cuda").simulate(traces[name])
    cpu_model = init_tao(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu = StreamingEngine(cpu_model, cfg, ecfg_c, device="cpu").simulate(traces[name])
    check = flip_check(gpu, cpu, traces[name], cfg)
    if not check["ok"]:
        failures.append(f"slice: GPU and CPU engines disagree beyond tolerance on {name}")
    emit({"phase": "slice", "check": "gpu_vs_cpu", "trace": name, "positions": gpu.num_instructions,
          **check, "gpu_mips": gpu.mips, "cpu_mips": cpu.mips})
    # B1's passes are its source's kernels, named fx_*
    prof = profile_breakdown(lambda: engine.simulate(traces["lee"]), track=("fx_",))
    lee_batches = -(-(res["lee"].num_instructions // cfg.window) // ecfg.batch_size)
    b1_passes = {k: ms / lee_batches for k, ms in prof.pop("tracked_ms").items()}
    emit({"phase": "slice", "check": "profile", "trace": "lee", "batches": lee_batches,
          "copy_kernels_per_batch": prof["copy_kernels"] / lee_batches,
          "fused_features_pass_ms_per_batch": b1_passes, **prof})

    arrays = {b: extract(t) for b, t in traces.items()}
    graph_vs_eager(failures, engine, traces, arrays, total_n, batches, lee_batches)
    slice_int8(failures, traces, arrays, model, engine, extract, batches, lee_batches)


def eager_entry_loop(engine, trace, features=None):
    """The engine's own batches folded through its cache entry called
    directly: the eager step, one dispatch per torch op (what simulate ran
    before the step was captured)."""
    import torch

    t0 = time.perf_counter()
    n, count, batches = engine._batches(trace, features)
    entry = engine.step_entry_for(n)
    carry = engine.init_carry(n)
    with torch.inference_mode():
        for b in batches:
            carry, _ = entry(engine.params, carry, b)
        return engine._result(carry, [], count, t0)


def graphed_vs_eager_diffs(graphed, eager, eager2) -> dict:
    """Which metrics the graphed simulate holds bitwise to the eager loop,
    and the relative spread of the float32 phase sums that go through
    index_add_'s atomics: eager against eager, graphed against eager."""
    import numpy as np

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    bitwise = {k: bool(np.array_equal(graphed.metrics[k], v)) for k, v in eager.metrics.items()}
    return {"bitwise": bitwise,
            "cpi_phase_rel_eager_vs_eager": rel(eager2.metrics["cpi_phase"], eager.metrics["cpi_phase"]),
            "cpi_phase_rel_graphed_vs_eager": rel(graphed.metrics["cpi_phase"], eager.metrics["cpi_phase"])}


def graph_vs_eager(failures, engine, traces, arrays, total_n, batches, lee_batches):
    """The graphed simulate against the eager entry loop, in turns (graphed,
    eager, eager, graphed) per trace, on both routes (the staged one
    reusing one extraction per trace): medians per trace, MIPS, host ms per
    batch (host clock around each run, which ends in the packed copy's
    sync), and from one profiled run of each on ``lee`` the device ms per
    batch and the idle share.  Results held bitwise, except ``cpi_phase``
    within GRAPH_PHASE_RTOL."""
    import numpy as np

    from repro_torch.engine import cache_stats

    for route in ("fused", "staged"):
        secs = {b: {"graphed": [], "eager": []} for b in traces}
        held = {}
        for _ in range(ROUTE_ROUNDS):
            for b, t in traces.items():
                feats = None if route == "fused" else arrays[b]
                runs = {}
                for mode in ("graphed", "eager", "eager2", "graphed2"):
                    r = (engine.simulate(t, features=feats) if mode.startswith("graphed")
                         else eager_entry_loop(engine, t, feats))
                    secs[b][mode.rstrip("2")].append(r.seconds)
                    runs[mode] = r
                held[b] = graphed_vs_eager_diffs(runs["graphed"], runs["eager"], runs["eager2"])
                ok = all(v for k, v in held[b]["bitwise"].items() if k != "cpi_phase") and \
                    held[b]["cpi_phase_rel_graphed_vs_eager"] <= GRAPH_PHASE_RTOL
                if not ok:
                    failures.append(f"slice: graphed {route} simulate differs from the eager step "
                                    f"on {b}: {held[b]}")
        med = {b: {k: float(np.median(v)) for k, v in d.items()} for b, d in secs.items()}
        feats = None if route == "fused" else arrays["lee"]
        prof = {mode: profile_breakdown(fn) for mode, fn in (
            ("graphed", lambda: engine.simulate(traces["lee"], features=feats)),
            ("eager", lambda: eager_entry_loop(engine, traces["lee"], feats)))}
        out = {"phase": "slice", "check": "graph_vs_eager", "route": route, "rounds": ROUTE_ROUNDS,
               "instructions": total_n, "batches": batches, "per_trace_median_s": med, "held": held}
        for mode in ("graphed", "eager"):
            s = sum(m[mode] for m in med.values())
            out[mode] = {"mips": total_n / 1e6 / s, "host_ms_per_batch": s * 1e3 / batches,
                         "device_ms_per_batch": prof[mode]["device_busy_s"] * 1e3 / lee_batches,
                         "idle_share": prof[mode]["idle_share"],
                         "top_device_ms": prof[mode]["top_device_ms"]}
        out["captures"] = engine.num_compiles
        out["cache_stats"] = cache_stats()
        emit(out)


def int8_gemm_ms(prof_tracked: dict) -> float:
    return sum(ms for k, ms in prof_tracked.items() if k.startswith(INT8_GEMM_PIECES))


def check_qdense_on_card(failures, qshapes):
    """``qdense`` on the card against the CPU at every dense layer shape of
    the default TaoConfig, at the step's 8,256 rows and at 16 (IMMA's row
    padding): quantized buffers, codes, int32 sums (cuBLASLt IMMA) and
    float output bitwise (``core.quant.qdense_device_vs_cpu``, as the cuda
    tests run it)."""
    from repro_torch.core.quant import qdense_device_vs_cpu

    cases = {f"{k}x{n}@{rows}": qdense_device_vs_cpu(k, n, rows, "cuda")
             for k, n in qshapes for rows in (8256, 16)}
    bad = {c: same for c, same in cases.items() if not all(same.values())}
    if bad:
        failures.append(f"slice int8: qdense on the card differs from the CPU: {bad}")
    emit({"phase": "slice", "check": "int8_qdense_gpu_vs_cpu",
          "bitwise": {c: all(same.values()) for c, same in cases.items()}, "ok": not bad})


def slice_int8(failures, traces, arrays, model, engine, extract, batches, lee_batches):
    """The main path under precision="int8" (the W8A8 forward): its own
    captured graph (warmup: seconds, bytes, kernel nodes, IMMA nodes), the
    fused and the staged route on the three traces with the kernels' counts
    zeroed before each and read after (B4 by the counter and by the int8
    graph's nodes x replays), int8 beside fp32 in turns (MIPS, device ms per
    batch, idle share, the IMMA kernels' device ms), int8 on the GPU against
    int8 on the CPU on one trace beside its control (float32 on the GPU
    against int8 on the CPU, which must fail), the int8-vs-fp32 metric
    differences for the record (no gate: a band needs trained weights), and
    qdense on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch.core.model import init_tao
    from repro_torch.core.quant import dense_layers, dense_shapes
    from repro_torch.engine import StreamingEngine, cache_stats
    from repro_torch.engine.aot import graph_kernel_names
    from repro_torch.kernels.attention.kernel import FLASH_ATTENTION

    cfg = engine.cfg
    ecfg8 = dataclasses.replace(engine.ecfg, precision="int8")
    engine8 = StreamingEngine(model, cfg, ecfg8, device="cuda")
    qdense_calls = len(dense_layers(engine8._run_params()))  # each QDense runs once per step
    check_qdense_on_card(failures, dense_shapes(engine8._run_params()))
    t0 = time.perf_counter()
    entry8 = engine8.warmup(SLICE_INSTRUCTIONS)
    capture_s = time.perf_counter() - t0
    entry32 = engine.step_entry_for(SLICE_INSTRUCTIONS)
    names8, names32 = graph_kernel_names(entry8.aot.graph), graph_kernel_names(entry32.aot.graph)
    gemm8 = [k for k in names8 if any(p in k for p in INT8_GEMM_PIECES)]
    float_gemm8 = [k for k in names8 if any(p in k for p in FLOAT_GEMM_PIECES)]
    emit({"phase": "slice", "check": "int8_capture", "seconds": capture_s, "compiles": entry8.compiles,
          "retained_bytes_est": entry8.est_bytes, "fp32_retained_bytes_est": entry32.est_bytes,
          "launches_per_replay": {k.symbol: n for k, n in entry8.aot.launches.items()},
          "kernels_per_replay": {"int8": len(names8), "fp32": len(names32)},
          "int8_gemm_nodes": len(gemm8), "qdense_calls": qdense_calls,
          "int8_gemm_kernels": sorted({k[:72] for k in gemm8}), "float_gemm_nodes": len(float_gemm8),
          "cache_stats": cache_stats()})
    if entry8 is entry32 or entry8.compiles != 1 or len(gemm8) != qdense_calls or float_gemm8:
        failures.append(f"slice int8: capture {entry8.compiles}, {len(gemm8)} IMMA nodes for "
                        f"{qdense_calls} projections, float GEMMs {float_gemm8[:3]}")
    engine8.simulate(traces["lee"])  # warm-up
    engine8.simulate(traces["lee"], features=arrays["lee"])

    # ---- the fused route under int8
    zero_counts()
    replays = entry8.aot.replays
    res8 = {b: engine8.simulate(t) for b, t in traces.items()}
    launches = read_counts()
    replays = entry8.aot.replays - replays
    attn_nodes = sum("attention_kernel" in k for k in names8)
    b4 = {"counter": launches["flash_attention"], "graph_nodes_x_replays": attn_nodes * replays,
          "captured_x_replays": entry8.aot.launches.get(FLASH_ATTENTION, 0) * replays}
    expected = {"fused_features": batches, "flash_attention": cfg.n_layers * batches,
                "branch_history": 0, "memdist_delta": 0, "ssd": 0, "flash_attention_bwd": 0}
    if launches != expected or attn_nodes != cfg.n_layers or set(b4.values()) != {cfg.n_layers * batches}:
        failures.append(f"slice int8: fused launches {launches}, expected {expected}; attention "
                        f"nodes {attn_nodes}, counts {b4}")
    for b, r in res8.items():
        scalars = [r.cpi, r.total_cycles, r.branch_mpki, r.l1d_mpki]
        if not (all(math.isfinite(x) for x in scalars)
                and all(np.isfinite(c).all() and c.shape == (32,) for c in (r.cpi_phase, r.l1d_phase))):
            failures.append(f"slice int8: non-finite or misshapen metrics on {b}")
    total_n = sum(r.num_instructions for r in res8.values())
    emit({"phase": "slice", "route": "fused", "precision": "int8", "traces": list(SLICE_BENCHMARKS),
          "instructions": total_n, "mips": total_n / 1e6 / sum(r.seconds for r in res8.values()),
          "per_trace": {b: {"cpi": r.cpi, "branch_mpki": r.branch_mpki, "l1d_mpki": r.l1d_mpki,
                            "seconds": r.seconds} for b, r in res8.items()},
          "launches": launches, "replays": replays, "attention_nodes_per_graph": attn_nodes,
          "flash_attention_counts": b4, "captures": engine8.num_compiles})

    # ---- the staged route under int8: one extraction per trace, then simulate
    zero_counts()
    staged8 = {b: engine8.simulate(t, features=extract(t)) for b, t in traces.items()}
    s_launches = read_counts()
    expected = {"fused_features": 0, "flash_attention": cfg.n_layers * batches,
                "branch_history": len(traces), "memdist_delta": len(traces), "ssd": 0,
                "flash_attention_bwd": 0}
    if s_launches != expected:
        failures.append(f"slice int8: staged launches {s_launches}, expected {expected}")
    vs_fused = {b: same_metrics(r, res8[b]) for b, r in staged8.items()}
    if not all(vs_fused.values()):
        failures.append(f"slice int8: staged and fused int8 results differ: {vs_fused}")
    emit({"phase": "slice", "route": "staged", "precision": "int8", "launches": s_launches,
          "bitwise_vs_fused": vs_fused, "captures": engine8.num_compiles})

    # ---- int8 beside fp32, in turns (fp32, int8, int8, fp32) on both routes
    secs = {route: {p: [] for p in ("fp32", "int8")} for route in ("fused", "staged")}
    fp32 = {}
    for _ in range(ROUTE_ROUNDS):
        for b, t in traces.items():
            for route in ("fused", "staged"):
                feats = None if route == "fused" else arrays[b]
                for prec in ("fp32", "int8", "int8", "fp32"):
                    r = (engine if prec == "fp32" else engine8).simulate(t, features=feats)
                    secs[route][prec].append((b, r.seconds))
                    if prec == "fp32" and route == "fused":
                        fp32[b] = r
    side = {}
    for route in ("fused", "staged"):
        out = {}
        for prec in ("fp32", "int8"):
            med = {b: float(np.median([s for bb, s in secs[route][prec] if bb == b])) for b in traces}
            feats = None if route == "fused" else arrays["lee"]
            eng = engine if prec == "fp32" else engine8
            prof = profile_breakdown(functools.partial(eng.simulate, traces["lee"], features=feats),
                                     track=INT8_GEMM_PIECES)
            out[prec] = {"mips": total_n / 1e6 / sum(med.values()), "per_trace_median_s": med,
                         "device_ms_per_batch": prof["device_busy_s"] * 1e3 / lee_batches,
                         "idle_share": prof["idle_share"],
                         "int8_gemm_ms_per_batch": int8_gemm_ms(prof["tracked_ms"]) / lee_batches,
                         "top_device_ms": prof["top_device_ms"]}
        side[route] = out
    emit({"phase": "slice", "check": "int8_vs_fp32", "rounds": ROUTE_ROUNDS, "instructions": total_n,
          "batches": batches, "fused": side["fused"], "staged_simulate_only": side["staged"],
          # for the record, not a gate: a band needs trained weights
          "metric_diffs": {b: {"cpi_rel": (r.cpi - fp32[b].cpi) / fp32[b].cpi,
                               "branch_mpki_abs": r.branch_mpki - fp32[b].branch_mpki,
                               "l1d_mpki_abs": r.l1d_mpki - fp32[b].l1d_mpki}
                           for b, r in res8.items()}})

    # ---- int8 on the card against int8 on the CPU (plain versions), one trace
    name = SLICE_BENCHMARKS[0]
    ecfg8c = dataclasses.replace(ecfg8, collect=True)
    gpu = StreamingEngine(model, cfg, ecfg8c, device="cuda").simulate(traces[name])
    cpu_model = init_tao(cfg, torch.Generator().manual_seed(0), device="cpu")
    t0 = time.perf_counter()
    cpu = StreamingEngine(cpu_model, cfg, ecfg8c, device="cpu").simulate(traces[name])
    cpu_s = time.perf_counter() - t0
    check = flip_check(gpu, cpu, traces[name], cfg, INT8_FLIP_FRACTION, INT8_PROB_ATOL)
    if not check["ok"]:
        failures.append(f"slice int8: GPU and CPU int8 engines disagree beyond tolerance on {name}")
    emit({"phase": "slice", "check": "int8_gpu_vs_cpu", "trace": name, "positions": gpu.num_instructions,
          **check, "cpu_seconds": cpu_s})
    # the control: float32 on the card against the same int8 on the CPU
    gpu32 = StreamingEngine(model, cfg, dataclasses.replace(ecfg8c, precision="fp32"),
                            device="cuda").simulate(traces[name])
    control = flip_check(gpu32, cpu, traces[name], cfg, INT8_FLIP_FRACTION, INT8_PROB_ATOL)
    if control["ok"]:
        failures.append(f"slice int8: float32 on the card passes the int8 GPU-vs-CPU check on {name}")
    emit({"phase": "slice", "check": "int8_gpu_vs_cpu_control", "trace": name, "gpu_precision": "fp32",
          "cpu_precision": "int8", **control, "fails_as_it_must": not control["ok"]})


def sweep_standalone(cfg, ecfg, jobs, route):
    """The sweep's baseline: a loop of standalone simulates, one engine per
    model, each job's features made for it alone (the staged route's
    device arrays, the host route's NumPy extraction).  Returns the
    results by job key and the loop's host seconds."""
    import torch

    from repro_torch.core.features import extract_features
    from repro_torch.engine import StreamingEngine
    from repro_torch.kernels.features.ops import device_feature_arrays, trace_columns

    engines, out = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in jobs:
        engine = engines.get(id(j.params))
        if engine is None:
            engine = engines[id(j.params)] = StreamingEngine(j.params, cfg, ecfg, device="cuda")
        feats = None
        if route == "staged":
            feats = device_feature_arrays(trace_columns(j.trace, cfg.features), cfg.features, device="cuda")
        elif route == "host":
            feats = extract_features(j.trace, cfg.features, with_labels=False)
        out[j.key] = engine.simulate(j.trace, features=feats)
    return out, time.perf_counter() - t0


def sweep_report_line(rep) -> dict:
    return {"seconds": rep.seconds, "mips": rep.mips, "traces_per_s": rep.traces_per_s,
            "num_compiles": rep.num_compiles, "queue_occupancy_mean": rep.queue_occupancy_mean,
            "queue_occupancy_max": rep.queue_occupancy_max, "queue_depth": rep.queue_depth,
            "prepared_async": rep.prepared_async, "features_extracted": rep.features_extracted,
            "features_from_store": rep.features_from_store, "jobs_skipped": rep.jobs_skipped}


def phase_sweep(failures, results, traces):
    """The sweep scheduler at the default TaoConfig width: 4 models x the
    three 150k traces on each route (module note)."""
    import tempfile

    import torch

    from repro_torch.core.features import extract_features
    from repro_torch.core.model import TaoConfig, init_tao
    from repro_torch.engine import EngineConfig, StreamingEngine, SweepJob, TraceSweeper
    from repro_torch.engine.aot import WARMUP_RUNS, graph_kernel_names
    from repro_torch.resilience.faults import FaultPlan, FaultSpec, inject
    from repro_torch.store import ArtifactStore

    cfg = TaoConfig()
    # a metric set of its own: a step geometry no earlier phase captured
    ecfg = EngineConfig(metrics=SWEEP_METRICS)
    models = {s: init_tao(cfg, torch.Generator().manual_seed(s), device="cuda") for s in SWEEP_SEEDS}
    jobs = [SweepJob(f"m{s}/{b}", models[s], t) for s in SWEEP_SEEDS for b, t in traces.items()]
    per_job = {b: -(-(len(t) // cfg.window) // ecfg.batch_size) for b, t in traces.items()}
    batches = sum(per_job[j.key.split("/")[1]] for j in jobs)
    none = {k: 0 for k in launch_counters()}

    def sweep(route, store=None):
        zero_counts()
        rep = TraceSweeper(cfg, ecfg, route=route, store=store).run(jobs)
        return rep, read_counts()

    def bitwise(rep, alone):
        return all(same_metrics(rep.results[k], r) for k, r in alone.items())

    # ---- fused: from a cold step cache for this geometry, then warm
    cold, cold_launches = sweep("fused")
    entry = StreamingEngine(models[0], cfg, ecfg, device="cuda").step_entry_for(SLICE_INSTRUCTIONS)
    replays = {"cold": entry.aot.replays}
    warm, warm_launches = sweep("fused")
    replays["warm"] = entry.aot.replays - replays["cold"]
    attn_nodes = sum("attention_kernel" in k for k in graph_kernel_names(entry.aot.graph))
    alone, alone_s = sweep_standalone(cfg, ecfg, jobs, "fused")
    n = cold.num_instructions
    fused_expected = none | {"fused_features": batches, "flash_attention": cfg.n_layers * batches}
    # a cold sweep's capture runs the step eagerly WARMUP_RUNS times first
    cold_expected = fused_expected | {"flash_attention": cfg.n_layers * (
        batches + WARMUP_RUNS * cold.num_compiles)}
    from_nodes = {k: attn_nodes * r for k, r in replays.items()}
    held = {"cold": bitwise(cold, alone), "warm": bitwise(warm, alone)}
    ok = (cold.num_compiles <= 1 and warm.num_compiles == 0 and cold_launches == cold_expected
          and warm_launches == fused_expected and attn_nodes == cfg.n_layers
          and set(from_nodes.values()) == {cfg.n_layers * batches} and all(held.values()))
    emit({"phase": "sweep", "route": "fused", "jobs": len(jobs), "models": len(models),
          "traces": list(traces), "batch": ecfg.batch_size, "batches": batches,
          "per_job": {"fused_features": batches / len(jobs),
                      "flash_attention": cfg.n_layers * batches / len(jobs)},
          "cold": sweep_report_line(cold), "warm": sweep_report_line(warm),
          "standalone": {"seconds": alone_s, "mips": n / 1e6 / alone_s},
          "warm_speedup_vs_standalone": alone_s / warm.seconds,
          "launches": {"cold": cold_launches, "warm": warm_launches},
          "attention_nodes_per_graph": attn_nodes, "replays": replays,
          "attention_from_graph_nodes": from_nodes, "bitwise_vs_standalone": held, "ok": ok})
    if not ok:
        failures.append(f"sweep: fused route: captures {cold.num_compiles} / {warm.num_compiles}, "
                        f"launches {cold_launches} / {warm_launches} (expected {cold_expected} / "
                        f"{fused_expected}), "
                        f"attention from nodes {from_nodes}, bitwise {held}")

    # ---- staged: each job's trace extracted on the device by B2 and B3
    staged, st_launches = sweep("staged")
    alone_st, alone_st_s = sweep_standalone(cfg, ecfg, jobs, "staged")
    st_expected = none | {"branch_history": len(jobs), "memdist_delta": len(jobs),
                          "flash_attention": cfg.n_layers * batches}
    held = bitwise(staged, alone_st)
    ok = staged.num_compiles == 0 and st_launches == st_expected and held
    emit({"phase": "sweep", "route": "staged", "jobs": len(jobs), "sweep": sweep_report_line(staged),
          "standalone": {"seconds": alone_st_s, "mips": n / 1e6 / alone_st_s},
          "speedup_vs_standalone": alone_st_s / staged.seconds, "launches": st_launches,
          "bitwise_vs_standalone": held, "ok": ok})
    if not ok:
        failures.append(f"sweep: staged route: captures {staged.num_compiles}, launches {st_launches} "
                        f"(expected {st_expected}), bitwise {held}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as root:
        store = ArtifactStore(root)
        # ---- host: one NumPy extraction per distinct trace, shared by the
        # models, then a second sweep over the warm store
        host, h_launches = sweep("host", store)
        host2, h2_launches = sweep("host", store)
        alone_h, alone_h_s = sweep_standalone(cfg, ecfg, jobs, "host")
        h_expected = none | {"flash_attention": cfg.n_layers * batches}
        held = {"cold_store": bitwise(host, alone_h), "warm_store": bitwise(host2, alone_h)}
        ok = ((host.features_extracted, host.features_from_store) == (len(traces), 0)
              and (host2.features_extracted, host2.features_from_store) == (0, len(traces))
              and host.num_compiles == host2.num_compiles == 0
              and h_launches == h2_launches == h_expected and all(held.values()))
        emit({"phase": "sweep", "route": "host", "jobs": len(jobs), "sweep": sweep_report_line(host),
              "warm_store": sweep_report_line(host2),
              "standalone": {"seconds": alone_h_s, "mips": n / 1e6 / alone_h_s,
                             "extractions": len(jobs)},
              "speedup_vs_standalone": alone_h_s / host.seconds, "launches": h_launches,
              "bitwise_vs_standalone": held, "ok": ok})
        if not ok:
            failures.append(f"sweep: host route: extracted {host.features_extracted} / "
                            f"{host2.features_extracted}, from the store {host.features_from_store} / "
                            f"{host2.features_from_store}, launches {h_launches} / {h2_launches}, "
                            f"bitwise {held}")

        # ---- the host route's prefetch on one trace, in turns: inline (the
        # engine's), off, and on the producer thread the engine does not take
        fs = extract_features(traces["lee"], cfg.features, with_labels=False)
        engines = {on: StreamingEngine(models[0], cfg, dataclasses.replace(ecfg, prefetch=on), device="cuda")
                   for on in (True, False)}
        hp = {}
        for i, mode in enumerate(("on", "off", "threaded", "threaded", "off", "on")):
            with prefetch_threaded() if mode == "threaded" else contextlib.nullcontext():
                hp[f"{i}_{mode}"] = engines[mode != "off"].simulate(traces["lee"], features=fs)
        held = {k: same_metrics(r, hp["1_off"]) for k, r in hp.items()}
        emit({"phase": "sweep", "check": "host_route_prefetch", "trace": "lee", "turns": list(hp),
              "ms_per_trace": {k: r.seconds * 1e3 for k, r in hp.items()},
              "mips": {k: r.mips for k, r in hp.items()}, "held": held, "ok": all(held.values())})
        if not all(held.values()):
            failures.append(f"sweep: the host route with prefetch differs from without: {held}")

        # ---- crash-resume: a fault at the consume of job 6, then a resume
        plan = FaultPlan(FaultSpec("scheduler.consume", after=SWEEP_KILL_AFTER, times=1,
                                   exc="RuntimeError"))
        killed = ""
        try:
            with inject(plan):
                TraceSweeper(cfg, ecfg, store=store).run(jobs, resume_key="chip-sweep")
        except RuntimeError as e:
            killed = str(e)
        zero_counts()
        resumed = TraceSweeper(cfg, ecfg, store=store).run(jobs, resume_key="chip-sweep")
        r_launches = read_counts()
        r_batches = sum(per_job[j.key.split("/")[1]] for j in jobs[SWEEP_KILL_AFTER:])
        r_expected = none | {"fused_features": r_batches, "flash_attention": cfg.n_layers * r_batches}
        held = bitwise(resumed, alone)
        ok = ("injected fault" in killed and resumed.jobs_skipped == SWEEP_KILL_AFTER
              and resumed.num_traces == len(jobs) and resumed.num_instructions == n
              and r_launches == r_expected and held)
        emit({"phase": "sweep", "check": "resume", "killed": killed, "kill_after": SWEEP_KILL_AFTER,
              "resumed": sweep_report_line(resumed), "launches": r_launches,
              "bitwise_vs_uninterrupted": held, "ok": ok})
        if not ok:
            failures.append(f"sweep: resume: killed {killed!r}, skipped {resumed.jobs_skipped}, "
                            f"launches {r_launches} (expected {r_expected}), bitwise {held}")


@functools.lru_cache(maxsize=None)
def adjusted_trace(name, uarch, n=TRAIN_INSTRUCTIONS):
    """The detailed simulator's records for ``name`` on ``uarch``, aligned to
    the functional trace (§4.1), and whether the alignment checks hold.
    Kept for the process: later phases reuse the labels."""
    from repro_torch.core import build_adjusted_trace, verify_alignment
    from repro_torch.uarch import get_benchmark, run_detailed, run_functional

    prog = get_benchmark(name)
    ft = run_functional(prog, n)
    det, _ = run_detailed(prog, ft, uarch)
    al = build_adjusted_trace(det)
    check = verify_alignment(al, ft)
    return al.adjusted, check["stream_match"] and check["cycles_match"]


@functools.lru_cache(maxsize=None)
def labelled_windows(names, uarch, cfg):
    """The training data path: each trace's adjusted records on ``uarch``,
    features with labels, windows (dedup per trace), concatenated.  Kept
    for the process: the ``persist`` and ``joint`` phases train on the
    ``train`` phase's windows."""
    from repro_torch.core import build_windows, concat_datasets, extract_features

    parts, aligned_ok = [], True
    for name in names:
        adj, ok = adjusted_trace(name, uarch)
        aligned_ok &= ok
        parts.append(build_windows(extract_features(adj, cfg.features), cfg.window))
    return concat_datasets(parts), aligned_ok


def params_diff(a, b) -> float:
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[k].cpu() - sb[k].cpu()).abs().max()) for k in sa)


def state_bitwise(a, b) -> bool:
    """Two trees of tensors (modules by state dict, AdamW states, dicts,
    lists) equal in structure, dtype, shape and every bit."""
    import torch

    if isinstance(a, torch.nn.Module):
        a, b = a.state_dict(), b.state_dict()
    if isinstance(a, tuple) and hasattr(a, "_asdict"):
        a, b = a._asdict(), b._asdict()
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(state_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(state_bitwise(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def graph_nodes(entry) -> dict:
    """Each captured geometry of a train-step entry: its kernel nodes, the
    attention forward and backward nodes among them, and its replays."""
    from repro_torch.engine.aot import graph_kernel_names

    out = []
    for g in entry.aot.values():
        names = graph_kernel_names(g.graph)
        out.append({"kernel_nodes": len(names),
                    "attention_nodes": sum("attention_kernel" in k for k in names),
                    "bwd_delta_nodes": sum("bwd_delta" in k for k in names),
                    "bwd_dkdv_dq_nodes": sum("bwd_dkdv_dq" in k for k in names),
                    "launches_per_replay": {k.symbol: n for k, n in g.launches.items()},
                    "replays": g.replays, "bytes": g.bytes_estimate})
    return out


@contextlib.contextmanager
def prefetch_threaded():
    """The engine's host route and the trainer prefetch inline; within this
    block their ``prefetch_to_device`` runs its producer thread instead
    (what the threaded turns measure)."""
    from repro_torch.engine import runner

    inline = runner.prefetch_to_device
    runner.prefetch_to_device = lambda *a, threaded=None, **k: inline(*a, threaded=True, **k)
    try:
        yield
    finally:
        runner.prefetch_to_device = inline


def train_run(cfg, ds, graphed: bool, epochs: int, freeze: bool = False, init=None, seed: int = 0,
              prefetch: bool = False, threaded: bool = False):
    """One run of a train recipe on the card, driven as ``train_tao_impl``
    drives it (``core/transfer.py``'s ``_run_epochs``): on the recipe's
    CUDA graph, or on the same entry's eager step; with ``prefetch``
    (graphed only) each epoch's batches through ``prefetch_to_device``,
    with ``threaded`` on its producer thread.  Returns the losses, steps,
    host seconds, and the model and AdamW state after the run."""
    import torch

    from repro_torch.core.transfer import _EagerRun, _GraphRun, _make_step, _new_state, _run_epochs, batch_like
    from repro_torch.train import AdamWConfig

    model, opt = _new_state(cfg, init, freeze, seed, torch.device("cuda"))
    entry = _make_step(cfg, AdamWConfig(lr=TRAIN_LR), "headonly" if freeze else "all")
    if prefetch:
        run = _GraphRun(entry, model, opt, like=batch_like(cfg, TRAIN_BATCH, ds.window))
    else:
        run = (_GraphRun if graphed else _EagerRun)(entry, model, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prefetch_threaded() if threaded else contextlib.nullcontext():
        losses, _, steps = _run_epochs(run, ds, epochs, TRAIN_BATCH, seed=seed, prefetch=prefetch)
    model, opt = run.state()
    torch.cuda.synchronize()
    return {"losses": losses, "steps": steps, "seconds": time.perf_counter() - t0, "model": model,
            "opt": opt}


def replay_split(graph, batches, state=None) -> dict:
    """Where a graphed step's host time goes, per step on the host clock
    (no synchronisation between the parts): the batch arrays copied into
    the static inputs (from pageable NumPy: each copy waits for the work
    queued before it), the replay's launch, the outputs cloned off the
    graph, and with ``state`` (a ``(params, carry)`` pair) the per-call
    copies of the state in and back (the joint step's)."""
    import torch

    from repro_torch.engine.aot import _copy_tree_, tree_map

    parts = ("load", "inputs", "replay", "outputs", "store") if state else ("inputs", "replay", "outputs")
    split = dict.fromkeys(parts, 0.0)
    for b in batches:
        t = [time.perf_counter()]
        if state:
            graph.load(*state)
            t.append(time.perf_counter())
        _copy_tree_(graph.batch, tree_map(torch.as_tensor, b))
        t.append(time.perf_counter())
        graph.graph.replay()
        t.append(time.perf_counter())
        tree_map(torch.clone, graph.per)
        t.append(time.perf_counter())
        if state:
            graph.store(*state)
            t.append(time.perf_counter())
        for k, a, z in zip(parts, t, t[1:]):
            split[k] += (z - a) * 1e3 / len(batches)
    torch.cuda.synchronize()
    return split


def prefetch_profile(entry, cfg, ds, prefetch: bool) -> dict:
    """Device ms per step, idle share and the copies' device ms per step
    over one epoch of the graphed train step driven by ``_run_epochs``,
    with or without prefetch (an unprofiled epoch first)."""
    import torch

    from repro_torch.core.transfer import _GraphRun, _new_state, _run_epochs, batch_like

    model, opt = _new_state(cfg, None, False, 0, torch.device("cuda"))
    run = _GraphRun(entry, model, opt, like=batch_like(cfg, TRAIN_BATCH, ds.window))
    _run_epochs(run, ds, 1, TRAIN_BATCH, prefetch=prefetch)
    prof = profile_breakdown(lambda: _run_epochs(run, ds, 1, TRAIN_BATCH, prefetch=prefetch),
                             track=("Memcpy",))
    steps = len(ds) // TRAIN_BATCH
    prof["ms_per_step_device"] = prof["device_busy_s"] * 1e3 / steps
    prof["memcpy_ms_per_step"] = {k: ms / steps for k, ms in prof.pop("tracked_ms").items()}
    return prof


def step_profile(run, batches, track=()) -> dict:
    """Device ms per step, idle share and the tracked kernels' ms over
    ``len(batches)`` steps of a run (one ``_GraphRun`` / ``_EagerRun``)."""
    def steps():
        for b in batches:
            loss = run.step(b)
        loss.item()

    steps()
    prof = profile_breakdown(steps, track=track)
    prof["ms_per_step_device"] = prof["device_busy_s"] * 1e3 / len(batches)
    return prof


def phase_train(failures, results, traces):
    """The port's training path at the default TaoConfig width: labelled
    windows from the detailed simulator; the train step captured ahead of
    any data (warmup_train_step: one CUDA graph per recipe and geometry,
    its capture seconds, bytes and kernel nodes); train_tao_impl for
    TRAIN_EPOCHS at batch 16 on the card, then Tao's transfer (frozen
    embeddings) to UARCH_B on another trace, both replaying their graphs;
    the attention kernels' launches per step from the counters and from
    the graphs' nodes times their replays; the graphed run against the
    entry's eager step in turns (host and device ms per step, idle share,
    windows/s; losses, parameters and AdamW state bitwise); the first
    steps on the card against the same steps on the CPU."""
    import numpy as np
    import torch

    from repro_torch.core import TaoConfig, train_tao_impl, transfer_finetune, warmup_train_step
    from repro_torch.core.model import init_tao
    from repro_torch.core.transfer import _EagerRun, _GraphRun, _make_step, _new_state
    from repro_torch.kernels.attention.kernel import BWD_KERNEL_NAMES
    from repro_torch.train import AdamWConfig, cache_stats
    from repro_torch.uarch import UARCH_A, UARCH_B

    cfg = TaoConfig()
    t0 = time.perf_counter()
    ds, aligned_ok = labelled_windows(TRAIN_TRACES, UARCH_A, cfg)
    small, small_ok = labelled_windows((TRANSFER_TRACE,), UARCH_B, cfg)
    data_s = time.perf_counter() - t0
    emit({"phase": "train", "check": "data", "traces": list(TRAIN_TRACES), "uarch": UARCH_A.name,
          "transfer_trace": TRANSFER_TRACE, "transfer_uarch": UARCH_B.name,
          "instructions_each": TRAIN_INSTRUCTIONS, "windows": len(ds), "transfer_windows": len(small),
          "window": cfg.window, "seconds": data_s, "aligned": aligned_ok and small_ok})
    if not (aligned_ok and small_ok):
        failures.append("train: the adjusted trace does not align with the functional trace")

    # ---- the captures, ahead of any data: one graph per recipe
    captures = {}
    for name, freeze in (("all", False), ("headonly", True)):
        t0 = time.perf_counter()
        entry = warmup_train_step(cfg, batch_size=TRAIN_BATCH, lr=TRAIN_LR, freeze_embed=freeze)
        torch.cuda.synchronize()
        captures[name] = {"seconds": time.perf_counter() - t0, "compiles": entry.compiles,
                          "est_bytes": entry.est_bytes, "graphs": graph_nodes(entry)}
    stats0 = cache_stats()
    emit({"phase": "train", "check": "capture", "captures": captures, "cache_stats": stats0})
    cap_ok = all(c["compiles"] == 1 and c["graphs"][0]["attention_nodes"] == cfg.n_layers
                 and c["graphs"][0]["bwd_dkdv_dq_nodes"] == cfg.n_layers
                 and c["graphs"][0]["bwd_delta_nodes"] == cfg.n_layers for c in captures.values())
    if not cap_ok:
        failures.append(f"train: captures {captures}")

    # ---- the main path: train_tao_impl and the transfer, on their graphs
    entries = {n: _make_step(cfg, AdamWConfig(lr=TRAIN_LR), n) for n in captures}
    replays0 = {n: sum(g.replays for g in e.aot.values()) for n, e in entries.items()}
    zero_counts()
    res = train_tao_impl(cfg, ds, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                         seed=0, device="cuda")
    ft = transfer_finetune(cfg, res.params.embed, res.params, small, epochs=TRANSFER_EPOCHS,
                           batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    steps = res.steps + ft.steps
    replays = {n: sum(g.replays for g in e.aot.values()) - replays0[n] for n, e in entries.items()}
    by_nodes = {k: sum(replays[n] * captures[n]["graphs"][0][f"{k}_nodes"] for n in replays)
                for k in ("attention", "bwd_dkdv_dq")}
    expected = {k: 0 for k in launches} | {"flash_attention": cfg.n_layers * steps,
                                           "flash_attention_bwd": cfg.n_layers * steps}
    new_captures = cache_stats()["compiles"] - stats0["compiles"]
    if (launches != expected or replays != {"all": res.steps, "headonly": ft.steps} or new_captures
            or by_nodes != {"attention": expected["flash_attention"],
                            "bwd_dkdv_dq": expected["flash_attention_bwd"]}):
        failures.append(f"train: launches {launches}, expected {expected}; replays {replays}; "
                        f"from nodes {by_nodes}; captures during the run {new_captures}")
    results["flash_attention_bwd"]["launches"] = launches["flash_attention_bwd"]
    finite = all(math.isfinite(x) for x in res.losses + ft.losses)
    falls = len(res.losses) == TRAIN_EPOCHS and res.losses[1] < res.losses[0]
    frozen = state_bitwise(ft.params.embed, res.params.embed)
    moved = params_diff(ft.params.pred, res.params.pred) > 0
    if not (finite and falls and frozen and moved):
        failures.append(f"train: losses {res.losses} / {ft.losses} (finite {finite}, falling "
                        f"{falls}), embed unchanged by the fine-tune {frozen}, pred moved {moved}")

    # ---- graphed against the entry's eager step, in turns: the same
    # recipe from the same seed, each run on its own model
    turns = {}
    for i, graphed in enumerate((True, False, False, True)):
        turns[f"{i}_{'graphed' if graphed else 'eager'}"] = train_run(cfg, ds, graphed, TRAIN_EPOCHS)
    ref = turns["1_eager"]
    held = {k: {"losses": t["losses"] == ref["losses"], "params": state_bitwise(t["model"], ref["model"]),
                "adamw": state_bitwise(t["opt"], ref["opt"])} for k, t in turns.items()}
    held_ok = all(all(v.values()) for v in held.values()) and ref["losses"] == res.losses
    if not held_ok:
        failures.append(f"train: the graphed run differs from the eager step: {held}")
    # device time and idle share: 10 steps on each, their profiles
    track = ("attention_kernel", *BWD_KERNEL_NAMES, "fmha", "flash_fwd", "flash_bwd",
             "efficient_attention")
    batches = list(ds.batches(TRAIN_BATCH, rng=np.random.default_rng(0)))[:10]
    profs = {}
    for name, run_cls in (("graphed", _GraphRun), ("eager", _EagerRun)):
        model, opt = _new_state(cfg, None, False, 0, torch.device("cuda"))
        profs[name] = step_profile(run_cls(entries["all"], model, opt), batches, track)
    ours = {"attention_kernel", *BWD_KERNEL_NAMES}
    for name, prof in profs.items():
        names = set(prof["tracked_ms"])
        if [n for n in names if not any(n.startswith(o) for o in ours)] or not all(
                any(n.startswith(o) for n in names) for o in ours):
            failures.append(f"train: {name} step profile attention kernels {sorted(names)}")
    model, opt = _new_state(cfg, None, False, 0, torch.device("cuda"))
    eager_run = _EagerRun(entries["all"], model, opt)
    kernels_eager = kernels_enqueued(lambda: eager_run.step(batches[0]))
    graph = next(iter(entries["all"].aot.values()))
    graph.load(model, opt)
    split = replay_split(graph, batches)

    def timing(t):
        return {"ms_per_step_host": t["seconds"] / t["steps"] * 1e3,
                "windows_per_s": t["steps"] * TRAIN_BATCH / t["seconds"]}

    emit({"phase": "train", "check": "train", "epochs": TRAIN_EPOCHS, "batch": TRAIN_BATCH,
          "lr": TRAIN_LR, "steps": res.steps, "losses": res.losses, "seconds": res.seconds,
          "ms_per_step_host": res.seconds / res.steps * 1e3,
          "windows_per_s": res.steps * TRAIN_BATCH / res.seconds,
          "flash_attention_per_step": launches["flash_attention"] / steps,
          "flash_attention_bwd_per_step": launches["flash_attention_bwd"] / steps,
          "launches": launches, "replays": replays, "launches_from_graph_nodes": by_nodes,
          "ok": finite and falls})
    emit({"phase": "train", "check": "graph_vs_eager", "turns": list(turns), "held": held,
          "timing": {k: timing(t) for k, t in turns.items()},
          "ms_per_step_device": {k: p["ms_per_step_device"] for k, p in profs.items()},
          "idle_share_profiled": {k: p["idle_share"] for k, p in profs.items()},
          "kernels_per_step": {"graphed": captures["all"]["graphs"][0]["kernel_nodes"],
                               "eager": kernels_eager},
          "graphed_host_ms_per_step_split": split,
          "attention_kernels_ms": {k: p["tracked_ms"] for k, p in profs.items()},
          "top_device_ms": {k: p["top_device_ms"] for k, p in profs.items()}, "ok": held_ok})

    # ---- the graphed run with prefetch (inline, as train_tao_impl runs it)
    # and without, in turns, and with the producer thread the trainer does
    # not take: the same recipe from the same seed, each run on its own model
    # a first run grows the pinned-memory pool the copies stage through
    first = train_run(cfg, ds, True, TRAIN_EPOCHS, prefetch=True)
    pf = {}
    for i, mode in enumerate(("on", "off", "threaded", "threaded", "off", "on")):
        pf[f"{i}_{mode}"] = train_run(cfg, ds, True, TRAIN_EPOCHS, prefetch=mode != "off",
                                      threaded=mode == "threaded")
    pf_ref = pf["1_off"]
    pf_held = {k: {"losses": t["losses"] == pf_ref["losses"],
                   "params": state_bitwise(t["model"], pf_ref["model"]),
                   "adamw": state_bitwise(t["opt"], pf_ref["opt"])} for k, t in pf.items()}
    pf_ok = (all(all(v.values()) for v in pf_held.values()) and pf_ref["losses"] == ref["losses"]
             and first["losses"] == ref["losses"])
    if not pf_ok:
        failures.append(f"train: the run with prefetch differs from the run without: {pf_held}")
    pf_prof = {name: prefetch_profile(entries["all"], cfg, ds, on) for name, on in (("on", True), ("off", False))}
    emit({"phase": "train", "check": "prefetch", "turns": list(pf), "held": pf_held,
          "first_run": timing(first), "timing": {k: timing(t) for k, t in pf.items()},
          "ms_per_step_device": {k: p["ms_per_step_device"] for k, p in pf_prof.items()},
          "idle_share_profiled": {k: p["idle_share"] for k, p in pf_prof.items()},
          "memcpy_ms_per_step": {k: p["memcpy_ms_per_step"] for k, p in pf_prof.items()},
          "top_device_ms": {k: p["top_device_ms"] for k, p in pf_prof.items()}, "ok": pf_ok})
    emit({"phase": "train", "check": "transfer", "epochs": TRANSFER_EPOCHS, "steps": ft.steps,
          "losses": ft.losses, "seconds": ft.seconds, "embed_bitwise_unchanged": frozen,
          "pred_max_change": params_diff(ft.params.pred, res.params.pred)})

    # the first steps on the card against the same steps on the CPU (the
    # plain versions): one batch of TRAIN_BATCH windows, one step an epoch
    sub = ds.subsample(TRAIN_BATCH, seed=1)
    init = init_tao(cfg, torch.Generator().manual_seed(1), device="cpu").state_dict()
    kw = dict(epochs=TRAIN_CHECK_STEPS, batch_size=TRAIN_BATCH, lr=TRAIN_LR, init_params=init, seed=1)
    t0 = time.perf_counter()
    cpu = train_tao_impl(cfg, sub, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    gpu = train_tao_impl(cfg, sub, device="cuda", **kw)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gpu.losses, cpu.losses))
    p_diff = params_diff(gpu.params, cpu.params)
    p_tol = 2 * TRAIN_LR * TRAIN_CHECK_STEPS
    ok = loss_rel <= TRAIN_LOSS_RTOL and p_diff <= p_tol
    emit({"phase": "train", "check": "gpu_vs_cpu", "steps": TRAIN_CHECK_STEPS,
          "gpu_losses": gpu.losses, "cpu_losses": cpu.losses, "loss_max_rel": loss_rel,
          "loss_rtol": TRAIN_LOSS_RTOL, "params_max_abs": p_diff, "params_atol": p_tol,
          "cpu_seconds": cpu_s, "ok": ok})
    if not ok:
        failures.append(f"train: the card's first steps differ from the CPU's: losses {loss_rel}, "
                        f"params {p_diff}")


def timed_store(root: str):
    """An ``ArtifactStore`` whose ``put`` and ``get`` record ``(kind, ms,
    done)`` in ``store.timings`` (done: the put created the entry, the get
    hit)."""
    from repro_torch.store import ArtifactStore

    store = ArtifactStore(root)
    store.timings = {"put": [], "get": []}
    for name in ("put", "get"):
        def timed(kind, *args, _fn=getattr(store, name), _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(kind, *args, **kw)
            store.timings[_name].append((kind, (time.perf_counter() - t0) * 1e3, bool(out)))
            return out
        setattr(store, name, timed)
    return store


def entry_bytes(store, kind: str, key: str) -> int:
    edir = store._entry_dir(kind, key)
    return sum(os.path.getsize(os.path.join(edir, f)) for f in os.listdir(edir))


def trees_bitwise(a, b) -> bool:
    """Two trees of NumPy arrays equal in structure, dtype, shape and bytes."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(trees_bitwise(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def kill_mid_run(store, resume_key: str, windows_key: str) -> dict:
    """Run the persist recipe in a child process (``PERSIST_CHILD``: this
    interpreter, ``PYTHONPATH=src``, the same ``build/``) and SIGKILL it
    once its first epoch manifest has landed in ``store``."""
    from repro_torch.resilience.manifest import train_epoch_key

    keys = [train_epoch_key(resume_key, ep) for ep in range(PERSIST_EPOCHS)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [store.root, windows_key, resume_key, str(PERSIST_EPOCHS), str(TRAIN_BATCH), str(TRAIN_LR)]
    with tempfile.TemporaryFile() as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", PERSIST_CHILD, *args], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
        first = None
        try:
            while proc.poll() is None and time.perf_counter() - t0 < PERSIST_CHILD_TIMEOUT_S:
                if any(store.has("train_epoch", k) for k in keys):
                    first = time.perf_counter() - t0
                    proc.send_signal(signal.SIGKILL)
                    break
                time.sleep(PERSIST_POLL_S)
        finally:
            if proc.poll() is None and first is None:
                proc.kill()
            rc = proc.wait(timeout=60)
        err.seek(0)
        tail = err.read().decode(errors="replace")[-2000:]
    published = [ep for ep, k in enumerate(keys) if store.has("train_epoch", k)]
    return {"returncode": rc, "first_manifest_after_s": first, "child_seconds": time.perf_counter() - t0,
            "published_epochs": published, "stderr_tail": tail if rc != -signal.SIGKILL else ""}


def phase_persist(failures, results, traces):
    """Crash-resumable training and the legacy simulate loop on the card:
    the train cell's windows and three 150k traces' features through an
    ``ArtifactStore``; ``train_tao_impl`` with a manifest per epoch,
    uninterrupted, then in a child process SIGKILLed mid-run, then resumed
    here, held bitwise to the uninterrupted run; ``simulate_trace_legacy``
    on the three traces against the engine's fused route."""
    import numpy as np
    import torch

    from repro_torch.core import TaoConfig, WindowDataset, extract_features, init_tao
    from repro_torch.core import simulate_trace_legacy, train_tao_impl
    from repro_torch.engine import EngineConfig, StreamingEngine
    from repro_torch.resilience.manifest import load_train_epoch, train_epoch_key
    from repro_torch.store import content_key, features_to_tree, tree_digest, tree_to_features
    from repro_torch.uarch import UARCH_A

    cfg = TaoConfig()
    fcfg = cfg.features
    ds, _ = labelled_windows(TRAIN_TRACES, UARCH_A, cfg)
    with tempfile.TemporaryDirectory() as root:
        store = timed_store(root)

        # ---- the store: windows and feature sets in, read back bitwise
        windows = {"inputs": ds.inputs, "labels": ds.labels}
        wkey = content_key("train_windows", tree_digest(windows), fcfg, cfg.window)
        store.put("train_windows", wkey, windows, {"windows": len(ds)})
        got, extra = store.get("train_windows", wkey)
        (_, w_put_ms, w_put), (_, w_get_ms, w_hit) = store.timings["put"][-1], store.timings["get"][-1]
        w_ok = w_put and w_hit and trees_bitwise(got, windows) and extra == {"windows": len(ds)}
        feats, fs_lines = {}, {}
        for b, t in traces.items():
            fs = feats[b] = extract_features(t, fcfg, with_labels=False)
            digest = fs.digest
            again = type(fs)(**{k: getattr(fs, k) for k in ("opcode", "regbits", "flags", "brhist",
                                                              "memdist", "labels")}).digest
            key = content_key("features", digest, fcfg)
            store.put("features", key, features_to_tree(fs))
            back = tree_to_features(store.get("features", key)[0])
            fs_lines[b] = {"put_ms": store.timings["put"][-1][1], "get_ms": store.timings["get"][-1][1],
                           "bytes": entry_bytes(store, "features", key),
                           "bitwise": trees_bitwise(features_to_tree(back), features_to_tree(fs)),
                           "digest_stable": digest == again == back.digest}
        s_ok = w_ok and all(v["bitwise"] and v["digest_stable"] for v in fs_lines.values())
        emit({"phase": "persist", "check": "store", "windows": len(ds), "windows_put_ms": w_put_ms,
              "windows_get_ms": w_get_ms, "windows_bytes": entry_bytes(store, "train_windows", wkey),
              "windows_bitwise": w_ok, "features": fs_lines, "counters": store.counters, "ok": s_ok})
        if not s_ok:
            failures.append(f"persist: store round trip: windows {w_ok}, features {fs_lines}")

        # ---- uninterrupted: a manifest per epoch
        kw = dict(epochs=PERSIST_EPOCHS, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=0, device="cuda",
                  store=store)
        n_put = len(store.timings["put"])
        base = train_tao_impl(cfg, ds, resume_key="base", **kw)
        publish_ms = [ms for kind, ms, _ in store.timings["put"][n_put:] if kind == "train_epoch"]
        manifest_bytes = entry_bytes(store, "train_epoch", train_epoch_key("base", 0))
        emit({"phase": "persist", "check": "uninterrupted", "epochs": PERSIST_EPOCHS, "steps": base.steps,
              "losses": base.losses, "seconds": base.seconds, "publish_ms": publish_ms,
              "manifest_bytes": manifest_bytes})

        # ---- killed: a child process, SIGKILLed once its first manifest lands
        killed = kill_mid_run(store, "killed", wkey)
        published = killed["published_epochs"]
        k_ok = (killed["returncode"] == -signal.SIGKILL and 1 <= len(published) < PERSIST_EPOCHS
                and published == list(range(len(published))))
        emit({"phase": "persist", "check": "killed", **killed, "last_published": max(published, default=None),
              "ok": k_ok})
        if not k_ok:
            failures.append(f"persist: the child was not killed mid-run: {killed}")
            return

        # ---- resumed: the same recipe and key, here; bitwise the uninterrupted run
        n_get = len(store.timings["get"])
        zero_counts()
        resumed = train_tao_impl(cfg, ds, resume_key="killed", **kw)
        torch.cuda.synchronize()
        launches = read_counts()
        lookups = [(ms, hit) for kind, ms, hit in store.timings["get"][n_get:] if kind == "train_epoch"]
        last = max(published)
        steps_per_epoch = base.steps // PERSIST_EPOCHS
        ran = resumed.steps - (last + 1) * steps_per_epoch
        expected = {k: 0 for k in launches} | {"flash_attention": cfg.n_layers * ran,
                                               "flash_attention_bwd": cfg.n_layers * ran}
        a, b = load_train_epoch(store, "base", PERSIST_EPOCHS), load_train_epoch(store, "killed", PERSIST_EPOCHS)
        opt_bitwise = trees_bitwise(a["opt"], b["opt"]) and a["rng_state"] == b["rng_state"]
        params_bitwise = all(torch.equal(x, y) for x, y in zip(resumed.params.state_dict().values(),
                                                               base.params.state_dict().values()))
        checks = {"losses_bitwise": resumed.losses == base.losses, "steps_equal": resumed.steps == base.steps,
                  "params_bitwise": params_bitwise, "optimizer_bitwise": opt_bitwise,
                  "launches_as_expected": launches == expected and ran == (PERSIST_EPOCHS - last - 1) * steps_per_epoch}
        emit({"phase": "persist", "check": "resumed", "resumed_from_epoch": last,
              "epochs_run": list(range(last + 1, PERSIST_EPOCHS)), "steps_run": ran, "steps": resumed.steps,
              "seconds": resumed.seconds, "resume_load_ms": [ms for ms, hit in lookups if hit],
              "resume_lookup_ms": sum(ms for ms, _ in lookups), "launches": launches, "expected": expected,
              "flash_attention_per_step": launches["flash_attention"] / max(ran, 1),
              "flash_attention_bwd_per_step": launches["flash_attention_bwd"] / max(ran, 1),
              **checks, "ok": all(checks.values())})
        if not all(checks.values()):
            failures.append(f"persist: the resumed run differs from the uninterrupted one: {checks}")

    # ---- the legacy loop against the engine's fused route, the same weights
    model = init_tao(cfg, torch.Generator().manual_seed(0), device="cuda")
    engine = StreamingEngine(model, cfg, EngineConfig(batch_size=LEGACY_BATCH), device="cuda")
    engine_c = StreamingEngine(model, cfg, EngineConfig(batch_size=LEGACY_BATCH, collect=True), device="cuda")
    name = SLICE_BENCHMARKS[0]
    simulate_trace_legacy(model, traces[name], cfg, LEGACY_BATCH, features=feats[name], device="cuda")
    lines, legacy_s, engine_s, total_n = {}, 0.0, 0.0, 0
    for b, t in traces.items():
        zero_counts()
        legacy = simulate_trace_legacy(model, t, cfg, LEGACY_BATCH, features=feats[b], device="cuda")
        torch.cuda.synchronize()
        launches = read_counts()
        batches = -(-(len(t) // cfg.window) // LEGACY_BATCH)
        expected = {k: 0 for k in launches} | {"flash_attention": cfg.n_layers * batches}
        engine.simulate(t)  # warm: the geometry's graph, the column copies
        fused = engine.simulate(t)
        check = flip_check(legacy, engine_c.simulate(t), t, cfg)
        ok = check["ok"] and launches == expected and math.isfinite(legacy.cpi)
        lines[b] = {"num_instructions": legacy.num_instructions, "batches": batches,
                    "legacy_seconds": legacy.seconds, "legacy_mips": legacy.mips,
                    "engine_seconds": fused.seconds, "engine_mips": fused.mips,
                    "engine_speedup": fused.mips / legacy.mips, "launches": launches,
                    "cpi": [legacy.cpi, fused.cpi], "vs_engine": check, "ok": ok}
        legacy_s += legacy.seconds
        engine_s += fused.seconds
        total_n += legacy.num_instructions
        if not ok:
            failures.append(f"persist: legacy loop on {b}: launches {launches} (expected {expected}), "
                            f"flip check {check['ok']}")
    emit({"phase": "persist", "check": "legacy", "batch": LEGACY_BATCH, "per_trace": lines,
          "instructions": total_n, "legacy_mips": total_n / 1e6 / legacy_s,
          "engine_mips": total_n / 1e6 / engine_s, "engine_speedup": legacy_s / engine_s,
          "ok": all(v["ok"] for v in lines.values())})


def joint_loop(cfg, ds_a, ds_b, method: str, graphed: bool = True, device: str = "cuda",
               epochs: int = JOINT_EPOCHS, max_steps=None, init=None):
    """Joint training of A and B as ``Session.train_joint`` runs it (one
    NumPy generator shuffles A's batches, then B's; the first step's
    losses become GradNorm's initial losses): through ``make_joint_step``
    (on the card its graph), or through the entry's eager step.  Returns
    the per-step losses and GradNorm weights, epoch mean losses, steps,
    host seconds, and the parameters, AdamW state and weights after the
    run."""
    import numpy as np
    import torch

    from repro_torch.core import init_multiarch, make_joint_step
    from repro_torch.core.transfer import to_device
    from repro_torch.train import AdamWConfig, adamw_init

    dev = torch.device(device)
    params = init_multiarch(cfg, torch.Generator().manual_seed(0), device=dev)
    if init is not None:
        params.load_state_dict(init)
    opt = adamw_init(dict(params.named_parameters()))
    w = torch.ones(2, device=dev)
    step = make_joint_step(cfg, AdamWConfig(lr=JOINT_LR), method)
    if not graphed:
        def step(p, o, gw, il, ba, bb, _fn=step.entry.fn):  # noqa: F811
            carry, m = _fn(p, {"opt": o, "w": gw}, {"initial": il, "a": to_device(ba, dev),
                                                    "b": to_device(bb, dev)})
            return carry["opt"], carry["w"], m
    rng = np.random.default_rng(0)
    initial, metrics, ws, steps = None, [], [], 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        for ba, bb in zip(ds_a.batches(TRAIN_BATCH, rng=rng), ds_b.batches(TRAIN_BATCH, rng=rng)):
            opt, w, m = step(params, opt, w, initial if initial is not None else torch.ones(2, device=dev),
                             ba, bb)
            metrics.append(torch.stack([m["loss_a"], m["loss_b"]]))
            ws.append(w.clone())
            if initial is None:
                initial = metrics[0].clone()
            steps += 1
            if steps == max_steps:
                break
        if steps == max_steps:
            break
    losses = torch.stack(metrics).cpu().numpy()
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_epoch = steps // epochs if max_steps is None else steps
    return {"losses": losses, "w": torch.stack(ws).cpu().numpy(), "steps": steps, "seconds": seconds,
            "epoch_losses": [float(losses[i:i + per_epoch].mean()) for i in range(0, steps, per_epoch)],
            "params": params, "opt": opt, "gradnorm_w": w}


def phase_joint(failures, results, traces):
    """The paper's workflow at the default TaoConfig width, as the
    reference's ``examples/train_tao_e2e.py`` runs it: Mahalanobis pair
    selection over sampled designs; joint training of the µarch-agnostic
    embedding on lee + mcf under UARCH_A and UARCH_B (the ``train`` phase's
    traces), with all four methods, each step one replay of its graph (4
    attention forward and 4 backward launches a step); the graphed joint
    step against its eager step in turns; the card's first steps against
    the CPU's; transfer of the jointly trained embedding, frozen, with A's
    heads as donor, onto dee under UARCH_C; and a short SimNet run on the
    card against the CPU."""
    import numpy as np
    import torch

    from repro_torch.core import (METHODS, SimNetConfig, TaoConfig, init_simnet, make_joint_step,
                                  make_simnet_step, measure_design_metrics, select_pair_euclidean,
                                  select_pair_mahalanobis, select_random, simnet_features,
                                  simnet_windows, transfer_finetune)
    from repro_torch.engine.aot import tree_map
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.uarch import UARCH_A, UARCH_B, UARCH_C, sample_design_space

    cfg = TaoConfig()
    # ---- selection over sampled designs on one short trace
    t0 = time.perf_counter()
    designs = sample_design_space(JOINT_DESIGNS, seed=JOINT_DESIGN_SEED)
    metrics = measure_design_metrics(designs, [JOINT_SELECT_TRACE], instructions=JOINT_SELECT_INSTRUCTIONS)
    pair = select_pair_mahalanobis(metrics)
    emit({"phase": "joint", "check": "selection", "designs": len(designs), "trace": JOINT_SELECT_TRACE,
          "instructions": JOINT_SELECT_INSTRUCTIONS, "seconds": time.perf_counter() - t0,
          "mahalanobis_pair": pair, "euclidean_pair": select_pair_euclidean(metrics),
          "random": [int(i) for i in select_random(len(designs), 2, seed=0)],
          "pair_names": [designs[i].name for i in pair], "metrics_finite": bool(np.isfinite(metrics).all())})
    if not (np.isfinite(metrics).all() and pair[0] < pair[1]):
        failures.append(f"joint: selection metrics {metrics.tolist()}, pair {pair}")

    t0 = time.perf_counter()
    ds_a, ok_a = labelled_windows(TRAIN_TRACES, UARCH_A, cfg)
    ds_b, ok_b = labelled_windows(TRAIN_TRACES, UARCH_B, cfg)
    ds_c, ok_c = labelled_windows((TRANSFER_TRACE,), UARCH_C, cfg)
    emit({"phase": "joint", "check": "data", "windows": [len(ds_a), len(ds_b)], "transfer_windows": len(ds_c),
          "seconds": time.perf_counter() - t0, "aligned": ok_a and ok_b and ok_c})
    if not (ok_a and ok_b and ok_c):
        failures.append("joint: the adjusted trace does not align with the functional trace")

    # ---- one capture per method, ahead of the counted runs
    like = tree_map(torch.as_tensor, next(ds_a.batches(TRAIN_BATCH)))
    captures = {}
    for method in METHODS:
        step = make_joint_step(cfg, AdamWConfig(lr=JOINT_LR), method)
        params = init_multiarch_like(cfg)
        t0 = time.perf_counter()
        step.entry.graph(params, {"opt": adamw_init(dict(params.named_parameters())),
                                  "w": torch.ones(2, device="cuda")},
                         {"initial": torch.ones(2), "a": like, "b": like})
        torch.cuda.synchronize()
        captures[method] = {"seconds": time.perf_counter() - t0, "compiles": step.entry.compiles,
                            "est_bytes": step.entry.est_bytes, "graphs": graph_nodes(step.entry)}
        del params
    emit({"phase": "joint", "check": "capture", "captures": captures})
    if not all(c["compiles"] == 1 and c["graphs"][0]["attention_nodes"] == 2 * cfg.n_layers
               and c["graphs"][0]["bwd_dkdv_dq_nodes"] == 2 * cfg.n_layers for c in captures.values()):
        failures.append(f"joint: captures {captures}")

    # ---- the main path: all four methods on their graphs
    entries = {m: make_joint_step(cfg, AdamWConfig(lr=JOINT_LR), m).entry for m in METHODS}
    replays0 = {m: sum(g.replays for g in e.aot.values()) for m, e in entries.items()}
    zero_counts()
    runs = {m: joint_loop(cfg, ds_a, ds_b, m) for m in METHODS}
    torch.cuda.synchronize()
    launches = read_counts()
    steps = sum(r["steps"] for r in runs.values())
    replays = {m: sum(g.replays for g in e.aot.values()) - replays0[m] for m, e in entries.items()}
    expected = {k: 0 for k in launches} | {"flash_attention": 2 * cfg.n_layers * steps,
                                           "flash_attention_bwd": 2 * cfg.n_layers * steps}
    by_nodes = {k: sum(replays[m] * captures[m]["graphs"][0][f"{k}_nodes"] for m in METHODS)
                for k in ("attention", "bwd_dkdv_dq")}
    counts_ok = (launches == expected and replays == {m: r["steps"] for m, r in runs.items()}
                 and by_nodes == {"attention": expected["flash_attention"],
                                  "bwd_dkdv_dq": expected["flash_attention_bwd"]}
                 and all(e.compiles == 1 for e in entries.values()))
    init = init_multiarch_like(cfg).state_dict()
    checks = {}
    for m, r in runs.items():
        adapt_same = all(torch.equal(r["params"].state_dict()[k], init[k]) for k in init if ".adapt." in k)
        checks[m] = {"finite": bool(np.isfinite(r["losses"]).all()),
                     "falling": r["epoch_losses"][-1] < r["epoch_losses"][0],
                     "adapt_unchanged": adapt_same,
                     "gradnorm_w_sum": float(r["w"].sum(axis=1).max()) if m == "gradnorm" else None}
    joint_ok = (counts_ok and all(c["finite"] for c in checks.values()) and checks["tao"]["falling"]
                and not checks["tao"]["adapt_unchanged"]
                and all(checks[m]["adapt_unchanged"] for m in METHODS if m != "tao")
                and np.allclose(runs["gradnorm"]["w"].sum(axis=1), 2.0, rtol=1e-6, atol=0))
    emit({"phase": "joint", "check": "train", "epochs": JOINT_EPOCHS, "batch": TRAIN_BATCH, "lr": JOINT_LR,
          "steps": {m: r["steps"] for m, r in runs.items()}, "launches": launches, "expected": expected,
          "replays": replays, "launches_from_graph_nodes": by_nodes,
          "flash_attention_per_step": launches["flash_attention"] / steps,
          "flash_attention_bwd_per_step": launches["flash_attention_bwd"] / steps,
          "epoch_losses": {m: r["epoch_losses"] for m, r in runs.items()},
          "gradnorm_w_last": runs["gradnorm"]["w"][-1].tolist(),
          "ms_per_step_host": {m: r["seconds"] / r["steps"] * 1e3 for m, r in runs.items()},
          "checks": checks, "ok": joint_ok})
    if not joint_ok:
        failures.append(f"joint: launches {launches} (expected {expected}), replays {replays}, "
                        f"from nodes {by_nodes}, checks {checks}")

    # ---- graphed against the eager step, in turns, under "tao"
    turns = {f"{i}_{'graphed' if g else 'eager'}": joint_loop(cfg, ds_a, ds_b, "tao", graphed=g)
             for i, g in enumerate((True, False, False, True))}
    ref = turns["1_eager"]
    held = {k: {"losses": bool(np.array_equal(t["losses"], ref["losses"])),
                "params": state_bitwise(t["params"], ref["params"]),
                "adamw": state_bitwise(t["opt"], ref["opt"])} for k, t in turns.items()}
    held_ok = all(all(v.values()) for v in held.values()) and np.array_equal(runs["tao"]["losses"], ref["losses"])
    gn_eager = joint_loop(cfg, ds_a, ds_b, "gradnorm", graphed=False, epochs=1)
    gn_graph = joint_loop(cfg, ds_a, ds_b, "gradnorm", epochs=1)
    gn_held = (np.array_equal(gn_eager["w"], gn_graph["w"])
               and np.array_equal(gn_eager["losses"], gn_graph["losses"])
               and state_bitwise(gn_eager["params"], gn_graph["params"]))
    profs = {name: joint_step_profile(cfg, ds_a, ds_b, graphed)
             for name, graphed in (("graphed", True), ("eager", False))}
    params = init_multiarch_like(cfg)
    state = (params, {"opt": adamw_init(dict(params.named_parameters())), "w": torch.ones(2, device="cuda")})
    rng = np.random.default_rng(0)
    inputs = [{"initial": torch.ones(2), "a": ba, "b": bb} for ba, bb in
              zip(ds_a.batches(TRAIN_BATCH, rng=rng), ds_b.batches(TRAIN_BATCH, rng=rng))]
    split = replay_split(next(iter(entries["tao"].aot.values())), inputs[:JOINT_PROFILE_STEPS], state)
    emit({"phase": "joint", "check": "graph_vs_eager", "method": "tao", "turns": list(turns), "held": held,
          "gradnorm_one_epoch_bitwise": gn_held,
          "ms_per_step_host": {k: t["seconds"] / t["steps"] * 1e3 for k, t in turns.items()},
          "windows_per_s": {k: 2 * t["steps"] * TRAIN_BATCH / t["seconds"] for k, t in turns.items()},
          "ms_per_step_device": {k: p["ms_per_step_device"] for k, p in profs.items()},
          "idle_share_profiled": {k: p["idle_share"] for k, p in profs.items()},
          "kernels_per_step": {"graphed": captures["tao"]["graphs"][0]["kernel_nodes"]},
          "graphed_host_ms_per_step_split": split,
          "top_device_ms": {k: p["top_device_ms"] for k, p in profs.items()}, "ok": held_ok and gn_held})
    if not (held_ok and gn_held):
        failures.append(f"joint: the graphed joint step differs from the eager one: {held}, "
                        f"gradnorm {gn_held}")

    # ---- the card's first steps against the CPU's, every method
    init_cpu = {k: v.cpu() for k, v in init.items()}
    vs_cpu = {}
    for m in METHODS:
        t0 = time.perf_counter()
        c = joint_loop(cfg, ds_a, ds_b, m, device="cpu", max_steps=TRAIN_CHECK_STEPS, init=init_cpu)
        cpu_s = time.perf_counter() - t0
        g = joint_loop(cfg, ds_a, ds_b, m, max_steps=TRAIN_CHECK_STEPS, init=init)
        vs_cpu[m] = {"loss_max_rel": float(np.abs(g["losses"] / c["losses"] - 1).max()),
                     "gradnorm_w_max_abs": float(np.abs(g["w"] - c["w"]).max()), "cpu_seconds": cpu_s}
    vs_ok = all(v["loss_max_rel"] <= JOINT_CPU_RTOL and v["gradnorm_w_max_abs"] <= JOINT_CPU_RTOL
                for v in vs_cpu.values())
    emit({"phase": "joint", "check": "gpu_vs_cpu", "steps": TRAIN_CHECK_STEPS, "limit": JOINT_CPU_RTOL,
          "per_method": vs_cpu, "ok": vs_ok})
    if not vs_ok:
        failures.append(f"joint: the card's first joint steps differ from the CPU's: {vs_cpu}")

    # ---- transfer of the jointly trained embedding onto UARCH_C
    joint = runs["tao"]["params"]
    embed0 = {k: v.clone() for k, v in joint.embed.state_dict().items()}
    ft = transfer_finetune(cfg, joint.embed, joint.A.state_dict(), ds_c, epochs=TRANSFER_EPOCHS,
                           batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=0, device="cuda")
    frozen = all(torch.equal(v, embed0[k]) for k, v in ft.params.embed.state_dict().items())
    ft_ok = frozen and all(math.isfinite(x) for x in ft.losses)
    emit({"phase": "joint", "check": "transfer", "uarch": UARCH_C.name, "trace": TRANSFER_TRACE,
          "steps": ft.steps, "losses": ft.losses, "seconds": ft.seconds, "embed_bitwise_unchanged": frozen,
          "ok": ft_ok})
    if not ft_ok:
        failures.append(f"joint: transfer losses {ft.losses}, embed unchanged {frozen}")

    # ---- SimNet: a few eager steps on the card against the CPU
    scfg = SimNetConfig()
    adj, _ = adjusted_trace(TRAIN_TRACES[0], UARCH_A)
    wins = simnet_windows(simnet_features(adj), scfg.window)
    batches = [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for k, v in wins.items()}
               for i in range(SIMNET_STEPS)]
    sim = {}
    zero_counts()
    for device in ("cpu", "cuda"):
        model = init_simnet(scfg, torch.Generator().manual_seed(0), device=device)
        opt = adamw_init(dict(model.named_parameters()))
        step = make_simnet_step(scfg, AdamWConfig(lr=TRAIN_LR))
        losses = []
        t0 = time.perf_counter()
        for b in batches:
            opt, loss = step(model, opt, b)
            losses.append(loss)
        losses = [x.item() for x in losses]
        sim[device] = {"losses": losses, "ms_per_step_host": (time.perf_counter() - t0) * 1e3 / len(batches)}
    sim_launches = read_counts()
    rel = max(abs(a / b - 1) for a, b in zip(sim["cuda"]["losses"], sim["cpu"]["losses"]))
    sim_ok = (all(math.isfinite(x) for x in sim["cuda"]["losses"]) and rel <= TRAIN_LOSS_RTOL
              and not any(sim_launches.values()))
    emit({"phase": "joint", "check": "simnet", "windows": len(wins["x"]), "steps": SIMNET_STEPS, **sim,
          "loss_max_rel": rel, "loss_rtol": TRAIN_LOSS_RTOL, "launches": sim_launches, "ok": sim_ok})
    if not sim_ok:
        failures.append(f"joint: SimNet on the card {sim}, rel {rel}, launches {sim_launches}")


def joint_step_profile(cfg, ds_a, ds_b, graphed: bool) -> dict:
    """Device time and idle share of JOINT_PROFILE_STEPS joint steps under
    "tao" (graphed, or the entry's eager step), from a profile of the steps
    alone (parameters and batches made before it)."""
    import numpy as np
    import torch

    from repro_torch.core import make_joint_step
    from repro_torch.core.transfer import to_device
    from repro_torch.train import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    params = init_multiarch_like(cfg)
    carry = {"opt": adamw_init(dict(params.named_parameters())), "w": torch.ones(2, device=dev)}
    step = make_joint_step(cfg, AdamWConfig(lr=JOINT_LR), "tao")
    rng = np.random.default_rng(0)
    pairs = list(zip(ds_a.batches(TRAIN_BATCH, rng=rng), ds_b.batches(TRAIN_BATCH, rng=rng)))
    pairs = pairs[:JOINT_PROFILE_STEPS]
    ones = torch.ones(2, device=dev)

    def steps():
        for ba, bb in pairs:
            if graphed:
                _, _, m = step(params, carry["opt"], carry["w"], ones, ba, bb)
            else:
                new, m = step.entry.fn(params, carry, {"initial": ones, "a": to_device(ba, dev),
                                                       "b": to_device(bb, dev)})
                carry.update(new)
        m["loss_a"].item()

    steps()
    prof = profile_breakdown(steps)
    prof["ms_per_step_device"] = prof["device_busy_s"] * 1e3 / len(pairs)
    return prof


def init_multiarch_like(cfg):
    """The joint parameters every run of the phase starts from (seed 0),
    on the card."""
    import torch

    from repro_torch.core import init_multiarch

    return init_multiarch(cfg, torch.Generator().manual_seed(0), device="cuda")


def rel_diff(a, b) -> float:
    """max |a - b| relative to max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


class _Calls:
    """Counts the calls of functions the facade imports, by name, while
    they run as they would (``with _Calls(module, names) as calls``)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.counts = {n: 0 for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def counting(*a, _n=n, _fn=fn, **kw):
                self.counts[_n] += 1
                return _fn(*a, **kw)
            setattr(self.module, n, counting)
        return self.counts

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def phase_session(failures, results, traces):
    """The facade (``repro_torch.api``) at the default TaoConfig width, as
    a user drives it (module note)."""
    import numpy as np
    import torch

    import repro_torch.api.session as api_session
    from repro_torch.api import Session, Trace, TrainedModel
    from repro_torch.core import TaoConfig, init_tao, make_joint_step
    from repro_torch.engine import EngineConfig, StreamingEngine, cache_stats, clear_step_cache
    from repro_torch.engine.aot import WARMUP_RUNS
    from repro_torch.train import AdamWConfig, train_step_compiles
    from repro_torch.uarch import UARCH_A, UARCH_B, get_benchmark

    cfg = TaoConfig()
    card = card_line()
    none = {k: 0 for k in launch_counters()}
    slices = {b: Trace(name=b, functional=t, program=get_benchmark(b), benchmark=b)
              for b, t in traces.items()}
    n_total = sum(len(t) for t in traces.values())

    def batches_of(bs):
        return sum(-(-(len(t) // cfg.window) // bs) for t in traces.values())

    def fused_counts(batches, captures):
        # a capture first runs the step eagerly WARMUP_RUNS times
        return none | {"fused_features": batches,
                       "flash_attention": cfg.n_layers * (batches + WARMUP_RUNS * captures)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def simulate_all(model, **kw):
        return {b: model.simulate(t, **kw) for b, t in slices.items()}

    def finite(res):
        return all(np.isfinite([r.cpi, r.branch_mpki, r.l1d_mpki]).all() and r.cpi > 0
                   for r in res.values())

    root = tempfile.mkdtemp(prefix="chip-smoke-session-")
    try:
        sess = Session(cfg, store=root)
        # ---- capture and train, from the store-less start
        trs, capture_s = timed(lambda: [sess.capture(b, TRAIN_INSTRUCTIONS) for b in TRAIN_TRACES])
        zero_counts()
        model, train_s = timed(lambda: sess.train(UARCH_A, trs, epochs=TRAIN_EPOCHS))
        train_launches = read_counts()
        windows = len(sess.dataset(UARCH_A, trs))
        ok = (model.device.type == "cuda" and model.steps == TRAIN_EPOCHS * (windows // TRAIN_BATCH)
              and len(model.losses) == TRAIN_EPOCHS and bool(np.isfinite(model.losses).all())
              and train_launches["flash_attention_bwd"] >= cfg.n_layers * model.steps)
        emit({"phase": "session", "check": "train", "traces": list(TRAIN_TRACES),
              "instructions_each": TRAIN_INSTRUCTIONS, "uarch": UARCH_A.name, "windows": windows,
              "capture_seconds": capture_s, "seconds": train_s, "train_loop_seconds": model.seconds,
              "steps": model.steps, "losses": model.losses, "launches": train_launches,
              "card": card, "ok": ok})
        if not ok:
            failures.append(f"session: train {model.steps} steps, losses {model.losses}, "
                            f"launches {train_launches}")

        # ---- simulate on the fused route: cold (the geometry's capture),
        # then warm; against a direct engine over the same weights
        zero_counts()
        captures0 = cache_stats()["compiles"]
        cold, cold_s = timed(lambda: simulate_all(model))
        cold_launches, cold_captures = read_counts(), cache_stats()["compiles"] - captures0
        zero_counts()
        warm, warm_s = timed(lambda: simulate_all(model))
        warm_launches = read_counts()
        engine = StreamingEngine(model.params, cfg, EngineConfig(), device="cuda")
        direct = {b: engine.simulate(t) for b, t in traces.items()}
        batches = batches_of(64)
        bitwise = {b: same_metrics(cold[b], direct[b]) and same_metrics(warm[b], direct[b])
                   for b in traces}
        ok = (all(bitwise.values()) and warm_launches == fused_counts(batches, 0)
              and cold_launches == fused_counts(batches, cold_captures) and cold_captures <= 1
              and finite(warm))
        emit({"phase": "session", "check": "simulate", "route": "fused", "traces": list(traces),
              "instructions": n_total, "batches": batches, "captures_cold": cold_captures,
              "launches_cold": cold_launches, "launches_warm": warm_launches,
              "fused_features_launches": warm_launches["fused_features"],
              "flash_attention_launches": warm_launches["flash_attention"],
              "seconds_cold": cold_s, "seconds_warm": warm_s, "mips_cold": n_total / 1e6 / cold_s,
              "mips_warm": n_total / 1e6 / warm_s, "bitwise_vs_direct_engine": bitwise,
              "cpi": {b: r.cpi for b, r in warm.items()}, "card": card, "ok": ok})
        if not ok:
            failures.append(f"session: simulate bitwise {bitwise}, launches cold {cold_launches} "
                            f"({cold_captures} captures) warm {warm_launches}, expected {batches} batches")

        # ---- int8: the quantized tree put in the store by the model, found
        # there by a second model of the same weights
        puts0 = sess.store.counters["puts"]
        q8, q8_s = timed(lambda: simulate_all(model, precision="int8"))
        stored = sess.store.counters["puts"] - puts0
        twin_params = init_tao(cfg, device="cuda")
        twin_params.load_state_dict(model.params.state_dict())
        twin = TrainedModel(params=twin_params, cfg=cfg, name="twin", store=sess.store, device="cuda")
        hits0 = sess.store.counters["hits"]
        q_twin = twin.quantized_params()
        found = sess.store.counters["hits"] - hits0
        q_own = model.quantized_params().state_dict()
        tree_bitwise = all(torch.equal(v, q_own[k]) for k, v in q_twin.state_dict().items())
        zero_counts()
        q8b, q8b_s = timed(lambda: simulate_all(twin, precision="int8"))
        q8b_launches = read_counts()
        int8_bitwise = {b: same_metrics(q8[b], q8b[b]) for b in traces}
        ok = (stored == 1 and found == 1 and tree_bitwise and all(int8_bitwise.values())
              and q8b_launches == fused_counts(batches, 0) and finite(q8b))
        emit({"phase": "session", "check": "int8", "traces": list(traces), "tree_put": stored,
              "tree_found_by_second_model": found, "tree_bitwise": tree_bitwise,
              "second_model_bitwise": int8_bitwise, "launches_second_model": q8b_launches,
              "seconds_first": q8_s, "seconds_second": q8b_s, "mips_second": n_total / 1e6 / q8b_s,
              "cpi": {b: r.cpi for b, r in q8b.items()}, "card": card, "ok": ok})
        if not ok:
            failures.append(f"session: int8 put {stored} found {found} tree {tree_bitwise} "
                            f"bitwise {int8_bitwise} launches {q8b_launches}")

        # ---- sweep: 2 models x the 3 traces, from a cold step cache, then warm
        other = sess.init_model(seed=1, name="init1")
        models = {"trained": model, "init1": other}
        clear_step_cache()
        zero_counts()
        rep, sweep_s = timed(lambda: sess.sweep(models, list(slices.values())))
        sweep_launches = read_counts()
        zero_counts()
        rep2, sweep2_s = timed(lambda: sess.sweep(models, list(slices.values())))
        sweep2_launches = read_counts()
        alone = {f"{mn}/{b}": (warm[b] if mn == "trained" else m.simulate(slices[b]))
                 for mn, m in models.items() for b in traces}
        bitwise = {k: same_metrics(rep.results[k], r) and same_metrics(rep2.results[k], r)
                   for k, r in alone.items()}
        jobs_batches = len(models) * batches
        ok = (rep.num_compiles == 1 and rep2.num_compiles == 0 and all(bitwise.values())
              and sweep_launches == fused_counts(jobs_batches, 1)
              and sweep2_launches == fused_counts(jobs_batches, 0))
        emit({"phase": "session", "check": "sweep", "jobs": len(rep.results), "models": len(models),
              "cold": sweep_report_line(rep), "warm": sweep_report_line(rep2),
              "launches_cold": sweep_launches, "launches_warm": sweep2_launches,
              "host_seconds_cold": sweep_s, "host_seconds_warm": sweep2_s,
              "bitwise_vs_single_simulates": all(bitwise.values()), "card": card, "ok": ok})
        if not ok:
            failures.append(f"session: sweep compiles {rep.num_compiles}/{rep2.num_compiles}, "
                            f"launches {sweep_launches} / {sweep2_launches}, bitwise {bitwise}")

        # ---- joint training (Algorithm 1), then A's head simulated
        entry = make_joint_step(cfg, AdamWConfig(lr=1e-3), "tao").entry
        joint_captures0 = entry.compiles
        zero_counts()
        joint, joint_s = timed(lambda: sess.train_joint(UARCH_A, UARCH_B, trs, epochs=1))
        joint_launches = read_counts()
        joint_captures = entry.compiles - joint_captures0
        head = joint.head("A")
        hres, head_s = timed(lambda: simulate_all(head))
        per_step = 2 * cfg.n_layers
        ok = (joint.steps > 0 and len(joint.losses) == 1 and bool(np.isfinite(joint.losses).all())
              and joint_launches["flash_attention_bwd"] >= per_step * joint.steps
              and joint_launches["flash_attention"] >= per_step * joint.steps and finite(hres))
        emit({"phase": "session", "check": "train_joint", "method": joint.method,
              "uarchs": [UARCH_A.name, UARCH_B.name], "steps": joint.steps, "losses": joint.losses,
              "captures": joint_captures, "launches": joint_launches, "seconds": joint_s,
              "train_loop_seconds": joint.seconds, "head_simulate_seconds": head_s,
              "head_cpi": {b: r.cpi for b, r in hres.items()}, "card": card, "ok": ok})
        if not ok:
            failures.append(f"session: train_joint steps {joint.steps}, losses {joint.losses}, "
                            f"launches {joint_launches}")

        # ---- a second Session on the same store: trains and detail-
        # simulates nothing
        sess2 = Session(cfg, store=root)
        zero_counts()
        with _Calls(api_session, ("run_detailed", "run_functional", "train_tao_impl")) as calls:
            (again, ds_b), again_s = timed(lambda: (
                sess2.train(UARCH_A, [sess2.capture(b, TRAIN_INSTRUCTIONS) for b in TRAIN_TRACES],
                            epochs=TRAIN_EPOCHS),
                sess2.dataset(UARCH_B, [sess2.capture(b, TRAIN_INSTRUCTIONS) for b in TRAIN_TRACES])))
        again_launches = read_counts()
        sa, sb = again.params.state_dict(), model.params.state_dict()
        params_bitwise = all(torch.equal(sa[k], sb[k]) for k in sb)
        ok = (all(c == 0 for c in calls.values()) and again_launches == none and params_bitwise
              and again.losses == model.losses and again.steps == model.steps
              and len(ds_b) == len(sess.dataset(UARCH_B, trs)))
        emit({"phase": "session", "check": "second_session", "calls": calls,
              "launches": again_launches, "params_bitwise": params_bitwise,
              "losses_equal": again.losses == model.losses, "seconds": again_s,
              "store": sess2.store.counters, "card": card, "ok": ok})
        if not ok:
            failures.append(f"session: a second session on the store made calls {calls}, "
                            f"launches {again_launches}, params bitwise {params_bitwise}")

        # ---- warmup ahead of any model: a batch size no earlier run
        # captured, so the first simulate after it captures nothing more
        sess3 = Session(cfg, batch_size=SESSION_WARMUP_BATCH, store=root)
        train0 = train_step_compiles()  # the default recipe: captured by train above
        out, warm_up_s = timed(lambda: sess3.warmup([SLICE_INSTRUCTIONS], train=True))
        captures0 = cache_stats()["compiles"]
        fresh = sess3.init_model(seed=2, name="init2")
        zero_counts()
        after, after_s = timed(lambda: simulate_all(fresh))
        after_launches = read_counts()
        after_captures = cache_stats()["compiles"] - captures0
        b32 = batches_of(SESSION_WARMUP_BATCH)
        ok = (out["sim_geometries"] == 1 and out["sim_aot"] == 1 and out["train_steps"] == 1
              and after_captures == 0 and train_step_compiles() == train0
              and after_launches == fused_counts(b32, 0) and finite(after))
        emit({"phase": "session", "check": "warmup", "batch_size": SESSION_WARMUP_BATCH,
              "warmup": out, "seconds": warm_up_s, "captures_after": after_captures,
              "launches_first_simulate": after_launches, "first_simulate_seconds": after_s,
              "first_simulate_mips": n_total / 1e6 / after_s, "card": card, "ok": ok})
        if not ok:
            failures.append(f"session: warmup {out}, then {after_captures} captures, "
                            f"launches {after_launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_mamba2(failures, results, traces):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model

    cfg = get_arch("mamba2-1.3b")
    B, S, steps = MAMBA_BATCH, MAMBA_PROMPT, MAMBA_DECODE
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    logits, cache = model.prefill(prompts)  # warm-up: cuBLAS handles, allocator pools
    model.decode_step(cache, logits.argmax(-1), S)
    del logits, cache
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    p_launches = read_counts()
    finite = bool(torch.isfinite(logits).all())
    tok = logits.argmax(-1)
    step_ms, d_launches = [], []
    for i in range(steps):
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok, S + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        d_launches.append(read_counts())
        finite &= bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
    peak = torch.cuda.max_memory_allocated()
    none = {k: 0 for k in p_launches}
    expected_p = none | {"ssd": cfg.n_layers}
    if p_launches != expected_p:
        failures.append(f"mamba2: prefill launches {p_launches}, expected {expected_p}")
    if any(d != none for d in d_launches):
        failures.append(f"mamba2: a decode step launched a kernel: {d_launches}")
    if not finite:
        failures.append("mamba2: non-finite logits")
    results["ssd"]["launches"] = p_launches["ssd"]
    emit({"phase": "mamba2", "config": cfg.name, "dtype": cfg.compute_dtype,
          "params": n_params, "init_seconds": init_s, "batch": B, "prompt_tokens": S,
          "prefill_seconds": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
          "prefill_launches": p_launches, "decode_steps": steps,
          "decode_ms_per_step_median": sorted(step_ms)[steps // 2],
          "decode_ms_per_step_mean": sum(step_ms) / steps,
          "decode_tokens_per_s": B * steps / (sum(step_ms) / 1e3),
          "decode_ssd_launches": [d["ssd"] for d in d_launches],
          "weights_bytes": base, "peak_bytes": peak, "finite_logits": finite})
    emit({"phase": "mamba2", "check": "profile", "call": "prefill",
          **profile_breakdown(lambda: model.prefill(prompts))})
    emit({"phase": "mamba2", "check": "profile", "call": "decode_step",
          **profile_breakdown(lambda: model.decode_step(cache, tok, S + steps))})
    del cache, logits

    # ---- handoff on a float32 copy of the same weights: the last logits of
    # prefill(p + t) against prefill(p) then decode_step(t)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    m32 = Model(cfg32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    m32.load_state_dict(model.state_dict())
    del model
    full, _ = m32.prefill(torch.cat([prompts, tok[:, None]], dim=1))
    _, cache32 = m32.prefill(prompts)
    dec, _ = m32.decode_step(cache32, tok, S)
    torch.cuda.synchronize()
    handoff = rel_diff(dec, full)
    del cache32
    ok = handoff <= HANDOFF_REL and bool(torch.isfinite(full).all())
    if not ok:
        failures.append(f"mamba2: prefill/decode handoff {handoff} > {HANDOFF_REL} of max |logit|")
    emit({"phase": "mamba2", "check": "handoff_f32", "prompt_tokens": S,
          "max_abs_diff_rel_to_max_logit": handoff, "limit": HANDOFF_REL, "ok": ok})

    # ---- the card's path (kernel) against the same model on the CPU (plain
    # versions), full width, first MAMBA_CPU_LAYERS layers, float32
    cfg4 = dataclasses.replace(cfg32, n_layers=MAMBA_CPU_LAYERS)
    sd4 = {k: v for k, v in m32.state_dict().items()
           if not k.startswith("layers.") or int(k.split(".")[1]) < MAMBA_CPU_LAYERS}
    del m32
    gpu = Model(cfg4, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    gpu.load_state_dict(sd4)
    cpu = Model(cfg4, device="cpu", generator=torch.Generator().manual_seed(1))
    cpu.load_state_dict({k: v.cpu() for k, v in sd4.items()})
    toks = prompts[:2, :MAMBA_CPU_SEQ]
    zero_counts()
    g_logits, g_cache = gpu.prefill(toks)
    g_step, _ = gpu.decode_step(g_cache, toks[:, 0], MAMBA_CPU_SEQ)
    torch.cuda.synchronize()
    g_launches = read_counts()["ssd"]
    t0 = time.perf_counter()
    c_logits, c_cache = cpu.prefill(toks.cpu())
    c_step, _ = cpu.decode_step(c_cache, toks[:, 0].cpu(), MAMBA_CPU_SEQ)
    cpu_s = time.perf_counter() - t0
    diffs = {"prefill_logits": rel_diff(g_logits.cpu(), c_logits),
             "decode_logits": rel_diff(g_step.cpu(), c_step),
             **{f"cache_{k}": rel_diff(g_cache[k].cpu(), c_cache[k]) for k in c_cache}}
    ok = max(diffs.values()) <= GPU_CPU_REL and g_launches == MAMBA_CPU_LAYERS
    if not ok:
        failures.append(f"mamba2: GPU and CPU disagree beyond {GPU_CPU_REL}: {diffs}, "
                        f"{g_launches} SSD launches")
    emit({"phase": "mamba2", "check": "gpu_vs_cpu", "layers": MAMBA_CPU_LAYERS,
          "tokens": list(toks.shape), "rel_diffs": diffs, "limit": GPU_CPU_REL,
          "gpu_ssd_launches": g_launches, "cpu_seconds": cpu_s, "ok": ok})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    from repro_torch.uarch import get_benchmark, run_functional

    t0 = time.perf_counter()
    traces = {b: run_functional(get_benchmark(b), SLICE_INSTRUCTIONS) for b in SLICE_BENCHMARKS}
    emit({"phase": "capture", "traces": list(SLICE_BENCHMARKS),
          "instructions_each": SLICE_INSTRUCTIONS, "seconds": time.perf_counter() - t0})
    failures, results = [], {}
    for phase in (phase_build, phase_kernels, phase_slice, phase_sweep, phase_train, phase_persist,
                  phase_joint, phase_session, phase_mamba2):
        phase(failures, results, traces)
        if failures:
            break
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    emit({"kernels": [results[k] for k in
                      ("fused_features", "branch_history", "memdist_delta", "flash_attention",
                       "flash_attention_bwd", "ssd")]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
