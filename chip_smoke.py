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
           S 17 / 200, D 16 / 64 / 128, causal and not, against the plain
           formulas, two calls bitwise, the forward's output bitwise with
           and without its log-sum-exp, timed beside SDPA's backward),
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
  train    the port's training path at the default TaoConfig width: the
           detailed simulator on lee and mcf (30,000 instructions each,
           UARCH_A), alignment, labelled features, windows; train_tao_impl
           for 2 epochs at batch 16 on the card, then transfer_finetune
           (frozen embeddings) for 1 epoch on dee under UARCH_B, with the
           launch counts read around both (2 attention forward and 2
           backward launches a step, no other kernel), the step's host and
           device ms, idle share and windows/s from a profile that must
           show only the port's attention kernels, the losses (finite,
           falling), the embeddings bitwise unchanged by the fine-tune,
           and the first 3 steps on the card against the CPU's;
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

import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
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
# batch 16 and 64, then short and long windows and narrow and wide heads
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
}
# the train cell: detailed-simulator labels on UARCH_A for the training
# traces, on UARCH_B for the transfer trace, at the default TaoConfig and
# FeatureConfig; Adam's lr as the trainer's default
TRAIN_TRACES = ("lee", "mcf")
TRANSFER_TRACE = "dee"
TRAIN_INSTRUCTIONS = 30_000
TRAIN_EPOCHS, TRANSFER_EPOCHS, TRAIN_BATCH, TRAIN_LR = 2, 1, 16, 3e-4
# the card's first steps against the same steps on the CPU: the forward
# differs in the last bits (cuBLAS vs CPU BLAS order, 3xTF32 attention), so
# the losses agree within 1e-4 relative; Adam moves each parameter by at
# most ~lr a step, and where a gradient is ~0 its sign can differ between
# the two, so a parameter may differ by up to 2 lr a step
TRAIN_CHECK_STEPS = 3
TRAIN_LOSS_RTOL = 1e-4

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
    the Tao training shapes and around them, causal and not: gradients
    within tolerance, two calls bitwise equal, the forward's output bitwise
    the same with and without its log-sum-exp, which is held to the plain
    one; then its times beside its bound, the plain version's and SDPA's
    backward at the training shape."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.kernels.attention.ref import attention_bwd_plain, attention_lse_plain

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    worst, all_ok, timed = 0.0, True, {}
    for name, (B, H, S, D, causal) in ATTN_BWD_CASES.items():
        # q, k, v as the Tao block hands them over: views of one packed projection
        q, k, v = packed_qkv(B, S, H, D, lambda *shape: torch.randn(*shape, generator=g).to(dev))
        do = torch.randn(B, S, H, D, generator=g).to(dev).transpose(1, 2)
        out_only = flash_attention_cuda(q, k, v, causal=causal)
        out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        ref = attention_bwd_plain(q, k, v, out, lse, do, causal)
        lse_ref = attention_lse_plain(q, k, causal=causal)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        within = all(bool(torch.all((a - b).abs() <= ATTN_BWD_ATOL + ATTN_BWD_RTOL * b.abs()))
                     for a, b in zip(got, ref))
        lse_err = float((lse - lse_ref).abs().max())
        lse_ok = bool(torch.all((lse - lse_ref).abs() <= LSE_ATOL + LSE_RTOL * lse_ref.abs()))
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        out_bitwise = torch.equal(out, out_only)
        ok = within and lse_ok and deterministic and out_bitwise
        worst, all_ok = max(worst, err), all_ok and ok
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", "case": name,
              "shape": [B, H, S, D], "causal": causal, "max_abs_err": err,
              "atol": ATTN_BWD_ATOL, "rtol": ATTN_BWD_RTOL, "lse_max_abs_err": lse_err,
              "lse_atol": LSE_ATOL, "two_calls_bitwise": deterministic,
              "forward_out_bitwise_with_and_without_lse": out_bitwise, "ok": ok})
        if name.startswith("tao_b") and causal:
            timed[B] = (q, k, v, out, lse, do)
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

    # times at the training shapes: the kernel (graph replay: device time),
    # its eager call, the plain version, and SDPA's backward (its kernels'
    # device time from the profiler, over 20 calls of autograd.grad)
    lines = {}
    for B, (q, k, v, out, lse, do) in sorted(timed.items()):
        _, H, S, D = q.shape
        ms = graph_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True))
        call_ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True), 100)
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
              "x_library": ms / lib_ms, "library": "scaled_dot_product_attention backward",
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
    tr = trace[:n]
    chunk_of = (np.arange(n) // cfg.window) * 32 // (n // cfg.window)
    min_chunk = np.bincount(chunk_of, minlength=32).min()
    min_mem_chunk = max(1, np.bincount(chunk_of, weights=tr["is_mem"], minlength=32).min())
    diffs = {
        "cpi_abs": abs(got.cpi - ref.cpi),
        "branch_mpki_abs": abs(got.branch_mpki - ref.branch_mpki),
        "l1d_mpki_abs": abs(got.l1d_mpki - ref.l1d_mpki),
        "cpi_phase_max_abs": float(np.abs(got.cpi_phase - ref.cpi_phase).max()),
        "l1d_phase_max_abs": float(np.abs(got.l1d_phase - ref.l1d_phase).max()),
    }
    tols = {
        "cpi_abs": 256.0 * (flips["fetch_lat"] + 1) / n,
        "branch_mpki_abs": 1000.0 * flips["mispredict"] / n,
        "l1d_mpki_abs": 1000.0 * flips["l1d_miss"] / n,
        "cpi_phase_max_abs": 256.0 * flips["fetch_lat"] / min_chunk,
        "l1d_phase_max_abs": flips["l1d_miss"] / min_mem_chunk,
    }
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


def labelled_windows(names, uarch, cfg):
    """The training data path: the detailed simulator's records for each
    trace on ``uarch``, aligned to the functional trace (§4.1), features
    with labels, windows (dedup per trace), concatenated."""
    from repro_torch.core import build_adjusted_trace, build_windows, concat_datasets
    from repro_torch.core import extract_features, verify_alignment
    from repro_torch.uarch import get_benchmark, run_detailed, run_functional

    parts, aligned_ok = [], True
    for name in names:
        prog = get_benchmark(name)
        ft = run_functional(prog, TRAIN_INSTRUCTIONS)
        det, _ = run_detailed(prog, ft, uarch)
        al = build_adjusted_trace(det)
        check = verify_alignment(al, ft)
        aligned_ok &= check["stream_match"] and check["cycles_match"]
        parts.append(build_windows(extract_features(al.adjusted, cfg.features), cfg.window))
    return concat_datasets(parts), aligned_ok


def params_diff(a, b) -> float:
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[k].cpu() - sb[k].cpu()).abs().max()) for k in sa)


def phase_train(failures, results, traces):
    """The port's training path at the default TaoConfig width: labelled
    windows from the detailed simulator, train_tao_impl for TRAIN_EPOCHS at
    batch 16 on the card, then Tao's transfer (frozen embeddings) to
    UARCH_B on another trace; the attention kernels' launches per step, the
    step's host and device time, idle share and windows/s; the first steps
    on the card against the same steps on the CPU."""
    import torch

    from repro_torch.core import TaoConfig, multi_metric_loss, tao_forward, train_tao_impl
    from repro_torch.core import transfer_finetune
    from repro_torch.core.model import init_tao
    from repro_torch.core.transfer import _make_step, to_device, trainable_params
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update
    from repro_torch.uarch import UARCH_A, UARCH_B

    import numpy as np

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

    # warm-up: cuBLAS handles, allocator pools, the kernels' first launches
    train_tao_impl(cfg, ds.subsample(2 * TRAIN_BATCH), epochs=1, batch_size=TRAIN_BATCH,
                   lr=TRAIN_LR, device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    res = train_tao_impl(cfg, ds, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                         seed=0, device="cuda")
    ft = transfer_finetune(cfg, res.params.embed, res.params, small, epochs=TRANSFER_EPOCHS,
                           batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    steps = res.steps + ft.steps
    expected = {k: 0 for k in launches} | {"flash_attention": cfg.n_layers * steps,
                                           "flash_attention_bwd": cfg.n_layers * steps}
    if launches != expected:
        failures.append(f"train: launches {launches}, expected {expected}")
    results["flash_attention_bwd"]["launches"] = launches["flash_attention_bwd"]
    finite = all(math.isfinite(x) for x in res.losses + ft.losses)
    falls = len(res.losses) == TRAIN_EPOCHS and res.losses[1] < res.losses[0]
    frozen = all(torch.equal(a, b) for a, b in zip(ft.params.embed.state_dict().values(),
                                                 res.params.embed.state_dict().values()))
    moved = params_diff(ft.params.pred, res.params.pred) > 0
    if not (finite and falls and frozen and moved):
        failures.append(f"train: losses {res.losses} / {ft.losses} (finite {finite}, falling "
                        f"{falls}), embed unchanged by the fine-tune {frozen}, pred moved {moved}")

    # the step's device time and idle share: one profiled epoch of 10
    # steps (model and optimizer made before the window)
    model = init_tao(cfg, torch.Generator().manual_seed(0), device="cuda")
    step = _make_step(cfg, AdamWConfig(lr=TRAIN_LR), "all")
    opt = adamw_init(trainable_params(model, "all"))
    batches = list(ds.batches(TRAIN_BATCH, rng=np.random.default_rng(0)))[:10]

    def ten_steps():
        nonlocal opt
        for b in batches:
            opt, loss = step(model, opt, to_device(b, torch.device("cuda")))
        loss.item()

    ten_steps()
    prof = profile_breakdown(ten_steps, track=("attention_kernel", "bwd_delta", "bwd_dkdv",
                                               "bwd_dq", "fmha", "flash_fwd", "flash_bwd",
                                               "efficient_attention"))
    names = set(prof["tracked_ms"])
    ours = {"attention_kernel", "bwd_delta", "bwd_dkdv", "bwd_dq"}
    library = [n for n in names if not any(n.startswith(o) for o in ours)]
    if library or not all(any(n.startswith(o) for n in names) for o in ours):
        failures.append(f"train: step profile attention kernels {sorted(names)}")
    # where the host's time goes: each part of the step on the host clock,
    # no synchronisation between them (the device idles most of the step),
    # and the kernels one step enqueues
    split = dict.fromkeys(("copy", "forward_loss", "backward", "adamw"), 0.0)
    params = trainable_params(model, "all")
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    for b in batches:
        t0 = time.perf_counter()
        tb = to_device(b, torch.device("cuda"))
        t1 = time.perf_counter()
        loss, _ = multi_metric_loss(tao_forward(model, tb, cfg), tb["labels"])
        t2 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(params.values()))
        t3 = time.perf_counter()
        opt = adamw_update(params, dict(zip(params, grads)), opt, opt_cfg)[1]
        t4 = time.perf_counter()
        for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[k] += dt * 1e3 / len(batches)
    torch.cuda.synchronize()
    per_step = kernels_enqueued(lambda: step(model, opt, to_device(batches[0], torch.device("cuda"))))
    host_ms = res.seconds / res.steps * 1e3
    emit({"phase": "train", "check": "train", "epochs": TRAIN_EPOCHS, "batch": TRAIN_BATCH,
          "lr": TRAIN_LR, "steps": res.steps, "losses": res.losses, "seconds": res.seconds,
          "ms_per_step_host": host_ms, "ms_per_step_device": prof["device_busy_s"] * 1e3 / 10,
          "idle_share_profiled": prof["idle_share"], "windows_per_s": res.steps * TRAIN_BATCH / res.seconds,
          "flash_attention_per_step": launches["flash_attention"] / steps,
          "flash_attention_bwd_per_step": launches["flash_attention_bwd"] / steps,
          "host_ms_per_step_split": split, "kernels_per_step": per_step,
          "launches": launches, "attention_kernels_ms": prof["tracked_ms"],
          "top_device_ms": prof["top_device_ms"], "ok": finite and falls})
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


def rel_diff(a, b) -> float:
    """max |a - b| relative to max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


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
    for phase in (phase_build, phase_kernels, phase_slice, phase_train, phase_mamba2):
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
