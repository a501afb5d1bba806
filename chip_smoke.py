#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py paper        # build, then the named phases only

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
           registers, shared memory and blocks per SM; in bfloat16 at the
           dense prefill shapes (4, 14, 2048, 64), (4, 32, 2048, 64) and
           (4, 32, 2048, 128), causal, qwen2-vl-2b's (4, 12, 2048, 128),
           causal, hubert-xlarge's (4, 16, 2048, 80), bidirectional, and
           qwen3-moe-235b-a22b's (4, 64, 2048, 128), causal, k / v drawn
           at 4 heads and repeated 16x, timed beside SDPA in bfloat16, with
           the wgmma (HGMMA) and mma.sync (HMMA) instructions of the kernel
           it launches), its backward (the
           port's own kernel: the Tao training shapes at batch 16 and 64,
           S 17 / 200, D 16 / 64 / 128, causal and not, the edges of its
           16-row and 64-row tiles, widths and strides that are not
           multiples of 4 floats, against the plain formulas, two calls
           bitwise, the forward's output bitwise with and without its
           log-sum-exp; what each of its kernels gets, no spills; timed
           beside SDPA's backward, with each kernel's device time and one
           (batch, head) alone; and on bfloat16 operands, the LLM trainer's,
           at qwen2-0.5b's (4, 14, 2048, 64) with k / v repeated 7x,
           qwen2-vl-2b's (4, 12, 2048, 128), causal, hubert-xlarge's (4,
           16, 2048, 80), bidirectional, and at unaligned strides, against
           the plain formulas rounded once, timed beside SDPA's bfloat16
           backward and the bound, with what each kernel gets),
           and the Mamba-2
           SSD scan (B5) at the full mamba2-1.3b prefill shape in float32
           and bfloat16, with two groups, in one chunk, at chunk 200, at
           widths 40 / 72, and against the sequential recurrence, with its
           registers, shared memory, blocks per SM and the tensor-core
           (HMMA) instructions in its SASS; and its backward (the port's
           own kernel, csrc/ssd_bwd.cu) against the plain chunked
           formulas at mamba2-1.3b's training shape (4 x 2048 and the
           2 x 2048 microbatch) in bfloat16 and float32 and at the
           forward's edge cases, each gradient's worst error against its
           limit, two calls bitwise, timed beside its bound and the plain
           version with each of its five kernels' device ms, what each
           gets and the tensor-core instructions of those that multiply
           (HGMMA in bfloat16, HMMA in float32), and across 32 chunks
           (1 x 8192) in both types;
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
  serve    the trace server (repro_torch.serve) at the default TaoConfig
           width, batch 64, with two models (torch.Generator seeds 0 and
           1), the three 150k traces and a 100-instruction one (w100b64):
           a model published to a store and resolved bitwise, its int8
           tree under quantized_params_key; warmup, then 4 closed-loop
           tenants x 2 rounds of every (model, trace) pair on the fused
           route (0 captures, 19 / 38 B1 / B4 launches a 150k request and
           1 / 2 a short one, by the counters and by graph nodes x
           replays, every result bitwise a direct simulate; traces/s,
           served MIPS beside a loop of direct simulates, latency and
           queue p50 / p99, batch_fill_ratio); the same load on the host
           route (one extraction per distinct trace, the rest coalesced,
           the extraction seconds saved); one request per trace on the
           staged route (1 B2 + 1 B3 each) and under int8, bitwise; faults
           on the card: a transient dispatch fault retried, a dispatch
           delayed past its request's deadline (the cohabitant and the
           next requests bitwise, the abandoned thread replays nothing,
           nothing logged), a poison trace in a group of 4 quarantined, a
           store resolve and int8 requests admitted while the dispatch
           thread is held inside a capture; the JSON-lines TCP front end
           (a 150k trace in one ~5 MB line, stats, models; the same line
           refused at the default 1 MiB); python -m
           repro_torch.launch.serve --demo as a child process;
  paper    the paper's model (get_arch("tao"): 6 layers, width 512, 8
           heads of 64, d_ff 2048, d_cat 128; random weights, seed 0):
           B4 at 64 windows and its backward at 16, causal, on the packed
           views, against their plain versions, timed beside SDPA's
           forward and backward and their bounds, with registers, spills
           and shared memory; the engine on the slice traces (the
           capture's seconds and bytes, the fused route with B1 and B4
           launches by the counters and by the graph's nodes x replays,
           MIPS, host and device ms per batch, idle share and the device
           time split into fp32 GEMMs, B4, B1 and the rest; the staged
           route; the fused route under int8 after qdense at every layer
           shape, int8 beside fp32 in turns; the fused route against the
           CPU on a 20,000-instruction prefix of dee; the graphed simulate
           against the eager step in turns); the train recipe at batch 16
           for 2 epochs on the train phase's windows (6 + 6 attention
           launches a step, graphed against eager in turns, bitwise; host
           and device ms a step, idle share, windows/s); the reference's
           examples/train_tao_e2e.py through Session (pair selection over
           8 designs, joint training, transfer to UARCH_C, scratch
           training, two unseen traces against their ground truth) at
           20,000 instructions and 6 epochs (cut from 40,000 and 12),
           each phase's seconds;
  mamba2   the port's Mamba-2 serving path at the full width of
           mamba2-1.3b (48 layers, bfloat16, random weights from a CUDA
           generator, seed 0): prefill of 4 prompts x 2048 tokens, then 32
           greedy decode steps, with the SSD launches read around each
           call (48 per prefill, 0 per decode step), prefill tokens/s,
           decode ms per step, peak device memory and a profile of one
           prefill; the prefill/decode handoff on a float32 copy of the
           same weights, and the card's path against the same model on
           the CPU (the plain versions) at 4 layers;
  dense    the dense family's serving path (bfloat16, random weights from
           a CUDA generator, seed 0): qwen2-0.5b and stablelm-1.6b at full
           width and depth (24 layers each), glm4-9b and qwen1.5-32b at
           full width cut to 2 layers; prefill of 4 prompts x 2048 tokens,
           then 32 greedy decode steps into a cache grown by 32 positions,
           with every kernel's launches read around each call (B4 once per
           layer per prefill, by the counter and the profiler; nothing in a
           decode step), prefill tokens/s, decode ms per step, weight and
           peak bytes and the profiles of one prefill and one step; for the
           two full-depth models the prefill/decode handoff on a float32
           copy of the weights, and the card against the CPU at 2 layers
           and 256 tokens;
  vlm_audio  the vlm and audio families at full width and depth (bfloat16,
           random weights from a CUDA generator, seed 0): qwen2-vl-2b (28
           layers, M-RoPE, GQA 6:1 at head dim 128) served as the dense
           cells are, each prompt with 64 random patches of width 1280
           over its first positions (B4 once per layer per prefill, none
           in a decode step; the handoff and the card against the CPU
           with the patches); hubert-xlarge (48 layers, 16 heads of 80)
           through Model.encode of 4 x 2048 random frames of width 512
           (B4 once per layer, bidirectional, by the counter and the
           profiler; frames/s, weight and peak bytes, a profile, finite
           (B, S, 504) logits) and the card against the CPU at 2 layers
           and 256 frames;
  moe      the moe family at full width (bfloat16, random weights from a
           CUDA generator, seed 0, the published capacity_factor 1.25),
           the models one after the other: deepseek-v2-lite-16b at full
           depth (27 layers, the first dense; MLA, so no B4 launch) and
           qwen3-moe-235b-a22b cut to 4 of its 94 layers (GQA 16:1 after
           QK-norm, B4 once per layer), each served as the dense cells are
           (launches by the counter and the profiler), with the device ms
           of a prefill and of a decode step split by stage (B4, expert
           GEMMs and their SwiGLU, routing, dispatch / combine, MLA's
           plain attention, other GEMMs, the rest) and the share of
           routed slots dropped at capacity in each; qwen3-moe's prefill
           whole and in 2 slices of the batch (ArchConfig.prefill_chunks)
           in turns, ms and peak bytes of each; the handoff on a
           float32 copy at capacity_factor = E (no slot can drop) on 4 x
           64-token prompts; and the card against the CPU in float32 at
           the published capacity (deepseek at 2 layers, qwen3-moe at 1;
           2 x 256 tokens; qwen3-moe's prefill whole and in 2 slices),
           with the routing choices that differ counted;
  hybrid   recurrentgemma-9b at full width and depth (38 layers: 12 units
           of two RG-LRU layers and one local-attention layer, window
           2048, 16 query heads of 256 over 1 kv head, and a tail of two
           RG-LRU layers; bfloat16, random weights from a CUDA generator,
           seed 0) served as the dense cells are: B4 launched by no call
           (the windowed attention runs the reference's plain blocked
           attention; by the counter and the profiler), 32 decode steps
           into a ring of 2048 slots that wrap at position 2048, device ms
           split by stage (the RG-LRU scan, conv + gates, the windowed
           attention, GEMMs, the rest); the handoff across position 2048
           and the card against the CPU (2 x 256 tokens) on a float32 copy
           cut to one unit and one tail layer;
  train_lm the LLM trainer: python -m repro_torch.launch.train's loop
           (launch/train.py::run) at full width and depth (bfloat16,
           weights from seed 0), 4 x 2048 tokens a step of
           LMDataPipeline's stream as one batch, AdamW, each model under
           its config's remat="full" (each layer recomputed in the
           backward), each for 10 steps with a checkpoint at step 5 and
           10: qwen2-0.5b (24 layers), mamba2-1.3b (48 layers) and
           hubert-xlarge (48 layers, the encoder, on frames); for each
           the losses (finite, the last below the first), wall ms a step
           with the card synchronised (median and range),
           tokens/s, the main kernels' launches in every step (B4's
           forward twice a layer, forward and recomputation, and its
           backward once: 48 + 24 for qwen2, 96 + 48 for hubert; B5 and
           its backward 96 + 48; nothing else) by the counters and, in one
           more profiled step, by the profiler, with its device ms by
           kernel group and idle share, the peak memory and the analytic
           bound of a step (roofline, kind "train"); then the last
           checkpoint removed and the same command run again: it resumes
           from the first in a fresh Model, and its losses are held to the
           uninterrupted run's.  Then the remat check, in process: one
           step of qwen2-0.5b (4 x 2048) and of mamba2-1.3b (2 x 2048, a
           batch that fits without remat) under "none", "full" and
           "dots" on the same weights and batch, the loss and every
           gradient under "full" and "dots" bitwise "none"'s, with each
           mode's backward peak, step peak, ms of loss plus gradient and
           kernel launches.
  dryrun   the runtime sanitizer and the one-card dry run
           (analysis/sanitize.py, launch/dryrun.py): the default
           TaoConfig's fused route, warm, on the three 150k traces inside
           sanitized(compile_budget=0) (the sync guard armed, NaNs
           checked): nothing raises or compiles, the results are the
           unsanitized run's, one B1 launch a batch; inside a sanitized
           block a planted .item() raises and device_get passes, and a
           planted NaN raises at the block's exit; one layer's B4 bfloat16
           call of qwen2-0.5b's prefill_32k, (2, 14, 32768, 64) causal,
           against its plain version one (batch, head) at a time, and B5 at
           mamba2-1.3b's (2 x 32768, 128 chunks), each timed beside its
           plain version and bound (B4 also beside SDPA); then run_cell for
           qwen2-0.5b's and mamba2-1.3b's prefill_32k (B4 / B5 once a
           layer), qwen2-0.5b's train_4k (16 x 4096 in 2 microbatches,
           remat "full": B4 twice a layer and its backward once, a
           microbatch) and mamba2-1.3b's long_500k (a decode over a
           524,288-token state: no kernel), each line the cell's record
           (step ms, profile, peak, launches, roofline terms) with the
           launches read around the whole run.

Each LLM phase (mamba2, dense, vlm_audio, moe, hybrid) prints, before
each model's reading, a ``roofline`` line per prefill (or encode) and per
median decode step: the port's analytic FLOPs and HBM bytes
(``launch/roofline.py``, with the model's parameter count and its cache's
bytes), the bound (the larger of FLOPs over the bfloat16 tensor-core peak
and bytes over the HBM rate), the measured ms and their ratio.

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main path, error, times and bound (B4's and its backward's entries also
hold their readings at the paper's width, B4's its bfloat16 readings and
the dense, vlm, audio, moe, hybrid and train_lm cells' launches; the
bfloat16 backward's entry its readings at the training shapes and its
launches in train_lm's qwen2-0.5b and hubert-xlarge runs; B5's its
launches in a prefill and in mamba2-1.3b's 10 training steps; the SSD
backward's its launches in those 10 steps; B4's, B5's and the bfloat16
backward's their readings at S = 32768 and their launches in the dryrun
cells); the card's name and power limit
as ``nvidia-smi`` prints them; and, last, the device line.  With phase
names as arguments, the build and those phases run, and the last line is
the device line with the phases' names; no kernels line.  Any failed check
exits nonzero before the device line.  Without a CUDA device, or outside a
checkout (no ``src/repro_torch``), it exits nonzero and prints no result.
Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import logging
import math
import os
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
# the serve phase: two models (torch.Generator seeds), the slice traces and
# a 100-instruction one (a second geometry, w100b64), 4 closed-loop tenants
# x 2 rounds; a dispatch delayed past a request's deadline; a capture held
# open while the event loop admits; a trace length no other phase captures
# (w77b64); a line limit that takes a 150k trace (~5 MB as JSON); the
# launcher's demo child
SERVE_SEEDS = (0, 1)
SERVE_SHORT = 100
SERVE_BATCH = 64
SERVE_TENANTS, SERVE_ROUNDS = 4, 2
SERVE_DELAY_S, SERVE_DEADLINE_S = 1.0, 0.3
SERVE_HOLD_S = 0.5
SERVE_ODD = 77
SERVE_MAX_LINE_BYTES = 8 << 20
SERVE_DEMO_TIMEOUT_S = 300
SERVE_TCP_TIMEOUT_S = 60
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
# the paper cell: get_arch("tao"), the reference's configs/tao.py (6 layers,
# width 512, 8 heads of 64).  The engine's check against the CPU runs on a
# prefix of one slice trace (the CPU's forward at that width does ~39
# MFLOP an instruction).  The session runs the reference's
# examples/train_tao_e2e.py under FULL=1 (its benchmarks, 40,000
# instructions each, 12 epochs) with the instructions and epochs cut
PAPER_CPU_INSTRUCTIONS = 20_000
PAPER_E2E_BENCHES = ("dee", "rom", "nab", "lee")
PAPER_E2E_UNSEEN = ("mcf", "cac")
PAPER_E2E_INSTRUCTIONS = 20_000
PAPER_E2E_EPOCHS = 6

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
# the SSD backward against its plain version: float32, each output within
# SSD_BWD_OF_MAX of its largest |plain| (split TF32 against float32 FMAs,
# sums in another order); bfloat16, each element within SSD_BWD_BF16_REL
# of |plain| plus SSD_BWD_OF_MAX of the largest (each side rounds a float32
# result once)
SSD_BWD_OF_MAX = 1e-4
SSD_BWD_BF16_REL = 2.0**-7
# the mamba2-1.3b serving cell: prompts x tokens, greedy decode steps
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_DECODE = 4, 2048, 32
MAMBA_CPU_LAYERS, MAMBA_CPU_SEQ = 4, 512
HANDOFF_REL = 2e-3         # prefill(p + t) vs prefill(p) + decode(t), float32
GPU_CPU_REL = 1e-3         # kernel path on the card vs plain path on the CPU
# B4 in bfloat16 against its plain version on the same bfloat16 inputs:
# both compute in float32 and round the output once, so an element may
# land one bfloat16 rounding (2^-8 relative, 2^-7 with the float32
# sums' order) apart; the absolute term covers outputs near 0
ATTN_BF16_RTOL = 2.0**-7
ATTN_BF16_ATOL_OF_MAX_V = 1e-5
# ...and at least this share of its elements bitwise the plain version's:
# with P kept in float32 (two bfloat16 terms) both round to the same
# bfloat16 but where the sums' order tips it; with P rounded to one
# bfloat16 term far fewer do (tests/test_torch_attention.py models both)
ATTN_BF16_MIN_BITWISE = 0.99
# (B, H, S, D, causal) of the serving cells' attention: the dense
# prefills of qwen2-0.5b (14 heads of 64 after the GQA repeat),
# stablelm-1.6b (32 of 64) and glm4-9b / qwen1.5-32b's width (32 of 128);
# qwen2-vl-2b's prefill (12 of 128 after the GQA repeat); hubert-xlarge's
# encode (16 of 80, bidirectional);
# qwen3-moe-235b-a22b's (64 of 128 after the GQA repeat over its 4 kv
# heads, after QK-norm), whose k / v are drawn at 4 heads and repeated 16x
# as B4 gets them.  (B, H, S, D, causal, kv heads' repeat)
ATTN_BF16_SHAPES = ((4, 14, 2048, 64, True, 1), (4, 32, 2048, 64, True, 1),
                    (4, 32, 2048, 128, True, 1), (4, 12, 2048, 128, True, 1),
                    (4, 16, 2048, 80, False, 1), (4, 64, 2048, 128, True, 16))
# B4's backward in bfloat16 against its plain version on the same bfloat16
# inputs (dO too): both compute in float32 and round each gradient once, so
# an element may land one bfloat16 rounding apart (2^-7 relative with the
# float32 sums' order), the absolute term covering gradients near 0; and
# at least ATTN_BWD_BF16_MIN_BITWISE of the elements bitwise the plain
# version's
ATTN_BWD_BF16_RTOL = 2.0**-7
ATTN_BWD_BF16_ATOL_OF_MAX = 1e-4
ATTN_BWD_BF16_MIN_BITWISE = 0.99
# (B, H, S, D, causal, kv heads' repeat) of the LLM trainer's attention:
# qwen2-0.5b's (14 heads of 64 after the GQA repeat of its 2 kv heads),
# qwen2-vl-2b's (12 of 128), hubert-xlarge's (16 of 80, bidirectional);
# then (B, H, S, D) with strides and widths that are not multiples of 8
# elements: q, k, v cut from one (B, H, S, 2 D + 1) tensor
ATTN_BWD_BF16_SHAPES = ((4, 14, 2048, 64, True, 7), (4, 12, 2048, 128, True, 1),
                        (4, 16, 2048, 80, False, 1))
ATTN_BWD_BF16_UNALIGNED = (2, 4, 300, 60)
# (B, H, S, D), causal, at twice the training cells' sequence: each
# gradient sums through one wgmma chain over every streamed tile, where
# the tensor cores' alignment of addends can grow with S
ATTN_BWD_BF16_LONG = (1, 2, 4096, 128)
# the bfloat16 backward's times at ATTN_BWD_BF16_SHAPES in its earlier
# design, the float32 kernels on bf16 tiles with TF32 mma.sync (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md), printed beside each reading as recorded, not
# measured; the kernels line holds only this run's numbers
ATTN_BWD_BF16_MMA_SYNC_MS = {"h14_d64": 1.1741, "h12_d128": 2.0818, "h16_d80": 5.3786}
# the LLM training cells, each at full width and depth and batch x seq of
# the serving cells, under its config's remat ("full", the reference's
# default: each layer's input kept, the layer recomputed in the backward):
# {config: (steps of the launcher's loop, checkpoint every)}, then a resume
# from that one checkpoint in a fresh Model (qwen2-0.5b ran 20 steps alone;
# 10 keep the script near its time beside the other two, and a checkpoint
# at 8 leaves six steps 1-6 for the median before its writer runs).
# mamba2-1.3b takes its 4 x 2048 tokens as one batch (without remat it
# would hold ~46 GB of activations); hubert-xlarge trains on
# LMDataPipeline's frames
TRAIN_LM_CELLS = {"qwen2-0.5b": (10, 8), "mamba2-1.3b": (10, 8), "hubert-xlarge": (10, 8)}
# the remat check: one step's loss and gradients under each mode, which
# must be bitwise "none"'s, at {config: batch} x DENSE_PROMPT tokens (a
# batch whose activations fit under "none")
REMAT_CELLS = {"qwen2-0.5b": 4, "mamba2-1.3b": 2}
# the trainer's microbatch path (TrainConfig.microbatches): one step of
# {config: (batch, microbatches)} at full width and depth under the
# config's remat, whole and cut, in float32 (B4 and its backward in
# float32), the gradients it hands to AdamW held to the whole batch's
# within this share of each gradient's largest |value| and the loss
# within MICROBATCH_LOSS_REL (the CPU tests' limits; the sums' order is
# all that differs).  In bfloat16 the tied embedding's gradient differs
# by ~10% of its largest value, its two halves cancelling (their largest
# 0.58 and 0.52 against the whole's 0.43), and 6e-6 in float32
MICROBATCH_CELLS = {"qwen2-0.5b": (4, 2)}
MICROBATCH_GRAD_OF_MAX = 1e-4
MICROBATCH_LOSS_REL = 1e-5
# the resumed steps' losses against the uninterrupted run's: every kernel
# of the step is deterministic, so bitwise is expected; the tolerance is
# what the phase accepts where the eager ops' kernels choose otherwise
TRAIN_LM_RESUME_REL = 1e-6
# the dense serving cells: prompts x tokens, greedy decode steps
# the dryrun phase: launch/dryrun.py's cells on the card, the two that take
# B4 bf16 and B5 to S = 32768 (2 x 32768 a prefill: the reference's 32 over
# its data axis of 16), qwen2-0.5b's train_4k (16 x 4096, 2 microbatches,
# remat "full": B4 and its backward) and mamba2-1.3b's 524,288-token state
# decode; each run for DRYRUN_STEPS timed steps
DRYRUN_CELLS = (("qwen2-0.5b", "prefill_32k"), ("mamba2-1.3b", "prefill_32k"),
                ("qwen2-0.5b", "train_4k"), ("mamba2-1.3b", "long_500k"))
DRYRUN_STEPS = 2
DRYRUN_SEQ = 32768
DRYRUN_SSD_BATCH = 2
# (B, H, S, D, kv heads' repeat) of qwen2-0.5b's prefill_32k attention
DRYRUN_ATTN_SHAPE = (2, 14, DRYRUN_SEQ, 64, 7)
# B4 bf16 at S = 32768 is held elementwise as in the kernels phase
# (ATTN_BF16_RTOL, ATTN_BF16_ATOL_OF_MAX_V); its bitwise share falls with
# S (99.74% at 2048): an output's float32 sum over 16x the keys carries
# about 4x (sqrt 16) the rounding error, so ~1% of its elements may round to
# the neighbouring bfloat16 where ~0.26% do at 2048; set before the first
# run at 32768, not after
DRYRUN_ATTN_MIN_BITWISE = 0.97
DENSE_FULL = ("qwen2-0.5b", "stablelm-1.6b")    # full width and depth
DENSE_CUT = ("glm4-9b", "qwen1.5-32b")          # full width, DENSE_CUT_LAYERS
DENSE_CUT_LAYERS = 2
DENSE_BATCH, DENSE_PROMPT, DENSE_DECODE = 4, 2048, 32
DENSE_CPU_LAYERS, DENSE_CPU_SEQ = 2, 256
# the vlm_audio cells run the dense cells' traffic; hubert's frames are
# HuBERT's 20 ms hops, so 4 x 2048 frames are 4 clips of ~41 s
HUBERT_FRAME_S = 0.02
# the moe cells run the dense cells' traffic: deepseek-v2-lite-16b at full
# width and depth (27 layers, the first dense); qwen3-moe-235b-a22b at full
# width cut to MOE_CUT_LAYERS of its 94 layers (~22.4 GB of bfloat16
# weights; all 94 would be ~470 GB), both at the published capacity_factor
MOE_FULL = "deepseek-v2-lite-16b"
MOE_CUT = "qwen3-moe-235b-a22b"
MOE_CUT_LAYERS = 4
# the card against the CPU in float32 at the published capacity: layers of
# the cut copy (one dense and one MoE layer of deepseek; one full-width
# qwen3-moe layer is ~10 GB of float32 weights) and the prompts (2 x 256)
MOE_CPU_LAYERS = {"deepseek-v2-lite-16b": 2, "qwen3-moe-235b-a22b": 1}
MOE_CPU_SEQ = 256
# qwen3-moe's prefill also in this many slices of the batch
# (ArchConfig.prefill_chunks), timed beside the whole batch and held to the
# CPU at it
MOE_PREFILL_CHUNKS = 2
# the handoff runs where no slot can drop, capacity_factor = E (C >= Tg *
# k), whose dispatch buffers grow with E: 4 prompts of this many tokens
MOE_HANDOFF_PROMPT = 64
# the hybrid cell: recurrentgemma-9b at full width and depth, the dense
# cells' traffic (DENSE_BATCH x DENSE_PROMPT, DENSE_DECODE steps: positions
# 2048-2079 overwrite ring slots 0-31); its handoff and the card against the
# CPU on a float32 copy of one unit and one tail layer, the latter on 2 x
# HYBRID_CPU_SEQ tokens
HYBRID_CUT_LAYERS = 4
HYBRID_CPU_SEQ = 256
# the port's profiler ranges (models/moe.py, models/attention.py: MLA's and
# the windowed attention, models/rglru.py) and the stage each one is
PROFILE_RANGES = {"moe.route": "routing", "moe.dispatch": "dispatch_combine",
                  "moe.combine": "dispatch_combine", "moe.experts": "experts",
                  "mla.attention": "mla_attention", "rglru.scan": "rglru_scan",
                  "rglru.conv": "conv_gates", "rglru.gates": "conv_gates",
                  "attention.windowed": "windowed_attention"}
GEMM_PIECES = ("nvjet", "gemm", "gemv")
# a profiler session on the card loses the first records of the kernels it
# traces, more of them the longer the process has run (in this script's
# later phases a prefill's first layer, one of a train step's 96 B5
# launches): each session first runs this many spin kernels (PREFIX_KERNEL),
# which take the loss and are left out of every count and time; a session
# that kept none of them fails (``prefix_left``), and each profile line
# says how many it lost (NVIDIA H100 80GB HBM3, 700 W: 1-34 a session, 164
# in stablelm-1.6b's prefill, 931 in recurrentgemma-9b's decode step)
PROFILE_PREFIX_KERNELS = 5000
PREFIX_KERNEL = "spin_kernel"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    from repro_torch.launch.dryrun import card_line as line

    return line()


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


def profile_prefix() -> None:
    """The spin kernels that open a profiler session (PROFILE_PREFIX_KERNELS),
    run to their end."""
    import torch

    for _ in range(PROFILE_PREFIX_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def prefix_left(averages) -> int:
    """How many of a session's PROFILE_PREFIX_KERNELS spin kernels its
    profile (``key_averages()``) kept.  Raises where it kept none: the loss
    may then have reached the kernels after them."""
    from torch.autograd import DeviceType

    left = sum(e.count for e in averages
               if e.device_type == DeviceType.CUDA and PREFIX_KERNEL in e.key)
    if not left:
        raise RuntimeError(f"a profiler session lost the records of all {PROFILE_PREFIX_KERNELS} "
                           "prefix kernels: its counts may miss the kernels after them")
    return left


def prefix_probe(launches: int = 300) -> dict:
    """``launches`` known kernels (an in-place add) counted by torch.profiler
    in a session as profile_breakdown opens it, without the prefix and then
    with it: how many of them each session lost, and how many of the
    prefix's records the second lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 16, device="cuda")
    out = {"launches": launches}
    for key, prefix in (("lost_without_prefix", False), ("lost_with_prefix", True)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if prefix:
                profile_prefix()
            for _ in range(launches):
                x.add_(1)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        out[key] = launches - sum(e.count for e in averages if e.device_type == DeviceType.CUDA
                                  and PREFIX_KERNEL not in e.key
                                  and not e.key.startswith(("Memcpy", "Memset")))
        if prefix:
            out["prefix_records_lost"] = PROFILE_PREFIX_KERNELS - prefix_left(averages)
    return out


def kernels_enqueued(fn, sessions: int = 3) -> int:
    """How many device kernels one ``fn()`` runs, from torch.profiler
    (copies and memsets not counted): the most over ``sessions`` profiled
    calls, each opened by ``profile_prefix`` and checked by
    ``prefix_left``.  A session can miss a kernel but never counts one
    that did not run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profile_prefix()
            fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        prefix_left(averages)
        counts.append(sum(e.count for e in averages if e.device_type == DeviceType.CUDA
                          and not e.key.startswith(("Memcpy", "Memset"))
                          and PREFIX_KERNEL not in e.key))
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
    from repro_torch.kernels import launch_counters as counters

    return counters()


def zero_counts() -> None:
    for c in launch_counters().values():
        c.launches = 0


def read_counts() -> dict:
    return {name: c.launches for name, c in launch_counters().items()}


def profile_breakdown(fn, track: tuple = (), groups: dict = None) -> dict:
    """Device time by kernel over one ``fn()``, from torch.profiler (CUPTI):
    busy = summed time of the device's kernel events (one stream: kernels
    do not overlap; the host ops that launched them are not counted again),
    idle share = 1 - busy / wall.  The profiler's own host overhead
    inflates the wall time here; the unprofiled runs report the real rates.
    ``track``: also the device ms and the launch count of each kernel whose
    name holds one of these pieces, by the name from there to its argument
    list.
    ``groups`` ({group: pieces}): also the device ms summed per group, a
    kernel going to the first group one of whose pieces its name holds,
    the rest to "other".  Where the profile holds the port's profiler
    ranges, also ``device_ms_split`` (``range_split``).  Raises when the
    profile cannot be taken or shows no device time.

    The session opens with ``profile_prefix``, whose kernels are left out
    (``prefix_records_lost``: how many of their records the session lost;
    ``prefix_left`` raises where it lost them all)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_prefix()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    lost = PROFILE_PREFIX_KERNELS - prefix_left(averages)
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not annotation(e) and PREFIX_KERNEL not in e.key]
    if not events:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    tracked = {e.key[e.key.index(t):].split("(")[0]: e.self_device_time_total / 1e3
               for e in events for t in track if t in e.key}
    tracked_count = {e.key[e.key.index(t):].split("(")[0]: e.count
                     for e in events for t in track if t in e.key}
    return {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        # PyTorch's copy / cast kernel (direct_copy_kernel_cuda): what a
        # .contiguous() or a layout-changing reshape launches
        "copy_kernels": sum(e.count for e in events if "copy_kernel" in e.key),
        "prefix_records_lost": lost,
        "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top],
        **({"tracked_ms": tracked, "tracked_count": tracked_count} if track else {}),
        **({"group_ms": group_ms(events, groups)} if groups else {}),
        **({"device_ms_split": split} if (split := range_split(prof.events())) else {}),
    }


def annotation(e) -> bool:
    """Whether a profiler event is a ``record_function`` range (the port's
    PROFILE_RANGES), which the profiler also lays on the device's timeline as a
    span around that range's kernels: a span, not a kernel, so no device
    time of its own."""
    return bool(getattr(e, "is_user_annotation", False)) or e.key in PROFILE_RANGES


def range_split(events) -> dict:
    """Device ms of a profile's kernel events by what they do, each event
    counted once, or None when the profile holds none of the port's
    profiler ranges (PROFILE_RANGES).  The profiler lays each range on the
    device's timeline as a span from its first kernel's start to its last
    one's end; one stream runs one kernel at a time, so the spans do not
    overlap (raises if they do) and a kernel inside a span is that range's.
    Inside ``moe.experts`` a GEMM (GEMM_PIECES) is an expert GEMM and the
    rest its SwiGLU; outside every span a kernel goes by its name to B4
    (``attention_kernel``), another GEMM or the rest.  (The ops' own
    ``kernels`` lists are not used: the profiler joins kernels to CPU events
    by correlation id, and its "Activity Buffer Request" event can share an
    op's id, so one kernel is listed under both.)"""
    import bisect

    from torch.autograd import DeviceType

    on_device = [e for e in events
                 if e.device_type == DeviceType.CUDA and PREFIX_KERNEL not in e.name]
    spans = sorted((e.time_range.start, e.time_range.end, PROFILE_RANGES[e.name])
                   for e in on_device if annotation(e) and e.name in PROFILE_RANGES)
    if not spans:
        return None
    if any(b[0] < a[1] for a, b in zip(spans, spans[1:])):
        raise RuntimeError("profiler ranges overlap on the device's timeline")
    starts = [s[0] for s in spans]
    split = dict.fromkeys(("b4", "expert_gemm", "expert_swiglu", "routing", "dispatch_combine",
                           "mla_attention", "rglru_scan", "conv_gates", "windowed_attention",
                           "other_gemm", "rest"), 0.0)
    for e in on_device:
        if annotation(e):
            continue
        j = bisect.bisect_right(starts, e.time_range.start) - 1
        where = spans[j][2] if j >= 0 and e.time_range.end <= spans[j][1] else None
        gemm = any(p in e.name for p in GEMM_PIECES)
        if "attention_kernel" in e.name:
            g = "b4"
        elif where == "experts":
            g = "expert_gemm" if gemm else "expert_swiglu"
        else:
            g = where or ("other_gemm" if gemm else "rest")
        split[g] += e.time_range.elapsed_us() / 1e3
    return split


def group_ms(events, groups: dict) -> dict:
    """Device ms of profiler events summed per group (see profile_breakdown)."""
    split = dict.fromkeys([*groups, "other"], 0.0)
    for e in events:
        g = next((n for n, pieces in groups.items() if any(p in e.key for p in pieces)), "other")
        split[g] += e.self_device_time_total / 1e3
    return split


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
    check_attention_bf16(failures, results)
    check_attention_bwd_kernel(failures, results)
    check_attention_bwd_bf16(failures, results)
    check_ssd_kernel(failures, results)
    check_ssd_bwd_kernel(failures, results)


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

    from repro_torch.kernels.attention.kernel import flash_attention_cuda
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
    t = attention_fwd_times(q, k, v, qc, kc, vc)
    if t["spill_bytes_per_thread"]:
        failures.append(f"flash_attention: {t['spill_bytes_per_thread']} spill bytes per thread")
    results["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:38",
        "max_abs_err": attn_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }
    emit({"phase": "kernels", "kernel": "flash_attention", "shape": list(q.shape),
          "operands": "packed_qkv_views", **t})


def check_attention_bf16(failures, results):
    """B4 with bfloat16 I/O at the serving cells' shapes (ATTN_BF16_SHAPES,
    causal or not, k / v repeated over the query heads where the cell's
    GQA does) against its plain version on the same bfloat16 inputs
    (every element within
    ATTN_BF16_RTOL * |plain| + ATTN_BF16_ATOL_OF_MAX_V * max|v|, and at
    least ATTN_BF16_MIN_BITWISE of them bitwise equal); its time beside the plain version's and
    SDPA's on the same bfloat16 operands, its bound (FLOPs at the bf16
    tensor rate, as for B5), what a launch gets and the tensor-core
    instructions of the kernel it launches (wgmma's HGMMA, and no
    mma.sync HMMA); and the float32 instantiations' (HMMA, no HGMMA)."""
    import torch

    from repro_torch.kernels._cuda import sass_counts
    from repro_torch.kernels.attention.kernel import FLASH_ATTENTION, flash_attention_cuda, launch_info
    from repro_torch.kernels.attention.ref import attention_plain

    sass = sass_counts(FLASH_ATTENTION.source, "attention_kernel")
    # the float32 (mma.sync) instantiations, by output column tiles of 8
    f32_sass = {dv8: ops for dv8 in (4, 8, 16)
                for k, ops in sass.items() if f"attention_kernelILi{dv8}EE" in k}
    emit({"phase": "kernels", "kernel": "flash_attention", "dtype": "float32", "check": "sass",
          "dv8": f32_sass})
    if len(f32_sass) != 3 or any(ops["HGMMA"] or not ops["HMMA"] for ops in f32_sass.values()):
        failures.append(f"flash_attention float32 SASS: {f32_sass}")
    g = torch.Generator(device="cuda").manual_seed(3)
    readings = {}
    for B, H, S, D, causal, rep in ATTN_BF16_SHAPES:
        q = torch.randn(B, H, S, D, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(B, H // rep, S, D, generator=g, device="cuda").to(torch.bfloat16)
                .repeat_interleave(rep, dim=1) for _ in range(2))
        a = flash_attention_cuda(q, k, v, causal=causal)
        b = attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (a.float() - b.float()).abs()
        limit = ATTN_BF16_RTOL * b.float().abs() + ATTN_BF16_ATOL_OF_MAX_V * float(v.float().abs().max())
        ok = bool(torch.all(diff <= limit)) and a.dtype == torch.bfloat16
        ms = graph_ms(lambda: flash_attention_cuda(q, k, v, causal=causal))
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=causal), 5)
        lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        visible = B * H * S * (S + 1) // 2 if causal else B * H * S * S
        b_ms, b_by = bound(4 * B * H * S * D * 2, visible * 4 * D, BF16_TENSOR_FLOPS_PER_S)
        info = launch_info(S, D, D, dtype=torch.bfloat16)
        [ops] = [v for k, v in sass.items() if f"wgmmaILi{64 if D <= 64 else 128}E" in k]
        r = {"shape": [B, H, S, D], "causal": causal, "kv_repeat": rep,
             "max_abs_err": float(diff.max()),
             "bitwise_share": float((a == b).float().mean()), "ok": ok, "ms": ms,
             "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
             "x_bound": ms / b_ms, "x_library": ms / lib_ms, **info,
             "sass_hgmma": ops["HGMMA"], "sass_hmma": ops["HMMA"]}
        readings[f"h{H}_d{D}"] = r
        emit({"phase": "kernels", "kernel": "flash_attention", "dtype": "bfloat16",
              "rtol": ATTN_BF16_RTOL, "atol_of_max_v": ATTN_BF16_ATOL_OF_MAX_V,
              "min_bitwise_share": ATTN_BF16_MIN_BITWISE, **r})
        if (not ok or r["bitwise_share"] < ATTN_BF16_MIN_BITWISE or info["spill_bytes_per_thread"]
                or not r["sass_hgmma"] or r["sass_hmma"]):
            failures.append(f"flash_attention bf16 at {[B, H, S, D]}, causal {causal}: ok {ok}, "
                            f"error {r['max_abs_err']}, bitwise share {r['bitwise_share']}, "
                            f"spills {info['spill_bytes_per_thread']}, "
                            f"HGMMA {r['sass_hgmma']}, HMMA {r['sass_hmma']}")
        del q, k, v, a, b, diff, limit
    keep = ("shape", "causal", "kv_repeat", "max_abs_err", "bitwise_share", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "regs_per_thread", "blocks_per_sm")
    results.setdefault("flash_attention", {})["bf16"] = {
        name: {k: r[k] for k in keep} for name, r in readings.items()}


def attention_fwd_times(q, k, v, qc, kc, vc) -> dict:
    """B4's times, causal, on the packed views ``q, k, v`` the model hands
    over (graph replay: device time; and its eager call), on contiguous
    copies ``qc, kc, vc``, the plain version's, SDPA's on both, its bound,
    and what a launch gets (registers, spills, shared memory, blocks)."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_cuda, launch_info
    from repro_torch.kernels.attention.ref import attention_plain

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
    return {"ms": ms, "contiguous_ms": contiguous_ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_packed_ms": lib_packed_ms, "bound_ms": b_ms,
            "bound_by": b_by, "x_bound": ms / b_ms, "x_library": ms / lib_ms,
            **launch_info(S, D, D)}


def attention_bwd_bound(B, H, S, D, causal):
    """The backward's least time: 7 tensors of B H S D floats moved (q, k,
    v, o, dO in; dq, dk, dv out) against 10 D FLOPs per visible (query,
    key) pair: the five products the function needs (s, dP, dV, dQ, dK),
    2 D each.  The kernel's second pass recomputes s and dP; that is its
    choice, not the function's work."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return bound(7 * B * H * S * D * 4, pairs * 10 * D)


def attention_bwd_held(q, k, v, do, causal):
    """B4's backward against its plain version on one input: gradients
    within tolerance, two calls bitwise, the forward's output bitwise with
    and without its lse, the lse held to the plain one; and the forward's
    (out, lse)."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.kernels.attention.ref import attention_bwd_plain, attention_lse_plain

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


def attention_bwd_times(q, k, v, out, lse, do):
    """The backward's times, causal, at one shape: the kernel (graph replay:
    device time), its eager call, the plain version, SDPA's backward (its
    kernels' device time from the profiler, over 20 calls of
    autograd.grad) and the bound; beside them the device ms of each of its
    kernels (profiler, 20 calls) and one (batch, head) alone (what a single
    block chain takes)."""
    import torch

    from repro_torch.kernels.attention.kernel import BWD_KERNEL_NAMES, flash_attention_bwd_cuda
    from repro_torch.kernels.attention.ref import attention_bwd_plain

    B, H, S, D = q.shape
    ms = graph_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True))
    call_ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True), 100)
    kprof = profile_breakdown(
        lambda: [flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True) for _ in range(20)],
        track=BWD_KERNEL_NAMES)
    kernel_ms = {n: t / 20 for n, t in kprof["tracked_ms"].items()}
    one = tuple(x[:1, :1] for x in (q, k, v, out, lse, do))
    one_bh_ms = graph_ms(lambda: flash_attention_bwd_cuda(*one, causal=True))
    plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, out, lse, do, True), 20)
    lib_ms, lib_kernels = sdpa_bwd_ms(q, k, v, do, True)
    b_ms, b_by = attention_bwd_bound(B, H, S, D, True)
    line = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}
    return line, {"x_bound": ms / b_ms, "x_library": ms / lib_ms, "kernel_ms": kernel_ms,
                  "one_batch_head_ms": one_bh_ms, "library": "scaled_dot_product_attention backward",
                  "library_kernels": lib_kernels}


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

    from repro_torch.kernels.attention.kernel import bwd_launch_info, flash_attention_cuda
    from repro_torch.kernels.attention.ref import attention_lse_plain

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    worst, all_ok, timed = 0.0, True, {}

    for name, (B, H, S, D, causal) in ATTN_BWD_CASES.items():
        # q, k, v as the Tao block hands them over: views of one packed projection
        q, k, v = packed_qkv(B, S, H, D, lambda *shape: torch.randn(*shape, generator=g).to(dev))
        do = torch.randn(B, S, H, D, generator=g).to(dev).transpose(1, 2)
        r, out, lse = attention_bwd_held(q, k, v, do, causal)
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
    r, _, _ = attention_bwd_held(q, k, v, do, True)
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
        lines[B], extra = attention_bwd_times(q, k, v, out, lse, do)
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", "shape": list(q.shape),
              "causal": True, "operands": "packed_qkv_views", **lines[B], **extra})
    at = lines[TRAIN_BATCH]
    results["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/attention_bwd.cu",
        # no TPU kernel: the reference's trainer differentiates its jnp attention
        "replaces": "src/repro/core/model.py:217",
        "max_abs_err": worst, "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"], "library_ms": at["library_ms"],
    }


def sdpa_bwd_ms(q, k, v, do, causal) -> tuple:
    """SDPA's backward on contiguous copies of ``q, k, v`` (the library's
    yardstick): its kernels' device ms per call from the profiler over 20
    calls of autograd.grad, and the names of the four longest."""
    import torch

    qs, ks, vs = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    dc = do.contiguous()

    def calls():
        for _ in range(20):
            torch.autograd.grad(out, (qs, ks, vs), dc, retain_graph=True)

    calls()
    prof = profile_breakdown(calls)
    return prof["device_busy_s"] * 1e3 / 20, [t[0] for t in prof["top_device_ms"][:4]]


def check_attention_bwd_bf16(failures, results):
    """B4's backward on bfloat16 operands (the LLM trainer's) against its
    plain version on the same bfloat16 inputs at the training cells'
    shapes (ATTN_BWD_BF16_SHAPES, k / v repeated over the query heads where
    the cell's GQA does), at unaligned strides and widths and at 4,096
    rows (ATTN_BWD_BF16_LONG): every gradient element within
    ATTN_BWD_BF16_RTOL |plain| + ATTN_BWD_BF16_ATOL_OF_MAX max |plain|, at least
    ATTN_BWD_BF16_MIN_BITWISE of them bitwise the plain version's, the
    forward's lse from the wgmma kernel; then each shape's time (graph
    replay), the plain version's, SDPA's bfloat16 backward (device time),
    the bound (10 D FLOPs a visible pair at the bf16 tensor rate, or the 8
    bfloat16 tensors and the float32 lse read or written once), the earlier
    design's recorded time (ATTN_BWD_BF16_MMA_SYNC_MS, in the reading line
    only) and what each of its kernels gets
    (registers, spills, blocks per SM).  First the tensor-core
    instructions of the kernels a call launches: the bfloat16 ones hold
    wgmma (HGMMA) and no mma.sync (HMMA), the float32 ones HMMA and no
    HGMMA."""
    import torch

    from repro_torch.kernels._cuda import sass_counts
    from repro_torch.kernels.attention.kernel import (
        FLASH_ATTENTION_BWD,
        bwd_launch_info,
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.attention.ref import attention_bwd_plain

    # the instantiations by template arguments: the bfloat16 (wgmma) kernel's
    # W, the float32 (mma.sync) one's
    sass = sass_counts(FLASH_ATTENTION_BWD.source, "bwd_dkdv_dq")
    pieces = {f"bf16_W{w}": f"bwd_dkdv_dq_wgmmaILi{w}E" for w in (64, 128)} | {
        f"float32_W{w}": f"bwd_dkdv_dqIfLi{w}E" for w in (32, 64, 128)}
    found = {name: next((ops for k, ops in sass.items() if piece in k), None)
             for name, piece in pieces.items()}
    sass_ok = all(ops is not None and ((ops["HGMMA"] > 0 and ops["HMMA"] == 0)
                                       if name.startswith("bf16") else
                                       (ops["HMMA"] > 0 and ops["HGMMA"] == 0))
                  for name, ops in found.items())
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "check": "sass", **found,
          "ok": sass_ok})
    if not sass_ok:
        failures.append(f"flash_attention_bwd SASS: {found}")

    g = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16

    def held(q, k, v, do, causal):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        ref = attention_bwd_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        ok, err, share = True, 0.0, 1.0
        for a, b in zip(got, ref):
            a32, b32 = a.float(), b.float()
            diff = (a32 - b32).abs()
            limit = ATTN_BWD_BF16_RTOL * b32.abs() + ATTN_BWD_BF16_ATOL_OF_MAX * float(b32.abs().max())
            ok &= bool(torch.all(diff <= limit)) and a.dtype == bf
            err = max(err, float(diff.max()))
            share = min(share, float((a == b).float().mean()))
        r = {"max_abs_err": err, "bitwise_share_min": share,
             "two_calls_bitwise": all(torch.equal(a, b) for a, b in zip(got, again))}
        r["ok"] = ok and share >= ATTN_BWD_BF16_MIN_BITWISE and r["two_calls_bitwise"]
        return r, out, lse

    def inputs(B, H, S, D, rep):
        """q, k, v, dO of a training shape, k / v drawn at H / rep heads and
        repeated; or, for rep None, cut from wider tensors at strides and
        widths that are not multiples of 8 elements."""
        if rep is None:
            base = torch.randn(B, H, S, 2 * D + 1, generator=g, device="cuda").to(bf)
            do = torch.randn(B, H, S, 2 * D + 1, generator=g, device="cuda").to(bf)[..., 2:D + 2]
            return base[..., :D], base[..., D:2 * D], base[..., 1:D + 1], do
        q = torch.randn(B, H, S, D, generator=g, device="cuda").to(bf)
        k, v = (torch.randn(B, H // rep, S, D, generator=g, device="cuda").to(bf)
                .repeat_interleave(rep, dim=1) for _ in range(2))
        return q, k, v, torch.randn(B, H, S, D, generator=g, device="cuda").to(bf)

    readings, worst = {}, 0.0
    cases = {f"h{H}_d{D}": (B, H, S, D, causal, rep)
             for B, H, S, D, causal, rep in ATTN_BWD_BF16_SHAPES}
    cases["unaligned_strides"] = (*ATTN_BWD_BF16_UNALIGNED, True, None)
    cases["long_s4096"] = (*ATTN_BWD_BF16_LONG, True, 1)
    for name, (B, H, S, D, causal, rep) in cases.items():
        q, k, v, do = inputs(B, H, S, D, rep)
        r, out, lse = held(q, k, v, do, causal)
        worst = max(worst, r["max_abs_err"])
        ms = graph_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal),
                      per_graph=5, replays=5)
        plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, out, lse, do, causal), 3, warmup=1)
        lib_ms, lib_kernels = sdpa_bwd_ms(q, k, v, do, causal)
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        nbytes, flops = 8 * B * H * S * D * 2 + B * H * S * 4, pairs * 10 * D
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
        info = bwd_launch_info(B, H, S, D, bf)
        r.update({"case": name, "shape": [B, H, S, D], "causal": causal, "kv_repeat": rep,
                  "q_strides": list(q.stride()), "dout_strides": list(do.stride()), "ms": ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "bound_operations_ms": flops / BF16_TENSOR_FLOPS_PER_S * 1e3,
                  "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "x_bound": ms / b_ms, "x_library": ms / lib_ms,
                  "mma_sync_ms_recorded": ATTN_BWD_BF16_MMA_SYNC_MS.get(name),
                  "library": "scaled_dot_product_attention backward, bfloat16",
                  "library_kernels": lib_kernels, "launch_info": info})
        readings[name] = r
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", "dtype": "bfloat16",
              "rtol": ATTN_BWD_BF16_RTOL, "atol_of_max": ATTN_BWD_BF16_ATOL_OF_MAX,
              "min_bitwise_share": ATTN_BWD_BF16_MIN_BITWISE, **r})
        if not r["ok"]:
            failures.append(f"flash_attention_bwd bf16 {name} at {[B, H, S, D]}, causal {causal}: {r}")
        del q, k, v, do, out, lse
    at = readings["h14_d64"]
    keep = ("shape", "causal", "kv_repeat", "max_abs_err", "bitwise_share_min", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")
    results["flash_attention_bwd_bf16"] = {
        "name": "flash_attention_bwd_bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/attention_bwd.cu",
        # no TPU kernel: the reference's LLM trainer differentiates flash_ref
        "replaces": "src/repro/models/attention.py:122",
        "max_abs_err": worst, "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"], "library_ms": at["library_ms"],
        "shapes": {name: {k: r[k] for k in keep} for name, r in readings.items()},
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


def ssd_work(B, S, H, P, G, N, c) -> tuple:
    """(bytes, FLOPs) B5 needs in bfloat16 with the state written: each
    input read once and y and the state written once; the causal scores C
    Bᵀ and the W X product over the lower triangle only (c(c+1)/2 entries
    per chunk, per group and per head), plus the state's apply and update,
    4NPH per token."""
    nbytes = (2 * B * S * H * P + 2 * B * S * G * N + B * S * H) * 2 + H * 4 + B * H * N * P * 4
    flops = B * (S // c) * (c * (c + 1) // 2) * 2 * (G * N + H * P) + B * S * 4 * N * P * H
    return nbytes, flops


def check_ssd_kernel(failures, results):
    """B5 against its plain chunked version (y and the final state) at the
    full mamba2-1.3b prefill shape in float32 and bfloat16, with two
    groups, in one chunk, at chunk 200 and at widths 40 / 72, and against
    the sequential recurrence; its launch resources and the tensor-core
    instructions in its SASS; timed at the prefill shape in bfloat16, with
    the state written, as prefill launches it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels._cuda import sass_counts
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
    nbytes, flops = ssd_work(B, S, H, P, G, N, c)
    # priced at the bf16 tensor-core rate: the kernel's products run there
    b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
    info = launch_info(N, c, bf16)
    if info["spill_bytes_per_thread"]:
        failures.append(f"ssd: {info['spill_bytes_per_thread']} spill bytes per thread")
    if info["blocks_per_sm"] < 1:
        failures.append("ssd: no block fits on an SM")
    hmma = {k: v["HMMA"] for k, v in sass_counts(SSD_SCAN.source, "ssd_kernel").items()}
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


def ssd_bwd_work(B, S, H, P, G, N, c, itemsize) -> tuple:
    """(bytes, FLOPs) the SSD backward needs: each input (x, dt, B, C, dy,
    A) read once and each gradient written once; per (batch, chunk) the
    causal score tiles C Bᵀ once per group and, per head, dy xᵀ, Wᵀ dy, M B
    and Mᵀ C over the lower triangle (c(c+1)/2 entries), plus five c·N·P
    products per head: the two state recurrences (S0 forward, dS back) and
    the state terms of dx, dB and dC."""
    tri = c * (c + 1) // 2
    nbytes = (3 * B * S * H * P + 4 * B * S * G * N + 2 * B * S * H) * itemsize + 2 * H * 4
    flops = 2 * B * (S // c) * (tri * G * N + H * (2 * tri * (P + N) + 5 * c * N * P))
    return nbytes, flops


def check_ssd_bwd_kernel(failures, results):
    """The SSD backward (csrc/ssd_bwd.cu) against ssd_chunked_bwd_plain at
    mamba2-1.3b's full training shape (4 x 2048, and the 2 x 2048 microbatch
    train_lm runs) in bfloat16 and float32 and at the forward's edge cases
    (two groups, one chunk, chunk 200, widths 40 / 72) and across 32 chunks
    (1 x 8192): each output's worst error against its limit and two calls
    bitwise; timed at the training shapes beside its bound and the plain
    version, with each of its five kernels' device ms and what it gets, and
    the tensor-core instructions of those that multiply (bfloat16 HGMMA,
    float32 HMMA)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels._cuda import sass_counts
    from repro_torch.kernels.ssd.kernel import (BWD_KERNEL_NAMES, SSD_SCAN_BWD, bwd_launch_info,
                                                ssd_scan_bwd_cuda)
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_plain

    s = get_arch("mamba2-1.3b").ssm
    d = get_arch("mamba2-1.3b").d_model
    H, P, G, N, c = s.n_heads(d), s.head_dim, s.n_groups, s.d_state, s.chunk
    f32, bf16 = torch.float32, torch.bfloat16
    B, S = DENSE_BATCH, DENSE_PROMPT
    cases = {  # name: (B, S, H, P, G, N, chunk, dtype)
        "train_bf16": (B, S, H, P, G, N, c, bf16),
        "train_f32": (B, S, H, P, G, N, c, f32),
        "microbatch_bf16": (B // 2, S, H, P, G, N, c, bf16),
        "two_groups_f32": (B, 512, H, P, 2, N, c, f32),
        "two_groups_bf16": (B, 512, H, P, 2, N, c, bf16),
        "single_chunk_f32": (B, c, H, P, G, N, c, f32),
        "chunk_200_f32": (2, 400, H, P, G, N, 200, f32),
        "chunk_200_bf16": (2, 400, H, P, G, N, 200, bf16),
        "widths_40_72_f32": (1, 256, 8, 40, G, 72, 64, f32),
        "widths_40_72_bf16": (1, 256, 8, 40, G, 72, 64, bf16),
        # the parallel state pass across 32 chunks
        "long_chain_bf16": (1, 8192, H, P, G, N, c, bf16),
        "long_chain_f32": (1, 8192, H, P, G, N, c, f32),
    }
    timed = ("train_bf16", "train_f32", "microbatch_bf16")
    names = ("dx", "ddt", "dA", "dB", "dC")
    ok, max_err, max_rel, readings = True, 0.0, 0.0, {}
    for i, (name, (b, sq, h, p, g, n, cc, dtype)) in enumerate(cases.items()):
        inp = ssd_inputs(b, sq, h, p, g, n, dtype, 100 + i)
        dy = (torch.randn(b, sq, h, p, generator=torch.Generator(device="cuda").manual_seed(i),
                          device="cuda")).to(dtype)
        got = ssd_scan_bwd_cuda(*inp, dy, chunk=cc)
        again = ssd_scan_bwd_cuda(*inp, dy, chunk=cc)
        want = ssd_chunked_bwd_plain(*inp, dy, cc)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        errs, good = {}, bitwise
        for out, a, w in zip(names, got, want):
            a, w = a.float(), w.float()
            top = float(w.abs().max())
            err = float((a - w).abs().max())
            limit = SSD_BWD_OF_MAX * top
            if dtype == f32 or out == "dA":
                fine = err <= limit
            else:  # the element-wise band
                fine = bool(torch.all((a - w).abs() <= SSD_BWD_BF16_REL * w.abs() + limit))
            fine &= bool(torch.isfinite(a).all())
            errs[out] = {"max_abs_err": err, "max_abs_plain": top, "limit_of_max": limit, "ok": fine}
            good &= fine
            max_err = max(max_err, err)
            max_rel = max(max_rel, err / max(top, 1e-30))
        emit({"phase": "kernels", "kernel": "ssd_bwd", "case": name,
              "shape": [b, sq, h, p, g, n, cc], "dtype": str(dtype), "errors": errs,
              "bf16_rel_band": SSD_BWD_BF16_REL if dtype == bf16 else None,
              "two_calls_bitwise": bitwise, "ok": good})
        ok &= good
        if name in timed:
            nbytes, flops = ssd_bwd_work(b, sq, h, p, g, n, cc, 2 if dtype == bf16 else 4)
            b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
            ms = cuda_ms(lambda: ssd_scan_bwd_cuda(*inp, dy, chunk=cc), 10)
            plain_ms = cuda_ms(lambda: ssd_chunked_bwd_plain(*inp, dy, cc), 3, warmup=1)
            # three calls: the profile may miss its window's first kernel
            prof = profile_breakdown(lambda: [ssd_scan_bwd_cuda(*inp, dy, chunk=cc)
                                              for _ in range(3)], track=BWD_KERNEL_NAMES)
            readings[name] = {"shape": [b, sq, h, p, g, n, cc], "dtype": str(dtype), "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "x_bound": ms / b_ms, "bytes": nbytes, "flops": flops,
                              "kernel_ms": {k: v / prof["tracked_count"][k]
                                            for k, v in prof["tracked_ms"].items()}}
        del inp, dy, got, again, want
        torch.cuda.empty_cache()
    if not ok:
        failures.append("ssd_bwd: kernel outside tolerance of its plain version, or not bitwise")

    info = {str(dt): bwd_launch_info(dt) for dt in (f32, bf16)}
    for per in info.values():
        for k, v in per.items():
            if v["spill_bytes_per_thread"] or v["blocks_per_sm"] < 1:
                failures.append(f"ssd_bwd: {k} spills or does not fit on an SM: {v}")
    sass = {k: {"HMMA": v["HMMA"], "HGMMA": v["HGMMA"]}
            for k, v in sass_counts(SSD_SCAN_BWD.source, "ssd_bwd").items()}
    # the kernels that multiply (each chunk's share of the states, the chunk
    # kernel): bfloat16 on wgmma (HGMMA), float32 on mma.sync (HMMA)
    mma_kernels = {k: ("HGMMA" if "bfloat16" in k else "HMMA") for k in sass
                   if "ssd_bwd_local" in k or "ssd_bwd_chunk" in k}
    if len(mma_kernels) != 4 or not all(sass[k][op] for k, op in mma_kernels.items()):
        failures.append(f"ssd_bwd: a kernel that multiplies lacks its tensor-core instructions "
                        f"(bfloat16 HGMMA, float32 HMMA): {sass}")
    main = readings["train_bf16"]
    results["ssd_bwd"] = {
        "name": "ssd_bwd", "route": "cuda", "source": "src/repro_torch/csrc/ssd_bwd.cu",
        "replaces": "none: the reference differentiates ssd_chunked_ref, "
                    "src/repro/models/mamba2.py:96",
        "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
    }
    emit({"phase": "kernels", "kernel": "ssd_bwd", "timed": readings, "launch_info": info,
          "sass": sass, "max_abs_err": max_err, "max_err_of_max": max_rel, "library_ms": None})
    # each kernel's device ms per call at the timed shapes beside what it gets
    for name, r in readings.items():
        per = info["torch.bfloat16" if "bf16" in name else "torch.float32"]
        emit({"phase": "kernels", "kernel": "ssd_bwd", "per_kernel": name, "shape": r["shape"],
              "kernels": {k: {"ms": next((v for piece, v in r["kernel_ms"].items()
                                          if piece.startswith(k)), None),
                              "regs_per_thread": per[k]["regs_per_thread"],
                              "smem_bytes_per_block": per[k]["smem_bytes_per_block"],
                              "blocks_per_sm": per[k]["blocks_per_sm"]}
                          for k in BWD_KERNEL_NAMES}})


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
                "flash_attention_bwd": 0, "ssd_bwd": 0}
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
                "flash_attention_bwd": 0, "ssd_bwd": 0}
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


def graph_vs_eager(failures, engine, traces, arrays, total_n, batches, lee_batches, phase="slice"):
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
                    failures.append(f"{phase}: graphed {route} simulate differs from the eager step "
                                    f"on {b}: {held[b]}")
        med = {b: {k: float(np.median(v)) for k, v in d.items()} for b, d in secs.items()}
        feats = None if route == "fused" else arrays["lee"]
        prof = {mode: profile_breakdown(fn) for mode, fn in (
            ("graphed", lambda: engine.simulate(traces["lee"], features=feats)),
            ("eager", lambda: eager_entry_loop(engine, traces["lee"], feats)))}
        out = {"phase": phase, "check": "graph_vs_eager", "route": route, "rounds": ROUTE_ROUNDS,
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


def check_qdense_on_card(failures, qshapes, phase="slice"):
    """``qdense`` on the card against the CPU at every dense layer shape
    ``qshapes`` of a TaoConfig, at the step's 8,256 rows and at 16 (IMMA's row
    padding): quantized buffers, codes, int32 sums (cuBLASLt IMMA) and
    float output bitwise (``core.quant.qdense_device_vs_cpu``, as the cuda
    tests run it)."""
    from repro_torch.core.quant import qdense_device_vs_cpu

    cases = {f"{k}x{n}@{rows}": qdense_device_vs_cpu(k, n, rows, "cuda")
             for k, n in qshapes for rows in (8256, 16)}
    bad = {c: same for c, same in cases.items() if not all(same.values())}
    if bad:
        failures.append(f"{phase} int8: qdense on the card differs from the CPU: {bad}")
    emit({"phase": phase, "check": "int8_qdense_gpu_vs_cpu",
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
                "branch_history": 0, "memdist_delta": 0, "ssd": 0, "flash_attention_bwd": 0,
                "ssd_bwd": 0}
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
                "flash_attention_bwd": 0, "ssd_bwd": 0}
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


def timed(fn):
    """``fn()`` and its seconds on the host clock, the card synchronised
    before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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


@contextlib.contextmanager
def hold_capture(seconds: float):
    """While inside, the next CUDA graph capture of a step sets the yielded
    event and then sleeps ``seconds`` between the capture's begin and end,
    so a CUDA call another thread makes in that window would break it."""
    import threading

    import torch

    from repro_torch.engine import aot

    started = threading.Event()
    saved = aot.CapturedStep._capture

    def capture(inner, fn, carry, batch):
        def held(*a):
            if torch.cuda.is_current_stream_capturing() and not started.is_set():
                started.set()
                time.sleep(seconds)
            return fn(*a)

        return saved(inner, held, carry, batch)

    aot.CapturedStep._capture = capture
    try:
        yield started
    finally:
        aot.CapturedStep._capture = saved


class _LogCount(logging.Handler):
    """Counts the WARNING-or-worse records logged while attached (asyncio's
    unretrieved-exception reports, a dispatch thread's errors)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(f"{record.name}: {record.getMessage()[:200]}")


def phase_serve(failures, results, traces):
    """The trace server (``repro_torch.serve``) at the default TaoConfig
    width, two models, the slice traces and a short one (module note)."""
    import asyncio

    import numpy as np
    import torch

    from repro_torch.api import Trace, TrainedModel
    from repro_torch.core import TaoConfig, extract_features, init_tao
    from repro_torch.engine import EngineConfig, StreamingEngine
    from repro_torch.engine.aot import graph_kernel_names
    from repro_torch.launch.serve import serve_forever
    from repro_torch.resilience import FaultPlan, FaultSpec, RetryPolicy, inject
    from repro_torch.serve import ModelRegistry, ServeError, ServeRequest, TraceServer, encode_trace
    from repro_torch.store import ArtifactStore
    from repro_torch.uarch import get_benchmark

    cfg = TaoConfig()
    card = card_line()
    none = {k: 0 for k in launch_counters()}
    models = {f"m{s}": TrainedModel(params=init_tao(cfg, torch.Generator().manual_seed(s), device="cuda"),
                                    cfg=cfg, name=f"m{s}") for s in SERVE_SEEDS}
    lee = get_benchmark("lee")
    work = {b: Trace(name=b, functional=t, program=get_benchmark(b), benchmark=b)
            for b, t in traces.items()}
    work["short"] = Trace(name="short", functional=traces["lee"][:SERVE_SHORT], program=lee,
                          benchmark="lee")
    batches = {k: -(-(len(t) // cfg.window) // SERVE_BATCH) if len(t) >= cfg.window else 1
               for k, t in work.items()}
    pairs = [(m, k) for m in models for k in work]
    log = _LogCount()
    logging.getLogger().addHandler(log)
    root = tempfile.mkdtemp(prefix="chip-smoke-serve-")

    def expected(reqs, staged=False):
        """The launches of ``reqs`` (keys of ``work``) on the fused or the
        staged route."""
        b = sum(batches[k] for k in reqs)
        if staged:
            return none | {"branch_history": len(reqs), "memdist_delta": len(reqs),
                           "flash_attention": cfg.n_layers * b}
        return none | {"fused_features": b, "flash_attention": cfg.n_layers * b}

    def bitwise(got, want):
        return got.num_instructions == want.num_instructions and got.metrics == want.metrics

    def registry(store=None, names=None):
        reg = ModelRegistry(store)
        for n in names or models:
            reg.register(n, models[n])
        return reg

    def stats_line(st):
        d = st.to_dict()
        return {k: d[k] for k in ("admitted", "completed", "failed", "rejected", "num_compiles",
                                  "features_extracted", "features_from_store", "features_coalesced",
                                  "traces_per_s", "latency_p50_s", "latency_p99_s", "queue_p50_s",
                                  "queue_p99_s", "batch_fill_ratio", "retries", "deadline_exceeded",
                                  "quarantined", "bisections", "breaker_sheds")}

    async def closed_loop(server, tenants, rounds, keys):
        """``tenants`` clients, each with one request in flight: every
        (model, trace) pair of ``keys``, ``rounds`` times."""
        async def tenant(i):
            out = []
            for _ in range(rounds):
                for m in models:
                    for k in keys:
                        out.append(((m, k), await server.submit(
                            ServeRequest(model=m, trace=work[k], tenant=f"t{i}"))))
            return out

        return [r for res in await asyncio.gather(*(tenant(i) for i in range(tenants))) for r in res]

    try:
        # ---- direct simulates of every pair first (no server runs beside
        # them), as the bitwise reference and the loop baseline
        direct, _ = timed(lambda: {p: models[p[0]].simulate(work[p[1]]) for p in pairs})
        direct, loop_s = timed(lambda: {p: models[p[0]].simulate(work[p[1]]) for p in pairs})
        loop_n = sum(r.num_instructions for r in direct.values())
        long_pairs = [p for p in pairs if p[1] != "short"]
        _, loop_long_s = timed(lambda: [models[m].simulate(work[k]) for m, k in long_pairs])
        loop_long_n = sum(direct[p].num_instructions for p in long_pairs)

        # ---- the registry: publish to a store, resolve in a fresh registry
        store = ArtifactStore(root)
        ModelRegistry(store).publish("pub", models["m1"])
        got = ModelRegistry(store).resolve("pub")
        sa, sb = got.params.state_dict(), models["m1"].params.state_dict()
        from repro_torch.api.session import quantized_params_key

        qkey = quantized_params_key(models["m1"].params)
        ok = (all(torch.equal(sa[k], sb[k]) for k in sb) and got.device.type == "cuda"
              and store.has("params_int8", qkey) and got.cfg == cfg)
        emit({"phase": "serve", "check": "registry", "params_bitwise": all(torch.equal(sa[k], sb[k])
                                                                          for k in sb),
              "int8_tree_under_quantized_params_key": store.has("params_int8", qkey),
              "store": store.counters, "card": card, "ok": ok})
        if not ok:
            failures.append("serve: registry publish / resolve")

        # ---- warm load: warmup, then 4 closed-loop tenants on the fused route
        entries = {k: StreamingEngine(models["m0"].params, cfg, EngineConfig(), device="cuda")
                   .step_entry_for(len(t)) for k, t in (("long", work["dee"]), ("short", work["short"]))}

        async def warm_load():
            server = TraceServer(registry(), batch_size=SERVE_BATCH)
            async with server:
                info = server.warmup(sorted({len(t) for t in work.values()}))
                replays0 = {k: e.aot.replays for k, e in entries.items()}
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = await closed_loop(server, SERVE_TENANTS, SERVE_ROUNDS, list(work))
                wall = time.perf_counter() - t0
                launches = read_counts()
                replays = {k: e.aot.replays - replays0[k] for k, e in entries.items()}
            return info, out, wall, launches, replays, server.stats()

        info, out, wall, launches, replays, st = asyncio.run(warm_load())
        reqs = [k for (_, k), _ in out]
        held = all(bitwise(r, direct[p]) for p, r in out)
        nodes = {k: sum("attention_kernel" in n for n in graph_kernel_names(e.aot.graph))
                 for k, e in entries.items()}
        from_nodes = sum(nodes[k] * replays[k] for k in nodes)
        served_n = sum(r.num_instructions for _, r in out)
        long_n = sum(r.num_instructions for (_, k), r in out if k != "short")
        per_req = {k: {"fused_features": batches[k], "flash_attention": cfg.n_layers * batches[k]}
                   for k in ("dee", "short")}
        ok = (st.num_compiles == 0 and launches == expected(reqs) and from_nodes == launches["flash_attention"]
              and held and st.completed == len(out) and st.failed == 0)
        emit({"phase": "serve", "check": "warm_load", "route": "fused", "tenants": SERVE_TENANTS,
              "rounds": SERVE_ROUNDS, "requests": len(out), "batch": SERVE_BATCH, "warmup": info,
              "num_compiles": st.num_compiles, "launches": launches, "per_request": per_req,
              "attention_nodes_per_graph": nodes, "replays": replays,
              "attention_from_graph_nodes": from_nodes, "bitwise_vs_direct": held,
              "wall_s": wall, "traces_per_s": len(out) / wall, "served_mips": served_n / 1e6 / wall,
              "loop_mips": loop_n / 1e6 / loop_s, "served_vs_loop": (served_n / wall) / (loop_n / loop_s),
              "long_request_ms_loop": loop_long_s / len(long_pairs) * 1e3,
              "loop_long_mips": loop_long_n / 1e6 / loop_long_s,
              "served_long_share_of_instructions": long_n / served_n,
              "stats": stats_line(st), "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: warm load: compiles {st.num_compiles}, launches {launches} "
                            f"(expected {expected(reqs)}), from nodes {from_nodes}, bitwise {held}")

        # ---- the host route: one extraction per distinct trace, shared by
        # every request of it; bitwise simulate(route="host").  With the
        # extraction started at admission (the card's default), every
        # request awaits the shared entry at dispatch, its owner's too, and
        # counts as coalesced, as in the reference
        direct_h = {p: models[p[0]].simulate(work[p[1]], route="host") for p in pairs}
        ext_s = {}
        for k, t in work.items():
            _, ext_s[k] = timed(lambda t=t: extract_features(t.functional, cfg.features, with_labels=False))

        async def host_load():
            server = TraceServer(registry(), batch_size=SERVE_BATCH, route="host")
            async with server:
                zero_counts()
                t0 = time.perf_counter()
                out = await closed_loop(server, SERVE_TENANTS, SERVE_ROUNDS, list(work))
                wall = time.perf_counter() - t0
                launches = read_counts()
            return out, wall, launches, server.stats(), server.extract_async

        out, wall, launches, st, at_admission = asyncio.run(host_load())
        held = all(bitwise(r, direct_h[p]) for p, r in out)
        h_expected = none | {"flash_attention": cfg.n_layers * sum(batches[k] for (_, k), _ in out)}
        saved = sum(ext_s[k] for (_, k), r in out if r.coalesced)
        coalesced = len(out) if at_admission else len(out) - len(work)
        ok = (st.features_extracted == len(work) and st.features_coalesced == coalesced
              and held and launches == h_expected and st.failed == 0)
        emit({"phase": "serve", "check": "host_route", "requests": len(out),
              "distinct_traces": len(work), "extraction_at_admission": at_admission,
              "features_extracted": st.features_extracted,
              "features_coalesced": st.features_coalesced, "extraction_s_per_trace": ext_s,
              "extraction_s_saved": saved, "launches": launches, "bitwise_vs_direct_host": held,
              "wall_s": wall, "served_mips": sum(r.num_instructions for _, r in out) / 1e6 / wall,
              "stats": stats_line(st), "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: host route: extracted {st.features_extracted}, coalesced "
                            f"{st.features_coalesced}, launches {launches}, bitwise {held}")

        # ---- the staged route and int8: one request per trace each
        def one_each(**kw):
            async def run():
                server = TraceServer(registry(), batch_size=SERVE_BATCH, **kw)
                async with server:
                    zero_counts()
                    out = [await server.submit(ServeRequest(model="m0", trace=t)) for t in work.values()]
                    return out, read_counts(), server.stats()
            return asyncio.run(run())

        direct_st = {k: models["m0"].simulate(t, route="staged") for k, t in work.items()}
        out, launches, st = one_each(route="staged")
        held = all(bitwise(r, direct_st[k]) for r, k in zip(out, work))
        ok = held and launches == expected(list(work), staged=True) and st.failed == 0
        emit({"phase": "serve", "check": "staged_route", "requests": len(out), "launches": launches,
              "bitwise_vs_direct_staged": held, "stats": stats_line(st), "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: staged route: launches {launches}, bitwise {held}")

        direct_8 = {k: models["m0"].simulate(t, precision="int8") for k, t in work.items()}
        out, launches, st = one_each(precision="int8")
        held = all(bitwise(r, direct_8[k]) for r, k in zip(out, work))
        ok = held and launches == expected(list(work)) and st.failed == 0
        emit({"phase": "serve", "check": "int8", "requests": len(out), "launches": launches,
              "num_compiles": st.num_compiles, "bitwise_vs_direct_int8": held,
              "stats": stats_line(st), "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: int8: launches {launches}, bitwise {held}")

        # ---- faults on the card
        async def transient():
            plan = FaultPlan(FaultSpec("serve.dispatch", times=1))
            server = TraceServer(registry(), batch_size=SERVE_BATCH,
                                 retry=RetryPolicy(max_attempts=3, base_delay_s=0.005))
            async with server:
                with inject(plan):
                    r = await server.submit(ServeRequest(model="m0", trace=work["mcf"]))
            return r, server.stats()

        r, st = asyncio.run(transient())
        ok = bitwise(r, direct[("m0", "mcf")]) and st.retries == 1 and st.failed == 0
        emit({"phase": "serve", "check": "fault_transient", "retries": st.retries,
              "bitwise_vs_direct": bitwise(r, direct[("m0", "mcf")]), "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: transient fault: retries {st.retries}, result {r.metrics}")

        async def hung():
            plan = FaultPlan(FaultSpec("serve.dispatch", kind="delay", delay_s=SERVE_DELAY_S, times=1))
            server = TraceServer(registry(), batch_size=SERVE_BATCH, group_size=2)
            async with server:
                with inject(plan):
                    zero_counts()
                    futs = [server.submit(ServeRequest(model="m0", trace=work["mcf"],
                                                       deadline_s=SERVE_DEADLINE_S)),
                            server.submit(ServeRequest(model="m1", trace=work["dee"]))]
                    out = await asyncio.gather(*futs, return_exceptions=True)
                    nxt = [await server.submit(ServeRequest(model=m, trace=work[k]))
                           for m, k in (("m1", "mcf"), ("m0", "lee"))]
                    # past the delay: the abandoned thread has woken by now
                    await asyncio.sleep(SERVE_DELAY_S + 0.5)
                    launches = read_counts()
            return out, nxt, launches, plan.hits.get("engine.simulate", 0), server.stats()

        (h, coh), nxt, launches, sims, st = asyncio.run(hung())
        held = {"cohabitant": bitwise(coh, direct[("m1", "dee")]),
                "next": [bitwise(r, direct[p]) for r, p in zip(nxt, (("m1", "mcf"), ("m0", "lee")))]}
        ok = (isinstance(h, ServeError) and h.code == "DEADLINE_EXCEEDED" and held["cohabitant"]
              and all(held["next"]) and sims == 3 and launches == expected(["dee", "mcf", "lee"])
              and st.deadline_exceeded == 1 and not log.records)
        emit({"phase": "serve", "check": "fault_deadline", "delay_s": SERVE_DELAY_S,
              "deadline_s": SERVE_DEADLINE_S, "hung": getattr(h, "code", repr(h)),
              "bitwise": held, "engine_simulate_calls": sims, "launches": launches,
              "logged": log.records, "stats": stats_line(st), "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: deadline fault: {getattr(h, 'code', h)}, bitwise {held}, "
                            f"simulates {sims}, launches {launches}, logged {log.records}")

        async def poison():
            bad = work["dee"]
            plan = FaultPlan(FaultSpec("serve.dispatch", match=bad.digest, times=None, transient=False,
                                       exc="ValueError"))
            server = TraceServer(registry(), batch_size=SERVE_BATCH, group_size=4)
            async with server:
                with inject(plan):
                    keys = [("m0", "mcf"), ("m0", "dee"), ("m0", "lee"), ("m1", "mcf")]
                    futs = [server.submit(ServeRequest(model=m, trace=work[k])) for m, k in keys]
                    out = await asyncio.gather(*futs, return_exceptions=True)
            return keys, out, server.stats()

        keys, out, st = asyncio.run(poison())
        held = [bitwise(r, direct[p]) for p, r in zip(keys, out) if p[1] != "dee"]
        rejected = out[1]
        ok = (isinstance(rejected, ServeError) and rejected.code == "TRACE_REJECTED" and all(held)
              and st.quarantined == 1 and st.bisections >= 1)
        emit({"phase": "serve", "check": "fault_poison", "group_size": 4,
              "poisoned": getattr(rejected, "code", repr(rejected)), "cohabitants_bitwise": held,
              "stats": stats_line(st), "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: poison: {rejected!r}, cohabitants {held}")

        # a store-resolved model and int8 requests admitted while the
        # dispatch thread captures a geometry no run has (held inside the
        # capture)
        odd = Trace(name="odd", functional=traces["mcf"][:SERVE_ODD], program=get_benchmark("mcf"),
                    benchmark="mcf")

        async def beside_capture():
            server = TraceServer(ModelRegistry(store), batch_size=SERVE_BATCH, precision="int8")
            server.registry.register("m0", models["m0"])
            async with server:
                with hold_capture(SERVE_HOLD_S) as started:
                    first = server.submit(ServeRequest(model="m0", trace=odd))
                    loop = asyncio.get_running_loop()
                    in_capture = await loop.run_in_executor(None, started.wait, 120)
                    t0 = time.perf_counter()
                    later = [server.submit(ServeRequest(model="pub", trace=t)) for t in (odd, work["mcf"])]
                    admit_s = time.perf_counter() - t0
                    out = await asyncio.gather(first, *later, return_exceptions=True)
            return in_capture, admit_s, out, server.stats()

        in_capture, admit_s, out, st = asyncio.run(beside_capture())
        want = [models["m0"].simulate(odd, precision="int8"), models["m1"].simulate(odd, precision="int8"),
                models["m1"].simulate(work["mcf"], precision="int8")]
        held = [not isinstance(r, BaseException) and bitwise(r, w) for r, w in zip(out, want)]
        ok = in_capture and all(held) and st.failed == 0 and not log.records
        emit({"phase": "serve", "check": "fault_beside_capture", "hold_s": SERVE_HOLD_S,
              "capture_started": in_capture, "admission_s": admit_s, "bitwise_vs_direct_int8": held,
              "num_compiles": st.num_compiles, "errors": [repr(r) for r in out if isinstance(r, BaseException)],
              "logged": log.records, "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: beside a capture: started {in_capture}, bitwise {held}, "
                            f"out {[repr(r)[:200] for r in out]}, logged {log.records}")

        # ---- the TCP front end: one simulate of a 150k trace, stats and
        # models, then the same line past the default line limit: the
        # server replies BAD_REQUEST and closes, with the rest of the line
        # unread (so the close may reach the client as a reset)
        line = (json.dumps({"op": "simulate", "model": "m0", "request_id": "tcp0",
                             "trace": encode_trace(work["mcf"].functional)}) + "\n").encode()

        async def tcp(max_line_bytes):
            server = TraceServer(registry(), batch_size=SERVE_BATCH)
            async with server:
                ready = asyncio.get_running_loop().create_future()
                kw = {} if max_line_bytes is None else {"max_line_bytes": max_line_bytes}
                task = asyncio.get_running_loop().create_task(
                    serve_forever(server, "127.0.0.1", 0, ready, **kw))
                _, port = await ready
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                t0 = time.perf_counter()
                writer.write(line)   # read the reply while the line is still going out
                resps = [json.loads(await asyncio.wait_for(reader.readline(), SERVE_TCP_TIMEOUT_S))]
                rtt = time.perf_counter() - t0
                if max_line_bytes is None:
                    try:
                        more = await asyncio.wait_for(reader.readline(), SERVE_TCP_TIMEOUT_S)
                        eof = "eof" if more == b"" else "data"
                    except ConnectionError:
                        eof = "reset"
                    except TimeoutError:
                        eof = "still open"
                else:
                    for op in ("stats", "models"):
                        writer.write(json.dumps({"op": op}).encode() + b"\n")
                        await writer.drain()
                        resps.append(json.loads(await asyncio.wait_for(reader.readline(),
                                                                        SERVE_TCP_TIMEOUT_S)))
                    eof = None
                writer.close()
                with contextlib.suppress(ConnectionError):
                    await writer.wait_closed()
                task.cancel()
            return resps, rtt, eof

        with contextlib.redirect_stdout(io.StringIO()):
            (res, stats, names), rtt, _ = asyncio.run(tcp(SERVE_MAX_LINE_BYTES))
            (refused,), _, eof = asyncio.run(tcp(None))
        want = direct[("m0", "mcf")]
        over_tcp = res.get("ok") and res["result"]["metrics"] == want.metrics
        ok = (over_tcp and res["result"]["request_id"] == "tcp0" and stats.get("ok")
              and stats["stats"]["completed"] == 1 and names.get("models") == sorted(models)
              and refused.get("error") == "BAD_REQUEST" and eof in ("eof", "reset"))
        emit({"phase": "serve", "check": "tcp", "line_bytes": len(line),
              "max_line_bytes": SERVE_MAX_LINE_BYTES, "round_trip_ms": rtt * 1e3,
              "bitwise_vs_in_process": bool(over_tcp), "models": names.get("models"),
              "default_limit_reply": refused, "closed_after": eof, "card": card, "ok": bool(ok)})
        if not ok:
            failures.append(f"serve: tcp: result {str(res)[:300]}, refused {refused}, eof {eof!r}")

        # ---- the launcher's demo, as a child process on the card
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--demo"], cwd=ROOT,
                               env=env, capture_output=True, text=True, timeout=SERVE_DEMO_TIMEOUT_S)
        demo_s = time.perf_counter() - t0
        try:
            demo = json.loads(child.stdout[child.stdout.index("\n{") + 1:])
        except ValueError:
            demo = {}
        ok = (child.returncode == 0 and demo.get("completed") == 20 and demo.get("failed") == 0
              and demo.get("num_compiles") == 0)
        emit({"phase": "serve", "check": "launcher_demo", "returncode": child.returncode,
              "seconds": demo_s, "stats": {k: demo.get(k) for k in ("completed", "failed", "num_compiles",
                                                                    "traces_per_s", "latency_p50_s")},
              "card": card, "ok": ok})
        if not ok:
            failures.append(f"serve: launcher --demo: rc {child.returncode}, "
                            f"stdout {child.stdout[-500:]!r}, stderr {child.stderr[-1500:]!r}")
    finally:
        logging.getLogger().removeHandler(log)
        shutil.rmtree(root, ignore_errors=True)


def phase_paper(failures, results, traces):
    """The paper's model (``repro_torch.configs.get_arch("tao")``, random
    weights from seed 0) through the kernels, the engine, the trainer and
    the facade (module note)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("tao")
    emit({"phase": "paper", "check": "config", "config": dataclasses.asdict(cfg),
          "head_dim": cfg.head_dim, "card": card_line()})
    paper_kernels(failures, results, cfg)
    paper_engine(failures, results, traces, cfg)
    paper_train(failures, results, cfg)
    paper_session(failures, cfg)


def paper_kernels(failures, results, cfg):
    """B4 at the engine's batch of 64 windows and its backward at the train
    batch of 16, causal, on the packed q/k/v views of the paper's width (8
    heads of 64): each held to its plain version, timed beside SDPA's
    forward / backward and its bound, with its launch resources."""
    import torch

    from repro_torch.engine import EngineConfig
    from repro_torch.kernels.attention.kernel import bwd_launch_info, flash_attention_cuda
    from repro_torch.kernels.attention.ref import attention_plain

    g = torch.Generator(device="cpu").manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to("cuda")

    H, S, D = cfg.n_heads, cfg.window, cfg.head_dim
    q, k, v = packed_qkv(EngineConfig().batch_size, S, H, D, rand)
    a = flash_attention_cuda(q, k, v, causal=True)
    b = attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    ok = bool(torch.all((a - b).abs() <= ATTN_ATOL + ATTN_RTOL * b.abs()))
    t = attention_fwd_times(q, k, v, *(x.contiguous() for x in (q, k, v)))
    fwd = {"shape": list(q.shape), "max_abs_err": err, "atol": ATTN_ATOL, "rtol": ATTN_RTOL,
           "ok": ok, **t, "launches_per_batch": cfg.n_layers}
    emit({"phase": "paper", "kernel": "flash_attention", "operands": "packed_qkv_views", **fwd})
    if not ok or t["spill_bytes_per_thread"]:
        failures.append(f"paper: B4 at {list(q.shape)}: error {err}, spills "
                        f"{t['spill_bytes_per_thread']}")

    q, k, v = packed_qkv(TRAIN_BATCH, S, H, D, rand)
    do = rand(TRAIN_BATCH, S, H, D).transpose(1, 2)
    r, out, lse = attention_bwd_held(q, k, v, do, True)
    line, extra = attention_bwd_times(q, k, v, out, lse, do)
    info = bwd_launch_info(TRAIN_BATCH, H, S, D)
    bwd = {"shape": list(q.shape), **r, **line, "launches_per_step": cfg.n_layers}
    emit({"phase": "paper", "kernel": "flash_attention_bwd", "causal": True,
          "operands": "packed_qkv_views", **bwd, **extra, "launch_info": info})
    # a spill is reported, not failed: the width-64 template sits at the
    # edge of the register file
    if not r["ok"]:
        failures.append(f"paper: B4's backward at {list(q.shape)} outside tolerance: {r}")
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    # beside the kernels line's entries (their slice / train cell readings)
    results.setdefault("flash_attention", {})["paper_width"] = {k: fwd[k] for k in keep}
    results.setdefault("flash_attention_bwd", {})["paper_width"] = {k: bwd[k] for k in keep}


def paper_engine(failures, results, traces, cfg):
    """StreamingEngine at the paper's width on the slice cell's three 150k
    traces: the capture, the fused route (B1 and B4 launches by the
    counters and by the graph's nodes x replays), the staged route, the
    fused route under int8 (qdense on the card against the CPU at every
    layer shape first), int8 beside fp32 in turns, a profile split of the
    device time, the fused route against the CPU on a prefix of one trace,
    and the graphed simulate against the eager step in turns."""
    import numpy as np
    import torch

    from repro_torch.core.model import init_tao
    from repro_torch.core.quant import dense_layers, dense_shapes
    from repro_torch.engine import EngineConfig, StreamingEngine, cache_stats
    from repro_torch.engine.aot import graph_kernel_names
    from repro_torch.kernels.attention.kernel import FLASH_ATTENTION
    from repro_torch.kernels.features.ops import device_feature_arrays, trace_columns

    fcfg = cfg.features
    metrics = ("cpi", "branch_mpki", "l1d_mpki", "cpi_phase", "l1d_phase")
    ecfg = EngineConfig(metrics=metrics)
    none = {k: 0 for k in launch_counters()}

    def extract(trace):
        arrays = device_feature_arrays(trace_columns(trace, fcfg), fcfg, device="cuda")
        torch.cuda.synchronize()
        return arrays

    def b4_counts(entry, launches, replays):
        nodes = sum("attention_kernel" in k for k in graph_kernel_names(entry.aot.graph))
        return nodes, {"counter": launches["flash_attention"], "graph_nodes_x_replays": nodes * replays,
                       "captured_x_replays": entry.aot.launches.get(FLASH_ATTENTION, 0) * replays}

    def capture(engine):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry = engine.warmup(SLICE_INSTRUCTIONS)
        torch.cuda.synchronize()
        return entry, time.perf_counter() - t0

    model = init_tao(cfg, torch.Generator().manual_seed(0), device="cuda")
    engine = StreamingEngine(model, cfg, ecfg, device="cuda")
    entry, capture_s = capture(engine)
    emit({"phase": "paper", "check": "capture", "seconds": capture_s, "compiles": entry.compiles,
          "retained_bytes_est": entry.est_bytes,
          "launches_per_replay": {k.symbol: n for k, n in entry.aot.launches.items()},
          "kernel_nodes": len(graph_kernel_names(entry.aot.graph)), "cache_stats": cache_stats()})
    engine.simulate(traces["lee"])  # warm-up: allocator pools, the column copies
    engine.simulate(traces["lee"], features=extract(traces["lee"]))
    batches = sum(-(-(len(t) // cfg.window) // ecfg.batch_size) for t in traces.values())
    lee_batches = -(-(len(traces["lee"]) // cfg.window) // ecfg.batch_size)

    # ---- the fused route
    zero_counts()
    replays = entry.aot.replays
    res = {b: engine.simulate(t) for b, t in traces.items()}
    launches = read_counts()
    replays = entry.aot.replays - replays
    nodes, b4 = b4_counts(entry, launches, replays)
    expected = none | {"fused_features": batches, "flash_attention": cfg.n_layers * batches}
    if not (launches == expected and nodes == cfg.n_layers and replays == batches
            and set(b4.values()) == {cfg.n_layers * batches} and engine.num_compiles == 1):
        failures.append(f"paper: fused launches {launches}, expected {expected}; attention nodes "
                        f"{nodes}, replays {replays} for {batches} batches, counts {b4}, captures "
                        f"{engine.num_compiles}")
    finite = all(np.isfinite([r.cpi, r.total_cycles, r.branch_mpki, r.l1d_mpki]).all()
                 and all(np.isfinite(c).all() and c.shape == (32,) for c in (r.cpi_phase, r.l1d_phase))
                 for r in res.values())
    if not finite:
        failures.append("paper: non-finite or misshapen metrics on the fused route")
    total_n = sum(r.num_instructions for r in res.values())
    total_s = sum(r.seconds for r in res.values())
    prof = profile_breakdown(lambda: engine.simulate(traces["lee"]),
                             groups={"fp32_gemm": ("gemm", "gemv"), "b4": ("attention_kernel",),
                                     "b1": ("fx_",)})
    fused = {"mips": total_n / 1e6 / total_s, "host_ms_per_batch": total_s * 1e3 / batches,
             "device_ms_per_batch": prof["device_busy_s"] * 1e3 / lee_batches,
             "idle_share": prof["idle_share"],
             "device_ms_per_batch_split": {k: ms / lee_batches for k, ms in prof["group_ms"].items()}}
    emit({"phase": "paper", "route": "fused", "traces": list(SLICE_BENCHMARKS), "instructions": total_n,
          "simulate_seconds": total_s, "batches": batches, "launches": launches, "replays": replays,
          "attention_nodes_per_graph": nodes, "flash_attention_counts": b4, **fused,
          "per_trace": {b: {"mips": r.mips, "seconds": r.seconds, "cpi": r.cpi} for b, r in res.items()},
          "top_device_ms": prof["top_device_ms"], "ok": finite})
    results["flash_attention"]["paper_width"]["launches"] = launches["flash_attention"]

    # ---- the staged route: one whole-trace extraction per trace
    zero_counts()
    staged = {}
    for b, t in traces.items():
        t0 = time.perf_counter()
        arrays = extract(t)
        ext_s = time.perf_counter() - t0
        staged[b] = (ext_s, engine.simulate(t, features=arrays))
        del arrays
    s_launches = read_counts()
    expected = none | {"flash_attention": cfg.n_layers * batches, "branch_history": len(traces),
                       "memdist_delta": len(traces)}
    if s_launches != expected:
        failures.append(f"paper: staged launches {s_launches}, expected {expected}")
    vs_fused = {}
    for b, (_, r) in staged.items():
        vs_fused[b] = "exact" if same_metrics(r, res[b]) else None
        if vs_fused[b] is None:
            ecfg_c = dataclasses.replace(ecfg, collect=True)
            eng_c = StreamingEngine(model, cfg, ecfg_c, device="cuda")
            check = flip_check(eng_c.simulate(traces[b], features=extract(traces[b])),
                               eng_c.simulate(traces[b]), traces[b], cfg)
            vs_fused[b] = "flip_explained" if check["ok"] else "neither"
    if "neither" in vs_fused.values():
        failures.append(f"paper: staged and fused routes disagree beyond the flips: {vs_fused}")
    ext_total = sum(e for e, _ in staged.values())
    sim_total = sum(r.seconds for _, r in staged.values())
    emit({"phase": "paper", "route": "staged", "instructions": total_n, "launches": s_launches,
          "extraction_seconds": ext_total, "simulate_seconds": sim_total,
          "mips": total_n / 1e6 / (ext_total + sim_total), "simulate_only_mips": total_n / 1e6 / sim_total,
          "host_ms_per_batch": sim_total * 1e3 / batches, "vs_fused": vs_fused})

    # ---- int8: qdense at every layer shape, the int8 step's capture, the
    # fused route, then int8 beside fp32 in turns (fp32, int8, int8, fp32)
    engine8 = StreamingEngine(model, cfg, dataclasses.replace(ecfg, precision="int8"), device="cuda")
    qshapes = dense_shapes(engine8._run_params())
    check_qdense_on_card(failures, qshapes, phase="paper")
    qdense_calls = len(dense_layers(engine8._run_params()))
    entry8, capture8_s = capture(engine8)
    names8 = graph_kernel_names(entry8.aot.graph)
    gemm8 = [k for k in names8 if any(p in k for p in INT8_GEMM_PIECES)]
    float_gemm8 = [k for k in names8 if any(p in k for p in FLOAT_GEMM_PIECES)]
    engine8.simulate(traces["lee"])  # warm-up
    zero_counts()
    replays = entry8.aot.replays
    res8 = {b: engine8.simulate(t) for b, t in traces.items()}
    launches8 = read_counts()
    replays = entry8.aot.replays - replays
    nodes8, b4_8 = b4_counts(entry8, launches8, replays)
    expected = none | {"fused_features": batches, "flash_attention": cfg.n_layers * batches}
    ok8 = (launches8 == expected and nodes8 == cfg.n_layers
           and set(b4_8.values()) == {cfg.n_layers * batches} and len(gemm8) == qdense_calls
           and not float_gemm8 and all(np.isfinite([r.cpi, r.branch_mpki, r.l1d_mpki]).all()
                                      for r in res8.values()))
    if not ok8:
        failures.append(f"paper int8: launches {launches8}, expected {expected}; attention nodes "
                        f"{nodes8}, counts {b4_8}; {len(gemm8)} IMMA nodes for {qdense_calls} "
                        f"projections, float GEMMs {float_gemm8[:3]}")
    secs = {p: {b: [] for b in traces} for p in ("fp32", "int8")}
    for b, t in traces.items():
        for prec in ("fp32", "int8", "int8", "fp32"):
            secs[prec][b].append((engine if prec == "fp32" else engine8).simulate(t).seconds)
    side = {}
    for prec, eng in (("fp32", engine), ("int8", engine8)):
        p8 = profile_breakdown(lambda eng=eng: eng.simulate(traces["lee"]), track=INT8_GEMM_PIECES)
        s = sum(float(np.median(v)) for v in secs[prec].values())
        side[prec] = {"mips": total_n / 1e6 / s, "host_ms_per_batch": s * 1e3 / batches,
                      "device_ms_per_batch": p8["device_busy_s"] * 1e3 / lee_batches,
                      "idle_share": p8["idle_share"],
                      "int8_gemm_ms_per_batch": int8_gemm_ms(p8["tracked_ms"]) / lee_batches}
    emit({"phase": "paper", "route": "fused", "precision": "int8", "capture_seconds": capture8_s,
          "retained_bytes_est": entry8.est_bytes, "fp32_retained_bytes_est": entry.est_bytes,
          "kernels_per_replay": {"int8": len(names8), "fp32": len(graph_kernel_names(entry.aot.graph))},
          "int8_gemm_nodes": len(gemm8), "qdense_calls": qdense_calls, "launches": launches8,
          "flash_attention_counts": b4_8, "int8_vs_fp32_in_turns": side,
          "metric_diffs": {b: {"cpi_rel": (r.cpi - res[b].cpi) / res[b].cpi,
                               "branch_mpki_abs": r.branch_mpki - res[b].branch_mpki,
                               "l1d_mpki_abs": r.l1d_mpki - res[b].l1d_mpki} for b, r in res8.items()},
          "ok": ok8})

    # ---- the same engine on the CPU (plain versions) on a prefix of one
    # trace, same weights: the slice phase's flip contract
    name = SLICE_BENCHMARKS[0]
    short = traces[name][:PAPER_CPU_INSTRUCTIONS]
    ecfg_c = dataclasses.replace(ecfg, collect=True)
    gpu = StreamingEngine(model, cfg, ecfg_c, device="cuda").simulate(short)
    cpu_model = init_tao(cfg, torch.Generator().manual_seed(0), device="cpu")
    t0 = time.perf_counter()
    cpu = StreamingEngine(cpu_model, cfg, ecfg_c, device="cpu").simulate(short)
    cpu_s = time.perf_counter() - t0
    check = flip_check(gpu, cpu, short, cfg)
    if not check["ok"]:
        failures.append(f"paper: GPU and CPU engines disagree beyond tolerance on {name}")
    emit({"phase": "paper", "check": "gpu_vs_cpu", "trace": name, "positions": gpu.num_instructions,
          **check, "cpu_seconds": cpu_s})

    arrays = {b: extract(t) for b, t in traces.items()}
    graph_vs_eager(failures, engine, traces, arrays, total_n, batches, lee_batches, phase="paper")


def paper_train(failures, results, cfg):
    """The train cell's recipe at the paper's width: the train phase's
    traces and labels, windowed for the paper's config, the recipe's graph captured ahead of data, train_tao_impl for TRAIN_EPOCHS
    at batch 16 (n_layers attention and backward launches a step, by the
    counters and by the graph's nodes x replays), then the graphed run
    against the eager step in turns (bitwise; host ms a step, windows/s)
    and each one's device ms a step and idle share from a profile."""
    import numpy as np
    import torch

    from repro_torch.core import train_tao_impl, warmup_train_step
    from repro_torch.core.transfer import _EagerRun, _GraphRun, _make_step, _new_state
    from repro_torch.train import AdamWConfig
    from repro_torch.uarch import UARCH_A

    ds, _ = labelled_windows(TRAIN_TRACES, UARCH_A, cfg)
    t0 = time.perf_counter()
    entry = warmup_train_step(cfg, batch_size=TRAIN_BATCH, lr=TRAIN_LR)
    torch.cuda.synchronize()
    capture = {"seconds": time.perf_counter() - t0, "compiles": entry.compiles,
               "est_bytes": entry.est_bytes, "graphs": graph_nodes(entry)}
    g0 = capture["graphs"][0]
    cap_ok = (entry.compiles == 1 and g0["attention_nodes"] == cfg.n_layers
              and g0["bwd_dkdv_dq_nodes"] == cfg.n_layers and g0["bwd_delta_nodes"] == cfg.n_layers)
    emit({"phase": "paper", "check": "train_capture", **capture, "ok": cap_ok})
    if not cap_ok:
        failures.append(f"paper: train capture {capture}")

    entry = _make_step(cfg, AdamWConfig(lr=TRAIN_LR), "all")
    replays0 = sum(g.replays for g in entry.aot.values())
    zero_counts()
    res = train_tao_impl(cfg, ds, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=0,
                         device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    replays = sum(g.replays for g in entry.aot.values()) - replays0
    expected = {k: 0 for k in launches} | {"flash_attention": cfg.n_layers * res.steps,
                                           "flash_attention_bwd": cfg.n_layers * res.steps}
    by_nodes = {"flash_attention": g0["attention_nodes"] * replays,
                "flash_attention_bwd": g0["bwd_dkdv_dq_nodes"] * replays}
    finite = all(math.isfinite(x) for x in res.losses) and len(res.losses) == TRAIN_EPOCHS
    if launches != expected or replays != res.steps or any(by_nodes[k] != expected[k] for k in by_nodes) \
            or not finite:
        failures.append(f"paper: train launches {launches}, expected {expected}; replays {replays}; "
                        f"from nodes {by_nodes}; losses {res.losses}")
    results["flash_attention_bwd"]["paper_width"]["launches"] = launches["flash_attention_bwd"]

    turns = {}
    for i, graphed in enumerate((True, False, False, True)):
        turns[f"{i}_{'graphed' if graphed else 'eager'}"] = train_run(cfg, ds, graphed, TRAIN_EPOCHS)
    ref = turns["1_eager"]
    held = {k: {"losses": t["losses"] == ref["losses"], "params": state_bitwise(t["model"], ref["model"]),
                "adamw": state_bitwise(t["opt"], ref["opt"])} for k, t in turns.items()}
    held_ok = all(all(v.values()) for v in held.values()) and ref["losses"] == res.losses
    if not held_ok:
        failures.append(f"paper: the graphed train run differs from the eager step: {held}")
    batches = list(ds.batches(TRAIN_BATCH, rng=np.random.default_rng(0)))[:10]
    profs = {}
    for name, run_cls in (("graphed", _GraphRun), ("eager", _EagerRun)):
        model, opt = _new_state(cfg, None, False, 0, torch.device("cuda"))
        profs[name] = step_profile(run_cls(entry, model, opt), batches)
    emit({"phase": "paper", "check": "train", "epochs": TRAIN_EPOCHS, "batch": TRAIN_BATCH,
          "windows": len(ds), "steps": res.steps, "losses": res.losses, "seconds": res.seconds,
          "ms_per_step_host": res.seconds / res.steps * 1e3,
          "windows_per_s": res.steps * TRAIN_BATCH / res.seconds, "launches": launches,
          "launches_from_graph_nodes": by_nodes, "turns": list(turns), "held": held,
          "turn_ms_per_step_host": {k: t["seconds"] / t["steps"] * 1e3 for k, t in turns.items()},
          "turn_windows_per_s": {k: t["steps"] * TRAIN_BATCH / t["seconds"] for k, t in turns.items()},
          "ms_per_step_device": {k: p["ms_per_step_device"] for k, p in profs.items()},
          "idle_share_profiled": {k: p["idle_share"] for k, p in profs.items()},
          "top_device_ms": {k: p["top_device_ms"] for k, p in profs.items()},
          "ok": held_ok and finite})


def paper_session(failures, cfg):
    """The reference's examples/train_tao_e2e.py under FULL=1 through
    ``Session(cfg)`` with the cuts of PAPER_E2E_*: pair selection over 8
    sampled designs, Algorithm 1 joint training (method "tao", the
    state dict checkpointed each epoch), the transfer to UARCH_C (embedding frozen),
    scratch training on UARCH_C, and the simulate of two unseen traces
    beside their ground truth; each phase's seconds, launches and the
    transfer-vs-scratch ratio.  No accuracy claim: the epochs are cut."""
    import numpy as np

    from repro_torch.api import DesignSpace, Session
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.uarch import UARCH_C

    n, epochs = PAPER_E2E_INSTRUCTIONS, PAPER_E2E_EPOCHS
    secs, launches = {}, {}
    root = tempfile.mkdtemp(prefix="chip-smoke-paper-")
    try:
        s = Session(cfg)
        trs, secs["capture"] = timed(lambda: [s.capture(b, n) for b in PAPER_E2E_BENCHES])
        space = DesignSpace.sample(JOINT_DESIGNS, seed=JOINT_DESIGN_SEED)
        (i, j), secs["select_pair"] = timed(
            lambda: space.select_pair(list(PAPER_E2E_BENCHES[:1]), instructions=JOINT_SELECT_INSTRUCTIONS))
        ua, ub = space[i], space[j]
        mgr = CheckpointManager(os.path.join(root, "ckpt"), keep=2)
        zero_counts()
        joint, secs["train_joint"] = timed(lambda: s.train_joint(
            ua, ub, trs, method="tao", epochs=epochs, batch_size=TRAIN_BATCH, lr=JOINT_LR,
            on_epoch=lambda ep, params, steps: mgr.save(params.state_dict(), steps)))
        mgr.close()
        launches["train_joint"] = read_counts()
        small_c, secs["transfer_data"] = timed(
            lambda: s.dataset(UARCH_C, [s.capture(PAPER_E2E_BENCHES[0], n // 3)]))
        zero_counts()
        transfer, secs["transfer"] = timed(lambda: joint.transfer(
            small_c, epochs=max(2, epochs // 2), batch_size=TRAIN_BATCH, lr=JOINT_LR, uarch=UARCH_C))
        launches["transfer"] = read_counts()
        zero_counts()
        scratch, secs["scratch"] = timed(lambda: s.train(
            UARCH_C, trs, epochs=epochs, batch_size=TRAIN_BATCH, lr=JOINT_LR))
        launches["scratch"] = read_counts()
        zero_counts()
        unseen = {}
        t0 = time.perf_counter()
        for bench in PAPER_E2E_UNSEEN:
            tr = s.capture(bench, n // 2)
            truth = s.ground_truth(UARCH_C, tr)
            sim_t, sim_s = transfer.simulate(tr), scratch.simulate(tr)
            unseen[bench] = {"truth_cpi": truth["cpi"], "transfer_cpi": sim_t.cpi,
                             "transfer_err_pct": sim_t.error_vs(truth["cpi"]), "scratch_cpi": sim_s.cpi,
                             "scratch_err_pct": sim_s.error_vs(truth["cpi"]),
                             "finite": bool(np.isfinite([sim_t.cpi, sim_t.branch_mpki, sim_s.cpi,
                                                         sim_s.branch_mpki]).all())}
        secs["simulate"] = time.perf_counter() - t0
        launches["simulate"] = read_counts()
        saved = sorted(os.listdir(os.path.join(root, "ckpt")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    frozen = state_bitwise(transfer.params.embed, joint.embedding)
    losses = [x for pair in joint.losses for x in pair] + transfer.losses + scratch.losses
    per_step = {"train_joint": launches["train_joint"]["flash_attention_bwd"] / joint.steps,
                "transfer": launches["transfer"]["flash_attention_bwd"] / transfer.steps,
                "scratch": launches["scratch"]["flash_attention_bwd"] / scratch.steps}
    ok = (frozen and all(math.isfinite(x) for x in losses) and all(u["finite"] for u in unseen.values())
          and per_step["train_joint"] >= 2 * cfg.n_layers and per_step["transfer"] >= cfg.n_layers
          and per_step["scratch"] >= cfg.n_layers and launches["simulate"]["fused_features"] > 0
          and len(saved) > 0)
    emit({"phase": "paper", "check": "session", "benchmarks": list(PAPER_E2E_BENCHES),
          "instructions_each": n, "epochs": epochs, "selected": [int(i), int(j)],
          "selected_designs": [ua.name, ub.name], "seconds": secs,
          "phases_seconds": sum(secs.values()),
          "steps": {"train_joint": joint.steps, "transfer": transfer.steps, "scratch": scratch.steps},
          "joint_losses": joint.losses, "transfer_losses": transfer.losses,
          "scratch_losses": scratch.losses, "launches": launches, "bwd_launches_per_step": per_step,
          "transfer_vs_scratch_seconds": secs["transfer"] / secs["scratch"],
          "checkpoints_kept": saved, "embed_bitwise_unchanged_by_transfer": frozen,
          "unseen": unseen, "ok": ok})
    if not ok:
        failures.append(f"paper: the session workflow: embed frozen {frozen}, losses {losses}, "
                        f"unseen {unseen}, bwd launches per step {per_step}, checkpoints {saved}")


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a cache (a dict of tensors or of dicts)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def roofline(phase, cfg, kind, batch, seq, n_params, cache_bytes, ms) -> float:
    """Emit the analytic bound of one call at ``cfg`` (the port's
    ``launch/roofline.py``: ``kind`` "prefill" over ``seq`` positions, or
    "decode" of one token over ``seq`` cached ones; bfloat16 tensor-core
    peak and HBM rate) beside its measured ``ms``; returns the bound."""
    from repro_torch.launch.roofline import analytic_flops, analytic_hbm_bytes

    meta = {"batch": batch, "seq": seq, "kind": kind}
    flops = analytic_flops(cfg, meta)
    nbytes = analytic_hbm_bytes(cfg, meta, n_params, cache_bytes)
    t_ops = flops / BF16_TENSOR_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms = max(t_ops, t_bytes)
    emit({"phase": phase, "config": cfg.name, "check": "roofline", "call": kind,
          "layers": cfg.n_layers, "batch": batch, "seq": seq, "analytic_flops": flops,
          "analytic_hbm_bytes": nbytes, "n_params": n_params, "cache_bytes": cache_bytes,
          "bound_ms": b_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "ms": ms, "x_bound": ms / b_ms})
    return b_ms


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
    results.setdefault("ssd", {})["launches"] = p_launches["ssd"]
    step_median = sorted(step_ms)[steps // 2]
    roofline("mamba2", cfg, "prefill", B, S, n_params, tree_bytes(cache), prefill_s * 1e3)
    roofline("mamba2", cfg, "decode", B, S + steps // 2, n_params, tree_bytes(cache), step_median)
    emit({"phase": "mamba2", "config": cfg.name, "dtype": cfg.compute_dtype,
          "params": n_params, "init_seconds": init_s, "batch": B, "prompt_tokens": S,
          "prefill_seconds": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
          "prefill_launches": p_launches, "decode_steps": steps,
          "decode_ms_per_step_median": step_median,
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


def b4_per_prefill(cfg) -> int:
    """B4's launches in one prefill at ``cfg``: one a layer, none under MLA
    or in a hybrid stack (whose prefills run the reference's plain blocked
    attention, a hybrid's over its window)."""
    return 0 if cfg.mla or cfg.family == "hybrid" else cfg.n_layers


def grown_cache(model, pre, batch: int, max_len: int):
    """A prefill's cache ``pre`` copied into ``model.init_cache(batch,
    max_len)``: a KV cache's first positions, or a hybrid cache's ring
    slots and recurrent states."""
    cache = model.init_cache(batch, max_len)
    if "attn" in cache:
        for k, t in pre["attn"].items():
            cache["attn"][k][:, :, : t.shape[2]] = t
        for k, t in pre["rec"].items():
            cache["rec"][k].copy_(t)
    else:
        for k, t in pre.items():
            cache[k][:, :, : t.shape[2]] = t
    return cache


def dense_serve(failures, cfg, gen, phase="dense") -> tuple:
    """One decoder at ``cfg`` (bfloat16, random weights from ``gen``): a
    warm-up prefill and step, then prefill of DENSE_BATCH x DENSE_PROMPT
    tokens (for a ``vlm``, with ``vision_patches`` random patches each,
    from ``gen``) and DENSE_DECODE greedy steps into a cache grown by
    DENSE_DECODE positions, with every kernel's launches read around each
    call (B4 ``b4_per_prefill`` times a prefill, nothing else, and no
    launch in a decode step), tokens/s, ms per step (wall and this
    thread's CPU time), weight and peak bytes, the analytic bound of the
    prefill and of the median step (``roofline``, on lines before the
    reading), and the profiles of one prefill and one step (B4's device ms
    and launches from the profiler; by stage where the model runs the
    port's profiler ranges).  A hybrid model's cache grows to
    min(S + DENSE_DECODE, window) ring slots.  Returns
    the model, the prompts, the patches (None but for a ``vlm``) and the
    reading."""
    import torch

    from repro_torch.models import Model

    B, S, steps = DENSE_BATCH, DENSE_PROMPT, DENSE_DECODE
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    patches = None
    if cfg.family == "vlm":
        patches = torch.randn(B, cfg.vision_patches, cfg.frontend_dim, generator=gen,
                              device="cuda").to(model.cd)
    logits, cache = model.prefill(prompts, patches)  # warm-up: cuBLAS handles, allocator pools
    model.decode_step(cache, logits.argmax(-1), S)
    del logits, cache
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0, c0 = time.perf_counter(), time.thread_time()
    logits, pre = model.prefill(prompts, patches)
    torch.cuda.synchronize()
    prefill_s, prefill_cpu_s = time.perf_counter() - t0, time.thread_time() - c0
    p_launches = read_counts()
    pre_bytes = tree_bytes(pre)
    cache = grown_cache(model, pre, B, S + steps)
    del pre
    finite = bool(torch.isfinite(logits).all())
    tok = logits.argmax(-1)
    step_ms, step_cpu_ms, d_launches = [], [], []
    for i in range(steps):
        zero_counts()
        t0, c0 = time.perf_counter(), time.thread_time()
        logits, cache = model.decode_step(cache, tok, S + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_cpu_ms.append((time.thread_time() - c0) * 1e3)
        d_launches.append(read_counts())
        finite &= bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
    peak = torch.cuda.max_memory_allocated()
    none = {k: 0 for k in p_launches}
    n_b4 = b4_per_prefill(cfg)
    expected_p = none | {"flash_attention": n_b4}
    track = ("attention_kernel",)
    groups = {"b4": track, "gemm": GEMM_PIECES, "copy": ("copy", "Copy")}
    prof_p = profile_breakdown(lambda: model.prefill(prompts, patches), track=track, groups=groups)
    prof_d = profile_breakdown(lambda: model.decode_step(cache, tok, S + steps - 1), track=track,
                               groups=groups)
    prof_launches = [sum(p.get("tracked_count", {}).values()) for p in (prof_p, prof_d)]
    if p_launches != expected_p or prof_launches != [n_b4, 0]:
        failures.append(f"{phase} {cfg.name}: prefill launches {p_launches} (profiler "
                        f"{prof_launches[0]}), expected {expected_p}")
    if any(d != none for d in d_launches) or prof_launches[1]:
        failures.append(f"{phase} {cfg.name}: a decode step launched a kernel: {d_launches}")
    if not finite:
        failures.append(f"{phase} {cfg.name}: non-finite logits")
    step_median = sorted(step_ms)[steps // 2]
    roofline(phase, cfg, "prefill", B, S, n_params, pre_bytes, prefill_s * 1e3)
    roofline(phase, cfg, "decode", B, S + steps // 2, n_params, tree_bytes(cache), step_median)
    reading = {"config": cfg.name, "dtype": cfg.compute_dtype, "layers": cfg.n_layers,
               "params": n_params, "init_seconds": init_s, "batch": B, "prompt_tokens": S,
               **({"patches": list(patches.shape)} if patches is not None else {}),
               "prefill_seconds": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
               "prefill_host_cpu_seconds": prefill_cpu_s,
               "prefill_launches": p_launches, "prefill_b4_launches_profiler": prof_launches[0],
               "decode_steps": steps,
               "decode_ms_per_step_median": step_median,
               "decode_ms_per_step_mean": sum(step_ms) / steps,
               # the thread's CPU clock may tick in 10 ms: a mean over the steps
               "decode_host_cpu_ms_per_step_mean": sum(step_cpu_ms) / steps,
               "decode_tokens_per_s": B * steps / (sum(step_ms) / 1e3),
               "decode_b4_launches": [d["flash_attention"] for d in d_launches],
               "decode_b4_launches_profiler": prof_launches[1],
               "weights_bytes": base, "peak_bytes": peak, "finite_logits": finite}
    emit({"phase": phase, **reading})
    for call, prof in (("prefill", prof_p), ("decode_step", prof_d)):
        emit({"phase": phase, "config": cfg.name, "check": "profile", "call": call, **prof})
    reading["prefill_b4_device_ms"] = sum(prof_p.get("tracked_ms", {}).values())
    reading["idle_share"] = {"prefill": prof_p["idle_share"], "decode_step": prof_d["idle_share"]}
    for call, prof in (("prefill", prof_p), ("decode_step", prof_d)):
        if "device_ms_split" in prof:
            reading[f"{call}_device_ms_split"] = prof["device_ms_split"]
    del cache, logits
    return model, prompts, patches, reading


def dense_handoff_and_cpu(failures, model, prompts, patches=None, phase="dense"):
    """On a float32 copy of ``model``'s weights: the handoff (the last
    logits of prefill(p + t) against prefill(p), then decode_step(t)) at
    the full prompt, and the card's path against the same model on the CPU
    (the plain versions) at DENSE_CPU_LAYERS layers and DENSE_CPU_SEQ
    tokens: prefill logits, every cache leaf and one decode step.  A
    ``vlm``'s ``patches`` go with every prefill."""
    import torch

    from repro_torch.models import Model

    cfg = model.cfg
    S = prompts.shape[1]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    m32 = Model(cfg32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    m32.load_state_dict(model.state_dict())
    tok = torch.randint(0, cfg.vocab, (prompts.shape[0],), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
    full, _ = m32.prefill(torch.cat([prompts, tok[:, None]], dim=1), patches)
    _, cache32 = m32.prefill(prompts, patches)
    dec, _ = m32.decode_step(cache32, tok, S)
    torch.cuda.synchronize()
    handoff = rel_diff(dec, full)
    del cache32
    ok = handoff <= HANDOFF_REL and bool(torch.isfinite(full).all())
    if not ok:
        failures.append(f"{phase} {cfg.name}: prefill/decode handoff {handoff} > {HANDOFF_REL}")
    emit({"phase": phase, "config": cfg.name, "check": "handoff_f32", "prompt_tokens": S,
          "max_abs_diff_rel_to_max_logit": handoff, "limit": HANDOFF_REL, "ok": ok})

    cfg_cut = dataclasses.replace(cfg32, n_layers=DENSE_CPU_LAYERS)
    sd = {k: v for k, v in m32.state_dict().items()
          if not k.startswith("layers.") or int(k.split(".")[1]) < DENSE_CPU_LAYERS}
    del m32
    gpu = Model(cfg_cut, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    gpu.load_state_dict(sd)
    cpu = Model(cfg_cut, device="cpu", generator=torch.Generator().manual_seed(1))
    cpu.load_state_dict({k: v.cpu() for k, v in sd.items()})
    toks = prompts[:2, :DENSE_CPU_SEQ]
    pt = patches[:2] if patches is not None else None
    zero_counts()
    g_logits, g_cache = gpu.prefill(toks, pt)
    g_step, g_cache = gpu.decode_step(g_cache, toks[:, 0], DENSE_CPU_SEQ - 1)
    torch.cuda.synchronize()
    g_launches = read_counts()["flash_attention"]
    t0 = time.perf_counter()
    c_logits, c_cache = cpu.prefill(toks.cpu(), pt.cpu() if pt is not None else None)
    c_step, c_cache = cpu.decode_step(c_cache, toks[:, 0].cpu(), DENSE_CPU_SEQ - 1)
    cpu_s = time.perf_counter() - t0
    diffs = {"prefill_logits": rel_diff(g_logits.cpu(), c_logits),
             "decode_logits": rel_diff(g_step.cpu(), c_step),
             **{f"cache_{k}": rel_diff(g_cache[k].cpu(), c_cache[k]) for k in c_cache}}
    ok = max(diffs.values()) <= GPU_CPU_REL and g_launches == DENSE_CPU_LAYERS
    if not ok:
        failures.append(f"{phase} {cfg.name}: GPU and CPU disagree beyond {GPU_CPU_REL}: "
                        f"{diffs}, {g_launches} B4 launches")
    emit({"phase": phase, "config": cfg.name, "check": "gpu_vs_cpu", "layers": DENSE_CPU_LAYERS,
          "tokens": list(toks.shape), "rel_diffs": diffs, "limit": GPU_CPU_REL,
          "gpu_b4_launches": g_launches, "cpu_seconds": cpu_s, "ok": ok})


def phase_dense(failures, results, traces):
    """The dense family's serving path at full width (module note)."""
    import torch

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    readings = {}
    for name in DENSE_FULL + DENSE_CUT:
        cfg = get_arch(name)
        if name in DENSE_CUT:
            cfg = dataclasses.replace(cfg, n_layers=DENSE_CUT_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model, prompts, _, reading = dense_serve(failures, cfg, gen)
        if name in DENSE_FULL and not failures:
            dense_handoff_and_cpu(failures, model, prompts)
        readings[name] = serve_summary(reading)
        del model, prompts
        torch.cuda.empty_cache()
        if failures:
            break
    results.setdefault("flash_attention", {})["dense"] = readings
    emit({"phase": "dense", "check": "seconds", "seconds": time.perf_counter() - t0})


def serve_summary(reading) -> dict:
    """What the kernels line keeps of a decoder's serving reading."""
    keep = ("layers", "prefill_tokens_per_s", "decode_ms_per_step_median", "peak_bytes",
            "prefill_b4_device_ms")
    return {"launches_per_prefill": reading["prefill_launches"]["flash_attention"],
            "launches_per_decode_step": max(reading["decode_b4_launches"]),
            **{k: reading[k] for k in keep}}


def audio_encode(failures, cfg, gen) -> tuple:
    """The encoder at ``cfg`` (bfloat16, random weights from ``gen``): a
    warm-up encode, then ``Model.encode`` of DENSE_BATCH x DENSE_PROMPT
    random frames (from ``gen``) with every kernel's launches read around
    it (B4 once per layer, bidirectional, nothing else), frames/s, weight
    and peak bytes and its profile (B4's device ms and launches from the
    profiler).  Returns the model, the frames and the reading."""
    import torch

    from repro_torch.models import Model

    B, S = DENSE_BATCH, DENSE_PROMPT
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    frames = torch.randn(B, S, cfg.frontend_dim, generator=gen, device="cuda").to(model.cd)
    model.encode(frames)  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    logits = model.encode(frames)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all())
    track = ("attention_kernel",)
    groups = {"b4": track, "gemm": ("nvjet", "gemm", "gemv"), "copy": ("copy", "Copy")}
    prof = profile_breakdown(lambda: model.encode(frames), track=track, groups=groups)
    prof_launches = sum(prof.get("tracked_count", {}).values())
    expected = {k: 0 for k in launches} | {"flash_attention": cfg.n_layers}
    if launches != expected or prof_launches != cfg.n_layers:
        failures.append(f"vlm_audio {cfg.name}: encode launches {launches} (profiler "
                        f"{prof_launches}), expected {expected}")
    if not finite or tuple(logits.shape) != (B, S, cfg.vocab) or logits.dtype != torch.float32:
        failures.append(f"vlm_audio {cfg.name}: encode gave {logits.dtype} "
                        f"{tuple(logits.shape)}, finite {finite}")
    roofline("vlm_audio", cfg, "prefill", B, S, n_params, 0, encode_s * 1e3)
    reading = {"config": cfg.name, "dtype": cfg.compute_dtype, "layers": cfg.n_layers,
               "params": n_params, "init_seconds": init_s, "batch": B, "frames": S,
               "audio_seconds": B * S * HUBERT_FRAME_S, "encode_seconds": encode_s,
               "frames_per_s": B * S / encode_s, "encode_launches": launches,
               "encode_b4_launches_profiler": prof_launches, "weights_bytes": base,
               "peak_bytes": peak, "logits": list(logits.shape), "finite_logits": finite}
    emit({"phase": "vlm_audio", **reading})
    emit({"phase": "vlm_audio", "config": cfg.name, "check": "profile", "call": "encode", **prof})
    reading["encode_b4_device_ms"] = sum(prof["tracked_ms"].values())
    return model, frames, reading


def audio_cpu(failures, model, frames):
    """The encoder's path on the card (B4) against the same model on the CPU
    (the plain versions), float32, at DENSE_CPU_LAYERS layers and
    DENSE_CPU_SEQ frames: the frame logits."""
    import torch

    from repro_torch.models import Model

    cfg = dataclasses.replace(model.cfg, param_dtype="float32", compute_dtype="float32",
                              n_layers=DENSE_CPU_LAYERS)
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("layers.") or int(k.split(".")[1]) < DENSE_CPU_LAYERS}
    gpu = Model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    gpu.load_state_dict(sd)
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    cpu.load_state_dict({k: v.cpu() for k, v in sd.items()})
    fr = frames[:2, :DENSE_CPU_SEQ].float()
    zero_counts()
    g = gpu.encode(fr)
    torch.cuda.synchronize()
    g_launches = read_counts()["flash_attention"]
    t0 = time.perf_counter()
    c = cpu.encode(fr.cpu())
    cpu_s = time.perf_counter() - t0
    diff = rel_diff(g.cpu(), c)
    ok = diff <= GPU_CPU_REL and g_launches == DENSE_CPU_LAYERS
    if not ok:
        failures.append(f"vlm_audio {cfg.name}: GPU and CPU encodes disagree beyond "
                        f"{GPU_CPU_REL}: {diff}, {g_launches} B4 launches")
    emit({"phase": "vlm_audio", "config": cfg.name, "check": "gpu_vs_cpu",
          "layers": DENSE_CPU_LAYERS, "frames": list(fr.shape),
          "rel_diffs": {"encode_logits": diff},
          "limit": GPU_CPU_REL, "gpu_b4_launches": g_launches, "cpu_seconds": cpu_s, "ok": ok})


def phase_vlm_audio(failures, results, traces):
    """qwen2-vl-2b's serving path and hubert-xlarge's encoder at full width
    and depth (module note)."""
    import torch

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    readings = {}
    cfg = get_arch("qwen2-vl-2b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model, prompts, patches, reading = dense_serve(failures, cfg, gen, phase="vlm_audio")
    if not failures:
        dense_handoff_and_cpu(failures, model, prompts, patches, phase="vlm_audio")
    readings[cfg.name] = serve_summary(reading)
    del model, prompts, patches
    torch.cuda.empty_cache()
    if not failures:
        cfg = get_arch("hubert-xlarge")
        gen = torch.Generator(device="cuda").manual_seed(0)
        model, frames, reading = audio_encode(failures, cfg, gen)
        if not failures:
            audio_cpu(failures, model, frames)
        readings[cfg.name] = {
            "launches_per_encode": reading["encode_launches"]["flash_attention"],
            **{k: reading[k] for k in ("layers", "frames_per_s", "peak_bytes",
                                       "encode_b4_device_ms")}}
        del model, frames
        torch.cuda.empty_cache()
    results.setdefault("flash_attention", {})["vlm_audio"] = readings
    emit({"phase": "vlm_audio", "check": "seconds", "seconds": time.perf_counter() - t0})


def moe_routing(model, fn) -> list:
    """Per MoE layer, in order, its tokens' expert ids (T, k) and the share
    of their slots dropped at the layer's capacity, over one ``fn()``
    (forward hooks on the ``MoE`` modules; the routing and the dispatch
    plan recomputed from each layer's input)."""
    import torch

    from repro_torch.models.moe import capacity, dispatch_meta

    seen = []

    def hook(mod, args, _out):
        xt = args[0].reshape(-1, args[0].shape[-1])
        _, ids, _ = mod.route(xt)
        G, C = capacity(mod.m, xt.shape[0])
        keep = dispatch_meta(ids.view(G, -1, mod.m.top_k), mod.m.num_experts, C)[2]
        seen.append((ids, 1.0 - float(keep.float().mean())))

    moes = [m for m in model.modules() if hasattr(m, "router")]
    handles = [m.register_forward_hook(hook) for m in moes]
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in handles:
            h.remove()
    return seen


def routing_flips(a: list, b: list, n_experts: int) -> int:
    """(token, expert) routing choices that differ between two runs' MoE
    layers (each choice made on one side and not on the other counts once)."""
    import torch

    flips = 0
    for (ia, _), (ib, _) in zip(a, b):
        ia, ib = ia.cpu(), ib.cpu()
        oa = torch.zeros(ia.shape[0], n_experts).scatter_(1, ia, 1.0)
        ob = torch.zeros(ib.shape[0], n_experts).scatter_(1, ib, 1.0)
        flips += int((oa != ob).sum()) // 2
    return flips


def moe_cut_state(sd: dict, cfg, n_layers: int) -> dict:
    """``sd`` for the first ``n_layers`` decoder layers (``dense_layers``
    whole, then the first of ``layers``)."""
    nd = cfg.moe.first_dense_layers
    return {k: v for k, v in sd.items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n_layers - nd}


def moe_serve(failures, cfg) -> tuple:
    """One MoE model at ``cfg`` (bfloat16, random weights from a CUDA
    generator, seed 0) served as the dense cells are (``dense_serve``, whose
    profiles split each call's device ms by stage), then the share of
    routed slots dropped at the published capacity in one more prefill and
    decode step; for MOE_CUT the prefill whole beside in slices
    (``moe_chunked_prefill``).  Returns the weights on the host and the
    reading."""
    import torch

    from repro_torch.models.moe import capacity

    gen = torch.Generator(device="cuda").manual_seed(0)
    model, prompts, _, reading = dense_serve(failures, cfg, gen, phase="moe")
    B, S = prompts.shape
    out = []
    drops = {"prefill": moe_routing(model, lambda: out.append(model.prefill(prompts)[1]))}
    cache = grown_cache(model, out[0], B, S + 1)
    del out
    tok = prompts[:, -1]
    drops["decode_step"] = moe_routing(model, lambda: model.decode_step(cache, tok, S))
    m = cfg.moe
    for call in ("prefill", "decode_step"):
        if f"{call}_device_ms_split" not in reading:
            failures.append(f"moe {cfg.name}: the {call} profile holds no MoE range")
        T = B * (S if call == "prefill" else 1)
        G, C = capacity(m, T)
        shares = [d for _, d in drops[call]]
        emit({"phase": "moe", "config": cfg.name, "check": "routing", "call": call,
              "tokens": T, "groups": G, "capacity": C, "capacity_factor": m.capacity_factor,
              "dropped_slot_share_per_layer": shares,
              "dropped_slot_share_mean": sum(shares) / len(shares)})
        reading[f"{call}_dropped_slot_share"] = sum(shares) / len(shares)
    del cache
    if cfg.name == MOE_CUT:
        reading["chunked_prefill"] = moe_chunked_prefill(failures, model, prompts)
    sd = {k: v.to("cpu") for k, v in model.state_dict().items()}
    del model, prompts
    torch.cuda.empty_cache()
    return sd, reading


def moe_chunked_prefill(failures, model, prompts) -> dict:
    """The cell's prefill whole and in MOE_PREFILL_CHUNKS slices of the
    batch, in turns (whole, sliced, sliced, whole): ms, peak bytes above
    what was allocated before, B4 launches (one a layer a slice), finite
    logits."""
    import torch

    cfg = model.cfg
    runs = []
    for nc in (1, MOE_PREFILL_CHUNKS, MOE_PREFILL_CHUNKS, 1):
        model.cfg = dataclasses.replace(cfg, prefill_chunks=nc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(prompts)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs.append({"prefill_chunks": nc, "ms": ms,
                     "peak_bytes_above_held": torch.cuda.max_memory_allocated() - held,
                     "b4_launches": read_counts()["flash_attention"],
                     "finite": bool(torch.isfinite(logits).all())})
        del logits, cache
    model.cfg = cfg
    ok = all(r["finite"] and r["b4_launches"] == cfg.n_layers * r["prefill_chunks"]
             for r in runs)
    if not ok:
        failures.append(f"moe {cfg.name}: chunked prefill {runs}")
    by = {nc: [r for r in runs if r["prefill_chunks"] == nc] for nc in (1, MOE_PREFILL_CHUNKS)}
    summary = {str(nc): {"ms": [r["ms"] for r in rs],
                         "peak_bytes_above_held": max(r["peak_bytes_above_held"] for r in rs)}
               for nc, rs in by.items()}
    emit({"phase": "moe", "config": cfg.name, "check": "chunked_prefill",
          "prompts": list(prompts.shape), "runs": runs, "by_chunks": summary, "ok": ok})
    return summary


def moe_handoff(failures, cfg, sd):
    """The handoff (the last logits of prefill(p + t) against prefill(p), then
    decode_step(t)) on a float32 copy of the weights at capacity_factor = E,
    where no slot can drop, for 4 prompts of MOE_HANDOFF_PROMPT tokens."""
    import torch

    from repro_torch.models import Model

    m = cfg.moe
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                moe=dataclasses.replace(m, capacity_factor=float(m.num_experts)))
    m32 = Model(cfg32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    m32.load_state_dict(sd)
    g = torch.Generator(device="cuda").manual_seed(2)
    P = MOE_HANDOFF_PROMPT
    toks = torch.randint(0, cfg.vocab, (DENSE_BATCH, P + 1), device="cuda", generator=g)
    full, _ = m32.prefill(toks)
    _, cache = m32.prefill(toks[:, :P])
    dec, _ = m32.decode_step(cache, toks[:, P], P)
    torch.cuda.synchronize()
    handoff = rel_diff(dec, full)
    ok = handoff <= HANDOFF_REL and bool(torch.isfinite(full).all())
    if not ok:
        failures.append(f"moe {cfg.name}: prefill/decode handoff {handoff} > {HANDOFF_REL}")
    emit({"phase": "moe", "config": cfg.name, "check": "handoff_f32_dropless",
          "layers": cfg.n_layers, "prompt_tokens": P, "batch": DENSE_BATCH,
          "capacity_factor": cfg32.moe.capacity_factor,
          "max_abs_diff_rel_to_max_logit": handoff, "limit": HANDOFF_REL, "ok": ok})
    del m32, cache
    torch.cuda.empty_cache()


def moe_gpu_vs_cpu(failures, cfg, sd):
    """The card's path against the same model on the CPU (plain versions),
    float32, the published capacity, MOE_CPU_LAYERS[name] layers, 2 x
    MOE_CPU_SEQ tokens: prefill logits, every cache leaf and one decode
    step, within GPU_CPU_REL, with the (token, expert) routing choices that
    differ between the two sides counted; for MOE_CUT also with the prefill
    in MOE_PREFILL_CHUNKS slices of the batch on both sides."""
    import torch

    from repro_torch.models import Model

    n = MOE_CPU_LAYERS[cfg.name]
    cut = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32", n_layers=n)
    gpu = Model(cut, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    gpu.load_state_dict(moe_cut_state(sd, cfg, n))
    toks = torch.randint(0, cfg.vocab, (2, MOE_CPU_SEQ), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))

    def run(model, tokens, nc):
        model.cfg = dataclasses.replace(cut, prefill_chunks=nc)
        logits, cache = model.prefill(tokens)
        step, cache = model.decode_step(cache, tokens[:, 0], MOE_CPU_SEQ - 1)
        model.cfg = cut
        return {"prefill_logits": logits.cpu(), "decode_logits": step.cpu(),
                **{f"cache_{k}": v.cpu() for k, v in cache.items()}}

    # qwen3-moe also in prefill slices: each routes its own tokens, on
    # both sides alike
    chunks = (1, MOE_PREFILL_CHUNKS) if cfg.name == MOE_CUT else (1,)
    g_out, c_out, g_route, c_route, g_launches = {}, {}, {}, {}, {}
    for nc in chunks:
        zero_counts()
        g_route[nc] = moe_routing(gpu, lambda: g_out.__setitem__(nc, run(gpu, toks, nc)))
        torch.cuda.synchronize()
        g_launches[nc] = read_counts()["flash_attention"]
    cpu = gpu.to("cpu")  # the same weights, moved
    torch.cuda.empty_cache()
    for nc in chunks:
        t0 = time.perf_counter()
        c_route[nc] = moe_routing(cpu, lambda: c_out.__setitem__(nc, run(cpu, toks.cpu(), nc)))
        cpu_s = time.perf_counter() - t0
        diffs = {k: rel_diff(g_out[nc][k], c_out[nc][k]) for k in c_out[nc]}
        flips = routing_flips(g_route[nc], c_route[nc], cfg.moe.num_experts)
        want_b4 = b4_per_prefill(cut) * nc
        ok = max(diffs.values()) <= GPU_CPU_REL and g_launches[nc] == want_b4
        if not ok:
            failures.append(f"moe {cfg.name}: GPU and CPU disagree beyond {GPU_CPU_REL} at "
                            f"prefill_chunks={nc}: {diffs}, {flips} routing choices differ, "
                            f"{g_launches[nc]} B4 launches")
        emit({"phase": "moe", "config": cfg.name, "check": "gpu_vs_cpu", "layers": n,
              "layers_cut_from": cfg.n_layers, "tokens": list(toks.shape), "prefill_chunks": nc,
              "capacity_factor": cfg.moe.capacity_factor, "rel_diffs": diffs,
              "limit": GPU_CPU_REL,
              "routing_choices": sum(int(i.numel()) for i, _ in c_route[nc]),
              "routing_choices_differing": flips,
              "dropped_slot_share_gpu": [d for _, d in g_route[nc]],
              "dropped_slot_share_cpu": [d for _, d in c_route[nc]],
              "gpu_b4_launches": g_launches[nc], "cpu_seconds": cpu_s, "ok": ok})


def phase_moe(failures, results, traces):
    """The moe family's serving path at full width (module note): the two
    models one after the other, each freed before the next."""
    import torch

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    readings = {}
    for name in (MOE_FULL, MOE_CUT):
        cfg = get_arch(name)
        if name == MOE_CUT:
            emit({"phase": "moe", "config": name, "check": "cut", "layers": MOE_CUT_LAYERS,
                  "of_layers": cfg.n_layers, "why": "94 full-width layers hold ~470 GB of "
                  "bfloat16 weights; 4 hold ~22.4 GB on the 80 GB card"})
            cfg = dataclasses.replace(cfg, n_layers=MOE_CUT_LAYERS)
        sd, reading = moe_serve(failures, cfg)
        if not failures:
            moe_handoff(failures, cfg, sd)
        if not failures:
            moe_gpu_vs_cpu(failures, cfg, sd)
        readings[name] = {**serve_summary(reading),
                          **{k: reading.get(k) for k in ("params", "idle_share",
                                                     "prefill_device_ms_split",
                                                     "decode_step_device_ms_split",
                                                     "prefill_dropped_slot_share",
                                                     "decode_step_dropped_slot_share")}}
        del sd
        torch.cuda.empty_cache()
        if failures:
            break
    results.setdefault("flash_attention", {})["moe"] = readings
    emit({"phase": "moe", "check": "seconds", "seconds": time.perf_counter() - t0})


def hybrid_cut_state(sd: dict) -> dict:
    """``sd`` of a hybrid model for its first unit and its first tail layer
    (the stack of HYBRID_CUT_LAYERS = 4 layers ``reduced()`` also builds)."""
    return {k: v for k, v in sd.items()
            if not k.startswith(("layers.", "tail.")) or k.split(".")[1] == "0"}


def hybrid_checks(failures, cfg, sd, prompts):
    """On a float32 copy of the first unit and tail layer of the weights
    ``sd`` (HYBRID_CUT_LAYERS layers, full width): the handoff (the last
    logits of prefill(p + t) against prefill(p), then decode_step(t)) at the
    full prompt, whose decode step at position 2048 overwrites ring slot 0;
    then the card against the same model moved to the CPU (plain versions)
    on 2 x HYBRID_CPU_SEQ tokens: prefill logits, a decode step and every
    cache leaf after it, with B4's launches on the card (none)."""
    import torch

    from repro_torch.models import Model

    cut = dataclasses.replace(cfg, n_layers=HYBRID_CUT_LAYERS, param_dtype="float32",
                              compute_dtype="float32", kv_cache_dtype="float32")
    m32 = Model(cut, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    m32.load_state_dict(hybrid_cut_state(sd))
    B, S = prompts.shape
    tok = torch.randint(0, cfg.vocab, (B,), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
    full, _ = m32.prefill(torch.cat([prompts, tok[:, None]], dim=1))
    _, cache = m32.prefill(prompts)
    slots = cache["attn"]["k"].shape[2]
    dec, _ = m32.decode_step(cache, tok, S)
    torch.cuda.synchronize()
    handoff = rel_diff(dec, full)
    del cache
    ok = handoff <= HANDOFF_REL and bool(torch.isfinite(full).all())
    if not ok:
        failures.append(f"hybrid {cfg.name}: prefill/decode handoff {handoff} > {HANDOFF_REL}")
    emit({"phase": "hybrid", "config": cfg.name, "check": "handoff_f32",
          "layers": cut.n_layers, "batch": B, "prompt_tokens": S, "ring_slots": slots,
          "decode_slot": S % slots, "max_abs_diff_rel_to_max_logit": handoff,
          "limit": HANDOFF_REL, "ok": ok})

    toks = prompts[:2, :HYBRID_CPU_SEQ]

    def run(model, tokens, out):
        logits, cache = model.prefill(tokens)
        step, cache = model.decode_step(cache, tokens[:, 0], HYBRID_CPU_SEQ - 1)
        out.update({"prefill_logits": logits.cpu(), "decode_logits": step.cpu(),
                    **{f"cache_{g}_{k}": v.cpu() for g in cache for k, v in cache[g].items()}})

    zero_counts()
    g_out, c_out = {}, {}
    run(m32, toks, g_out)
    torch.cuda.synchronize()
    g_launches = read_counts()["flash_attention"]
    cpu = m32.to("cpu")  # the same weights, moved
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run(cpu, toks.cpu(), c_out)
    cpu_s = time.perf_counter() - t0
    diffs = {k: rel_diff(g_out[k], c_out[k]) for k in c_out}
    ok = max(diffs.values()) <= GPU_CPU_REL and g_launches == 0
    if not ok:
        failures.append(f"hybrid {cfg.name}: GPU and CPU disagree beyond {GPU_CPU_REL}: {diffs}, "
                        f"{g_launches} B4 launches")
    emit({"phase": "hybrid", "config": cfg.name, "check": "gpu_vs_cpu", "layers": cut.n_layers,
          "tokens": list(toks.shape), "rel_diffs": diffs, "limit": GPU_CPU_REL,
          "gpu_b4_launches": g_launches, "cpu_seconds": cpu_s, "ok": ok})


def phase_hybrid(failures, results, traces):
    """recurrentgemma-9b's serving path at full width and depth (module
    note): served as the dense cells are, then the handoff and the card
    against the CPU on a float32 copy cut to HYBRID_CUT_LAYERS layers."""
    import torch

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    cfg = get_arch("recurrentgemma-9b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model, prompts, _, reading = dense_serve(failures, cfg, gen, phase="hybrid")
    if "prefill_device_ms_split" not in reading:
        failures.append("hybrid: the prefill profile holds no RG-LRU or windowed range")
    sd = {k: v.clone() for k, v in hybrid_cut_state(model.state_dict()).items()}
    del model
    torch.cuda.empty_cache()
    if not failures:
        hybrid_checks(failures, cfg, sd, prompts)
    results.setdefault("flash_attention", {})["hybrid"] = {
        cfg.name: {**serve_summary(reading),
                   **{k: reading.get(k) for k in ("params", "idle_share",
                                                  "prefill_device_ms_split",
                                                  "decode_step_device_ms_split")}}}
    del sd, prompts
    torch.cuda.empty_cache()
    emit({"phase": "hybrid", "check": "seconds", "seconds": time.perf_counter() - t0})


def train_lm_run(flags, track_steps: bool) -> tuple:
    """One run of the launcher's loop (``launch/train.py::run``) with
    ``flags``, its printed lines captured: (its result, the lines, per
    step the wall seconds to the step's end with the card synchronised and
    every kernel's launches, when ``track_steps``)."""
    import torch

    from repro_torch.launch import train as launcher

    per_step = []
    clock = [time.perf_counter()]

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        per_step.append({"step": i, "s": now - clock[0], "launches": read_counts()})
        zero_counts()
        clock[0] = now

    buf = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(buf):
        out = launcher.run(launcher.build_parser().parse_args(flags),
                           on_step=on_step if track_steps else None)
    return out, buf.getvalue().splitlines(), per_step


def train_lm_kernels(cfg) -> tuple:
    """What one train_lm step of ``cfg`` must launch: ({counter: launches}),
    {counter: the name piece of its main kernel in a profile}, the
    profile's kernel name pieces to track and its groups.  Under remat
    "full" or "dots" each layer's forward kernel runs twice a step, in the
    forward and in its recomputation; its backward once."""
    fwd = cfg.n_layers * (1 if cfg.remat == "none" else 2)
    if cfg.family == "ssm":
        from repro_torch.kernels.ssd.kernel import BWD_KERNEL_NAMES

        return ({"ssd": fwd, "ssd_bwd": cfg.n_layers},
                {"ssd": "ssd_kernel", "ssd_bwd": "ssd_bwd_chunk"},
                ("ssd_kernel", *BWD_KERNEL_NAMES),
                {"ssd_fwd": ("ssd_kernel",), "ssd_bwd": ("ssd_bwd_",), "gemm": GEMM_PIECES,
                 "copy": ("copy",)})
    return ({"flash_attention": fwd, "flash_attention_bwd": cfg.n_layers},
            {"flash_attention": "attention_kernel", "flash_attention_bwd": "bwd_dkdv_dq"},
            ("attention_kernel", "bwd_dkdv_dq", "bwd_delta"),
            {"b4_fwd": ("attention_kernel",), "b4_bwd": ("bwd_dkdv_dq", "bwd_delta"),
             "gemm": GEMM_PIECES, "copy": ("copy",)})


def phase_train_lm(failures, results, traces):
    """The LLM trainer at full width and depth (module note), for each of
    TRAIN_LM_CELLS: the launcher's loop, DENSE_BATCH x DENSE_PROMPT tokens a
    step, its steps from seed 0 with a checkpoint every so many; then the
    run resumed from the first checkpoint in a fresh Model, its losses
    against the uninterrupted run's; then the remat check (REMAT_CELLS),
    the microbatch check (MICROBATCH_CELLS) and the profiler's prefix
    (``prefix_probe``)."""
    import gc

    import torch

    from repro_torch.engine import clear_step_cache
    from repro_torch.train import clear_train_step_cache

    t0 = time.perf_counter()
    # the Tao phases' captured steps stay in the process-wide caches, their
    # CUDA graphs holding private memory pools, and the earlier phases'
    # freed blocks stay reserved in pieces; mamba2's step peaks at ~51 GB
    clear_step_cache()
    clear_train_step_cache()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_lm", "check": "memory_at_start",
          "allocated_bytes": torch.cuda.memory_allocated(),
          "reserved_bytes": torch.cuda.memory_reserved()})
    for arch, (n, every) in TRAIN_LM_CELLS.items():
        train_lm_cell(failures, results, arch, n, every)
        if failures:
            return
    for arch, batch in REMAT_CELLS.items():
        train_lm_remat(failures, arch, batch)
        if failures:
            return
    for arch, (batch, nm) in MICROBATCH_CELLS.items():
        train_lm_microbatches(failures, arch, batch, nm)
        if failures:
            return
    # the profiler's loss where this script's process is oldest
    probe = prefix_probe()
    if probe["lost_with_prefix"]:
        failures.append(f"profiler prefix: a session opened by it lost kernel records {probe}")
    emit({"phase": "train_lm", "check": "profiler_prefix", **probe,
          "ok": not probe["lost_with_prefix"]})
    emit({"phase": "train_lm", "check": "seconds", "seconds": time.perf_counter() - t0})


def train_lm_cell(failures, results, arch, n, every):
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import batch_to_device
    from repro_torch.train import TrainConfig, make_train_step

    t0 = time.perf_counter()
    B, S = DENSE_BATCH, DENSE_PROMPT
    cfg = get_arch(arch)
    expected_kernels, main_pieces, track, groups = train_lm_kernels(cfg)
    with tempfile.TemporaryDirectory() as ckpt:
        flags = ["--arch", arch, "--full", "--steps", str(n), "--batch", str(B),
                 "--seq", str(S), "--ckpt-dir", ckpt, "--ckpt-every", str(every),
                 "--seed", "0", "--device", "cuda"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, lines, per_step = train_lm_run(flags, track_steps=True)
        peak = torch.cuda.max_memory_allocated()
        model, state = out["model"], out["state"]
        n_params = sum(p.numel() for p in model.parameters())
        losses = [float(m["loss"]) for m in out["metrics"]]
        logged = {i: losses[i] for i in range(n) if i % 5 == 0 or i == n - 1}
        falling = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
        launches = [p["launches"] for p in per_step]
        expected = {k: 0 for k in launches[0]} | expected_kernels
        # the first step warms cuBLAS and the allocator's pools; the
        # checkpoint at `every` copies the state to the host in its step
        # and writes it from a thread during the next ones
        all_ms = [p["s"] * 1e3 for p in per_step]
        step_ms = sorted(all_ms[1:])
        median = step_ms[len(step_ms) // 2]
        before = sorted(all_ms[1:every - 1])
        median_before = before[len(before) // 2]
        if not falling:
            failures.append(f"train_lm {arch}: losses not finite and falling: {losses}")
        if any(x != expected for x in launches):
            failures.append(f"train_lm {arch}: launches per step {launches}, expected {expected}")
        roofline("train_lm", cfg, "train", B, S, n_params, 0, median)
        # one more step under the profiler: device ms by kernel, the main
        # kernels' launches, idle share
        tcfg = TrainConfig(lr=3e-4, total_steps=n, warmup_steps=max(1, n // 10))
        step_fn = make_train_step(model, tcfg)
        batch = batch_to_device(LMDataPipeline(cfg, B, S, seed=0).make_batch(n), torch.device("cuda"))
        prof = profile_breakdown(lambda: step_fn(state, batch), track=track, groups=groups)
        counts = prof["tracked_count"]
        prof_launches = {k: sum(c for name, c in counts.items() if name.startswith(piece))
                         for k, piece in main_pieces.items()}
        if prof_launches != expected_kernels:
            failures.append(f"train_lm {arch}: the profiled step ran {prof_launches} kernels, "
                            f"expected {expected_kernels}")
        reading = {"config": cfg.name, "dtype": cfg.compute_dtype, "layers": cfg.n_layers,
                   "params": n_params, "batch": B, "seq": S, "remat": cfg.remat,
                   "steps": n, "losses_logged": logged, "losses": losses,
                   "finite_and_falling": falling,
                   "first_step_ms_with_setup": per_step[0]["s"] * 1e3, "step_ms_median": median,
                   "step_ms_range": [step_ms[0], step_ms[-1]], "step_ms": all_ms,
                   "step_ms_median_before_checkpoint": median_before,
                   "tokens_per_s": B * S / (median / 1e3),
                   "launches_per_step": launches[1], "launches_per_step_all_as_expected":
                   all(x == expected for x in launches),
                   "launches_profiler": prof_launches, "peak_bytes": peak,
                   "loop_seconds": out["seconds"], "launcher_lines": lines}
        emit({"phase": "train_lm", **reading})
        emit({"phase": "train_lm", "config": cfg.name, "check": "profile", "call": "train_step",
              **prof})
        summary = {k: reading[k] for k in ("layers", "remat", "step_ms_median", "tokens_per_s",
                                           "peak_bytes", "launches_per_step")}
        # the kernels line's entries: the bfloat16 backward's is its own
        entries = {"ssd": "ssd", "ssd_bwd": "ssd_bwd", "flash_attention": "flash_attention",
                   "flash_attention_bwd": "flash_attention_bwd_bf16"}
        for counter in expected_kernels:
            results.setdefault(entries[counter], {}).setdefault("train_lm", {})[cfg.name] = {
                **summary, "launches": sum(p["launches"][counter] for p in per_step)}
        # a backward's entry counts its launches on the training path
        bwd = results[entries[list(expected_kernels)[1]]]
        bwd["launches"] = sum(r["launches"] for r in bwd["train_lm"].values())
        del model, state, out, step_fn, batch
        torch.cuda.empty_cache()

        # ---- resume: from the checkpoint at `every`, in a fresh Model
        for name in os.listdir(ckpt):
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and int(name[len("step_"):]) > every):
                shutil.rmtree(os.path.join(ckpt, name))
        resumed, r_lines, r_steps = train_lm_run(flags, track_steps=True)
        r_losses = [float(m["loss"]) for m in resumed["metrics"]]
        want = losses[every:]
        bitwise = r_losses == want
        worst = max((abs(a - b) / abs(b) for a, b in zip(r_losses, want)), default=math.inf)
        ok = (resumed["start_step"] == every and len(r_losses) == len(want)
              and worst <= TRAIN_LM_RESUME_REL
              and all(p["launches"] == expected for p in r_steps))
        if not ok:
            failures.append(f"train_lm {arch}: resumed run {r_losses} against {want}")
        emit({"phase": "train_lm", "config": cfg.name, "check": "resume",
              "from_step": resumed["start_step"], "steps": len(r_losses), "losses": r_losses,
              "losses_bitwise": bitwise, "max_rel_diff": worst, "limit": TRAIN_LM_RESUME_REL,
              "launcher_lines": r_lines[:2], "ok": ok})
        del resumed
        torch.cuda.empty_cache()
    emit({"phase": "train_lm", "config": cfg.name, "check": "seconds",
          "seconds": time.perf_counter() - t0})


def train_lm_remat(failures, arch, B):
    """One step of ``arch`` at full width and depth (seed 0), B x
    DENSE_PROMPT tokens, under each of ``models.config.REMAT_MODES`` in
    turn ("none" first) on the same weights and batch: the state built
    (AdamW's moments), one untimed loss and gradient, the peak reset, the
    loss and ``autograd.grad`` (the backward's peak, ms, the host's share
    of them and the kernels' launches), then AdamW's update (the step's
    peak), and the weights put back.  The loss and every gradient under
    "full" and "dots" must be bitwise those under "none"."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import Model
    from repro_torch.models.config import REMAT_MODES
    from repro_torch.train import TrainConfig, init_state
    from repro_torch.train.optim import AdamWConfig, adamw_update

    t0 = time.perf_counter()
    cfg = get_arch(arch)
    model = Model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    batch = batch_to_device(LMDataPipeline(cfg, B, DENSE_PROMPT, seed=0).make_batch(0),
                            torch.device("cuda"))
    tcfg = TrainConfig()
    opt_cfg = AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
                          m_dtype=tcfg.opt_m_dtype)
    # the starting weights and "none"'s results wait on the host, so that
    # every mode runs with the same bytes on the card
    start = {k: v.detach().cpu() for k, v in model.named_parameters()}
    ref = None
    for mode in ("none", *(m for m in REMAT_MODES if m != "none")):
        model.cfg = dataclasses.replace(cfg, remat=mode)
        state = init_state(model, tcfg)
        params = list(state.params.values())
        with torch.enable_grad():  # warms the allocator's pools for this mode
            torch.autograd.grad(model.loss(batch)[0], params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        t1 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = model.loss(batch)
            t2 = time.perf_counter()
            grads = torch.autograd.grad(loss, params)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        bwd_peak = torch.cuda.max_memory_allocated()
        launches = {k: v for k, v in read_counts().items() if v}
        got = (loss.detach().cpu(), [g.cpu() for g in grads])
        adamw_update(state.params, dict(zip(state.params, grads)), state.opt, opt_cfg,
                     lr=torch.tensor(tcfg.lr, device="cuda"))
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated()
        del loss, grads, state, params
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(start[k])
        if ref is None:
            ref = got
        bitwise = torch.equal(got[0], ref[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], ref[1]))
        want = train_lm_kernels(model.cfg)[0]
        ok = bitwise and launches == want
        if not ok:
            failures.append(f"train_lm remat {arch} {mode}: bitwise {bitwise}, launches "
                            f"{launches}, expected {want}")
        emit({"phase": "train_lm", "check": "remat", "config": cfg.name, "remat": mode,
              "batch": B, "seq": DENSE_PROMPT, "layers": cfg.n_layers, "loss": float(got[0]),
              "bitwise_none": bitwise, "launches": launches, "launches_expected": want,
              "loss_plus_grad_ms": ms,
              # the host's time to enqueue the forward and the backward (each
              # call's return, no sync): where their sum nears the wall
              # time, the host paces the card
              "host_forward_ms": (t2 - t1) * 1e3, "host_backward_ms": (t3 - t2) * 1e3,
              "backward_peak_bytes": bwd_peak,
              "step_peak_bytes": step_peak, "allocated_before_bytes": held, "ok": ok})
        if failures:
            break
    del model, batch, start, ref, got
    torch.cuda.empty_cache()
    emit({"phase": "train_lm", "check": "remat_seconds", "config": cfg.name,
          "seconds": time.perf_counter() - t0})


def train_lm_microbatches(failures, arch, B, nm):
    """The trainer's microbatch path at full width and depth under the
    config's remat, in float32 (seed 0): one step of ``make_train_step`` on B x
    DENSE_PROMPT tokens whole (twice: the first warms float32's kernels),
    then one with ``TrainConfig(microbatches=nm)`` from the same weights
    and state.  The gradients each step hands to
    AdamW (read by a wrapper around ``train.trainer.adamw_update``) and its
    loss: the cut step's within MICROBATCH_GRAD_OF_MAX of each gradient's
    largest |value| and MICROBATCH_LOSS_REL of the whole step's; its
    launches nm times the whole step's."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import Model
    from repro_torch.train import TrainConfig, init_state, make_train_step, trainer

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch), param_dtype="float32", compute_dtype="float32")
    model = Model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    batch = batch_to_device(LMDataPipeline(cfg, B, DENSE_PROMPT, seed=0).make_batch(0),
                            torch.device("cuda"))
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    update, seen, runs = trainer.adamw_update, {}, {}

    def reading(params, grads, *args, **kwargs):
        seen["grads"] = {k: g.float() for k, g in grads.items()}
        return update(params, grads, *args, **kwargs)

    trainer.adamw_update = reading
    try:
        for m in (1, 1, nm):
            tcfg = TrainConfig(microbatches=m)
            step = make_train_step(model, tcfg)
            state = init_state(model, tcfg)
            torch.cuda.synchronize()
            zero_counts()
            t1 = time.perf_counter()
            _, metrics = step(state, batch)
            torch.cuda.synchronize()
            runs[m] = {"ms": (time.perf_counter() - t1) * 1e3, "loss": float(metrics["loss"]),
                       "launches": {k: v for k, v in read_counts().items() if v},
                       "grads": seen.pop("grads")}
            del step, state, metrics
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(start[k])
    finally:
        trainer.adamw_update = update
    whole, cut = runs[1], runs[nm]
    tiny = torch.finfo(torch.float32).tiny
    grad_err, worst = max((float((cut["grads"][k] - g).abs().max() / g.abs().max().clamp(min=tiny)), k)
                          for k, g in whole["grads"].items())
    loss_err = abs(cut["loss"] - whole["loss"]) / abs(whole["loss"])
    once = train_lm_kernels(cfg)[0]
    want = {k: nm * v for k, v in once.items()}
    ok = (grad_err <= MICROBATCH_GRAD_OF_MAX and loss_err <= MICROBATCH_LOSS_REL
          and whole["launches"] == once and cut["launches"] == want)
    if not ok:
        failures.append(f"train_lm microbatches {arch}: gradients {grad_err}, loss {loss_err}, "
                        f"launches {whole['launches']} / {cut['launches']}, expected {once} / "
                        f"{want}")
    emit({"phase": "train_lm", "check": "microbatches", "config": cfg.name, "remat": cfg.remat,
          "dtype": cfg.compute_dtype, "batch": B, "seq": DENSE_PROMPT, "layers": cfg.n_layers,
          "microbatches": nm,
          "loss_whole": whole["loss"], "loss_microbatched": cut["loss"],
          "loss_rel_diff": loss_err, "loss_limit": MICROBATCH_LOSS_REL,
          "grad_max_diff_of_max": grad_err, "grad_worst": worst,
          "grad_limit": MICROBATCH_GRAD_OF_MAX,
          "launches_whole": whole["launches"], "launches_microbatched": cut["launches"],
          "launches_expected": want, "step_ms_whole": whole["ms"],
          "step_ms_microbatched": cut["ms"], "ok": ok, "seconds": time.perf_counter() - t0})
    del model, batch, start, runs, whole, cut
    torch.cuda.empty_cache()


def phase_dryrun(failures, results, traces):
    """The one-card dry run (module note): the Tao fused warm path under
    ``analysis.sanitize.sanitized(compile_budget=0)`` with the sync guard
    armed, the guard firing on a planted ``.item()`` and a planted NaN
    caught at a block's exit; B4 bf16 and B5 at S = 32768 against their
    plain versions; then DRYRUN_CELLS through ``launch.dryrun.run_cell``,
    each with every kernel's launches read around it."""
    import gc

    import torch

    from repro_torch.engine import clear_step_cache
    from repro_torch.train import clear_train_step_cache

    t0 = time.perf_counter()
    clear_step_cache()
    clear_train_step_cache()
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_sanitized(failures, traces)
    if failures:
        return
    dryrun_attention_32k(failures, results)
    dryrun_ssd_32k(failures, results)
    if failures:
        return
    for arch, shape in DRYRUN_CELLS:
        dryrun_cell(failures, results, arch, shape)
        if failures:
            return
    emit({"phase": "dryrun", "check": "seconds", "seconds": time.perf_counter() - t0})


def dryrun_sanitized(failures, traces):
    """The default TaoConfig's engine, its geometry captured and each trace
    simulated once, then the three traces again inside
    ``sanitized(compile_budget=0)`` (sync guard armed, NaNs checked):
    nothing raises, nothing is captured or built, the same results, one B1
    launch a batch.  Inside a sanitized block a planted ``.item()`` must
    raise and ``device_get`` must pass; a planted NaN must raise at the
    block's exit."""
    import torch

    from repro_torch.analysis.sanitize import compiles_now, sanitized
    from repro_torch.core.model import TaoConfig, init_tao
    from repro_torch.engine import EngineConfig, StreamingEngine
    from repro_torch.engine.runner import device_get

    cfg = TaoConfig()
    engine = StreamingEngine(init_tao(cfg, torch.Generator().manual_seed(0), device="cuda"), cfg,
                             EngineConfig(metrics=("cpi", "branch_mpki", "l1d_mpki")), device="cuda")
    warm = {b: engine.simulate(t) for b, t in traces.items()}
    compiles = compiles_now()
    zero_counts()
    t1 = time.perf_counter()
    error = None
    try:
        with sanitized(compile_budget=0):
            got = {b: engine.simulate(t) for b, t in traces.items()}
    except (RuntimeError, AssertionError, FloatingPointError) as e:
        error = f"{type(e).__name__}: {e}"
        got = {}
    seconds = time.perf_counter() - t1
    launches = read_counts()
    batches = sum(-(-(len(t) // cfg.window) // engine.ecfg.batch_size) for t in traces.values())
    same = bool(got) and all(same_metrics(got[b], warm[b]) for b in traces)
    planted = {}
    x = torch.arange(4, dtype=torch.float32, device="cuda")
    with sanitized(debug_nans=False):
        try:
            x.sum().item()
            planted["item_raised"] = False
        except RuntimeError as e:
            planted["item_raised"] = "synchroniz" in str(e)
        planted["device_get_passed"] = device_get({"x": x})["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
    try:
        with sanitized():
            torch.log(x - 10.0)
        planted["nan_raised"] = False
    except FloatingPointError as e:
        planted["nan_raised"] = "aten.log" in str(e)
    ok = (error is None and same and compiles_now() == compiles
          and launches["fused_features"] == batches and all(planted.values()))
    if not ok:
        failures.append(f"dryrun sanitized: error {error}, same {same}, launches {launches}, "
                        f"{batches} batches, planted {planted}")
    emit({"phase": "dryrun", "check": "sanitized_warm_fused", "traces": list(traces),
          "error": error, "results_same_as_unsanitized": same,
          "compiles_in_block": compiles_now() - compiles, "launches": launches,
          "batches": batches, "seconds": seconds, "planted": planted, "ok": ok})


def dryrun_attention_32k(failures, results):
    """One layer's B4 bfloat16 call of qwen2-0.5b's prefill_32k cell, (2,
    14, 32768, 64) causal, k / v drawn at 2 heads and repeated 7x, against
    its plain version run one (batch, head) at a time (the whole (S, S)
    float32 score matrix of every head at once would need ~120 GB): every
    element within ATTN_BF16_RTOL |plain| + ATTN_BF16_ATOL_OF_MAX_V max|v|
    and at least DRYRUN_ATTN_MIN_BITWISE of them bitwise; its time beside
    the plain loop's, SDPA's and its bound."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ref import attention_plain

    B, H, S, D, rep = DRYRUN_ATTN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(B, H, S, D, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, H // rep, S, D, generator=g, device="cuda").to(torch.bfloat16)
            .repeat_interleave(rep, dim=1) for _ in range(2))
    a = flash_attention_cuda(q, k, v, causal=True)

    def plain():
        return torch.cat([torch.cat([attention_plain(q[b:b + 1, h:h + 1], k[b:b + 1, h:h + 1],
                                                     v[b:b + 1, h:h + 1], causal=True)
                                     for h in range(H)], dim=1) for b in range(B)])

    ref = plain()
    torch.cuda.synchronize()
    diff = (a.float() - ref.float()).abs()
    limit = ATTN_BF16_RTOL * ref.float().abs() + ATTN_BF16_ATOL_OF_MAX_V * float(v.float().abs().max())
    within = bool(torch.all(diff <= limit))
    share = float((a == ref).float().mean())
    max_err = float(diff.max())
    ok = within and share >= DRYRUN_ATTN_MIN_BITWISE and bool(torch.isfinite(a.float()).all())
    del diff, limit, ref
    ms = graph_ms(lambda: flash_attention_cuda(q, k, v, causal=True), per_graph=2, replays=5)
    plain_ms = cuda_ms(plain, 1, warmup=0)
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), per_graph=2, replays=5)
    visible = B * H * S * (S + 1) // 2
    b_ms, b_by = bound(4 * B * H * S * D * 2, visible * 4 * D, BF16_TENSOR_FLOPS_PER_S)
    r = {"shape": [B, H, S, D], "causal": True, "kv_repeat": rep, "max_abs_err": max_err,
         "bitwise_share": share, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        "x_bound": ms / b_ms, "x_library": ms / lib_ms}
    emit({"phase": "dryrun", "kernel": "flash_attention", "dtype": "bfloat16",
          "rtol": ATTN_BF16_RTOL, "atol_of_max_v": ATTN_BF16_ATOL_OF_MAX_V,
          "min_bitwise_share": DRYRUN_ATTN_MIN_BITWISE, **r, "ok": ok})
    if not ok:
        failures.append(f"dryrun flash_attention bf16 at {[B, H, S, D]}: within {within}, "
                        f"bitwise share {share}")
    results.setdefault("flash_attention", {}).setdefault("dryrun", {})["s32768"] = r
    del q, k, v, a
    torch.cuda.empty_cache()


def dryrun_ssd_32k(failures, results):
    """B5 at mamba2-1.3b's prefill_32k shape (2 x 32768: 128 chunks of 256
    carried in the state), bfloat16, against its plain chunked version
    (y within SSD_TOL, the final state within SSD_STATE_TOL); its time
    beside the plain version's and its bound."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    cfg = get_arch("mamba2-1.3b")
    s, d = cfg.ssm, cfg.d_model
    H, P, G, N, c = s.n_heads(d), s.head_dim, s.n_groups, s.d_state, s.chunk
    B, S = DRYRUN_SSD_BATCH, DRYRUN_SEQ
    inp = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, 7)
    y, state = ssd_scan_cuda(*inp, chunk=c, return_state=True)
    y_ref, state_ref = ssd_chunked_ref(*inp, c, return_state=True)
    torch.cuda.synchronize()
    tol = SSD_TOL["bfloat16"]
    err = float((y.float() - y_ref.float()).abs().max())
    s_err = float((state - state_ref).abs().max())
    ok = (bool(torch.isfinite(y.float()).all())
          and bool(torch.all((y.float() - y_ref.float()).abs() <= tol + tol * y_ref.float().abs()))
          and bool(torch.all((state - state_ref).abs()
                             <= SSD_STATE_TOL + SSD_STATE_TOL * state_ref.abs())))
    del y, state, y_ref, state_ref
    ms = graph_ms(lambda: ssd_scan_cuda(*inp, chunk=c, return_state=True), per_graph=2, replays=5)
    plain_ms = cuda_ms(lambda: ssd_chunked_ref(*inp, c, return_state=True), 1, warmup=0)
    b_ms, b_by = bound(*ssd_work(B, S, H, P, G, N, c), BF16_TENSOR_FLOPS_PER_S)
    r = {"shape": [B, S, H, P, G, N, c], "chunks": S // c, "max_abs_err": max(err, s_err),
         "y_max_abs_err": err, "state_max_abs_err": s_err, "ms": ms, "plain_ms": plain_ms,
         "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "x_bound": ms / b_ms}
    emit({"phase": "dryrun", "kernel": "ssd", "dtype": "bfloat16", "y_tol": tol,
          "state_tol": SSD_STATE_TOL, **r, "ok": ok})
    if not ok:
        failures.append(f"dryrun ssd at {r['shape']}: y error {err}, state error {s_err}")
    results.setdefault("ssd", {}).setdefault("dryrun", {})["s32768"] = r
    del inp
    torch.cuda.empty_cache()


def dryrun_expected(cfg, meta) -> dict:
    """The hand kernels one step of a cell launches (each counter's
    launches; the rest 0): a prefill B4 or B5 once a layer, a train step
    ``train_lm_kernels`` once a microbatch, a decode step none."""
    if meta["kind"] == "decode":
        return {}
    if meta["kind"] == "train":
        return {k: v * meta["microbatches"] for k, v in train_lm_kernels(cfg)[0].items()}
    return {"ssd" if cfg.family == "ssm" else "flash_attention": cfg.n_layers}


def dryrun_cell(failures, results, arch, shape):
    """One cell through ``run_cell`` (DRYRUN_STEPS timed steps) with every
    kernel's counter set to 0 just before and read just after: it must
    fit, run, give finite output and launch per step what
    ``dryrun_expected`` says, in every step it ran (warm-up, timed,
    profiled, counted)."""
    import torch

    from repro_torch.launch.dryrun import lower_cell, run_cell

    _, meta, cfg = lower_cell(arch, shape)
    want = dryrun_expected(cfg, meta)
    zero_counts()
    t0 = time.perf_counter()
    rec = run_cell(arch, shape, steps=DRYRUN_STEPS)
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    steps_run = DRYRUN_STEPS + 3  # warm-up, timed, profiled, counted
    ok = ("skipped" not in rec and rec["finite"]
          and rec["launches_per_step"] == {k: float(v) for k, v in want.items()}
          and counts == {k: v * steps_run for k, v in want.items()})
    keep = ("kind", "batch", "global_batch", "seq", "microbatches", "n_params", "step_ms_median",
            "step_ms_range", "launches_per_step", "finite", "output_shape")
    emit({"phase": "dryrun", "cell": f"{arch}|{shape}", **rec, "launches_expected_per_step": want,
          "launches_all_steps": counts, "seconds": seconds, "ok": ok})
    if not ok:
        failures.append(f"dryrun {arch}|{shape}: skipped {rec.get('skipped')}, finite "
                        f"{rec.get('finite')}, launches {rec.get('launches_per_step')} / {counts}, "
                        f"expected {want} a step")
    entries = {"flash_attention": "flash_attention", "ssd": "ssd",
               "flash_attention_bwd": "flash_attention_bwd_bf16", "ssd_bwd": "ssd_bwd"}
    for counter, n in counts.items():
        results.setdefault(entries[counter], {}).setdefault("dryrun", {})[f"{arch}|{shape}"] = {
            **{k: rec[k] for k in keep}, "launches": n}
    torch.cuda.empty_cache()


PHASES = {"build": phase_build, "kernels": phase_kernels, "slice": phase_slice,
          "sweep": phase_sweep, "train": phase_train, "persist": phase_persist,
          "joint": phase_joint, "session": phase_session, "serve": phase_serve,
          "paper": phase_paper, "mamba2": phase_mamba2, "dense": phase_dense,
          "vlm_audio": phase_vlm_audio, "moe": phase_moe, "hybrid": phase_hybrid,
          "train_lm": phase_train_lm, "dryrun": phase_dryrun}


def main(argv) -> int:
    import torch

    unknown = [a for a in argv if a not in PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; have {list(PHASES)}", file=sys.stderr)
        return 2

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
    names = ["build", *(a for a in argv if a != "build")] if argv else list(PHASES)
    for name in names:
        t1 = time.perf_counter()
        PHASES[name](failures, results, traces)
        emit({"phase": name, "check": "phase_seconds", "seconds": time.perf_counter() - t1})
        if failures:
            break
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if argv:
        print(card_line(), flush=True)
        emit({"ok": True, "phases": names, "device": device})
        return 0
    emit({"kernels": [results[k] for k in
                      ("fused_features", "branch_history", "memdist_delta", "flash_attention",
                       "flash_attention_bwd", "flash_attention_bwd_bf16", "ssd", "ssd_bwd")]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
