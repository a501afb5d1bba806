#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``.  Phases, one JSON line each:

  build    compile every kernel in src/repro_torch/csrc (one nvcc per
           source, all started together) and report the seconds and the
           ptxas register / spill lines;
  kernels  every kernel against its plain PyTorch version on the card, at
           the shapes the main path gives it, timed with CUDA events;
  slice    the port's main path — StreamingEngine.simulate of raw traces
           at the default TaoConfig width on captured benchmark traces —
           with the kernels' launch counts read around that run,
           finite-metric checks, and a comparison with the same engine on
           the CPU (the plain versions) on one trace.

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main path, error, times and bound; the card's name and power limit as
``nvidia-smi`` prints them; and, last, the device line.  Any failed check
exits nonzero before the device line.  Without a CUDA device, or outside a
checkout (no ``src/repro_torch``), it exits nonzero and prints no result.
Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # float32 on the CUDA cores, no tensor cores

SLICE_BENCHMARKS = ("dee", "mcf", "lee")
SLICE_INSTRUCTIONS = 150_000
KERNEL_LAUNCHES = 4        # state-threaded B1 launches checked bitwise
WIDE_ADDR_OFFSET = 1 << 40  # shifts a trace's addresses past the int32 window
ATTN_ATOL = 1e-5           # fp32 online softmax vs full-matrix softmax:
ATTN_RTOL = 1e-5           # only the summation order differs

# GPU vs CPU engine on one trace.  Features are bitwise equal on both; the
# model's float32 logits differ in the last bits (cuBLAS vs CPU BLAS
# summation order), which flips an argmax / threshold decode only where
# two logits nearly tie.  At most 0.1% of positions may flip, and every
# metric difference must be explained by the flips that occurred.
FLIP_FRACTION = 1e-3
PROB_ATOL = 1e-4           # sigmoid(mispred_logit), logits differ ~1e-6


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_breakdown(engine, trace) -> dict:
    """Device time by kernel over one simulate, from torch.profiler (CUPTI):
    busy = summed time of the device's kernel events (one stream: kernels
    do not overlap; the host ops that launched them are not counted again),
    idle share = 1 - busy / wall.  The profiler's own host overhead
    inflates the wall time here; the unprofiled runs report the real MIPS."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.simulate(trace)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    except Exception as e:  # the profiler is optional here: report, go on
        return {"profile": "not measured", "error": repr(e)}
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top],
    }


def phase_build(failures, results):
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


def phase_kernels(failures, results):
    import numpy as np
    import torch

    from repro_torch.core.features import FeatureConfig, extract_features
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ref import attention_plain
    from repro_torch.kernels.features.ops import trace_columns
    from repro_torch.kernels.fused.kernel import COLUMN_KEYS, fused_features_cuda
    from repro_torch.kernels.fused.ops import init_fused_state
    from repro_torch.kernels.fused.ref import fused_features_plain
    from repro_torch.uarch import get_benchmark, run_functional

    dev = torch.device("cuda")

    # ---- B1: fused features, state threaded over KERNEL_LAUNCHES batches,
    # on a benchmark trace and on the same trace with wide addresses
    fcfg = FeatureConfig()
    n = 64 * 129  # one engine batch: 64 windows of 129
    ft = run_functional(get_benchmark("mcf"), KERNEL_LAUNCHES * n)
    wide = ft.copy()
    wide["addr"][wide["is_mem"]] += WIDE_ADDR_OFFSET
    bitwise, max_err = True, 0.0
    names = ("regbits", "flags", "brhist", "memdist")
    for trace in (ft, wide):
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in trace_columns(trace, fcfg).items()}
        spec = extract_features(trace, fcfg, with_labels=False)
        st_k = init_fused_state(fcfg, dev)
        table_k, mq_k = st_k["table"], st_k["mq"]
        table_p, mq_p = table_k.clone(), mq_k.clone()
        for i in range(KERNEL_LAUNCHES):
            sl = {k: cols[k][i * n:(i + 1) * n] for k in COLUMN_KEYS}
            *outs_k, table_k, mq_k = fused_features_cuda(sl, table_k, mq_k)
            *outs_p, table_p, mq_p = fused_features_plain(sl, table_p, mq_p)
            torch.cuda.synchronize()
            for name, a, b in zip(names, outs_k, outs_p):
                ref = getattr(spec, name)[i * n:(i + 1) * n]
                same = torch.equal(a.view(torch.int32), b.view(torch.int32)) and np.array_equal(
                    a.cpu().numpy().view(np.int32), ref.view(np.int32))
                bitwise &= same
                max_err = max(max_err, float((a - b).abs().max()))
            bitwise &= torch.equal(table_k, table_p) and torch.equal(mq_k, mq_p)
    if not bitwise:
        failures.append("fused_features: kernel != plain version / NumPy spec")
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in trace_columns(ft, fcfg).items()}
    sl = {k: cols[k][:n] for k in COLUMN_KEYS}
    t_state = init_fused_state(fcfg, dev)
    ms = graph_ms(lambda: fused_features_cuda(sl, t_state["table"], t_state["mq"]))
    call_ms = cuda_ms(lambda: fused_features_cuda(sl, t_state["table"], t_state["mq"]), 200)
    p_state = init_fused_state(fcfg, dev)
    plain_ms = cuda_ms(lambda: fused_features_plain(sl, p_state["table"], p_state["mq"]), 10)
    col_bytes = n * (5 * 4 + 8 + 4 * 1)
    state_bytes = 2 * (fcfg.n_buckets * fcfg.n_queue * 4 + (fcfg.n_mem + 1) * 8)
    out_bytes = n * (32 + 5 + fcfg.n_queue + fcfg.n_mem) * 4
    n_mem_slots = int((extract_features(ft[:n], fcfg, with_labels=False).memdist != 0).sum())
    # per valid memory-distance slot: one subtraction, two conversions and
    # the ~27 float32 ops of the signed-log
    b_ms, b_by = bound(col_bytes + state_bytes + out_bytes, 30 * n_mem_slots)
    results["fused_features"] = {
        "name": "fused_features", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_features.cu",
        "replaces": "src/repro/kernels/fused/kernel.py:49",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit({"phase": "kernels", "kernel": "fused_features",
          "launches_checked": 2 * KERNEL_LAUNCHES, "wide_address_offset": WIDE_ADDR_OFFSET,
          "positions_per_launch": n, "bitwise_vs_plain_and_numpy_spec": bitwise,
          "max_abs_err": max_err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by})

    # ---- B4: attention at the Tao shape, plus q_offset / segment cases
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
        attn_err, attn_ok = max(attn_err, err), attn_ok and ok
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "max_abs_err": err, "atol": ATTN_ATOL, "rtol": ATTN_RTOL, "ok": ok})
    if not attn_ok:
        failures.append("flash_attention: kernel outside tolerance of the plain version")
    q, k, v, *_ = cases["tao_causal"]
    B, H, S, D = q.shape
    ms = graph_ms(lambda: flash_attention_cuda(q, k, v, causal=True))
    call_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True), 200)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=True), 20)
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    visible = B * H * S * (S + 1) // 2  # causal (query, key) pairs
    b_ms, b_by = bound(4 * B * H * S * D * 4, visible * (2 * D + 2 * D))
    results["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:38",
        "max_abs_err": attn_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    }
    emit({"phase": "kernels", "kernel": "flash_attention", "shape": [B, H, S, D],
          "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": b_ms, "bound_by": b_by})


def phase_slice(failures, results):
    import numpy as np
    import torch

    from repro_torch.core.model import TaoConfig, init_tao
    from repro_torch.engine import EngineConfig, StreamingEngine
    from repro_torch.kernels.attention.kernel import FLASH_ATTENTION
    from repro_torch.kernels.fused.kernel import FUSED_FEATURES
    from repro_torch.uarch import get_benchmark, run_functional

    cfg = TaoConfig()
    metrics = ("cpi", "branch_mpki", "l1d_mpki", "cpi_phase", "l1d_phase")
    ecfg = EngineConfig(metrics=metrics)
    t0 = time.perf_counter()
    traces = {b: run_functional(get_benchmark(b), SLICE_INSTRUCTIONS) for b in SLICE_BENCHMARKS}
    capture_s = time.perf_counter() - t0
    model = init_tao(cfg, torch.Generator().manual_seed(0), device="cuda")
    engine = StreamingEngine(model, cfg, ecfg, device="cuda")
    engine.simulate(traces["lee"])  # warm-up: cuBLAS handles, allocator pools

    FUSED_FEATURES.launches = 0
    FLASH_ATTENTION.launches = 0
    res = {b: engine.simulate(t) for b, t in traces.items()}
    launches = {"fused_features": FUSED_FEATURES.launches,
                "flash_attention": FLASH_ATTENTION.launches}
    batches = sum(-(-(r.num_instructions // cfg.window) // ecfg.batch_size) for r in res.values())
    for b, r in res.items():
        scalars = [r.cpi, r.total_cycles, r.branch_mpki, r.l1d_mpki]
        curves = [r.cpi_phase, r.l1d_phase]
        if not (all(math.isfinite(x) for x in scalars)
                and all(np.isfinite(c).all() and c.shape == (32,) for c in curves)):
            failures.append(f"slice: non-finite or misshapen metrics on {b}")
        emit({"phase": "slice", "trace": b, "num_instructions": r.num_instructions,
              "seconds": r.seconds, "mips": r.mips, "cpi": r.cpi,
              "total_cycles": r.total_cycles, "branch_mpki": r.branch_mpki,
              "l1d_mpki": r.l1d_mpki})
    if launches["fused_features"] != batches or launches["flash_attention"] != cfg.n_layers * batches:
        failures.append(f"slice: launches {launches} for {batches} batches "
                        f"(expected 1 fused and {cfg.n_layers} attention launches per batch)")
    for name, c in launches.items():
        results[name]["launches"] = c
    total_n = sum(r.num_instructions for r in res.values())
    total_s = sum(r.seconds for r in res.values())

    # the same engine on the CPU (plain versions), one trace, same weights
    name = SLICE_BENCHMARKS[0]
    ecfg_c = EngineConfig(metrics=metrics, collect=True)
    gpu = StreamingEngine(model, cfg, ecfg_c, device="cuda").simulate(traces[name])
    cpu_model = init_tao(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu = StreamingEngine(cpu_model, cfg, ecfg_c, device="cpu").simulate(traces[name])
    n = gpu.num_instructions
    flipped = {
        "fetch_lat": gpu.fetch_lat != cpu.fetch_lat,
        "exec_lat": gpu.exec_lat != cpu.exec_lat,
        "dlevel": gpu.dlevel != cpu.dlevel,
        "mispredict": (gpu.mispred_prob > 0.5) != (cpu.mispred_prob > 0.5),
        "l1d_miss": (gpu.dlevel >= 2) != (cpu.dlevel >= 2),
    }
    flips = {k: int(v.sum()) for k, v in flipped.items()}
    prob_err = float(np.abs(gpu.mispred_prob - cpu.mispred_prob).max())
    # every metric difference must be explained by the flipped decodes: a
    # fetch flip moves the cycle sum by at most the top bucket (256), the
    # last exec latency by 256 once, a miss count by one per flip; a phase
    # chunk holds at least its share of instructions / memory ops
    tr = traces[name][:n]
    chunk_of = (np.arange(n) // cfg.window) * 32 // (n // cfg.window)
    min_chunk = np.bincount(chunk_of, minlength=32).min()
    min_mem_chunk = max(1, np.bincount(chunk_of, weights=tr["is_mem"], minlength=32).min())
    diffs = {
        "cpi_abs": abs(gpu.cpi - cpu.cpi),
        "branch_mpki_abs": abs(gpu.branch_mpki - cpu.branch_mpki),
        "l1d_mpki_abs": abs(gpu.l1d_mpki - cpu.l1d_mpki),
        "cpi_phase_max_abs": float(np.abs(gpu.cpi_phase - cpu.cpi_phase).max()),
        "l1d_phase_max_abs": float(np.abs(gpu.l1d_phase - cpu.l1d_phase).max()),
    }
    tols = {
        "cpi_abs": 256.0 * (flips["fetch_lat"] + 1) / n,
        "branch_mpki_abs": 1000.0 * flips["mispredict"] / n,
        "l1d_mpki_abs": 1000.0 * flips["l1d_miss"] / n,
        "cpi_phase_max_abs": 256.0 * flips["fetch_lat"] / min_chunk,
        "l1d_phase_max_abs": flips["l1d_miss"] / min_mem_chunk,
    }
    ok = (
        max(flips.values()) <= FLIP_FRACTION * n
        and prob_err <= PROB_ATOL
        and all(diffs[k] <= tols[k] * (1 + 1e-6) + 1e-9 for k in diffs)
    )
    if not ok:
        failures.append(f"slice: GPU and CPU engines disagree beyond tolerance on {name}")
    emit({"phase": "slice", "check": "gpu_vs_cpu", "trace": name, "positions": n,
          "flips": flips, "mispred_prob_max_abs": prob_err, "diffs": diffs, "tols": tols, "ok": ok,
          "gpu_mips": gpu.mips, "cpu_mips": cpu.mips})
    emit({"phase": "slice", "check": "profile", "trace": "lee", **profile_breakdown(engine, traces["lee"])})
    emit({"phase": "slice", "traces": list(SLICE_BENCHMARKS), "instructions": total_n,
          "capture_seconds": capture_s, "simulate_seconds": total_s,
          "mips": total_n / 1e6 / total_s, "batches": batches, "launches": launches})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    failures, results = [], {}
    for phase in (phase_build, phase_kernels, phase_slice):
        phase(failures, results)
        if failures:
            break
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    emit({"kernels": [results["fused_features"], results["flash_attention"]]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
