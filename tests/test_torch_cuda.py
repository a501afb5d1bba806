"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import).  This file imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The feature kernels — fused (B1) and the staged whole-trace scans (B2
branch history, B3 memory distance writing the signed-log features) — are
held BITWISE to their plain versions and to the NumPy specification
(copies, int64 deltas rounded to float32 through float64, and the
signed-log in individually rounded float32 ops on every side, the eager
torch one included); attention within
atol = rtol = 1e-5 (3xTF32 tensor-core products, float32-level error, and
exp2 of pre-scaled scores in the kernel against float32 einsum and expf in
the full-matrix plain version), its output the (B, H, Sq, Dv) view of a
(B, Sq, H, Dv) tensor, packed q/k/v views taken at their strides.  The staged engine route equals the
fused one on the card.  The SSD scan (B5) is held to its plain chunked
version within atol = rtol = 1e-4 in float32 (summation order and the
chunk's prefix sum differ) and 2e-2 on bfloat16 outputs (one rounding of
nearly equal float32 values), its float32 final state within 1e-4 either
way; one Mamba-2 prefill launches it once per layer, a decode step never.
Its backward (csrc/ssd_bwd.cu) is held to ssd_chunked_bwd_plain at the
same cases, mamba2-1.3b's training microbatch and 16 chunks of two groups
(S = 4096): float32 within 1e-4 of
each gradient's largest |plain|, bfloat16 each element within 2^-7 |plain|
+ 1e-4 of the largest (each side rounds a float32 result once), two calls
bitwise (no atomics); its bfloat16 kernels that multiply hold wgmma
(HGMMA), the float32 ones mma.sync (HMMA); a reduced Mamba-2's
Model.loss backward launches it
once per layer, and its gradients on the card are within 1e-3 of the
CPU's (of each leaf's largest |g|).
B4 with bfloat16 I/O (the wgmma kernel) is held to its plain version on
the same bfloat16 inputs within 2^-7 |plain| + 1e-5 max|v| (both compute
in float32 and round once; the sums' order may put an element one
rounding apart) and in >= 99% of elements bitwise (P kept in float32), its
float32 lse within 2e-5, at the dense prefill shapes
(qwen2-0.5b, stablelm-1.6b, glm4-9b's width), qwen2-vl-2b's prefill and
hubert-xlarge's bidirectional encode at head dim 80, a full non-causal case,
ragged tails at width 128, width 80, Sq != Sk with a q_offset, segments,
rows that see no key and unaligned strides; its SASS holds wgmma (HGMMA)
and no mma.sync (HMMA), and the float32 kernel's HMMA count is as it
was.  Each dense config at full width cut to 2 layers matches the CPU in
float32 (2e-4 of the largest value), and its prefill launches B4 once per
layer, a decode step never; so do qwen2-vl-2b (prefill with patches and a
decode step) and hubert-xlarge (``encode``, bidirectional) at reduced
width.  The moe family: B4 in bfloat16 at qwen3-moe-235b-a22b's prefill
shape (64 query heads over 4 kv heads repeated 16x); each moe config at
full width cut to its first MoE layer matches the CPU in float32 (MoE
routing, dispatch and combine; MLA's plain prefill and absorbed decode),
and in bfloat16 a qwen3-moe prefill launches B4 once per layer, an MLA
(deepseek) prefill and every decode step never.  The memory policies: a
reduced bfloat16 qwen2-0.5b's and a reduced Mamba-2's loss and gradients
under remat "full" and "dots" are bitwise those under "none", with the
forward kernel (B4, B5) launched twice a layer (forward and
recomputation) and its backward once; a prefill in 2 slices of the batch
(prefill_chunks=2, dense and moe) matches the CPU's within 2e-4 of the
largest value.  A profiler session opened by chip_smoke.py's prefix of
spin kernels counts every launch of a known loop.

The engine's graphed step (one CUDA graph per geometry, replayed per
batch) is held to the eager step driven through its cache entry, on every
route and under ``collect=True``: bitwise, except ``cpi_phase``, whose
float32 per-chunk sums go through ``index_add_``'s atomics in an order
that changes from run to run, even between two eager runs; it is held
within ``batch_size * 2^-24`` relative (the batch's window sums added to a
chunk in any order).  One capture serves traces of any length, ``warmup``
captures ahead of time, engines of one shape share an entry with their own
weights, the replays launch attention ``n_layers`` times each (counted from
the graph's own kernel nodes), and a step that cannot be captured raises.

Training: the attention backward (``csrc/attention_bwd.cu``, the port's
own kernel) is held to its plain formulas within atol = rtol = 1e-5 and is
bitwise equal over two calls (no atomics), at the training shapes, the
edges of its 16-row and 64-row tiles, a 1,000-row window and widths and
strides that are not multiples of 4 floats; its kernels do not spill at
the training shape; the forward's output is bitwise
the same with and without its log-sum-exp, which is +inf on a row that
sees no key.  Under autograd ``flash_attention`` launches the forward and,
in backward, the backward kernel; without grad only the forward.
``loss.backward()`` through ``tao_forward`` on the card gives every
parameter a gradient (``qkv`` included) within 1e-4 of its tensor's
largest CPU gradient; the engine's graph holds no backward node; 3 steps
of ``train_tao_impl`` launch 2 forward and 2 backward attention kernels a
step and track the CPU's (losses 1e-4 relative, parameters 2 lr a step);
the fine-tune leaves ``embed`` bitwise unchanged.  The bfloat16 backward
(the LLM trainer's, on wgmma) is held to its plain formulas on the same
bfloat16 inputs within 2^-7 |plain| + 1e-4 max |plain|, >= 99% bitwise,
two calls bitwise, at widths 32 to 128, causal and not, GQA-repeated k / v,
unaligned strides and 4,096 rows (``attention_bwd_bf16_cases.py``); its
SASS holds wgmma and no mma.sync, the float32 instantiations' mma.sync and
no wgmma, and a call launches ``bwd_delta`` and the wgmma kernel
(profiler).

The train steps' CUDA graphs (``train/trainer.py``, one per recipe and
batch geometry): ``train_tao_impl`` on the graph is bitwise the entry's
eager step — losses, parameters, AdamW state, and what ``eval_fn`` and
the manifests read between epochs — for "all" and "headonly"; runs of
other weights through one entry leak nothing into each other;
``warmup_train_step`` captures ahead of time and the run after it
captures nothing; a graph holds ``n_layers`` attention forward and
backward nodes (2 ``n_layers`` for the joint step); the joint step of
each method is bitwise its eager step, and launches each attention
kernel 2 ``n_layers`` times a step.

Persistence: a training run resumed from its first epoch's manifest is
bitwise the uninterrupted run on the card (losses, steps, parameters,
optimizer state) and launches the attention kernels only for the epochs
it runs; card tensors (bfloat16 included) go through the artifact store
and the checkpoint manager to the host bitwise and restore onto a card
template; the legacy simulate loop on the card launches attention
``n_layers`` times per ragged batch and is held to the same loop on the
CPU by the engine's flip contract.

The sweep scheduler (``engine/scheduler.py``) on the card: every job of a
4-model sweep on each route is bitwise its standalone simulate (metrics
without ``cpi_phase``, whose float atomics vary run to run), captures at
most once cold and never warm, and launches B1 once per batch on the
fused route, B2 and B3 once per job on the staged one, and no feature
kernel on the host route.  ``prefetch_to_device`` across a first capture,
inline (as the engine and the trainer take it) and on its producer
thread: the engine's host route and the train step each capture cleanly
(no batch is drawn before the graph exists) and are bitwise the same run
without prefetch, after ``warmup`` / ``warmup_train_step`` too.  A process started after the kernels were
built finds every library in the build cache (``build_cache_counters``:
no miss).

The Session facade (``repro_torch.api``): ``Session.train`` on the card
tracks the same call on the CPU as ``train_tao_impl`` does, and its
model's ``simulate`` (one B1 launch a batch) is held to the same weights
on the CPU by the legacy loop's flip contract; ``Session.warmup`` captures
a geometry and a train recipe ahead of any model, after which the first
``simulate`` and ``train`` capture nothing.

The trace server (``repro_torch.serve``) on the card: a warm server's
results under four tenants are bitwise the same models' direct
``simulate`` (default metrics), with no capture a request caused and one
B1 launch a batch; a dispatch hung past its deadline is abandoned, its
cohabitant and the next request come out bitwise on the fresh thread, and
the woken thread replays nothing (one ``engine.simulate`` and the
attention launches of two runs in all); and while the dispatch thread
captures a new geometry (held inside the capture), the event loop
resolves a model from the store and admits int8 requests — the placement
waits for the device lock, the engines are built on the dispatch thread
after the capture, and every result is bitwise its direct run.

The int8 W8A8 path (``core/quant.py``): quantization on the card is bitwise
the CPU's; ``qdense``'s codes, int32 accumulations (cuBLASLt IMMA through
``torch._int_mm``, zero-padded to its multiples of 8 and past 16 rows) and
float output are bitwise the CPU's at every default-width layer shape and
at 16 rows or fewer: the card's ``addcmul`` is one fused multiply-add, as
the CPU's is.  The int8 step has its own graph, with ``n_layers``
attention nodes, and is held to the eager int8 step as the float32 one
is.

The hybrid family (``recurrentgemma-9b``): the RG-LRU's Hillis–Steele
scan at 2,048 positions within 1e-5 of the CPU's largest |h|, the
windowed ``flash_ref`` at its attention shape (16 heads of 256) within
1e-5 of max|v| in float32 and 2^-7 in bfloat16, the model at full width
cut to one unit and a tail layer against the CPU in float32 (2e-4 of the
largest value), and a bfloat16 prefill past the window and decode steps
on its ring that launch no B4.

The runtime sanitizer (``analysis/sanitize.py``): inside ``sanitized()``
a planted ``.item()`` on a card tensor raises (the sync guard, the card's
sync debug mode "error") while ``engine.runner.device_get`` passes and the
previous mode comes back after the block; a NaN made on the card raises
``FloatingPointError`` at the block's exit; the warm Tao fused route runs
inside ``sanitized(compile_budget=0)`` with no sync, capture or NaN, one
B1 launch a batch, its results those of the unsanitized run.

The paper's model (``configs/tao.py``: 6 layers, width 512, 8 heads of 64)
runs through the same paths: B4 and its backward at (·, 8, 129, 64) on the
packed views; its graphed fused simulate bitwise the eager step and held
to the CPU by the flip contract; its gradients on the card against the
CPU's and its graphed train step bitwise the eager one; ``qdense`` at
every one of its dense layer shapes.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.features import FeatureConfig, extract_features, signed_log  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.core.quant import dense_shapes, qdense_device_vs_cpu, quantize_tao_params  # noqa: E402
from repro_torch.engine import EngineConfig, MetricSpec, StreamingEngine, cache_stats  # noqa: E402
from repro_torch.engine.aot import WARMUP_RUNS, graph_kernel_names  # noqa: E402
from repro_torch.core import build_adjusted_trace, build_windows, multi_metric_loss  # noqa: E402
from repro_torch.core import tao_forward, train_tao_impl, transfer_finetune, warmup_train_step  # noqa: E402
from repro_torch.core.transfer import to_device  # noqa: E402
from repro_torch.kernels._cuda import sass_counts  # noqa: E402
from repro_torch.kernels.attention.kernel import (  # noqa: E402
    BWD_KERNEL_NAMES,
    FLASH_ATTENTION,
    FLASH_ATTENTION_BWD,
    bwd_launch_info,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.attention.kernel import launch_info as attention_launch_info  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.attention.ref import attention_bwd_plain, attention_lse_plain, attention_plain  # noqa: E402
from repro_torch.kernels.features import ops as feature_ops  # noqa: E402
from repro_torch.kernels.features.kernel import (  # noqa: E402
    BRANCH_HISTORY,
    MEMDIST_DELTA,
    branch_history_cuda,
    memdist_delta_cuda,
)
from repro_torch.kernels.features.ops import device_feature_arrays, trace_columns  # noqa: E402
from repro_torch.kernels.features.ref import (  # noqa: E402
    branch_history_plain,
    memdist_feature_plain,
    signed_log_edge_addresses,
)
from repro_torch.kernels.fused.kernel import FUSED_FEATURES, fused_features_cuda  # noqa: E402
from repro_torch.kernels.fused.ops import FusedExtractor, fused_feature_columns, init_fused_state  # noqa: E402
from repro_torch.kernels.fused.ref import fused_features_plain  # noqa: E402
from repro_torch.kernels.ssd.kernel import SSD_SCAN, SSD_SCAN_BWD, ssd_scan_bwd_cuda, ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd.kernel import BWD_KERNEL_NAMES as SSD_BWD_KERNEL_NAMES  # noqa: E402
from repro_torch.kernels.ssd.kernel import bwd_launch_info as ssd_bwd_launch_info  # noqa: E402
from repro_torch.kernels.ssd.kernel import launch_info as ssd_launch_info  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_plain, ssd_chunked_ref, ssd_sequential_ref  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

PAPER = get_arch("tao")  # the paper's TaoConfig
# the Tao configs the model-level tests run at: the default width, the paper's
TAO_CONFIGS = {"default": TaoConfig(), "paper": PAPER}
from repro_torch.models import Model  # noqa: E402
from repro_torch.uarch import UARCH_A, get_benchmark, run_detailed, run_functional  # noqa: E402
from repro_torch.uarch.isa import FUNC_TRACE_DTYPE, Op  # noqa: E402

from attention_bwd_bf16_cases import ATTN_BWD_BF16_CASES  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def random_trace(n, rng, branch_p=0.4, mem_p=0.4, pc_mod=64, addr_hi=1 << 29):
    t = np.zeros(n, dtype=FUNC_TRACE_DTYPE)
    t["pc"] = rng.integers(0, pc_mod, n) * 4
    t["opcode"] = rng.integers(0, len(Op), n)
    t["dst"] = rng.integers(0, 32, n)
    t["src1"] = rng.integers(0, 32, n)
    t["src2"] = rng.integers(0, 32, n)
    t["is_branch"] = rng.random(n) < branch_p
    t["taken"] = t["is_branch"] & (rng.random(n) < 0.5)
    t["is_mem"] = ~t["is_branch"] & (rng.random(n) < mem_p)
    t["is_store"] = t["is_mem"] & (rng.random(n) < 0.4)
    t["addr"] = np.where(t["is_mem"], rng.integers(-addr_hi, addr_hi, n), 0)
    return t


# (n_buckets, n_queue, n_mem), trace, slice lengths threaded through the state
FUSED_CASES = {
    "default_config_benchmark": ((1024, 32, 64), lambda: run_functional(get_benchmark("mcf"), 3 * 8256), (8256,) * 3),
    "collision_heavy": ((4, 32, 64), lambda: random_trace(3000, np.random.default_rng(1), 0.8, 0.15, 8), (1, 1500, 1499)),
    "no_memory_ops": ((64, 8, 16), lambda: random_trace(2000, np.random.default_rng(2), mem_p=0.0), (700, 700, 600)),
    "narrow_queue_deep_memory": ((16, 5, 100), lambda: random_trace(2500, np.random.default_rng(3), 0.2, 0.6), (257, 1000, 1243)),
    "wide_addresses": ((64, 32, 64), lambda: random_trace(3000, np.random.default_rng(4), addr_hi=1 << 62), (1000, 1000, 1000)),
    # past the one-slot-per-lane and shared-memory limits of earlier kernels
    "queue_48_benchmark": ((1024, 48, 64), lambda: run_functional(get_benchmark("mcf"), 3 * 8256), (8256,) * 3),
    "queue_64_benchmark": ((1024, 64, 64), lambda: run_functional(get_benchmark("mcf"), 3 * 8256), (8256,) * 3),
    "buckets_20000": ((20000, 32, 64), lambda: random_trace(3 * 8256, np.random.default_rng(13), pc_mod=40_000), (8256,) * 3),
    "buckets_60000": ((60000, 8, 16), lambda: random_trace(20000, np.random.default_rng(14), pc_mod=120_000), (10000, 10000)),
    "four_batches_one_launch": ((1024, 32, 64), lambda: run_functional(get_benchmark("mcf"), 4 * 8256), (4 * 8256,)),
    "single_position_launches": ((1024, 32, 64), lambda: run_functional(get_benchmark("mcf"), 2000), (1, 1, 1997, 1)),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_kernel_bitwise_equals_plain(dev, case):
    (nb, nq, nm), make, slices = FUSED_CASES[case]
    fcfg = FeatureConfig(nb, nq, nm)
    trace = make()
    spec = extract_features(trace, fcfg, with_labels=False)
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in trace_columns(trace, fcfg).items()}
    st = init_fused_state(fcfg, dev)
    table_k, mq_k = st["table"], st["mq"]
    table_p, mq_p = table_k.clone(), mq_k.clone()
    launches = FUSED_FEATURES.launches
    lo = 0
    for m in slices:
        sl = {k: v[lo : lo + m] for k, v in cols.items()}
        *got, table_k, mq_k = fused_features_cuda(sl, table_k, mq_k)
        *ref, table_p, mq_p = fused_features_plain(sl, table_p, mq_p)
        torch.cuda.synchronize()
        for name, a, b in zip(("regbits", "flags", "brhist", "memdist"), got, ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (case, lo, name)
            np.testing.assert_array_equal(
                a.cpu().numpy().view(np.int32),
                getattr(spec, name)[lo : lo + m].view(np.int32), err_msg=f"{case}@{lo}/{name}")
        assert torch.equal(table_k, table_p) and torch.equal(mq_k, mq_p), (case, lo)
        lo += m
    assert FUSED_FEATURES.launches == launches + len(slices)


def test_fused_kernel_state_is_functional(dev):
    """Two launches from one state give what the CPU path gives from that
    state, and the state on the card is left as it was."""
    fcfg = FeatureConfig(64, 32, 64)
    cols = trace_columns(random_trace(4000, np.random.default_rng(7), 0.5, 0.3, 128), fcfg)
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cols.items()}
    card = {k: v.to(dev) for k, v in host.items()}
    first, second = slice(0, 1500), slice(1500, 4000)
    _, st_c = fused_feature_columns({k: v[first] for k, v in host.items()},
                                    init_fused_state(fcfg, "cpu"), fcfg)
    _, st_k = fused_feature_columns({k: v[first] for k, v in card.items()},
                                    init_fused_state(fcfg, dev), fcfg)
    kept = {k: v.clone() for k, v in st_k.items()}
    ref, ref_state = fused_feature_columns({k: v[second] for k, v in host.items()}, st_c, fcfg)
    launches = FUSED_FEATURES.launches
    for _ in range(2):
        got, got_state = fused_feature_columns({k: v[second] for k, v in card.items()}, st_k, fcfg)
        torch.cuda.synchronize()
        for name in ("regbits", "flags", "brhist", "memdist"):
            assert torch.equal(got[name].cpu().view(torch.int32), ref[name].view(torch.int32)), name
        for k in ref_state:
            assert torch.equal(got_state[k].cpu(), ref_state[k]), k
            assert torch.equal(st_k[k], kept[k]), k
    assert FUSED_FEATURES.launches == launches + 2


def test_engine_takes_deep_branch_queue_on_card(dev):
    """FeatureConfig(n_queue=48), past the old one-slot-per-lane limit: a
    raw trace runs through the fused kernel on the card, one launch per
    batch, and gives exactly what the same engine gives from the NumPy
    specification's features; the card's feature batches equal the CPU
    path's."""
    fcfg = FeatureConfig(64, 48, 16)
    cfg = TaoConfig(window=33, d_model=64, n_heads=2, n_layers=2, d_ff=128, d_cat=32, features=fcfg)
    ecfg = EngineConfig(batch_size=16, collect=True, metrics=("cpi", "branch_mpki", "l1d_mpki", "cpi_phase"))
    trace = run_functional(get_benchmark("lee"), 30000)
    engine = StreamingEngine(init_tao(cfg, torch.Generator().manual_seed(0), device=dev), cfg, ecfg, device=dev)
    launches = FUSED_FEATURES.launches
    fused = engine.simulate(trace)
    assert FUSED_FEATURES.launches == launches + -(-(len(trace) // cfg.window) // ecfg.batch_size)
    host = engine.simulate(trace, features=extract_features(trace, fcfg, with_labels=False))
    for k, v in host.metrics.items():
        np.testing.assert_array_equal(fused.metrics[k], v, err_msg=k)
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        np.testing.assert_array_equal(getattr(fused, k), getattr(host, k), err_msg=k)
    cols = trace_columns(trace, fcfg)
    card = FusedExtractor(cols, fcfg, device=dev)
    cpu = FusedExtractor(cols, fcfg, device="cpu")
    for m in (8256, 8256, 13488):
        got, ref = card.next_batch(m), cpu.next_batch(m)
        for name in ("regbits", "flags", "brhist", "memdist"):
            assert torch.equal(got[name].cpu().view(torch.int32), ref[name].view(torch.int32)), name


# (B, H, Sq, Sk, D, Dv, causal, q_offset, segmented, seed); each case keeps
# its own seed, so a case added later leaves the others' inputs alone
ATTN_CASES = {
    "tao": (64, 4, 129, 129, 32, 32, True, 0, False, 4),
    "noncausal_odd_dims": (2, 3, 70, 70, 20, 40, False, 0, False, 2),
    "wide_heads": (2, 2, 100, 100, 128, 128, True, 0, False, 5),
    "dv96_segments": (2, 2, 65, 65, 64, 96, True, 0, True, 1),
    "decode_q_offset": (3, 2, 9, 140, 32, 32, True, 131, False, 0),
    "rows_past_sk": (2, 2, 40, 129, 32, 48, False, 100, True, 3),
    # many double-buffered 64-key tiles and several query blocks per head
    "long_causal_1024": (2, 2, 1024, 1024, 64, 64, True, 0, False, 6),
    # Sk not a multiple of the 64-key tile, with segments
    "sk200_segments": (2, 2, 200, 200, 32, 32, True, 0, True, 7),
    # one query row decoding at the last position
    "sq1_decode": (3, 2, 1, 140, 32, 32, True, 139, False, 8),
    # the paper's model (configs/tao.py): 8 heads of 64, a batch of 64 windows
    "paper": (64, 8, 129, 129, 64, 64, True, 0, False, 9),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_kernel_matches_plain(dev, case):
    B, H, Sq, Sk, D, Dv, causal, off, segmented, seed = ATTN_CASES[case]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=g).to(dev)
    k = torch.randn(B, H, Sk, D, generator=g).to(dev)
    v = torch.randn(B, H, Sk, Dv, generator=g).to(dev)
    seg = None
    if segmented:
        cuts = torch.sort(torch.randint(1, Sk, (B, 3), generator=g), dim=1).values
        seg = (torch.arange(Sk)[None, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32).to(dev)
    launches = FLASH_ATTENTION.launches
    got = flash_attention_cuda(q, k, v, seg, causal=causal, q_offset=off)
    ref = attention_plain(q, k, v, seg, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    # the (B, H, Sq, Dv) view of a contiguous (B, Sq, H, Dv) output
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("causal", [True, False])
def test_attention_kernel_takes_packed_qkv_views(dev, causal):
    """q, k, v cut from one packed (B, S, 3, H, D) tensor, as the Tao block
    makes them, go in at their strides: no copy, same result."""
    B, S, H, D = 64, 129, 4, 32
    g = torch.Generator().manual_seed(11)
    packed = torch.randn(B, S, 3, H, D, generator=g).to(dev)
    q, k, v = packed.permute(2, 0, 3, 1, 4).unbind(0)
    assert not q.is_contiguous() and q.stride() == (S * 3 * H * D, D, 3 * H * D, 1)
    got = flash_attention_cuda(q, k, v, causal=causal)
    ref = attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert got.stride() == (S * H * D, D, H * D, 1)
    contiguous = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    torch.testing.assert_close(got, contiguous, atol=0, rtol=0)


def test_attention_kernel_takes_unaligned_strides(dev):
    """Widths and strides that are not multiples of 4 floats take the
    kernel's 4-byte copies; the result is the same."""
    g = torch.Generator().manual_seed(12)
    base = torch.randn(2, 3, 77, 2 * 21 + 1, generator=g).to(dev)
    q, k, v = base[..., :21], base[..., 21:42], base[..., 1:22]
    got = flash_attention_cuda(q, k, v, causal=True)
    ref = attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_attention_kernel_refuses_wide_heads(dev):
    q = torch.zeros(1, 1, 4, 129, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q, q, q)


def edge_delta_trace(rng):
    """Memory ops at every other position, at ``signed_log_edge_addresses``
    (deltas of 0, x * 2^k - 1 with x next to sqrt(2), and 2^62)."""
    addr = signed_log_edge_addresses()
    t = random_trace(2 * len(addr), rng, mem_p=0.0)
    t["is_mem"][::2], t["is_branch"][::2], t["taken"][::2], t["addr"][::2] = True, False, False, addr
    return t


def tile_edge_trace(n, alternate, rng):
    """Every position a branch: at pc 0 (bucket 0), or at pcs 0 and 4 in
    turn (buckets 0 and 1)."""
    t = random_trace(n, rng, branch_p=1.0, mem_p=0.0, pc_mod=1)
    if alternate:
        t["pc"] = np.arange(n) % 2 * 4
    return t


# (n_buckets, n_queue, n_mem), trace: the CPU cases of
# test_torch_feature_kernels.py, the default config on a benchmark, and
# shapes past one rank tile and past 32 queue slots
SCAN_CASES = {
    "default_config_mcf": ((1024, 32, 64), lambda: run_functional(get_benchmark("mcf"), 20000)),
    "dee_small_config": ((32, 4, 8), lambda: run_functional(get_benchmark("dee"), 2500)),
    "lee_small_config": ((2, 3, 2), lambda: run_functional(get_benchmark("lee"), 2500)),
    "one_bucket": ((1, 4, 4), lambda: random_trace(4000, np.random.default_rng(3), 0.8, 0.15, 512)),
    "two_buckets": ((2, 8, 4), lambda: random_trace(4000, np.random.default_rng(4), 0.8, 0.15, 512)),
    "three_buckets_long": ((3, 5, 12), lambda: random_trace(9000, np.random.default_rng(5), 0.8, 0.15, 512)),
    "no_branches": ((4, 3, 3), lambda: random_trace(300, np.random.default_rng(6), 0.0, 0.5)),
    "no_memory_ops": ((4, 3, 3), lambda: random_trace(300, np.random.default_rng(7), 0.5, 0.0)),
    "neither": ((4, 3, 3), lambda: random_trace(300, np.random.default_rng(8), 0.0, 0.0)),
    "single": ((4, 3, 3), lambda: random_trace(1, np.random.default_rng(9))),
    "pair": ((4, 3, 3), lambda: random_trace(2, np.random.default_rng(10))),
    "memory_heavy": ((16, 6, 12), lambda: random_trace(2000, np.random.default_rng(11), 0.3, 0.7, addr_hi=1 << 24)),
    "deep_queues_wide_addresses": ((8192, 40, 100), lambda: random_trace(5000, np.random.default_rng(12), addr_hi=1 << 62)),
    # more than 8,192 buckets: shared-memory counters past 48 KB, the most
    # that shared memory takes (49,152), then (60,000) counters in global
    # scratch
    "buckets_20000": ((20000, 32, 64), lambda: random_trace(30000, np.random.default_rng(13), pc_mod=40_000)),
    "buckets_49152": ((49152, 32, 64), lambda: random_trace(30000, np.random.default_rng(16), pc_mod=98_304)),
    "buckets_60000": ((60000, 32, 64), lambda: random_trace(30000, np.random.default_rng(14), pc_mod=120_000)),
    # the signed-log's tight roundings, huge and wrapping deltas, zero deltas
    "edge_deltas": ((16, 4, 8), lambda: edge_delta_trace(np.random.default_rng(15))),
    # all branches, of bucket 0 (every walk step one 32-lane group, one
    # bucket across tiles) or buckets 0 and 1 in turn, around B2's
    # 1,024-position rank tile
    **{f"tile_edge_{'two_buckets' if alt else 'one_bucket'}_{n}":
       ((1024, 32, 64), lambda n=n, alt=alt: tile_edge_trace(n, alt, np.random.default_rng(n)))
       for alt in (False, True) for n in (1023, 1024, 1025, 3 * 1024 + 1)},
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_staged_scan_kernels_bitwise_equal_plain(dev, case):
    (nb, nq, nm), make = SCAN_CASES[case]
    fcfg = FeatureConfig(nb, nq, nm)
    trace = make()
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in trace_columns(trace, fcfg).items()}
    outcome = torch.where(cols["is_branch"], torch.where(cols["taken"], 1.0, -1.0), 0.0).float()
    launches = (BRANCH_HISTORY.launches, MEMDIST_DELTA.launches)
    br = branch_history_cuda(cols["bucket"], outcome, nb, nq)
    md = memdist_delta_cuda(cols["addr"], cols["is_mem"], nm)
    br_p = branch_history_plain(cols["bucket"], outcome, nb, nq)
    md_p = memdist_feature_plain(cols["addr"], cols["is_mem"], nm)
    torch.cuda.synchronize()
    assert (BRANCH_HISTORY.launches, MEMDIST_DELTA.launches) == (launches[0] + 1, launches[1] + 1)
    assert torch.equal(br.view(torch.int32), br_p.view(torch.int32)), case
    assert torch.equal(md.view(torch.int32), md_p.view(torch.int32)), case
    spec = extract_features(trace, fcfg, with_labels=False)
    arrays = device_feature_arrays(trace_columns(trace, fcfg), fcfg, device=dev)
    for name in ("opcode", "regbits", "flags", "brhist", "memdist"):
        got = arrays[name].cpu().numpy()
        ref = getattr(spec, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32), err_msg=f"{case}/{name}")


def test_eager_signed_log_on_card_bitwise_equals_numpy(dev):
    """One PyTorch CUDA op per statement, each rounded: the NumPy bits, over
    edge values and mantissas on both sides of sqrt(2)."""
    rng = np.random.default_rng(0)
    tiny = np.float32(1e-45)  # the smallest denormal
    sqrt2 = np.float32(np.sqrt(2.0))
    # 1 + |d| with a mantissa just below, at and just above sqrt(2)
    x = np.array([np.nextafter(sqrt2, np.float32(0)), sqrt2, np.nextafter(sqrt2, np.float32(2))])
    near = x * np.float32(2.0) ** np.arange(40, dtype=np.float32)[:, None] - np.float32(1)
    d = np.concatenate([
        [0.0, -0.0, 1.0, -1.0, tiny, -tiny, 1e-38, -1e-38, 2.0**62, -(2.0**62), 2.0**24 + 2, 3.4e38],
        near, -near,
        rng.integers(-(2**62), 2**62, 20000).astype(np.float64),
        rng.integers(-4096, 4096, 4000),
    ], axis=None).astype(np.float32)
    got = feature_ops.signed_log(torch.from_numpy(d).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32), signed_log(d).view(np.int32))


def test_staged_engine_route_equals_fused_on_card(dev):
    """One extraction on the card, two engines reusing it: the metrics and
    per-instruction arrays equal the fused route's, with one launch of each
    staged kernel and none of the fused one."""
    fcfg = FeatureConfig(64, 8, 16)
    cfg = TaoConfig(window=33, d_model=64, n_heads=2, n_layers=2, d_ff=128, d_cat=32, features=fcfg)
    ecfg = EngineConfig(batch_size=16, collect=True, metrics=("cpi", "branch_mpki", "l1d_mpki", "cpi_phase"))
    trace = run_functional(get_benchmark("lee"), 30000)
    engine = StreamingEngine(init_tao(cfg, torch.Generator().manual_seed(0), device=dev), cfg, ecfg, device=dev)
    fused = engine.simulate(trace)
    launches = (BRANCH_HISTORY.launches, MEMDIST_DELTA.launches, FUSED_FEATURES.launches)
    arrays = device_feature_arrays(trace_columns(trace, fcfg), fcfg, device=dev)
    staged = [engine.simulate(trace, features=arrays) for _ in range(2)]
    assert (BRANCH_HISTORY.launches, MEMDIST_DELTA.launches, FUSED_FEATURES.launches) == (
        launches[0] + 1, launches[1] + 1, launches[2])
    for got in staged:
        for k, v in fused.metrics.items():
            np.testing.assert_array_equal(got.metrics[k], v, err_msg=k)
        for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
            np.testing.assert_array_equal(getattr(got, k), getattr(fused, k), err_msg=k)
    with pytest.raises(ValueError, match="device"):
        engine.simulate(trace, features={k: v.cpu() for k, v in arrays.items()})


# (B, S, H, P, G, N, chunk): the reduced and full mamba2-1.3b widths, two
# groups, chunks that are not a multiple of the kernel's 64-row tile (200
# neither of 16 nor of 64), odd head and state widths, and widths that are
# multiples of 8 but not of the kernel's 16-column fragments and 64-wide
# tiles
SSD_CASES = {
    "reduced_config": (2, 64, 8, 16, 1, 16, 32),
    "full_width": (2, 512, 64, 64, 1, 128, 256),
    "two_groups": (1, 512, 8, 64, 2, 128, 256),
    "chunk_96": (2, 192, 4, 32, 1, 64, 96),
    "odd_widths": (1, 40, 3, 5, 1, 7, 8),
    "chunk_200": (2, 400, 64, 64, 1, 128, 200),
    "widths_40_72": (1, 256, 8, 40, 1, 72, 64),
    # a microbatch of mamba2-1.3b's training step
    "train_microbatch": (2, 2048, 64, 64, 1, 128, 256),
    # 16 chunks through the parallel state pass, two groups
    "long_s4096_g2": (1, 4096, 64, 64, 2, 128, 256),
}
# each case's own seed: a new case leaves the others' inputs as they were
SSD_SEEDS = {"chunk_96": 0, "full_width": 1, "odd_widths": 2, "reduced_config": 3,
             "two_groups": 4, "chunk_200": 5, "widths_40_72": 6, "train_microbatch": 7,
             "long_s4096_g2": 8}


def ssd_inputs(case, dtype, dev):
    B, S, H, P, G, N, c = SSD_CASES[case]
    rng = np.random.default_rng(SSD_SEEDS[case])
    cast = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, dtype)  # noqa: E731
    xh = cast(rng.standard_normal((B, S, H, P)))
    # the model's regime: softplus(dt) in [1e-3, 0.1] plus noise, A = -(1..H)
    dt = cast(np.log1p(np.exp(rng.uniform(-7, -2, (B, S, H)))))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    Bm = cast(rng.standard_normal((B, S, G, N)) * 0.5)
    Cm = cast(rng.standard_normal((B, S, G, N)) * 0.5)
    return (xh, dt, A, Bm, Cm), c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_kernel_matches_plain(dev, case, dtype):
    (xh, dt, A, Bm, Cm), c = ssd_inputs(case, getattr(torch, dtype), dev)
    launches = SSD_SCAN.launches
    y, state = ssd_scan_cuda(xh, dt, A, Bm, Cm, chunk=c, return_state=True)
    y_only = ssd_scan_cuda(xh, dt, A, Bm, Cm, chunk=c)
    y_ref, state_ref = ssd_chunked_ref(xh, dt, A, Bm, Cm, c, return_state=True)
    torch.cuda.synchronize()
    assert SSD_SCAN.launches == launches + 2
    assert y.dtype == xh.dtype and state.dtype == torch.float32
    assert torch.equal(y, y_only)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_ref, atol=1e-4, rtol=1e-4)
    if dtype == "float32" and xh.shape[1] <= 512:
        torch.testing.assert_close(y, ssd_sequential_ref(xh, dt, A, Bm, Cm), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_launch_info_at_the_prefill_shape(dev, dtype):
    ssm = get_arch("mamba2-1.3b").ssm
    info = ssd_launch_info(ssm.d_state, ssm.chunk, getattr(torch, dtype))
    assert info["spill_bytes_per_thread"] == 0
    assert info["blocks_per_sm"] >= 1
    assert info["threads_per_block"] == 256 and info["regs_per_thread"] > 0


def test_ssd_kernel_refuses_what_it_cannot_hold(dev):
    (xh, dt, A, Bm, Cm), _ = ssd_inputs("reduced_config", torch.float32, dev)
    with pytest.raises(ValueError, match="limits"):
        ssd_scan_cuda(xh, dt, A, Bm, Cm, chunk=512)
    with pytest.raises(ValueError, match="dt must be a contiguous torch.float32"):
        ssd_scan_cuda(xh, dt.to(torch.bfloat16), A, Bm, Cm, chunk=32)


def test_mamba2_prefill_launches_ssd_once_per_layer(dev):
    cfg = get_arch("mamba2-1.3b", reduced=True)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 48), device=dev)
    launches = SSD_SCAN.launches
    logits, cache = model.prefill(toks)
    assert SSD_SCAN.launches == launches + cfg.n_layers
    step, _ = model.decode_step(cache, toks[:, 0], 48)
    torch.cuda.synchronize()
    assert SSD_SCAN.launches == launches + cfg.n_layers
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref, ref_cache = cpu.prefill(toks.cpu())
    torch.testing.assert_close(logits.cpu(), ref, atol=2e-4, rtol=2e-4)
    for k in cache:
        torch.testing.assert_close(cache[k].cpu(), ref_cache[k], atol=2e-4, rtol=2e-4)


SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def assert_ssd_bwd_close(got, want, dtype):
    """float32: each output within 1e-4 of its largest |plain|; bfloat16:
    each element within 2^-7 |plain| + 1e-4 of the largest (the kernel and
    the plain version each round a float32 result once)."""
    for name, a, b in zip(SSD_BWD_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        top = float(b.abs().max())
        if dtype == "float32" or name == "dA":
            assert float((a - b).abs().max()) <= 1e-4 * top, (name, float((a - b).abs().max()), top)
        else:
            assert torch.all((a - b).abs() <= 2.0**-7 * b.abs() + 1e-4 * top), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_bwd_kernel_matches_plain(dev, case, dtype):
    """The backward against ``ssd_chunked_bwd_plain`` on the same inputs,
    and two calls bitwise (no atomics)."""
    inp, c = ssd_inputs(case, getattr(torch, dtype), dev)
    gen = torch.Generator(device=dev).manual_seed(SSD_SEEDS[case])
    dy = torch.randn(inp[0].shape, generator=gen, device=dev).to(inp[0].dtype)
    launches = SSD_SCAN_BWD.launches
    got = ssd_scan_bwd_cuda(*inp, dy, chunk=c)
    again = ssd_scan_bwd_cuda(*inp, dy, chunk=c)
    want = ssd_chunked_bwd_plain(*inp, dy, c)
    torch.cuda.synchronize()
    assert SSD_SCAN_BWD.launches == launches + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert_ssd_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_launch_info(dev, dtype):
    info = ssd_bwd_launch_info(getattr(torch, dtype))
    assert tuple(info) == SSD_BWD_KERNEL_NAMES
    for name, k in info.items():
        assert k["spill_bytes_per_thread"] == 0, name
        assert k["blocks_per_sm"] >= 1 and k["regs_per_thread"] > 0, name
    if dtype == "bfloat16":  # three warpgroups' tiles share an SM
        assert info["ssd_bwd_chunk"]["threads_per_block"] == 128
        assert info["ssd_bwd_chunk"]["blocks_per_sm"] >= 3


def test_ssd_bwd_sass_bf16_on_wgmma_and_float32_on_mma_sync(dev):
    """The kernels that multiply (each chunk's share of the states, the
    chunk kernel) run wgmma (HGMMA) in bfloat16 and mma.sync (HMMA) in
    float32; the others hold neither."""
    sass = sass_counts(SSD_SCAN_BWD.source, "ssd_bwd")
    assert len(sass) == 2 * len(SSD_BWD_KERNEL_NAMES), sorted(sass)
    for name, v in sass.items():
        if "ssd_bwd_local" not in name and "ssd_bwd_chunk" not in name:
            assert v["HMMA"] == v["HGMMA"] == 0, (name, v)
        elif "bfloat16" in name:
            assert v["HGMMA"] > 0 and v["HMMA"] == 0, (name, v)
        else:
            assert v["HMMA"] > 0 and v["HGMMA"] == 0, (name, v)


def test_ssd_bwd_kernel_refuses_what_it_cannot_hold(dev):
    inp, _ = ssd_inputs("reduced_config", torch.float32, dev)
    dy = torch.zeros_like(inp[0])
    with pytest.raises(ValueError, match="limits"):
        ssd_scan_bwd_cuda(*inp, dy, chunk=512)
    with pytest.raises(ValueError, match="dy must be a contiguous torch.float32"):
        ssd_scan_bwd_cuda(*inp, dy.to(torch.bfloat16), chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_bwd_cuda(*inp, dy, chunk=48)


def test_ssd_scan_records_the_kernel_backward(dev):
    """Under autograd, ``ssd_scan`` launches B5's forward and, in backward,
    its backward kernel once: its gradients are the kernel's.  Without
    grad it is the forward launch alone; ``return_state`` under autograd
    raises."""
    inp, c = ssd_inputs("reduced_config", torch.float32, dev)
    dy = torch.randn(inp[0].shape, generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    leaves = [t.clone().requires_grad_() for t in inp]
    counts = (SSD_SCAN.launches, SSD_SCAN_BWD.launches)
    y = ssd_scan(*leaves, chunk=c)
    y.backward(dy)
    assert (SSD_SCAN.launches, SSD_SCAN_BWD.launches) == (counts[0] + 1, counts[1] + 1)
    assert torch.equal(y.detach(), ssd_scan_cuda(*inp, chunk=c))
    for leaf, want in zip(leaves, ssd_scan_bwd_cuda(*inp, dy, chunk=c)):
        assert torch.equal(leaf.grad, want)
    counts = (SSD_SCAN.launches, SSD_SCAN_BWD.launches)
    with torch.no_grad():
        plain = ssd_scan(*leaves, chunk=c)
    assert plain.grad_fn is None
    assert (SSD_SCAN.launches, SSD_SCAN_BWD.launches) == (counts[0] + 1, counts[1])
    with pytest.raises(ValueError, match="return_state"):
        ssd_scan(*leaves, chunk=c, return_state=True)


def mamba2_grads(model, batch):
    named = dict(model.named_parameters())
    loss, _ = model.loss(batch)
    return loss.detach(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def mamba2_batch(cfg, dev, B=2, S=48):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev) for k in ("tokens", "labels")}


def test_mamba2_loss_backward_launches_ssd_bwd_once_per_layer(dev):
    cfg = get_arch("mamba2-1.3b", reduced=True)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    counts = (SSD_SCAN.launches, SSD_SCAN_BWD.launches)
    loss, grads = mamba2_grads(model, mamba2_batch(cfg, dev))
    torch.cuda.synchronize()
    assert (SSD_SCAN.launches, SSD_SCAN_BWD.launches) == (counts[0] + cfg.n_layers, counts[1] + cfg.n_layers)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())


def test_mamba2_gradients_on_card_match_cpu(dev):
    """A reduced mamba2's loss and every gradient leaf on the card within
    1e-3 of the same model's on the CPU (of the leaf's largest |g|): the
    card runs B5 and its backward in split TF32, the CPU the plain chunked
    version under autograd."""
    cfg = get_arch("mamba2-1.3b", reduced=True)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss, grads = mamba2_grads(model, mamba2_batch(cfg, dev))
    ref_loss, ref_grads = mamba2_grads(cpu, mamba2_batch(cfg, "cpu"))
    assert abs(float(loss) - float(ref_loss)) <= 1e-3 * abs(float(ref_loss))
    for name, ref in ref_grads.items():
        err = float((grads[name].cpu() - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()), (name, err, float(ref.abs().max()))


# ---------------------------------------------------------------------------
# The engine's graphed step
# ---------------------------------------------------------------------------

GRAPH_METRICS = ("cpi", "branch_mpki", "l1d_mpki", "dlevel_hist", "cpi_phase", "l1d_phase")
# float32 per-chunk sums accumulated with atomics (see the module note)
ATOMIC_FLOAT_METRICS = ("cpi_phase",)


def graph_engine(dev, seed=0, cfg=None, **kw):
    cfg = cfg or TaoConfig()
    ecfg = EngineConfig(metrics=GRAPH_METRICS, **kw)
    return StreamingEngine(init_tao(cfg, torch.Generator().manual_seed(seed), device=dev), cfg, ecfg,
                           device=dev)


def eager_entry_loop(engine, trace, features=None):
    """The engine's own batches through its cache entry called directly:
    the eager step, on the card."""
    import time

    t0 = time.perf_counter()
    n, count, batches = engine._batches(trace, features)
    entry = engine.step_entry_for(n)
    carry = engine.init_carry(n)
    params = engine._run_params()
    pers = []
    with torch.inference_mode():
        for b in batches:
            carry, per = entry(params, carry, b)
            if engine.ecfg.collect:
                pers.append(per)
        return engine._result(carry, pers, count, t0)


def assert_graph_equals_eager(got, ref, batch_size):
    assert got.num_instructions == ref.num_instructions
    assert got.metrics.keys() == ref.metrics.keys()
    for k, v in ref.metrics.items():
        if k in ATOMIC_FLOAT_METRICS:
            np.testing.assert_allclose(got.metrics[k], v, rtol=batch_size * 2.0**-24, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got.metrics[k], v, err_msg=k)
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        if k in ref.available_metrics:
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)


def route_features(route, trace, fcfg, dev):
    if route == "fused":
        return None
    if route == "staged":
        return device_feature_arrays(trace_columns(trace, fcfg), fcfg, device=dev)
    return extract_features(trace, fcfg, with_labels=False)


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("route", ["fused", "staged", "host"])
def test_graphed_simulate_equals_eager_entry_loop(dev, route, collect):
    engine = graph_engine(dev, collect=collect)
    trace = run_functional(get_benchmark("mcf"), 40000)
    feats = route_features(route, trace, engine.cfg.features, dev)
    got = engine.simulate(trace, features=feats)
    assert engine.step_entry_for(len(trace)).aot is not None
    ref = eager_entry_loop(engine, trace, feats)
    assert_graph_equals_eager(got, ref, engine.ecfg.batch_size)
    if collect:
        assert got.fetch_lat.shape == (got.num_instructions,)


def test_one_capture_across_uneven_trace_lengths(dev):
    engine = graph_engine(dev, batch_size=56)
    base = run_functional(get_benchmark("lee"), 60000)
    before = cache_stats()["compiles"]
    for n in (60000, 12345, 8256, 129 * 64 + 1, 33333):
        got = engine.simulate(base[:n])
        assert_graph_equals_eager(got, eager_entry_loop(engine, base[:n]), 56)
    assert engine.num_compiles == 1
    assert cache_stats()["compiles"] == before + 1
    # a trace shorter than the window is another geometry: one more capture
    engine.simulate(base[:100])
    assert engine.num_compiles == 2


def test_warmup_then_simulate_makes_no_capture(dev):
    engine = graph_engine(dev, batch_size=32)
    trace = run_functional(get_benchmark("dee"), 20000)
    entry = engine.warmup(len(trace))
    assert entry.aot is not None and entry.compiles == 1 and entry.est_bytes > 0
    assert engine.warmup(len(trace)) is entry and entry.compiles == 1
    stats = cache_stats()
    got = engine.simulate(trace)
    assert entry.compiles == 1 and cache_stats()["compiles"] == stats["compiles"]
    assert stats["aot_compiled"] >= 1 and stats["retained_bytes_est"] >= entry.est_bytes
    assert_graph_equals_eager(got, eager_entry_loop(engine, trace), 32)


def test_engines_share_one_entry_with_their_own_weights(dev):
    """Two engines of one shape, different weights, in turns on one shared
    captured entry: each gives its own eager result, and no second capture
    is made."""
    a, b = graph_engine(dev, seed=0, batch_size=48), graph_engine(dev, seed=1, batch_size=48)
    trace = run_functional(get_benchmark("lee"), 30000)
    runs = [(e, e.simulate(trace)) for e in (a, b, a)]
    entry = a.step_entry_for(len(trace))
    assert entry is b.step_entry_for(len(trace)) and entry.compiles == 1
    assert a.num_compiles == b.num_compiles == 1
    for e, got in runs:
        assert_graph_equals_eager(got, eager_entry_loop(e, trace), 48)
    assert runs[0][1].cpi != runs[1][1].cpi


def test_replays_launch_attention_per_layer(dev):
    """The graph holds ``n_layers`` attention kernel nodes, and a simulate
    adds ``n_layers`` launches per batch, one fused-feature launch per
    batch on the fused route and none at capture."""
    engine = graph_engine(dev, batch_size=24)
    trace = run_functional(get_benchmark("mcf"), 20000)
    entry = engine.warmup(len(trace))
    names = graph_kernel_names(entry.aot.graph)
    assert sum("attention_kernel" in k for k in names) == engine.cfg.n_layers
    assert not any("fx_" in k for k in names)
    assert entry.aot.launches == {FLASH_ATTENTION: engine.cfg.n_layers}
    batches = -(-(len(trace) // engine.cfg.window) // 24)
    launches = (FLASH_ATTENTION.launches, FUSED_FEATURES.launches)
    engine.simulate(trace)
    assert (FLASH_ATTENTION.launches, FUSED_FEATURES.launches) == (
        launches[0] + engine.cfg.n_layers * batches, launches[1] + batches)


def test_paper_config_graphed_simulate_equals_eager_and_tracks_cpu(dev):
    """The paper's model (configs/tao.py) on the fused route: one graph
    holding 6 attention nodes, 6 launches a batch; the graphed simulate
    bitwise the eager step (``cpi_phase`` as the module note says); and on
    a short trace held to the same weights on the CPU by the flip
    contract."""
    engine = graph_engine(dev, cfg=PAPER, collect=True)
    trace = run_functional(get_benchmark("mcf"), 20000)
    launches = FLASH_ATTENTION.launches
    got = engine.simulate(trace)
    entry = engine.step_entry_for(len(trace))
    batches = -(-(len(trace) // PAPER.window) // engine.ecfg.batch_size)
    assert sum("attention_kernel" in k for k in graph_kernel_names(entry.aot.graph)) == PAPER.n_layers == 6
    assert entry.aot.launches == {FLASH_ATTENTION: 6}
    # a capture first runs the step eagerly WARMUP_RUNS times
    assert FLASH_ATTENTION.launches - launches == 6 * (batches + WARMUP_RUNS * engine.num_compiles)
    assert_graph_equals_eager(got, eager_entry_loop(engine, trace), engine.ecfg.batch_size)
    short = trace[:6000]
    cpu_model = init_tao(PAPER, torch.Generator().manual_seed(0), device="cpu")
    cpu = StreamingEngine(cpu_model, PAPER, engine.ecfg, device="cpu").simulate(short)
    assert_card_tracks_cpu(engine.simulate(short), cpu)


def test_failed_capture_raises(dev):
    """A spec whose update reads the device cannot be captured: simulate
    raises, the entry keeps no graph and no capture is counted, and the
    card runs the next engine as before."""
    def reads_device(carry, ctx):
        return carry + int(ctx.is_branch.sum().item())

    spec = MetricSpec("reads_device", lambda device: torch.zeros((), dtype=torch.int32, device=device),
                      reads_device, lambda carry, n: {"reads_device": float(carry)})
    cfg = TaoConfig()
    engine = StreamingEngine(init_tao(cfg, device=dev), cfg, EngineConfig(metrics=("cpi", spec)), device=dev)
    trace = run_functional(get_benchmark("dee"), 10000)
    with pytest.raises(RuntimeError):
        engine.simulate(trace)
    entry = engine.step_entry_for(len(trace))
    assert entry.aot is None and entry.compiles == 0
    with pytest.raises(RuntimeError):
        engine.warmup(len(trace))
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    good = graph_engine(dev, batch_size=40)
    assert_graph_equals_eager(good.simulate(trace), eager_entry_loop(good, trace), 40)


# ---------------------------------------------------------------------------
# The int8 W8A8 path
# ---------------------------------------------------------------------------

# every dense layer shape (in, out) of the default TaoConfig and of the paper's
INT8_LAYER_SHAPES = sorted({shape for cfg in TAO_CONFIGS.values()
                            for shape in dense_shapes(quantize_tao_params(init_tao(cfg, device="cpu")))})


def test_quantize_tao_params_on_card_bitwise_cpu(dev):
    cfg = TaoConfig()
    cpu = quantize_tao_params(init_tao(cfg, torch.Generator().manual_seed(3), device="cpu"))
    card = quantize_tao_params(init_tao(cfg, torch.Generator().manual_seed(3), device=dev))
    a, b = dict(cpu.named_buffers()), dict(card.named_buffers())
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert b[k].is_cuda and b[k].dtype == v.dtype, k
        assert torch.equal(b[k].cpu().view(torch.uint8), v.view(torch.uint8)), k


@pytest.mark.parametrize("rows", [8256, 16, 3])
@pytest.mark.parametrize("shape", INT8_LAYER_SHAPES, ids=[f"{k}x{n}" for k, n in INT8_LAYER_SHAPES])
def test_qdense_on_card_equals_cpu(dev, shape, rows):
    """Quantized buffers, codes, int32 sums and output bitwise."""
    same = qdense_device_vs_cpu(*shape, rows, dev)
    assert all(same.values()), same


@pytest.mark.parametrize("route", ["fused", "staged", "host"])
def test_graphed_int8_simulate_equals_eager_entry_loop(dev, route):
    """The int8 step's own graph: ``n_layers`` attention nodes, and every
    route's graphed simulate held to the eager int8 step (module note)."""
    engine = graph_engine(dev, collect=True, precision="int8")
    trace = run_functional(get_benchmark("mcf"), 40000)
    feats = route_features(route, trace, engine.cfg.features, dev)
    got = engine.simulate(trace, features=feats)
    entry = engine.step_entry_for(len(trace))
    assert entry.aot is not None and entry.compiles == 1
    assert sum("attention_kernel" in k for k in graph_kernel_names(entry.aot.graph)) == engine.cfg.n_layers
    assert entry.aot.launches == {FLASH_ATTENTION: engine.cfg.n_layers}
    assert_graph_equals_eager(got, eager_entry_loop(engine, trace, feats), engine.ecfg.batch_size)


def test_int8_entry_shared_by_engines_apart_from_fp32(dev):
    """int8 engines of one shape share one captured entry, each with its own
    quantized weights copied in per simulate; the fp32 engine of the same
    shape has another entry."""
    a = graph_engine(dev, seed=0, batch_size=40, precision="int8")
    b = graph_engine(dev, seed=1, batch_size=40, precision="int8")
    fp = graph_engine(dev, seed=0, batch_size=40)
    trace = run_functional(get_benchmark("lee"), 30000)
    runs = [(e, e.simulate(trace)) for e in (a, b, fp, a)]
    n = len(trace)
    assert a.step_entry_for(n) is b.step_entry_for(n) is not fp.step_entry_for(n)
    assert a.num_compiles == b.num_compiles == fp.num_compiles == 1
    for e, got in runs:
        assert_graph_equals_eager(got, eager_entry_loop(e, trace), 40)
    assert runs[0][1].cpi != runs[1][1].cpi and runs[0][1].cpi != runs[2][1].cpi


# ---------------------------------------------------------------------------
# Training: the attention backward (B4's, the port's own kernel) and the
# trainer on the card
# ---------------------------------------------------------------------------

# (B, H, S, D, causal, seed): the Tao training shape at batch 16 and 64,
# short and long windows, narrow, odd and wide heads, then the edges of the
# kernel's 16-row tiles and 64-row streamed tiles (S 1, 15, 16, 17, 144,
# 145) at widths 8 and 20, and a long window, whose sums run over 1,000
# rows
ATTN_BWD_CASES = {
    "tao_b16": (16, 4, 129, 32, True, 0),
    "tao_noncausal": (4, 4, 129, 32, False, 1),
    "s17_d16": (4, 4, 17, 16, True, 2),
    "s200_d64_noncausal": (2, 4, 200, 64, False, 3),
    "s77_d20": (3, 2, 77, 20, True, 4),
    "s129_d128": (2, 2, 129, 128, True, 5),
    "tao_b64": (64, 4, 129, 32, True, 6),
    **{f"tile_s{S}_d{D}": (2, 3, S, D, True, 7 + i)
       for i, (S, D) in enumerate((S, D) for S in (1, 15, 16, 17, 144, 145) for D in (8, 20))},
    "tile_s145_d20_noncausal": (2, 3, 145, 20, False, 19),
    "long_s1000_d64": (1, 2, 1000, 64, True, 21),
    # the paper's model at the train batch (configs/tao.py)
    "paper_b16": (16, 8, 129, 64, True, 22),
}


@pytest.mark.parametrize("case", sorted(ATTN_BWD_CASES))
def test_attention_bwd_kernel_matches_plain(dev, case):
    """The backward kernel against the explicit formulas within atol = rtol
    = 1e-5 (float32 sums over at most S terms in other orders), bitwise
    equal over two calls (no atomics), on the packed q/k/v views; the
    forward's output bitwise the same with and without its log-sum-exp,
    which is within 2e-5 + 1e-5 |lse| of the plain one."""
    B, H, S, D, causal, seed = ATTN_BWD_CASES[case]
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(B, S, 3, H, D, generator=g).to(dev).permute(2, 0, 3, 1, 4).unbind(0)
    do = torch.randn(B, H, S, D, generator=g).to(dev)
    out_only = flash_attention_cuda(q, k, v, causal=causal)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    launches = FLASH_ATTENTION_BWD.launches
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    ref = attention_bwd_plain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_BWD.launches == launches + 2
    assert torch.equal(out, out_only)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, causal=causal), atol=2e-5, rtol=1e-5)
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5)


def test_attention_bwd_kernel_takes_unaligned_strides(dev):
    """Widths and strides that are not multiples of 4 floats take the
    backward's 4-byte copies and scalar stores, with dO a strided view:
    within atol = rtol = 1e-5 of the plain formulas, two calls bitwise."""
    g = torch.Generator().manual_seed(20)
    base = torch.randn(2, 3, 77, 2 * 21 + 1, generator=g).to(dev)
    q, k, v = base[..., :21], base[..., 21:42], base[..., 1:22]
    do = torch.randn(2, 3, 77, 2 * 21 + 1, generator=g).to(dev)[..., 2:23]
    assert q.stride() == k.stride() == v.stride() == do.stride() == (3 * 77 * 43, 77 * 43, 43, 1)
    out, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)
    ref = attention_bwd_plain(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5)


def test_attention_bwd_launch_info_at_the_training_shape(dev):
    """What the backward's kernels get at (16, 4, 129, 32): no spills, the
    dK / dV and dQ grid at least one block per SM and resident in one
    wave."""
    info = bwd_launch_info(16, 4, 129, 32)
    assert tuple(info) == BWD_KERNEL_NAMES
    assert all(i["spill_bytes_per_thread"] == 0 for i in info.values()), info
    main = info["bwd_dkdv_dq"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert sms <= main["blocks_per_call"] <= main["blocks_per_sm"] * sms, (main, sms)


def test_attention_lse_of_rows_without_keys_is_inf(dev):
    """A row that sees no key (past Sk under segments) gets lse = +inf, so
    the backward's 2^(s - lse) is 0 there, as its output is."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 2, 12, 16, generator=g).to(dev) for _ in range(3))
    seg = torch.zeros(2, 12, dtype=torch.int32, device=dev)
    out, lse = flash_attention_cuda(q, k, v, seg, causal=False, q_offset=6, return_lse=True)
    torch.cuda.synchronize()
    assert torch.all(torch.isposinf(lse[:, :, 6:])) and torch.all(out[:, :, 6:] == 0)
    torch.testing.assert_close(lse[:, :, :6], attention_lse_plain(q, k, seg, causal=False,
                                                                  q_offset=6)[:, :, :6],
                               atol=2e-5, rtol=1e-5)


def test_flash_attention_records_the_kernel_backward(dev):
    """Under autograd, ``flash_attention`` launches the forward with its
    lse and, in backward, the backward kernel once: its gradients are the
    kernel's.  Without grad it is the plain forward launch; a call the
    backward does not take raises."""
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(2, 4, 129, 32, generator=g).to(dev) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    out = flash_attention(*leaves, causal=True)
    out.backward(do)
    assert (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches) == (counts[0] + 1, counts[1] + 1)
    ref_out, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    for x, ref in zip(leaves, flash_attention_bwd_cuda(q, k, v, ref_out, lse, do, causal=True)):
        assert torch.equal(x.grad, ref)
    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    with torch.no_grad():
        plain_launch = flash_attention(*leaves, causal=True)
    with torch.inference_mode():
        flash_attention(q, k, v, causal=True)
    assert (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches) == (counts[0] + 2, counts[1])
    assert plain_launch.grad_fn is None and torch.equal(plain_launch, ref_out)
    with pytest.raises(ValueError, match="backward takes"):
        flash_attention(*leaves, torch.zeros(2, 129, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="backward takes"):
        flash_attention(*leaves, q_offset=3)


def labelled_batch(cfg, n, seed=0):
    """``n`` labelled windows of lee on UARCH_A: the training data path."""
    fs = extract_features(build_adjusted_trace(run_detailed(
        get_benchmark("lee"), run_functional(get_benchmark("lee"), 6000), UARCH_A)[0]).adjusted,
        cfg.features)
    return build_windows(fs, cfg.window).subsample(n, seed=seed)


@pytest.mark.parametrize("name", sorted(TAO_CONFIGS))
def test_tao_gradients_on_card_match_cpu(dev, name):
    """``loss.backward()`` through ``tao_forward`` on the card at the
    default width and at the paper's gives every parameter a gradient — the attention
    projection ``qkv`` included, whose gradient comes back through the
    packed q/k/v views and the backward kernel — each within 1e-4 of its
    tensor's largest CPU gradient of the same model's CPU gradient (the
    forward differs in the last bits: cuBLAS and 3xTF32 attention)."""
    cfg = TAO_CONFIGS[name]
    batch = next(labelled_batch(cfg, 4).batches(4))
    model_cpu = init_tao(cfg, torch.Generator().manual_seed(0), device="cpu")
    model_gpu = init_tao(cfg, torch.Generator().manual_seed(0), device=dev)
    grads = {}
    for name, model, device in (("cpu", model_cpu, torch.device("cpu")), ("gpu", model_gpu, dev)):
        loss, _ = multi_metric_loss(tao_forward(model, to_device(batch, device), cfg),
                                    to_device(batch, device)["labels"])
        loss.backward()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    assert model_gpu.pred.blocks[0].qkv.weight.grad is not None
    assert all(g is not None for g in grads["gpu"].values())
    for k, ref in grads["cpu"].items():
        err = float((grads["gpu"][k].cpu() - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (k, err, float(ref.abs().max()))


def test_inference_graph_holds_no_backward(dev):
    """The engine runs under inference mode: its graph holds ``n_layers``
    attention forward nodes and none of the backward's, and a simulate
    launches no backward."""
    engine = graph_engine(dev, batch_size=24)
    trace = run_functional(get_benchmark("mcf"), 20000)
    entry = engine.warmup(len(trace))
    names = graph_kernel_names(entry.aot.graph)
    assert sum("attention_kernel" in k for k in names) == engine.cfg.n_layers
    assert not any("bwd_" in k for k in names)
    launches = FLASH_ATTENTION_BWD.launches
    engine.simulate(trace)
    assert FLASH_ATTENTION_BWD.launches == launches


def test_train_on_card_launches_the_kernels_and_tracks_cpu(dev):
    """3 steps of ``train_tao_impl`` at the default width on the card: 2
    attention forward and 2 backward launches a step, losses within 1e-4
    relative of the same steps on the CPU, parameters within 2 lr a step
    (Adam moves a parameter by at most ~lr a step, and the sign of a ~0
    gradient may differ between the two)."""
    cfg = TaoConfig()
    ds = labelled_batch(cfg, 16, seed=1)
    init = init_tao(cfg, torch.Generator().manual_seed(1), device="cpu").state_dict()
    kw = dict(epochs=3, batch_size=16, lr=3e-4, init_params=init, seed=1)
    cpu = train_tao_impl(cfg, ds, device="cpu", **kw)
    # the recipe's graph captured first: its capture's eager warm-up
    # steps launch the kernels too, outside the run counted here
    warmup_train_step(cfg, batch_size=16, lr=3e-4, device=dev)
    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    gpu = train_tao_impl(cfg, ds, device=dev, **kw)
    assert gpu.steps == 3
    assert (FLASH_ATTENTION.launches - counts[0], FLASH_ATTENTION_BWD.launches - counts[1]) == (
        cfg.n_layers * 3, cfg.n_layers * 3)
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-4)
    sg, sc = gpu.params.state_dict(), cpu.params.state_dict()
    assert max(float((sg[k].cpu() - sc[k]).abs().max()) for k in sc) <= 2 * 3e-4 * 3


def test_transfer_on_card_keeps_embed_bitwise(dev):
    cfg = TaoConfig()
    ds = labelled_batch(cfg, 32, seed=2)
    donor = init_tao(cfg, torch.Generator().manual_seed(2), device=dev)
    ft = transfer_finetune(cfg, donor.embed, donor, ds, epochs=1, batch_size=16, device=dev)
    for (k, a), b in zip(ft.params.embed.state_dict().items(), donor.embed.state_dict().values()):
        assert torch.equal(a, b), k
    assert not torch.equal(ft.params.adapt.weight, donor.adapt.weight)


# ---------------------------------------------------------------------------
# persistence: the store, checkpoints, crash-resume, the legacy loop
# ---------------------------------------------------------------------------


def test_train_resume_bitwise_on_card(dev, tmp_path):
    """One epoch with manifests, then a resume to three, on the card at
    the default width: losses, steps, every parameter and the optimizer
    state bitwise the uninterrupted run's (no kernel of the step uses
    atomics); the resumed run launches the attention kernels only for the
    epochs it ran."""
    from repro_torch.resilience.manifest import load_train_epoch
    from repro_torch.store import ArtifactStore

    cfg = TaoConfig()
    ds = labelled_batch(cfg, 32, seed=3)  # 2 steps an epoch
    kw = dict(batch_size=16, lr=3e-4, seed=0, device=dev)
    base_st, st = ArtifactStore(str(tmp_path / "base")), ArtifactStore(str(tmp_path / "ck"))
    base = train_tao_impl(cfg, ds, epochs=3, store=base_st, resume_key="run", **kw)
    part = train_tao_impl(cfg, ds, epochs=1, store=st, resume_key="run", **kw)
    assert part.losses == base.losses[:1]
    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    resumed = train_tao_impl(cfg, ds, epochs=3, store=st, resume_key="run", **kw)
    ran = resumed.steps - part.steps
    assert part.steps == 2 and ran == 4
    assert (FLASH_ATTENTION.launches - counts[0], FLASH_ATTENTION_BWD.launches - counts[1]) == (
        cfg.n_layers * ran, cfg.n_layers * ran)
    assert resumed.losses == base.losses and resumed.steps == base.steps
    for (k, a), b in zip(resumed.params.state_dict().items(), base.params.state_dict().values()):
        assert a.device.type == "cuda" and torch.equal(a, b), k
    a, b = load_train_epoch(base_st, "run", 3), load_train_epoch(st, "run", 3)
    for group in ("mu", "nu"):
        for k in a["opt"][group]:
            np.testing.assert_array_equal(a["opt"][group][k], b["opt"][group][k])
    assert int(a["opt"]["step"]) == int(b["opt"]["step"]) == base.steps


def test_store_and_checkpoints_round_trip_card_tensors(dev, tmp_path):
    """Card tensors (float32, int32, bfloat16) go through the store and the
    checkpoint manager to the host bitwise, digest as their host copies,
    and restore onto a template on the card."""
    from repro_torch.ckpt import CheckpointManager, restore_pytree
    from repro_torch.store import ArtifactStore, array_digest, tree_digest

    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn(64, 33, generator=g, device=dev),
            "bf": torch.randn(17, 5, generator=g, device=dev).to(torch.bfloat16),
            "n": torch.arange(10, dtype=torch.int32, device=dev)}
    host = {k: v.cpu().clone() for k, v in tree.items()}
    assert tree_digest(tree) == tree_digest(host)
    assert array_digest(tree["bf"]) == array_digest(host["bf"])
    st = ArtifactStore(str(tmp_path / "s"))
    assert st.put("params", "k" * 32, tree)
    got, _ = st.get("params", "k" * 32)
    assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"], host["bf"])
    np.testing.assert_array_equal(got["w"], host["w"].numpy())
    np.testing.assert_array_equal(got["n"], host["n"].numpy())
    mgr = CheckpointManager(str(tmp_path / "c"), use_async=True)
    mgr.save(tree, 1)
    for v in tree.values():  # the loop overwrites its tensors after the save
        v.zero_()
    mgr.wait()
    restored, extra = mgr.restore_latest(tree)
    mgr.close()
    assert extra["step"] == 1
    for k, v in restored.items():
        assert v.device.type == "cuda" and v.dtype == host[k].dtype and torch.equal(v.cpu(), host[k]), k
    on_cpu = restore_pytree(host, str(tmp_path / "c" / "step_1"))
    assert all(torch.equal(on_cpu[k], host[k]) for k in host)


def assert_card_tracks_cpu(gpu, cpu):
    """Two collected runs of one trace and one set of weights, on the card
    and on the CPU: decodes flipped at ≤ 0.1% of positions,
    ``mispred_prob`` within 1e-4, every metric moved only as far as its
    flips allow."""
    n = cpu.num_instructions
    assert gpu.num_instructions == n
    flips = {
        "fetch": int((gpu.fetch_lat != cpu.fetch_lat).sum()),
        "exec": int((gpu.exec_lat != cpu.exec_lat).sum()),
        "mispredict": int(((gpu.mispred_prob > 0.5) != (cpu.mispred_prob > 0.5)).sum()),
        "l1d": int(((gpu.dlevel >= 2) != (cpu.dlevel >= 2)).sum()),
    }
    assert max(flips.values()) <= 1e-3 * n, flips
    np.testing.assert_allclose(gpu.mispred_prob, cpu.mispred_prob, rtol=0, atol=1e-4)
    assert abs(gpu.total_cycles - cpu.total_cycles) <= 256.0 * (flips["fetch"] + flips["exec"])
    assert abs(gpu.branch_mpki - cpu.branch_mpki) <= 1000.0 * flips["mispredict"] / n + 1e-12
    assert abs(gpu.l1d_mpki - cpu.l1d_mpki) <= 1000.0 * flips["l1d"] / n + 1e-12


def test_simulate_trace_legacy_on_card_matches_cpu(dev):
    """The legacy loop on the card against the same loop on the CPU at the
    default width: 2 attention launches per ragged batch, decodes flipped
    at ≤ 0.1% of positions, ``mispred_prob`` within 1e-4, every metric
    moved only as far as its flips allow."""
    from repro_torch.core import simulate_trace_legacy

    cfg = TaoConfig()
    trace = run_functional(get_benchmark("mcf"), 20000)
    fs = extract_features(trace, cfg.features, with_labels=False)
    gpu_model = init_tao(cfg, torch.Generator().manual_seed(0), device=dev)
    cpu_model = init_tao(cfg, torch.Generator().manual_seed(0), device="cpu")
    launches = FLASH_ATTENTION.launches
    gpu = simulate_trace_legacy(gpu_model, trace, cfg, batch_size=64, features=fs, device=dev)
    batches = -(-(len(trace) // cfg.window) // 64)
    assert FLASH_ATTENTION.launches - launches == cfg.n_layers * batches
    cpu = simulate_trace_legacy(cpu_model, trace, cfg, batch_size=64, features=fs, device="cpu")
    assert gpu.num_instructions == cpu.num_instructions == (len(trace) // cfg.window) * cfg.window
    assert_card_tracks_cpu(gpu, cpu)


# ---------------------------------------------------------------------------
# the train steps' CUDA graphs
# ---------------------------------------------------------------------------


def drive(cfg, ds, graphed, epochs=2, freeze=False, init=None, seed=0, lr=3e-4, eval_fn=None):
    """A run driven as ``train_tao_impl`` drives it, on the recipe's graph
    or on the entry's eager step: (losses, evals, model, AdamW state)."""
    from repro_torch.core.transfer import _EagerRun, _GraphRun, _make_step, _new_state, _run_epochs
    from repro_torch.train import AdamWConfig

    model, opt = _new_state(cfg, init, freeze, seed, torch.device("cuda"))
    entry = _make_step(cfg, AdamWConfig(lr=lr), "headonly" if freeze else "all")
    run = (_GraphRun if graphed else _EagerRun)(entry, model, opt)
    losses, evals, _ = _run_epochs(run, ds, epochs, 16, eval_fn=eval_fn, seed=seed)
    model, opt = run.state()
    return losses, evals, model, opt


def assert_state_equal(a, b):
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def assert_adamw_equal(a, b):
    assert torch.equal(a.step, b.step)
    for group in ("mu", "nu"):
        ga, gb = getattr(a, group), getattr(b, group)
        assert list(ga) == list(gb)
        for k in ga:
            assert torch.equal(ga[k], gb[k]), (group, k)


@pytest.mark.parametrize("name", sorted(TAO_CONFIGS))
@pytest.mark.parametrize("freeze", [False, True], ids=["all", "headonly"])
def test_graphed_train_equals_eager_step(dev, freeze, name):
    """Losses, parameters, AdamW state and each epoch's eval (read from
    the state stored back between epochs) bitwise the eager step's; the
    public entry point's run is the graphed one."""
    from repro_torch.core.transfer import _make_step
    from repro_torch.train import AdamWConfig

    cfg = TAO_CONFIGS[name]
    ds = labelled_batch(cfg, 48, seed=4)
    assert len(ds) // 16 >= 2  # steps an epoch
    init = init_tao(cfg, torch.Generator().manual_seed(4), device="cpu").state_dict()

    def eval_fn(model):
        return float(sum(p.detach().double().sum() for p in model.parameters()))

    g_losses, g_evals, g_model, g_opt = drive(cfg, ds, True, freeze=freeze, init=init, eval_fn=eval_fn)
    e_losses, e_evals, e_model, e_opt = drive(cfg, ds, False, freeze=freeze, init=init, eval_fn=eval_fn)
    assert g_losses == e_losses and g_evals == e_evals and len(g_evals) == 2
    assert_state_equal(g_model, e_model)
    assert_adamw_equal(g_opt, e_opt)
    assert int(g_opt.step) == 2 * (len(ds) // 16)
    res = train_tao_impl(cfg, ds, epochs=2, batch_size=16, lr=3e-4, init_params=init, seed=0,
                         freeze_embed=freeze, eval_fn=eval_fn, device=dev)
    assert res.losses == e_losses and res.eval_losses == e_evals
    assert_state_equal(res.params, e_model)
    entry = _make_step(cfg, AdamWConfig(lr=3e-4), "headonly" if freeze else "all")
    # one graph of this geometry on the card (a CPU run of the recipe, in
    # this process, counts its own geometry in ``compiles``)
    assert entry.aot is not None and len(entry.aot) == 1
    if freeze:
        for k, v in res.params.embed.state_dict().items():
            assert torch.equal(v, init[f"embed.{k}"].to(dev)), k


def test_runs_through_one_entry_leak_nothing(dev):
    """Runs of other weights through one captured entry, in turns: each is
    bitwise its own eager run, and the first run repeated is bitwise the
    first."""
    cfg = TaoConfig()
    ds = labelled_batch(cfg, 32, seed=5)
    inits = [init_tao(cfg, torch.Generator().manual_seed(s), device="cpu").state_dict() for s in (5, 6)]
    runs = [drive(cfg, ds, True, init=inits[i]) for i in (0, 1, 0)]
    assert runs[0][0] == runs[2][0] and runs[0][0] != runs[1][0]
    assert_state_equal(runs[0][2], runs[2][2])
    assert_adamw_equal(runs[0][3], runs[2][3])
    eager = drive(cfg, ds, False, init=inits[1])
    assert runs[1][0] == eager[0]
    assert_state_equal(runs[1][2], eager[2])


def test_warmup_train_step_then_train_captures_nothing(dev):
    from repro_torch.engine.aot import graph_kernel_names
    from repro_torch.train import cache_stats

    cfg = TaoConfig()
    lr = 4.4e-4  # a recipe of its own
    entry = warmup_train_step(cfg, batch_size=16, lr=lr, device=dev)
    assert entry.aot is not None and entry.compiles == 1 and entry.est_bytes > 0
    assert warmup_train_step(cfg, batch_size=16, lr=lr, device=dev) is entry and entry.compiles == 1
    (graph,) = entry.aot.values()
    names = graph_kernel_names(graph.graph)
    assert sum("attention_kernel" in k for k in names) == cfg.n_layers
    assert sum("bwd_dkdv_dq" in k for k in names) == cfg.n_layers
    assert graph.launches == {FLASH_ATTENTION: cfg.n_layers, FLASH_ATTENTION_BWD: cfg.n_layers}
    stats = cache_stats()
    assert stats["aot_compiled"] >= 1 and stats["retained_bytes_est"] >= entry.est_bytes
    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    res = train_tao_impl(cfg, labelled_batch(cfg, 32, seed=6), epochs=2, batch_size=16, lr=lr, device=dev)
    assert entry.compiles == 1 and cache_stats()["compiles"] == stats["compiles"]
    assert graph.replays == res.steps == 4
    assert (FLASH_ATTENTION.launches - counts[0], FLASH_ATTENTION_BWD.launches - counts[1]) == (
        cfg.n_layers * 4, cfg.n_layers * 4)
    # a window shorter than the config's is another geometry: one more capture
    warmup_train_step(cfg, batch_size=16, lr=lr, window=65, device=dev)
    assert entry.compiles == 2 and len(entry.aot) == 2


def joint_pairs(cfg, n):
    from repro_torch.uarch import UARCH_B

    out = []
    for ua in (UARCH_A, UARCH_B):
        prog = get_benchmark("lee")
        det = run_detailed(prog, run_functional(prog, 12000), ua)[0]
        ds = build_windows(extract_features(build_adjusted_trace(det).adjusted, cfg.features), cfg.window)
        out.append(list(ds.batches(16, rng=np.random.default_rng(0)))[:n])
    return list(zip(*out))


@pytest.mark.parametrize("method", ["tao", "tao_no_adapt", "granite", "gradnorm"])
def test_graphed_joint_step_equals_eager(dev, method):
    """Three joint steps through ``make_joint_step`` (the graph) and
    through the entry's eager step, from equal parameters: losses, the
    global norm, parameters, AdamW state and GradNorm's weights bitwise;
    2 ``n_layers`` attention forward and backward launches a step."""
    from repro_torch.core import init_multiarch, make_joint_step
    from repro_torch.core.transfer import to_device
    from repro_torch.engine.aot import graph_kernel_names
    from repro_torch.train import AdamWConfig, adamw_init

    cfg = TaoConfig()
    pairs = joint_pairs(cfg, 3)
    assert len(pairs) == 3
    step = make_joint_step(cfg, AdamWConfig(lr=1e-3), method)
    out = {}
    for graphed in (True, False):
        params = init_multiarch(cfg, torch.Generator().manual_seed(0), device=dev)
        opt, w = adamw_init(dict(params.named_parameters())), torch.ones(2, device=dev)
        initial, metrics = torch.ones(2, device=dev), []
        for i, (ba, bb) in enumerate(pairs):
            if graphed:
                if i == 1:  # captured at the first step: count from the second
                    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
                opt, w, m = step(params, opt, w, initial, ba, bb)
            else:
                carry, m = step.entry.fn(params, {"opt": opt, "w": w},
                                         {"initial": initial, "a": to_device(ba, dev), "b": to_device(bb, dev)})
                opt, w = carry["opt"], carry["w"]
            metrics.append(torch.stack([m["loss_a"], m["loss_b"], m["gnorm"]]).cpu())
            if i == 0:
                initial = metrics[0][:2].to(dev)
        if graphed:
            launches = (FLASH_ATTENTION.launches - counts[0], FLASH_ATTENTION_BWD.launches - counts[1])
        out[graphed] = (torch.stack(metrics), params, opt, w.clone())
    (gm, gp, go, gw), (em, ep, eo, ew) = out[True], out[False]
    assert torch.equal(gm, em) and torch.equal(gw, ew)
    assert_state_equal(gp, ep)
    assert_adamw_equal(go, eo)
    assert launches == (2 * cfg.n_layers * 2, 2 * cfg.n_layers * 2)
    (graph,) = step.entry.aot.values()
    names = graph_kernel_names(graph.graph)
    assert sum("attention_kernel" in k for k in names) == 2 * cfg.n_layers
    assert sum("bwd_dkdv_dq" in k for k in names) == 2 * cfg.n_layers
    if method == "gradnorm":
        assert not torch.equal(gw, torch.ones(2, device=dev)) and abs(float(gw.sum()) - 2.0) <= 1e-6


# ---------------------------------------------------------------------------
# the sweep scheduler, prefetch across a first capture, the build cache
# ---------------------------------------------------------------------------

# deterministic on the card: cpi_phase's float atomics are left out
SWEEP_METRICS = ("cpi", "branch_mpki", "l1d_mpki", "dlevel_hist", "l1d_phase")


@pytest.mark.parametrize("route", ["fused", "staged", "host"])
def test_sweep_on_each_route_is_bitwise_each_standalone_simulate(dev, route):
    from repro_torch.engine import SweepJob, TraceSweeper
    from repro_torch.kernels.features.kernel import BRANCH_HISTORY, MEMDIST_DELTA

    cfg = TaoConfig()
    ecfg = EngineConfig(batch_size=40, metrics=SWEEP_METRICS)  # a geometry of its own
    traces = {b: run_functional(get_benchmark(b), 20000) for b in ("mcf", "lee")}
    models = [init_tao(cfg, torch.Generator().manual_seed(s), device=dev) for s in range(4)]
    jobs = [SweepJob(f"m{i}/{b}", m, t) for i, m in enumerate(models) for b, t in traces.items()]
    batches = sum(-(-(len(j.trace) // cfg.window) // 40) for j in jobs)
    counters = (FUSED_FEATURES, BRANCH_HISTORY, MEMDIST_DELTA, FLASH_ATTENTION)
    before = [k.launches for k in counters]
    rep = TraceSweeper(cfg, ecfg, route=route).run(jobs)
    got = tuple(k.launches - b for k, b in zip(counters, before))
    assert rep.prepared_async is True and rep.num_compiles <= 1
    expected = {"fused": (batches, 0, 0), "staged": (0, len(jobs), len(jobs)), "host": (0, 0, 0)}[route]
    # a capture first runs the step eagerly WARMUP_RUNS times
    assert got == expected + (cfg.n_layers * (batches + WARMUP_RUNS * rep.num_compiles),)
    assert rep.features_extracted == (len(traces) if route == "host" else 0)
    for j in jobs:
        engine = StreamingEngine(j.params, cfg, ecfg, device=dev)
        alone = engine.simulate(j.trace, features=route_features(route, j.trace, cfg.features, dev))
        assert rep.results[j.key].metrics.keys() == alone.metrics.keys()
        for k, v in alone.metrics.items():
            np.testing.assert_array_equal(rep.results[j.key].metrics[k], v, err_msg=f"{j.key} {k}")
    assert TraceSweeper(cfg, ecfg, route=route).run(jobs).num_compiles == 0


def force_prefetch(monkeypatch, threaded):
    """The engine's host route and the trainer prefetch inline; ``threaded``
    runs their ``prefetch_to_device`` on its producer thread instead."""
    from repro_torch.engine import prefetch_to_device, runner

    def forced(*args, **kw):
        kw.pop("threaded", None)
        return prefetch_to_device(*args, threaded=threaded, **kw)

    monkeypatch.setattr(runner, "prefetch_to_device", forced)


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
@pytest.mark.parametrize("warm", [False, True], ids=["first_capture", "after_warmup"])
def test_prefetch_across_the_engines_first_capture(dev, warm, threaded, monkeypatch):
    """The host route under prefetch, inline and on the producer thread,
    captures its step at the first simulate (or replays warmup's) before
    any batch is drawn, and is bitwise the same route without prefetch and
    the eager step."""
    from repro_torch.engine import clear_step_cache

    force_prefetch(monkeypatch, threaded)
    clear_step_cache()
    bsz = (44 if warm else 36) + threaded  # geometries of their own
    trace = run_functional(get_benchmark("dee"), 30000)
    fs = extract_features(trace, TaoConfig().features, with_labels=False)
    on = graph_engine(dev, batch_size=bsz, collect=True)
    if warm:
        on.warmup(len(trace))
    got = on.simulate(trace, features=fs)
    assert on.ecfg.prefetch and on.num_compiles == 1
    off = graph_engine(dev, batch_size=bsz, collect=True, prefetch=False)
    ref = off.simulate(trace, features=fs)
    assert off.num_compiles == 1  # the same entry: no second capture
    assert_graph_equals_eager(got, ref, bsz)
    assert_graph_equals_eager(got, eager_entry_loop(on, trace, fs), bsz)


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
@pytest.mark.parametrize("warm", [False, True], ids=["first_capture", "after_warmup"])
def test_train_step_bitwise_with_prefetch_on_and_off(dev, warm, threaded, monkeypatch):
    """train_tao_impl with prefetch, inline (its own) and on the producer
    thread: the recipe's graph is captured before the first batch is drawn
    (or taken from warmup_train_step), once; losses, evals and parameters
    bitwise the run without prefetch and the entry's eager step."""
    from repro_torch.core.transfer import _make_step
    from repro_torch.train import AdamWConfig

    force_prefetch(monkeypatch, threaded)
    cfg = TaoConfig()
    lr = (5.3e-4 if warm else 5.1e-4) + threaded * 1e-5  # recipes of their own: a cold cache
    ds = labelled_batch(cfg, 48, seed=7)
    init = init_tao(cfg, torch.Generator().manual_seed(7), device="cpu").state_dict()
    if warm:
        warmup_train_step(cfg, batch_size=16, lr=lr, device=dev)
    entry = _make_step(cfg, AdamWConfig(lr=lr), "all")
    evals = {}

    def eval_fn(tag):
        def read(model):
            evals.setdefault(tag, []).append(float(sum(p.detach().double().sum() for p in model.parameters())))
            return 0.0

        return read

    runs = {pf: train_tao_impl(cfg, ds, epochs=2, batch_size=16, lr=lr, init_params=init, seed=2,
                               prefetch=pf, eval_fn=eval_fn(pf), device=dev) for pf in (True, False)}
    assert entry.compiles == 1 and len(entry.aot) == 1
    assert runs[True].losses == runs[False].losses and evals[True] == evals[False]
    assert_state_equal(runs[True].params, runs[False].params)
    e_losses, _, e_model, _ = drive(cfg, ds, False, init=init, seed=2, lr=lr)
    assert runs[True].losses == e_losses
    assert_state_equal(runs[True].params, e_model)


def test_a_warm_process_builds_nothing(dev):
    """After every kernel is built, a new process finds each library in the
    build cache: no nvcc run, one hit per source."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.engine import build_cache_counters, persistent_cache_status
    from repro_torch.kernels import _cuda

    _cuda.build()
    assert persistent_cache_status()["entries"] >= len(list(_cuda.CSRC.glob("*.cu")))
    code = ("import json; from repro_torch.kernels._cuda import build; "
            "from repro_torch.engine import build_cache_counters; build(); "
            "print(json.dumps(build_cache_counters()))")
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": src})
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    n = len(list(_cuda.CSRC.glob("*.cu")))
    assert counts == {"requests": n, "hits": n, "misses": 0}
    assert set(build_cache_counters()) == set(counts)


# ---------------------------------------------------------------------------
# the Session facade
# ---------------------------------------------------------------------------


def test_session_train_then_simulate_on_card_tracks_cpu(dev):
    """``Session.train`` at the default width on the card and on the CPU
    (losses within 1e-4 relative, parameters within 2 lr a step, as
    ``train_tao_impl`` is held), then the card model's ``simulate`` on the
    fused route (one B1 launch a batch) against the same weights simulated
    on the CPU: decodes flipped at ≤ 0.1% of positions, ``mispred_prob``
    within 1e-4, every metric moved only as far as its flips allow."""
    from repro_torch.api import Session, TrainedModel

    cfg = TaoConfig()
    kw = dict(epochs=2, batch_size=16, lr=3e-4)
    sessions = {"gpu": Session(cfg), "cpu": Session(cfg, device="cpu")}
    models = {k: s.train(UARCH_A, [s.capture("lee", 6000)], **kw) for k, s in sessions.items()}
    gpu, cpu = models["gpu"], models["cpu"]
    assert gpu.device == dev and gpu.steps == cpu.steps > 0
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-4)
    sg, sc = gpu.params.state_dict(), cpu.params.state_dict()
    assert max(float((sg[k].cpu() - sc[k]).abs().max()) for k in sc) <= 2 * 3e-4 * gpu.steps
    trace = run_functional(get_benchmark("mcf"), 20000)
    launches = FUSED_FEATURES.launches
    g = gpu.simulate(trace, collect=True)
    assert FUSED_FEATURES.launches - launches == -(-(len(trace) // cfg.window) // 64)
    same = TrainedModel(params=init_tao(cfg, device="cpu"), cfg=cfg, device="cpu")
    same.params.load_state_dict({k: v.cpu() for k, v in sg.items()})
    c = same.simulate(trace, collect=True)
    assert_card_tracks_cpu(g, c)


def test_session_warmup_then_simulate_and_train_capture_nothing(dev):
    """``Session.warmup`` at a geometry and a train recipe of their own:
    one capture each ahead of any model, after which the first
    ``simulate`` and the first ``train`` capture nothing more."""
    from repro_torch.api import Session
    from repro_torch.train import train_step_compiles

    cfg = TaoConfig()
    sess = Session(cfg, batch_size=20)
    trace = run_functional(get_benchmark("dee"), 8000)
    out = sess.warmup([len(trace)], train=[{"batch_size": 8, "lr": 1e-4}])
    assert (out["sim_geometries"], out["sim_aot"], out["train_steps"]) == (1, 1, 1)
    captures, train_captures = cache_stats()["compiles"], train_step_compiles()
    model = sess.init_model(seed=3)
    res = model.simulate(trace)
    assert cache_stats()["compiles"] == captures and model.num_compiles == 1
    assert np.isfinite(res.cpi)
    trained = sess.train(dataset=labelled_batch(cfg, 16, seed=3), epochs=1, batch_size=8, lr=1e-4)
    assert trained.steps == 2 and train_step_compiles() == train_captures


# ---------------------------------------------------------------------------
# the trace server
# ---------------------------------------------------------------------------


def serve_models(cfg, seeds=(0, 1)):
    from repro_torch.api import TrainedModel

    return {f"m{s}": TrainedModel(params=init_tao(cfg, torch.Generator().manual_seed(s), device="cuda"),
                                  cfg=cfg, name=f"m{s}") for s in seeds}


def serve_registry(models, store=None):
    from repro_torch.serve import ModelRegistry

    reg = ModelRegistry(store)
    for name, m in models.items():
        reg.register(name, m)
    return reg


def run_server(coro):
    import asyncio

    return asyncio.run(coro)


def test_warm_server_on_card_is_bitwise_direct_with_no_capture(dev):
    import asyncio

    from repro_torch.serve import ServeRequest, TraceServer

    cfg = TaoConfig()
    models = serve_models(cfg)
    traces = {"mcf": run_functional(get_benchmark("mcf"), 20000),
              "short": run_functional(get_benchmark("lee"), 100)}
    direct = {(m, t): models[m].simulate(tr) for m in models for t, tr in traces.items()}
    batches = {"mcf": -(-(20000 // cfg.window) // 64), "short": 1}

    async def run():
        server = TraceServer(serve_registry(models), batch_size=64)
        async with server:
            server.warmup([len(t) for t in traces.values()])
            captures = cache_stats()["compiles"]
            b1, b4 = FUSED_FEATURES.launches, FLASH_ATTENTION.launches

            async def tenant(i):
                out = {}
                for m in models:
                    for t, tr in traces.items():
                        out[(m, t)] = await server.submit(ServeRequest(model=m, trace=tr, tenant=f"t{i}"))
                return out

            out = await asyncio.gather(*(tenant(i) for i in range(4)))
            return (out, server.num_compiles, cache_stats()["compiles"] - captures,
                    FUSED_FEATURES.launches - b1, FLASH_ATTENTION.launches - b4)

    out, compiles, captures, b1, b4 = run_server(run())
    assert compiles == 0 and captures == 0
    per_tenant = len(models) * sum(batches.values())
    assert b1 == 4 * per_tenant and b4 == cfg.n_layers * 4 * per_tenant
    for res in out:
        for k, r in res.items():
            assert r.metrics == direct[k].metrics, k


def test_hung_dispatch_on_card_leaves_later_results_bitwise(dev):
    import asyncio

    from repro_torch.resilience import FaultPlan, FaultSpec, inject
    from repro_torch.serve import ServeError, ServeRequest, TraceServer

    cfg = TaoConfig()
    models = serve_models(cfg)
    traces = {b: run_functional(get_benchmark(b), 20000) for b in ("mcf", "dee")}
    direct = {(m, t): models[m].simulate(tr) for m in models for t, tr in traces.items()}
    batches = -(-(20000 // cfg.window) // 64)
    plan = FaultPlan(FaultSpec("serve.dispatch", kind="delay", delay_s=1.0, times=1))

    async def run():
        server = TraceServer(serve_registry(models), batch_size=64, group_size=2)
        async with server:
            b4 = FLASH_ATTENTION.launches
            with inject(plan):
                futs = [server.submit(ServeRequest(model="m0", trace=traces["mcf"], deadline_s=0.3)),
                        server.submit(ServeRequest(model="m1", trace=traces["dee"]))]
                out = await asyncio.gather(*futs, return_exceptions=True)
                nxt = await server.submit(ServeRequest(model="m1", trace=traces["mcf"]))
                await asyncio.sleep(1.2)   # the abandoned thread wakes, and drops its group
            return out, nxt, plan.hits.get("engine.simulate", 0), FLASH_ATTENTION.launches - b4

    (hung, cohabitant), nxt, sims, b4 = run_server(run())
    assert isinstance(hung, ServeError) and hung.code == "DEADLINE_EXCEEDED"
    assert cohabitant.metrics == direct[("m1", "dee")].metrics
    assert nxt.metrics == direct[("m1", "mcf")].metrics
    assert sims == 2 and b4 == cfg.n_layers * 2 * batches


@contextlib.contextmanager
def hold_capture(seconds):
    """While inside, the next CUDA graph capture of a step sets the yielded
    event and then sleeps ``seconds`` between the capture's begin and end,
    so a CUDA call another thread makes in that window would break it (as
    ``chip_smoke.py``'s)."""
    import threading
    import time

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


def test_resolution_and_int8_beside_a_capture_on_card(dev, tmp_path):
    """An int8 server's first request captures a geometry no run has
    (held inside the capture); meanwhile the event loop resolves a model
    from the store (its placement waits for the device lock) and admits
    int8 requests for it, whose engine (the stored quantized tree) is built
    on the dispatch thread after the capture.  Nothing breaks the capture,
    and every result is bitwise the direct int8 run."""
    import asyncio

    from repro_torch.engine import clear_step_cache
    from repro_torch.serve import ModelRegistry, ServeRequest, TraceServer
    from repro_torch.store import ArtifactStore

    cfg = TaoConfig()
    models = serve_models(cfg)
    store = ArtifactStore(str(tmp_path / "s"))
    ModelRegistry(store).publish("pub", models["m1"])
    reg = ModelRegistry(store)
    reg.register("m0", models["m0"])
    trace = run_functional(get_benchmark("mcf"), 20000)
    odd = trace[:77]                      # a geometry of its own: w77b64
    clear_step_cache()

    async def run():
        server = TraceServer(reg, batch_size=64, precision="int8")
        async with server:
            with hold_capture(0.5) as started:
                first = server.submit(ServeRequest(model="m0", trace=odd))
                loop = asyncio.get_running_loop()
                assert await loop.run_in_executor(None, started.wait, 60)
                later = [server.submit(ServeRequest(model="pub", trace=t)) for t in (odd, trace)]
                out = await asyncio.gather(first, *later)
            return out, server.num_compiles

    out, compiles = run_server(run())
    assert compiles == 2   # the int8 step at w77 and at w129
    want = [models["m0"].simulate(odd, precision="int8"), models["m1"].simulate(odd, precision="int8"),
            models["m1"].simulate(trace, precision="int8")]
    for r, w in zip(out, want):
        assert r.metrics == w.metrics



# ---------------------------------------------------------------------------
# The dense family: B4 in bfloat16 and the serving path
# ---------------------------------------------------------------------------

# B4 in bfloat16 against its plain version on the same bfloat16 inputs:
# both compute in float32 and round the output once, so an element may
# land a bfloat16 rounding apart (2^-8 relative; 2^-7 with the sums'
# order); the absolute term covers outputs near 0
BF16_RTOL, BF16_ATOL_OF_MAX_V = 2.0**-7, 1e-5
# ...and at least this share of elements bitwise equal: P kept in float32
# (two bfloat16 terms) rounds as the plain version does but where the sums'
# order tips it; P rounded to one bfloat16 term does not (the CPU model of
# both is in tests/test_torch_attention.py)
BF16_MIN_BITWISE = 0.99
# (B, H, Sq, Sk, D, causal, q_offset, segmented, seed)
BF16_ATTN_CASES = {
    "qwen2_prefill_d64": (4, 14, 2048, 2048, 64, True, 0, False, 20),
    "glm4_prefill_d128": (4, 32, 2048, 2048, 128, True, 0, False, 21),
    "q_offset_sq_ne_sk": (2, 4, 40, 300, 64, True, 260, False, 22),
    "rows_without_keys": (2, 4, 40, 129, 32, False, 100, True, 23),
    "stablelm_prefill_d64": (4, 32, 2048, 2048, 64, True, 0, False, 25),
    "full_noncausal_d64": (2, 8, 1024, 1024, 64, False, 0, False, 26),
    "ragged_s2047_d128": (1, 8, 2047, 2047, 128, True, 0, False, 27),
    "ragged_s129_d128": (2, 4, 129, 129, 128, True, 0, False, 28),
    "width_80": (2, 4, 300, 300, 80, True, 0, False, 29),
    "segments_q_offset_d64": (2, 4, 100, 300, 64, True, 150, True, 30),
    "hubert_encode_d80_noncausal": (2, 16, 2048, 2048, 80, False, 0, False, 32),
    "qwen2vl_prefill_d128": (2, 12, 2048, 2048, 128, True, 0, False, 33),
}
# the float32 (mma.sync) instantiations' HMMA instructions, as in the
# build from before the bfloat16 path moved to wgmma: {output column tiles
# of 8: HMMA instructions}
F32_ATTENTION_HMMA = {4: 210, 8: 378, 16: 750}


def assert_bf16_close(got, ref, v):
    assert got.dtype == ref.dtype == torch.bfloat16
    diff = (got.float() - ref.float()).abs()
    limit = BF16_RTOL * ref.float().abs() + BF16_ATOL_OF_MAX_V * float(v.float().abs().max())
    assert bool((diff <= limit).all()), float(diff.max())
    share = float((got == ref).float().mean())
    assert share >= BF16_MIN_BITWISE, share


@pytest.mark.parametrize("case", sorted(BF16_ATTN_CASES))
def test_attention_kernel_bf16_matches_plain(dev, case):
    B, H, Sq, Sk, D, causal, off, segmented, seed = BF16_ATTN_CASES[case]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, n, D, generator=g).to(dev, torch.bfloat16) for n in (Sq, Sk, Sk))
    seg = None
    if segmented:
        cuts = torch.sort(torch.randint(1, Sk, (B, 3), generator=g), dim=1).values
        seg = (torch.arange(Sk)[None, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32).to(dev)
    launches = FLASH_ATTENTION.launches
    got, lse = flash_attention_cuda(q, k, v, seg, causal=causal, q_offset=off, return_lse=True)
    ref = attention_plain(q, k, v, seg, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + 1
    assert_bf16_close(got, ref, v)
    assert got.transpose(1, 2).is_contiguous()
    assert lse.dtype == torch.float32
    want = attention_lse_plain(q, k, seg, causal=causal, q_offset=off)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], want[finite], atol=2e-5, rtol=1e-5)


def test_attention_kernel_bf16_takes_unaligned_strides_and_packed_views(dev):
    """bfloat16 widths and strides that are not multiples of 8 elements take
    the kernel's element-wise staging; packed q / k / v views of one
    projection go in at their strides; both match the plain version."""
    g = torch.Generator().manual_seed(24)
    base = torch.randn(2, 77, 3, 5, 40, generator=g).to(dev, torch.bfloat16)
    q, k, v = base.permute(2, 0, 3, 1, 4).unbind(0)
    got = flash_attention_cuda(q, k, v[..., :36], causal=True)
    assert_bf16_close(got, attention_plain(q, k, v[..., :36], causal=True), v)
    odd = torch.randn(2, 3, 77, 43, generator=g).to(dev, torch.bfloat16)
    q, k, v = odd[..., :21], odd[..., 21:42], odd[..., 1:22]
    got = flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert_bf16_close(got, attention_plain(q, k, v, causal=True), v)


def test_attention_kernel_bf16_launch_info_at_the_dense_shapes(dev):
    for D in (64, 128):
        info = attention_launch_info(2048, D, D, dtype=torch.bfloat16)
        assert info["spill_bytes_per_thread"] == 0 and info["blocks_per_sm"] >= 1, (D, info)
        assert info["regs_per_thread"] <= 255
        assert info["threads_per_block"] == 256 and info["query_blocks"] == 16  # 2 x 64 rows


def test_attention_sass_bf16_on_wgmma_and_float32_as_it_was(dev):
    """Both bfloat16 instantiations (widths 64 and 128) run their products
    as wgmma (HGMMA) and hold no mma.sync (HMMA); the float32 ones hold the
    same HMMA count as before and no HGMMA."""
    sass = sass_counts(FLASH_ATTENTION.source, "attention_kernel")
    wgmma = {k: v for k, v in sass.items() if "attention_kernel_wgmma" in k}
    assert len(wgmma) == 2, sorted(sass)
    for name, ops in wgmma.items():
        assert ops["HGMMA"] > 0 and ops["HMMA"] == 0, (name, ops)
    for dv8, hmma in F32_ATTENTION_HMMA.items():
        [ops] = [v for k, v in sass.items() if f"attention_kernelILi{dv8}E" in k]
        assert (ops["HMMA"], ops["HGMMA"]) == (hmma, 0), (dv8, ops)


def test_bf16_calls_launch_the_wgmma_kernel_and_float32_the_mma_sync_one(dev):
    """By the profiler: a bfloat16 call of ``flash_attention`` runs one
    kernel, the wgmma one, at either width; a float32 call the mma.sync one."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(31)
    for D, dtype, piece in ((64, torch.bfloat16, "attention_kernel_wgmma<64>"),
                            (128, torch.bfloat16, "attention_kernel_wgmma<128>"),
                            (64, torch.float32, "attention_kernel<8>")):
        x = torch.randn(1, 2, 300, D, generator=g, device=dev).to(dtype)
        flash_attention(x, x, x, causal=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention(x, x, x, causal=True)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if "attention_kernel" in e.key]
        assert len(names) == 1 and piece in names[0], (D, dtype, names)


def test_flash_attention_refuses_bf16_that_requires_grad(dev):
    """bfloat16 operands under autograd launch the kernel backward (the LLM
    trainer's); what it does not take is refused, never run another way:
    segment ids, q_offset, Sq != Sk and D > 128 raise."""
    q = torch.randn(1, 2, 16, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    flash_attention(q, q, q, causal=True).sum().backward()
    assert (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches) == (counts[0] + 1, counts[1] + 1)
    assert q.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="backward takes"):
        flash_attention(q, q, q, torch.zeros(1, 16, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="backward takes"):
        flash_attention(q, q, q, q_offset=2)
    with pytest.raises(ValueError, match="backward takes"):
        flash_attention(q, q[:, :, :8].detach(), q[:, :, :8].detach())
    wide = torch.randn(1, 2, 16, 136, device=dev, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="outside 1..128"):
        flash_attention(wide, wide, wide)
    assert FLASH_ATTENTION_BWD.launches == counts[1] + 1
    with torch.no_grad():
        assert flash_attention(q, q, q, causal=True).dtype == torch.bfloat16


@pytest.mark.parametrize("case", sorted(ATTN_BWD_BF16_CASES))
def test_attention_bwd_bf16_matches_plain(dev, case):
    """The backward on bfloat16 operands against the plain formulas on the
    same bfloat16 inputs, both in float32 and rounded once: every element
    within 2^-7 |plain| + 1e-4 max |plain| (one bfloat16 rounding, the
    float32 sums in other orders), at least 99% bitwise, two calls bitwise;
    the lse is the wgmma forward's."""
    B, H, S, D, causal, rep, seed = ATTN_BWD_BF16_CASES[case]
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn(B, H, S, D, generator=g).to(dev, bf)
    k, v = (torch.randn(B, H // rep, S, D, generator=g).to(dev, bf).repeat_interleave(rep, dim=1)
            for _ in range(2))
    do = torch.randn(B, H, S, D, generator=g).to(dev, bf)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    ref = attention_bwd_plain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, ref):
        assert a.dtype == c.dtype == bf and torch.equal(a, b)
        a32, c32 = a.float(), c.float()
        limit = 2.0**-7 * c32.abs() + 1e-4 * float(c32.abs().max())
        assert bool(torch.all((a32 - c32).abs() <= limit)), float((a32 - c32).abs().max())
        assert float((a == c).float().mean()) >= 0.99


def test_attention_bwd_bf16_takes_unaligned_strides(dev):
    """bfloat16 widths and strides that are not multiples of 8 elements
    stage element by element: within the bfloat16 band, two calls bitwise."""
    g = torch.Generator().manual_seed(21)
    base = torch.randn(2, 3, 77, 2 * 21 + 1, generator=g).to(dev, torch.bfloat16)
    q, k, v = base[..., :21], base[..., 21:42], base[..., 1:22]
    do = torch.randn(2, 3, 77, 2 * 21 + 1, generator=g).to(dev, torch.bfloat16)[..., 2:23]
    out, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)
    ref = attention_bwd_plain(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, b)
        a32, c32 = a.float(), c.float()
        assert bool(torch.all((a32 - c32).abs() <= 2.0**-7 * c32.abs() + 1e-4 * float(c32.abs().max())))


def test_attention_bwd_bf16_launch_info_at_the_training_shapes(dev):
    """What the bfloat16 backward's wgmma kernel gets at the LLM training
    shapes: at width 64 three one-warpgroup blocks per SM and no spill; the
    128-wide template (D 80 and 128) one block of two warpgroups, its
    registers under 255 and no more spill than the mma.sync kernel it
    replaced had there (104 bytes)."""
    assert tuple(bwd_launch_info(1, 1, 64, 64, torch.bfloat16)) == ("bwd_delta", "bwd_dkdv_dq_wgmma")
    for D in (64, 80, 128):
        info = bwd_launch_info(4, 14, 2048, D, torch.bfloat16)["bwd_dkdv_dq_wgmma"]
        assert info["regs_per_thread"] <= 255, (D, info)
        if D <= 64:
            assert (info["threads_per_block"], info["blocks_per_sm"]) == (128, 3), (D, info)
            assert info["spill_bytes_per_thread"] == 0, (D, info)
        else:
            assert (info["threads_per_block"], info["blocks_per_sm"]) == (256, 1), (D, info)
            assert info["spill_bytes_per_thread"] <= 104, (D, info)


def test_attention_bwd_sass_bf16_on_wgmma_and_float32_on_mma_sync(dev):
    """The bfloat16 backward's instantiations (widths 64 and 128) run their
    products as wgmma (HGMMA) and hold no mma.sync (HMMA); the float32 ones
    (widths 32, 64 and 128) hold HMMA and no HGMMA."""
    sass = sass_counts(FLASH_ATTENTION_BWD.source, "bwd_dkdv_dq")
    wgmma = {k: v for k, v in sass.items() if "bwd_dkdv_dq_wgmma" in k}
    assert len(wgmma) == 2, sorted(sass)
    for name, ops in wgmma.items():
        assert ops["HGMMA"] > 0 and ops["HMMA"] == 0, (name, ops)
    for w in (32, 64, 128):
        [ops] = [v for k, v in sass.items() if f"bwd_dkdv_dqIfLi{w}E" in k]
        assert ops["HMMA"] > 0 and ops["HGMMA"] == 0, (w, ops)


def test_bf16_backward_launches_the_wgmma_kernel_and_float32_the_mma_sync_one(dev):
    """By the profiler: a bfloat16 backward runs bwd_delta and the wgmma
    kernel at either width; a float32 one bwd_delta and the mma.sync one."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(33)
    for D, dtype, piece in ((64, torch.bfloat16, "bwd_dkdv_dq_wgmma<64>"),
                            (128, torch.bfloat16, "bwd_dkdv_dq_wgmma<128>"),
                            (64, torch.float32, "bwd_dkdv_dq<float, 64>")):
        q, k, v, do = (torch.randn(1, 2, 300, D, generator=g, device=dev).to(dtype) for _ in range(4))
        out, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)
            torch.cuda.synchronize()
        names = sorted(e.key for e in prof.key_averages() if "bwd_" in e.key)
        assert len(names) == 2 and "bwd_delta" in names[0] and piece in names[1], (D, dtype, names)


def test_lm_train_step_on_card_matches_cpu(dev):
    """One step of the LLM trainer at qwen2-0.5b reduced in bfloat16: B4
    and its backward once a layer on the card, the loss, grad_norm and lr
    within 1e-2 relative of the same step on the CPU (plain attention
    under autograd), the parameters within 2 lr plus one bfloat16 ulp of
    the CPU's (a sign flip where g ~ 0, bfloat16 rounding elsewhere)."""
    from repro_torch.data import LMDataPipeline
    from repro_torch.train import TrainConfig, init_state, make_train_step

    cfg = dataclasses.replace(get_arch("qwen2-0.5b", reduced=True), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    gpu = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    tcfg = TrainConfig(lr=1e-3, total_steps=10, warmup_steps=0)
    batch = {k: torch.from_numpy(v) for k, v in LMDataPipeline(cfg, 4, 64, seed=2).make_batch(0).items()}
    counts = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    g_state, g_m = make_train_step(gpu, tcfg)(init_state(gpu, tcfg), {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (FLASH_ATTENTION.launches - counts[0], FLASH_ATTENTION_BWD.launches - counts[1]) == (
        cfg.n_layers, cfg.n_layers)
    c_state, c_m = make_train_step(cpu, tcfg)(init_state(cpu, tcfg), batch)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(g_m[k]) - float(c_m[k])) <= 1e-2 * abs(float(c_m[k])), k
    lr = float(c_m["lr"])
    for name, p in c_state.params.items():
        d = (g_state.params[name].detach().cpu().float() - p.detach().float()).abs()
        assert float(d.max()) <= 2 * lr + 2.0**-7 * float(p.detach().float().abs().max()), name


def test_attention_kernel_refuses_mixed_dtypes(dev):
    q = torch.zeros(1, 1, 4, 64, device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_cuda(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        flash_attention_cuda(q.half(), q.half(), q.half())


DENSE_ARCHS = ("qwen2-0.5b", "stablelm-1.6b", "glm4-9b", "qwen1.5-32b")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_full_width_two_layers_on_card_matches_cpu(dev, arch):
    """Each dense config at full width cut to 2 layers, float32, random
    weights: prefill (logits and cache) and a decode step on the card
    against the same model on the CPU (plain attention), within 2e-4 of
    the largest logit; B4 once per layer per prefill, never in a step."""
    import copy

    cfg = dataclasses.replace(get_arch(arch), n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 64), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    launches = FLASH_ATTENTION.launches
    logits, cache = model.prefill(toks)
    assert FLASH_ATTENTION.launches == launches + cfg.n_layers
    step, cache = model.decode_step(cache, toks[:, 0], 63)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + cfg.n_layers
    cpu = copy.deepcopy(model).to("cpu")
    del model
    ref, ref_cache = cpu.prefill(toks.cpu())
    ref_step, ref_cache = cpu.decode_step(ref_cache, toks[:, 0].cpu(), 63)
    for got, want in ((logits, ref), (step, ref_step), *((cache[k], ref_cache[k]) for k in ref_cache)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, atol=2e-4 * scale, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "stablelm-1.6b"])
def test_dense_bf16_serving_launches_b4_per_layer(dev, arch):
    """bfloat16 at full width, 2 layers: a prefill launches B4 once per layer
    (on bfloat16 q / k / v), a decode step never; logits finite."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 300), device=dev)
    launches = FLASH_ATTENTION.launches
    logits, cache = model.prefill(toks)
    assert FLASH_ATTENTION.launches == launches + cfg.n_layers
    assert cache["k"].dtype == torch.bfloat16
    grown = model.init_cache(2, 302)
    for k in grown:
        grown[k][:, :, :300] = cache[k]
    for i in range(2):
        logits, grown = model.decode_step(grown, logits.argmax(-1), 300 + i)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + cfg.n_layers
    assert torch.isfinite(logits).all()


VLM_AUDIO_ARCHS = ("qwen2-vl-2b", "hubert-xlarge")


@pytest.mark.parametrize("arch", VLM_AUDIO_ARCHS)
def test_vlm_audio_reduced_on_card_matches_cpu(dev, arch):
    """Each config reduced (4 layers, head dim 16, float32), random weights:
    qwen2-vl's prefill with random patches (logits and cache) and a decode
    step, hubert's ``encode``, on the card against the same model on the
    CPU (plain attention), within 2e-4 of the largest value; B4 once per
    layer (bidirectional for hubert), never in a decode step."""
    import copy

    cfg = get_arch(arch, reduced=True)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    cpu = copy.deepcopy(model).to("cpu")
    g = torch.Generator(device=dev).manual_seed(1)
    launches = FLASH_ATTENTION.launches
    if cfg.encoder_only:
        frames = torch.randn(2, 64, cfg.frontend_dim, generator=g, device=dev)
        got = model.encode(frames)
        torch.cuda.synchronize()
        assert FLASH_ATTENTION.launches == launches + cfg.n_layers
        pairs = [(got, cpu.encode(frames.cpu()))]
    else:
        toks = torch.randint(0, cfg.vocab, (2, 64), device=dev, generator=g)
        patches = torch.randn(2, cfg.vision_patches, cfg.frontend_dim, generator=g, device=dev)
        logits, cache = model.prefill(toks, patches)
        assert FLASH_ATTENTION.launches == launches + cfg.n_layers
        step, cache = model.decode_step(cache, toks[:, 0], 63)
        torch.cuda.synchronize()
        assert FLASH_ATTENTION.launches == launches + cfg.n_layers
        ref, ref_cache = cpu.prefill(toks.cpu(), patches.cpu())
        ref_step, ref_cache = cpu.decode_step(ref_cache, toks[:, 0].cpu(), 63)
        pairs = [(logits, ref), (step, ref_step), *((cache[k], ref_cache[k]) for k in ref_cache)]
    for got, want in pairs:
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, atol=2e-4 * scale, rtol=0)


# ---------------------------------------------------------------------------
# The moe family: MoE and MLA on the card, B4 at qwen3-moe's GQA 16:1
# ---------------------------------------------------------------------------

MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")
# full width cut to the first MoE layer: deepseek's dense layer and one MoE
# layer, qwen3-moe's first layer (~10 GB of float32 weights)
MOE_CUT_LAYERS = {"qwen3-moe-235b-a22b": 1, "deepseek-v2-lite-16b": 2}


def b4_per_prefill(cfg) -> int:
    """B4's launches in one prefill: one a layer, none under MLA (whose
    prefill runs the reference's plain blocked attention)."""
    return 0 if cfg.mla else cfg.n_layers


def test_attention_kernel_bf16_at_qwen3_moe_gqa_16(dev):
    """qwen3-moe-235b-a22b's prefill shape: 64 query heads over 4 kv heads
    (k / v drawn at 4 heads and repeated 16x as B4 gets them), causal."""
    g = torch.Generator().manual_seed(34)
    q = torch.randn(4, 64, 2048, 128, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(4, 4, 2048, 128, generator=g).to(dev, torch.bfloat16)
            .repeat_interleave(16, dim=1) for _ in range(2))
    launches = FLASH_ATTENTION.launches
    got = flash_attention_cuda(q, k, v, causal=True)
    ref = attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + 1
    assert_bf16_close(got, ref, v)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_full_width_cut_on_card_matches_cpu(dev, arch):
    """Each moe config at full width cut to its first MoE layer, float32,
    the published capacity_factor, random weights: prefill (logits and
    cache) and a decode step on the card against the same model on the
    CPU, within 2e-4 of the largest value; B4 once per layer a qwen3-moe
    prefill, never for MLA (deepseek), never in a step."""
    import copy

    cfg = dataclasses.replace(get_arch(arch), n_layers=MOE_CUT_LAYERS[arch],
                              param_dtype="float32", compute_dtype="float32")
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 64), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    b4 = b4_per_prefill(cfg)
    launches = FLASH_ATTENTION.launches
    logits, cache = model.prefill(toks)
    assert FLASH_ATTENTION.launches == launches + b4
    step, cache = model.decode_step(cache, toks[:, 0], 63)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + b4
    assert sorted(cache) == (["c_kv", "k_rope"] if cfg.mla else ["k", "v"])
    got = [t.cpu() for t in (logits, step, *cache.values())]
    del logits, step, cache
    cpu = model.to("cpu")
    ref, ref_cache = cpu.prefill(toks.cpu())
    ref_step, ref_cache = cpu.decode_step(ref_cache, toks[:, 0].cpu(), 63)
    for g, want in zip(got, (ref, ref_step, *ref_cache.values())):
        scale = float(want.abs().max())
        torch.testing.assert_close(g, want, atol=2e-4 * scale, rtol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_serving_launches_b4_per_layer_unless_mla(dev, arch):
    """bfloat16 at full width, cut to 2 layers: a qwen3-moe prefill launches
    B4 once per layer (GQA 16:1 after QK-norm), a deepseek prefill (MLA)
    never, a decode step never; the router stays float32; logits finite."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    assert model.layers[-1].moe.router.dtype == torch.float32
    toks = torch.randint(0, cfg.vocab, (2, 300), device=dev)
    b4 = b4_per_prefill(cfg)
    launches = FLASH_ATTENTION.launches
    logits, cache = model.prefill(toks)
    assert FLASH_ATTENTION.launches == launches + b4
    grown = model.init_cache(2, 302)
    for k in grown:
        grown[k][:, :, :300] = cache[k]
    for i in range(2):
        logits, grown = model.decode_step(grown, logits.argmax(-1), 300 + i)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + b4
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# The hybrid family: RG-LRU and windowed attention on the card, no B4
# ---------------------------------------------------------------------------

HYBRID = "recurrentgemma-9b"


def test_linear_scan_on_card_matches_cpu(dev):
    """The RG-LRU's Hillis–Steele scan at the prefill's 2,048 positions
    (a in [e^-8, 1), 512 channels), float32: the card's within 1e-5 of the
    largest |h| of the CPU's (FMA against separate rounding per step)."""
    from repro_torch.models import linear_scan

    g = torch.Generator().manual_seed(36)
    a = torch.exp(-8.0 * torch.rand(2, 2048, 512, generator=g))
    b = torch.randn(2, 2048, 512, generator=g)
    want = linear_scan(a, b)
    got = linear_scan(a.to(dev), b.to(dev)).cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_windowed_flash_ref_on_card_matches_cpu(dev, dtype):
    """recurrentgemma's attention shape, 16 heads of 256 (k / v of its one
    kv head repeated), 1,100 positions in 512-key blocks, window 300 (the
    first block skipped from the second query block on): the card against
    the CPU within 1e-5 of max|v| in float32, 2^-7 in bfloat16 (scores and
    P rounded to bfloat16 on both sides)."""
    from repro_torch.models import flash_ref

    g = torch.Generator().manual_seed(37)
    q = torch.randn(1, 16, 1100, 256, generator=g).to(dtype)
    k, v = (torch.randn(1, 1, 1100, 256, generator=g).to(dtype).repeat_interleave(16, 1)
            for _ in range(2))
    want = flash_ref(q, k, v, causal=True, window=300).float()
    got = flash_ref(q.to(dev), k.to(dev), v.to(dev), causal=True, window=300).float().cpu()
    tol = (1e-5 if dtype == torch.float32 else 2.0**-7) * float(v.float().abs().max())
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def test_hybrid_full_width_cut_on_card_matches_cpu(dev):
    """recurrentgemma-9b at full width cut to one unit and a tail layer (4
    layers), float32, random weights: prefill of 2 x 300 tokens (past no
    window) and a decode step, logits and every cache leaf after it,
    against the same model on the CPU within 2e-4 of the largest value;
    no B4 launch."""
    cfg = dataclasses.replace(get_arch(HYBRID), n_layers=4, param_dtype="float32",
                              compute_dtype="float32", kv_cache_dtype="float32")
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 300), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    launches = FLASH_ATTENTION.launches
    logits, cache = model.prefill(toks)
    step, cache = model.decode_step(cache, toks[:, 0], 299)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches
    got = [t.cpu() for t in (logits, step, *cache["attn"].values(), *cache["rec"].values())]
    del logits, step, cache
    cpu = model.to("cpu")
    ref, ref_cache = cpu.prefill(toks.cpu())
    ref_step, ref_cache = cpu.decode_step(ref_cache, toks[:, 0].cpu(), 299)
    for g, want in zip(got, (ref, ref_step, *ref_cache["attn"].values(),
                             *ref_cache["rec"].values())):
        torch.testing.assert_close(g, want, atol=2e-4 * float(want.abs().max()), rtol=0)


def test_hybrid_bf16_serving_launches_no_b4(dev):
    """bfloat16 at full width, cut to one unit and a tail layer: a prefill
    of 2 x 2,100 tokens (past the 2,048 window: the ring rolled) and three
    decode steps into a 2,048-slot ring launch no B4; logits finite; the
    recurrent states float32."""
    cfg = dataclasses.replace(get_arch(HYBRID), n_layers=4)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 2100), device=dev)
    launches = FLASH_ATTENTION.launches
    logits, cache = model.prefill(toks)
    assert cache["attn"]["k"].shape[2] == 2048 and cache["rec"]["h"].dtype == torch.float32
    for i in range(3):
        logits, cache = model.decode_step(cache, logits.argmax(-1), 2100 + i)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Memory policies: ArchConfig.remat and prefill_chunks
# ---------------------------------------------------------------------------

# a reduced dense model in the full configs' bfloat16 (B4 and its bf16
# backward) and a reduced Mamba-2 (B5 and the SSD backward)
REMAT_ARCHS = {"qwen2-0.5b": "bfloat16", "mamba2-1.3b": "float32"}


@pytest.mark.parametrize("arch", sorted(REMAT_ARCHS))
def test_remat_full_and_dots_bitwise_none_on_card(dev, arch):
    """The loss and every gradient under remat "full" and "dots" bitwise
    those under "none" on the card; the forward kernel (B4 or B5) launched
    once a layer under "none" and twice under "full" and "dots" (forward
    and recomputation), its backward once a layer under each."""
    dtype = REMAT_ARCHS[arch]
    cfg = dataclasses.replace(get_arch(arch, reduced=True), param_dtype=dtype,
                              compute_dtype=dtype)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    batch = mamba2_batch(cfg, dev, B=2, S=64)
    fwd, bwd = (SSD_SCAN, SSD_SCAN_BWD) if cfg.family == "ssm" else (
        FLASH_ATTENTION, FLASH_ATTENTION_BWD)
    runs = {}
    for mode in ("none", "full", "dots"):
        model.cfg = dataclasses.replace(cfg, remat=mode)
        counts = (fwd.launches, bwd.launches)
        loss, grads = mamba2_grads(model, batch)
        torch.cuda.synchronize()
        assert (fwd.launches - counts[0], bwd.launches - counts[1]) == (
            cfg.n_layers * (1 if mode == "none" else 2), cfg.n_layers), mode
        runs[mode] = (loss, grads)
    loss, grads = runs["none"]
    assert torch.isfinite(loss)
    for mode in ("full", "dots"):
        assert torch.equal(runs[mode][0], loss), mode
        for name, g in grads.items():
            assert torch.equal(runs[mode][1][name], g), (mode, name)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-235b-a22b"])
def test_chunked_prefill_on_card_matches_cpu(dev, arch):
    """prefill_chunks=2 at reduced width, float32: 4 prompts prefilled as
    2 slices of 2 on the card (B4 once a layer a slice) against the same
    model and slices on the CPU, logits and every cache leaf within 2e-4
    of the largest value."""
    cfg = dataclasses.replace(get_arch(arch, reduced=True), prefill_chunks=2)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 64), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    launches = FLASH_ATTENTION.launches
    logits, cache = model.prefill(toks)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == launches + 2 * cfg.n_layers
    assert logits.shape == (4, cfg.vocab) and cache["k"].shape[1] == 4
    got = [t.cpu() for t in (logits, *cache.values())]
    del logits, cache
    cpu = model.to("cpu")
    ref, ref_cache = cpu.prefill(toks.cpu())
    for g, want in zip(got, (ref, *ref_cache.values())):
        scale = float(want.abs().max())
        torch.testing.assert_close(g, want, atol=2e-4 * scale, rtol=0)


def test_sanitized_guard_fires_on_a_hidden_sync_and_passes_device_get(dev):
    """Inside ``sanitized()`` a ``.item()`` on a card tensor (a hidden
    sync) raises, while ``device_get``, the sanctioned end-of-trace pull,
    passes; the previous sync debug mode comes back after the block."""
    from repro_torch.analysis.sanitize import sanitized
    from repro_torch.engine.runner import device_get

    x = torch.arange(4, dtype=torch.float32, device=dev)
    before = torch.cuda.get_sync_debug_mode()
    with sanitized(debug_nans=False):
        with pytest.raises(RuntimeError, match="synchronizing"):
            x.sum().item()
        host = device_get({"x": x, "n": torch.full((), 3, dtype=torch.int32, device=dev)})
    np.testing.assert_array_equal(host["x"], np.arange(4, dtype=np.float32))
    assert host["n"] == 3
    assert torch.cuda.get_sync_debug_mode() == before


def test_sanitized_catches_a_nan_on_the_card_at_the_block_exit(dev):
    """A NaN made on the card raises FloatingPointError at the block's exit
    (the flag read through the sanctioned path, the guard armed inside),
    naming the op that made it."""
    from repro_torch.analysis.sanitize import sanitized

    x = torch.full((8,), -1.0, device=dev)
    with pytest.raises(FloatingPointError, match="aten.log"):
        with sanitized():
            y = torch.log(x)
            y * 2.0
    with sanitized():  # no NaN: the exit's read passes the armed guard
        torch.exp(x)


def test_warm_fused_simulate_runs_sanitized(dev):
    """The Tao fused route, warm (its geometry captured), inside
    ``sanitized(compile_budget=0)`` with the sync guard armed and NaNs
    checked: no hidden sync, no capture, no NaN, one B1 launch a batch, and
    the results the same as outside the block."""
    from repro_torch.analysis.sanitize import sanitized

    engine = graph_engine(dev, batch_size=32)
    trace = run_functional(get_benchmark("dee"), 20000)
    ref = engine.simulate(trace)
    short_ref = engine.simulate(trace[:9001])
    fused = FUSED_FEATURES.launches
    with sanitized(compile_budget=0):
        got = engine.simulate(trace)
        short = engine.simulate(trace[:9001])
    w = engine.cfg.window
    assert FUSED_FEATURES.launches - fused == -(-(20000 // w) // 32) + -(-(9001 // w) // 32)
    assert_graph_equals_eager(got, ref, 32)
    assert_graph_equals_eager(short, short_ref, 32)


def chip_smoke_module():
    """``chip_smoke.py``, at the repo's root, as a module (its ``main`` not
    run)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# last in the file, so that it runs where the file's process is oldest
def test_profile_prefix_keeps_every_record_of_a_known_loop(dev):
    """torch.profiler on the card can lose the first kernel records of a
    session, more the longer the process has run (in chip_smoke.py's later
    phases one B4 launch of a prefill's 24, one B5 launch of a train step's
    96).  300 known launches, profiled as chip_smoke's ``profile_breakdown``
    profiles, without ``profile_prefix`` and with it: the session opened by
    the prefix counts all 300 and keeps some of the prefix's own records
    (``prefix_left`` raises where it kept none); the loss without the
    prefix is printed."""
    smoke = chip_smoke_module()
    probe = smoke.prefix_probe(300)
    print("prefix_probe", probe)
    assert probe["lost_with_prefix"] == 0
    assert 0 <= probe["prefix_records_lost"] < smoke.PROFILE_PREFIX_KERNELS
    assert 0 <= probe["lost_without_prefix"] <= 300
