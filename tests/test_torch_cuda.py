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
the fine-tune leaves ``embed`` bitwise unchanged.

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

The int8 W8A8 path (``core/quant.py``): quantization on the card is bitwise
the CPU's; ``qdense``'s codes, int32 accumulations (cuBLASLt IMMA through
``torch._int_mm``, zero-padded to its multiples of 8 and past 16 rows) and
float output are bitwise the CPU's at every default-width layer shape and
at 16 rows or fewer: the card's ``addcmul`` is one fused multiply-add, as
the CPU's is.  The int8 step has its own graph, with ``n_layers``
attention nodes, and is held to the eager int8 step as the float32 one
is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.features import FeatureConfig, extract_features, signed_log  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.core.quant import dense_shapes, qdense_device_vs_cpu, quantize_tao_params  # noqa: E402
from repro_torch.engine import EngineConfig, MetricSpec, StreamingEngine, cache_stats  # noqa: E402
from repro_torch.engine.aot import graph_kernel_names  # noqa: E402
from repro_torch.core import build_adjusted_trace, build_windows, multi_metric_loss  # noqa: E402
from repro_torch.core import tao_forward, train_tao_impl, transfer_finetune, warmup_train_step  # noqa: E402
from repro_torch.core.transfer import to_device  # noqa: E402
from repro_torch.kernels.attention.kernel import (  # noqa: E402
    BWD_KERNEL_NAMES,
    FLASH_ATTENTION,
    FLASH_ATTENTION_BWD,
    bwd_launch_info,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
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
from repro_torch.kernels.ssd.kernel import SSD_SCAN, ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd.kernel import launch_info as ssd_launch_info  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_sequential_ref  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.uarch import UARCH_A, get_benchmark, run_detailed, run_functional  # noqa: E402
from repro_torch.uarch.isa import FUNC_TRACE_DTYPE, Op  # noqa: E402

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
}
# each case's own seed: a new case leaves the others' inputs as they were
SSD_SEEDS = {"chunk_96": 0, "full_width": 1, "odd_widths": 2, "reduced_config": 3,
             "two_groups": 4, "chunk_200": 5, "widths_40_72": 6}


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


# ---------------------------------------------------------------------------
# The engine's graphed step
# ---------------------------------------------------------------------------

GRAPH_METRICS = ("cpi", "branch_mpki", "l1d_mpki", "dlevel_hist", "cpi_phase", "l1d_phase")
# float32 per-chunk sums accumulated with atomics (see the module note)
ATOMIC_FLOAT_METRICS = ("cpi_phase",)


def graph_engine(dev, seed=0, **kw):
    cfg = TaoConfig()
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

# every dense layer shape (in, out) of the default TaoConfig
INT8_LAYER_SHAPES = dense_shapes(quantize_tao_params(init_tao(TaoConfig(), device="cpu")))


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


def test_tao_gradients_on_card_match_cpu(dev):
    """``loss.backward()`` through ``tao_forward`` on the card at the
    default width gives every parameter a gradient — the attention
    projection ``qkv`` included, whose gradient comes back through the
    packed q/k/v views and the backward kernel — each within 1e-4 of its
    tensor's largest CPU gradient of the same model's CPU gradient (the
    forward differs in the last bits: cuBLAS and 3xTF32 attention)."""
    cfg = TaoConfig()
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
    n = cpu.num_instructions
    assert gpu.num_instructions == n == (len(trace) // cfg.window) * cfg.window
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


@pytest.mark.parametrize("freeze", [False, True], ids=["all", "headonly"])
def test_graphed_train_equals_eager_step(dev, freeze):
    """Losses, parameters, AdamW state and each epoch's eval (read from
    the state stored back between epochs) bitwise the eager step's; the
    public entry point's run is the graphed one."""
    from repro_torch.core.transfer import _make_step
    from repro_torch.train import AdamWConfig

    cfg = TaoConfig()
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
    from repro_torch.engine.aot import WARMUP_RUNS
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
    n = c.num_instructions
    assert g.num_instructions == n
    flips = {
        "fetch": int((g.fetch_lat != c.fetch_lat).sum()),
        "exec": int((g.exec_lat != c.exec_lat).sum()),
        "mispredict": int(((g.mispred_prob > 0.5) != (c.mispred_prob > 0.5)).sum()),
        "l1d": int(((g.dlevel >= 2) != (c.dlevel >= 2)).sum()),
    }
    assert max(flips.values()) <= 1e-3 * n, flips
    np.testing.assert_allclose(g.mispred_prob, c.mispred_prob, rtol=0, atol=1e-4)
    assert abs(g.total_cycles - c.total_cycles) <= 256.0 * (flips["fetch"] + flips["exec"])
    assert abs(g.branch_mpki - c.branch_mpki) <= 1000.0 * flips["mispredict"] / n + 1e-12
    assert abs(g.l1d_mpki - c.l1d_mpki) <= 1000.0 * flips["l1d"] / n + 1e-12


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
