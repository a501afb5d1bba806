"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import).  This file imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The fused feature kernel is held BITWISE to its plain version and to the
NumPy specification (copies, int64 deltas rounded to float32 through
float64, and the signed-log in individually rounded float32 ops on every
side); attention within atol = rtol = 1e-5 (float32 on both sides, online
vs full-matrix softmax: only the summation order differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.features import FeatureConfig, extract_features  # noqa: E402
from repro_torch.kernels.attention.kernel import FLASH_ATTENTION, flash_attention_cuda  # noqa: E402
from repro_torch.kernels.attention.ref import attention_plain  # noqa: E402
from repro_torch.kernels.features.ops import trace_columns  # noqa: E402
from repro_torch.kernels.fused.kernel import FUSED_FEATURES, fused_features_cuda  # noqa: E402
from repro_torch.kernels.fused.ops import fused_feature_columns, init_fused_state  # noqa: E402
from repro_torch.kernels.fused.ref import fused_features_plain  # noqa: E402
from repro_torch.uarch import get_benchmark, run_functional  # noqa: E402
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


# (B, H, Sq, Sk, D, Dv, causal, q_offset, segmented)
ATTN_CASES = {
    "tao": (64, 4, 129, 129, 32, 32, True, 0, False),
    "noncausal_odd_dims": (2, 3, 70, 70, 20, 40, False, 0, False),
    "wide_heads": (2, 2, 100, 100, 128, 128, True, 0, False),
    "dv96_segments": (2, 2, 65, 65, 64, 96, True, 0, True),
    "decode_q_offset": (3, 2, 9, 140, 32, 32, True, 131, False),
    "rows_past_sk": (2, 2, 40, 129, 32, 48, False, 100, True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_kernel_matches_plain(dev, case):
    B, H, Sq, Sk, D, Dv, causal, off, segmented = ATTN_CASES[case]
    g = torch.Generator().manual_seed(sorted(ATTN_CASES).index(case))
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


def test_attention_kernel_refuses_wide_heads(dev):
    q = torch.zeros(1, 1, 4, 129, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q, q, q)
