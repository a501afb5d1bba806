"""Feature extraction of the port, bitwise against the reference.

Every feature value is either an exact copy ({0, ±1}), an int64 address
delta rounded to float32 through float64 (as the NumPy specification does),
or the signed-log of one — evaluated as a fixed sequence of individually
rounded float32 ops — so the comparisons here are BITWISE (float32 bit
patterns), never within a tolerance:

  * the torch ``signed_log`` == the NumPy specification's;
  * the port's NumPy ``extract_features`` / ``extract_features_reference``
    == the reference's;
  * the plain version of the fused CUDA kernel == the reference's fused
    Pallas kernel (``fused_feature_columns``, interpret mode) and its scan
    oracle (``fused_scan_ref``) over three state-threaded slices, on
    collision-heavy buckets, empty queues and traces without memory ops
    (the reference's int32 queue compared by value with the port's int64);
  * past the reference's int32 address window, the plain version == the
    NumPy specification;
  * the fused state is functional: a pass leaves the state it was given
    unchanged, so passing it again gives the same result;
  * the CUDA source's constants == the Python constants it hard-codes.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import features as ref_features  # noqa: E402
from repro.kernels.features import ops as ref_ops  # noqa: E402
from repro.kernels.fused import ops as ref_fused  # noqa: E402
from repro.kernels.fused.ref import fused_scan_ref, init_state_ref  # noqa: E402
from repro.uarch import get_benchmark, run_functional  # noqa: E402
from repro.uarch.isa import FUNC_TRACE_DTYPE, Op  # noqa: E402

from repro_torch.core import features as port_features  # noqa: E402
from repro_torch.kernels.features import ops as port_ops  # noqa: E402
from repro_torch.kernels.fused import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.fused.ops import (  # noqa: E402
    FusedExtractor,
    fused_feature_columns,
    init_fused_state,
)
from repro_torch.kernels.fused.ref import fused_scan_plain  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
FIELDS = ("regbits", "flags", "brhist", "memdist")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, ref, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    assert got.dtype == ref.dtype, (msg, got.dtype, ref.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=msg)


def random_trace(n, rng, branch_p=0.4, mem_p=0.4, pc_mod=64, addr_hi=1 << 20):
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


def torch_cols(cols):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cols.items()}


# ---------------------------------------------------------------------------
# signed-log and the NumPy specification
# ---------------------------------------------------------------------------


def test_signed_log_bitwise():
    rng = np.random.default_rng(0)
    edges = np.array(
        [0, 1, -1, 2, -2, 3, 7, 8, 2**24, 2**24 + 1, 2**30, -(2**30), 2**31 - 1, -(2**31) + 1],
        np.int64,
    )
    d = np.concatenate([edges, rng.integers(-(2**31) + 1, 2**31, 20000), rng.integers(-512, 512, 2000)])
    ref = ref_features.signed_log(d.astype(np.float64))
    assert_bitwise(port_features.signed_log(d.astype(np.float64)), ref, "numpy twin")
    assert_bitwise(port_ops.signed_log(torch.from_numpy(d.astype(np.int32))), ref, "torch")


def test_cuda_source_constants_match_python():
    """The kernel hard-codes float32 bit patterns and opcode ids."""
    src = (CSRC / "fused_features.cu").read_text()
    bits = {m[0]: int(m[1], 16) for m in re.findall(r"#define SL_(\w+) (0x[0-9a-f]+)u", src)}
    assert bits.pop("SQRT2") == int(np.float32(ref_features.SIGNED_LOG_SQRT2).view(np.uint32))
    for k, c in zip((1, 3, 5, 7, 9, 11, 13), ref_features.SIGNED_LOG_COEFFS):
        assert bits.pop(f"C{k}") == int(np.float32(c).view(np.uint32)), k
    assert not bits
    ops = dict(re.findall(r"constexpr int kOp(\w+) = (\d+);", src))
    assert {k.upper(): int(v) for k, v in ops.items()} == {
        "FALU": int(Op.FALU), "FMUL": int(Op.FMUL), "FDIV": int(Op.FDIV)
    }


@pytest.mark.parametrize("bench", ["dee", "lee", "mcf"])
def test_numpy_extraction_matches_reference(bench):
    t = run_functional(get_benchmark(bench), 3000)
    for fcfg in (port_features.FeatureConfig(n_buckets=16, n_queue=4, n_mem=8),
                 port_features.FeatureConfig()):
        rcfg = ref_features.FeatureConfig(fcfg.n_buckets, fcfg.n_queue, fcfg.n_mem)
        ref = ref_features.extract_features(t, rcfg)
        for fn in (port_features.extract_features, port_features.extract_features_reference):
            got = fn(t, fcfg)
            for f in ("opcode",) + FIELDS:
                assert_bitwise(getattr(got, f), getattr(ref, f), f"{fn.__name__}/{f}")


def test_trace_columns_match_reference():
    """The same columns, except that ``addr`` stays int64: the reference
    narrows it to int32 (and refuses |addr| >= 2^30), the port keeps every
    address exact."""
    fcfg = port_features.FeatureConfig()
    rcfg = ref_features.FeatureConfig()
    t = run_functional(get_benchmark("mcf"), 2000)
    got, ref = port_ops.trace_columns(t, fcfg), ref_ops.trace_columns(t, rcfg)
    assert list(got) == list(ref)
    for k in got:
        if k == "addr":
            assert got[k].dtype == np.int64
            np.testing.assert_array_equal(got[k], ref[k].astype(np.int64))
        else:
            assert_bitwise(got[k], ref[k], k)
    big = t.copy()
    big["addr"][5] = ref_ops.ADDR_EXACT_LIMIT
    big["addr"][6] = -(1 << 60)
    assert ref_ops.trace_columns(big, rcfg) is None
    np.testing.assert_array_equal(port_ops.trace_columns(big, fcfg)["addr"], big["addr"])


# ---------------------------------------------------------------------------
# The plain version of the fused kernel vs the reference's fused kernel
# ---------------------------------------------------------------------------

# (feature config, trace maker, slice lengths); three slices thread the state
GEOMETRIES = {
    "benchmark": (
        (32, 4, 8),
        lambda: run_functional(get_benchmark("dee"), 2500),
        (700, 900, 900),
    ),
    "collision_heavy": (
        (4, 4, 8),
        lambda: random_trace(1500, np.random.default_rng(1), branch_p=0.8, mem_p=0.15, pc_mod=8),
        (1, 600, 899),
    ),
    "no_memory_ops": (
        (16, 8, 8),
        lambda: random_trace(900, np.random.default_rng(2), mem_p=0.0),
        (300, 300, 300),
    ),
    "no_branches_deep_queue": (
        (16, 4, 64),
        lambda: random_trace(900, np.random.default_rng(3), branch_p=0.0, mem_p=0.05),
        (50, 350, 500),
    ),
}


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_fused_plain_matches_reference_kernel_threaded(geom):
    (nb, nq, nm), make, slices = GEOMETRIES[geom]
    t = make()
    fcfg = port_features.FeatureConfig(nb, nq, nm)
    rcfg = ref_features.FeatureConfig(nb, nq, nm)
    cols = port_ops.trace_columns(t, fcfg)
    state = init_fused_state(fcfg, device="cpu")
    ref_state = ref_fused.init_fused_state(rcfg)
    launches = port_kernel.FUSED_FEATURES.launches
    lo = 0
    for m in slices:
        sl = {k: v[lo : lo + m] for k, v in cols.items()}
        got, state = fused_feature_columns(torch_cols(sl), state, fcfg)
        ref, ref_state = ref_fused.fused_feature_columns(sl, ref_state, rcfg, chunk=128)
        for f in ("opcode",) + FIELDS:
            assert_bitwise(got[f], ref[f], f"{geom}@{lo}/{f}")
        assert_bitwise(state["table"], ref_state["table"], "table")
        assert_bitwise(state["mq"], np.asarray(ref_state["mq"]).astype(np.int64), "mq")
        lo += m
    # the CPU path is the plain version: no kernel launch
    assert port_kernel.FUSED_FEATURES.launches == launches


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_fused_scan_plain_matches_scan_oracle(geom):
    """Raw deltas and the explicit state against the lax.scan oracle,
    starting from a nonzero carry."""
    (nb, nq, nm), make, slices = GEOMETRIES[geom]
    t = make()
    cols = port_ops.trace_columns(t, port_features.FeatureConfig(nb, nq, nm))
    outcome = np.where(cols["is_branch"], np.where(cols["taken"], 1.0, -1.0), 0.0).astype(np.float32)
    rng = np.random.default_rng(5)
    table = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(nb, nq))
    queue = rng.integers(-(1 << 20), 1 << 20, nm).astype(np.int32)
    fill = np.int32(nm // 2)
    state_ref = (jnp.asarray(table), jnp.asarray(queue), jnp.int32(fill))
    mq = torch.from_numpy(np.concatenate([queue, [fill]]).astype(np.int64))[None]
    tab = torch.from_numpy(table)
    lo = 0
    for m in slices:
        s = slice(lo, lo + m)
        ref, state_ref = fused_scan_ref(
            cols["bucket"][s], cols["addr"][s], outcome[s],
            cols["is_mem"][s].astype(np.int32), state_ref, n_mem=nm,
        )
        c = torch_cols({k: v[s] for k, v in cols.items()})
        brhist, raw, tab, mq = fused_scan_plain(
            c["bucket"], c["addr"], c["is_branch"], c["taken"], c["is_mem"], tab, mq
        )
        assert_bitwise(brhist, ref["brhist"], f"{geom}/brhist")
        assert_bitwise(raw, ref["memdist_raw"], f"{geom}/memdist_raw")
        assert_bitwise(tab, state_ref[0], f"{geom}/table")
        assert_bitwise(mq[0, :nm], np.asarray(state_ref[1]).astype(np.int64), f"{geom}/queue")
        assert int(mq[0, nm]) == int(state_ref[2])
        lo += m


def test_extractor_batches_equal_numpy_spec():
    """Uneven batches through FusedExtractor (state threaded) == the NumPy
    specification over the whole trace; the padded tail is inert."""
    fcfg = port_features.FeatureConfig(n_buckets=32, n_queue=4, n_mem=8)
    t = random_trace(3000, np.random.default_rng(11))
    spec = port_features.extract_features(t, fcfg, with_labels=False)
    ex = FusedExtractor(port_ops.trace_columns(t, fcfg), fcfg, pad_to=3300, device="cpu")
    batches = [ex.next_batch(m) for m in (700, 700, 700, 700, 500)]
    for f in ("opcode",) + FIELDS:
        got = torch.cat([b[f] for b in batches])[:3000]
        assert_bitwise(got, getattr(spec, f), f)
    assert torch.equal(torch.cat([b["is_mem"] for b in batches])[:3000], torch.from_numpy(t["is_mem"]))
    with pytest.raises(ValueError):
        ex.next_batch(301)
    with pytest.raises(ValueError):
        FusedExtractor(port_ops.trace_columns(t, fcfg), fcfg, pad_to=100, device="cpu")


@pytest.mark.parametrize("addr_hi", [1 << 31, 1 << 62], ids=["past_int32", "near_int64_edge"])
def test_fused_plain_wide_addresses_match_numpy_spec(addr_hi):
    """Addresses the reference's fused kernel cannot take (its int32 deltas
    need |addr| < 2^30): over three threaded slices the plain version still
    equals the NumPy specification, int64 delta -> float64 -> float32,
    including deltas that wrap in int64 as NumPy's do."""
    fcfg = port_features.FeatureConfig(n_buckets=16, n_queue=4, n_mem=8)
    t = random_trace(2400, np.random.default_rng(17), addr_hi=addr_hi)
    spec = port_features.extract_features(t, fcfg, with_labels=False)
    cols = torch_cols(port_ops.trace_columns(t, fcfg))
    state = init_fused_state(fcfg, device="cpu")
    got = []
    for lo, hi in ((0, 900), (900, 1700), (1700, 2400)):
        feats, state = fused_feature_columns({k: v[lo:hi] for k, v in cols.items()}, state, fcfg)
        got.append(feats)
    for f in FIELDS:
        assert_bitwise(torch.cat([g[f] for g in got]), getattr(spec, f), f)
    assert np.abs(spec.memdist).max() > np.abs(port_features.signed_log(np.float64(2**31)))


def test_fused_state_is_functional():
    """A pass reads its state and returns a new one: the same state passed
    twice gives the same features and the same outgoing state, and is left
    as it was."""
    fcfg = port_features.FeatureConfig(n_buckets=8, n_queue=4, n_mem=8)
    t = random_trace(1200, np.random.default_rng(23), pc_mod=16)
    cols = torch_cols(port_ops.trace_columns(t, fcfg))
    first = {k: v[:500] for k, v in cols.items()}
    second = {k: v[500:] for k, v in cols.items()}
    _, state = fused_feature_columns(first, init_fused_state(fcfg, device="cpu"), fcfg)
    kept = {k: v.clone() for k, v in state.items()}
    a, out_a = fused_feature_columns(second, state, fcfg)
    b, out_b = fused_feature_columns(second, state, fcfg)
    for k in kept:
        assert torch.equal(state[k], kept[k]), k
        assert torch.equal(out_a[k], out_b[k]), k
    assert not torch.equal(out_a["table"], state["table"])
    for f in FIELDS:
        assert_bitwise(a[f], b[f].numpy(), f)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel binding launches or raises: a CPU tensor is refused (the
    plain version is taken one level up, by ``fused_feature_columns``)."""
    fcfg = port_features.FeatureConfig(n_buckets=8, n_queue=4, n_mem=8)
    t = random_trace(64, np.random.default_rng(3))
    st = init_fused_state(fcfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.fused_features_cuda(
            torch_cols(port_ops.trace_columns(t, fcfg)), st["table"], st["mq"]
        )
