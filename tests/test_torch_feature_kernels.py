"""The staged whole-trace feature path of the port, bitwise against the
reference.

The port's ``branch_history_scan`` / ``memdist_feature_scan`` (on the
CPU: the plain versions of ``csrc/feature_scans.cu``) and the raw deltas
under the latter (``memdist_delta_plain``) against the reference's scan
oracles (``repro.kernels.features.ref``), its Pallas kernels in interpret
mode (``repro.kernels.features.ops``, ``interpret=True``; the memory
features against the reference's ``signed_log_device`` of its Pallas scan)
and the NumPy specification, and the port's ``extract_features_device``
against the reference's and the NumPy specification.  Every value is a
copy ({0, ±1}), an int64 delta rounded to float32 through float64, or the
signed-log of one in
individually rounded float32 ops, so every comparison is BITWISE.  The
cases mirror ``tests/test_feature_kernels.py``: benchmark traces,
collision-heavy bucket counts (1, 2 and the non-power-of-two 3), empty
queues, all-branch traces of one or two buckets around the card's rank
tile, a memory-heavy trace with negative, zero and duplicate deltas,
labels passed through from an adjusted trace, deltas where the
signed-log's rounding is tight — and, past the reference's int32 window
(where it raises by design), wide addresses against the NumPy
specification.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import features as ref_features  # noqa: E402
from repro.kernels.features import ops as ref_ops  # noqa: E402
from repro.kernels.features.ref import branch_history_scan_ref, memdist_delta_scan_ref  # noqa: E402
from repro.uarch import get_benchmark, run_functional  # noqa: E402
from repro.uarch.isa import FUNC_TRACE_DTYPE, Op  # noqa: E402

from repro_torch.core import features as port_features  # noqa: E402
from repro_torch.core.dataset import INPUT_KEYS  # noqa: E402
from repro_torch.kernels.features import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.features import ops as port_ops  # noqa: E402
from repro_torch.kernels.features import ref as port_ref  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
FIELDS = ("opcode", "regbits", "flags", "brhist", "memdist")


def assert_bitwise(got, ref, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    assert got.dtype == ref.dtype, (msg, got.dtype, ref.dtype)
    if got.dtype == np.float32:
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=msg)


def random_trace(n, rng, branch_p=0.4, mem_p=0.4, pc_mod=64, addr_hi=1 << 20, addr_lo=0):
    t = np.zeros(n, dtype=FUNC_TRACE_DTYPE)
    t["pc"] = rng.integers(0, pc_mod, n) * 4
    t["opcode"] = rng.integers(0, len(Op), n)
    t["dst"] = rng.integers(0, 32, n)
    t["src1"] = rng.integers(0, 32, n)
    t["src2"] = rng.integers(0, 32, n)
    t["is_branch"] = rng.random(n) < branch_p
    t["taken"] = rng.random(n) < 0.5
    t["is_mem"] = (rng.random(n) < mem_p) & ~t["is_branch"]
    t["is_store"] = t["is_mem"] & (rng.random(n) < 0.5)
    t["addr"] = np.where(t["is_mem"], rng.integers(addr_lo, addr_hi, n), 0)
    return t


def configs(shape):
    return port_features.FeatureConfig(*shape), ref_features.FeatureConfig(*shape)


def assert_scans_match_reference(trace, shape, msg, chunk=256):
    """The port's scans (plain, CPU) against the reference's oracle and its
    Pallas kernels in interpret mode, from the reference's columns: the
    raw deltas to the reference's raw scans, the memory features to the
    reference's signed-log of its Pallas scan and the NumPy
    specification's ``memdist``."""
    pcfg, rcfg = configs(shape)
    cols = ref_ops.trace_columns(trace, rcfg)
    assert cols is not None, "the reference takes |addr| < 2^30 only"
    outcome = np.where(cols["is_branch"], np.where(cols["taken"], 1.0, -1.0), 0.0).astype(np.float32)
    mem = cols["is_mem"].astype(np.int32)
    launches = (port_kernel.BRANCH_HISTORY.launches, port_kernel.MEMDIST_DELTA.launches)
    br = port_ops.branch_history_scan(cols["bucket"], outcome, n_buckets=pcfg.n_buckets, n_queue=pcfg.n_queue)
    md = port_ref.memdist_delta_plain(torch.as_tensor(cols["addr"].astype(np.int64)),
                                      torch.as_tensor(cols["is_mem"]), pcfg.n_mem)
    mf = port_ops.memdist_feature_scan(cols["addr"].astype(np.int64), cols["is_mem"], n_mem=pcfg.n_mem)
    kw = dict(n_buckets=rcfg.n_buckets, n_queue=rcfg.n_queue)
    assert_bitwise(br, branch_history_scan_ref(cols["bucket"], outcome, **kw), f"{msg}/brhist oracle")
    assert_bitwise(br, ref_ops.branch_history_scan(cols["bucket"], outcome, chunk=chunk, interpret=True, **kw),
                   f"{msg}/brhist pallas")
    assert_bitwise(md, memdist_delta_scan_ref(cols["addr"], mem, n_mem=rcfg.n_mem), f"{msg}/memdist oracle")
    md_pallas = ref_ops.memdist_delta_scan(cols["addr"], mem, n_mem=rcfg.n_mem, chunk=chunk, interpret=True)
    assert_bitwise(md, md_pallas, f"{msg}/memdist pallas")
    assert_bitwise(mf, ref_ops.signed_log_device(md_pallas), f"{msg}/memdist features pallas")
    assert_bitwise(mf, ref_features.extract_features(trace, rcfg, with_labels=False).memdist,
                   f"{msg}/memdist features numpy spec")
    # the CPU route is the plain version: no kernel launch
    assert (port_kernel.BRANCH_HISTORY.launches, port_kernel.MEMDIST_DELTA.launches) == launches


def assert_extraction_matches_reference(trace, shape, msg, with_labels=False):
    """``extract_features_device`` against the reference's (Pallas, interpret
    mode) and the reference's NumPy interpreter loop."""
    pcfg, rcfg = configs(shape)
    got = port_ops.extract_features_device(trace, pcfg, with_labels=with_labels, device="cpu")
    refs = {
        "pallas": ref_ops.extract_features_device(trace, rcfg, with_labels=with_labels, chunk=256),
        "numpy_loop": ref_features.extract_features_reference(trace, rcfg, with_labels=with_labels),
    }
    for name, ref in refs.items():
        for f in FIELDS:
            assert_bitwise(getattr(got, f), getattr(ref, f), f"{msg}/{name}/{f}")
    return got, refs["numpy_loop"]


@pytest.mark.parametrize("bench", ["mcf", "dee", "lee"])
@pytest.mark.parametrize("shape", [(32, 4, 8), (2, 3, 2)], ids=["32x4x8", "2x3x2"])
def test_scans_and_extraction_match_reference_on_benchmarks(bench, shape):
    trace = run_functional(get_benchmark(bench), 2500)
    assert_scans_match_reference(trace, shape, bench)
    assert_extraction_matches_reference(trace, shape, bench)


@pytest.mark.parametrize("shape", [(1, 4, 4), (2, 8, 4), (3, 5, 4)], ids=["nb1", "nb2", "nb3"])
def test_hash_collision_heavy(shape):
    """Many distinct PCs folded into very few buckets: histories mix exactly
    as the per-branch interpreter loop mixes them, in trace order."""
    trace = random_trace(4000, np.random.default_rng(3), branch_p=0.8, mem_p=0.15, pc_mod=512)
    assert_scans_match_reference(trace, shape, f"nb={shape[0]}", chunk=512)
    assert_extraction_matches_reference(trace, shape, f"nb={shape[0]}")


EDGE_CASES = {
    "no_branches": (300, dict(branch_p=0.0, mem_p=0.5)),
    "no_memory_ops": (300, dict(branch_p=0.5, mem_p=0.0)),
    "neither": (300, dict(branch_p=0.0, mem_p=0.0)),
    "single": (1, {}),
    "pair": (2, {}),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_empty_queue_boundaries(case):
    """First-branch / first-access rows see empty queues; traces without
    branches or memory ops stay all zero there."""
    n, kw = EDGE_CASES[case]
    trace = random_trace(n, np.random.default_rng(sorted(EDGE_CASES).index(case)), **kw)
    assert_scans_match_reference(trace, (4, 3, 3), case, chunk=64)
    got, _ = assert_extraction_matches_reference(trace, (4, 3, 3), case)
    if not trace["is_branch"].any():
        assert not got.brhist.any()
    if trace["is_mem"].sum() < 2:
        assert not got.memdist.any()


@pytest.mark.parametrize("addr_hi", [1 << 24, 48], ids=["spread", "duplicates"])
def test_memory_heavy_negative_zero_duplicate_deltas(addr_hi):
    trace = random_trace(2000, np.random.default_rng(11), branch_p=0.3, mem_p=0.7, addr_hi=addr_hi)
    assert_scans_match_reference(trace, (16, 6, 12), "memory_heavy")
    got, _ = assert_extraction_matches_reference(trace, (16, 6, 12), "memory_heavy")
    assert (got.memdist < 0).any() and (got.memdist > 0).any()
    mem_rows = got.memdist[trace["is_mem"]][12:]  # full queues: every slot valid
    assert (mem_rows == 0).any() == (addr_hi == 48)  # zero deltas only from duplicates


def edge_delta_trace(k_max, rng, huge=False):
    """Memory ops at every other position, at ``signed_log_edge_addresses``;
    branches and other ops fill the positions between."""
    addr = port_ref.signed_log_edge_addresses(k_max, huge)
    t = random_trace(2 * len(addr), rng, mem_p=0.0)
    t["is_mem"][::2], t["is_branch"][::2], t["addr"][::2] = True, False, addr
    return t


@pytest.mark.parametrize("wide", [False, True], ids=["int32_deltas", "int64_deltas"])
def test_memdist_features_at_tight_rounding_deltas(wide):
    """Deltas whose signed-log rounds tightly (1 + |d| next to sqrt(2) in
    float32), huge and wrapping deltas, and zero deltas: the memory
    feature scan is bitwise the NumPy specification's ``memdist`` (and, inside the
    reference's int32 window, its Pallas scan with ``signed_log_device``);
    a zero delta gives +0 and a negative one keeps its sign."""
    shape = (8, 4, 6)
    trace = edge_delta_trace(63 if wide else 30, np.random.default_rng(21), huge=wide)
    pcfg, rcfg = configs(shape)
    if not wide:
        assert_scans_match_reference(trace, shape, "tight_rounding", chunk=128)
    addr, is_mem = np.ascontiguousarray(trace["addr"]), np.ascontiguousarray(trace["is_mem"])
    got = port_ops.memdist_feature_scan(addr, is_mem, n_mem=pcfg.n_mem)
    spec = port_features.extract_features(trace, pcfg, with_labels=False).memdist
    assert_bitwise(got, spec, "tight_rounding")
    raw = port_ref.memdist_delta_plain(torch.from_numpy(addr), torch.from_numpy(is_mem), pcfg.n_mem).numpy()
    mem_idx = np.nonzero(trace["is_mem"])[0]
    valid = np.zeros(raw.shape, dtype=bool)  # slot k of the access of rank r holds a delta while k < r
    valid[mem_idx] = np.arange(pcfg.n_mem)[None, :] < np.arange(len(mem_idx))[:, None]
    bits = got.numpy().view(np.int32)
    assert (valid & (raw == 0)).any() and (bits[valid & (raw == 0)] == 0).all()  # +0, not -0
    assert ((got.numpy() < 0) == (raw < 0)).all() and (raw < 0).any()
    assert (np.abs(raw) >= (2.0**62 if wide else 2.0**29)).any()


def test_labels_pass_through_from_adjusted_trace(small_tao_setup):
    """An adjusted trace built by the reference (``build_adjusted_trace``)
    and handed over as a NumPy array: features bitwise and labels equal."""
    cfg, _, al, _ = small_tao_setup
    fc = cfg.features
    got, ref = assert_extraction_matches_reference(
        al.adjusted, (fc.n_buckets, fc.n_queue, fc.n_mem), "adjusted", with_labels=True)
    assert got.labels is not None and sorted(got.labels) == sorted(ref.labels)
    for k, v in ref.labels.items():
        assert_bitwise(got.labels[k], v, f"labels/{k}")
    assert port_ops.extract_features_device(al.adjusted, with_labels=False, device="cpu").labels is None


@pytest.mark.parametrize("addr_hi", [1 << 31, 1 << 62], ids=["past_int32", "near_int64_edge"])
def test_wide_addresses_match_numpy_spec(addr_hi):
    """Where the reference raises by design (|addr| >= 2^30), the port's
    int64 deltas equal the NumPy specification's, including deltas that
    wrap in int64 as NumPy's do."""
    trace = random_trace(2400, np.random.default_rng(17), addr_lo=-addr_hi, addr_hi=addr_hi)
    pcfg, rcfg = configs((16, 4, 8))
    with pytest.raises(ValueError, match="2\\^30"):
        ref_ops.extract_features_device(trace, rcfg, with_labels=False)
    spec = port_features.extract_features(trace, pcfg, with_labels=False)
    got = port_ops.extract_features_device(trace, pcfg, with_labels=False, device="cpu")
    for f in FIELDS:
        assert_bitwise(getattr(got, f), getattr(spec, f), f)
    assert np.abs(spec.memdist).max() > np.abs(port_features.signed_log(np.float64(2**31)))


def test_device_feature_arrays_layout():
    """What the engine's staged route reads: every input key plus the bool
    masks, one length, on the requested device; an empty trace gives
    empty arrays."""
    pcfg, _ = configs((8, 4, 8))
    trace = random_trace(500, np.random.default_rng(2))
    arrays = port_ops.device_feature_arrays(port_ops.trace_columns(trace, pcfg), pcfg, device="cpu")
    assert sorted(arrays) == sorted(INPUT_KEYS + ("is_branch", "is_mem"))
    widths = {"opcode": (), "regbits": (32,), "flags": (5,), "brhist": (4,), "memdist": (8,),
              "is_branch": (), "is_mem": ()}
    for k, v in arrays.items():
        assert v.device.type == "cpu" and tuple(v.shape) == (500,) + widths[k], k
    assert arrays["opcode"].dtype == torch.int32
    assert arrays["is_branch"].dtype == arrays["is_mem"].dtype == torch.bool
    assert_bitwise(arrays["is_mem"], trace["is_mem"], "is_mem")
    empty = port_ops.device_feature_arrays(port_ops.trace_columns(trace[:0], pcfg), pcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in empty.items()} == {k: (0,) + w for k, w in widths.items()}


def test_scans_take_any_queue_depth():
    """The kernels keep no queue slot per lane: depths past 32 are taken,
    and the plain versions agree with the reference's oracle there."""
    trace = random_trace(1500, np.random.default_rng(5), pc_mod=16)
    assert_scans_match_reference(trace, (4, 40, 70), "deep_queues")


def test_scans_take_more_than_8192_buckets():
    """Past 8,192 buckets the plain versions agree with the reference's
    oracle and its Pallas kernels (the card's cases at 20,000 and 60,000
    buckets are in tests/test_torch_cuda.py)."""
    trace = random_trace(1200, np.random.default_rng(9), branch_p=0.6, pc_mod=40_000)
    assert_scans_match_reference(trace, (9000, 4, 8), "many_buckets")


def tile_edge_trace(n, alternate, rng):
    """Every position a branch: at pc 0 (bucket 0), or at pcs 0 and 4 in
    turn (buckets 0 and 1 of two)."""
    t = random_trace(n, rng, branch_p=1.0, mem_p=0.0, pc_mod=1)
    if alternate:
        t["pc"] = np.arange(n) % 2 * 4
    return t


# trace lengths around the card's branch rank tile: one short, one full,
# one past, and a lone position after three tiles
TILE_EDGE_LENGTHS = tuple(port_kernel.BR_TILE * k + d for k, d in ((1, -1), (1, 0), (1, 1), (3, 1)))


@pytest.mark.parametrize("alternate", [False, True], ids=["one_bucket", "two_buckets"])
@pytest.mark.parametrize("n", TILE_EDGE_LENGTHS)
def test_branch_history_at_rank_tile_edges(n, alternate):
    """Where the card's rank walk and placement pass can go wrong: one
    bucket spanning tiles with all 32 lanes in one group at every step, or
    two buckets in turn, at lengths around a tile.  The plain version
    against the reference's oracle and its Pallas scan (the card's cases
    are in tests/test_torch_cuda.py)."""
    trace = tile_edge_trace(n, alternate, np.random.default_rng(n))
    assert_scans_match_reference(trace, (2, 8, 4), f"tile_edge/{n}/{'two' if alternate else 'one'}")


def test_wrappers_refuse_cpu_tensors_and_bad_sizes():
    """The kernel bindings launch or raise: a CPU tensor is refused (the
    plain version is taken one level up, by the ``*_scan`` dispatchers), as
    are sizes the kernels cannot take."""
    bucket = torch.zeros(16, dtype=torch.int32)
    outcome = torch.ones(16, dtype=torch.float32)
    addr = torch.zeros(16, dtype=torch.int64)
    mem = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.branch_history_cuda(bucket, outcome, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.memdist_delta_cuda(addr, mem, 8)
    with pytest.raises(ValueError, match="n_buckets"):
        port_kernel.branch_history_cuda(bucket, outcome, 0, 4)
    with pytest.raises(ValueError, match="n_queue"):
        port_kernel.branch_history_cuda(bucket, outcome, 8, 0)
    with pytest.raises(ValueError, match="n_mem"):
        port_kernel.memdist_delta_cuda(addr, mem, 0)


def test_cuda_source_constants_match_python():
    """The wrappers size the kernels' scratch from the source's tiles."""
    src = (CSRC / "feature_scans.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int k(BrTile|MemTile|SmemBuckets) = (\d+);", src)}
    assert consts == {"BrTile": port_kernel.BR_TILE, "MemTile": port_kernel.MEM_TILE,
                      "SmemBuckets": port_kernel.SMEM_BUCKETS}
    assert 1 << int(re.search(r"constexpr int kMaxPositions = 1 << (\d+);", src)[1]) == port_kernel.MAX_POSITIONS


def test_signed_log_source_copies_identical():
    """``feature_scans.cu`` carries verbatim copies of ``fused_features.cu``'s
    signed-log constants and device functions (each library is built from
    its own source alone): the two texts are identical."""
    def pieces(name):
        src = (CSRC / name).read_text()
        defs = re.findall(r"^#define SL_\w+ 0x[0-9a-f]+u$", src, flags=re.M)
        funcs = re.findall(r"^__device__ __forceinline__ float (?:horner_step|signed_log_rn)\(.*?^}$",
                           src, flags=re.M | re.S)
        return defs, funcs

    defs, funcs = pieces("fused_features.cu")
    assert len(defs) == 8 and len(funcs) == 2
    assert pieces("feature_scans.cu") == (defs, funcs)
