"""The port's streaming engine against the reference engine.

The reference initializes the weights (converted with ``params_from_jax``);
the same functional traces go through ``repro.engine.StreamingEngine`` and
the port's engine on the CPU, every way the port takes features: from the
raw trace through the fused kernel's path (``"fused"``), precomputed by the
NumPy specification (``"numpy"``, ``simulate(trace, features=FeatureSet)``),
and extracted once for the whole trace by the staged kernels' path
(``"staged"``, ``simulate(trace, features=device_feature_arrays(...))``),
which is held to the reference's ``feature_backend="pallas"``.

``precision="int8"`` (the W8A8 forward of ``core/quant.py``) is held to
the reference's int8 engine on every route, under the contract below with
one more kind of flip: an activation whose float32 value differs by an
ulp can round to the neighbouring int8 code, which moves that position's
logits by a quantization step, so ``mispred_prob`` may differ by more than
1e-5 there (3 of 5,984 positions per trace here, no decode flipped, at
most 0.0044).  Such positions count as flips too, at most 0.1%, and are
held within 0.01.  int8 is never held to
the int8-vs-fp32 band, which the reference's own test does not meet on
random weights.

Host->device prefetch (``prefetch_to_device``) keeps the order of its
batches inline and threaded, raises a producer's error in the consumer,
stops its producer when the consumer closes it and refuses a depth below
1, as the reference's does; the host route is bitwise the same with
``EngineConfig.prefetch`` on and off.  The kernel build cache: a library
found at ``library_path`` under an ``enable_persistent_cache`` directory
is a hit, with no ``nvcc``; ``persistent_cache_status`` has the
reference's keys.

The step cache, the window-grid carry and AOT warmup are held to the
reference's: ``cache_stats()``'s keys, hit and miss counts, the reserved
``"__grid__"`` slot, and the cached entry driven directly.  On the CPU no
CUDA graph exists, so ``warmup`` captures nothing (the graphed step is held
on the card, in test_torch_cuda.py).

Tolerance.  Features are bitwise equal on both sides (see
test_torch_features.py); the model's float32 logits differ in the last
bits (XLA vs torch CPU BLAS summation order).  A decoded value — the argmax
latency bucket, the argmax data level, ``mispred_prob > 0.5`` — can flip
only where two logits nearly tie.  So: at most 0.1% of positions may flip,
``mispred_prob`` agrees within 1e-5, and every metric difference must be
explained by the flips that occurred (a fetch flip moves the cycle sum by
at most 256, the top bucket; a miss count moves by one per flip).  With no
flip, the metrics are equal exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core.dataset import stream_batches as ref_stream_batches  # noqa: E402
from repro.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.engine import MetricSpec as RefMetricSpec  # noqa: E402
from repro.engine import StreamingEngine as RefEngine  # noqa: E402
from repro.engine import cache_stats as ref_cache_stats  # noqa: E402
from repro.engine import clear_step_cache as ref_clear_step_cache  # noqa: E402
from repro.uarch import get_benchmark, run_functional  # noqa: E402

from repro_torch.convert import params_from_jax, qparams_from_jax  # noqa: E402
from repro_torch.core.dataset import num_windows, stream_batches  # noqa: E402
from repro_torch.core.features import FeatureConfig, extract_features  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.core.quant import quantize_tao_params  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    METRIC_REGISTRY,
    EngineConfig,
    build_cache_counters,
    enable_persistent_cache,
    persistent_cache_status,
    prefetch_to_device,
    MetricNotCollectedError,
    MetricNotComputedError,
    MetricSpec,
    SimulationResult,
    StepContext,
    StreamingEngine,
    cache_stats,
    clear_step_cache,
    simulate_trace_engine,
    windowed_spec,
)
from repro_torch.engine.runner import device_get  # noqa: E402
from repro_torch.kernels.features.kernel import BRANCH_HISTORY, MEMDIST_DELTA  # noqa: E402
from repro_torch.kernels.features.ops import device_feature_arrays, trace_columns  # noqa: E402
from repro_torch.kernels.fused.kernel import FUSED_FEATURES  # noqa: E402

FCFG = (64, 4, 8)
MODEL = dict(window=17, d_model=32, n_heads=2, n_layers=1, d_ff=64, d_cat=16)
PORT_CFG = TaoConfig(features=FeatureConfig(*FCFG), **MODEL)
REF_CFG = ref_model.TaoConfig(features=ref_features.FeatureConfig(*FCFG), **MODEL)
METRICS = ("cpi", "branch_mpki", "l1d_mpki", "cpi_phase", "l1d_phase", "dlevel_hist")
TRACE_LEN = 6000
BATCH = 13  # ragged final batch: the padding path runs
FLIP_FRACTION = 1e-3
PROB_ATOL = 1e-5
# int8: a position where an activation took the neighbouring code moved
# mispred_prob by at most 0.0044 here; the reference's own int8 against its
# float32 differs by 0.020-0.021 on these traces, so a step that ran float32
# where int8 was asked for cannot pass
INT8_CODE_FLIP_PROB_ATOL = 1e-2


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(ref_model.init_tao, static_argnums=1)(jax.random.PRNGKey(0), REF_CFG)
    return params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def traces():
    return {b: run_functional(get_benchmark(b), TRACE_LEN) for b in ("dee", "lee")}


@pytest.fixture(scope="module")
def reference(weights, traces):
    params, _ = weights
    eng = RefEngine(params, REF_CFG, RefEngineConfig(batch_size=BATCH, collect=True,
                                                     metrics=METRICS))
    return {b: eng.simulate(t) for b, t in traces.items()}


@pytest.fixture(scope="module")
def reference_pallas(weights, traces):
    """The reference engine on its staged ``"pallas"`` feature backend (the
    Pallas kernels in interpret mode off the TPU)."""
    params, _ = weights
    eng = RefEngine(params, REF_CFG, RefEngineConfig(batch_size=BATCH, collect=True, metrics=METRICS,
                                                     feature_backend="pallas"))
    return {b: eng.simulate(t) for b, t in traces.items()}


@pytest.fixture(scope="module")
def reference_int8(weights, traces):
    """The reference engine under ``precision="int8"`` (its NumPy feature
    backend: every route's features are bitwise the same)."""
    params, _ = weights
    eng = RefEngine(params, REF_CFG, RefEngineConfig(batch_size=BATCH, collect=True, metrics=METRICS,
                                                     precision="int8"))
    return {b: eng.simulate(t) for b, t in traces.items()}


def port_model(weights):
    model = init_tao(PORT_CFG, device="cpu")
    model.load_state_dict(weights[1])
    return model


def port_engine(weights, **kw):
    kw.setdefault("batch_size", BATCH)
    kw.setdefault("metrics", METRICS)
    return StreamingEngine(port_model(weights), PORT_CFG, EngineConfig(**kw), device="cpu")


def port_simulate(engine, trace, backend):
    """``"fused"``: the raw trace; ``"numpy"``: the NumPy features,
    precomputed; ``"staged"``: the whole-trace device feature arrays."""
    if backend == "fused":
        return engine.simulate(trace)
    if backend == "staged":
        fcfg = PORT_CFG.features
        return engine.simulate(trace, features=device_feature_arrays(trace_columns(trace, fcfg), fcfg,
                                                                     device="cpu"))
    return engine.simulate(trace, features=extract_features(trace, PORT_CFG.features, with_labels=False))


def assert_explained_by_flips(got, ref, code_flip_atol=None, window=PORT_CFG.window):
    """``code_flip_atol``: int8 runs, where a position whose activation
    rounded to the neighbouring int8 code may differ in ``mispred_prob`` by
    more than PROB_ATOL; such positions count as flips too, and are held
    within this looser bound.  ``window``: the config's window (a phase
    holds at least one)."""
    n = ref.num_instructions
    assert got.num_instructions == n
    prob_diff = np.abs(got.mispred_prob - ref.mispred_prob)
    code_flips = code_flip_atol is not None
    flipped = {
        "fetch": got.fetch_lat != ref.fetch_lat,
        "exec": got.exec_lat != ref.exec_lat,
        "dlevel": got.dlevel != ref.dlevel,
        "mispredict": (got.mispred_prob > 0.5) != (ref.mispred_prob > 0.5),
        "l1d": (got.dlevel >= 2) != (ref.dlevel >= 2),
        "code": prob_diff > PROB_ATOL if code_flips else np.zeros(n, bool),
    }
    flips = {k: int(v.sum()) for k, v in flipped.items()}
    assert max(flips.values()) <= FLIP_FRACTION * n, flips
    np.testing.assert_allclose(got.mispred_prob, ref.mispred_prob, rtol=0,
                               atol=code_flip_atol if code_flips else PROB_ATOL)
    assert abs(got.total_cycles - ref.total_cycles) <= 256.0 * (flips["fetch"] + flips["exec"])
    assert abs(got.cpi - ref.cpi) <= 256.0 * (flips["fetch"] + flips["exec"]) / n
    assert abs(got.branch_mpki - ref.branch_mpki) <= 1000.0 * flips["mispredict"] / n + 1e-12
    assert abs(got.l1d_mpki - ref.l1d_mpki) <= 1000.0 * flips["l1d"] / n + 1e-12
    hist = sum(abs(got.metrics[k] - ref.metrics[k]) for k in ref.metrics if k.startswith("dlevel_"))
    assert hist <= 2 * flips["dlevel"]
    # a phase holds at least one window (or is empty on both sides)
    assert np.abs(got.cpi_phase - ref.cpi_phase).max() <= 256.0 * flips["fetch"] / window
    assert np.abs(got.l1d_phase - ref.l1d_phase).max() <= flips["l1d"]
    for k in ("cpi_phase", "l1d_phase"):
        assert getattr(got, k).dtype == np.float32 and getattr(got, k).shape == (32,)
    return flips


@pytest.mark.parametrize("backend", ["numpy", "fused"])
@pytest.mark.parametrize("bench", ["dee", "lee"])
def test_simulate_matches_reference_engine(weights, traces, reference, bench, backend):
    got = port_simulate(port_engine(weights, collect=True), traces[bench], backend)
    ref = reference[bench]
    assert got.available_metrics == ref.available_metrics
    assert_explained_by_flips(got, ref)
    assert set(got.to_dict()) == set(ref.to_dict())
    assert set(got.to_dict(arrays=True)) == set(ref.to_dict(arrays=True))
    assert set(got.to_dict(arrays=True)["arrays"]) == set(ref.to_dict(arrays=True)["arrays"])
    assert list(got.to_dict()["metrics"]) == list(ref.to_dict()["metrics"])


@pytest.mark.parametrize("bench", ["dee", "lee"])
def test_staged_route_matches_reference_pallas_engine(weights, traces, reference_pallas, bench):
    """The staged route against the reference engine's staged ``"pallas"``
    backend, under the flip-explained tolerance."""
    got = port_simulate(port_engine(weights, collect=True), traces[bench], "staged")
    ref = reference_pallas[bench]
    assert got.available_metrics == ref.available_metrics
    assert_explained_by_flips(got, ref)
    assert list(got.to_dict()["metrics"]) == list(ref.to_dict()["metrics"])


def test_fused_and_numpy_backends_are_identical(weights, traces):
    """Same device, bitwise-equal features: the raw-trace path,
    precomputed NumPy features and the staged whole-trace arrays agree
    exactly (on the CPU: no kernel launches)."""
    eng = port_engine(weights, collect=True)
    launches = (FUSED_FEATURES.launches, BRANCH_HISTORY.launches, MEMDIST_DELTA.launches)
    a = port_simulate(eng, traces["dee"], "numpy")
    for backend in ("fused", "staged"):
        b = port_simulate(eng, traces["dee"], backend)
        for k, v in a.metrics.items():
            np.testing.assert_array_equal(b.metrics[k], v, err_msg=f"{backend}/{k}")
        for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=f"{backend}/{k}")
    assert (FUSED_FEATURES.launches, BRANCH_HISTORY.launches, MEMDIST_DELTA.launches) == launches


def test_staged_route_reuses_one_extraction(weights, traces):
    """One extraction serves several simulations (the arrays are not
    consumed), a batch size that divides the windows exactly pads nothing,
    and the one-shot wrapper takes the arrays too."""
    fcfg = PORT_CFG.features
    t = traces["lee"][: 17 * 26]  # 26 windows: two whole batches of 13
    arrays = device_feature_arrays(trace_columns(t, fcfg), fcfg, device="cpu")
    kept = {k: v.clone() for k, v in arrays.items()}
    eng = port_engine(weights)
    runs = [eng.simulate(t, features=arrays) for _ in range(2)]
    runs.append(simulate_trace_engine(port_model(weights), t, PORT_CFG, batch_size=BATCH,
                                      features=arrays, metrics=METRICS, device="cpu"))
    fused = eng.simulate(t)
    for r in runs:
        for k, v in fused.metrics.items():
            np.testing.assert_array_equal(r.metrics[k], v, err_msg=k)
    for k, v in kept.items():
        assert torch.equal(arrays[k], v), k


def test_staged_route_refuses_arrays_it_cannot_batch(weights, traces):
    """A tensor on another device than the engine's raises (nothing is
    copied silently), as do missing keys, ragged lengths and other types."""
    fcfg = PORT_CFG.features
    t = traces["dee"][:500]
    arrays = device_feature_arrays(trace_columns(t, fcfg), fcfg, device="cpu")
    eng = port_engine(weights)
    moved = dict(arrays, memdist=arrays["memdist"].to("meta"))
    with pytest.raises(ValueError, match="'memdist' is on meta"):
        eng.simulate(t, features=moved)
    with pytest.raises(ValueError, match="lack"):
        eng.simulate(t, features={k: v for k, v in arrays.items() if k != "is_mem"})
    with pytest.raises(ValueError, match="rows"):
        eng.simulate(t, features=dict(arrays, brhist=arrays["brhist"][:-1]))
    with pytest.raises(TypeError):
        eng.simulate(t, features=list(arrays.values()))


def test_wide_addresses_raw_trace_equals_numpy_route(weights, traces):
    """Addresses past 2^31 (where the reference's int32 fused deltas would
    be inexact): the raw-trace path takes its deltas in int64 and gives
    what the NumPy route gives, bit for bit.  On the CPU it runs the plain
    version, so no kernel launches."""
    t = traces["lee"][:2000].copy()
    t["addr"][t["is_mem"]] += 1 << 40
    t["addr"][np.flatnonzero(t["is_mem"])[::7]] -= 1 << 50  # deltas past 2^31 too
    launches = FUSED_FEATURES.launches
    eng = port_engine(weights, collect=True)
    fused = port_simulate(eng, t, "fused")
    numpy_ = port_simulate(eng, t, "numpy")
    assert FUSED_FEATURES.launches == launches
    for k, v in numpy_.metrics.items():
        np.testing.assert_array_equal(fused.metrics[k], v, err_msg=k)
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        np.testing.assert_array_equal(getattr(fused, k), getattr(numpy_, k), err_msg=k)


def test_short_trace_and_wrapper(weights, traces):
    """A trace shorter than the window is one truncated window; the one-shot
    wrapper equals the engine."""
    t = traces["dee"][:10]
    r = port_engine(weights).simulate(t)
    assert r.num_instructions == 10
    w = simulate_trace_engine(port_model(weights), t, PORT_CFG, batch_size=BATCH,
                              metrics=METRICS, device="cpu")
    for k, v in r.metrics.items():
        np.testing.assert_array_equal(w.metrics[k], v, err_msg=k)


def test_result_errors_and_unported_options(weights, traces):
    r = port_engine(weights, metrics=("cpi",)).simulate(traces["lee"][:500])
    with pytest.raises(MetricNotCollectedError):
        r.fetch_lat
    with pytest.raises(MetricNotComputedError):
        r.l1d_mpki
    assert "arrays" not in r.to_dict()
    assert port_engine(weights, precision="int8").ecfg.precision == "int8"
    with pytest.raises(ValueError):
        port_engine(weights, precision="bf16")
    with pytest.raises(ValueError):
        port_engine(weights, batch_size=0)
    with pytest.raises(ValueError):
        port_engine(weights).simulate(traces["lee"][:0])


@pytest.mark.parametrize("backend", ["numpy", "fused", "staged"])
@pytest.mark.parametrize("bench", ["dee", "lee"])
def test_int8_simulate_matches_reference_int8_engine(weights, traces, reference_int8, bench, backend):
    got = port_simulate(port_engine(weights, collect=True, precision="int8"), traces[bench], backend)
    ref = reference_int8[bench]
    assert got.available_metrics == ref.available_metrics
    assert_explained_by_flips(got, ref, code_flip_atol=INT8_CODE_FLIP_PROB_ATOL)
    assert list(got.to_dict()["metrics"]) == list(ref.to_dict()["metrics"])


def assert_same_result(a, b):
    assert a.metrics.keys() == b.metrics.keys()
    for k, v in a.metrics.items():
        np.testing.assert_array_equal(b.metrics[k], v, err_msg=k)
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        if k in a.available_metrics:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)


def test_int8_gets_own_step_cache_entry(weights, traces):
    """The port of the reference's test: precision is in the step key, so
    fp32 and int8 make two entries; int8 engines share theirs across the
    routes, whose results are bitwise equal, and differ from fp32."""
    t = traces["lee"][:3000]
    clear_step_cache()
    r32 = port_simulate(port_engine(weights), t, "fused")
    a, b = port_engine(weights, precision="int8"), port_engine(weights, precision="int8")
    ra = port_simulate(a, t, "fused")
    runs = [port_simulate(b, t, "staged"), port_simulate(b, t, "numpy")]
    assert cache_stats()["entries"] == 2
    assert a.step_entry_for(len(t)) is b.step_entry_for(len(t))
    for r in runs:
        assert_same_result(ra, r)
    assert any(not np.array_equal(ra.metrics[k], v) for k, v in r32.metrics.items())


def test_int8_qparams_injection_equals_lazy_quantization(weights, traces):
    """An engine given ``qparams=`` (its own quantization of the weights, or
    the reference's quantized tree through ``qparams_from_jax``) uses them
    as they are and simulates exactly what lazy quantization gives; a
    trace shorter than the window at batch 1 (10 rows per product) too."""
    t = traces["dee"][:2500]
    lazy = port_engine(weights, precision="int8", collect=True)
    want = lazy.simulate(t)
    assert lazy._run_params() is lazy._run_params()
    own = quantize_tao_params(port_model(weights))
    from_ref = quantize_tao_params(init_tao(PORT_CFG, torch.Generator().manual_seed(9), device="cpu"))
    from_ref.load_state_dict(qparams_from_jax(jax.tree.map(np.asarray, ref_quant.quantize_tao_params(weights[0]))))
    for q in (own, from_ref):
        eng = StreamingEngine(port_model(weights), PORT_CFG,
                              EngineConfig(batch_size=BATCH, collect=True, metrics=METRICS, precision="int8"),
                              device="cpu", qparams=q)
        assert eng._run_params() is q
        assert_same_result(want, eng.simulate(t))
    short = simulate_trace_engine(port_model(weights), t[:10], PORT_CFG, batch_size=1, precision="int8",
                                  metrics=METRICS, device="cpu")
    assert short.num_instructions == 10
    assert_same_result(short, port_engine(weights, batch_size=1, precision="int8").simulate(t[:10]))


def test_device_get_is_exact():
    tree = {
        "a": torch.tensor([2**31 - 1, -(2**31), 0, 7], dtype=torch.int32),
        "b": {"c": torch.tensor([1e-38, 3.4e38, -0.0, 1 / 3], dtype=torch.float32)},
        "e": {},
    }
    host = device_get(tree)
    assert host["a"].dtype == np.int32 and host["b"]["c"].dtype == np.float32
    np.testing.assert_array_equal(host["a"], tree["a"].numpy())
    np.testing.assert_array_equal(host["b"]["c"].view(np.int32), tree["b"]["c"].numpy().view(np.int32))
    assert host["e"] == {}


# ---------------------------------------------------------------------------
# The step cache, the window-grid carry and AOT warmup
# ---------------------------------------------------------------------------

STAT_KEYS = {"entries", "hits", "misses", "compiles", "aot_compiled", "retained_bytes_est",
             "entries_unmeasured"}


def test_cache_stats_keys_equal_reference():
    assert set(cache_stats()) == set(ref_cache_stats()) == STAT_KEYS


def test_step_cache_hits_and_misses_match_reference(weights, traces):
    """The same engine traffic on both sides: a first simulate misses, a
    repeat hits, a second engine of the same shape shares the entry (a
    hit), a short trace (w_eff < window) adds a second entry (a miss), and
    step_entry_for / warmup of a known geometry hit.  clear_step_cache
    returns what it dropped."""
    t = traces["lee"][:1000]
    params, _ = weights
    counts = {}
    for side in ("reference", "port"):
        if side == "reference":
            make = lambda: RefEngine(params, REF_CFG, RefEngineConfig(batch_size=BATCH, metrics=METRICS))  # noqa: E731
            stats, clear = ref_cache_stats, ref_clear_step_cache
        else:
            make = lambda: port_engine(weights)  # noqa: E731
            stats, clear = cache_stats, clear_step_cache
        clear()
        before = stats()
        a, b = make(), make()
        a.simulate(t)
        a.simulate(t)
        b.simulate(t)
        assert a.step_entry_for(len(t)) is b.step_entry_for(len(t))
        a.simulate(t[:10])
        b.warmup(10)
        after = stats()
        counts[side] = {k: after[k] - before[k] for k in ("hits", "misses")}
        counts[side]["entries"] = after["entries"]
        counts[side]["cleared"] = clear()
        assert stats()["entries"] == 0
    assert counts["port"] == counts["reference"] == {"hits": 5, "misses": 2, "entries": 2, "cleared": 2}


def test_clear_step_cache_returns_dropped_count(weights, traces):
    clear_step_cache()
    eng = port_engine(weights)
    for n in (3, 9, 500):
        eng.step_entry_for(n)
    assert cache_stats()["entries"] == 3
    assert clear_step_cache() == 3
    assert clear_step_cache() == 0
    # the engine keeps its entries; a new engine builds anew (a miss)
    misses = cache_stats()["misses"]
    assert eng.step_entry_for(500) is not port_engine(weights).step_entry_for(500)
    assert cache_stats()["misses"] == misses + 1


def test_grid_spec_name_is_reserved(weights):
    grid = MetricSpec("__grid__", lambda device: {}, lambda carry, ctx: carry, lambda carry, n: {})
    with pytest.raises(ValueError, match="reserved"):
        port_engine(weights, metrics=("cpi", grid))
    ref_grid = RefMetricSpec("__grid__", lambda: {}, lambda carry, ctx: carry, lambda carry, n: {})
    with pytest.raises(ValueError, match="reserved"):
        RefEngine(weights[0], REF_CFG, RefEngineConfig(metrics=("cpi", ref_grid)))


@pytest.mark.parametrize("n", [10, 17, 1000, TRACE_LEN])
def test_init_carry_holds_the_grid(weights, n):
    """The specs' carries plus ``"__grid__"``: ``seen`` 0 and ``total`` the
    trace's windows, int32 scalars, as the reference's."""
    carry = port_engine(weights).init_carry(n)
    ref = RefEngine(weights[0], REF_CFG, RefEngineConfig(batch_size=BATCH, metrics=METRICS)).init_carry(n)
    assert list(carry) == list(ref) == list(METRICS) + ["__grid__"]
    grid = carry["__grid__"]
    assert set(grid) == set(ref["__grid__"]) == {"seen", "total"}
    for k in ("seen", "total"):
        assert grid[k].dtype == torch.int32 and grid[k].shape == () and grid[k].device.type == "cpu"
        assert int(grid[k]) == int(ref["__grid__"][k])
    assert int(grid["total"]) == num_windows(n, PORT_CFG.window, PORT_CFG.window)


def _drive(entry, params, carry, batches, specs, count, finalize_host):
    """Fold every batch through a cached entry called directly, then
    finalize on the host: a SimulationResult of the entry loop."""
    pers = []
    for b in batches:
        carry, per = entry(params, carry, b)
        pers.append(per)
    host = finalize_host(carry)
    metrics = {}
    for s in specs:
        metrics.update(s.finalize(host[s.name], count))
    arrays = {k: np.concatenate([np.asarray(p[k]) for p in pers])[:count]
              for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel")}
    return SimulationResult(count, 1.0, 0.0, metrics=metrics, arrays=arrays)


@pytest.mark.parametrize("bench", ["dee", "lee"])
def test_step_entry_loop_equals_simulate(weights, traces, bench):
    """Driving ``step_entry_for(n)(params, carry, batch)`` over host batches
    from ``init_carry(n)`` gives exactly what ``simulate`` gives; the same
    loop through the reference's entry stays within the flip tolerance."""
    t = traces[bench]
    n = len(t)
    count = num_windows(n, PORT_CFG.window, PORT_CFG.window) * PORT_CFG.window
    extra = {"is_branch": t["is_branch"], "is_mem": t["is_mem"]}
    eng = port_engine(weights, collect=True)
    fs = extract_features(t, PORT_CFG.features, with_labels=False)
    batches = ({k: torch.from_numpy(v) for k, v in b.items()}
               for b in stream_batches(fs, PORT_CFG.window, BATCH, stride=PORT_CFG.window, extra=extra))
    got = _drive(eng.step_entry_for(n), eng.params, eng.init_carry(n), batches, eng._specs, count,
                 lambda c: device_get(c))
    sim = eng.simulate(t, features=fs)
    assert got.metrics.keys() == sim.metrics.keys()
    for k, v in sim.metrics.items():
        np.testing.assert_array_equal(got.metrics[k], v, err_msg=k)
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        np.testing.assert_array_equal(getattr(got, k), getattr(sim, k), err_msg=k)

    ref_eng = RefEngine(weights[0], REF_CFG, RefEngineConfig(batch_size=BATCH, collect=True, metrics=METRICS))
    ref_fs = ref_features.extract_features(t, REF_CFG.features, with_labels=False)
    ref = _drive(ref_eng.step_entry_for(n), weights[0], ref_eng.init_carry(n),
                 ref_stream_batches(ref_fs, REF_CFG.window, BATCH, stride=REF_CFG.window, extra=extra),
                 ref_eng._specs, count, jax.device_get)
    assert_explained_by_flips(got, ref)


class _IntGridContext(StepContext):
    """The step context as it was with a host int ``num_windows``."""

    def chunk_of(self, num_chunks):
        b = (self.win_index * num_chunks) // max(self.num_windows, 1)
        return torch.clamp(b, 0, num_chunks - 1)


PHASE_SPECS = sorted(name for name, s in METRIC_REGISTRY.items() if s.num_chunks is not None)


@pytest.mark.parametrize("spec_name", PHASE_SPECS + ["chunks_7"])
def test_chunk_of_device_grid_is_bitwise_int_grid(spec_name):
    """``chunk_of`` and every phase spec's ``update`` with the grid as int32
    tensors are bitwise what they were with host ints: empty, short and
    long traces, first, middle and padding batches."""
    spec = (windowed_spec("chunks_7", lambda ctx: ctx.exec_lat, num_chunks=7)
            if spec_name == "chunks_7" else METRIC_REGISTRY[spec_name])
    rng = np.random.default_rng(len(spec_name))
    W = PORT_CFG.window
    for total, seen in ((0, 0), (1, 0), (5, 0), (40, 13), (40, 39), (1000, 520), (2**20, 2**20 - 3)):
        valid = torch.from_numpy((rng.random((BATCH, W)) < 0.9).astype(np.float32))
        valid[max(0, total - seen):] = 0.0  # padding rows past the trace's windows
        on = valid.reshape(-1) > 0
        fields = dict(
            valid=valid.reshape(-1), on=on,
            is_branch=torch.from_numpy(rng.random(BATCH * W) < 0.3) & on,
            is_mem=torch.from_numpy(rng.random(BATCH * W) < 0.4) & on,
            fetch_lat=torch.from_numpy(rng.exponential(4.0, BATCH * W).astype(np.float32)),
            exec_lat=torch.from_numpy(rng.exponential(9.0, BATCH * W).astype(np.float32)),
            mispred_prob=torch.from_numpy(rng.random(BATCH * W).astype(np.float32)),
            dlevel=torch.from_numpy(rng.integers(0, 4, BATCH * W).astype(np.int32)),
            gidx=torch.arange(BATCH * W, dtype=torch.float32),
            last_key=torch.tensor(float(BATCH * W - 1)), batch={}, window=W,
        )
        win_index = seen + torch.arange(BATCH, dtype=torch.int32)
        dev = StepContext(**fields, win_index=torch.tensor(seen, dtype=torch.int32)
                          + torch.arange(BATCH, dtype=torch.int32),
                          num_windows=torch.tensor(total, dtype=torch.int32))
        host = _IntGridContext(**fields, win_index=win_index, num_windows=total)
        assert torch.equal(dev.chunk_of(spec.num_chunks), host.chunk_of(spec.num_chunks)), (total, seen)
        got = spec.update(spec.init("cpu"), dev)
        ref = spec.update(spec.init("cpu"), host)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), (total, seen, k)


def test_at_last_reads_the_last_valid_position():
    """``at_last`` by ``index_select`` (no read back to the host) is the
    element at the last valid position, as indexing gives it."""
    x = torch.arange(10, dtype=torch.float32) * 1.5
    for mask in ([1] * 10, [1] * 4 + [0] * 6, [0, 1, 0, 0, 1, 0, 0, 0, 0, 0], [0] * 10):
        on = torch.tensor(mask, dtype=torch.bool)
        gidx = torch.arange(10, dtype=torch.float32)
        ctx = StepContext(valid=on.float(), on=on, is_branch=on, is_mem=on, fetch_lat=x, exec_lat=x,
                          mispred_prob=x, dlevel=x.int(), gidx=gidx, last_key=torch.tensor(0.0), batch={})
        got = ctx.at_last(x)
        assert got.shape == () and torch.equal(got, x[torch.argmax(torch.where(on, gidx, -1.0))])


def test_warmup_on_cpu_captures_nothing(weights, traces):
    """No CUDA graph on the CPU: warmup returns the entry the geometry's
    simulate uses, with ``aot`` None, no capture and no byte estimate; the
    entry counts as unmeasured."""
    clear_step_cache()
    eng = port_engine(weights)
    entry = eng.warmup(TRACE_LEN)
    assert entry is eng.warmup(TRACE_LEN) is eng.step_entry_for(TRACE_LEN)
    assert entry.aot is None and entry.compiles == 0 and entry.est_bytes is None
    eng.simulate(traces["dee"])
    assert eng.num_compiles == 0
    s = cache_stats()
    assert (s["entries"], s["compiles"], s["aot_compiled"], s["retained_bytes_est"],
            s["entries_unmeasured"]) == (1, 0, 0, 0, 1)


def test_prefetch_helper_inline_and_threaded():
    """Order kept in both modes, producer errors raised in the consumer,
    an abandoned consumer stops the producer, depth below 1 refused."""
    import threading

    items = [{"i": np.full((3,), i)} for i in range(25)]
    for threaded in (False, True):
        out = list(prefetch_to_device(iter(items), device="cpu", threaded=threaded))
        assert [int(o["i"][0]) for o in out] == list(range(25)), threaded
        assert all(isinstance(o["i"], torch.Tensor) for o in out)
        ident = list(prefetch_to_device(iter(items), lambda b: b, device="cpu", threaded=threaded))
        assert all(a is b for a, b in zip(ident, items))
    assert list(prefetch_to_device(iter(()), device="cpu", threaded=True)) == []

    def bad():
        yield {"i": np.zeros(1)}
        raise RuntimeError("producer boom")

    for threaded in (False, True):
        with pytest.raises(RuntimeError, match="producer boom"):
            list(prefetch_to_device(bad(), device="cpu", threaded=threaded))

    gen = prefetch_to_device(iter(items), device="cpu", threaded=True)
    assert int(next(gen)["i"][0]) == 0
    gen.close()  # abandoning the consumer stops the producer thread
    assert not [t for t in threading.enumerate() if t.name == "batch-prefetch" and t.is_alive()]
    with pytest.raises(ValueError, match="depth"):
        next(prefetch_to_device(iter(items), device="cpu", depth=0, threaded=True))


@pytest.mark.parametrize("mode", [False, True], ids=["inline", "threaded"])
def test_host_route_is_bitwise_with_prefetch_on_and_off(weights, traces, mode, monkeypatch):
    """The host route through ``prefetch_to_device`` (inline, as the engine
    takes it, and forced onto a producer thread) against synchronous
    copies: every metric and array bitwise."""
    from repro_torch.engine import runner

    fs = extract_features(traces["lee"], PORT_CFG.features, with_labels=False)
    off = port_engine(weights, collect=True, prefetch=False).simulate(traces["lee"], features=fs)
    monkeypatch.setattr(runner, "prefetch_to_device",
                        lambda *a, threaded=None, **k: prefetch_to_device(*a, threaded=mode, **k))
    on = port_engine(weights, collect=True).simulate(traces["lee"], features=fs)
    assert on.metrics.keys() == off.metrics.keys()
    for k, v in off.metrics.items():
        np.testing.assert_array_equal(on.metrics[k], v, err_msg=k)
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        np.testing.assert_array_equal(getattr(on, k), getattr(off, k), err_msg=k)


def test_library_path_follows_every_included_header(tmp_path):
    """An edit to a header that a source pulls in by a local ``#include``,
    directly or through another header, renames its library; an edit to a
    file it does not include leaves the name as it was.  The wgmma kernels
    share csrc/wgmma.cuh."""
    from repro_torch.kernels import _cuda

    (tmp_path / "sub").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint main() {}\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "sub/b.cuh"\n')
    (tmp_path / "sub" / "b.cuh").write_text("constexpr int kB = 1;\n")
    (tmp_path / "unrelated.cuh").write_text("constexpr int kU = 1;\n")
    assert [p.name for p in _cuda.included_sources(src)] == ["k.cu", "a.cuh", "b.cuh"]
    first = _cuda.library_path(src)
    (tmp_path / "unrelated.cuh").write_text("constexpr int kU = 2;\n")
    assert _cuda.library_path(src) == first
    (tmp_path / "sub" / "b.cuh").write_text("constexpr int kB = 2;\n")
    second = _cuda.library_path(src)
    assert second != first and second.name.startswith("k-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n// edited\n')
    assert _cuda.library_path(src) not in (first, second)
    for name in ("attention.cu", "attention_bwd.cu", "ssd_bwd.cu"):
        assert _cuda.CSRC / "wgmma.cuh" in _cuda.included_sources(_cuda.CSRC / name), name


def test_build_cache_hit_needs_no_nvcc_and_status_has_the_reference_keys(tmp_path, monkeypatch):
    from repro.engine import persistent_cache_status as ref_status
    from repro_torch.kernels import _cuda

    before = _cuda.BUILD_DIR
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    try:
        d = enable_persistent_cache(str(tmp_path / "cache"))
        assert d == str((tmp_path / "cache").resolve()) and enable_persistent_cache(d) == d
        src = _cuda.CSRC / "graph_nodes.cu"
        lib = _cuda.library_path(src)
        assert lib.parent == tmp_path / "cache"
        lib.write_bytes(b"\0" * 100)  # a library of this source and these flags
        (tmp_path / "cache" / "other.7.tmp.so").write_bytes(b"\0" * 7)  # a build in flight

        def no_nvcc():
            raise AssertionError("a hit must not run nvcc")

        monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
        c0 = build_cache_counters()
        assert _cuda.build([src]) == {src: lib}
        c1 = build_cache_counters()
        assert {k: c1[k] - c0[k] for k in c1} == {"requests": 1, "hits": 1, "misses": 0}
        status = persistent_cache_status()
        assert set(status) == set(ref_status())
        assert (status["enabled"], status["dir"], status["entries"], status["bytes"]) == (True, d, 1, 100)
        assert {k: status[k] for k in c1} == c1
        # the environment variable names the default directory
        monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path / "env"))
        assert enable_persistent_cache() == str((tmp_path / "env").resolve())
        assert persistent_cache_status()["entries"] == 0
    finally:
        _cuda.BUILD_DIR = before
    monkeypatch.delenv("REPRO_COMPILE_CACHE")
    assert enable_persistent_cache() == str(_cuda.DEFAULT_BUILD_DIR.resolve())
    assert _cuda.BUILD_DIR == before
