"""The port's streaming engine against the reference engine.

The reference initializes the weights (converted with ``params_from_jax``);
the same functional traces go through ``repro.engine.StreamingEngine`` and
the port's engine on the CPU, both ways the port takes features: from the
raw trace through the fused kernel's path (``"fused"``), and precomputed by
the NumPy specification (``"numpy"``, ``simulate(trace, features=...)``).

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
from repro.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.engine import StreamingEngine as RefEngine  # noqa: E402
from repro.uarch import get_benchmark, run_functional  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.features import FeatureConfig, extract_features  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    EngineConfig,
    MetricNotCollectedError,
    MetricNotComputedError,
    StreamingEngine,
    simulate_trace_engine,
)
from repro_torch.engine.runner import device_get  # noqa: E402
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


def port_model(weights):
    model = init_tao(PORT_CFG, device="cpu")
    model.load_state_dict(weights[1])
    return model


def port_engine(weights, **kw):
    kw.setdefault("batch_size", BATCH)
    kw.setdefault("metrics", METRICS)
    return StreamingEngine(port_model(weights), PORT_CFG, EngineConfig(**kw), device="cpu")


def port_simulate(engine, trace, backend):
    """``"fused"``: the raw trace; ``"numpy"``: the NumPy features, precomputed."""
    if backend == "fused":
        return engine.simulate(trace)
    return engine.simulate(trace, features=extract_features(trace, PORT_CFG.features, with_labels=False))


def assert_explained_by_flips(got, ref):
    n = ref.num_instructions
    assert got.num_instructions == n
    flipped = {
        "fetch": got.fetch_lat != ref.fetch_lat,
        "exec": got.exec_lat != ref.exec_lat,
        "dlevel": got.dlevel != ref.dlevel,
        "mispredict": (got.mispred_prob > 0.5) != (ref.mispred_prob > 0.5),
        "l1d": (got.dlevel >= 2) != (ref.dlevel >= 2),
    }
    flips = {k: int(v.sum()) for k, v in flipped.items()}
    assert max(flips.values()) <= FLIP_FRACTION * n, flips
    np.testing.assert_allclose(got.mispred_prob, ref.mispred_prob, rtol=0, atol=PROB_ATOL)
    assert abs(got.total_cycles - ref.total_cycles) <= 256.0 * (flips["fetch"] + flips["exec"])
    assert abs(got.cpi - ref.cpi) <= 256.0 * (flips["fetch"] + flips["exec"]) / n
    assert abs(got.branch_mpki - ref.branch_mpki) <= 1000.0 * flips["mispredict"] / n + 1e-12
    assert abs(got.l1d_mpki - ref.l1d_mpki) <= 1000.0 * flips["l1d"] / n + 1e-12
    hist = sum(abs(got.metrics[k] - ref.metrics[k]) for k in ref.metrics if k.startswith("dlevel_"))
    assert hist <= 2 * flips["dlevel"]
    # a phase holds at least one window (or is empty on both sides)
    assert np.abs(got.cpi_phase - ref.cpi_phase).max() <= 256.0 * flips["fetch"] / PORT_CFG.window
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


def test_fused_and_numpy_backends_are_identical(weights, traces):
    """Same device, bitwise-equal features: the raw-trace path and
    precomputed NumPy features agree exactly."""
    eng = port_engine(weights, collect=True)
    a = port_simulate(eng, traces["dee"], "numpy")
    b = port_simulate(eng, traces["dee"], "fused")
    for k, v in a.metrics.items():
        np.testing.assert_array_equal(b.metrics[k], v, err_msg=k)
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)


def test_wide_addresses_take_the_numpy_route(weights, traces):
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
    with pytest.raises(NotImplementedError, match="A6"):
        port_engine(weights, precision="int8")
    with pytest.raises(ValueError):
        port_engine(weights, precision="bf16")
    with pytest.raises(ValueError):
        port_engine(weights, batch_size=0)
    with pytest.raises(ValueError):
        port_engine(weights).simulate(traces["lee"][:0])


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
