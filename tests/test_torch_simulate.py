"""The port's ``core/simulate.py`` against the reference's, on the CPU.

The reference initializes the weights (carried over with
``params_from_jax``); the same functional traces go through the
reference's ``simulate_trace_legacy`` (its host batch loop, ragged
batches, jitted forward) and the port's (an eager ``tao_forward`` per
ragged batch).  Features are bitwise equal on both sides; the float32
logits differ in the last bits, so the decodes may flip only at near ties
(the engine's flip contract, ``tests/test_torch_engine.py``): at most
0.1% of positions, ``mispred_prob`` within 1e-5, and every metric
difference explained by the flips.  ``phase_curves`` is bitwise the
reference's on equal arrays; ``simulate_trace`` warns and equals the
port's engine.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.engine.runner import SimulationResult as RefSimulationResult  # noqa: E402
from repro.uarch import get_benchmark, run_functional  # noqa: E402

from repro_torch import core as port_core  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import simulate as port_simulate  # noqa: E402
from repro_torch.core.features import FeatureConfig, extract_features  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.engine import EngineConfig, SimulationResult, StreamingEngine  # noqa: E402
from repro_torch.kernels.attention.kernel import FLASH_ATTENTION  # noqa: E402

FCFG = (64, 4, 8)
MODEL = dict(window=17, d_model=32, n_heads=2, n_layers=1, d_ff=64, d_cat=16)
PORT_CFG = TaoConfig(features=FeatureConfig(*FCFG), **MODEL)
REF_CFG = ref_model.TaoConfig(features=ref_features.FeatureConfig(*FCFG), **MODEL)
TRACE_LEN = 2000
BATCH = 13  # ragged final batch
FLIP_FRACTION = 1e-3
PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(ref_model.init_tao, static_argnums=1)(jax.random.PRNGKey(0), REF_CFG)
    model = init_tao(PORT_CFG, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, model


@pytest.fixture(scope="module")
def traces():
    return {b: run_functional(get_benchmark(b), TRACE_LEN) for b in ("dee", "lee")}


def assert_explained_by_flips(got, ref):
    """The engine's flip contract on the legacy loop's metrics (no phase
    curves): decodes flip at ≤ 0.1% of positions, ``mispred_prob`` within
    1e-5, every scalar moved only as far as its flips allow."""
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
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        assert getattr(got, k).dtype == getattr(ref, k).dtype and getattr(got, k).shape == (n,)
    assert abs(got.total_cycles - ref.total_cycles) <= 256.0 * (flips["fetch"] + flips["exec"])
    assert abs(got.cpi - ref.cpi) <= 256.0 * (flips["fetch"] + flips["exec"]) / n
    assert abs(got.branch_mpki - ref.branch_mpki) <= 1000.0 * flips["mispredict"] / n + 1e-12
    assert abs(got.l1d_mpki - ref.l1d_mpki) <= 1000.0 * flips["l1d"] / n + 1e-12
    return flips


@pytest.mark.parametrize("bench", ["dee", "lee"])
def test_simulate_trace_legacy_matches_reference(weights, traces, bench):
    params, model = weights
    trace = traces[bench]
    ref = ref_simulate.simulate_trace_legacy(params, trace, REF_CFG, batch_size=BATCH)
    got = port_simulate.simulate_trace_legacy(model, trace, PORT_CFG, batch_size=BATCH, device="cpu")
    assert got.num_instructions == (TRACE_LEN // PORT_CFG.window) * PORT_CFG.window
    assert got.available_metrics == ref.available_metrics
    assert assert_explained_by_flips(got, ref)["fetch"] <= FLIP_FRACTION * TRACE_LEN
    assert got.mips > 0 and got.seconds > 0


def test_simulate_trace_legacy_features_and_launches(weights, traces):
    """Without ``features`` the loop extracts them with the interpreter
    loop, bitwise the vectorized spec's; the result is the same either
    way.  One ``tao_forward`` per ragged batch: on the CPU the attention
    wrapper takes its plain version and counts no launch."""
    _, model = weights
    trace = traces["lee"]
    launches = FLASH_ATTENTION.launches
    a = port_simulate.simulate_trace_legacy(model, trace, PORT_CFG, batch_size=BATCH, device="cpu")
    fs = extract_features(trace, PORT_CFG.features, with_labels=False)
    b = port_simulate.simulate_trace_legacy(model, trace, PORT_CFG, batch_size=BATCH, features=fs,
                                            device="cpu")
    assert a.metrics == b.metrics
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert FLASH_ATTENTION.launches == launches


def test_simulate_trace_legacy_equals_engine_numpy_route(weights, traces):
    """The legacy loop is the engine's executable specification: on the
    same device and features the engine's host route gives the same
    per-instruction predictions, up to the padded batch's float32 ulps."""
    _, model = weights
    trace = traces["dee"]
    fs = extract_features(trace, PORT_CFG.features, with_labels=False)
    legacy = port_simulate.simulate_trace_legacy(model, trace, PORT_CFG, batch_size=BATCH,
                                                 features=fs, device="cpu")
    eng = StreamingEngine(model, PORT_CFG, EngineConfig(batch_size=BATCH, collect=True),
                          device="cpu").simulate(trace, features=fs)
    assert_explained_by_flips(legacy, eng)


def test_phase_curves_bitwise_reference(traces):
    rng = np.random.default_rng(0)
    n = 25_000
    arrays = {
        "fetch_lat": rng.gamma(2.0, 3.0, n).astype(np.float32),
        "exec_lat": rng.gamma(2.0, 3.0, n).astype(np.float32),
        "mispred_prob": rng.random(n).astype(np.float32),
        "dlevel": rng.integers(0, 4, n).astype(np.int32),
    }
    port = SimulationResult(n, 1.0, 0.025, {"cpi": 1.0}, arrays=arrays)
    ref = RefSimulationResult(n, 1.0, 0.025, {"cpi": 1.0}, arrays=arrays)
    for chunk in (10_000, 777):
        got = port_simulate.phase_curves(port, chunk)
        want = ref_simulate.phase_curves(ref, chunk)
        assert sorted(got) == sorted(want) == ["branch_mpki", "cpi", "l1d_mpki"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert len(got["cpi"]) == n // chunk
    with pytest.raises(ValueError, match="collect=True"):
        port_simulate.phase_curves(SimulationResult(n, 1.0, 0.025, {"cpi": 1.0}))


def test_simulate_trace_warns_and_equals_engine(weights, traces):
    _, model = weights
    trace = traces["lee"]
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = port_core.simulate_trace(model, trace, PORT_CFG, batch_size=BATCH, device="cpu")
    want = StreamingEngine(model, PORT_CFG, EngineConfig(batch_size=BATCH, collect=True),
                           device="cpu").simulate(trace)
    assert got.metrics == want.metrics and got.available_metrics == want.available_metrics
    for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    # collect=False and a FeatureSet route, as the engine takes them
    fs = extract_features(trace, PORT_CFG.features, with_labels=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        host = port_core.simulate_trace(model, trace, PORT_CFG, batch_size=BATCH, features=fs,
                                        collect=False, device="cpu")
    assert "fetch_lat" not in host.available_metrics
    assert port_core.phase_curves is port_simulate.phase_curves
    assert port_core.SimulationResult is SimulationResult
