"""The port's sweep scheduler against the reference's ``TraceSweeper``.

Four models (JAX weights from seeds 0-3, converted with
``params_from_jax``) x two functional traces go through the port's
``TraceSweeper`` on each route — ``"fused"``, ``"staged"`` and ``"host"``,
held to the reference's ``feature_backend`` ``"fused"``, ``"pallas"`` and
``"numpy"`` — with the producer inline and on its thread, on the CPU.

  * Every result is bitwise the port's own standalone
    ``StreamingEngine.simulate`` of that (model, trace) pair on that route,
    and is held to the reference sweep's result by the engine's flip
    contract (test_torch_engine.py: at most 0.1% of positions flip near
    logit ties, every metric difference explained by the flips).
  * The counters equal the reference's: traces, instructions, step builds
    (1 when the step cache starts cold, 0 warm; on the CPU, where nothing
    is captured, a build is a step entry the sweep made), host
    extractions, store loads, skipped jobs, plan kind and shards; so does
    ``to_dict()``'s key set (the wire schema TAO007 also holds).
  * The host route extracts each distinct trace once (content digest) and
    through an ``ArtifactStore``: a warm store extracts nothing, and a
    store the reference filled serves the port.
  * Faults (``resilience.faults``): a producer fault surfaces in the
    consumer without a hang; a consumer that fails leaves no producer
    parked; a sweep killed by a consume fault after 2 jobs resumes,
    skipping them, bitwise the uninterrupted sweep.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.engine import SweepJob as RefSweepJob  # noqa: E402
from repro.engine import TraceSweeper as RefSweeper  # noqa: E402
from repro.engine import clear_step_cache as ref_clear_step_cache  # noqa: E402
from repro.store import ArtifactStore as RefStore  # noqa: E402
from repro.uarch import get_benchmark, run_functional  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.features import FeatureConfig, extract_features  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ROUTES,
    EngineConfig,
    StreamingEngine,
    SweepJob,
    TraceSweeper,
    clear_step_cache,
    sweep_traces,
)
from repro_torch.kernels.features.ops import device_feature_arrays, trace_columns  # noqa: E402
from repro_torch.resilience.faults import FaultPlan, FaultSpec, inject  # noqa: E402
from repro_torch.store import ArtifactStore  # noqa: E402

from test_torch_engine import assert_explained_by_flips  # noqa: E402

FCFG = (32, 4, 8)
MODEL = dict(window=9, d_model=16, n_heads=2, n_layers=1, d_ff=32, d_cat=16)
PORT_CFG = TaoConfig(features=FeatureConfig(*FCFG), **MODEL)
REF_CFG = ref_model.TaoConfig(features=ref_features.FeatureConfig(*FCFG), **MODEL)
METRICS = ("cpi", "branch_mpki", "l1d_mpki", "cpi_phase", "l1d_phase", "dlevel_hist")
TRACE_LEN = 2400
BATCH = 8
SEEDS = (0, 1, 2, 3)
BENCHES = ("dee", "lee")
ECFG = EngineConfig(batch_size=BATCH, collect=True, metrics=METRICS)
# the reference's feature_backend of each of the port's routes
REF_BACKEND = {"fused": "fused", "staged": "pallas", "host": "numpy"}
COUNTERS = ("num_traces", "num_instructions", "num_compiles", "features_extracted",
            "features_from_store", "jobs_skipped", "plan_kind", "num_shards", "queue_depth")
# a hung sweep fails the test instead of the run
HANG_S = 120


@pytest.fixture(scope="module")
def traces():
    return {b: run_functional(get_benchmark(b), TRACE_LEN) for b in BENCHES}


@pytest.fixture(scope="module")
def weights():
    init = jax.jit(ref_model.init_tao, static_argnums=1)
    params = {s: init(jax.random.PRNGKey(s), REF_CFG) for s in SEEDS}
    return {s: (p, params_from_jax(jax.tree.map(np.asarray, p))) for s, p in params.items()}


def port_models(weights):
    out = {}
    for s, (_, state) in weights.items():
        out[s] = init_tao(PORT_CFG, device="cpu")
        out[s].load_state_dict(state)
    return out


def port_jobs(models, traces):
    return [SweepJob(f"m{s}/{b}", models[s], traces[b]) for s in SEEDS for b in BENCHES]


@pytest.fixture(scope="module")
def reference(weights, traces):
    """Each backend's reference sweep, from a cold step cache and warm."""
    jobs = [RefSweepJob(f"m{s}/{b}", weights[s][0], traces[b]) for s in SEEDS for b in BENCHES]
    out = {}
    for route, backend in REF_BACKEND.items():
        ecfg = RefEngineConfig(batch_size=BATCH, collect=True, metrics=METRICS, feature_backend=backend)
        ref_clear_step_cache()
        cold = RefSweeper(REF_CFG, ecfg).run(jobs)
        out[route] = (cold, RefSweeper(REF_CFG, ecfg).run(jobs))
    return out


def route_features(route, trace):
    if route == "fused":
        return None
    if route == "staged":
        return device_feature_arrays(trace_columns(trace, PORT_CFG.features), PORT_CFG.features,
                                     device="cpu")
    return extract_features(trace, PORT_CFG.features, with_labels=False)


@pytest.fixture(scope="module")
def standalone(weights, traces):
    """The port's own standalone simulate of every pair on every route."""
    models = port_models(weights)
    out = {}
    for route in ROUTES:
        out[route] = {}
        for job in port_jobs(models, traces):
            engine = StreamingEngine(job.params, PORT_CFG, ECFG, device="cpu")
            out[route][job.key] = engine.simulate(job.trace, features=route_features(route, job.trace))
    return out


def assert_same_result(got, want, arrays=True):
    assert got.num_instructions == want.num_instructions
    assert got.metrics.keys() == want.metrics.keys()
    for k, v in want.metrics.items():
        np.testing.assert_array_equal(got.metrics[k], v, err_msg=k)
    if arrays:
        for k in ("fetch_lat", "exec_lat", "mispred_prob", "dlevel"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def counters(rep):
    return {k: getattr(rep, k) for k in COUNTERS}


@pytest.mark.parametrize("async_prepare", [False, True], ids=["inline", "threaded"])
@pytest.mark.parametrize("route", ROUTES)
def test_sweep_matches_standalone_and_reference(weights, traces, reference, standalone, route,
                                                async_prepare):
    jobs = port_jobs(port_models(weights), traces)
    clear_step_cache()
    reps = [TraceSweeper(PORT_CFG, ECFG, route=route, async_prepare=async_prepare, device="cpu").run(jobs)
            for _ in ("cold", "warm")]
    for rep, ref in zip(reps, reference[route]):
        assert list(rep.results) == [j.key for j in jobs]
        for key, r in rep.results.items():
            assert_same_result(r, standalone[route][key])
            assert_explained_by_flips(r, ref.results[key], window=PORT_CFG.window)
        assert counters(rep) == counters(ref)
        assert rep.prepared_async is async_prepare
        assert set(rep.to_dict()) == set(ref.to_dict())
        for key, r in rep.to_dict()["results"].items():
            assert set(r) == set(ref.to_dict()["results"][key])
        assert rep.queue_occupancy_max <= rep.queue_depth
    assert [r.num_compiles for r in reps] == [1, 0]
    assert [r.features_extracted for r in reps] == ([2, 2] if route == "host" else [0, 0])


def test_warmup_and_the_one_shot_wrapper(weights, traces, standalone):
    clear_step_cache()
    sweeper = TraceSweeper(PORT_CFG, ECFG, route="host", device="cpu")
    # on the CPU nothing is captured: the entries are built, so the sweep
    # after it builds none (the reference's AOT-compiled warmup likewise)
    assert sweeper.warmup([TRACE_LEN, TRACE_LEN, 5]) == {"geometries": 2, "aot_compiled": 0}
    models = port_models(weights)
    rep = sweep_traces(PORT_CFG, [(j.key, j.params, j.trace) for j in port_jobs(models, traces)],
                       ECFG, route="host", device="cpu")
    assert rep.num_compiles == 0 and rep.prepared_async is False
    for key, r in rep.results.items():
        assert_same_result(r, standalone["host"][key])
    ref_clear_step_cache()
    ref = RefSweeper(REF_CFG, RefEngineConfig(batch_size=BATCH, collect=True, metrics=METRICS))
    ref.warmup([TRACE_LEN])
    ref_jobs = [RefSweepJob(f"m0/{b}", weights[0][0], traces[b]) for b in BENCHES]
    assert ref.run(ref_jobs).num_compiles == 0


def test_host_route_dedups_by_digest_through_the_store(tmp_path, weights, traces):
    model = port_models(weights)[0]
    t = traces["dee"]
    jobs = [SweepJob("m/a", model, t), SweepJob("m/b", model, t.copy())]  # equal content
    st = ArtifactStore(str(tmp_path / "port"))
    rep = TraceSweeper(PORT_CFG, ECFG, route="host", store=st, device="cpu").run(jobs)
    assert (rep.features_extracted, rep.features_from_store) == (1, 0)
    assert_same_result(rep.results["m/a"], rep.results["m/b"])
    rep2 = TraceSweeper(PORT_CFG, ECFG, route="host", store=st, device="cpu").run(jobs)
    assert (rep2.features_extracted, rep2.features_from_store) == (0, 1)
    assert rep2.stats()["features_from_store"] == 1
    assert_same_result(rep2.results["m/a"], rep.results["m/a"])
    # the reference's counters in the same scenario
    rst = RefStore(str(tmp_path / "ref"))
    ref_jobs = [RefSweepJob("m/a", weights[0][0], t), RefSweepJob("m/b", weights[0][0], t.copy())]
    ref_ecfg = RefEngineConfig(batch_size=BATCH, collect=True, metrics=METRICS)
    r1 = RefSweeper(REF_CFG, ref_ecfg, store=rst).run(ref_jobs)
    r2 = RefSweeper(REF_CFG, ref_ecfg, store=rst).run(ref_jobs)
    assert [(r.features_extracted, r.features_from_store) for r in (r1, r2)] == [(1, 0), (0, 1)]
    # a store the reference filled serves the port: the same content keys
    rep3 = TraceSweeper(PORT_CFG, ECFG, route="host", store=ArtifactStore(str(tmp_path / "ref")),
                        device="cpu").run(jobs)
    assert (rep3.features_extracted, rep3.features_from_store) == (0, 1)
    assert_same_result(rep3.results["m/a"], rep.results["m/a"])


def run_with_deadline(fn):
    """``fn()`` on a thread joined within HANG_S: (result, error)."""
    out = {}

    def body():
        try:
            out["result"] = fn()
        except BaseException as e:  # handed to the test
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(HANG_S)
    assert not t.is_alive(), f"the sweep hung past {HANG_S} s"
    return out.get("result"), out.get("error")


def producers_alive():
    return [t for t in threading.enumerate() if t.name == "trace-sweep-producer" and t.is_alive()]


@pytest.mark.parametrize("route", ["fused", "host"])
def test_producer_fault_surfaces_without_a_hang(weights, traces, route):
    jobs = port_jobs(port_models(weights), traces)[:2]
    sweeper = TraceSweeper(PORT_CFG, ECFG, route=route, async_prepare=True, device="cpu")
    with inject(FaultPlan(FaultSpec("scheduler.prepare", exc="RuntimeError"))):
        _, err = run_with_deadline(lambda: sweeper.run(jobs))
    assert isinstance(err, RuntimeError) and "injected fault" in str(err)
    assert not producers_alive()


def test_consumer_failure_leaves_no_producer_parked(weights, traces):
    jobs = port_jobs(port_models(weights), traces)
    sweeper = TraceSweeper(PORT_CFG, ECFG, route="host", depth=1, async_prepare=True, device="cpu")
    with inject(FaultPlan(FaultSpec("scheduler.consume", exc="RuntimeError"))):
        _, err = run_with_deadline(lambda: sweeper.run(jobs))
    assert isinstance(err, RuntimeError) and "injected fault" in str(err)
    assert not producers_alive()


@pytest.mark.parametrize("async_prepare", [False, True], ids=["inline", "threaded"])
def test_resume_after_a_consume_fault_is_bitwise_the_uninterrupted_sweep(tmp_path, weights, traces,
                                                                         async_prepare):
    jobs = port_jobs(port_models(weights), traces)
    ref = TraceSweeper(PORT_CFG, ECFG, route="host", device="cpu").run(jobs)
    st = ArtifactStore(str(tmp_path / "s"))

    def sweeper():
        return TraceSweeper(PORT_CFG, ECFG, route="host", store=st, async_prepare=async_prepare,
                            device="cpu")

    # killed mid-sweep: the 3rd consume dies after 2 jobs published
    plan = FaultPlan(FaultSpec("scheduler.consume", after=2, times=1, exc="RuntimeError"))
    with inject(plan), pytest.raises(RuntimeError, match="injected fault"):
        sweeper().run(jobs, resume_key="dse-run")
    resumed = sweeper().run(jobs, resume_key="dse-run")
    assert (resumed.jobs_skipped, resumed.features_extracted, resumed.num_traces) == (2, 0, len(jobs))
    assert resumed.num_instructions == ref.num_instructions
    assert list(resumed.results)[:2] == [j.key for j in jobs[:2]]
    for key, r in ref.results.items():
        assert_same_result(resumed.results[key], r, arrays=key not in {j.key for j in jobs[:2]})
    # a finished sweep resumes as pure manifest replay: no device work
    replay = sweeper().run(jobs, resume_key="dse-run")
    assert (replay.jobs_skipped, replay.num_compiles, replay.features_extracted) == (len(jobs), 0, 0)
    for key, r in ref.results.items():
        assert_same_result(replay.results[key], r, arrays=False)


def test_sweeper_rejects_what_it_cannot_run(weights, traces):
    model = port_models(weights)[0]
    t = traces["dee"]
    sweeper = TraceSweeper(PORT_CFG, ECFG, device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        sweeper.run([SweepJob("k", model, t), SweepJob("k", model, t)])
    with pytest.raises(ValueError, match="at least one"):
        sweeper.run([])
    with pytest.raises(ValueError, match="store"):
        sweeper.run([SweepJob("k", model, t)], resume_key="no-store")
    with pytest.raises(ValueError, match="depth"):
        TraceSweeper(PORT_CFG, ECFG, depth=0, device="cpu")
    with pytest.raises(ValueError, match="route"):
        TraceSweeper(PORT_CFG, ECFG, route="numpy", device="cpu")
    assert sweeper.route == "fused" and sweeper.async_prepare is False
    assert sweeper.plan.describe()["kind"] == "single"
