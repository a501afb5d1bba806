"""The port's fault injection, crash-resume manifests and resumable
training against the reference's, on the CPU.

  * faults: the reference's harness tests (``tests/test_resilience.py``)
    on the port's copy, and one seeded ``FaultPlan`` firing at the same
    calls in both packages; ``store.load`` faults are misses that recover;
    ``engine.simulate`` and ``engine.compile`` fire in the port's engine.
  * manifests: ``publish_train_epoch`` / ``load_train_epoch`` and
    ``publish_sweep_result`` / ``load_sweep_result`` round trips.
  * training: one epoch with manifests, then a resume to three equals the
    uninterrupted run bitwise (losses, steps, every parameter and optimizer
    tensor); a finished recipe replays with zero steps; and the
    uninterrupted run's losses are within 1e-6 relative of the
    reference's on the same weights and windows (float32 reductions in
    other orders, as ``tests/test_torch_train.py`` holds them).
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import dataset as ref_dataset  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.core.align import build_adjusted_trace  # noqa: E402
from repro.core.transfer import train_tao_impl as ref_train  # noqa: E402
from repro.resilience import FaultError as RefFaultError  # noqa: E402
from repro.resilience import FaultPlan as RefFaultPlan  # noqa: E402
from repro.resilience import FaultSpec as RefFaultSpec  # noqa: E402
from repro.resilience import fault_point as ref_fault_point  # noqa: E402
from repro.resilience import inject as ref_inject  # noqa: E402
from repro.uarch import UARCH_A, get_benchmark, run_detailed, run_functional  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FeatureConfig, TaoConfig, WindowDataset, init_tao  # noqa: E402
from repro_torch.core.transfer import train_tao_impl  # noqa: E402
from repro_torch.engine import EngineConfig, SimulationResult, StreamingEngine  # noqa: E402
from repro_torch.engine import clear_step_cache  # noqa: E402
from repro_torch.resilience import SITES, FaultError, FaultPlan, FaultSpec, fault_point, inject  # noqa: E402
from repro_torch.resilience import faults as port_faults  # noqa: E402
from repro_torch.resilience.manifest import (  # noqa: E402
    load_sweep_result,
    load_train_epoch,
    publish_sweep_result,
    publish_train_epoch,
    sweep_progress_key,
    train_epoch_key,
)
from repro_torch.store import ArtifactStore, content_key  # noqa: E402

MODEL = dict(window=9, d_model=16, n_heads=2, n_layers=1, d_ff=32, d_cat=8)
FCFG = (64, 4, 8)
CFG = TaoConfig(features=FeatureConfig(*FCFG), **MODEL)
REF_CFG = ref_model.TaoConfig(features=ref_features.FeatureConfig(*FCFG), **MODEL)
LR = 1e-3


# ---------------------------------------------------------------------------
# the harness (mirrors test_resilience.py)
# ---------------------------------------------------------------------------


def test_fault_spec_after_times_and_match():
    plan = FaultPlan(FaultSpec("site.a", after=2, times=2, message="boom"))
    fired = []
    with inject(plan):
        for i in range(6):
            try:
                fault_point("site.a", payload=f"p{i}")
                fired.append(False)
            except FaultError as e:
                fired.append(True)
                assert e.site == "site.a" and e.transient
                assert "boom" in str(e)
        fault_point("site.b")  # an unarmed site: no-op
    assert fired == [False, False, True, True, False, False]
    assert plan.hits == {"site.a": 6, "site.b": 1}
    assert [site for site, _, _ in plan.fired] == ["site.a", "site.a"]

    plan2 = FaultPlan(FaultSpec("s", match="poison", times=None, transient=False))
    with inject(plan2):
        fault_point("s", payload="healthy-digest")  # no match, no fire
        with pytest.raises(FaultError) as ei:
            fault_point("s", payload="poison-digest")
        assert not ei.value.transient
    fault_point("s", payload="poison-digest")  # disarmed after the block


def fire_sequence(plan_cls, spec_cls, inject_fn, point, seed, n=64):
    """Which of ``n`` hits of one site fire under a seeded p=0.5 plan (and
    a second spec that fires after 3 matched hits, twice)."""
    plan = plan_cls(spec_cls("s", p=0.5, times=None, match="odd"),
                    spec_cls("s", after=3, times=2, exc="OSError"), seed=seed)
    out = []
    with inject_fn(plan):
        for i in range(n):
            try:
                point("s", payload="odd" if i % 2 else "even")
                out.append(0)
            except (FaultError, RefFaultError, OSError) as e:
                out.append(2 if isinstance(e, OSError) else 1)
    return out, plan.fired, plan.hits


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_seeded_plan_fires_at_the_same_calls_as_the_reference(seed):
    port = fire_sequence(FaultPlan, FaultSpec, inject, fault_point, seed)
    ref = fire_sequence(RefFaultPlan, RefFaultSpec, ref_inject, ref_fault_point, seed)
    assert port == ref
    assert 0 < sum(x == 1 for x in port[0]) < 32 and port[0].count(2) == 2


def test_fault_plan_seeded_probability_deterministic():
    def seq(seed):
        return fire_sequence(FaultPlan, FaultSpec, inject, fault_point, seed)[0]

    assert seq(3) == seq(3)
    assert seq(3) != seq(4)


def test_fault_delay_kind_sleeps_instead_of_raising():
    plan = FaultPlan(FaultSpec("s", kind="delay", delay_s=0.05))
    with inject(plan):
        t0 = time.perf_counter()
        fault_point("s")  # sleeps, does not raise
        assert time.perf_counter() - t0 >= 0.04
        fault_point("s")  # times=1: the second hit is clean


def test_inject_non_reentrant_and_none_passthrough():
    fault_point("anything")  # unarmed: a free no-op
    with inject(None):
        fault_point("anything")
    with inject(FaultPlan(FaultSpec("s"))):
        with pytest.raises(RuntimeError, match="already injected"):
            with inject(FaultPlan()):
                pass
    with inject(FaultPlan()):  # released after exit
        pass
    assert port_faults._ACTIVE is None


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    assert FaultPlan.from_env() is None
    monkeypatch.setenv("REPRO_FAULT_PLAN", json.dumps({
        "seed": 9, "faults": [{"site": "store.load", "times": 2, "exc": "OSError"}]}))
    plan = FaultPlan.from_env()
    assert plan.seed == 9 and plan.faults[0].site == "store.load"
    assert plan.faults[0].times == 2 and plan.faults[0].exc == "OSError"
    assert plan.faults[0].to_dict()["site"] == "store.load"
    with pytest.raises(ValueError, match="unknown fault exception"):
        FaultSpec("s", exc="SystemExit")
    with pytest.raises(ValueError, match="kind"):
        FaultSpec("s", kind="explode")
    assert {"store.load", "engine.compile", "engine.simulate"} <= set(SITES)


# ---------------------------------------------------------------------------
# the sites the port threads
# ---------------------------------------------------------------------------


def test_store_load_fault_is_corruption_miss_then_recovers(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    key = content_key("features", "z")
    st.put("features", key, {"x": np.arange(4.0)})
    plan = FaultPlan(FaultSpec("store.load", times=1, exc="OSError"))
    with inject(plan):
        assert st.get("features", key) is None  # fault -> miss, never raise
    assert plan.fired == [("store.load", key, 0)]
    assert st.counters["corrupt_dropped"] == 1
    assert st.put("features", key, {"x": np.arange(4.0)})  # recompute and re-put
    tree, _ = st.get("features", key)
    np.testing.assert_array_equal(tree["x"], np.arange(4.0))


@pytest.fixture(scope="module")
def trace():
    return run_functional(get_benchmark("dee"), 600)


def test_engine_simulate_and_compile_faults_fire(trace):
    clear_step_cache()
    model = init_tao(CFG, device="cpu")
    engine = StreamingEngine(model, CFG, EngineConfig(batch_size=8), device="cpu")
    with inject(FaultPlan(FaultSpec("engine.simulate"))) as plan:
        with pytest.raises(FaultError, match="engine.simulate"):
            engine.simulate(trace)
        clean = engine.simulate(trace)  # times=1: the next call runs
    assert plan.hits == {"engine.simulate": 2, "engine.compile": 1}
    clear_step_cache()
    fresh = StreamingEngine(model, CFG, EngineConfig(batch_size=8), device="cpu")
    plan = FaultPlan(FaultSpec("engine.compile", match="w9", exc="MemoryError"))
    with inject(plan):
        with pytest.raises(MemoryError):
            fresh.simulate(trace)  # a step-cache miss at window 9
        again = fresh.simulate(trace)  # the retry builds the step
        fresh.simulate(trace)  # a cache hit: no compile site
    assert plan.hits == {"engine.simulate": 3, "engine.compile": 2}
    assert plan.fired == [("engine.compile", "w9", 0)]
    assert again.metrics == clean.metrics


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------


def test_train_epoch_manifest_round_trip(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    rng = np.random.default_rng(5)
    rng.random(3)
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3, dtype=torch.bfloat16)}
    opt = {"step": torch.tensor(4, dtype=torch.int32), "mu": {"w": torch.ones(2, 3)}, "nu": {"w": torch.ones(2, 3)}}
    assert load_train_epoch(st, "run", 5) is None
    for ep in (0, 1):
        publish_train_epoch(st, "run", ep, params, opt, [1.5, 0.25][: ep + 1], [], 4 * (ep + 1),
                            rng.bit_generator.state)
    state = load_train_epoch(st, "run", 5)  # the latest below 5
    assert state["epoch"] == 1 and state["losses"] == [1.5, 0.25] and state["steps"] == 8
    assert state["rng_state"] == rng.bit_generator.state
    assert torch.equal(state["params"]["b"], params["b"]) and state["params"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["params"]["w"], params["w"].numpy())
    assert int(state["opt"]["step"]) == 4
    assert load_train_epoch(st, "run", 1)["epoch"] == 0  # strictly below max_epochs
    assert load_train_epoch(st, "other", 5) is None
    assert train_epoch_key("run", 1) != train_epoch_key("run", 0) != train_epoch_key("other", 0)


def test_sweep_result_manifest_round_trip(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    res = SimulationResult(num_instructions=900, seconds=1.0, mips=0.0009,
                           metrics={"cpi": 1.25, "cpi_phase": np.arange(4, dtype=np.float32)})
    key = sweep_progress_key("run", "m/t", "digest", "params", "w9")
    assert load_sweep_result(st, key) is None
    publish_sweep_result(st, key, res)
    got = load_sweep_result(st, key)
    assert isinstance(got, SimulationResult)
    assert got.num_instructions == 900 and got.seconds == 0.0 and got.mips == 0.0
    assert got.cpi == 1.25 and np.array_equal(got.cpi_phase, res.cpi_phase)
    assert got.available_metrics == ("cpi", "cpi_phase")


# ---------------------------------------------------------------------------
# training: crash-resume, bit for bit (mirrors test_resilience.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def windows():
    """Labelled windows of dee on UARCH_A from the reference's data path,
    and the reference's initial params (carried over as data)."""
    prog = get_benchmark("dee")
    det, _ = run_detailed(prog, run_functional(prog, 900), UARCH_A)
    fs = ref_features.extract_features(build_adjusted_trace(det).adjusted, REF_CFG.features)
    ds = ref_dataset.build_windows(fs, REF_CFG.window)
    params = jax.jit(ref_model.init_tao, static_argnums=1)(jax.random.PRNGKey(0), REF_CFG)
    return ds, params


def train(ds, params, **kw):
    kw = dict(dict(epochs=3, batch_size=8, lr=LR, seed=0, device="cpu"), **kw)
    init = params_from_jax(jax.tree.map(np.asarray, params))
    return train_tao_impl(CFG, WindowDataset(inputs=ds.inputs, labels=ds.labels), init_params=init, **kw)


def assert_same_run(a, b):
    assert a.losses == b.losses and a.steps == b.steps and a.eval_losses == b.eval_losses
    for (k, x), y in zip(a.params.state_dict().items(), b.params.state_dict().values()):
        assert torch.equal(x, y), k


@pytest.fixture(scope="module")
def uninterrupted(windows, tmp_path_factory):
    """Three epochs with manifests on, in one go, and the store."""
    st = ArtifactStore(str(tmp_path_factory.mktemp("base")))
    return train(*windows, store=st, resume_key="run"), st


def test_train_resume_bit_identical(tmp_path, windows, uninterrupted):
    ds, params = windows
    base, base_st = uninterrupted
    assert_same_run(base, train(ds, params))  # publishing manifests changes nothing

    st = ArtifactStore(str(tmp_path / "ck"))
    # "crash" after epoch 0: one epoch with manifests on
    part = train(ds, params, epochs=1, store=st, resume_key="run")
    assert part.losses == base.losses[:1]
    resumed = train(ds, params, store=st, resume_key="run")
    assert_same_run(resumed, base)
    # the optimizer state too: the last manifests of both runs
    a = load_train_epoch(base_st, "run", 3)
    b = load_train_epoch(st, "run", 3)
    assert a["epoch"] == b["epoch"] == 2 and a["rng_state"] == b["rng_state"]
    for group in ("mu", "nu"):
        assert sorted(a["opt"][group]) == sorted(b["opt"][group])
        for k in a["opt"][group]:
            np.testing.assert_array_equal(a["opt"][group][k], b["opt"][group][k])
    assert int(a["opt"]["step"]) == int(b["opt"]["step"]) == base.steps

    # a finished recipe replays its final manifest: zero steps run
    calls = []
    again = train(ds, params, store=st, resume_key="run", eval_fn=lambda m: calls.append(m) or 0.0)
    assert calls == [] and again.losses == base.losses and again.steps == base.steps
    assert_same_run(again, base)

    with pytest.raises(ValueError, match="manifest_every"):
        train(ds, params, epochs=1, store=st, resume_key="run", manifest_every=0)


def test_train_resume_with_manifest_every_and_eval(tmp_path, windows):
    """``manifest_every=2`` over 4 epochs publishes epochs 1 and 3; a run
    cut after epoch 2 resumes from epoch 1 and still ends bitwise, its
    eval history included."""
    ds, params = windows
    evals = dict(eval_fn=lambda m: float(m.adapt.weight.detach().sum()))
    base = train(ds, params, epochs=4, **evals)
    st = ArtifactStore(str(tmp_path / "ck"))
    train(ds, params, epochs=3, store=st, resume_key="r", manifest_every=2, **evals)
    published = [ep for ep in range(4) if st.has("train_epoch", train_epoch_key("r", ep))]
    assert published == [1, 2]  # every 2nd epoch and the run's last
    st.delete("train_epoch", train_epoch_key("r", 2))  # as if cut before epoch 2 landed
    resumed = train(ds, params, epochs=4, store=st, resume_key="r", manifest_every=2, **evals)
    assert_same_run(resumed, base)
    assert [ep for ep in range(4) if st.has("train_epoch", train_epoch_key("r", ep))] == [1, 3]


def test_train_matches_reference(windows, uninterrupted):
    ds, params = windows
    ref = ref_train(REF_CFG, ds, epochs=3, batch_size=8, lr=LR, init_params=params, seed=0)
    got, _ = uninterrupted
    assert got.steps == ref.steps
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-6)


def test_headonly_resume_bit_identical(tmp_path, windows):
    """Tao's fine-tune (frozen embeddings, optimizer state for the head
    only) resumes bitwise too."""
    ds, params = windows
    kw = dict(freeze_embed=True, epochs=2)
    base = train(ds, params, **kw)
    st = ArtifactStore(str(tmp_path / "ck"))
    train(ds, params, store=st, resume_key="ft", **dict(kw, epochs=1))
    state = load_train_epoch(st, "ft", 2)
    assert all(k.split(".")[0] in ("adapt", "pred") for k in state["opt"]["mu"])
    assert_same_run(train(ds, params, store=st, resume_key="ft", **kw), base)
