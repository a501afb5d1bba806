"""The port's Session facade (``repro_torch.api``) against the reference's
(``repro.api``), on the CPU, at the reference test's small config.

Both packages run the same workflow on the same inputs; where the port
draws its own weights (``init_model``, ``train_joint``), the port's
``init_tao`` / ``init_multiarch`` as imported by ``repro_torch.api.session``
are patched to return the reference's ``jax.random`` init of that seed,
converted with ``params_from_jax``.  What each comparison holds:

  * traces, ground truth, materialized and streaming datasets, store keys
    and int8 trees: bitwise (the same NumPy substrate on both sides);
  * ``train`` / ``transfer`` from the same weights: epoch losses within
    1e-6 relative, every parameter within 2 lr a step and 99% of them
    within 1e-5 (``tests/test_torch_train.py``'s trajectory tolerance);
  * ``train_joint``: epoch losses within 1e-5 relative and ``eval_loss``
    within 1e-6 (``tests/test_torch_multiarch.py``'s tolerances);
  * ``simulate`` on each route (``fused``, ``staged``, ``host``, held to the
    reference's ``fused``, ``pallas``, ``numpy``) and in int8: the engine's
    flip contract (``tests/test_torch_engine.py::assert_explained_by_flips``);
  * ``sweep``: bitwise the port's own ``simulate`` of each pair, and within
    the flip contract of the reference's sweep.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
import repro.api.session as ref_session  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.core import multiarch as ref_ma  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.store import ArtifactStore as RefStore  # noqa: E402
from repro import uarch as ref_uarch  # noqa: E402

import repro_torch.api as api  # noqa: E402
import repro_torch.api.session as port_session  # noqa: E402
from repro_torch import uarch  # noqa: E402
from repro_torch.api import DesignSpace, JointModel, Session, TrainedModel  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    qparams_from_jax,
    qparams_to_jax,
)
from repro_torch.core import multiarch as port_ma  # noqa: E402
from repro_torch.core.features import FeatureConfig  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.core.quant import quantize_tao_params  # noqa: E402
from repro_torch.store import ArtifactStore  # noqa: E402

from test_torch_engine import (  # noqa: E402
    INT8_CODE_FLIP_PROB_ATOL,
    assert_explained_by_flips,
    assert_same_result,
)

FCFG = (32, 4, 8)
MODEL = dict(window=17, d_model=32, n_heads=2, n_layers=1, d_ff=64, d_cat=16)
PORT_CFG = TaoConfig(features=FeatureConfig(*FCFG), **MODEL)
REF_CFG = ref_model.TaoConfig(features=ref_features.FeatureConfig(*FCFG), **MODEL)
METRICS = ("cpi", "branch_mpki", "l1d_mpki", "cpi_phase", "l1d_phase", "dlevel_hist")
# the reference's feature_backend of each of the port's routes
REF_BACKEND = {"fused": "fused", "staged": "pallas", "host": "numpy"}
SERVE_NAMES = {"TraceServer", "ModelRegistry", "ServeRequest", "ServeResult", "ServerStats",
               "ServeError"}
LR = 1e-3
BATCH = 8
TRAIN_TRACE = ("dee", 800)   # ~47 windows: 5 steps an epoch at batch 8
SIM_TRACE = ("mcf", 3000)
# the routes' trace: tests/test_torch_engine.py's length, at which its flip
# contract (0.1% of positions) was set.  int8 moves a few positions to the
# neighbouring code whatever the length (2-4 on dee, lee and mcf at 3,000
# and 6,000 instructions), so at 3,000 the contract's limit is 2.99
ROUTE_TRACE = ("mcf", 6000)
CPU = "cpu"


def ref_sess(**kw):
    # no JAX persistent compilation cache: it is process-wide state
    return ref_api.Session(REF_CFG, compile_cache=False, **kw)


def port_sess(**kw):
    return Session(PORT_CFG, device=CPU, **kw)


@pytest.fixture(scope="module")
def sessions():
    return ref_sess(), port_sess()


@pytest.fixture(scope="module")
def traces(sessions):
    ref, port = sessions
    return {name: (ref.capture(name, n), port.capture(name, n)) for name, n in (TRAIN_TRACE, SIM_TRACE)}


def jax_init(seed):
    return jax.jit(ref_model.init_tao, static_argnums=1)(jax.random.PRNGKey(seed), REF_CFG)


def port_tao(tree):
    model = init_tao(PORT_CFG, device=CPU)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return model


@pytest.fixture(scope="module")
def weights():
    params = jax_init(0)
    return params, port_tao(params)


def assert_tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(path))


def assert_state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def assert_trajectory(got, ref_params, steps):
    """Every parameter within 2 lr a step, 99% of them within 1e-5."""
    diffs = np.concatenate([np.abs(np.asarray(r) - g).ravel() for r, g in zip(
        jax.tree.leaves(ref_params), jax.tree.leaves(params_to_jax(got)))])
    assert diffs.max() <= 2 * LR * steps
    assert (diffs <= 1e-5).mean() >= 0.99


# ---------------------------------------------------------------------------
# traces, ground truth, datasets
# ---------------------------------------------------------------------------


def test_capture_digest_and_cache_match_reference(sessions, traces):
    ref, port = sessions
    for r, p in traces.values():
        np.testing.assert_array_equal(p.functional, r.functional)
        assert p.digest == r.digest and p.name == r.name and len(p) == p.num_instructions
    # the reference's cache semantics: the same object, custom names never
    # shadow the default, same-named Programs never alias
    a = port.capture("dee", 1200)
    assert port.capture("dee", 1200) is a and port.capture("dee", 800) is not a
    named = port.capture("dee", 1200, name="warmup")
    assert named.name == "warmup" and named is not a
    assert port.capture("dee", 1200).name == "dee:1200" == ref.capture("dee", 1200).name
    assert port.capture("dee", 1200, name="warmup") is named
    import copy

    prog = uarch.get_benchmark("dee")
    prog2 = copy.copy(prog)
    x, y = port.capture(prog, 600), port.capture(prog2, 600)
    assert x is not y and x.program is prog and y.program is prog2
    assert port.capture(prog, 600) is x
    np.testing.assert_array_equal(x.functional, ref.capture(ref_uarch.get_benchmark("dee"), 600).functional)


def test_ground_truth_matches_and_shares_one_detailed_run(monkeypatch):
    ref, port = ref_sess(), port_sess()
    rt, pt = ref.capture("dee", 800), port.capture("dee", 800)
    calls = []
    real = port_session.run_detailed

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(port_session, "run_detailed", counting)
    summ = port.ground_truth(uarch.UARCH_A, pt)
    assert summ == ref.ground_truth(ref_uarch.UARCH_A, rt)
    port.dataset(uarch.UARCH_A, [pt])
    assert summ == port.ground_truth(uarch.UARCH_A, pt)
    assert len(calls) == 1  # one detailed sim serves truth + dataset


@pytest.mark.parametrize("streaming", [False, True])
def test_dataset_windows_and_labels_bitwise(sessions, traces, streaming):
    ref, port = sessions
    rts, pts = zip(*traces.values())
    rd = ref.dataset(ref_uarch.UARCH_A, rts, streaming=streaming)
    pd = port.dataset(uarch.UARCH_A, pts, streaming=streaming)
    assert type(pd).__name__ == type(rd).__name__ and len(pd) == len(rd)
    assert pd is port.dataset(uarch.UARCH_A, pts, streaming=streaming)
    for rb, pb in zip(rd.batches(BATCH, rng=np.random.default_rng(1)),
                      pd.batches(BATCH, rng=np.random.default_rng(1))):
        assert_tree_equal(jax.tree.map(np.asarray, rb), pb)
    if not streaming:
        assert_tree_equal(rd.inputs, pd.inputs)
        assert_tree_equal(rd.labels, pd.labels)
    else:
        g = port.dataset(uarch.UARCH_A, pts, streaming=True, dedup_scope="global")
        assert len(g) == len(ref.dataset(ref_uarch.UARCH_A, rts, streaming=True, dedup_scope="global"))
    for s in (ref, port):
        with pytest.raises(ValueError, match="dedup_scope is a streaming-pipeline option"):
            s.dataset(s_uarch(s).UARCH_A, traces["dee"][s is port], streaming=False, dedup_scope="global")


def s_uarch(s):
    return uarch if isinstance(s, Session) else ref_uarch


# ---------------------------------------------------------------------------
# training and transfer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(sessions, traces, weights):
    """``train`` of the training trace on UARCH_A from the same weights."""
    ref, port = sessions
    rt, pt = traces["dee"]
    kw = dict(epochs=2, batch_size=BATCH, lr=LR, seed=3)
    r = ref.train(ref_uarch.UARCH_A, [rt], init=weights[0], **kw)
    p = port.train(uarch.UARCH_A, [pt], init=weights[1], **kw)
    return r, p


def test_train_from_same_init_tracks_reference(trained, weights):
    r, p = trained
    assert p.steps == r.steps == 10 and p.name == r.name == "uArchA" and p.uarch == uarch.UARCH_A
    np.testing.assert_allclose(p.losses, r.losses, rtol=1e-6)
    assert_trajectory(p.params, r.params, p.steps)
    assert isinstance(p.params, torch.nn.Module) and p.device == torch.device(CPU)
    assert (p.sim_batch_size, p.sim_route, p.sim_precision, p.sim_plan) == (64, "fused", "fp32", None)
    # the init is left alone; a TrainedModel and a state dict are inits too
    assert_state_equal(weights[1], port_tao(weights[0]))
    sess = port_sess()
    ds = sess.dataset(uarch.UARCH_A, sess.capture(*TRAIN_TRACE)).subsample(BATCH)
    a = sess.train(dataset=ds, epochs=1, batch_size=4, init=p)
    b = sess.train(dataset=ds, epochs=1, batch_size=4, init=p.params.state_dict())
    assert a.losses == b.losses
    assert_state_equal(a.params, b.params)
    with pytest.raises(ValueError, match="dataset"):
        sess.train(epochs=1)
    with pytest.raises(ValueError, match="streaming="):
        sess.train(dataset=ds, streaming=True)


def test_trained_model_transfer_tracks_reference(sessions, traces, weights):
    ref, port = sessions
    rt, pt = traces["dee"]
    small_r = ref.dataset(ref_uarch.UARCH_B, rt).subsample(16)
    small_p = port.dataset(uarch.UARCH_B, pt).subsample(16)
    kw = dict(epochs=2, batch_size=4, lr=LR, seed=2)
    r = ref_api.TrainedModel(params=weights[0], cfg=REF_CFG, name="m").transfer(small_r, **kw)
    model = TrainedModel(params=port_tao(weights[0]), cfg=PORT_CFG, name="m", device=CPU)
    before = {k: v.clone() for k, v in model.params.state_dict().items()}
    p = model.transfer(small_p, **kw)
    assert p.name == r.name == "m-transfer" and p.steps == r.steps == 8
    np.testing.assert_allclose(p.losses, r.losses, rtol=1e-6)
    assert_trajectory(p.params, r.params, p.steps)
    for k, v in p.params.embed.state_dict().items():
        assert torch.equal(v, before[f"embed.{k}"]), k
    assert_state_equal(model.params, port_tao(weights[0]))  # the donor is left alone
    assert np.isfinite(p.simulate(pt).cpi)


def joint_tree(seed=0):
    return jax.jit(ref_ma.init_multiarch, static_argnums=1)(jax.random.PRNGKey(seed), REF_CFG)


def port_multiarch(tree):
    model = port_ma.init_multiarch(PORT_CFG, device=CPU)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return model


@pytest.fixture(scope="module")
def joint_data(sessions, traces):
    ref, port = sessions
    rt, pt = traces["dee"]
    return ((ref.dataset(ref_uarch.UARCH_A, rt).subsample(16), ref.dataset(ref_uarch.UARCH_B, rt).subsample(16)),
            (port.dataset(uarch.UARCH_A, pt).subsample(16), port.dataset(uarch.UARCH_B, pt).subsample(16)))


@pytest.mark.parametrize("method", ["tao", "gradnorm"])
def test_train_joint_tracks_reference(monkeypatch, sessions, joint_data, method):
    ref, port = sessions
    tree = joint_tree(5)
    drawn = []

    def patched(cfg, generator=None, *, device=None):
        drawn.append(generator.initial_seed())
        return port_multiarch(tree).to(device)

    monkeypatch.setattr(port_session, "init_multiarch", patched)
    seen = []
    kw = dict(method=method, epochs=2, batch_size=4, seed=5)
    r = ref.train_joint(ref_uarch.UARCH_A, ref_uarch.UARCH_B, datasets=joint_data[0], **kw)
    p = port.train_joint(uarch.UARCH_A, uarch.UARCH_B, datasets=joint_data[1], **kw,
                         on_epoch=lambda ep, params, steps: seen.append((ep, steps, params)))
    assert drawn == [5]
    assert p.steps == r.steps == 8 and p.method == method and len(p.losses) == 2
    np.testing.assert_allclose(np.array(p.losses), np.array(r.losses), rtol=1e-5)
    assert [(e, s) for e, s, _ in seen] == [(0, 4), (1, 8)] and seen[-1][2] is p.params
    assert isinstance(p.params, port_ma.MultiArch) and p.embedding is p.params.embed


def test_train_joint_errors_match_reference(sessions, joint_data, traces):
    ref, port = sessions
    for s, (ds_a, ds_b), u in ((ref, joint_data[0], ref_uarch), (port, joint_data[1], uarch)):
        with pytest.raises(ValueError, match="not in"):
            s.train_joint(u.UARCH_A, u.UARCH_B, datasets=(ds_a, ds_b), method="avg")
        with pytest.raises(ValueError, match="streaming="):
            s.train_joint(u.UARCH_A, u.UARCH_B, datasets=(ds_a, ds_b), streaming=True)
        with pytest.raises(ValueError, match="traces= or datasets="):
            s.train_joint(u.UARCH_A, u.UARCH_B)
        with pytest.raises(ValueError, match="no full batch"):
            s.train_joint(u.UARCH_A, u.UARCH_B, datasets=(ds_a, ds_b), batch_size=64)


@pytest.fixture(scope="module")
def joint_models():
    tree = joint_tree(1)
    ref = ref_api.JointModel(params=tree, cfg=REF_CFG, method="tao", losses=[])
    port = JointModel(params=port_multiarch(tree), cfg=PORT_CFG, method="tao", losses=[], device=CPU)
    return ref, port


def test_joint_head_and_eval_loss_match_reference(joint_models, joint_data, traces):
    ref, port = joint_models
    for arch in ("A", "B"):
        head = port.head(arch)
        assert head.name == f"joint-tao-{arch}"
        want = {f"embed.{k}": v for k, v in port.params.embed.state_dict().items()}
        want.update(getattr(port.params, arch).state_dict())
        got = head.params.state_dict()
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
        assert got["embed.combine.weight"].data_ptr() != want["embed.combine.weight"].data_ptr()
    rt, pt = traces["mcf"]
    r = ref.head("A").simulate(rt, metrics=METRICS, collect=True, batch_size=13)
    p = port.head("A").simulate(pt, metrics=METRICS, collect=True, batch_size=13)
    assert_explained_by_flips(p, r, window=PORT_CFG.window)
    rb = [next(joint_data[0][0].batches(4, rng=np.random.default_rng(0)))]
    pb = [next(joint_data[1][0].batches(4, rng=np.random.default_rng(0)))]
    for arch in ("A", "B"):
        np.testing.assert_allclose(port.eval_loss(pb, arch), ref.eval_loss(jax.tree.map(jax.numpy.asarray, rb), arch),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="arch must be"):
        port.head("C")
    gran = JointModel(params=port.params, cfg=PORT_CFG, method="granite", losses=[], device=CPU)
    with pytest.raises(ValueError, match="adaptation"):
        gran.head("A")
    with pytest.raises(ValueError, match="donor"):
        port.transfer(joint_data[1][0], donor="embed")


def test_joint_transfer_tracks_reference(joint_models, joint_data):
    ref, port = joint_models
    before = {k: v.clone() for k, v in port.params.state_dict().items()}
    kw = dict(donor="B", epochs=2, batch_size=4, lr=LR, seed=1)
    r = ref.transfer(joint_data[0][1], **kw)
    p = port.transfer(joint_data[1][1], **kw)
    assert p.name == r.name == "transfer-tao" and p.steps == r.steps
    np.testing.assert_allclose(p.losses, r.losses, rtol=1e-6)
    assert_trajectory(p.params, r.params, p.steps)
    for k, v in p.params.embed.state_dict().items():
        assert torch.equal(v, before[f"embed.{k}"]), k
    assert all(torch.equal(v, before[k]) for k, v in port.params.state_dict().items())


# ---------------------------------------------------------------------------
# simulation and sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("route", ["fused", "staged", "host"])
def test_simulate_routes_match_reference(sessions, weights, route, precision):
    rt, pt = (s.capture(*ROUTE_TRACE) for s in sessions)
    kw = dict(metrics=METRICS, collect=True, batch_size=13, precision=precision)
    r = ref_api.TrainedModel(params=weights[0], cfg=REF_CFG).simulate(
        rt, feature_backend=REF_BACKEND[route], **kw)
    model = TrainedModel(params=port_tao(weights[0]), cfg=PORT_CFG, sim_route=route, device=CPU)
    p = model.simulate(pt, **kw)
    assert p.available_metrics == r.available_metrics
    assert_explained_by_flips(p, r, code_flip_atol=INT8_CODE_FLIP_PROB_ATOL if precision == "int8" else None,
                              window=PORT_CFG.window)
    # every route gives the same result; one engine per EngineConfig
    for other in ("fused", "staged", "host"):
        assert_same_result(p, model.simulate(pt, route=other, **kw))
    assert len(model._engines) == 1 and model.num_compiles == 0  # the CPU captures nothing
    with pytest.raises(ValueError, match="route must be"):
        model.simulate(pt, route="pallas")


@pytest.fixture(scope="module")
def init_models():
    """``init_model`` on both sides: the port's draw patched to the
    reference's init of the same seed."""
    ref, port = ref_sess(batch_size=16), port_sess(batch_size=16)
    mp = pytest.MonkeyPatch()
    drawn = []

    def patched(cfg, generator=None, *, device=None):
        drawn.append(generator.initial_seed())
        return port_tao(jax_init(generator.initial_seed())).to(device)

    mp.setattr(port_session, "init_tao", patched)
    try:
        models = ({f"u{i}": ref.init_model(seed=i, name=f"u{i}") for i in range(2)},
                  {f"u{i}": port.init_model(seed=i, name=f"u{i}") for i in range(2)})
    finally:
        mp.undo()
    assert drawn == [0, 1]
    assert all(m.sim_batch_size == 16 for m in models[1].values())
    return (ref, port), models


@pytest.mark.parametrize("route", ["fused", "host"])
def test_sweep_matches_simulate_and_reference(init_models, traces, route):
    (ref, port), (rm, pm) = init_models
    rts = [traces[b][0] for b in ("dee", "mcf")]
    pts = [traces[b][1] for b in ("dee", "mcf")]
    kw = dict(metrics=METRICS, collect=True)
    r = ref.sweep(rm, rts, feature_backend=REF_BACKEND[route], **kw)
    p = port.sweep(pm, pts, route=route, **kw)
    assert sorted(p.results) == sorted(r.results) == sorted(f"u{i}/{t.name}" for i in range(2) for t in pts)
    assert (p.num_traces, p.num_instructions) == (r.num_traces, r.num_instructions)
    assert p.features_extracted == r.features_extracted
    for name, model in pm.items():
        for t in pts:
            key = f"{name}/{t.name}"
            assert_same_result(model.simulate(t, route=route, **kw), p.results[key])
            assert_explained_by_flips(p.results[key], r.results[key], window=PORT_CFG.window)


def test_sweep_errors_and_resume(init_models, traces, tmp_path):
    (_, port), (_, pm) = init_models
    pt = traces["dee"][1]
    m = pm["u0"]
    twin = TrainedModel(params=m.params, cfg=PORT_CFG, name=m.name, device=CPU)
    with pytest.raises(ValueError, match="duplicate model name"):
        port.sweep([m, twin], [pt])
    with pytest.raises(ValueError, match="duplicate trace name"):
        port.sweep([m], [pt, port.capture("lee", 800, name=pt.name)])
    other = dataclasses.replace(PORT_CFG, window=21)
    alien = TrainedModel(params=init_tao(other, device=CPU), cfg=other, name="alien", device=CPU)
    with pytest.raises(ValueError, match="different TaoConfig"):
        port.sweep([alien], [pt])
    with pytest.raises(ValueError, match="route must be"):
        port.sweep([m], [pt], route="numpy")
    sess = port_sess(batch_size=16, store=str(tmp_path))
    traces2 = [sess.capture("dee", 800), sess.capture("lee", 800)]
    first = sess.sweep(pm, traces2, resume_key="dse")
    again = sess.sweep(pm, traces2, resume_key="dse")
    assert first.jobs_skipped == 0 and again.jobs_skipped == len(again.results) == 4
    for k, res in first.results.items():
        assert_same_result(res, again.results[k])


# ---------------------------------------------------------------------------
# the artifact store
# ---------------------------------------------------------------------------


def test_second_session_on_a_store_trains_nothing(monkeypatch, tmp_path):
    kw = dict(epochs=1, batch_size=BATCH, lr=LR)
    a = port_sess(store=str(tmp_path))
    first = a.train(uarch.UARCH_A, [a.capture(*TRAIN_TRACE)], **kw)

    def refuse(*args, **kwargs):
        raise AssertionError("a warm store must not train")

    monkeypatch.setattr(port_session, "train_tao_impl", refuse)
    monkeypatch.setattr(port_session, "run_detailed", refuse)
    monkeypatch.setattr(port_session, "run_functional", refuse)
    b = port_sess(store=ArtifactStore(str(tmp_path)))
    again = b.train(uarch.UARCH_A, [b.capture(*TRAIN_TRACE)], **kw)
    assert again.losses == first.losses and again.steps == first.steps and again.seconds == 0.0
    assert_state_equal(again.params, first.params)
    assert again.store is b.store and again.device == torch.device(CPU)
    # another recipe is another key
    with pytest.raises(AssertionError, match="must not train"):
        b.train(uarch.UARCH_A, [b.capture(*TRAIN_TRACE)], **dict(kw, lr=2 * LR))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_entries_cross_read(monkeypatch, tmp_path, writer):
    """``"trace"``, ``"detail_summary"`` and ``"features_labeled"`` entries
    written by either package are hits for the other."""
    ref, port = ref_sess(store=str(tmp_path)), port_sess(store=str(tmp_path))
    w, rd = (ref, port) if writer == "ref" else (port, ref)
    wu, ru = s_uarch(w), s_uarch(rd)
    wt = w.capture("lee", 900)
    truth = w.ground_truth(wu.UARCH_A, wt)
    wds = w.dataset(wu.UARCH_A, [wt])

    def refuse(*args, **kwargs):
        raise AssertionError("a cross-read must hit the store")

    mod = ref_session if rd is ref else port_session
    monkeypatch.setattr(mod, "run_functional", refuse)
    monkeypatch.setattr(mod, "run_detailed", refuse)
    before = rd.store.counters["hits"]
    rt = rd.capture("lee", 900)
    np.testing.assert_array_equal(rt.functional, wt.functional)
    assert rd.ground_truth(ru.UARCH_A, rt) == truth
    rds = rd.dataset(ru.UARCH_A, [rt])
    assert_tree_equal(jax.tree.map(np.asarray, wds.inputs), jax.tree.map(np.asarray, rds.inputs))
    assert_tree_equal(jax.tree.map(np.asarray, wds.labels), jax.tree.map(np.asarray, rds.labels))
    after = rd.store.counters["hits"]
    assert after - before == 3


def test_quantized_params_key_and_int8_tree_cross_read(weights, tmp_path):
    params, model = weights
    key = port_session.quantized_params_key(model)
    assert key == ref_session.quantized_params_key(params)
    assert key == port_session.quantized_params_key(model.state_dict())
    ref_q = jax.tree.map(np.asarray, ref_quant.quantize_tao_params(params))
    q = quantize_tao_params(model)
    assert_tree_equal(ref_q, qparams_to_jax(q))      # the port's codes are the reference's
    sd = qparams_from_jax(qparams_to_jax(q))
    assert list(sd) == list(q.state_dict()) and all(torch.equal(sd[k], v) for k, v in q.state_dict().items())
    assert_tree_equal(qparams_to_jax(qparams_from_jax(ref_q)), ref_q)
    # the port writes, the reference reads
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    pm = TrainedModel(params=port_tao(params), cfg=PORT_CFG, store=ArtifactStore(str(port_dir)), device=CPU)
    pq = pm.quantized_params()
    assert pm.quantized_params() is pq and pm.store.counters["puts"] == 1
    rm = ref_api.TrainedModel(params=params, cfg=REF_CFG, store=RefStore(str(port_dir)))
    assert_tree_equal(jax.tree.map(np.asarray, rm.quantized_params()), ref_q)
    assert rm.store.counters["hits"] == 1 and rm.store.counters["puts"] == 0
    # the reference writes, the port reads
    ref_api.TrainedModel(params=params, cfg=REF_CFG, store=RefStore(str(ref_dir))).quantized_params()
    pm2 = TrainedModel(params=port_tao(params), cfg=PORT_CFG, store=ArtifactStore(str(ref_dir)), device=CPU)
    assert_state_equal(pm2.quantized_params(), q)
    assert pm2.store.counters["hits"] == 1 and pm2.store.counters["puts"] == 0
    # the stored tree is what an int8 engine of the model runs
    assert pm2.engine(precision="int8")._qparams is pm2.quantized_params()


# ---------------------------------------------------------------------------
# design space, warmup, surface
# ---------------------------------------------------------------------------


def test_design_space_matches_reference(monkeypatch):
    space, ref = DesignSpace.sample(5, seed=1), ref_api.DesignSpace.sample(5, seed=1)
    assert [dataclasses.asdict(d) for d in space] == [dataclasses.asdict(d) for d in ref]
    vary = DesignSpace.vary(uarch.UARCH_B, "l1d_size", [1024, 2048, 4096])
    ref_vary = ref_api.DesignSpace.vary(ref_uarch.UARCH_B, "l1d_size", [1024, 2048, 4096])
    assert [dataclasses.asdict(d) for d in vary] == [dataclasses.asdict(d) for d in ref_vary]
    assert len(vary) == 3 and vary[0].name == "l1d_size1024"
    calls = []
    real = port_session.measure_design_metrics

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(port_session, "measure_design_metrics", counting)
    for method in ("mahalanobis", "euclidean", "random"):
        got = space.select_pair(["dee"], method=method, instructions=500, seed=2)
        assert got == ref.select_pair(["dee"], method=method, instructions=500, seed=2), method
    assert len(calls) == 1  # one detailed-sim pass serves both distance methods
    with pytest.raises(ValueError, match="method must be"):
        space.select_pair(["dee"], method="cosine")


def test_warmup_keys_and_engine_cache_warning(weights):
    sess = port_sess(batch_size=16)
    out = sess.warmup([900, (600, 8)], train=[{"batch_size": 4}])
    assert set(out) == {"sim_geometries", "sim_aot", "train_steps", "compile_cache"}
    assert (out["sim_geometries"], out["sim_aot"], out["train_steps"]) == (2, 0, 1)
    assert set(out["compile_cache"]) == set(ref_api.persistent_cache_status())
    model = TrainedModel(params=port_tao(weights[0]), cfg=PORT_CFG, name="w", device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for b in range(1, 8):
            model.engine(batch_size=b)
    with pytest.warns(RuntimeWarning, match="8 engine configurations cached on model 'w'"):
        model.engine(batch_size=8)
    assert model.engine(batch_size=8) is model.engine(api.EngineConfig(batch_size=8))


def test_compile_cache_option(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(port_session, "enable_persistent_cache", lambda *a: seen.append(a))
    for opt in (None, False):
        port_sess(store=str(tmp_path), compile_cache=opt)
    assert seen == []
    port_sess(compile_cache=True)
    port_sess(compile_cache=str(tmp_path / "kernels"))
    assert seen == [(), (str(tmp_path / "kernels"),)]


def test_api_surface_is_the_reference_whole():
    """Nothing is left out: the facade's surface is the reference's whole,
    the six serve names included."""
    assert api.__all__ == ref_api.__all__
    assert SERVE_NAMES <= set(api.__all__)
    assert all(hasattr(api, n) for n in api.__all__)
    assert port_session.__all__ == ref_session.__all__


def test_session_without_device_raises_without_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for call in (lambda: Session(PORT_CFG), lambda: TrainedModel(params=weights[1], cfg=PORT_CFG),
                 lambda: JointModel(params=port_ma.init_multiarch(PORT_CFG, device=CPU), cfg=PORT_CFG,
                                    method="tao", losses=[])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# deprecation shims
# ---------------------------------------------------------------------------


def test_simulate_trace_shim_warns_and_matches(weights, traces):
    from repro_torch.core import simulate_trace

    pt = traces["mcf"][1]
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        old = simulate_trace(weights[1], pt.functional, PORT_CFG, batch_size=13, device=CPU)
    new = TrainedModel(params=weights[1], cfg=PORT_CFG, device=CPU).simulate(pt, collect=True, batch_size=13)
    assert_same_result(old, new)


def test_train_tao_shim_warns_and_matches(sessions, traces):
    from repro_torch.core import train_tao

    _, port = sessions
    ds = port.dataset(uarch.UARCH_A, traces["dee"][1]).subsample(16)
    with pytest.warns(DeprecationWarning, match="Session.train"):
        old = train_tao(PORT_CFG, ds, epochs=2, batch_size=8, lr=2e-3, seed=3, device=CPU)
    new = port.train(dataset=ds, epochs=2, batch_size=8, lr=2e-3, seed=3)
    assert old.losses == new.losses
    assert_state_equal(old.params, new.params)


def test_facade_emits_no_deprecation_warnings(sessions, traces, weights):
    _, port = sessions
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ds = port.dataset(uarch.UARCH_A, traces["dee"][1]).subsample(8)
        port.train(dataset=ds, epochs=1, batch_size=8)
        TrainedModel(params=weights[1], cfg=PORT_CFG, device=CPU).simulate(traces["mcf"][1])
    ours = [w for w in rec if issubclass(w.category, DeprecationWarning) and "repro" in str(w.message)]
    assert not ours, [str(w.message) for w in ours]
