"""The port's trace server against the reference's, on the CPU.

``repro_torch.serve`` (``TraceServer``, ``ModelRegistry``, the wire
types), ``repro_torch.resilience.{retry,breaker}`` and
``repro_torch.launch.serve`` are held to ``repro.serve``,
``repro.resilience`` and ``repro.launch.serve`` at the reference serve
tests' config (``tests/test_serve.py``) and traces.  The port's models
hold the reference's ``jax.random`` weights (``params_from_jax``).  Each
test of ``tests/test_serve.py`` and each server, TCP, retry and breaker
test of ``tests/test_resilience.py`` has its counterpart here, run on
both packages with the same requests:

  * every result is bitwise the port's own direct ``TrainedModel.simulate``
    of the same model, trace, route and precision, and held to the
    reference server's result for the same request through the engine's
    flip contract (``tests/test_torch_engine.py::assert_explained_by_flips``
    on the two packages' direct runs of that pair, which bound the
    scalars' differences);
  * counters, ``stats()`` keys, error codes and completion orders equal
    the reference's for the same sequence;
  * ``encode_trace`` gives the reference's bytes and either package
    decodes the other's; ``serve_model`` and int8 store entries published
    by either package resolve in the other, params bitwise;
  * ``RetryPolicy`` and ``CircuitBreaker`` go through the reference's
    states under a stepped clock.

The port's route takes the reference's ``feature_backend`` place
(``fused`` / ``staged`` / ``host`` for ``fused`` / ``pallas`` /
``numpy``).  The reference's tests run on its default ``numpy`` backend,
so their counterparts run the port's ``host`` route; tests that do not
depend on the route run on each.
"""
import asyncio
import dataclasses
import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro import resilience as ref_resilience  # noqa: E402
from repro import serve as ref_serve  # noqa: E402
from repro.api.session import quantized_params_key as ref_qkey  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.core.quant import quantize_tao_params as ref_quantize  # noqa: E402
from repro.engine import runner as ref_runner  # noqa: E402
from repro.launch import serve as ref_launch  # noqa: E402
from repro.store import ArtifactStore as RefStore  # noqa: E402

import repro_torch.api as api  # noqa: E402
from repro_torch import resilience as port_resilience  # noqa: E402
from repro_torch import serve as port_serve  # noqa: E402
from repro_torch.api.session import quantized_params_key  # noqa: E402
from repro_torch.convert import params_from_jax, qparams_from_jax  # noqa: E402
from repro_torch.core.features import FeatureConfig  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.core.quant import quantize_tao_params  # noqa: E402
from repro_torch.engine import EngineConfig, ExecutionPlan, StreamingEngine  # noqa: E402
from repro_torch.engine import runner as port_runner  # noqa: E402
from repro_torch.kernels.features.ops import device_feature_arrays, trace_columns  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.store import ArtifactStore  # noqa: E402

from test_torch_engine import INT8_CODE_FLIP_PROB_ATOL, assert_explained_by_flips  # noqa: E402

FCFG = (64, 4, 8)
MODEL = dict(window=9, d_model=16, n_heads=2, n_layers=1, d_ff=32, d_cat=8)
PORT_CFG = TaoConfig(features=FeatureConfig(*FCFG), **MODEL)
REF_CFG = ref_model.TaoConfig(features=ref_features.FeatureConfig(*FCFG), **MODEL)
BATCH = 8
# the reference serve and resilience tests' traces: long / mid / extra
# share the w9 geometry, short is w6
TRACES = {"long": ("mcf", 1200), "mid": ("dee", 600), "short": ("lee", 6), "extra": ("mcf", 300)}
ROUTES = ("fused", "staged", "host")
REF_BACKEND = {"fused": "fused", "staged": "pallas", "host": "numpy"}
# the metrics the direct runs are compared on (the flip contract reads the
# phase curves)
METRICS = ("cpi", "branch_mpki", "l1d_mpki", "cpi_phase", "l1d_phase", "dlevel_hist")
CPU = "cpu"


def _serve(coro):
    return asyncio.run(coro)


def same_metrics(a, b) -> bool:
    return set(a) == set(b) and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


@dataclasses.dataclass
class Side:
    """One package's serving surface, models and traces: the same
    scenario runs against each."""

    name: str
    serve: types.ModuleType
    resilience: types.ModuleType
    launch: types.ModuleType
    models: dict
    traces: dict

    def server(self, registry, route="host", **kw):
        if self.name == "port":
            return self.serve.TraceServer(registry, route=route, device=CPU, **kw)
        return self.serve.TraceServer(registry, feature_backend=REF_BACKEND[route], **kw)

    def registry(self, store=None):
        reg = (self.serve.ModelRegistry(store, device=CPU) if self.name == "port"
               else self.serve.ModelRegistry(store))
        for name, m in self.models.items():
            reg.register(name, m)
        return reg

    def request(self, model, trace, **kw):
        return self.serve.ServeRequest(model=model, trace=self.traces[trace], **kw)

    def store(self, root):
        return ArtifactStore(str(root)) if self.name == "port" else RefStore(str(root))


@pytest.fixture(scope="module")
def ref_params():
    return {name: ref_model.init_tao(jax.random.PRNGKey(i), REF_CFG)
            for i, name in enumerate(("base", "tuned"))}


def port_tao(tree):
    model = init_tao(PORT_CFG, device=CPU)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return model


@pytest.fixture(scope="module")
def sides(ref_params):
    ref_sess = ref_api.Session(REF_CFG, compile_cache=False)
    port_sess = api.Session(PORT_CFG, device=CPU)
    ref = Side("ref", ref_serve, ref_resilience, ref_launch,
               {n: ref_api.TrainedModel(params=p, cfg=REF_CFG, name=n) for n, p in ref_params.items()},
               {k: ref_sess.capture(b, n) for k, (b, n) in TRACES.items()})
    port = Side("port", port_serve, port_resilience, port_launch,
                {n: api.TrainedModel(params=port_tao(p), cfg=PORT_CFG, name=n, device=CPU)
                 for n, p in ref_params.items()},
                {k: port_sess.capture(b, n) for k, (b, n) in TRACES.items()})
    return port, ref


def both(sides, scenario):
    """``scenario(side)`` (a coroutine function) run to its end on the
    port, then on the reference."""
    return tuple(_serve(scenario(s)) for s in sides)


def port_engine_run(model, trace, route, precision, **kw):
    engine = StreamingEngine(model.params, PORT_CFG, EngineConfig(batch_size=BATCH, precision=precision,
                                                                  **kw), device=CPU)
    if route == "staged":
        fcfg = PORT_CFG.features
        return engine.simulate(trace, features=device_feature_arrays(trace_columns(trace, fcfg), fcfg,
                                                                     device=CPU))
    if route == "host":
        from repro_torch.core.features import extract_features

        return engine.simulate(trace, features=extract_features(trace, PORT_CFG.features,
                                                                with_labels=False))
    return engine.simulate(trace)


@pytest.fixture(scope="module")
def held(sides):
    """``held(port_result, ref_result, model, trace, route, precision)``:
    the port server's result is bitwise the port's direct simulate, and
    its scalars differ from the reference server's only as far as the
    flips between the two packages' direct runs of that pair allow."""
    port, ref = sides
    flips_of = {}

    def check(got, want, mname, tkey, route="host", precision="fp32"):
        pm = port.models[mname]
        direct = pm.simulate(port.traces[tkey], batch_size=BATCH, route=route, precision=precision)
        assert got.num_instructions == direct.num_instructions
        assert same_metrics(got.metrics, direct.metrics), (mname, tkey, route)
        if want is None:
            return
        key = (mname, tkey, route, precision)
        if key not in flips_of:
            trace = port.traces[tkey].functional
            g = port_engine_run(pm, trace, route, precision, collect=True, metrics=METRICS)
            eng = ref_runner.StreamingEngine(
                ref.models[mname].params, REF_CFG,
                ref_runner.EngineConfig(batch_size=BATCH, collect=True, metrics=METRICS,
                                        feature_backend=REF_BACKEND[route], precision=precision))
            r = eng.simulate(ref.traces[tkey].functional)
            atol = INT8_CODE_FLIP_PROB_ATOL if precision == "int8" else None
            flips_of[key] = assert_explained_by_flips(g, r, code_flip_atol=atol,
                                                      window=PORT_CFG.window)
        flips = flips_of[key]
        n = want.num_instructions
        assert got.num_instructions == n and set(got.metrics) == set(want.metrics)
        assert abs(got.metrics["cpi"] - want.metrics["cpi"]) <= 256.0 * (flips["fetch"] + flips["exec"]) / n
        assert abs(got.metrics["branch_mpki"] - want.metrics["branch_mpki"]) <= (
            1000.0 * flips["mispredict"] / n + 1e-12)
        assert abs(got.metrics["l1d_mpki"] - want.metrics["l1d_mpki"]) <= 1000.0 * flips["l1d"] / n + 1e-12

    return check


def host(tree):
    return jax.tree.map(np.asarray, tree)


def assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


def counts(stats) -> dict:
    """A ``ServerStats``'s counters and per-tenant books (no clocks)."""
    d = stats.to_dict()
    keep = ("admitted", "completed", "failed", "rejected", "queue_depth", "max_queue",
            "num_compiles", "features_extracted", "features_from_store", "features_coalesced",
            "plan_kind", "num_shards", "retries", "deadline_exceeded", "quarantined",
            "bisections", "breaker_sheds", "per_tenant")
    out = {k: d[k] for k in keep}
    out["per_geometry"] = {g: {k: v for k, v in s.items() if k in ("queued", "served")}
                           for g, s in d["per_geometry"].items()}
    out["breakers"] = {k: {f: v for f, v in b.items() if f != "retry_after_s"}
                       for k, b in d["breakers"].items()}
    return out


def clear_step_caches():
    port_runner.clear_step_cache()
    ref_runner.clear_step_cache()


# ---------------------------------------------------------------------------
# the traces and the wire surface
# ---------------------------------------------------------------------------


def test_traces_are_the_references(sides):
    port, ref = sides
    for k in TRACES:
        assert np.array_equal(port.traces[k].functional, ref.traces[k].functional)
        assert port.traces[k].digest == ref.traces[k].digest


def test_wire_types_and_codes_equal_the_references():
    assert port_serve.ERROR_CODES == ref_serve.ERROR_CODES
    for cls in ("ServeRequest", "ServeResult", "ServerStats"):
        assert ([f.name for f in dataclasses.fields(getattr(port_serve, cls))]
                == [f.name for f in dataclasses.fields(getattr(ref_serve, cls))])
    assert port_serve.__all__ == ref_serve.__all__
    for code in ref_serve.ERROR_CODES:
        kw = dict(retry_after_s=0.25, request_id="r7")
        assert (port_serve.ServeError(code, "m", **kw).to_dict()
                == ref_serve.ServeError(code, "m", **kw).to_dict())


# ---------------------------------------------------------------------------
# tests/test_serve.py, each on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_warm_server_mixed_load_zero_compiles(sides, held, route):
    load = {
        "alice": [("base", "long"), ("tuned", "short")],
        "bob": [("tuned", "long"), ("base", "mid")],
        "carol": [("base", "long"), ("base", "short")],
        "dave": [("tuned", "mid"), ("tuned", "long")],
    }

    async def run(side):
        server = side.server(side.registry(), route=route, batch_size=BATCH, max_queue=64)
        async with server:
            server.warmup([len(t) for t in side.traces.values()])
            warm = server.num_compiles

            async def tenant(name, jobs):
                futs = [server.submit(side.request(m, t, tenant=name)) for m, t in jobs]
                return await asyncio.gather(*futs)

            out = await asyncio.gather(*(tenant(name, jobs) for name, jobs in load.items()))
            stats = server.stats()
        return warm, out, stats, server.num_compiles

    (warm, out, stats, compiles), (rwarm, rout, rstats, rcompiles) = both(sides, run)
    assert warm == compiles == stats.num_compiles == 0
    assert counts(stats) == counts(rstats) and (rwarm, rcompiles) == (0, 0)
    assert stats.completed == 8 and stats.failed == 0
    # one pre-pass per distinct trace on the host route, none elsewhere
    assert (stats.features_extracted, stats.features_coalesced) == ((3, 5) if route == "host" else (0, 0))
    assert set(stats.per_geometry) == {"w9b8", "w6b8"}
    assert set(stats.to_dict()) == set(rstats.to_dict())
    for (tname, jobs), res, rres in zip(load.items(), out, rout):
        for (mname, tkey), r, rr in zip(jobs, res, rres):
            assert r.tenant == tname and r.model == mname
            held(r, rr, mname, tkey, route)


def test_tenant_fairness_interleaving(sides):
    async def run(side):
        order = []
        server = side.server(side.registry(), batch_size=BATCH, max_queue=64)
        async with server:
            futs = []
            for tenant, count in (("A", 12), ("B", 4)):
                for i in range(count):
                    f = server.submit(side.request("base", "long", tenant=tenant,
                                                   request_id=f"{tenant}{i}"))
                    f.add_done_callback(lambda _f: order.append(_f.result().request_id))
                    futs.append(f)
            await asyncio.gather(*futs)
        return order

    order, rorder = both(sides, run)
    assert order == rorder and len(order) == 16
    b_slots = [i for i, rid in enumerate(order) if rid.startswith("B")]
    assert len(b_slots) == 4
    for k, slot in enumerate(b_slots):
        assert slot <= 2 * k + 1, (order, b_slots)


def test_backpressure_queue_full_and_recovery(sides):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH, max_queue=4)
        async with server:
            futs = [server.submit(side.request("base", "short")) for _ in range(4)]
            with pytest.raises(side.serve.ServeError) as ei:
                server.submit(side.request("base", "short"))
            err = ei.value
            assert err.code == "QUEUE_FULL"
            assert err.retry_after_s is not None and err.retry_after_s > 0
            d = err.to_dict()
            assert d["error"] == "QUEUE_FULL" and "retry_after_s" in d
            rejected_at = server.stats().rejected
            await asyncio.gather(*futs)
            r = await server.submit(side.request("base", "short"))
            assert r.num_instructions == len(side.traces["short"])
            return rejected_at, server.stats()

    (rejected_at, stats), (rrejected_at, rstats) = both(sides, run)
    assert rejected_at == rrejected_at == 1
    assert stats.rejected == 1 and stats.completed == 5
    assert counts(stats) == counts(rstats)


def test_feature_coalescing_across_models_and_store(sides, tmp_path):
    """The host route's pre-pass: one extraction serves three requests (two
    models, one digest); a fresh server over the same store extracts
    nothing.  The feature entries' keys are the reference's, so a port
    server over the reference's store finds its features too."""
    def scenario(root, regs):
        async def run(side):
            store = side.store(root)
            server = side.server(regs[side.name], batch_size=BATCH, store=store)
            async with server:
                futs = [server.submit(side.request(m, "mid")) for m in ("base", "tuned", "base")]
                out = await asyncio.gather(*futs)
            return server.stats(), out
        return run

    port, ref = sides
    regs = {s.name: s.registry() for s in sides}
    (s1, out), (r1, rout) = both(sides, scenario(tmp_path / "shared", regs))
    assert (s1.features_extracted, s1.features_from_store, s1.features_coalesced) == (1, 0, 2)
    # the reference ran second over the store the port filled
    assert (r1.features_extracted, r1.features_from_store, r1.features_coalesced) == (0, 1, 2)
    # a fresh server per package over its own store, twice
    for side in sides:
        s_a = _serve(scenario(tmp_path / side.name, regs)(side))[0]
        reg2 = side.registry()
        s_b = _serve(scenario(tmp_path / side.name, {side.name: reg2})(side))[0]
        assert (s_a.features_extracted, s_a.features_from_store, s_a.features_coalesced) == (1, 0, 2)
        assert (s_b.features_extracted, s_b.features_from_store, s_b.features_coalesced) == (0, 1, 2)


def test_error_codes_unknown_model_bad_request(sides):
    async def run(side):
        codes = []
        server = side.server(side.registry(), batch_size=BATCH)
        async with server:
            empty = np.empty(0, side.traces["short"].functional.dtype)
            for req in (side.request("nope", "short"),
                        side.serve.ServeRequest(model="base", trace=empty),
                        side.request("base", "short", metrics=("no_such_metric",))):
                with pytest.raises(side.serve.ServeError) as ei:
                    server.submit(req)
                codes.append(ei.value.code)
        return codes, server.stats()

    (codes, stats), (rcodes, rstats) = both(sides, run)
    assert codes == rcodes == ["UNKNOWN_MODEL", "BAD_REQUEST", "BAD_REQUEST"]
    assert counts(stats) == counts(rstats)


def test_error_wrap_mapping_never_leaks():
    from repro_torch.engine.runner import MetricNotCollectedError, MetricNotComputedError

    ServeError = port_serve.ServeError
    assert ServeError.wrap(MetricNotCollectedError("x")).code == "METRIC_NOT_COLLECTED"
    assert ServeError.wrap(MetricNotComputedError("x")).code == "METRIC_NOT_COMPUTED"
    e = ServeError.wrap(RuntimeError("secret internal path /etc/x"))
    assert e.code == "INTERNAL"
    assert "secret" not in e.message and "/etc" not in e.message
    assert e.to_dict() == ref_serve.ServeError.wrap(RuntimeError("secret")).to_dict()
    orig = ServeError("QUEUE_FULL", "full", retry_after_s=1.0)
    assert ServeError.wrap(orig) is orig
    with pytest.raises(ValueError):
        ServeError("NOT_A_CODE", "x")


def test_shutdown_rejects_and_drain_false_fails_pending(sides):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH)
        await server.start()
        fut = server.submit(side.request("base", "short"))
        await server.stop(drain=False)
        with pytest.raises(side.serve.ServeError) as ei:
            await fut
        with pytest.raises(side.serve.ServeError) as ei2:
            server.submit(side.request("base", "short"))
        return ei.value.code, ei2.value.code, server.stats()

    (c1, c2, stats), (r1, r2, rstats) = both(sides, run)
    assert (c1, c2) == (r1, r2) == ("SHUTTING_DOWN", "SHUTTING_DOWN")
    assert counts(stats) == counts(rstats)


def test_registry_publish_resolve_roundtrip(sides, tmp_path):
    port, _ = sides
    models = port.models
    store = ArtifactStore(str(tmp_path / "s"))
    reg = port_serve.ModelRegistry(store, device=CPU)
    reg.register("served", models["base"], publish=True)
    assert "served" in reg and len(reg) == 1

    reg2 = port_serve.ModelRegistry(store, device=CPU)
    assert "served" in reg2
    assert dict(reg2.published())["served"]["cfg"]["window"] == PORT_CFG.window
    m = reg2.resolve("served")
    assert m.cfg == PORT_CFG and m.device == torch.device(CPU) and m.store is store
    r_direct = models["base"].simulate(port.traces["short"], batch_size=BATCH)
    assert same_metrics(m.simulate(port.traces["short"], batch_size=BATCH).metrics, r_direct.metrics)

    with pytest.raises(ValueError, match="overwrite"):
        reg2.publish("served", models["tuned"])
    reg2.publish("served", models["tuned"], overwrite=True)
    got = port_serve.ModelRegistry(store, device=CPU).resolve("served")
    want = models["tuned"].params.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in got.params.state_dict().items())

    with pytest.raises(port_serve.ServeError) as ei:
        port_serve.ModelRegistry(store, device=CPU).resolve("never-published")
    assert ei.value.code == "UNKNOWN_MODEL"


@pytest.mark.parametrize("route", ROUTES)
def test_registry_entries_cross_read_both_ways(sides, ref_params, tmp_path, route):
    """A ``serve_model`` entry published by either package resolves in the
    other: the same key, the same extra (the reference's config dict,
    ``sim_feature_backend`` for the route), params bitwise, and the int8
    tree under the same ``quantized_params_key``."""
    port, ref = sides
    pm = dataclasses.replace(port.models["base"], sim_route=route, sim_batch_size=16)
    rm = dataclasses.replace(ref.models["base"], sim_feature_backend=REF_BACKEND[route],
                             sim_batch_size=16)
    assert port_serve.ModelRegistry.key("m") == ref_serve.ModelRegistry.key("m")
    # the port publishes, the reference resolves
    root_p, root_r = str(tmp_path / "p"), str(tmp_path / "r")
    port_serve.ModelRegistry(root_p, device=CPU).publish("m", pm)
    ref_serve.ModelRegistry(root_r).publish("m", rm)
    extras = [dict(reg.published())["m"] for reg in (port_serve.ModelRegistry(root_p, device=CPU),
                                                     ref_serve.ModelRegistry(root_r))]
    assert extras[0] == extras[1]
    assert extras[0]["sim_feature_backend"] == REF_BACKEND[route] and not extras[0]["cfg"]["use_pallas"]
    got = ref_serve.ModelRegistry(root_p).resolve("m")
    assert got.cfg == REF_CFG and got.sim_feature_backend == REF_BACKEND[route]
    assert_same_state(params_from_jax(host(got.params)), params_from_jax(host(ref_params["base"])))
    q = RefStore(root_p).get("params_int8", ref_qkey(ref_params["base"]))
    assert_same_state(qparams_from_jax(host(q[0])), qparams_from_jax(host(ref_quantize(ref_params["base"]))))
    # the reference publishes, the port resolves
    m = port_serve.ModelRegistry(root_r, device=CPU).resolve("m")
    assert m.cfg == PORT_CFG and m.sim_route == route and m.sim_batch_size == 16
    assert_same_state(m.params.state_dict(), pm.params.state_dict())
    key = quantized_params_key(m.params)
    assert key == ref_qkey(ref_params["base"])
    q = ArtifactStore(root_r).get("params_int8", key)
    assert_same_state(qparams_from_jax(q[0]), quantize_tao_params(pm.params).state_dict())


def test_set_plan_single_and_sharded_refused(sides):
    """The reference's plan switch needs two devices (a mesh); the port
    runs one: ``set_plan`` takes the single plan, between requests and
    without a restart, and refuses a sharded one."""
    port, _ = sides

    async def run():
        server = port.server(port.registry(), batch_size=BATCH)
        async with server:
            r1 = await server.submit(port.request("base", "long"))
            plan = server.set_plan(plan=ExecutionPlan.single())
            assert plan.kind == "single" and plan.num_shards == 1
            r2 = await server.submit(port.request("base", "long"))
            with pytest.raises(NotImplementedError):
                server.set_plan(plan=ExecutionPlan(kind="sharded"))
            assert server.set_plan().kind == "single"
            r3 = await server.submit(port.request("base", "long"))
            return (r1, r2, r3), server.stats()

    res, stats = _serve(run())
    assert all(same_metrics(r.metrics, res[0].metrics) for r in res)
    assert stats.plan_kind == "single" and stats.num_shards == 1


def tcp_exchange(side, lines, read, max_line_bytes=None, then=None):
    """Send raw ``lines`` to ``serve_forever`` over one connection, read
    ``read`` response lines (then ``then``'s lines, one response each)."""
    async def run():
        server = side.server(side.registry(), batch_size=BATCH, max_queue=16)
        async with server:
            ready = asyncio.get_running_loop().create_future()
            kw = {} if max_line_bytes is None else {"max_line_bytes": max_line_bytes}
            tcp = asyncio.get_running_loop().create_task(
                side.launch.serve_forever(server, "127.0.0.1", 0, ready, **kw))
            _, port = await ready
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            for line in lines:
                writer.write(line)
            await writer.drain()
            resps = [json.loads(await reader.readline()) for _ in range(read)]
            for line in then or ():
                writer.write(line)
                await writer.drain()
                resps.append(json.loads(await reader.readline()))
            eof = await reader.readline() if max_line_bytes is not None else None
            writer.close()
            tcp.cancel()
        return resps, eof, server.stats()

    return _serve(run())


def test_tcp_front_end_simulate_stats_models(sides, held):
    outs = []
    for side in sides:
        enc = side.serve.encode_trace(side.traces["short"].functional)
        lines = [json.dumps(o).encode() + b"\n" for o in (
            {"op": "models"},
            {"op": "simulate", "model": "base", "tenant": "wire", "request_id": "w0", "trace": enc},
            {"op": "simulate", "model": "nope", "request_id": "w1", "trace": enc})]
        outs.append(tcp_exchange(side, lines + [b"this is not json\n"], 4,
                                 then=[b'{"op": "stats"}\n']))

    def by_kind(resps):
        out = {}
        for r in resps:
            if "models" in r:
                out["models"] = r
            elif "stats" in r:
                out["stats"] = r
            elif r.get("ok") and "result" in r:
                out["result"] = r
            elif r.get("error") == "UNKNOWN_MODEL":
                out["unknown"] = r
            elif r.get("error") == "BAD_REQUEST":
                out["bad"] = r
        return out

    got, want = by_kind(outs[0][0]), by_kind(outs[1][0])
    assert set(got) == set(want) == {"models", "stats", "result", "unknown", "bad"}
    assert got["models"] == want["models"] == {"ok": True, "models": ["base", "tuned"]}
    assert got["unknown"] == want["unknown"]
    assert set(got["stats"]["stats"]) == set(want["stats"]["stats"])
    assert got["stats"]["stats"]["completed"] >= 1
    res, rres = got["result"]["result"], want["result"]["result"]
    assert set(res) == set(rres) and res["request_id"] == "w0" and res["metrics"]["cpi"] > 0
    as_result = [port_serve.ServeResult(**{k: v for k, v in r.items()}) for r in (res, rres)]
    held(*as_result, "base", "short")


def test_trace_wire_codec_roundtrip(sides):
    port, ref = sides
    arr = port.traces["mid"].functional
    enc = port_serve.encode_trace(arr)
    json.dumps(enc)
    assert enc == ref_serve.encode_trace(ref.traces["mid"].functional)  # the reference's bytes
    for dec in (port_serve.decode_trace(enc), ref_serve.decode_trace(enc),
                port_serve.decode_trace(ref_serve.encode_trace(arr))):
        assert dec.dtype == arr.dtype
        np.testing.assert_array_equal(dec, arr)
    bad = dict(enc)
    bad["shape"] = [len(arr) + 1]
    with pytest.raises(ValueError, match="bytes"):
        port_serve.decode_trace(bad)


def test_to_dict_contracts_json_clean(sides, held):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH)
        async with server:
            r = await server.submit(side.request("base", "mid", request_id="rid"))
            stats = server.stats()
        return r, stats

    (r, stats), (rr, rstats) = both(sides, run)
    assert isinstance(r, port_serve.ServeResult)
    d = json.loads(json.dumps(r.to_dict()))
    assert list(d) == list(rr.to_dict())
    assert d["request_id"] == "rid" and d["geometry"] == "w9b8"
    assert isinstance(d["metrics"]["cpi"], float)
    sd = json.loads(json.dumps(stats.to_dict()))
    assert list(sd) == list(rstats.to_dict())
    assert sd["completed"] == 1 and "per_geometry" in sd
    assert set(sd["per_geometry"]["w9b8"]) == set(rstats.to_dict()["per_geometry"]["w9b8"])
    held(r, rr, "base", "mid")


# ---------------------------------------------------------------------------
# tests/test_resilience.py: retry, breaker, the server's failure handling
# ---------------------------------------------------------------------------


def test_retry_policy_schedule_and_classifier():
    for res in (port_resilience, ref_resilience):
        rp = res.RetryPolicy(max_attempts=4, base_delay_s=0.01, multiplier=2.0, max_delay_s=0.03)
        assert [rp.delay(k) for k in (1, 2, 3, 4)] == pytest.approx([0.01, 0.02, 0.03, 0.03])
        with pytest.raises(ValueError):
            res.RetryPolicy(max_attempts=0)
    rp = port_resilience.RetryPolicy(max_attempts=5, base_delay_s=0.003, multiplier=3.0, max_delay_s=0.2)
    rrp = ref_resilience.RetryPolicy(max_attempts=5, base_delay_s=0.003, multiplier=3.0, max_delay_s=0.2)
    assert [rp.delay(k) for k in range(8)] == [rrp.delay(k) for k in range(8)]
    for exc in (port_resilience.FaultError("s", transient=True), OSError("flaky"),
                ConnectionResetError(), TimeoutError()):
        assert port_resilience.is_transient(exc)
    for exc in (port_resilience.FaultError("s", transient=False), ValueError("poison"),
                RuntimeError("x")):
        assert not port_resilience.is_transient(exc)


def breaker_walk(res):
    t = [0.0]
    br = res.CircuitBreaker(failure_threshold=2, cooldown_s=1.0, clock=lambda: t[0])
    seen = []

    def snap(*extra):
        seen.append((br.state, br.failures, br.trips, br.retry_after_s, *extra))

    snap(br.allow())
    br.record_failure()
    snap(br.allow())
    br.record_failure()
    snap(br.allow())
    t[0] = 1.5
    snap(br.allow(), br.allow())
    br.record_failure()
    snap(br.allow())
    t[0] = 3.0
    snap(br.allow())
    br.record_success()
    snap(br.allow(), json.dumps(br.snapshot()))
    with pytest.raises(ValueError):
        res.CircuitBreaker(failure_threshold=0)
    return seen


def test_circuit_breaker_state_machine():
    seen = breaker_walk(port_resilience)
    assert seen == breaker_walk(ref_resilience)
    assert [s[0] for s in seen] == ["closed", "closed", "open", "half-open", "open", "half-open",
                                    "closed"]
    assert seen[2][3] == pytest.approx(1.0) and seen[3][4:] == (True, False)
    assert json.loads(seen[-1][-1]) == {"state": "closed", "failures": 0, "trips": 2,
                                        "retry_after_s": 0.0}


def faulted(side, specs, **plan_kw):
    return side.resilience.FaultPlan(*(side.resilience.FaultSpec(*a, **kw) for a, kw in specs),
                                     **plan_kw)


@pytest.mark.parametrize("route", ROUTES)
def test_transient_dispatch_fault_retries_to_success(sides, held, route):
    async def run(side):
        plan = faulted(side, [(("serve.dispatch",), {"times": 2})])
        server = side.server(side.registry(), route=route, batch_size=BATCH,
                             retry=side.resilience.RetryPolicy(max_attempts=3, base_delay_s=0.005))
        async with server:
            with side.resilience.inject(plan):
                r = await server.submit(side.request("base", "long"))
            return r, server.stats()

    (r, stats), (rr, rstats) = both(sides, run)
    assert stats.retries == 2 and stats.completed == 1 and stats.failed == 0
    assert counts(stats) == counts(rstats)
    held(r, rr, "base", "long", route)


def test_transient_extract_fault_retries_without_poisoning_cache(sides, held):
    async def run(side):
        plan = faulted(side, [(("serve.extract",), {"times": 1, "exc": "OSError"})])
        server = side.server(side.registry(), batch_size=BATCH,
                             retry=side.resilience.RetryPolicy(max_attempts=3, base_delay_s=0.005))
        async with server:
            with side.resilience.inject(plan):
                r1 = await server.submit(side.request("base", "mid"))
            r2 = await server.submit(side.request("tuned", "mid"))
            return r1, r2, server.stats()

    (r1, r2, stats), (rr1, rr2, rstats) = both(sides, run)
    assert stats.retries >= 1 and stats.failed == 0
    assert counts(stats) == counts(rstats)
    held(r1, rr1, "base", "mid")
    held(r2, rr2, "tuned", "mid")


@pytest.mark.parametrize("route", ROUTES)
def test_poison_trace_bisected_quarantined_cohabitants_unharmed(sides, held, route):
    async def run(side):
        poison = side.traces["mid"]
        plan = faulted(side, [(("serve.dispatch",), {"match": poison.digest, "times": None,
                                                     "transient": False, "exc": "ValueError"})])
        server = side.server(side.registry(), route=route, batch_size=BATCH, group_size=4)
        async with server:
            with side.resilience.inject(plan):
                futs = [server.submit(side.request("base", t)) for t in ("long", "mid", "extra")]
                out = await asyncio.gather(*futs, return_exceptions=True)
                with pytest.raises(side.serve.ServeError) as ei:
                    server.submit(side.serve.ServeRequest(model="base", trace=poison))
                again = await server.submit(side.request("base", "extra"))
            return out, ei.value.code, again, server.stats()

    ((r_long, r_poison, r_extra), code, again, stats), (rout, rcode, ragain, rstats) = both(sides, run)
    assert code == rcode == "TRACE_REJECTED"
    assert isinstance(r_poison, port_serve.ServeError) and r_poison.code == "TRACE_REJECTED"
    assert r_poison.to_dict() == rout[1].to_dict()
    assert stats.quarantined == 1 and stats.bisections >= 1 and stats.retries == 0
    assert counts(stats) == counts(rstats)
    for r, rr, key in ((r_long, rout[0], "long"), (r_extra, rout[2], "extra"), (again, ragain, "extra")):
        held(r, rr, "base", key, route)


def test_deadline_exceeded_on_hung_dispatch_then_recovers(sides, held):
    """The reference's test, then past the delay: the abandoned dispatch
    thread, once awake, drops its request instead of simulating it beside
    the fresh thread (one ``engine.simulate`` in all: the next request's;
    the reference's thread simulates the hung request too)."""
    async def run(side):
        plan = faulted(side, [(("serve.dispatch",), {"kind": "delay", "delay_s": 0.5, "times": 1})])
        server = side.server(side.registry(), batch_size=BATCH)
        async with server:
            with side.resilience.inject(plan):
                with pytest.raises(side.serve.ServeError) as ei:
                    await server.submit(side.request("base", "long", deadline_s=0.15))
                r = await server.submit(side.request("base", "extra"))
                await asyncio.sleep(0.6)   # the hung thread wakes meanwhile
            return ei.value.code, r, server.stats(), plan.hits.get("engine.simulate", 0)

    (code, r, stats, sims), (rcode, rr, rstats, rsims) = both(sides, run)
    assert code == rcode == "DEADLINE_EXCEEDED"
    assert stats.deadline_exceeded == 1 and stats.completed == 1
    assert counts(stats) == counts(rstats)
    assert sims == 1
    held(r, rr, "base", "extra")


@pytest.mark.parametrize("route", ROUTES)
def test_abandoned_thread_drops_its_group_and_cohabitants_rerun(sides, held, route):
    """A group of two whose first request hangs past its deadline: the
    cohabitant re-runs on the fresh dispatch thread, bitwise, and the woken
    thread simulates neither (one ``engine.simulate`` in all)."""
    async def run(side):
        plan = faulted(side, [(("serve.dispatch",), {"kind": "delay", "delay_s": 0.5, "times": 1})])
        server = side.server(side.registry(), route=route, batch_size=BATCH, group_size=2)
        async with server:
            with side.resilience.inject(plan):
                futs = [server.submit(side.request("base", "long", deadline_s=0.15)),
                        server.submit(side.request("tuned", "extra"))]
                out = await asyncio.gather(*futs, return_exceptions=True)
                await asyncio.sleep(0.6)
            return out, server.stats(), plan.hits.get("engine.simulate", 0)

    (out, stats, sims), (rout, rstats, rsims) = both(sides, run)
    assert isinstance(out[0], port_serve.ServeError) and out[0].code == "DEADLINE_EXCEEDED"
    assert rout[0].code == "DEADLINE_EXCEEDED"
    assert counts(stats) == counts(rstats)
    assert sims == 1 and rsims >= 2
    held(out[1], rout[1], "tuned", "extra", route)


def test_deadline_spent_in_queue_expires_without_dispatch(sides):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH, deadline_s=0.0)
        async with server:
            with pytest.raises(side.serve.ServeError) as ei:
                await server.submit(side.request("base", "extra"))
            r = await server.submit(side.request("base", "extra", deadline_s=30.0))
            return ei.value.code, r.num_instructions, server.stats()

    (code, n, stats), (rcode, rn, rstats) = both(sides, run)
    assert code == rcode == "DEADLINE_EXCEEDED" and n == rn
    assert stats.deadline_exceeded == 1 and stats.completed == 1
    assert counts(stats) == counts(rstats)


def test_breaker_trips_sheds_and_recovers_after_cooldown(sides, held):
    async def run(side):
        plan = faulted(side, [(("serve.dispatch",), {"times": 4, "transient": True})])
        server = side.server(side.registry(), batch_size=BATCH,
                             retry=side.resilience.RetryPolicy(max_attempts=2, base_delay_s=0.002),
                             breaker_threshold=2, breaker_cooldown_s=0.25)
        codes = []
        async with server:
            with side.resilience.inject(plan):
                for _ in range(2):
                    with pytest.raises(side.serve.ServeError) as ei:
                        await server.submit(side.request("base", "long"))
                    codes.append(ei.value.code)
                with pytest.raises(side.serve.ServeError) as ei:
                    server.submit(side.request("base", "long"))
                codes.append(ei.value.code)
                assert ei.value.retry_after_s is not None and ei.value.retry_after_s > 0
                open_stats = server.stats()
                await asyncio.sleep(0.3)
                r = await server.submit(side.request("base", "long"))
            return codes, open_stats, r, server.stats()

    (codes, open_stats, r, stats), (rcodes, ropen, rr, rstats) = both(sides, run)
    assert codes == rcodes == ["INTERNAL", "INTERNAL", "CIRCUIT_OPEN"]
    assert open_stats.breaker_sheds == 1 and open_stats.retries == 2
    assert open_stats.breakers["base/w9b8"]["state"] == "open"
    assert stats.breakers["base/w9b8"]["state"] == "closed"
    assert counts(open_stats) == counts(ropen) and counts(stats) == counts(rstats)
    sd = json.loads(json.dumps(stats.to_dict()))
    assert sd["breakers"]["base/w9b8"]["trips"] == 1
    held(r, rr, "base", "long")


def test_chaos_smoke_mixed_load_stays_available(sides):
    async def run(side):
        plan = faulted(side, [(("serve.dispatch",), {"times": 2}),
                              (("serve.extract",), {"times": 1, "exc": "OSError"})], seed=7)
        server = side.server(side.registry(), batch_size=BATCH,
                             retry=side.resilience.RetryPolicy(max_attempts=3, base_delay_s=0.005))
        async with server:
            with side.resilience.inject(plan):
                futs = [server.submit(side.serve.ServeRequest(
                    model=("base", "tuned")[i % 2], trace=side.traces[("long", "mid", "extra")[i % 3]],
                    tenant=f"t{i % 3}")) for i in range(6)]
                out = await asyncio.gather(*futs, return_exceptions=True)
            r = await server.submit(side.request("base", "extra"))
            return out, r, server.stats(), sum(plan.hits.values())

    (out, r, stats, hits), (rout, rr, rstats, rhits) = both(sides, run)
    assert hits > 0
    for item, ritem in zip(out, rout):
        if isinstance(item, BaseException):
            assert isinstance(item, port_serve.ServeError) and item.code in port_serve.ERROR_CODES
            assert item.code == ritem.code
        else:
            assert isinstance(item, port_serve.ServeResult) and not isinstance(ritem, BaseException)
    assert isinstance(r, port_serve.ServeResult)
    assert stats.admitted == stats.completed + stats.failed
    assert counts(stats) == counts(rstats)


def test_shutdown_drain_serves_admitted_but_unbatched(sides):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH)
        await server.start()
        futs = [server.submit(side.request("base", "extra", request_id=f"d{i}")) for i in range(3)]
        await server.shutdown(drain=True)
        return await asyncio.gather(*futs), server.stats()

    (results, stats), (rresults, rstats) = both(sides, run)
    assert all(isinstance(r, port_serve.ServeResult) for r in results)
    assert [r.request_id for r in results] == [r.request_id for r in rresults]
    assert stats.completed == 3 and stats.failed == 0
    assert counts(stats) == counts(rstats)


def test_shutdown_drain_waits_for_parked_retry(sides):
    async def run(side):
        plan = faulted(side, [(("serve.dispatch",), {"times": 1})])
        server = side.server(side.registry(), batch_size=BATCH,
                             retry=side.resilience.RetryPolicy(max_attempts=3, base_delay_s=0.05))
        await server.start()
        with side.resilience.inject(plan):
            fut = server.submit(side.request("base", "extra"))
            await server.shutdown(drain=True)
            r = await fut
        return r.num_instructions, server.stats()

    (n, stats), (rn, rstats) = both(sides, run)
    assert n == rn and stats.retries == 1 and stats.failed == 0
    assert counts(stats) == counts(rstats)


def test_shutdown_kill_fails_parked_retry_with_stable_code(sides):
    async def run(side):
        plan = faulted(side, [(("serve.dispatch",), {"times": None, "transient": True})])
        server = side.server(side.registry(), batch_size=BATCH,
                             retry=side.resilience.RetryPolicy(max_attempts=10, base_delay_s=0.2))
        await server.start()
        with side.resilience.inject(plan):
            fut = server.submit(side.request("base", "extra"))
            await server.stop(drain=False)
            with pytest.raises(side.serve.ServeError) as ei:
                await fut
        return ei.value.code

    assert both(sides, run) == ("SHUTTING_DOWN", "SHUTTING_DOWN")


# ---------------------------------------------------------------------------
# tests/test_resilience.py: the TCP front end under hostile input
# ---------------------------------------------------------------------------


def test_tcp_oversized_line_structured_error_and_close(sides):
    outs = [tcp_exchange(side, [b"x" * 4096 + b"\n"], 1, max_line_bytes=1024) for side in sides]
    ([resp], eof, _), ([rresp], reof, _) = outs
    assert resp == rresp and resp["ok"] is False and resp["error"] == "BAD_REQUEST"
    assert "line" in resp["message"] and eof == reof == b""


def test_tcp_truncated_request_structured_error(sides):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH)
        async with server:
            ready = asyncio.get_running_loop().create_future()
            tcp = asyncio.get_running_loop().create_task(
                side.launch.serve_forever(server, "127.0.0.1", 0, ready))
            _, port = await ready
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b'{"op": "stats"')
            await writer.drain()
            writer.write_eof()
            resp = json.loads(await reader.readline())
            eof = await reader.readline()
            writer.close()
            tcp.cancel()
        return resp, eof

    (resp, eof), (rresp, reof) = both(sides, run)
    assert resp == rresp and resp["ok"] is False and resp["error"] == "BAD_REQUEST"
    assert "truncated" in resp["message"] and eof == reof == b""


def test_tcp_disconnect_mid_request_server_survives(sides):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH)
        async with server:
            ready = asyncio.get_running_loop().create_future()
            tcp = asyncio.get_running_loop().create_task(
                side.launch.serve_forever(server, "127.0.0.1", 0, ready))
            _, port = await ready
            r1, w1 = await asyncio.open_connection("127.0.0.1", port)
            w1.write(json.dumps({"op": "simulate", "model": "base",
                                 "trace": side.serve.encode_trace(side.traces["extra"].functional),
                                 }).encode() + b"\n")
            await w1.drain()
            w1.transport.abort()
            r2, w2 = await asyncio.open_connection("127.0.0.1", port)
            w2.write(b'{"op": "stats"}\n')
            await w2.drain()
            resp = json.loads(await r2.readline())
            w2.close()
            tcp.cancel()
        return resp, server.stats()

    (resp, stats), (rresp, rstats) = both(sides, run)
    assert resp["ok"] is True and "stats" in resp and set(resp["stats"]) == set(rresp["stats"])
    assert stats.admitted >= 1


def test_tcp_reply_fault_drops_only_that_response(sides):
    async def run(side):
        plan = faulted(side, [(("tcp.reply",), {"times": 1, "exc": "ConnectionResetError"})])
        server = side.server(side.registry(), batch_size=BATCH)
        async with server:
            ready = asyncio.get_running_loop().create_future()
            tcp = asyncio.get_running_loop().create_task(
                side.launch.serve_forever(server, "127.0.0.1", 0, ready))
            _, port = await ready
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            with side.resilience.inject(plan):
                writer.write(b'{"op": "models"}\n')
                writer.write(b'{"op": "models"}\n')
                await writer.drain()
                resp = json.loads(await reader.readline())
            writer.write(b'{"op": "stats"}\n')
            await writer.drain()
            resp2 = json.loads(await reader.readline())
            writer.close()
            tcp.cancel()
        return resp, resp2["ok"], set(resp2["stats"])

    got, want = both(sides, run)
    assert got == want and got[0] == {"ok": True, "models": ["base", "tuned"]} and got[1] is True


# ---------------------------------------------------------------------------
# the port's own: device lock paths, num_compiles, int8, the launcher
# ---------------------------------------------------------------------------


def test_num_compiles_counts_request_builds_like_the_reference(sides):
    """From cleared step caches: a cold server's requests build one step
    per geometry (the reference compiles one; the port, on the CPU, counts
    the step entries its requests built), a warm one none."""
    async def run(side, warm):
        reg = side.registry()
        for name in ("base", "tuned"):   # fresh engines: none holds a step yet
            reg.register(name, dataclasses.replace(side.models[name]))
        server = side.server(reg, batch_size=BATCH)
        async with server:
            if warm:
                server.warmup([len(t) for t in side.traces.values()])
            futs = [server.submit(side.request(m, t)) for m in ("base", "tuned")
                    for t in ("long", "short")]
            await asyncio.gather(*futs)
        return server.num_compiles, server.stats().num_compiles

    for warm in (False, True):
        clear_step_caches()
        got = tuple(_serve(run(side, warm)) for side in sides)
        assert got[0] == got[1] == ((0, 0) if warm else (2, 2)), (warm, got)


def test_store_resolved_and_int8_requests_are_bitwise_direct(sides, tmp_path):
    """A model published to a store and resolved by a fresh registry at
    admission, then an int8 request of it (its stored quantized tree):
    both bitwise the original model's direct simulate, the int8 one under
    ``precision="int8"``."""
    port, _ = sides
    store = ArtifactStore(str(tmp_path / "s"))
    port_serve.ModelRegistry(store, device=CPU).publish("pub", port.models["tuned"])
    qkey = quantized_params_key(port.models["tuned"].params)
    assert store.has("params_int8", qkey)

    async def run(precision):
        reg = port_serve.ModelRegistry(store, device=CPU)
        server = port.server(reg, route="fused", batch_size=BATCH, precision=precision)
        async with server:
            out = await asyncio.gather(*(server.submit(port.request("pub", t)) for t in ("long", "short")))
        return out, store.counters["hits"]

    hits0 = store.counters["hits"]
    out, _ = _serve(run("fp32"))
    for r, t in zip(out, ("long", "short")):
        direct = port.models["tuned"].simulate(port.traces[t], batch_size=BATCH, route="fused")
        assert same_metrics(r.metrics, direct.metrics)
    out8, hits = _serve(run("int8"))
    assert hits - hits0 >= 3   # two resolves and the int8 tree
    for r, t in zip(out8, ("long", "short")):
        direct = port.models["tuned"].simulate(port.traces[t], batch_size=BATCH, route="fused",
                                               precision="int8")
        assert same_metrics(r.metrics, direct.metrics)


def test_int8_requests_held_to_the_reference_int8(sides, held):
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH, precision="int8")
        async with server:
            return await server.submit(side.request("base", "long"))

    r, rr = both(sides, run)
    held(r, rr, "base", "long", "host", "int8")


def test_device_lock_guards_the_dispatch_paths(sides, monkeypatch, tmp_path):
    """Every call that can touch the card runs under the server's device
    lock: the engine (and its step entry), the staged extraction, the
    simulate, a store-resolved model's placement and ``warmup``."""
    port, _ = sides
    seen = []
    store = ArtifactStore(str(tmp_path / "s"))
    port_serve.ModelRegistry(store, device=CPU).publish("tuned", port.models["tuned"])
    reg = port_serve.ModelRegistry(store, device=CPU)
    reg.register("base", port.models["base"])

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.append((name, server.device_lock._is_owned()))
            return fn(*a, **kw)
        return wrapped

    import repro_torch.serve.server as srv

    server = port.server(reg, route="staged", batch_size=BATCH)
    monkeypatch.setattr(srv, "device_feature_arrays", spy("staged", srv.device_feature_arrays))
    monkeypatch.setattr(StreamingEngine, "simulate", spy("simulate", StreamingEngine.simulate))
    monkeypatch.setattr(StreamingEngine, "step_entry_for", spy("entry", StreamingEngine.step_entry_for))
    monkeypatch.setattr(StreamingEngine, "warmup", spy("warmup", StreamingEngine.warmup))
    monkeypatch.setattr(api.TrainedModel, "engine", spy("engine", api.TrainedModel.engine))
    monkeypatch.setattr(api.TrainedModel, "__post_init__",
                        spy("placement", api.TrainedModel.__post_init__))

    async def run():
        async with server:
            server.warmup([len(port.traces["long"])], models=["base"])
            await server.submit(port.request("tuned", "long"))

    _serve(run())
    names = {n for n, _ in seen}
    assert {"staged", "simulate", "entry", "warmup", "engine", "placement"} <= names
    assert all(owned for _, owned in seen), seen


def test_server_registry_and_launcher_raise_without_cuda(sides):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    port, _ = sides
    reg = port.registry()
    for call in (lambda: port_serve.TraceServer(reg), lambda: port_serve.ModelRegistry(),
                 lambda: port_launch.main(["--demo"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="route"):
        port_serve.TraceServer(reg, route="pallas", device=CPU)


def test_launcher_demo_runs_on_the_cpu_when_asked(capsys):
    port_launch.main(["--demo", "--device", "cpu", "--batch-size", "8"])
    out = capsys.readouterr().out
    stats = json.loads(out[out.index("{"):])
    assert "warm: 0 request-attributed captures" in out
    assert stats["completed"] == 20 and stats["failed"] == 0 and stats["num_compiles"] == 0
    assert set(stats) == set(ref_serve.ServerStats.__dataclass_fields__)


@pytest.mark.parametrize("extract_async", [False, True], ids=["inline", "at_admission"])
def test_host_route_extraction_counts_like_the_reference(sides, held, extract_async):
    """Three requests of one trace on the host route: one extraction either
    way.  Inline (the CPU's default) the two later requests coalesce; with
    the pre-pass started at admission (the card's default) every request,
    the owner too, awaits the shared entry at dispatch and counts as
    coalesced — the reference's counting, held here."""
    async def run(side):
        server = side.server(side.registry(), batch_size=BATCH, extract_async=extract_async)
        async with server:
            out = await asyncio.gather(*(server.submit(side.request(m, "mid"))
                                         for m in ("base", "tuned", "base")))
        return out, server.stats()

    (out, stats), (rout, rstats) = both(sides, run)
    assert counts(stats) == counts(rstats)
    assert (stats.features_extracted, stats.features_coalesced) == (1, 3 if extract_async else 2)
    assert [r.coalesced for r in out] == [r.coalesced for r in rout]
    for r, rr, m in zip(out, rout, ("base", "tuned", "base")):
        held(r, rr, m, "mid")
