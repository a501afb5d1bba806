"""The port's ExecutionPlan against the reference's, on one device.

The port runs on one GPU, so its only plan is the single-device one: its
``describe``, ``cache_token``, ``num_shards``, ``local_batch`` and
``validate_batch`` are held to the reference's single plan exactly; a
sharded plan, a mesh or batch axes raise ``NotImplementedError``.  The
plan's ``AxisContext`` is the one place the step's reducers are defined
(the identity; shard 0).  ``EngineConfig(plan=ExecutionPlan.single())``
and ``EngineConfig()`` share one step-cache entry, as the train step's
``plan=None`` and single plan share one recipe entry.  ``device_put``'s
packed staging buffer (one pinned buffer and one copy per batch on the
card) round-trips every leaf bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine.plan import ExecutionPlan as RefPlan  # noqa: E402

from repro_torch.core.features import FeatureConfig  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.core.transfer import _make_step, warmup_train_step  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    AxisContext,
    EngineConfig,
    ExecutionPlan,
    StepContext,
    StreamingEngine,
    cache_stats,
    clear_step_cache,
)
from repro_torch.train import AdamWConfig  # noqa: E402

CFG = TaoConfig(features=FeatureConfig(32, 4, 8), window=9, d_model=16, n_heads=2, n_layers=1,
                d_ff=32, d_cat=16)


def test_single_plan_answers_equal_the_reference():
    got, ref = ExecutionPlan.single(), RefPlan.single()
    assert got.kind == ref.kind == "single"
    assert got.describe() == ref.describe() == {
        "kind": "single", "num_shards": 1, "batch_axes": [], "mesh_shape": {}}
    assert got.cache_token() == ref.cache_token() == ("plan", "single", (), ())
    assert got.num_shards == ref.num_shards == 1
    assert got.sharded is ref.sharded is False
    for b in (1, 7, 64):
        assert got.local_batch(b) == ref.local_batch(b) == b
        assert got.validate_batch(b) is ref.validate_batch(b) is None
    assert ExecutionPlan.auto(64) == ExecutionPlan.single() == ExecutionPlan()
    assert hash(ExecutionPlan.single()) == hash(ExecutionPlan())


def test_resolve_passes_a_plan_through_and_defaults_to_single():
    plan = ExecutionPlan.single()
    assert ExecutionPlan.resolve(batch_size=8, plan=plan) is plan
    assert ExecutionPlan.resolve(batch_size=8) == plan
    assert RefPlan.resolve(batch_size=8) == RefPlan.single()


@pytest.mark.parametrize("make", [
    lambda: ExecutionPlan(kind="sharded"),
    lambda: ExecutionPlan(kind="single", mesh=object()),
    lambda: ExecutionPlan(kind="single", batch_axes=("data",)),
    lambda: ExecutionPlan.resolve(object(), batch_size=8),
    lambda: AxisContext(axes=("data",), sizes=(2,)),
], ids=["sharded_kind", "mesh", "batch_axes", "resolve_mesh", "axis_context_axes"])
def test_sharded_plans_and_meshes_are_not_ported(make):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make()


def test_unknown_kind_raises_value_error_as_the_reference():
    with pytest.raises(ValueError, match="single|sharded"):
        ExecutionPlan(kind="ring")
    with pytest.raises(ValueError, match="single|sharded"):
        RefPlan(kind="ring")


def test_axis_context_is_the_identity_on_shard_zero():
    actx = ExecutionPlan.single().axis_context()
    ref = RefPlan.single().axis_context()
    assert actx == AxisContext() and actx.num_shards == ref.num_shards == 1
    assert (actx.axes, actx.sizes) == (ref.axes, ref.sizes) == ((), ())
    x = torch.arange(5.0)
    assert actx.psum(x) is x and actx.pmax(x) is x
    idx = actx.shard_index()
    assert idx.dtype == torch.int32 and idx.shape == () and int(idx) == int(ref.shard_index()) == 0
    # StepContext's reducers are the AxisContext's, defined there only
    assert StepContext.psum.__func__ is AxisContext.psum
    assert StepContext.pmax.__func__ is AxisContext.pmax


def test_device_put_on_cpu_shares_memory_and_keeps_the_tree():
    plan = ExecutionPlan.single()
    batch = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "labels": {"b": np.ones((2, 3), np.int32), "c": np.zeros((2, 3), bool)}}
    got = plan.device_put(batch, "cpu")
    assert set(got) == {"a", "labels"} and set(got["labels"]) == {"b", "c"}
    assert got["a"].data_ptr() == batch["a"].ctypes.data  # no copy on the CPU
    assert got["labels"]["c"].dtype == torch.bool
    np.testing.assert_array_equal(got["labels"]["b"].numpy(), batch["labels"]["b"])
    tree = {"w": torch.ones(2)}
    assert plan.replicate(tree) is tree
    fn = lambda x: x  # noqa: E731
    assert plan.wrap(fn, None, None) is fn


def test_packed_staging_buffer_round_trips_every_leaf():
    """What ``device_put`` copies to a CUDA device in one piece: every leaf
    (strided, bool, int32, empty, nested) at an aligned offset of one
    buffer, and viewed back bitwise in the tree's order and shapes."""
    from repro_torch.engine.plan import _ALIGN, _pack

    rng = np.random.default_rng(0)
    batch = {"opcode": rng.integers(0, 99, (4, 9), dtype=np.int32),
             "regbits": rng.random((4, 9, 6), dtype=np.float32)[:, :, ::2],
             "labels": {"dlevel": rng.integers(0, 4, (4, 9), dtype=np.int32),
                        "is_mem": rng.random((4, 9)) > 0.5, "none": np.zeros((0, 3), np.float32)},
             "valid": np.ones((4, 9), np.float32)[:3]}
    host = ExecutionPlan.single().device_put(batch, "cpu")
    staging, unpack = _pack(host, pin=False)
    assert staging.dtype == torch.uint8 and staging.numel() % _ALIGN == 0
    got = unpack(staging.clone())
    assert list(got) == list(batch) and list(got["labels"]) == list(batch["labels"])

    def check(g, want):
        assert g.dtype == torch.as_tensor(want).dtype and tuple(g.shape) == want.shape
        assert g.is_contiguous() and (g.storage_offset() * g.element_size()) % _ALIGN == 0
        np.testing.assert_array_equal(g.numpy(), want)

    for k in ("opcode", "regbits", "valid"):
        check(got[k], batch[k])
    for k, v in batch["labels"].items():
        check(got["labels"][k], v)


def test_engine_configs_with_and_without_the_single_plan_share_one_entry():
    clear_step_cache()
    model = init_tao(CFG, device="cpu")
    a = StreamingEngine(model, CFG, EngineConfig(batch_size=8), device="cpu")
    b = StreamingEngine(model, CFG, EngineConfig(batch_size=8, plan=ExecutionPlan.single()), device="cpu")
    assert a.plan == b.plan == ExecutionPlan.single()
    assert a.step_entry_for(500) is b.step_entry_for(500)
    assert cache_stats()["entries"] == 1 and cache_stats()["misses"] >= 1
    clear_step_cache()


def test_train_step_plan_none_and_single_are_one_recipe_entry():
    opt = AdamWConfig(lr=2.5e-4)
    assert _make_step(CFG, opt, "all") is _make_step(CFG, opt, "all", ExecutionPlan.single())
    entry = warmup_train_step(CFG, batch_size=8, lr=2.5e-4, plan=ExecutionPlan.single(), device="cpu")
    assert entry is _make_step(CFG, opt, "all", None)
