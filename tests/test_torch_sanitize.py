"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``) against
the reference's contract (``tests/test_analysis.py``'s sanitizer tests).

The public names and keyword signature are the reference's; the compile
budget counts the engine's captures, the trainer's compiles and ``nvcc``
builds; a NaN raises ``FloatingPointError``; the sync guard's previous mode
comes back after a block that raised.  On the CPU the guard arms and
cannot fire (the module note): its restore is held here on a stand-in for
``torch.cuda``'s mode, its teeth on the card (``tests/test_torch_cuda.py``).
A warm engine simulates uneven traces inside ``sanitized(compile_budget=0)``,
the counterpart of the reference's ``test_engine_single_compile_across_
uneven_batches``.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import sanitize as ref_sanitize  # noqa: E402

from repro_torch.analysis import sanitize as S  # noqa: E402
from repro_torch.core.features import FeatureConfig  # noqa: E402
from repro_torch.core.model import TaoConfig, init_tao  # noqa: E402
from repro_torch.engine import EngineConfig, StreamingEngine  # noqa: E402
from repro_torch.engine import aot  # noqa: E402
from repro_torch.uarch import get_benchmark, run_functional  # noqa: E402


def test_public_names_and_signature_are_the_reference():
    assert set(ref_sanitize.__all__) <= set(S.__all__)
    assert inspect.signature(S.sanitized) == inspect.signature(ref_sanitize.sanitized)


def test_compile_budget_exceeded_raises(monkeypatch):
    counts = iter([10, 13])  # 3 compiles inside the block, budget 2
    monkeypatch.setattr(S, "compiles_now", lambda: next(counts))
    with pytest.raises(S.CompileBudgetExceeded, match="budget was 2"):
        with S.sanitized(transfer_guard=None, debug_nans=False, compile_budget=2):
            pass


def test_compile_budget_within_budget_passes(monkeypatch):
    counts = iter([10, 12])
    monkeypatch.setattr(S, "compiles_now", lambda: next(counts))
    with S.sanitized(transfer_guard=None, debug_nans=False, compile_budget=2):
        pass


def test_compile_budget_is_assertion_error():
    assert issubclass(S.CompileBudgetExceeded, AssertionError)


def test_an_nvcc_build_trips_the_budget(monkeypatch):
    """A kernel library built in the block (a miss of the build cache) is a
    compile, as a capture is."""
    misses = iter([0, 1])
    monkeypatch.setattr(aot, "build_cache_counters", lambda: {"requests": 1, "hits": 0,
                                                              "misses": next(misses)})
    with pytest.raises(S.CompileBudgetExceeded, match="compiled 1 step"):
        with S.sanitized(transfer_guard=None, debug_nans=False, compile_budget=0):
            pass


def test_debug_nans_catches_nan_inside_sanitized():
    with pytest.raises(FloatingPointError, match="aten.log"):
        with S.sanitized(transfer_guard=None):
            torch.log(torch.tensor(-1.0))


def test_debug_nans_on_the_device_flag_names_the_first_op(monkeypatch):
    """The card's route, run on the CPU: every check kept in the device
    flag, read once at the block's exit; the first op that made a NaN is
    named, and a later one does not displace it."""
    monkeypatch.setattr(S, "_deferred", lambda t: True)
    a = torch.full((3,), 2.0)
    with pytest.raises(FloatingPointError, match=r"aten\.log\.default, the first of the 5 ops"):
        with S.sanitized(transfer_guard=None):
            b = torch.log(-a)
            torch.sqrt(b * 0.0)
            torch.exp(a)
    with S.sanitized(transfer_guard=None):  # no NaN: no raise
        torch.exp(a)


def test_debug_nans_off_lets_nans_through():
    with S.sanitized(transfer_guard=None, debug_nans=False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_unknown_guard_level_raises():
    with pytest.raises(ValueError, match="transfer_guard"):
        with S.sanitized(transfer_guard="sometimes"):
            pass


def test_guard_mode_restored_after_a_block_that_raised(monkeypatch):
    """The guard sets the card's sync debug mode for the block and puts the
    previous one back, also when the block raises (a stand-in for
    ``torch.cuda``'s process-wide mode, since this CPU build has none)."""
    mode = {"now": "warn", "set": []}

    def set_mode(m):
        mode["set"].append(m)
        mode["now"] = m

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    with pytest.raises(KeyError):
        with S.sanitized(debug_nans=False):
            assert mode["now"] == "error"
            with S.allowed_sync():
                assert mode["now"] == "default"
            assert mode["now"] == "error"
            raise KeyError("inside")
    assert mode["now"] == "warn"
    assert mode["set"] == ["error", "default", "error", "warn"]


def test_warm_engine_single_compile_across_uneven_traces():
    """A warm engine (tiny config, the CPU) simulates a ragged trace and two
    more of other lengths inside sanitized(compile_budget=0): nothing
    compiles, no NaN, finite metrics, arrays left on the device."""
    fcfg = FeatureConfig(n_buckets=16, n_queue=4, n_mem=8)
    cfg = TaoConfig(window=9, d_model=16, n_heads=2, n_layers=1, d_ff=32, d_cat=8, features=fcfg)
    params = init_tao(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = StreamingEngine(params, cfg, EngineConfig(batch_size=13), device="cpu")
    engine.simulate(run_functional(get_benchmark("mcf"), 500))  # warm: the geometry's entry
    compiles = engine.num_compiles
    with S.sanitized(compile_budget=0):
        r1 = engine.simulate(run_functional(get_benchmark("mcf"), 700))  # ragged tail
        r2 = engine.simulate(run_functional(get_benchmark("dee"), 1000))
        r3 = engine.simulate(run_functional(get_benchmark("lee"), 13 * 17))
    assert engine.num_compiles == compiles
    for r in (r1, r2, r3):
        assert np.isfinite(r.cpi) and r.cpi > 0
        assert "fetch_lat" not in r.available_metrics
