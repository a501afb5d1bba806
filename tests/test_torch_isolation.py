"""The port stands alone: no JAX, no reference package, no silent CPU.

  * a fresh interpreter imports every ``repro_torch`` module and then finds
    neither ``jax`` nor any ``repro`` module in ``sys.modules``;
  * no port source and not ``chip_smoke.py`` names them in an import;
  * entry points default to ``cuda`` and raise without it (the CPU runs
    only when asked for);
  * ``chip_smoke.py`` fails, and prints no result, without a CUDA device.
"""
import ast
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad, sorted(names))
"""

# modules the walk must reach: one per subpackage, the persistence and
# joint-training slices' too
_MUST_WALK = (
    "repro_torch.ckpt.checkpoint",
    "repro_torch.core.multiarch",
    "repro_torch.core.selection",
    "repro_torch.core.simnet",
    "repro_torch.core.simulate",
    "repro_torch.core.transfer",
    "repro_torch.engine.plan",
    "repro_torch.engine.runner",
    "repro_torch.engine.scheduler",
    "repro_torch.resilience.faults",
    "repro_torch.resilience.manifest",
    "repro_torch.store.content",
    "repro_torch.store.store",
    "repro_torch.train.trainer",
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_importing_every_port_module_loads_no_jax_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        env=_env(), timeout=300, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20  # every subpackage was walked
    bad, walked = out[1].strip().split("] ", 1)
    assert bad == "["
    assert set(_MUST_WALK) <= set(ast.literal_eval(walked))


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse((REPO / path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_api_imports_alone_without_jax_or_reference():
    """The facade (``repro_torch.api`` and its ``session`` module) imported
    first in a fresh interpreter brings in neither JAX nor the reference."""
    code = ("import sys, repro_torch.api, repro_torch.api.session; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
                         timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_tf32_is_off():
    import repro_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch import resolve_device
    from repro_torch.core import (
        FeatureConfig,
        TaoConfig,
        build_windows,
        SimNetConfig,
        extract_features,
        init_multiarch,
        init_simnet,
        init_tao,
        simulate_trace,
        simulate_trace_legacy,
        train_tao_impl,
        transfer_finetune,
        warmup_train_step,
    )
    from repro_torch.engine import StreamingEngine, TraceSweeper, simulate_trace_engine, sweep_traces
    from repro_torch.kernels.features.ops import (
        device_feature_arrays,
        extract_features_device,
        trace_columns,
    )
    from repro_torch.kernels.fused.ops import FusedExtractor, init_fused_state
    from repro_torch.uarch import get_benchmark, run_functional

    fcfg = FeatureConfig(n_buckets=8, n_queue=4, n_mem=8)
    cfg = TaoConfig(window=9, d_model=16, n_heads=2, n_layers=1, d_ff=32, d_cat=8, features=fcfg)
    trace = run_functional(get_benchmark("lee"), 100)
    cpu_model = init_tao(cfg, device="cpu")
    windows = build_windows(extract_features(trace, fcfg), cfg.window)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "init_tao": lambda: init_tao(cfg),
        "init_fused_state": lambda: init_fused_state(fcfg),
        "FusedExtractor": lambda: FusedExtractor(trace_columns(trace, fcfg), fcfg),
        "device_feature_arrays": lambda: device_feature_arrays(trace_columns(trace, fcfg), fcfg),
        "extract_features_device": lambda: extract_features_device(trace, fcfg),
        "StreamingEngine": lambda: StreamingEngine(cpu_model, cfg),
        "simulate_trace_engine": lambda: simulate_trace_engine(cpu_model, trace, cfg),
        "TraceSweeper": lambda: TraceSweeper(cfg),
        "sweep_traces": lambda: sweep_traces(cfg, [("k", cpu_model, trace)]),
        "train_tao_impl": lambda: train_tao_impl(cfg, windows, epochs=1),
        "transfer_finetune": lambda: transfer_finetune(cfg, cpu_model.embed, cpu_model, windows),
        "warmup_train_step": lambda: warmup_train_step(cfg),
        "init_multiarch": lambda: init_multiarch(cfg),
        "init_simnet": lambda: init_simnet(SimNetConfig()),
        "simulate_trace": lambda: simulate_trace(cpu_model, trace, cfg),
        "simulate_trace_legacy": lambda: simulate_trace_legacy(cpu_model, trace, cfg),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"), warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)  # simulate_trace's own
            call()
    # asked for explicitly, the CPU runs
    r = simulate_trace_engine(cpu_model, trace, cfg, device="cpu")
    assert np.isfinite(r.cpi)


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:  # a directory holding the script and nothing else
            script.write_text((REPO / "chip_smoke.py").read_text())
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("PYTHONPATH", None)
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, env=env, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
