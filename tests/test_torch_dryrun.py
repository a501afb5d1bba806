"""The port's one-card dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

The cell matrix (``SHAPES``, ``cell_supported`` for every architecture and
shape, ``runnable_cells``) and ``model_flops`` for all 31 cells equal the
reference's, and the port's meta-built parameter count equals the
reference's ``jax.eval_shape`` count at full size for every ``ARCH_IDS``
entry.  The reference's numbers come from one module-scoped subprocess:
importing its dryrun module rewrites ``XLA_FLAGS`` (512 host devices) for
the process that imports it.  ``counted_flops`` (the port's stand-in for
``hloanalysis.py``, ``FlopCounterMode``'s formulas) counts products exactly
and a reduced dense prefill as ``FlopCounterMode`` does, within 0.5-4x of
the analytic count (the reference's
``tests/test_roofline.py`` band).  ``run_cell`` on the CPU gives a finite
record with the reference's roofline keys (the counterpart of the
reference's ``test_dryrun_cell_end_to_end``), and a cell over the memory
limit is recorded as not fitting and not run.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.roofline import analytic_flops  # noqa: E402
from repro_torch.models import Model  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# the keys of the reference's record (dryrun.py::analyze) that the port's
# keeps: its roofline terms and the per-device flop / byte counts
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "step_time_s", "model_flops",
                 "useful_flops_ratio", "roofline_fraction"}
RECORD_KEYS = {"arch", "shape", "kind", "batch", "seq", "n_params", "microbatches", "mesh",
               "n_devices", "flops_per_device", "flops_per_device_analytic", "bytes_per_device",
               "collectives", "collective_bytes_per_device", "collective_wire_bytes", "memory",
               "roofline", "lower_s"}

_REFERENCE = """
import json
import jax
import numpy as np
from repro.configs import ARCH_IDS, get_arch
from repro.launch.dryrun import SHAPES, cell_supported, model_flops, runnable_cells
from repro.models.backbone import Model

n_params = {}
for a in ARCH_IDS:
    sds = jax.eval_shape(Model(get_arch(a)).init, jax.random.PRNGKey(0))
    n_params[a] = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(sds))
flops = {}
for a, s in runnable_cells():
    meta = {"kind": SHAPES[s]["kind"], "batch": SHAPES[s]["batch"], "seq": SHAPES[s]["seq"],
            "n_params": n_params[a]}
    flops[a + "|" + s] = model_flops(get_arch(a), meta)
print(json.dumps({"shapes": SHAPES, "arch_ids": list(ARCH_IDS),
                  "supported": {a + "|" + s: list(cell_supported(a, s))
                                for a in ARCH_IDS for s in SHAPES},
                  "cells": [list(c) for c in runnable_cells()], "n_params": n_params,
                  "model_flops": flops}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE)], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_matrix_equals_reference(reference):
    assert D.SHAPES == reference["shapes"]
    assert list(ARCH_IDS) == reference["arch_ids"]
    for a in ARCH_IDS:
        for s in D.SHAPES:
            assert list(D.cell_supported(a, s)) == reference["supported"][f"{a}|{s}"], (a, s)
    assert [list(c) for c in D.runnable_cells()] == reference["cells"]
    assert len(reference["cells"]) == 31


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_params_and_model_flops_equal_reference(reference, arch):
    """The port's model on ``meta`` (nothing allocated or drawn) counts the
    reference's parameters at full size, and ``model_flops`` of each of the
    architecture's cells (at the reference's global batch) is its."""
    _, meta, cfg = D.lower_cell(arch, "train_4k")
    assert meta["n_params"] == reference["n_params"][arch]
    model = Model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    for a, s in D.runnable_cells():
        if a != arch:
            continue
        spec = D.SHAPES[s]
        m = {"kind": spec["kind"], "batch": spec["batch"], "seq": spec["seq"],
             "n_params": meta["n_params"]}
        assert D.model_flops(cfg, m) == reference["model_flops"][f"{a}|{s}"], (a, s)


def test_meta_route_keeps_the_seeded_init():
    """Building on ``meta`` draws nothing: the CPU's seeded weights are the
    same before and after a meta build."""
    cfg = get_arch("mamba2-1.3b", reduced=True)
    a = Model(cfg, device="cpu").state_dict()
    Model(cfg, device="meta")
    b = Model(cfg, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_per_card_cell_and_microbatches():
    """One data-parallel replica: the reference's batch over its data axis
    of 16; a train cell's microbatches by the reference's 2 GiB rule."""
    _, meta, cfg = D.lower_cell("qwen2-0.5b", "train_4k")
    assert (meta["batch"], meta["global_batch"], meta["seq"]) == (16, 256, 4096)
    assert meta["microbatches"] == 2  # 24 x 16 x 4096 x 896 x 2 B = 2.8 GB residuals
    assert D.lower_cell("mamba2-1.3b", "long_500k")[1]["batch"] == 1
    assert D.lower_cell("mamba2-1.3b", "prefill_32k")[1]["batch"] == 2
    # mamba2's 524,288-token state is constant-size
    assert D.lower_cell("mamba2-1.3b", "long_500k")[1]["cache_bytes"] == \
        D.lower_cell("mamba2-1.3b", "decode_32k")[1]["cache_bytes"] // 8


def test_flop_counts_of_products_are_exact():
    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(s, generator=g) for s in ((8, 16), (16, 24), (24, 40)))
    assert D.counted_flops(lambda: (a @ b) @ c) == 2 * 8 * 16 * 24 + 2 * 8 * 24 * 40


def test_counted_flops_of_a_reduced_dense_prefill_near_analytic():
    cfg = get_arch("qwen2-0.5b", reduced=True)
    model = Model(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(0))
    counted = D.counted_flops(lambda: model.prefill(tokens))
    analytic = analytic_flops(cfg, {"batch": 2, "seq": 64, "kind": "prefill"})
    assert 0.5 * analytic < counted < 4 * analytic, (counted, analytic)
    with FlopCounterMode(display=False) as counter:  # the same formulas
        model.prefill(tokens)
    assert counted == counter.get_total_flops()


@pytest.mark.parametrize("arch,shape", [("qwen2-0.5b", "decode_32k"), ("mamba2-1.3b", "long_500k")])
def test_run_cell_on_the_cpu_gives_a_finite_record(arch, shape):
    rec = D.run_cell(arch, shape, reduced=True, device="cpu", steps=2)
    assert RECORD_KEYS <= set(rec) and set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["finite"] and rec["memory"]["fits"] and "skipped" not in rec
    assert rec["output_shape"] == [rec["batch"], get_arch(arch, reduced=True).vocab]
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["flops_per_device"] == max(rec["flops_per_device_counted"],
                                          rec["flops_per_device_analytic"]) > 0
    assert rec["timer"] == "host_clock" and len(rec["step_ms"]) == 2
    # no device metric from a CPU run
    assert rec["profile"] is None and rec["memory"]["peak_bytes"] is None
    assert rec["measured"] == {"x_bound": None, "mfu": None}
    assert all(np.isfinite(v) for v in rec["roofline"].values() if not isinstance(v, str))


def test_a_cell_over_the_memory_limit_is_recorded_and_not_run(monkeypatch):
    monkeypatch.setattr(D, "card_memory_bytes", lambda device: 1 << 20)

    def refuse(*args, **kwargs):
        raise AssertionError("a cell that does not fit was run")

    monkeypatch.setattr(D, "_cell_step", refuse)
    rec = D.run_cell("qwen2-0.5b", "decode_32k", reduced=True, device="cpu")
    assert rec["memory"]["fits"] is False
    assert rec["memory"]["estimate_bytes"] > rec["memory"]["card_bytes"] == 1 << 20
    assert "does not fit" in rec["skipped"] and "step_ms_median" not in rec
    assert set(rec["roofline"]) == ROOFLINE_KEYS


def test_cli_is_resumable_and_refuses_a_mesh(tmp_path, capsys):
    out = tmp_path / "dry.json"
    out.write_text(json.dumps({"mamba2-1.3b|long_500k": {"done": True}}))
    D.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out", str(out), "--device", "cpu"])
    assert "[skip] mamba2-1.3b|long_500k" in capsys.readouterr().out
    assert json.loads(out.read_text()) == {"mamba2-1.3b|long_500k": {"done": True}}
    with pytest.raises(NotImplementedError, match=r"A\.14 \(c\)"):
        D.main(["--mesh", "single", "--out", str(out), "--device", "cpu"])
