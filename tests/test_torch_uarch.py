"""The port's copy of the NumPy µarch substrate equals the reference's.

``repro_torch.uarch`` keeps its own copy of the ISA, the program builder,
the benchmark suite, the functional simulator, the design space and the
detailed (timing) simulator with its caches and branch predictors, and
``repro_torch.core.align`` its copy of the §4.1 alignment, so that the port
never imports the reference package: every benchmark's functional trace,
detailed trace, summary and adjusted trace must come out identical, record
for record, on each of the three named microarchitectures.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.align import build_adjusted_trace, verify_alignment  # noqa: E402
from repro.uarch import (  # noqa: E402
    ALL_BENCHMARKS,
    DESIGN_SPACE,
    TEST_BENCHMARKS,
    TRAIN_BENCHMARKS,
    UARCH_A,
    UARCH_B,
    UARCH_C,
    enumerate_design_space,
    get_benchmark,
    run_detailed,
    run_functional,
    sample_design_space,
    summarize_detailed,
)
from repro.uarch import isa as ref_isa  # noqa: E402

from repro_torch import uarch as port  # noqa: E402
from repro_torch.core import align as port_align  # noqa: E402
from repro_torch.uarch import isa as port_isa  # noqa: E402

UARCHS = {"A": (UARCH_A, port.UARCH_A), "B": (UARCH_B, port.UARCH_B), "C": (UARCH_C, port.UARCH_C)}


@pytest.mark.parametrize("bench", sorted(ALL_BENCHMARKS))
def test_functional_trace_matches_reference(bench):
    ref = run_functional(get_benchmark(bench), 3000)
    got = port.run_functional(port.get_benchmark(bench), 3000)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_benchmark_suites_and_isa_match_reference():
    assert list(port.ALL_BENCHMARKS) == list(ALL_BENCHMARKS)
    assert list(port.TRAIN_BENCHMARKS) == list(TRAIN_BENCHMARKS)
    assert list(port.TEST_BENCHMARKS) == list(TEST_BENCHMARKS)
    assert {o.name: int(o) for o in port_isa.Op} == {o.name: int(o) for o in ref_isa.Op}
    assert port_isa.FUNC_TRACE_DTYPE == ref_isa.FUNC_TRACE_DTYPE
    assert port_isa.NUM_REGS == ref_isa.NUM_REGS
    assert port_isa.NUM_DLEVELS == ref_isa.NUM_DLEVELS
    assert port_isa.DLEVEL_L2 == ref_isa.DLEVEL_L2


@pytest.mark.parametrize("uarch", sorted(UARCHS))
@pytest.mark.parametrize("bench", sorted(ALL_BENCHMARKS))
def test_detailed_trace_and_alignment_match_reference(bench, uarch):
    """run_detailed, summarize_detailed, build_adjusted_trace and
    verify_alignment bitwise the reference's at 3,000 instructions."""
    ref_cfg, port_cfg = UARCHS[uarch]
    ft = run_functional(get_benchmark(bench), 3000)
    ref_det, ref_summ = run_detailed(get_benchmark(bench), ft, ref_cfg)
    det, summ = port.run_detailed(port.get_benchmark(bench), ft, port_cfg)
    assert det.dtype == ref_det.dtype
    np.testing.assert_array_equal(det, ref_det)
    assert summ == ref_summ
    assert port.summarize_detailed(det) == summarize_detailed(ref_det)
    ref_al, al = build_adjusted_trace(ref_det), port_align.build_adjusted_trace(det)
    assert al.adjusted.dtype == ref_al.adjusted.dtype
    np.testing.assert_array_equal(al.adjusted, ref_al.adjusted)
    assert (al.total_cycles_detailed, al.num_squashed, al.num_nops, al.total_cycles_adjusted) == (
        ref_al.total_cycles_detailed, ref_al.num_squashed, ref_al.num_nops,
        ref_al.total_cycles_adjusted)
    check = port_align.verify_alignment(al, ft)
    assert check == verify_alignment(ref_al, ft)
    assert check["stream_match"] and check["cycles_match"]


def test_design_space_matches_reference():
    assert port.DESIGN_SPACE == DESIGN_SPACE
    assert port.enumerate_design_space() == enumerate_design_space()
    for ref_cfg, port_cfg in UARCHS.values():
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert port_cfg.key() == ref_cfg.key()
    got = [dataclasses.asdict(c) for c in port.sample_design_space(12, seed=3)]
    assert got == [dataclasses.asdict(c) for c in sample_design_space(12, seed=3)]
