"""The port's copy of the NumPy µarch substrate equals the reference's.

``repro_torch.uarch`` keeps its own copy of the ISA, the program builder,
the benchmark suite and the functional simulator so that the port never
imports the reference package; every benchmark's functional trace must come
out identical, record for record.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.uarch import (  # noqa: E402
    ALL_BENCHMARKS,
    TEST_BENCHMARKS,
    TRAIN_BENCHMARKS,
    get_benchmark,
    run_functional,
)
from repro.uarch import isa as ref_isa  # noqa: E402

from repro_torch import uarch as port  # noqa: E402
from repro_torch.uarch import isa as port_isa  # noqa: E402


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
