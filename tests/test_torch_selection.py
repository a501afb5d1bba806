"""The port's µarch-pair selection against the reference's, on the CPU.

Both are NumPy over copies of the same simulator (``uarch``), so every
result is held exactly equal: the per-design metric vectors, the
Mahalanobis distance matrix, both pair selections and the random draw.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import selection as ref_sel  # noqa: E402
from repro.uarch import sample_design_space as ref_sample  # noqa: E402

from repro_torch.core import selection as port_sel  # noqa: E402
from repro_torch.uarch import UARCH_A, UARCH_B, UARCH_C, sample_design_space  # noqa: E402


def test_measure_design_metrics_equals_reference():
    designs = [UARCH_A, UARCH_B, UARCH_C, *sample_design_space(2, seed=3)]
    ref_designs = [UARCH_A, UARCH_B, UARCH_C, *ref_sample(2, seed=3)]
    got = port_sel.measure_design_metrics(designs, ["dee", "mcf"], instructions=1500)
    ref = ref_sel.measure_design_metrics(ref_designs, ["dee", "mcf"], instructions=1500)
    assert got.shape == (5, len(port_sel.METRIC_NAMES)) and port_sel.METRIC_NAMES == ref_sel.METRIC_NAMES
    np.testing.assert_array_equal(got, ref)
    assert got[:, 0].std() > 0  # the designs' CPIs differ


# metric matrices: random, one with a constant column (a singular
# covariance, pinv's case), two designs only, and equal rows
def metric_cases():
    rng = np.random.default_rng(0)
    random = rng.random((8, 4)) * [3.0, 0.1, 0.05, 0.2]
    singular = random.copy()
    singular[:, 2] = 0.25
    ties = np.repeat(rng.random((3, 4)), 2, axis=0)
    return {"random": random, "singular": singular, "two": random[:2], "ties": ties}


@pytest.mark.parametrize("case", sorted(metric_cases()))
def test_distances_and_pair_selections_equal_reference(case):
    m = metric_cases()[case]
    np.testing.assert_array_equal(port_sel.mahalanobis_matrix(m), ref_sel.mahalanobis_matrix(m))
    assert port_sel.select_pair_mahalanobis(m) == ref_sel.select_pair_mahalanobis(m)
    assert port_sel.select_pair_euclidean(m) == ref_sel.select_pair_euclidean(m)
    i, j = port_sel.select_pair_mahalanobis(m)
    assert 0 <= i < j < len(m)


@pytest.mark.parametrize("n,k,seed", [(8, 2, 0), (8, 8, 1), (100, 5, 42)])
def test_select_random_equals_reference(n, k, seed):
    got = port_sel.select_random(n, k, seed=seed)
    assert got == ref_sel.select_random(n, k, seed=seed)
    assert len(set(got)) == k
