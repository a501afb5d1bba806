"""The port's analytic roofline counts (``repro_torch/launch/roofline.py``)
against the reference's (``repro/launch/roofline.py``), on the CPU.

Every ``ARCH_IDS`` entry, full and reduced: the forward FLOPs per token,
``analytic_flops`` and ``analytic_hbm_bytes`` for a prefill and a decode
step at 1, 2,048 and 32,768 positions are EQUAL, as floats, to the
reference's on the reference's config (the same terms in the same
order).  A ``train`` step is compared under each ``remat``: 3x the
forward under "none" and "dots", 4x under "full", the full configs'
default.  ``count_params`` raises in both.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

SEQS = (1, 2048, 32768)
N_PARAMS = 8_527_071_232  # any count: both sides take it as given
CACHE_BYTES = 100_663_296


def configs(arch, reduced):
    return ref_get_arch(arch, reduced=reduced), get_arch(arch, reduced=reduced)


def test_every_reference_arch_is_counted():
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_serving_counts_equal_the_reference(arch, kind, seq, reduced):
    ref, port = configs(arch, reduced)
    meta = {"batch": 4, "seq": seq, "kind": kind}
    assert roofline.fwd_flops_per_token(port, seq, kind) == ref_roofline.fwd_flops_per_token(
        ref, seq, kind)
    assert roofline.analytic_flops(port, meta) == ref_roofline.analytic_flops(ref, meta)
    assert roofline.analytic_hbm_bytes(port, meta, N_PARAMS, CACHE_BYTES) == (
        ref_roofline.analytic_hbm_bytes(ref, meta, N_PARAMS, CACHE_BYTES))
    assert roofline.analytic_flops(port, meta) > 0


def train_counts(arch, seq, remat):
    """The port's and the reference's train-step FLOPs and HBM bytes of
    ``arch`` under ``remat``."""
    ref, port = (dataclasses.replace(c, remat=remat) for c in configs(arch, False))
    meta = {"batch": 2, "seq": seq, "kind": "train"}
    return ((roofline.analytic_flops(port, meta), roofline.analytic_hbm_bytes(port, meta, N_PARAMS)),
            (ref_roofline.analytic_flops(ref, meta),
             ref_roofline.analytic_hbm_bytes(ref, meta, N_PARAMS)))


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_train_counts_equal_the_reference_without_remat(arch, seq):
    port, ref = train_counts(arch, seq, "none")
    assert port == ref


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_train_counts_equal_the_reference_under_remat(arch, seq, remat):
    port, ref = train_counts(arch, seq, remat)
    assert port == ref
    none = train_counts(arch, seq, "none")[0]
    assert port[0] / none[0] == pytest.approx(4.0 / 3.0 if remat == "full" else 1.0, rel=1e-12)
    if remat == "full":  # the full configs' default
        assert get_arch(arch).remat == "full"
        assert roofline.analytic_flops(get_arch(arch), {"batch": 2, "seq": seq,
                                                        "kind": "train"}) == port[0]


def test_hybrid_counts_read_the_window_and_the_units():
    """recurrentgemma-9b: 26 recurrent and 12 attention layers, the
    attention context capped at the 2,048 window past it."""
    cfg = get_arch("recurrentgemma-9b")
    at = {s: roofline.fwd_flops_per_token(cfg, s, "decode") for s in (2048, 4096, 32768)}
    assert at[2048] == at[4096] == at[32768]
    assert roofline.fwd_flops_per_token(cfg, 1024, "decode") < at[2048]


@pytest.mark.parametrize("module", [roofline, ref_roofline], ids=["port", "reference"])
def test_count_params_raises(module):
    with pytest.raises(NotImplementedError):
        module.count_params(get_arch("qwen2-0.5b"))
