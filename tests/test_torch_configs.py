"""The port's architecture registry against the reference's.

``get_arch("tao")`` is the paper's model (``repro/configs/tao.py``): a
``TaoConfig``, not an ``ArchConfig``, so it is outside ``ARCH_IDS`` and has
no reduced variant.  The port's config equals the reference's field by
field, all but the reference's ``use_pallas`` switch (the port always runs
its hand-written attention kernel on the card).  ``ARCH_IDS`` is the
reference's, every id.  The four ``dense`` configs, ``qwen2-vl-2b``,
``hubert-xlarge``, the two ``moe`` configs and ``recurrentgemma-9b``
equal the reference's field by field, full and reduced (the MoE, MLA and
hybrid fields nested), on every field the port has; the fields the port
leaves out are the reference's switches it does not read (``use_pallas``,
``scan_layers``), which these configs leave at their defaults.  The
memory policies are fields of both: ``remat`` "full" and
``prefill_chunks`` 1 in every full config, ``remat`` "none" in every
reduced one.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import tao as ref_tao  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.configs import tao as port_tao  # noqa: E402
from repro_torch.core.model import TaoConfig  # noqa: E402

# the reference's architectures the port runs
DENSE = ("qwen1.5-32b", "qwen2-0.5b", "stablelm-1.6b", "glm4-9b")
VLM_AUDIO = ("qwen2-vl-2b", "hubert-xlarge")
MOE = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")
HYBRID = "recurrentgemma-9b"
PORTED = DENSE + ("mamba2-1.3b",) + VLM_AUDIO + MOE + (HYBRID,)
# reference ArchConfig fields the port leaves out, and their defaults
LEFT_OUT = {"scan_layers": True, "use_pallas": False}


def assert_memory_policies(port, reduced):
    assert (port.remat, port.prefill_chunks) == ("none" if reduced else "full", 1)


def as_fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("use_pallas", None)
    return d


def test_tao_config_equals_the_reference_field_by_field():
    ref, port = ref_get_arch("tao"), get_arch("tao")
    assert port is port_tao.CONFIG and ref is ref_tao.CONFIG
    assert isinstance(port, TaoConfig)
    assert ref.use_pallas is False
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref) if f.name != "use_pallas"]
    assert as_fields(port) == as_fields(ref)
    assert (port.window, port.d_model, port.n_heads, port.n_layers, port.d_ff, port.d_cat) == (
        129, 512, 8, 6, 2048, 128)
    assert port.head_dim == ref.head_dim == 64
    assert dataclasses.astuple(port.features) == dataclasses.astuple(ref.features) == (1024, 32, 64)


def test_arch_ids_are_the_reference_less_the_zoo_not_ported():
    assert "tao" not in ARCH_IDS and "tao" not in REF_ARCH_IDS
    assert ARCH_IDS == [a for a in REF_ARCH_IDS if a in PORTED] == REF_ARCH_IDS
    for name in ARCH_IDS:  # the fields are held in tests/test_torch_mamba2.py
        assert get_arch(name).name == ref_get_arch(name).name == name


@pytest.mark.parametrize("package", ["reference", "port"])
def test_tao_has_no_reduced_variant(package):
    arch = ref_get_arch if package == "reference" else get_arch
    with pytest.raises(AttributeError, match="reduced"):
        arch("tao", reduced=True)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_equals_the_reference_field_by_field(arch, reduced):
    ref, port = ref_get_arch(arch, reduced=reduced), get_arch(arch, reduced=reduced)
    ref_fields = dataclasses.asdict(ref)
    port_fields = dataclasses.asdict(port)
    assert set(port_fields) | set(LEFT_OUT) == set(ref_fields)
    assert port_fields == {k: v for k, v in ref_fields.items() if k in port_fields}
    for k, v in LEFT_OUT.items():  # the switches the port does not read are off
        assert ref_fields[k] == v, k
    assert_memory_policies(port, reduced)
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.family == "dense"
    assert (port.frontend, port.encoder_only, port.rope) == (None, False, "rope")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", VLM_AUDIO)
def test_vlm_audio_config_equals_the_reference_field_by_field(arch, reduced):
    """qwen2-vl-2b and hubert-xlarge, full and reduced (frontend_dim 32, 4
    patches, M-RoPE sections (2, 3, 3) for the vlm), on every field the
    port has."""
    ref, port = ref_get_arch(arch, reduced=reduced), get_arch(arch, reduced=reduced)
    ref_fields = dataclasses.asdict(ref)
    port_fields = dataclasses.asdict(port)
    assert set(port_fields) | set(LEFT_OUT) == set(ref_fields)
    assert port_fields == {k: v for k, v in ref_fields.items() if k in port_fields}
    assert all(ref_fields[k] == v for k, v in LEFT_OUT.items())
    assert_memory_policies(port, reduced)
    want = {"qwen2-vl-2b": {"family": "vlm", "frontend": "vision_stub", "frontend_dim": 1280,
                            "encoder_only": False, "rope": "mrope", "mrope_sections": (16, 24, 24)},
            "hubert-xlarge": {"family": "audio", "frontend": "audio_stub", "frontend_dim": 512,
                              "encoder_only": True, "rope": "rope"}}[arch]
    want["vision_patches"] = 64
    if reduced:
        want.update(frontend_dim=32, vision_patches=4)
        if want["rope"] == "mrope":
            want["mrope_sections"] = (2, 3, 3)
    assert {k: port_fields[k] for k in want} == want
    head_dim = {"qwen2-vl-2b": 128, "hubert-xlarge": 80}[arch]
    assert port.resolved_head_dim == (16 if reduced else head_dim)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_moe_config_equals_the_reference_field_by_field(arch, reduced):
    """qwen3-moe-235b-a22b and deepseek-v2-lite-16b, full and reduced (at
    most 8 experts, top_k at most 2, expert d_ff 64, shared d_ff 64 where
    there are shared experts, capacity_factor 8.0; MLA ranks 32 / 16 / 8 /
    16), on every field the port has, the nested MoE and MLA fields
    included."""
    ref, port = ref_get_arch(arch, reduced=reduced), get_arch(arch, reduced=reduced)
    ref_fields = dataclasses.asdict(ref)
    port_fields = dataclasses.asdict(port)
    assert set(port_fields) | set(LEFT_OUT) == set(ref_fields)
    assert port_fields == {k: v for k, v in ref_fields.items() if k in port_fields}
    assert all(ref_fields[k] == v for k, v in LEFT_OUT.items())
    assert_memory_policies(port, reduced)
    assert [f.name for f in dataclasses.fields(port.moe)] == [
        f.name for f in dataclasses.fields(ref.moe)]
    m = port.moe
    want = {"qwen3-moe-235b-a22b": dict(num_experts=128, top_k=8, d_ff_expert=1536, num_shared=0,
                                        d_ff_shared=0, first_dense_layers=0),
            "deepseek-v2-lite-16b": dict(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
                                         d_ff_shared=2816, first_dense_layers=1)}[arch]
    want["capacity_factor"] = 1.25
    if reduced:
        want.update(num_experts=8, top_k=2, d_ff_expert=64, capacity_factor=8.0,
                    d_ff_shared=64 if want["num_shared"] else 0)
    assert {k: getattr(m, k) for k in want} == want
    assert (m.router_aux_weight, m.router_z_weight) == (0.01, 1e-3)
    if arch == "deepseek-v2-lite-16b":
        assert dataclasses.astuple(port.mla) == ((32, 16, 8, 16) if reduced else (512, 128, 64, 128))
        assert (port.n_layers, port.d_model, port.n_heads) == ((4, 64, 4) if reduced else (27, 2048, 16))
    else:
        assert port.mla is None and port.qk_norm
        assert (port.n_heads, port.n_kv_heads, port.resolved_head_dim) == (
            (4, 4, 16) if reduced else (64, 4, 128))
    assert port.family == "moe"


@pytest.mark.parametrize("reduced", [False, True])
def test_hybrid_config_equals_the_reference_field_by_field(reduced):
    """recurrentgemma-9b, full and reduced (window 32, ``lru_width`` None,
    one unit and a one-layer tail), on every field the port has, the nested
    hybrid fields included."""
    ref, port = ref_get_arch(HYBRID, reduced=reduced), get_arch(HYBRID, reduced=reduced)
    ref_fields = dataclasses.asdict(ref)
    port_fields = dataclasses.asdict(port)
    assert set(port_fields) | set(LEFT_OUT) == set(ref_fields)
    assert port_fields == {k: v for k, v in ref_fields.items() if k in port_fields}
    assert all(ref_fields[k] == v for k, v in LEFT_OUT.items())
    assert_memory_policies(port, reduced)
    assert [f.name for f in dataclasses.fields(port.hybrid)] == [
        f.name for f in dataclasses.fields(ref.hybrid)]
    assert dataclasses.astuple(port.hybrid) == ((2, 1, 32, None, 4) if reduced
                                                else (2, 1, 2048, None, 4))
    want = (4, 64, 4, 1, 16, 128, 512) if reduced else (38, 4096, 16, 1, 256, 12288, 256000)
    assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads, port.resolved_head_dim,
            port.d_ff, port.vocab) == want
    assert (port.family, port.mlp_act, port.norm, port.rope, port.tie_embeddings) == (
        "hybrid", "gelu", "rmsnorm", "rope", False)
