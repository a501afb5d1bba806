"""The port's ``vlm`` and ``audio`` families against the reference's, on the
CPU.

``qwen2-vl-2b`` (``vlm``: GQA, QKV bias, tied head, M-RoPE, the vision
stub's patches over the first positions) and ``hubert-xlarge`` (``audio``:
a bidirectional MHA encoder over projected frames, layernorm, GELU, an
untied head), reduced by the reference's rules (4 layers, d_model 64, 4
heads of 16, d_ff 128, vocab 512, frontend_dim 32, 4 patches, M-RoPE
sections (2, 3, 3), float32).  The reference initializes the weights with
``jax.random`` and they cross as NumPy through
``convert.lm_params_from_jax``; the same NumPy-seeded tokens, patches and
frames go through both sides, each side its own copy.

Tolerance: atol = rtol = 2e-4 on logits, caches and loss, as in
``tests/test_torch_dense.py`` (float32 on both sides; matmul, reduction and
softmax order, ``cos`` / ``sin`` and rsqrt differ over four layers and a
512-way head).  The reference runs its default path (``flash_ref``) and,
once per model, its Pallas kernel (``use_pallas=True``, interpret mode;
non-causal for hubert).  M-RoPE is held on three distinct position
streams; on text positions the port's ``apply_mrope`` is its
``apply_rope``, bitwise.  The reference's own smoke cases
(``tests/test_models_smoke.py``) run on the port, and its handoff within
2e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.backbone import Model as RefModel  # noqa: E402
from repro.models.rotary import apply_mrope as ref_apply_mrope  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import Model, apply_mrope, apply_rope, text_mrope_positions  # noqa: E402
from test_torch_dense import assert_cache, build, close, j_, pad_seq, t_  # noqa: E402

VLM, AUDIO = "qwen2-vl-2b", "hubert-xlarge"
B, S = 2, 48
HANDOFF_TOL = 2e-3  # the reference's test_prefill_matches_decode


def rng(seed):
    return np.random.default_rng(seed)


def tokens(seed, shape=(B, S)):
    return rng(seed).integers(0, 512, shape).astype(np.int32)


def patches(cfg, seed, batch=B):
    shape = (batch, cfg.vision_patches, cfg.frontend_dim)
    return rng(seed).standard_normal(shape).astype(np.float32)


def frames(cfg, seed, shape=(B, S)):
    return rng(seed).standard_normal(shape + (cfg.frontend_dim,)).astype(np.float32)


@pytest.fixture(scope="module")
def vlm():
    return build(VLM)


@pytest.fixture(scope="module")
def audio():
    return build(AUDIO)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((2, 3, 3), 16)])
def test_mrope_matches_reference_on_distinct_streams(sections, hd):
    """Three position streams that differ (temporal, height, width of image
    patches), so every section's stream is seen."""
    r = rng(12)
    x = r.standard_normal((2, 3, 40, hd)).astype(np.float32)
    pos3 = np.stack([r.permutation(4000)[:40].reshape(1, 40).repeat(2, 0) for _ in range(3)])
    pos3 = pos3.astype(np.int32)
    assert not (pos3[0] == pos3[1]).all() and not (pos3[1] == pos3[2]).all()
    got = apply_mrope(t_(x), t_(pos3), sections, 1_000_000.0)
    want = ref_apply_mrope(j_(x), j_(pos3), sections, 1_000_000.0)
    close(got, want)
    # each section rotates by its own stream: changing stream i changes only
    # section i's frequencies
    moved = pos3.copy()
    moved[1] += 7
    other = apply_mrope(t_(x), t_(moved), sections, 1_000_000.0)
    lo, hi = sections[0], sections[0] + sections[1]
    same = np.ones(hd // 2, bool)
    same[lo:hi] = False
    diff = (other != got).numpy()
    assert not diff[..., np.r_[same, same]].any() and diff[..., np.r_[~same, ~same]].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_on_text_positions_is_rope_bitwise(dtype):
    x = t_(rng(13).standard_normal((2, 4, 33, 16)).astype(np.float32)).to(getattr(torch, dtype))
    pos = torch.arange(33).expand(2, 33) + 5
    pos3 = text_mrope_positions(pos)
    assert pos3.shape == (3, 2, 33)
    got = apply_mrope(x, pos3, (2, 3, 3))
    assert torch.equal(got, apply_rope(x, pos))
    assert torch.equal(apply_mrope(x, text_mrope_positions(pos[0]), (2, 3, 3)), got)


def test_mrope_refuses_sections_that_miss_half_the_head():
    with pytest.raises(ValueError, match="sum to head_dim / 2 = 8"):
        apply_mrope(torch.zeros(1, 1, 2, 16), torch.zeros(3, 1, 2, dtype=torch.long), (2, 3, 4))


# ---------------------------------------------------------------------------
# qwen2-vl-2b
# ---------------------------------------------------------------------------


def test_vlm_prefill_and_decode_step_match_reference(vlm):
    (_, ref, params), (cfg, port) = vlm
    toks, pt = tokens(1, (B, S + 1)), patches(cfg, 2)
    logits, cache = port.prefill(t_(toks[:, :S]), t_(pt))
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks[:, :S]), "patches": j_(pt)})
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    close(logits, r_logits)
    assert_cache(cache, r_cache)
    cache = pad_seq(cache, 1)
    r_cache = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))), r_cache)
    d, cache = port.decode_step(cache, t_(toks[:, S]), S)
    r_d, r_cache = jax.jit(ref.decode_step)(params, r_cache, j_(toks[:, S]), jnp.int32(S))
    close(d, r_d)
    assert_cache(cache, r_cache)


def test_vlm_decode_from_init_cache_matches_reference(vlm):
    (_, ref, params), (_, port) = vlm
    toks = tokens(3, (B, 2))
    cache, r_cache = port.init_cache(B, 8), ref.init_cache(B, 8)
    assert_cache(cache, r_cache)
    step = jax.jit(ref.decode_step)
    for i in range(2):
        d, cache = port.decode_step(cache, t_(toks[:, i]), i)
        r_d, r_cache = step(params, r_cache, j_(toks[:, i]), jnp.int32(i))
        close(d, r_d)
        assert_cache(cache, r_cache)


def test_vlm_loss_matches_reference(vlm):
    (_, ref, params), (cfg, port) = vlm
    toks, pt = tokens(4), patches(cfg, 5)
    labels = toks.copy()
    labels[:, : cfg.vision_patches] = -1  # no targets on the image positions
    with torch.no_grad():  # the value only
        loss, metrics = port.loss({"tokens": t_(toks), "patches": t_(pt), "labels": t_(labels)})
    r_loss, r_metrics = jax.jit(ref.loss)(
        params, {"tokens": j_(toks), "patches": j_(pt), "labels": j_(labels)})
    close(loss, r_loss)
    close(metrics["ce"], r_metrics["ce"])


# ---------------------------------------------------------------------------
# hubert-xlarge
# ---------------------------------------------------------------------------


def test_hubert_encode_matches_reference(audio):
    (_, ref, params), (cfg, port) = audio
    fr = frames(cfg, 6)
    got = port.encode(t_(fr))
    want = jax.jit(ref.encode)(params, {"frames": j_(fr)})
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    close(got, want)


def test_hubert_encode_is_bidirectional(audio):
    """A change to the last frame moves every frame's logits (a causal stack
    would leave the earlier ones bitwise as they were)."""
    _, (cfg, port) = audio
    fr = frames(cfg, 7)
    moved = fr.copy()
    moved[:, -1] += 1.0
    a, b = port.encode(t_(fr)), port.encode(t_(moved))
    assert bool((a[:, 0] != b[:, 0]).any(-1).all())


def test_hubert_loss_matches_reference(audio):
    (_, ref, params), (cfg, port) = audio
    fr = frames(cfg, 8)
    labels = rng(9).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[1, :7] = -1
    with torch.no_grad():  # the value only
        loss, metrics = port.loss({"frames": t_(fr), "labels": t_(labels)})
    r_loss, r_metrics = jax.jit(ref.loss)(params, {"frames": j_(fr), "labels": j_(labels)})
    close(loss, r_loss)
    close(metrics["ce"], r_metrics["ce"])


# ---------------------------------------------------------------------------
# the reference's Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_matches_the_reference_pallas_kernel(arch):
    """``use_pallas=True`` on the reference side: its Pallas attention kernel
    in interpret mode (non-causal for hubert), which the port's B4 (here
    its plain version) ports."""
    (ref_cfg, _, params), (cfg, port) = build(arch)
    ref = RefModel(dataclasses.replace(ref_cfg, use_pallas=True))
    if arch == AUDIO:
        fr = frames(cfg, 10)
        close(port.encode(t_(fr)), jax.jit(ref.encode)(params, {"frames": j_(fr)}))
        return
    toks, pt = tokens(10), patches(cfg, 11)
    logits, cache = port.prefill(t_(toks), t_(pt))
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks), "patches": j_(pt)})
    close(logits, r_logits)
    assert_cache(cache, r_cache)


# ---------------------------------------------------------------------------
# the reference's smoke cases (tests/test_models_smoke.py), on the port
# ---------------------------------------------------------------------------


def smoke_batch(cfg, B=2, S=32):
    """``tests/test_models_smoke.py::_batch``, as torch tensors."""
    if cfg.family == "audio":
        return {"frames": t_(rng(0).normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)),
                "labels": torch.zeros((B, S), dtype=torch.int32)}
    b = {"tokens": t_(rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)),
         "labels": t_(rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.family == "vlm":
        b["patches"] = torch.zeros((B, cfg.vision_patches, cfg.frontend_dim))
    return b


def smoke_model(arch):
    return Model(get_arch(arch, reduced=True), device="cpu")


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_forward_loss_finite(arch):
    model = smoke_model(arch)
    with torch.no_grad():  # the value only
        loss, _ = model.loss(smoke_batch(model.cfg))
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), arch
    assert float(loss) > 0


def test_decode_step_shapes():
    model = smoke_model(VLM)
    cache = model.init_cache(2, 64)
    logits, cache = model.decode_step(cache, torch.zeros(2, dtype=torch.int32), 0)
    logits, cache = model.decode_step(cache, torch.ones(2, dtype=torch.int32), 1)
    assert logits.shape == (2, model.cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_hubert_encode_shapes():
    model = smoke_model(AUDIO)
    out = model.encode(smoke_batch(model.cfg)["frames"])
    assert out.shape == (2, 32, model.cfg.vocab)
    assert bool(torch.isfinite(out).all())


def test_vlm_patches_change_output():
    model = smoke_model(VLM)
    b = smoke_batch(model.cfg)
    with torch.no_grad():  # the value only
        l1, _ = model.loss(b)
    with torch.no_grad():  # the value only
        l2, _ = model.loss({**b, "patches": b["patches"] + 1.0})
    assert float(l1) != pytest.approx(float(l2))


def test_vlm_prefill_then_decode_equals_longer_prefill(vlm):
    """prefill(p ⧺ t) == prefill(p) + decode_step(t) at position len(p), the
    patches over the first positions of both (the reference's handoff
    test, within its 2e-3)."""
    _, (cfg, port) = vlm
    P = 16
    toks, pt = t_(tokens(14, (1, P + 1))), t_(patches(cfg, 15, batch=1))
    full, _ = port.prefill(toks, pt)
    _, cache = port.prefill(toks[:, :P], pt)
    dec, _ = port.decode_step(pad_seq(cache, 1), toks[:, P], P)
    np.testing.assert_allclose(dec[0].numpy(), full[0].numpy(), atol=HANDOFF_TOL, rtol=HANDOFF_TOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["prefill", "init_cache", "decode_step"])
def test_encoder_refuses_decoder_entry_points(audio, entry):
    _, (_, port) = audio
    toks = torch.zeros((B, 4), dtype=torch.long)
    call = {"prefill": lambda: port.prefill(toks),
            "init_cache": lambda: port.init_cache(B, 8),
            "decode_step": lambda: port.decode_step({}, toks[:, 0], 0)}[entry]
    with pytest.raises(NotImplementedError, match="encode"):
        call()


def test_vlm_prefill_refuses_missing_patches_and_others_refuse_patches(vlm):
    _, (cfg, port) = vlm
    toks = torch.zeros((B, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="patches"):
        port.prefill(toks)
    dense = smoke_model("qwen2-0.5b")
    with pytest.raises(ValueError, match="patches"):
        dense.prefill(toks, torch.zeros((B, 4, 32)))
    with pytest.raises(NotImplementedError, match="frames"):
        port.encode(torch.zeros((B, 8, cfg.frontend_dim)))
