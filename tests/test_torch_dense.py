"""The port's dense serving path against the reference's, on the CPU.

The four ``dense`` configs reduced (4 layers, d_model 64, at most 4 heads
of 16, d_ff 128, vocab 512, float32): ``qwen2-0.5b`` (GQA, QKV bias, tied
head, rmsnorm), ``stablelm-1.6b`` (MHA, layernorm, untied head),
``glm4-9b`` (GQA, QKV bias, untied) and ``qwen1.5-32b`` (MHA, QKV bias,
untied).  ``jax.random`` cannot be reproduced in torch, so the reference
initializes the weights and they cross as NumPy through
``convert.lm_params_from_jax``; the same NumPy-seeded tokens go through
both.  Each side gets its own copy of every input.

Tolerance: atol = rtol = 2e-4 on logits, caches and loss.  Both sides are
float32 (TF32 off); they differ in matmul and reduction order, in the
attention's softmax (the reference's ``flash_ref`` runs online over
512-key blocks, the port's plain version over the whole row), in
``cos`` / ``sin`` at angles up to ~50 rad and in rsqrt, over four layers
and a 512-way head.  The reference runs its default path (``flash_ref``)
and, for ``qwen2-0.5b``, its Pallas kernel (``use_pallas=True``,
interpret mode).  A cache from ``init_cache`` is bfloat16 on both sides
(``kv_cache_dtype``), whatever the compute dtype, and is compared in
bfloat16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.kernels.attention.kernel import flash_attention_pallas  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models.backbone import Model as RefModel  # noqa: E402
from repro.models.rotary import apply_rope as ref_apply_rope  # noqa: E402
from repro.nn.core import layernorm as ref_layernorm  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels.attention.ref import attention_plain  # noqa: E402
from repro_torch.models import Model, apply_rope, quantize_kv  # noqa: E402
from repro_torch.nn.core import scaled_layernorm  # noqa: E402

TOL = 2e-4
DENSE = ("qwen2-0.5b", "stablelm-1.6b", "glm4-9b", "qwen1.5-32b")
B, S = 2, 48


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=tol)


def t_(a):
    return torch.tensor(np.asarray(a))


def j_(a):
    return jnp.array(np.asarray(a), copy=True)


def np_(t):
    """A port tensor as NumPy float32 (bfloat16 widened exactly)."""
    return t.detach().float().numpy() if t.is_floating_point() else t.detach().numpy()


def tokens(seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def build(arch, **changes):
    """(reference cfg, Model, params), (port cfg, Model) on the same weights."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch, reduced=True), **changes)
    ref = RefModel(ref_cfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_arch(arch, reduced=True), **changes)
    port = Model(cfg, device="cpu")
    port.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params)))
    return (ref_cfg, ref, params), (cfg, port)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return build(request.param)


def assert_cache(got, ref):
    """Same leaves, shapes and dtypes; values within TOL, and a bfloat16
    leaf also within one bfloat16 ulp: its rows are float32 values that
    agree within TOL, each rounded once into the cache, and two that
    straddle a rounding boundary land one ulp apart."""
    assert sorted(got) == sorted(ref)
    for k in got:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(ref[k].dtype), k
        g, w = np_(got[k]), np.asarray(ref[k]).astype(np.float32)
        if got[k].dtype == torch.bfloat16:
            assert np.all(np.abs(g - w) <= np.maximum(TOL + TOL * np.abs(w), bf16_ulp(w))), k
        else:
            close(g, w)


def pad_seq(cache, n):
    """Grow a prefill cache by ``n`` zero positions (the reference's handoff
    test pads the same way)."""
    return {k: torch.cat([v, v.new_zeros(v.shape[:2] + (n,) + v.shape[3:])], 2) for k, v in cache.items()}


def snapshot(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_prefill_and_two_decode_steps_match_reference(pair):
    (ref_cfg, ref, params), (cfg, port) = pair
    toks = tokens(1, (B, S + 2))
    logits, cache = port.prefill(t_(toks[:, :S]))
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks[:, :S])})
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    close(logits, r_logits)
    assert_cache(cache, r_cache)

    cache = pad_seq(cache, 2)
    r_cache = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0))), r_cache)
    step = jax.jit(ref.decode_step)
    for i in range(2):
        d, cache = port.decode_step(cache, t_(toks[:, S + i]), S + i)
        r_d, r_cache = step(params, r_cache, j_(toks[:, S + i]), jnp.int32(S + i))
        close(d, r_d)
        assert_cache(cache, r_cache)


def test_decode_from_init_cache_matches_reference(pair):
    """A zero cache from ``init_cache`` (bfloat16 on both sides), two steps
    from position 0: the rows are rounded into the cache's dtype."""
    (_, ref, params), (cfg, port) = pair
    toks = tokens(2, (B, 2))
    cache, r_cache = port.init_cache(B, 8), ref.init_cache(B, 8)
    assert_cache(cache, r_cache)
    assert cache["k"].dtype == torch.bfloat16
    step = jax.jit(ref.decode_step)
    for i in range(2):
        d, cache = port.decode_step(cache, t_(toks[:, i]), i)
        r_d, r_cache = step(params, r_cache, j_(toks[:, i]), jnp.int32(i))
        close(d, r_d)
        assert_cache(cache, r_cache)


def test_loss_matches_reference(pair):
    (_, ref, params), (_, port) = pair
    toks = tokens(3)
    labels = toks.copy()
    labels[0, :5] = -1  # masked positions
    with torch.no_grad():  # the value only
        loss, metrics = port.loss({"tokens": t_(toks), "labels": t_(labels)})
    r_loss, r_metrics = jax.jit(ref.loss)(params, {"tokens": j_(toks), "labels": j_(labels)})
    close(loss, r_loss)
    close(metrics["ce"], r_metrics["ce"])
    assert float(metrics["aux"]) == 0.0 and np.isfinite(float(loss))


@pytest.mark.parametrize("entry", ["prefill", "loss"])
def test_qwen2_matches_the_reference_pallas_kernel(entry):
    """``use_pallas=True`` on the reference side: its Pallas attention kernel
    in interpret mode, which the port's B4 (here its plain version) ports."""
    (ref_cfg, _, params), (_, port) = build("qwen2-0.5b")
    ref = RefModel(dataclasses.replace(ref_cfg, use_pallas=True))
    toks = tokens(4)
    if entry == "prefill":
        logits, cache = port.prefill(t_(toks))
        r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks)})
        close(logits, r_logits)
        assert_cache(cache, r_cache)
    else:
        with torch.no_grad():  # the value only
            loss, _ = port.loss({"tokens": t_(toks), "labels": t_(toks)})
        r_loss, _ = jax.jit(ref.loss)(params, {"tokens": j_(toks), "labels": j_(toks)})
        close(loss, r_loss)


@pytest.mark.parametrize("prompt", [1, S])
def test_prefill_then_decode_equals_longer_prefill(pair, prompt):
    """The port's own handoff: prefill(p ⧺ t) == prefill(p) + decode_step(t)
    at position len(p), on the prefill's cache (the write past its end is
    dropped, and the token's own k / v are attended inline)."""
    _, (_, port) = pair
    toks = t_(tokens(5, (B, prompt + 1)))
    full, _ = port.prefill(toks)
    _, cache = port.prefill(toks[:, :prompt])
    dec, _ = port.decode_step(cache, toks[:, prompt], prompt)
    close(dec, full)


@pytest.mark.parametrize("pos", [S, S + 5])
def test_decode_at_or_past_the_cache_end_leaves_it_unchanged(pair, pos):
    """A step at ``pos >= max_len`` writes nothing (the reference's clipped
    write) and still matches the reference's logits."""
    (_, ref, params), (_, port) = pair
    toks = tokens(6, (B, S + 1))
    _, cache = port.prefill(t_(toks[:, :S]))
    _, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks[:, :S])})
    before = snapshot(cache)
    d, after = port.decode_step(cache, t_(toks[:, S]), pos)
    r_d, r_after = jax.jit(ref.decode_step)(params, r_cache, j_(toks[:, S]), jnp.int32(pos))
    close(d, r_d)
    for k in before:
        assert torch.equal(after[k], before[k]), k
        np.testing.assert_array_equal(np.asarray(r_after[k]), np.asarray(r_cache[k]))


def test_int8_kv_cache_matches_reference(pair):
    """``kv_cache_dtype="int8"`` on both sides: three steps from a zero
    cache.  Codes equal (the rows differ by float32 ulps between the two
    sides, so a quotient x / scale within an ulp of a .5 boundary could
    round apart; none does on these inputs), scales within 1e-6 relative,
    logits within TOL."""
    (ref_cfg, _, _), (cfg, _) = pair
    (_, ref, params), (_, port) = build(cfg.name, kv_cache_dtype="int8")
    toks = tokens(7, (B, 3))
    cache, r_cache = port.init_cache(B, 8), ref.init_cache(B, 8)
    assert sorted(cache) == sorted(r_cache) == ["k", "k_scale", "v", "v_scale"]
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float32
    step = jax.jit(ref.decode_step)
    for i in range(3):
        d, cache = port.decode_step(cache, t_(toks[:, i]), i)
        r_d, r_cache = step(params, r_cache, j_(toks[:, i]), jnp.int32(i))
        close(d, r_d)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(r_cache[name]), rtol=1e-6, atol=0)
        for name in ("k", "v"):
            np.testing.assert_array_equal(cache[name].numpy(), np.asarray(r_cache[name]), err_msg=name)


def test_quantize_kv_rounds_half_to_even_like_the_reference():
    x = np.array([[[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]]], np.float32)
    q, s = quantize_kv(torch.tensor(x))
    r_q, r_s = ref_attention._quantize_kv(jnp.array(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(r_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(r_s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32) + 1000
    got = apply_rope(t_(x).to(getattr(torch, dtype)), t_(pos), 1_000_000.0)
    want = ref_apply_rope(j_(x).astype(dtype), j_(pos), 1_000_000.0)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    tol = TOL if dtype == "float32" else 2.0**-7  # one bfloat16 rounding apart
    close(np_(got), np.asarray(want).astype(np.float32), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference_cast_points(dtype):
    rng = np.random.default_rng(9)
    x = (3.0 + rng.standard_normal((4, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    dt = getattr(torch, dtype)
    got = scaled_layernorm(t_(x).to(dt), t_(scale).to(dt), t_(bias).to(dt))
    want = ref_layernorm({"scale": j_(scale).astype(dtype), "bias": j_(bias).astype(dtype)},
                         j_(x).astype(dtype))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    tol = 1e-5 if dtype == "float32" else 2.0**-6  # bfloat16 intermediates, rounded apart
    close(np_(got), np.asarray(want).astype(np.float32), tol)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("case", ["causal", "q_offset", "noncausal"])
def test_attention_plain_bf16_within_one_ulp_of_the_pallas_kernel(case):
    """B4's plain version on bfloat16 inputs against the reference's Pallas
    kernel (interpret mode) on the same: both upcast, compute in float32
    and round once to bfloat16, so they differ by at most one bfloat16 ulp
    (a float32 sum order that lands on the other side of a rounding
    boundary)."""
    rng = np.random.default_rng(10)
    Sq, Sk, off, causal = {"causal": (64, 64, 0, True), "q_offset": (24, 90, 66, True),
                           "noncausal": (40, 72, 0, False)}[case]
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 3, Sq, 32), (2, 3, Sk, 32), (2, 3, Sk, 32)))
    tq, tk, tv = (t_(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention_plain(tq, tk, tv, causal=causal, q_offset=off)
    want = flash_attention_pallas(j_(q).astype(jnp.bfloat16), j_(k).astype(jnp.bfloat16),
                                  j_(v).astype(jnp.bfloat16), causal=causal, q_offset=off,
                                  block_q=32, block_k=32, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = np_(got), np.asarray(want).astype(np.float32)
    assert np.all(np.abs(g - w) <= bf16_ulp(w)), float(np.abs(g - w).max())
    assert (g == w).mean() > 0.9


def test_attention_module_decode_uses_the_reference_gqa_grouping():
    """Query head h reads kv head h // (H // Hkv) in prefill and decode
    alike: a decode step over a cache holding a prompt's k / v equals the
    prompt's last prefill row, on the GQA config."""
    (_, ref, params), (cfg, port) = build("glm4-9b")
    assert cfg.n_heads // cfg.n_kv_heads == 2
    attn = port.layers[0].attn
    x = np.random.default_rng(11).standard_normal((B, 9, cfg.d_model)).astype(np.float32)
    pos = torch.arange(9).expand(B, 9)
    with torch.no_grad():
        full = attn(t_(x), pos)
        _, (k, v) = attn(t_(x[:, :8]), pos[:, :8], return_kv=True)
        dec, _ = attn.decode(t_(x[:, 8:]), {"k": k, "v": v}, 8)
    close(dec[:, 0], full[:, 8])
    p = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    r_full = ref_attention.attention_forward(p, j_(x), ref.cfg, jnp.broadcast_to(jnp.arange(9)[None], (B, 9)))
    close(full, r_full)


def test_dense_config_reduces_by_the_reference_rules():
    for arch in DENSE:
        cfg = get_arch(arch, reduced=True)
        assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (4, 64, 128, 512)
        assert cfg.n_heads == 4 and cfg.n_heads % cfg.n_kv_heads == 0
        assert cfg.resolved_head_dim == 16
        assert (cfg.param_dtype, cfg.compute_dtype, cfg.kv_cache_dtype) == ("float32", "float32", "bfloat16")
