"""The port's ``hybrid`` family (``recurrentgemma-9b``) against the
reference's, on the CPU.

Reduced by the reference's rules: one unit (two RG-LRU layers and one
local-attention layer, window 32) and a one-layer tail, d_model 64, 4
query heads over 1 kv head (MQA) of 16, d_ff 128, vocab 512, float32.
The reference initializes the weights with ``jax.random`` and they cross
as NumPy through ``convert.lm_params_from_jax``; the same NumPy-seeded
inputs go through both sides, each side its own copy.

Tolerances: atol = rtol = 2e-4 (``TOL``, as in ``tests/test_torch_dense.py``)
on the recurrent block, its states, the logits, the caches and the loss.
Both sides are float32 (TF32 off); they differ in matmul and reduction
order, in the scan's combination order (the port's Hillis–Steele scan
against ``associative_scan``), in ``cos`` / ``sin``, softplus and rsqrt,
over four layers and a 512-way head.  The scan alone is held to a float64
sequential loop within 1e-5 relative to the largest |h| (a's near e^-8
and near 1, S up to 200).  The windowed ``flash_ref`` is held to the
reference's at window < S, = S and > S within 1e-5 (one layer's scores
in another order).

The ring: the port puts position p in slot p mod window; the reference's
prefill keeps the last window keys in slots 0 … window-1.  The two caches
are the same where the prompt is at most the window or a multiple of it
(P = 16, 32, 64) and the reference's rolled by P mod window elsewhere
(P = 40).  The handoff (prefill(P), then a decode step at P) is held to
the reference's prefill(P + 1) within 2e-3, the bound of the reference's
own ``test_prefill_matches_decode``, at P = 16, 32, 40 and 64; at P = 40
the reference's own decode misses that bound (its ring is misaligned),
and a test records that it does.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ref_attention  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import Model, flash_ref, linear_scan  # noqa: E402
from test_torch_dense import assert_cache, build, close, j_, np_, t_  # noqa: E402

ARCH = "recurrentgemma-9b"
B = 2
HANDOFF_TOL = 2e-3  # the reference's test_prefill_matches_decode
SCAN_TOL = 1e-5
WINDOW = 32         # the reduced window


@functools.lru_cache(maxsize=None)
def built():
    """``build(ARCH)``, once per module: the tests share the weights and
    write only the caches they make."""
    return build(ARCH)


@pytest.fixture(scope="module")
def pair():
    return built()


@functools.lru_cache(maxsize=None)
def ref_prefill():
    return jax.jit(built()[0][1].prefill)


def tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(np.int32)


# the reference's block, jitted once per shape (eager, its associative_scan
# takes seconds)
ref_block_forward = jax.jit(ref_rglru.rglru_block_forward, static_argnums=(2, 3))
ref_block_decode = jax.jit(ref_rglru.rglru_block_decode, static_argnums=(3,))


def rec_params(params, unit, layer):
    """The reference's params of recurrent layer ``layer`` of ``unit``."""
    return jax.tree.map(lambda a: a[unit, layer], params["layers"]["recs"]["rec"])


def grow(cache, max_len):
    """A prefill cache copied into a cache of min(max_len, window) ring
    slots (the reference's handoff test pads the same way), in the
    prefill's dtype."""
    k = cache["attn"]["k"]
    n = min(max_len, WINDOW) - k.shape[2]
    attn = {name: torch.cat([t, t.new_zeros(t.shape[:2] + (n,) + t.shape[3:])], 2)
            for name, t in cache["attn"].items()}
    return {"attn": attn, "rec": {name: t.clone() for name, t in cache["rec"].items()}}


# ---------------------------------------------------------------------------
# config, weights, refusals
# ---------------------------------------------------------------------------


def test_reduced_config_is_one_unit_and_a_tail(pair):
    (ref_cfg, _, params), (cfg, port) = pair
    assert dataclasses.asdict(cfg.hybrid) == dataclasses.asdict(ref_cfg.hybrid)
    assert (cfg.n_layers, cfg.hybrid.window, cfg.hybrid.lru_width) == (4, WINDOW, None)
    assert len(port.layers) == 1 and len(port.layers[0].recs) == 2 and len(port.tail) == 1
    # every leaf of the reference's tree crossed: strict load, same count
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_ref


def test_init_draws_the_reference_distributions():
    """Λ so that a = exp(-8 softplus(Λ)) spans [0.9, 0.999]; conv_b zero;
    the projections' std 1/sqrt(fan_in), conv_w's 0.5."""
    cfg = dataclasses.replace(get_arch(ARCH, reduced=True), d_model=512)
    rec = Model(cfg, device="cpu").layers[0].recs[0].rec
    a = torch.exp(-8.0 * torch.nn.functional.softplus(getattr(rec, "lambda").detach()))
    assert getattr(rec, "lambda").dtype == torch.float32
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert float(a.max() - a.min()) > 0.09
    assert not rec.conv_b.any()
    for name, std in (("w_x", 512 ** -0.5), ("w_r", 512 ** -0.5), ("out", 512 ** -0.5),
                      ("conv_w", 0.5)):
        assert abs(float(getattr(rec, name).std()) / std - 1) < 0.1, name


def test_model_refuses_a_unit_of_two_attention_layers():
    cfg = get_arch(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(cfg.hybrid, attn_per_unit=2))
    with pytest.raises(NotImplementedError, match="one attention layer"):
        Model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the scan, the recurrent block, windowed attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 7, 64, 200])
def test_linear_scan_matches_sequential_recurrence(S):
    """a in [e^-8, 1) (the RG-LRU's range, a's products underflowing over
    long spans), b of either sign: the Hillis–Steele scan against a float64
    loop and against the reference's associative_scan combine."""
    r = np.random.default_rng(S)
    a = np.exp(-8.0 * r.random((2, S, 24))).astype(np.float32)
    a[:, :, :4] = 1.0 - 1e-4 * r.random((2, S, 4))  # slow decay
    b = r.standard_normal((2, S, 24)).astype(np.float32)
    h = linear_scan(t_(a), t_(b)).numpy()
    want = np.zeros_like(b, dtype=np.float64)
    prev = np.zeros((2, 24))
    for t in range(S):
        prev = a[:, t].astype(np.float64) * prev + b[:, t]
        want[:, t] = prev
    assert np.all(np.isfinite(h))
    np.testing.assert_allclose(h, want, atol=SCAN_TOL * np.abs(want).max(), rtol=0)

    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    _, ref = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1))(j_(a), j_(b))
    np.testing.assert_allclose(h, np.asarray(ref), atol=SCAN_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("seq", [2, 5, 48, 64])
def test_rglru_forward_and_state_match_reference(pair, seq):
    """The block's output and its state; at seq 2 (< K - 1 = 3) the port's
    conv state is the reference's two rows zero-padded on the left."""
    (ref_cfg, _, params), (cfg, port) = pair
    x = np.random.default_rng(seq).standard_normal((B, seq, cfg.d_model)).astype(np.float32)
    rec = port.layers[0].recs[1].rec
    p = rec_params(params, 0, 1)
    with torch.no_grad():
        out = rec(t_(x))
        out_s, st = rec(t_(x), return_state=True)
    r_out = ref_block_forward(p, j_(x), ref_cfg, False)
    r_out_s, r_st = ref_block_forward(p, j_(x), ref_cfg, True)
    close(out, r_out)
    close(out_s, r_out_s)
    assert st["h"].dtype == st["conv"].dtype == torch.float32
    close(st["h"], r_st["h"])
    K1 = cfg.hybrid.conv_kernel - 1
    assert tuple(st["conv"].shape) == (B, K1, cfg.d_model)
    n = min(seq, K1)
    close(st["conv"][:, K1 - n:], r_st["conv"])
    assert not st["conv"][:, : K1 - n].any()


@pytest.mark.parametrize("seq", [5, 48])
def test_rglru_decode_matches_reference(pair, seq):
    """Two decode steps from the forward's state."""
    (ref_cfg, _, params), (cfg, port) = pair
    x = np.random.default_rng(seq + 1).standard_normal((B, seq + 2, cfg.d_model)).astype(np.float32)
    rec = port.layers[0].recs[0].rec
    p = rec_params(params, 0, 0)
    with torch.no_grad():
        _, st = rec(t_(x[:, :seq]), return_state=True)
    _, r_st = ref_block_forward(p, j_(x[:, :seq]), ref_cfg, True)
    for t in range(seq, seq + 2):
        with torch.no_grad():
            out, st = rec.decode(t_(x[:, t : t + 1]), st)
        r_out, r_st = ref_block_decode(p, j_(x[:, t : t + 1]), r_st, ref_cfg)
        close(out, r_out)
        close(st["h"], r_st["h"])
        close(st["conv"], r_st["conv"])


def test_rglru_init_state_matches_reference(pair):
    (ref_cfg, ref, _), (cfg, port) = pair
    got, want = port.init_cache(B, 8)["rec"], ref.init_cache(B, 8)["rec"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32
        assert not got[k].any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [10, 64, 100])
def test_windowed_flash_ref_matches_reference(window, causal):
    """S = 64 in blocks of 16, so key blocks wholly before the window are
    skipped (window 10), none is (64 = S) and the window is wider than the
    sequence (100); with a q_offset of 5 against 69 keys too."""
    r = np.random.default_rng(window)
    q, k, v = (r.standard_normal((2, 3, 64, 16)).astype(np.float32) for _ in range(3))
    got = flash_ref(t_(q), t_(k), t_(v), causal=causal, window=window, block_q=16, block_k=16)
    want = ref_attention.flash_ref(j_(q), j_(k), j_(v), causal=causal, window=window,
                                   block_q=16, block_k=16)
    close(got, want, SCAN_TOL)
    k2, v2 = (r.standard_normal((2, 3, 69, 16)).astype(np.float32) for _ in range(2))
    got = flash_ref(t_(q), t_(k2), t_(v2), causal=causal, window=window, q_offset=5,
                    block_q=16, block_k=16)
    want = ref_attention.flash_ref(j_(q), j_(k2), j_(v2), causal=causal, window=window,
                                   q_offset=5, block_q=16, block_k=16)
    close(got, want, SCAN_TOL)


# ---------------------------------------------------------------------------
# the model: logits, caches, the handoff, decode, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [16, 32, 40, 64])
def test_prefill_logits_and_cache_match_reference(pair, P):
    (ref_cfg, ref, params), (cfg, port) = pair
    toks = tokens(P, P)
    logits, cache = port.prefill(t_(toks))
    r_logits, r_cache = ref_prefill()(params, {"tokens": j_(toks)})
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    close(logits, r_logits)
    assert sorted(cache) == sorted(r_cache) == ["attn", "rec"]
    assert_cache(cache["rec"], r_cache["rec"])
    want = dict(r_cache["attn"])
    if P > WINDOW and P % WINDOW:  # the reference's slots rolled into the ring
        want = {k: np.roll(np.asarray(a), P % WINDOW, axis=2) for k, a in want.items()}
    assert_cache(cache["attn"], want)
    assert cache["attn"]["k"].shape[2] == min(P, WINDOW)


@pytest.mark.parametrize("P", [16, 32, 40, 64])
def test_handoff_matches_reference_prefill_of_the_longer_prompt(pair, P):
    """prefill(P) then decode_step at P against the reference's
    prefill(P + 1): P = 40 crosses the window off its multiple."""
    (_, _, params), (_, port) = pair
    toks = tokens(100 + P, P + 1)
    _, cache = port.prefill(t_(toks[:, :P]))
    dec, _ = port.decode_step(grow(cache, P + 1), t_(toks[:, P]), P)
    full, _ = ref_prefill()(params, {"tokens": j_(toks)})
    close(dec, full, HANDOFF_TOL)


def test_reference_ring_handoff_misses_its_bound_at_40(pair):
    """The fault the port does not copy: the reference's prefill(40) then
    decode at 40 (its cache as it comes) against its prefill(41)."""
    (_, ref, params), _ = pair
    P = 40
    toks = tokens(100 + P, P + 1)
    full, _ = ref_prefill()(params, {"tokens": j_(toks)})
    _, cache = ref_prefill()(params, {"tokens": j_(toks[:, :P])})
    dec, _ = jax.jit(ref.decode_step)(params, cache, j_(toks[:, P]), jnp.int32(P))
    assert np.abs(np.asarray(dec) - np.asarray(full)).max() > HANDOFF_TOL


def test_decode_across_the_ring_matches_reference_prefill(pair):
    """prefill(12), then 40 greedy-free steps of given tokens to position 51
    (the ring wraps at 32): each step's logits against the reference's
    prefill of the prompt so far, at every 13th step and the last."""
    (_, _, params), (_, port) = pair
    toks = tokens(7, 52)
    _, cache = port.prefill(t_(toks[:, :12]))
    cache = grow(cache, 52)
    for t in range(12, 52):
        dec, cache = port.decode_step(cache, t_(toks[:, t]), t)
        if t % 13 == 0 or t == 51:
            full, _ = ref_prefill()(params, {"tokens": j_(toks[:, : t + 1])})
            close(dec, full, HANDOFF_TOL)


def test_two_decode_steps_match_reference(pair):
    """From prefill(16) grown to 18 slots on both sides, two steps: logits
    and every cache leaf against the reference's."""
    (_, ref, params), (_, port) = pair
    P = 16
    toks = tokens(3, P + 2)
    _, cache = port.prefill(t_(toks[:, :P]))
    cache = grow(cache, P + 2)
    _, r_cache = ref_prefill()(params, {"tokens": j_(toks[:, :P])})
    pad = ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0))
    r_cache = {"attn": {k: jnp.pad(a, pad) for k, a in r_cache["attn"].items()},
               "rec": r_cache["rec"]}
    step = jax.jit(ref.decode_step)
    for i in range(2):
        d, cache = port.decode_step(cache, t_(toks[:, P + i]), P + i)
        r_d, r_cache = step(params, r_cache, j_(toks[:, P + i]), jnp.int32(P + i))
        close(d, r_d)
        assert_cache(cache["attn"], r_cache["attn"])
        assert_cache(cache["rec"], r_cache["rec"])


def test_decode_from_init_cache_matches_reference(pair):
    """The reference's ``test_decode_step_shapes`` case: a zero cache of 64
    positions (32 ring slots, bfloat16 on both sides), steps at 0 and 1."""
    (_, ref, params), (cfg, port) = pair
    cache, r_cache = port.init_cache(B, 64), ref.init_cache(B, 64)
    assert cache["attn"]["k"].dtype == torch.bfloat16 and cache["attn"]["k"].shape[2] == WINDOW
    step = jax.jit(ref.decode_step)
    for i in range(2):
        toks = np.full((B,), i, np.int32)
        d, cache = port.decode_step(cache, t_(toks), i)
        r_d, r_cache = step(params, r_cache, j_(toks), jnp.int32(i))
        close(d, r_d)
        assert d.shape == (B, cfg.vocab) and torch.isfinite(d).all()
        assert_cache(cache["attn"], r_cache["attn"])
        assert_cache(cache["rec"], r_cache["rec"])


@pytest.mark.parametrize("S", [32, 48])
def test_loss_matches_reference(pair, S):
    """Next-token loss over S tokens (48 passes the window), labels with
    masked positions."""
    (_, ref, params), (_, port) = pair
    toks = tokens(S, S)
    labels = tokens(S + 1, S)
    labels[:, ::7] = -1
    with torch.no_grad():  # the value only
        loss, parts = port.loss({"tokens": t_(toks), "labels": t_(labels)})
    r_loss, r_parts = jax.jit(ref.loss)(params, {"tokens": j_(toks), "labels": j_(labels)})
    close(loss, r_loss)
    close(parts["ce"], r_parts["ce"])
    assert float(parts["aux"]) == 0.0


def test_bfloat16_block_tracks_reference(pair):
    """The recurrent block in bfloat16 on both sides (the reference's cast
    points): within 2^-5 of the largest |output| over 48 positions, the
    states within 2^-6 of theirs (one bfloat16 rounding of nearly equal
    values, carried through the gates and the scan)."""
    (ref_cfg, _, params), (cfg, port) = pair
    ref16 = dataclasses.replace(ref_cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    m16 = Model(cfg16, device="cpu")
    m16.load_state_dict(port.state_dict())
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 and a.ndim > 1
                     else a, rec_params(params, 0, 1))
    p["conv_b"] = p["conv_b"].astype(jnp.bfloat16)
    x = np.random.default_rng(9).standard_normal((B, 48, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, st = m16.layers[0].recs[1].rec(t_(x).bfloat16(), return_state=True)
    r_out, r_st = ref_block_forward(p, j_(x).astype(jnp.bfloat16), ref16, True)
    assert out.dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    w = np.asarray(r_out, np.float32)
    np.testing.assert_allclose(np_(out), w, atol=2 ** -5 * np.abs(w).max(), rtol=0)
    for k in ("h", "conv"):
        w = np.asarray(r_st[k], np.float32)
        np.testing.assert_allclose(np_(st[k]), w, atol=2 ** -6 * np.abs(w).max(), rtol=0)
