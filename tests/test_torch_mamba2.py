"""The port's Mamba-2 serving path against the reference's, on the CPU.

Reduced ``mamba2-1.3b`` (4 layers, d_model 64, 8 heads × 16, d_state 16,
chunk 32, vocab 512, float32).  ``jax.random`` cannot be reproduced in
torch, so the reference initializes the weights and they cross as NumPy
through ``convert.lm_params_from_jax``; the same NumPy-seeded tokens and
activations go through both.  Each side gets its own copy of every input,
and the port runs before the reference, so no buffer is shared between
the two runtimes while either computes.

Tolerance: atol = rtol = 2e-4 on logits, states and loss.  Both sides are
float32 (TF32 off); they differ in matmul and reduction order, in the
SSD's prefix sum and in softplus / SiLU / rsqrt, over four layers and a
512-way head.  The loss is checked against the reference's jnp oracle and
its Pallas kernel (``use_pallas=True``, interpret mode).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models.backbone import Model as RefModel  # noqa: E402
from repro.models.mamba2 import mamba2_decode, mamba2_forward  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402

TOL = 2e-4
ARCH = "mamba2-1.3b"
B, S = 2, 48  # 48 is not a multiple of the reduced chunk (32): the model pads


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, Model, params), (port cfg, Model) on the same weights."""
    ref_cfg = ref_get_arch(ARCH, reduced=True)
    ref = RefModel(ref_cfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    cfg = get_arch(ARCH, reduced=True)
    port = Model(cfg, device="cpu")
    port.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params)))
    return (ref_cfg, ref, params), (cfg, port)


def tokens(seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def t_(a):
    return torch.tensor(np.asarray(a))


def j_(a):
    return jnp.array(np.asarray(a), copy=True)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_equals_reference(reduced):
    ref, port = ref_get_arch(ARCH, reduced=reduced), get_arch(ARCH, reduced=reduced)
    shared = [f.name for f in dataclasses.fields(port)]
    assert shared and all(hasattr(ref, f) for f in shared)
    for f in shared:
        if f == "ssm":
            assert dataclasses.asdict(port.ssm) == dataclasses.asdict(ref.ssm)
        else:
            assert getattr(port, f) == getattr(ref, f), f
    assert ref.norm == "rmsnorm" and ref.tie_embeddings  # what the port's Model builds
    if reduced:
        assert (port.n_layers, port.d_model, port.vocab, port.param_dtype) == (4, 64, 512, "float32")
        assert (port.ssm.d_state, port.ssm.head_dim, port.ssm.chunk) == (16, 16, 32)


def test_registry_and_model_refuse_what_is_not_ported():
    """Every reference id is ported; an unknown id and an unknown family
    still raise."""
    with pytest.raises(KeyError, match="unknown architecture"):
        get_arch("retnet-7b")
    cfg = dataclasses.replace(get_arch(ARCH, reduced=True), family="retention")
    with pytest.raises(NotImplementedError, match="unknown family"):
        Model(cfg, device="cpu")


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_arch(ARCH, reduced=True))


@pytest.mark.parametrize("seq", [48, 64])
def test_mixer_forward_state_and_decode_match_reference(pair, seq):
    (ref_cfg, _, params), (cfg, port) = pair
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((B, seq + 1, cfg.d_model)).astype(np.float32)
    mixer = port.layers[1].mixer
    with torch.no_grad():
        out = mixer(t_(x[:, :seq]))
        out_s, st = mixer(t_(x[:, :seq]), return_state=True)
        dec, st2 = mixer.decode(t_(x[:, seq:]), st)
    p = jax.tree.map(lambda a: a[1], params["layers"]["mixer"])
    r_out = mamba2_forward(p, j_(x[:, :seq]), ref_cfg)
    r_out_s, r_st = mamba2_forward(p, j_(x[:, :seq]), ref_cfg, return_state=True)
    r_dec, r_st2 = mamba2_decode(p, j_(x[:, seq:]), r_st, ref_cfg)
    close(out, r_out)
    close(out_s, r_out_s)
    close(dec, r_dec)
    for k in ("ssm", "conv"):
        assert st[k].dtype == torch.float32 and tuple(st[k].shape) == r_st[k].shape, k
        close(st[k], r_st[k])
        close(st2[k], r_st2[k])


def test_prefill_and_decode_match_reference(pair):
    (ref_cfg, ref, params), (cfg, port) = pair
    toks = tokens(1, (B, S + 2))
    logits, cache = port.prefill(t_(toks[:, :S]))
    d1, cache1 = port.decode_step(cache, t_(toks[:, S]), S)
    d2, cache2 = port.decode_step(cache1, t_(toks[:, S + 1]), S + 1)
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks[:, :S])})
    step = jax.jit(ref.decode_step)
    r_d1, r_cache1 = step(params, r_cache, j_(toks[:, S]), jnp.int32(S))
    r_d2, r_cache2 = step(params, r_cache1, j_(toks[:, S + 1]), jnp.int32(S + 1))
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    for got, ref_ in ((logits, r_logits), (d1, r_d1), (d2, r_d2)):
        close(got, ref_)
    for got, ref_ in ((cache, r_cache), (cache1, r_cache1), (cache2, r_cache2)):
        assert sorted(got) == sorted(ref_) == ["conv", "ssm"]
        for k in got:
            assert tuple(got[k].shape) == ref_[k].shape, k
            close(got[k], ref_[k])
    # init_cache has the reference's layout
    zero = port.init_cache(B, 64)
    r_zero = ref.init_cache(B, 64)
    for k in r_zero:
        assert tuple(zero[k].shape) == r_zero[k].shape and not zero[k].any(), k


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_matches_reference(pair, use_pallas):
    (ref_cfg, _, params), (cfg, port) = pair
    toks = tokens(2)
    labels = toks.copy()
    labels[0, :5] = -1  # masked positions
    with torch.no_grad():  # the value only
        loss, metrics = port.loss({"tokens": t_(toks), "labels": t_(labels)})
    ref = RefModel(dataclasses.replace(ref_cfg, use_pallas=use_pallas))
    r_loss, r_metrics = jax.jit(ref.loss)(params, {"tokens": j_(toks), "labels": j_(labels)})
    close(loss, r_loss)
    close(metrics["ce"], r_metrics["ce"])
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("prompt", [2, S])
def test_prefill_then_decode_equals_longer_prefill(pair, prompt):
    """The port's own handoff: prefill(p ⧺ t) == prefill(p) + decode_step(t),
    also for a prompt shorter than the conv's K - 1 = 3 rows of state."""
    _, (cfg, port) = pair
    toks = t_(tokens(3, (B, prompt + 1)))
    full, _ = port.prefill(toks)
    _, cache = port.prefill(toks[:, :prompt])
    assert cache["conv"].shape[2] == cfg.ssm.conv_kernel - 1
    dec, _ = port.decode_step(cache, toks[:, prompt], prompt)
    close(dec, full)
