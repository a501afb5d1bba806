"""The attention kernel's plain version against the reference.

Inputs are made with a NumPy seed and go through

  * ``repro.kernels.attention.ref.attention_ref`` (full-matrix oracle),
  * ``repro.kernels.attention.kernel.flash_attention_pallas`` in interpret
    mode (the TPU kernel's program, online softmax over key blocks),
  * ``repro.core.model._attention``'s jnp path (what the reference model's
    step runs; causal, Sq == Sk, no segments),

and the port's ``attention_plain`` / ``flash_attention`` on the CPU.

Tolerance: atol = rtol = 2e-6.  Every path computes in float32; they differ
only in summation order (einsum vs blocked online softmax) and in
multiplying by 1/sqrt(D) vs dividing by sqrt(D) — a few ulp on outputs of
magnitude <= ~4 for unit-normal inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.model import _attention as ref_model_attention  # noqa: E402
from repro.kernels.attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.attention.ref import attention_ref  # noqa: E402

from repro_torch.kernels.attention import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.attention.ref import attention_plain  # noqa: E402

ATOL = RTOL = 2e-6


def close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=msg)


def make(seed, B, H, Sq, Sk, D, Dv, segmented):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, Dv)).astype(np.float32)
    seg = None
    if segmented:
        cuts = np.sort(rng.integers(1, Sk, (B, 3)), axis=1)
        seg = (np.arange(Sk)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(np.int32)
    return q, k, v, seg


# (B, H, Sq, Sk, D, Dv, causal, q_offset, segmented)
CASES = {
    "tao_causal": (2, 4, 129, 129, 32, 32, True, 0, False),
    "noncausal": (2, 2, 33, 33, 16, 16, False, 0, False),
    "causal_segments": (2, 2, 40, 40, 16, 16, True, 0, True),
    "decode_q_offset": (2, 2, 8, 40, 16, 24, True, 32, False),
    "q_offset_segments": (2, 2, 12, 40, 16, 16, True, 20, True),
    "rows_past_sk_masked": (1, 2, 12, 20, 8, 8, False, 15, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_oracle_and_pallas(case):
    B, H, Sq, Sk, D, Dv, causal, off, segmented = CASES[case]
    q, k, v, seg = make(sorted(CASES).index(case), B, H, Sq, Sk, D, Dv, segmented)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tseg = None if seg is None else torch.from_numpy(seg)
    got = attention_plain(tq, tk, tv, tseg, causal=causal, q_offset=off)
    jseg = None if seg is None else jnp.asarray(seg)
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg,
                        causal=causal, q_offset=off)
    close(got, ref, f"{case} vs attention_ref")
    pal = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg,
                                 causal=causal, q_offset=off, block_q=16, block_k=16,
                                 interpret=True)
    close(got, pal, f"{case} vs flash_attention_pallas")
    assert got.shape == (B, H, Sq, Dv)


def test_fully_masked_rows_are_zero():
    B, H, Sq, Sk, D, Dv, causal, off, _ = CASES["rows_past_sk_masked"]
    q, k, v, seg = make(3, B, H, Sq, Sk, D, Dv, True)
    got = attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg),
                          causal=causal, q_offset=off)
    past = off + np.arange(Sq) >= Sk  # these rows carry segment -2: no key
    assert past.any()
    assert torch.all(got[:, :, torch.from_numpy(past)] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_dispatch_matches_reference_model_attention(causal):
    """``flash_attention`` on CPU tensors is the plain version (no launch)
    and agrees with the jnp path the reference model's step runs."""
    q, k, v, _ = make(7, 3, 4, 129, 129, 32, 32, False)
    launches = port_kernel.FLASH_ATTENTION.launches
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert port_kernel.FLASH_ATTENTION.launches == launches
    ref = ref_model_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, False)
    close(got, ref, "vs core.model._attention")


def test_cuda_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.flash_attention_cuda(q, q, q)
