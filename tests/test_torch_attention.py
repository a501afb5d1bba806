"""The attention kernel's plain version against the reference.

Inputs are made with a NumPy seed and go through

  * ``repro.kernels.attention.ref.attention_ref`` (full-matrix oracle),
  * ``repro.kernels.attention.kernel.flash_attention_pallas`` in interpret
    mode (the TPU kernel's program, online softmax over key blocks),
  * ``repro.core.model._attention``'s jnp path (what the reference model's
    step runs; causal, Sq == Sk, no segments),

and the port's ``attention_plain`` / ``flash_attention`` on the CPU.

The backward's plain version, ``attention_bwd_plain`` (the explicit
formulas the CUDA backward is held to on the card), is held to torch
autograd through ``attention_plain`` and to ``jax.vjp`` of the reference
model's jnp attention, within atol = rtol = 2e-6 (float32 einsums in other
orders, gradients of magnitude <= ~10); ``FlashAttentionFn``'s wiring (the
forward's lse saved, the gradients returned in order) is checked on the
CPU with the two kernel calls swapped for their plain versions.  The
bfloat16 backward kernel's arithmetic (P and dS as two bfloat16 terms,
bfloat16 products summed in float32, one rounding) is emulated in torch
and held to the plain formulas in the card test's band at its shapes.

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

import jax  # noqa: E402

from repro_torch.kernels.attention import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as port_ops  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    attention_bwd_plain,
    attention_lse_plain,
    attention_plain,
)

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


def test_cuda_wrapper_refuses_a_strided_last_dimension():
    """Any batch, head and sequence strides go in; the last dimension must
    be contiguous (the kernel's rows are copied as runs of floats)."""
    q = torch.zeros(1, 1, 4, 16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dimension"):
        port_kernel.flash_attention_cuda(q, q, q)


def packed(seed, B, S, H, D):
    """q, k, v as the Tao block makes them: (B, H, S, D) views of one
    packed (B, S, 3, H, D) projection."""
    x = np.random.default_rng(seed).standard_normal((B, S, 3, H, D)).astype(np.float32)
    return x, torch.from_numpy(x).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("causal", [True, False])
def test_packed_qkv_views_match_contiguous_call_and_reference(causal):
    """``flash_attention`` takes the packed views at their strides (no copy
    on either device); on the CPU that equals the call on contiguous copies
    within 1e-6 and the reference oracle within the tolerance above."""
    x, (q, k, v) = packed(5, 3, 129, 4, 32)
    assert not q.is_contiguous() and q.stride() == (129 * 3 * 4 * 32, 32, 3 * 4 * 32, 1)
    got = flash_attention(q, k, v, causal=causal)
    contiguous = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    np.testing.assert_allclose(got.numpy(), contiguous.numpy(), atol=1e-6, rtol=1e-6)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(x[:, :, i].transpose(0, 2, 1, 3)))
                  for i in range(3))
    close(got, attention_ref(jq, jk, jv, None, causal=causal), "packed views vs attention_ref")


# (B, H, S, D, causal); the tile_ cases sit on the edges of the CUDA
# backward's 16-row tiles and 64-row streamed tiles
BWD_CASES = {
    "tao": (2, 4, 129, 32, True),
    "tao_noncausal": (2, 4, 129, 32, False),
    "short_narrow": (3, 2, 17, 16, True),
    "odd_width": (2, 2, 40, 20, False),
    "tile_s16": (2, 2, 16, 8, True),
    "tile_s16_noncausal": (2, 2, 16, 8, False),
    "tile_s145": (2, 2, 145, 20, True),
    "tile_s145_noncausal": (2, 2, 145, 20, False),
}


def bwd_inputs(case):
    B, H, S, D, causal = BWD_CASES[case]
    rng = np.random.default_rng(20 + sorted(BWD_CASES).index(case))
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    return q, k, v, do, causal


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_plain_matches_autograd_and_reference_vjp(case):
    q, k, v, do, causal = bwd_inputs(case)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention_plain(*leaves, causal=causal)
    out.backward(torch.from_numpy(do))
    tq, tk, tv = (x.detach() for x in leaves)
    lse = attention_lse_plain(tq, tk, causal=causal)
    got = attention_bwd_plain(tq, tk, tv, out.detach(), lse, torch.from_numpy(do), causal)
    _, vjp = jax.vjp(lambda a, b, c: ref_model_attention(a, b, c, causal, False),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, leaf, ref in zip("qkv", got, leaves, vjp(jnp.asarray(do))):
        close(g, leaf.grad, f"{case} d{name} vs autograd")
        close(g, ref, f"{case} d{name} vs jax.vjp of the reference attention")


@pytest.mark.parametrize("causal", [True, False])
def test_lse_plain_normalizes_rows_and_marks_rows_without_keys(causal):
    """2^(s log2(e) - lse) sums to 1 over each row's visible keys; a row
    that sees no key (segment -2 past Sk) has lse = +inf."""
    q, k, v, seg = make(9, 2, 2, 12, 20, 8, 8, True)
    tq, tk, tseg = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(seg)
    lse = attention_lse_plain(tq, tk, tseg, causal=causal, q_offset=15)
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk) / np.sqrt(8)
    p = torch.exp2(s * 1.4426950408889634 - lse[..., None])
    out = attention_plain(tq, tk, torch.from_numpy(v), tseg, causal=causal, q_offset=15)
    qpos = 15 + np.arange(12)
    past = qpos >= 20
    assert torch.all(torch.isposinf(lse[:, :, torch.from_numpy(past)]))
    segq = np.where(past, -2, seg[:, np.minimum(qpos, 19)])
    visible = segq[:, :, None] == seg[:, None, :]
    if causal:
        visible &= np.arange(20)[None, None, :] <= qpos[None, :, None]
    p = torch.where(torch.from_numpy(visible)[:, None], p, torch.zeros(()))
    # the visible keys' probabilities reproduce the output of the rows that see keys
    pv = torch.einsum("bhqk,bhkd->bhqd", p, torch.from_numpy(v))
    live = torch.from_numpy(~past)
    close(pv[:, :, live], out[:, :, live], "2^(s - lse) v vs attention_plain")


def test_flash_attention_fn_wiring_with_plain_kernels(monkeypatch):
    """``FlashAttentionFn`` saves the forward's lse and returns (dq, dk, dv)
    in order: with the kernel calls swapped for their plain versions it
    gives autograd's gradients through ``attention_plain`` bitwise."""
    q, k, v, do, causal = bwd_inputs("tao")

    def fwd(q, k, v, *, causal, return_lse):
        assert return_lse
        return attention_plain(q, k, v, causal=causal), attention_lse_plain(q, k, causal=causal)

    def bwd(q, k, v, out, lse, dout, *, causal):
        return attention_bwd_plain(q, k, v, out, lse, dout, causal)

    monkeypatch.setattr(port_ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(port_ops, "flash_attention_bwd_cuda", bwd)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = port_ops.FlashAttentionFn.apply(*leaves, causal)
    out.backward(torch.from_numpy(do))
    plain = [x.detach() for x in leaves]
    ref = attention_bwd_plain(*plain, attention_plain(*plain, causal=causal),
                              attention_lse_plain(plain[0], plain[1], causal=causal),
                              torch.from_numpy(do), causal)
    for leaf, g in zip(leaves, ref):
        assert torch.equal(leaf.grad, g)


def test_cpu_autograd_stays_on_the_plain_version():
    """On CPU tensors ``flash_attention`` under autograd is the plain
    version (no launch of either kernel), differentiated by autograd."""
    q, k, v, do, causal = bwd_inputs("short_narrow")
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    counts = (port_kernel.FLASH_ATTENTION.launches, port_kernel.FLASH_ATTENTION_BWD.launches)
    flash_attention(*leaves, causal=causal).backward(torch.from_numpy(do))
    assert (port_kernel.FLASH_ATTENTION.launches, port_kernel.FLASH_ATTENTION_BWD.launches) == counts
    plain = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    attention_plain(*plain, causal=causal).backward(torch.from_numpy(do))
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)


def test_bwd_cuda_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.flash_attention_bwd_cuda(q, q, q, q, torch.zeros(1, 1, 4), q)


@pytest.mark.parametrize("D", [64, 128])
def test_p_split_into_two_bfloat16_terms_stays_within_the_stated_bound(D):
    """The bfloat16 kernel's P V (``csrc/attention.cu``): P, float32 in [0,
    1] as the online softmax makes it, split into P_hi = bf16(P) and P_lo =
    bf16(P - P_hi), each times bfloat16 V in float32, stays within 2^-15
    sum_k |P||V| of float32 P V in every row, the bound the kernel's header
    states (P - P_hi - P_lo is at most 2^-16 |P|).  P_hi alone does not."""
    rng = np.random.default_rng(40 + D)
    rows, keys = 64, 2048
    s = 3.0 * rng.standard_normal((rows, keys)).astype(np.float32)
    p = torch.from_numpy(np.exp2(s - s.max(-1, keepdims=True)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((keys, D)).astype(np.float32)).to(torch.bfloat16).float()
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert torch.equal(p - hi, (p.double() - hi.double()).float())  # the residual is exact
    want = p @ v
    bound = 2.0**-15 * (p.abs() @ v.abs())
    assert bool(((lo @ v + hi @ v) - want).abs().le(bound).all())
    assert not bool(((hi @ v) - want).abs().le(bound).all())


@pytest.mark.parametrize("D", [64, 128])
def test_p_split_keeps_the_bfloat16_output_where_one_bfloat16_term_moves_it(D):
    """Why the card's checks ask the bfloat16 kernel for >= 99% of its
    output bitwise the plain version's: O = P V / l rounded to bfloat16,
    with P split into two bfloat16 terms, equals the float32 product's
    rounding in >= 99% of elements; with P rounded to one bfloat16 term
    (a kernel that drops P_lo) it does in < 90%."""
    rng = np.random.default_rng(50 + D)
    rows, keys = 256, 2048
    s = rng.standard_normal((rows, keys)).astype(np.float32)  # base-2 scores
    p = torch.from_numpy(np.exp2(s - s.max(-1, keepdims=True)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((keys, D)).astype(np.float32)).to(torch.bfloat16).float()
    l = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    want = (p @ v / l).to(torch.bfloat16)
    split = ((lo @ v + hi @ v) / l).to(torch.bfloat16)
    one = (hi @ v / l).to(torch.bfloat16)
    assert float((split == want).float().mean()) >= 0.99
    assert float((one == want).float().mean()) < 0.9


def bwd_two_term_emulation(q, k, v, o, lse, do, causal, terms=2):
    """What the bfloat16 backward kernel (``csrc/attention_bwd.cu``,
    ``bwd_dkdv_dq_wgmma``) computes, in torch on the CPU: S = q kᵀ and dP =
    dO vᵀ as products of bfloat16 values summed in float32; P = 2^(S scale
    log2(e) - lse) and dS = P (dP - delta) in float32, each split into
    bf16(x) + bf16(x - bf16(x)) (``terms=1``: the first term alone); dV,
    dK, dQ as the products of those bfloat16 terms with the bfloat16
    operands summed in float32, the lo term's then the hi term's; each
    gradient rounded once to bfloat16."""
    import math

    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    S = q.shape[2]
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask = torch.tril(mask)
    p = torch.where(mask, torch.exp2(s * (scale * 1.4426950408889634) - lse[..., None]),
                    torch.zeros(()))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)

    def split(x):
        hi = x.to(torch.bfloat16).float()
        return [hi] if terms == 1 else [(x - hi).to(torch.bfloat16).float(), hi]

    dv = sum(torch.einsum("bhqk,bhqd->bhkd", t, dof) for t in split(p))
    dk = sum(torch.einsum("bhqk,bhqd->bhkd", t, qf) for t in split(ds)) * scale
    dq = sum(torch.einsum("bhqk,bhkd->bhqd", t, kf) for t in split(ds)) * scale
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _bf16_bwd_cases():
    from attention_bwd_bf16_cases import ATTN_BWD_BF16_CASES

    return {name: c for name, c in ATTN_BWD_BF16_CASES.items() if c[2] <= 300}


@pytest.mark.parametrize("case", sorted(_bf16_bwd_cases()))
def test_bf16_bwd_two_term_split_meets_the_card_contract(case):
    """The bfloat16 backward's arithmetic (P and dS as two bfloat16 terms,
    bfloat16 products summed in float32, one rounding) against the plain
    formulas at the shapes of the card's bfloat16 backward cases (S <= 300),
    held to the card test's band: every element within 2^-7 |plain| +
    1e-4 max |plain|, and >= 99% of elements bitwise the plain version's.
    P and dS rounded to one bfloat16 term (what a kernel that drops the lo
    term computes) keep < 90% bitwise.  What the emulation leaves out is
    the kernel's summation order and ex2.approx; the card tests hold the
    kernel itself."""
    B, H, S, D, causal, rep, seed = _bf16_bwd_cases()[case]
    rng = np.random.default_rng(100 + seed)
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(np.float32)).to(bf)
    k, v = (torch.from_numpy(rng.standard_normal((B, H // rep, S, D)).astype(np.float32)).to(bf)
            .repeat_interleave(rep, dim=1) for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(np.float32)).to(bf)
    o = attention_plain(q, k, v, causal=causal)
    lse = attention_lse_plain(q, k, causal=causal)
    got = bwd_two_term_emulation(q, k, v, o, lse, do, causal)
    ref = attention_bwd_plain(q, k, v, o, lse, do, causal)
    for name, a, c in zip(("dq", "dk", "dv"), got, ref):
        a32, c32 = a.float(), c.float()
        limit = 2.0**-7 * c32.abs() + 1e-4 * float(c32.abs().max())
        assert bool(torch.all((a32 - c32).abs() <= limit)), (name, float((a32 - c32).abs().max()))
        assert float((a == c).float().mean()) >= 0.99, (name, float((a == c).float().mean()))
    one = bwd_two_term_emulation(q, k, v, o, lse, do, causal, terms=1)
    assert all(float((a == c).float().mean()) < 0.9 for a, c in zip(one, ref))
