"""The port's SSD scan against the reference's, on the CPU.

The same NumPy-seeded inputs go through the reference's oracles
(``ssd_sequential_ref``, ``ssd_chunked_ref``) and its Pallas kernel
(``ssd_scan``, interpret mode off the TPU), and through the port's plain
versions and its ``ssd_scan`` (which takes the plain chunked version for
CPU tensors; the CUDA kernel is held to it on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances: atol = rtol = 1e-4 in float32 (both sides float32; they
differ in summation order and in how the chunk's prefix sum is taken), as
the reference's own kernel tests use; bfloat16 inputs at 5e-2, as the
reference holds its kernel to the sequential oracle.

The backward's plain version (``ssd_chunked_bwd_plain``, the function
``csrc/ssd_bwd.cu`` is held to on the card) against torch autograd through
``ssd_chunked_ref`` within 1e-5 of each output's largest |·| (the same
float32 arithmetic in another order; measured ≤ 2.2e-6, dA's sum over
batch and sequence the widest), and against ``jax.grad`` of the
reference's ``ssd_chunked_ref`` within 1e-4 of it, the reference's own
float32 tolerance; on bfloat16 inputs each element within 2^-7 of its
float32 value plus 1e-4 of the largest (one rounding of the output).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd_scan as ref_ssd_scan  # noqa: E402
from repro.kernels.ssd.ref import ssd_sequential_ref as ref_sequential  # noqa: E402
from repro.models.mamba2 import ssd_chunked_ref as ref_chunked  # noqa: E402

from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels.ssd import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_plain, ssd_chunked_ref, ssd_sequential_ref  # noqa: E402

ATOL = RTOL = 1e-4
BF16_TOL = 5e-2

# (B, S, H, P, G, N, chunk): the reference's three kernel cases
# (tests/test_kernels.py), a two-group case, and S off the chunk grid
CASES = {
    "ref_a": (2, 128, 4, 16, 1, 8, 32),
    "ref_b": (1, 64, 2, 8, 2, 16, 16),
    "ref_c": (1, 256, 8, 32, 1, 16, 64),
    "two_groups": (2, 96, 8, 16, 2, 16, 32),
    "ragged_seq": (2, 70, 4, 16, 1, 16, 32),
}


def make_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    softplus = lambda v: np.log1p(np.exp(v))  # noqa: E731
    return dict(
        xh=rng.standard_normal((B, S, H, P)).astype(np.float32),
        dt=(softplus(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32),
        A=(-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32),
        Bm=(rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32),
        Cm=(rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32),
    )


def padded(inp, chunk):
    """Zero rows up to a chunk multiple, as the model pads (dt = 0 rows
    are exact no-ops)."""
    S = inp["xh"].shape[1]
    pad = (-S) % chunk
    return {k: v if k == "A" else np.concatenate(
        [v, np.zeros((v.shape[0], pad) + v.shape[2:], v.dtype)], axis=1) for k, v in inp.items()}


# Each side gets its own copy of the inputs, and the port runs first: no
# buffer is shared between the two runtimes while either computes.
def as_jax(inp):
    return [jnp.array(inp[k], copy=True) for k in ("xh", "dt", "A", "Bm", "Cm")]


def as_torch(inp):
    return [torch.tensor(inp[k]) for k in ("xh", "dt", "A", "Bm", "Cm")]


def close(a, b, tol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_matches_reference_oracles_and_pallas(case):
    B, S, H, P, G, N, c = CASES[case]
    inp = make_inputs(B, S, H, P, G, N, sorted(CASES).index(case))
    pin = padded(inp, c)
    port = ssd_scan(*as_torch(pin), chunk=c)[:, :S].numpy()
    port_chunked = ssd_chunked_ref(*as_torch(pin), c)[:, :S].numpy()
    port_seq = ssd_sequential_ref(*as_torch(inp)).numpy()
    np.testing.assert_array_equal(port, port_chunked)  # ssd_scan on CPU is the plain version
    seq = np.asarray(ref_sequential(*as_jax(inp)))
    chk = np.asarray(ref_chunked(*as_jax(pin), chunk=c))[:, :S]
    ker = np.asarray(ref_ssd_scan(*as_jax(pin), chunk=c))[:, :S]
    for ref in (seq, chk, ker):
        close(port, ref)
    close(port_seq, seq)


@pytest.mark.parametrize("case", ["ref_a", "two_groups", "ragged_seq"])
def test_ssd_final_state_matches_reference_and_recurrence(case):
    B, S, H, P, G, N, c = CASES[case]
    inp = make_inputs(B, S, H, P, G, N, 10 + sorted(CASES).index(case))
    pin = padded(inp, c)
    y, state = ssd_scan(*as_torch(pin), chunk=c, return_state=True)
    _, ref_state = ref_chunked(*as_jax(pin), chunk=c, return_state=True)
    assert state.dtype == torch.float32 and state.shape == (B, H, N, P)
    close(state.numpy(), np.asarray(ref_state))
    # the literal recurrence over the unpadded sequence (the padding's
    # dt = 0 rows leave the state as it was)
    Bh = np.repeat(inp["Bm"], H // G, axis=2)
    st = np.zeros((B, H, N, P), np.float64)
    for t in range(S):
        decay = np.exp(inp["dt"][:, t] * inp["A"][None, :])
        st = st * decay[..., None, None] + np.einsum(
            "bh,bhn,bhp->bhnp", inp["dt"][:, t], Bh[:, t], inp["xh"][:, t])
    close(state.numpy(), st)
    close(y[:, :S].numpy(), np.asarray(ref_sequential(*as_jax(inp))))


def test_ssd_bf16_matches_reference_sequential():
    B, S, H, P, G, N, c = 1, 64, 2, 8, 1, 8, 32
    inp = make_inputs(B, S, H, P, G, N, 5)
    jx = as_jax(inp)
    jx = [v if i == 2 else v.astype(jnp.bfloat16) for i, v in enumerate(jx)]  # A stays f32
    tx = as_torch(inp)
    tx = [v if i == 2 else v.to(torch.bfloat16) for i, v in enumerate(tx)]
    port = ssd_scan(*tx, chunk=c)
    port_seq = ssd_sequential_ref(*tx)
    assert port.dtype == port_seq.dtype == torch.bfloat16
    seq = np.asarray(ref_sequential(*jx), np.float32)
    close(port.float().numpy(), seq, BF16_TOL)
    close(port_seq.float().numpy(), seq, BF16_TOL)


def test_ssd_scan_refuses_bad_shapes_and_grad():
    """Shapes the scan does not take raise; a CPU call under autograd is
    ``ssd_chunked_ref``'s, gradients and all, and refuses ``return_state``."""
    inp = as_torch(make_inputs(1, 64, 4, 8, 2, 8, 0))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(*inp, chunk=48)
    xh, dt, A, Bm, Cm = inp
    with pytest.raises(ValueError, match="groups"):
        ssd_scan(xh[:, :, :3].contiguous(), dt[:, :, :3].contiguous(), A[:3], Bm, Cm, chunk=32)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(xh.shape).astype(np.float32))
    grads = []
    for fn in (lambda *a: ssd_scan(*a, chunk=32), lambda *a: ssd_chunked_ref(*a, 32)):
        leaves = [t.clone().requires_grad_() for t in inp]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, dy))
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="return_state"):
        ssd_scan(*leaves, chunk=32, return_state=True)


# (B, S, H, P, G, N, chunk) of the backward's cases: several chunks, two
# groups, one chunk, and the reference's widest kernel case
BWD_CASES = {
    "several_chunks": (2, 128, 4, 16, 1, 8, 32),
    "two_groups": (2, 96, 8, 16, 2, 16, 32),
    "one_chunk": (1, 64, 4, 8, 2, 16, 64),
    "ref_c": (1, 256, 8, 32, 1, 16, 64),
}
BWD_AUTOGRAD_OF_MAX = 1e-5
BWD_REF_OF_MAX = 1e-4
BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def bwd_inputs(case, seed):
    B, S, H, P, G, N, c = BWD_CASES[case]
    inp = make_inputs(B, S, H, P, G, N, seed)
    dy = np.random.default_rng(seed + 100).standard_normal((B, S, H, P)).astype(np.float32)
    return inp, dy, c


def assert_within_of_max(got, want, rel, names=BWD_NAMES):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= rel * top, (name, err, top)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_ssd_bwd_plain_matches_autograd_through_chunked_ref(case):
    inp, dy, c = bwd_inputs(case, sorted(BWD_CASES).index(case))
    leaves = [t.requires_grad_() for t in as_torch(inp)]
    want = torch.autograd.grad(ssd_chunked_ref(*leaves, c), leaves, torch.from_numpy(dy))
    got = ssd_chunked_bwd_plain(*as_torch(inp), torch.from_numpy(dy), c)
    for g, t in zip(got, as_torch(inp)):
        assert g.dtype == t.dtype and g.shape == t.shape
    assert_within_of_max([g.numpy() for g in got], [w.numpy() for w in want], BWD_AUTOGRAD_OF_MAX)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_ssd_bwd_plain_matches_jax_grad_of_reference(case):
    inp, dy, c = bwd_inputs(case, 10 + sorted(BWD_CASES).index(case))
    got = ssd_chunked_bwd_plain(*as_torch(inp), torch.from_numpy(dy), c)
    grad = jax.jit(lambda a, g: jax.vjp(lambda *t: ref_chunked(*t, chunk=c), *a)[1](g))
    want = grad(as_jax(inp), jnp.array(dy, copy=True))
    assert_within_of_max([g.numpy() for g in got], [np.asarray(w) for w in want], BWD_REF_OF_MAX)


def test_ssd_bwd_plain_bf16_within_one_rounding_of_float32():
    inp, dy, c = bwd_inputs("two_groups", 20)
    bf = [v if i == 2 else v.to(torch.bfloat16) for i, v in enumerate(as_torch(inp))]
    dy_bf = torch.from_numpy(dy).to(torch.bfloat16)
    got = ssd_chunked_bwd_plain(*bf, dy_bf, c)
    want = ssd_chunked_bwd_plain(*(v.float() for v in bf), dy_bf.float(), c)
    for name, a, b in zip(BWD_NAMES, got, want):
        assert a.dtype == (torch.float32 if name == "dA" else torch.bfloat16), name
        err = (a.float() - b).abs()
        assert torch.all(err <= 2.0**-7 * b.abs() + 1e-4 * b.abs().max()), (name, float(err.max()))


def test_kernel_limits_match_the_source():
    """The wrapper's limits are the forward's (csrc/ssd.cu) and the
    backward's (csrc/ssd_bwd.cu)."""
    for source in ("ssd.cu", "ssd_bwd.cu"):
        src = (_cuda.CSRC / source).read_text()
        for const, value in (("kMaxN", port_kernel.MAX_STATE), ("kMaxP", port_kernel.MAX_HEAD_DIM),
                             ("kMaxChunk", port_kernel.MAX_CHUNK)):
            assert int(re.search(rf"constexpr int {const} = (\d+);", src)[1]) == value, (source, const)


def test_backward_scratch_matches_the_source():
    """The wrapper sizes the backward's scratch as csrc/ssd_bwd.cu reads it:
    the vecs rows a chunk and the heads a bfloat16 chunk block sums dB and
    dC over."""
    src = (_cuda.CSRC / "ssd_bwd.cu").read_text()
    rowk = int(re.search(r"kVRowk = (\d+);", src)[1])
    per_tile = int(re.search(r"constexpr int kRowkParts = kMaxTiles \* (\d+);", src)[1])
    assert port_kernel.BWD_VEC_ROWS == rowk + per_tile * port_kernel.MAX_CHUNK // 64
    assert int(re.search(r"constexpr int kHeadsPerBlock = (\d+);", src)[1]) == \
        port_kernel.BWD_HEADS_PER_BLOCK
    hpb = port_kernel.bwd_heads_per_block
    assert [hpb(64, 1, torch.bfloat16), hpb(64, 2, torch.bfloat16), hpb(12, 2, torch.bfloat16),
            hpb(3, 1, torch.bfloat16), hpb(64, 1, torch.float32)] == [4, 4, 2, 1, 1]


def _split_tf32(x: torch.Tensor):
    """The SSD kernel's split() on float32 bits (csrc/ssd.cu, from
    csrc/attention.cu): hi rounded to TF32 to nearest, ties away (add half a
    TF32 ulp to the bits and mask), lo the remainder x - hi cut to TF32."""
    mask = -8192  # 0xffffe000 as int32: sign, exponent and 10 mantissa bits
    hi = ((x.view(torch.int32) + 0x1000) & mask).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & mask).view(torch.float32)
    return hi, lo


def test_split_tf32_keeps_bfloat16_exact_and_float32_within_2_pow_minus_20():
    # every finite bfloat16 value: TF32 rounding leaves it as it is, so the
    # bfloat16 kernel's operands read from memory need no remainder
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    bf = bits.view(torch.bfloat16)
    bf = bf[torch.isfinite(bf)]
    assert bf.numel() == 65536 - 2 * 128  # all but the top exponent's NaNs and infs
    x = bf.float()
    hi, lo = _split_tf32(x)
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32))
    assert torch.equal(lo, torch.zeros_like(lo))
    # float32 values over 40 binades, plus every rounding edge of the low 13
    # bits (ties, one below, one above): hi + lo within 2^-20 |x| (the
    # analysis gives 2^-21)
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 100_000) * np.exp2(rng.integers(-20, 20, 100_000))
    v = (mant * rng.choice([-1.0, 1.0], 100_000)).astype(np.float32)
    edges = (np.float32(1.5).view(np.int32) & ~0x1fff) + np.array([0xfff, 0x1000, 0x1001, 0x1fff])
    v = np.concatenate([v, edges.astype(np.int32).view(np.float32), -edges.astype(np.int32).view(np.float32)])
    x = torch.from_numpy(v)
    hi, lo = _split_tf32(x)
    for part in (hi, lo):  # both are TF32 values: the low 13 bits are zero
        assert not torch.any(part.view(torch.int32) & 0x1fff)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert torch.all(err <= 2.0 ** -20 * x.double().abs())
    assert float((err / x.double().abs()).max()) > 0  # the cut does lose bits
