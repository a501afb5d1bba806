"""The port's int8 W8A8 path against the reference's ``core/quant.py``.

The reference initializes the weights (converted with ``params_from_jax``)
and the same NumPy-seeded inputs go through both sides on the CPU.

What is exact.  The quantized tree (every ``w_q``, ``table_q`` and
``scale``) is bitwise the reference engine's EAGER ``quantize_tao_params``
(a true division by 127).  ``qdense``'s codes, int32 accumulations and
float output are bitwise the JITTED reference ``qdense``, where XLA
multiplies the activation amax by ``float32(1/127)`` and dequantizes with
one fused multiply-add; ``qembed`` is bitwise too.

What is banded.  ``tao_forward_int8``: at the small config (d_model 32,
one layer) within 1e-5 (observed 7e-7).  At the default width the float32
parts around the quantized products (layernorm, tanh-GELU, softmax,
attention) differ by ulps between XLA and torch; once an activation lands
on the other side of a rounding boundary its int8 code flips, and causal
attention carries the difference to every later position of the window.
So there: max |Δlogit| ≤ 5% of max |logit| (observed 1.4%), the 99th
percentile of |Δlogit| ≤ half the reference's own p99 |int8 − fp32|
(observed 0.29×), and at most 1% of the decodes flip (observed ≤ 0.39%).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model as ref_model  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402

from repro_torch.convert import params_from_jax, qparams_from_jax  # noqa: E402
from repro_torch.core import model as port_model  # noqa: E402
from repro_torch.core import quant as port_quant  # noqa: E402

from repro_torch.configs import tao as port_tao  # noqa: E402

from test_torch_model import CONFIGS, DEFAULT, SMALL, configs, random_batch  # noqa: E402

LOGIT_KEYS = ("fetch_lat_logits", "exec_lat_logits", "mispred_logit", "dlevel_logits",
              "icache_logit", "tlb_logit")
SMALL_ATOL = 1e-5
MAX_REL = 0.05        # max |Δlogit| / max |logit| at default width
P99_OF_QUANT = 0.5    # p99 |Δlogit| / the reference's p99 |int8 - fp32|
FLIP_SHARE = 0.01     # decodes that may flip at default width

# every dense layer shape (in, out) of the default TaoConfig and of the
# paper's (configs/tao.py: K and N up to 2048, heads 1 and 4 wide)
LAYER_SHAPES = sorted({shape for cfg in (port_model.TaoConfig(), port_tao.CONFIG)
                       for shape in port_quant.dense_shapes(port_quant.quantize_tao_params(
                           port_model.init_tao(cfg, device="cpu")))})


def bits(a):
    return np.asarray(a).view(np.int32)


def reference_and_port(spec, seed=0, zero=False):
    """The reference's params and the port's ``Tao`` on them; ``zero``: one
    all-zero channel in a dense layer and one all-zero embedding row."""
    ref_cfg, port_cfg = configs(spec)
    params = jax.jit(ref_model.init_tao, static_argnums=1)(jax.random.PRNGKey(seed), ref_cfg)
    np_tree = jax.tree.map(np.array, params)
    if zero:
        np_tree["embed"]["opcode"]["table"][3] = 0.0
        np_tree["embed"]["flags"]["w"][:, 1] = 0.0
        np_tree["pred"]["blocks"][0]["qkv"]["w"][:, 7] = 0.0
        np_tree["pred"]["head_branch"]["w"][:] = 0.0
        params = jax.tree.map(jnp.asarray, np_tree)
    model = port_model.init_tao(port_cfg, device="cpu")
    model.load_state_dict(params_from_jax(np_tree))
    return ref_cfg, port_cfg, params, model


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("name", ["small", "default_width", "paper"])
def test_quantize_tao_params_bitwise_reference(name, zero):
    """Every leaf of the port's quantized tree is the reference's eager
    ``quantize_tao_params`` bit for bit, all-zero channels and rows (unit
    scale, zero codes) included; ``qparams_from_jax`` of the reference's
    tree loads strictly into a ``QuantTao`` and gives the same state, the
    padded IMMA copies included."""
    ref_cfg, port_cfg, params, model = reference_and_port(CONFIGS[name][0], zero=zero)
    ref_tree = jax.tree.map(np.asarray, ref_quant.quantize_tao_params(params))
    q = port_quant.quantize_tao_params(model)
    got = q.state_dict()
    want = qparams_from_jax(ref_tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k].numpy().view(np.uint8), v.numpy().view(np.uint8)), k
    assert got["embed.regbits.w_q"].dtype == torch.int8
    assert tuple(got["embed.flags.w_q"].shape) == (5, port_cfg.d_cat)  # (in, out), untransposed
    if zero:  # a unit amax: scale 1/127
        unit = np.float32(1) / np.float32(127)
        assert torch.all(q.embed.opcode.table_q[3] == 0) and q.embed.opcode.scale[3] == unit
        assert torch.all(q.embed.flags.w_q[:, 1] == 0) and q.embed.flags.scale[1] == unit
        assert torch.all(q.pred.head_branch.w_q == 0) and q.pred.head_branch.scale[0] == unit
    loaded = port_quant.quantize_tao_params(port_model.init_tao(port_cfg, torch.Generator().manual_seed(5),
                                                                device="cpu"))
    loaded.load_state_dict(want)  # strict
    for (k, a), (k2, b) in zip(loaded.named_buffers(), q.named_buffers()):
        assert k == k2 and torch.equal(a, b), k
    for (k, a), (k2, b) in zip(loaded.named_parameters(), q.named_parameters()):
        assert k == k2 and torch.equal(a, b), k


def test_qdense_handles_zero_channels():
    """The port of the reference's zero-channel test: an all-zero weight
    quantizes to zero codes with the unit amax's scale 1/127, and an
    all-zero input row gives the bias."""
    layer = torch.nn.Linear(8, 4)
    with torch.no_grad():
        layer.weight.zero_()
        layer.bias.copy_(torch.arange(4.0))
    q = port_quant.quantize_dense(layer)
    assert torch.all(q.w_q == 0) and torch.all(q.scale == np.float32(1) / np.float32(127))
    y = port_quant.qdense(q, torch.ones(2, 8))
    assert torch.equal(y, torch.arange(4.0).expand(2, 4))
    layer.weight.data.normal_(generator=torch.Generator().manual_seed(0))
    y = port_quant.qdense(port_quant.quantize_dense(layer), torch.zeros(3, 8))
    assert torch.equal(y, torch.arange(4.0).expand(3, 4))


def _reference_codes_and_acc(x, w_q):
    """The reference ``qdense``'s codes and int32 sums, jitted as its own
    expressions are (``_safe_scale`` inside ``jax.jit``)."""
    def inner(x, w_q):
        sx = ref_quant._safe_scale(jnp.max(jnp.abs(x), axis=-1, keepdims=True))
        xq = jnp.clip(jnp.round(x / sx), -127, 127).astype(jnp.int8)
        acc = jax.lax.dot_general(xq, w_q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
        return xq, acc
    return jax.jit(inner)(x, w_q)


@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=[f"{k}x{n}" for k, n in LAYER_SHAPES])
def test_qdense_bitwise_jitted_reference(shape):
    """Codes, int32 accumulations and the float output of ``qdense`` are
    the jitted reference's bit for bit.  The rows' scales vary, so that
    for some of them (at least 10 of 777) ``amax * float32(1/127)`` and
    ``amax / 127`` differ, which moves their output: the test tells the
    two scales apart."""
    k, n = shape
    rng = np.random.default_rng(k * 1000 + n)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = (rng.standard_normal((777, k)) * rng.uniform(0.1, 30.0, (777, 1))).astype(np.float32)
    x[5] = 0.0  # an all-zero row: unit scale
    amax = np.abs(x).max(-1)
    assert np.sum(amax * np.float32(1 / 127) != amax / np.float32(127)) >= 10

    ref_p = ref_quant.quantize_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    ref_y = jax.jit(ref_quant.qdense)(ref_p, jnp.asarray(x))
    ref_xq, ref_acc = _reference_codes_and_acc(jnp.asarray(x), ref_p["w_q"])

    layer = torch.nn.Linear(k, n)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        layer.bias.copy_(torch.from_numpy(b))
    q = port_quant.quantize_dense(layer)
    assert np.array_equal(q.w_q.numpy(), np.asarray(ref_p["w_q"]))
    xt = torch.from_numpy(x)
    xq, _, _ = port_quant.quantize_rows(xt)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_xq))
    np.testing.assert_array_equal(port_quant.qdense_acc(q, xq).numpy(), np.asarray(ref_acc))
    np.testing.assert_array_equal(port_quant.int8_matmul(xq, q.w_q).numpy(), np.asarray(ref_acc))
    y = port_quant.qdense(q, xt)
    assert y.shape == (777, n) and y.dtype == torch.float32
    np.testing.assert_array_equal(bits(y.numpy()), bits(ref_y))


def test_qembed_bitwise_reference():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    table[7] = 0.0
    ids = rng.integers(0, 40, (5, 33)).astype(np.int32)
    ref_p = ref_quant.quantize_embed({"table": jnp.asarray(table)})
    ref = jax.jit(ref_quant.qembed)(ref_p, jnp.asarray(ids))
    emb = torch.nn.Embedding(40, 16)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(table))
    q = port_quant.quantize_embed(emb)
    np.testing.assert_array_equal(q.table_q.numpy(), np.asarray(ref_p["table_q"]))
    np.testing.assert_array_equal(bits(q.scale.numpy()), bits(ref_p["scale"]))
    np.testing.assert_array_equal(bits(port_quant.qembed(q, torch.from_numpy(ids)).numpy()), bits(ref))


def forwards(spec, b, seed):
    ref_cfg, port_cfg, params, model = reference_and_port(spec)
    batch = random_batch(port_cfg, b, seed=seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref8 = jax.jit(ref_quant.tao_forward_int8, static_argnums=2)(
        ref_quant.quantize_tao_params(params), jbatch, ref_cfg)
    ref32 = jax.jit(ref_model.tao_forward, static_argnums=2)(params, jbatch, ref_cfg)
    with torch.inference_mode():
        got = port_quant.tao_forward_int8(port_quant.quantize_tao_params(model),
                                          {k: torch.from_numpy(v) for k, v in batch.items()}, port_cfg)
    return got, {k: np.asarray(v) for k, v in ref8.items()}, {k: np.asarray(v) for k, v in ref32.items()}


def test_tao_forward_int8_small_config_matches_reference():
    got, ref, _ = forwards(SMALL, 4, seed=1)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=SMALL_ATOL, err_msg=k)


def test_tao_forward_int8_default_width_within_band():
    """Four windows of 129 at the default widths (see the module note)."""
    got, ref, ref32 = forwards(DEFAULT, 4, seed=1)
    assert set(got) == set(ref)
    delta = np.concatenate([np.abs(got[k].numpy() - ref[k]).ravel() for k in LOGIT_KEYS])
    quant_err = np.concatenate([np.abs(ref32[k] - ref[k]).ravel() for k in LOGIT_KEYS])
    mag = np.concatenate([np.abs(ref[k]).ravel() for k in LOGIT_KEYS])
    assert delta.max() <= MAX_REL * mag.max(), (delta.max(), mag.max())
    assert np.quantile(delta, 0.99) <= P99_OF_QUANT * np.quantile(quant_err, 0.99)
    decodes = {
        "fetch_lat": (got["fetch_lat"].numpy(), ref["fetch_lat"]),
        "exec_lat": (got["exec_lat"].numpy(), ref["exec_lat"]),
        "dlevel": (got["dlevel_logits"].numpy().argmax(-1), ref["dlevel_logits"].argmax(-1)),
        "mispredict": (got["mispred_logit"].numpy() > 0, ref["mispred_logit"] > 0),
    }
    for name, (a, b) in decodes.items():
        assert np.mean(a != b) <= FLIP_SHARE, name
