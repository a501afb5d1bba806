"""The port's Tao model against the reference's, on the reference's weights.

``jax.random`` cannot be reproduced in torch, so the reference initializes
the parameters, they cross as NumPy arrays (``repro_torch.convert``), and
the same NumPy-seeded batch goes through both forwards.

Tolerance on logits: atol = rtol = 1e-4.  Both sides are float32 end to end
(TF32 off); they differ in matmul/reduction order (XLA vs torch CPU BLAS),
through layernorm, tanh-GELU and softmax, over up to two attention blocks.
The decoded latencies are compared exactly where the top two logits are
apart by more than that band (a nearer tie may decode either way).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import model as port_model  # noqa: E402
from repro_torch.core.features import FeatureConfig  # noqa: E402

ATOL = RTOL = 1e-4

SMALL = dict(window=17, d_model=32, n_heads=2, n_layers=1, d_ff=64, d_cat=16,
             features=(64, 4, 8))
DEFAULT = dict(features=(1024, 32, 64))  # the default TaoConfig's widths
CONFIGS = {"small": (SMALL, 4), "default_width": (DEFAULT, 2)}


def configs(spec):
    kw = dict(spec)
    nb, nq, nm = kw.pop("features")
    ref = ref_model.TaoConfig(features=ref_features.FeatureConfig(nb, nq, nm), **kw)
    port = port_model.TaoConfig(features=FeatureConfig(nb, nq, nm), **kw)
    return ref, port


def random_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    w, f = cfg.window, cfg.features
    return {
        "opcode": rng.integers(0, ref_features.NUM_OPCODES, (b, w)).astype(np.int32),
        "regbits": (rng.random((b, w, 32)) < 0.1).astype(np.float32),
        "flags": (rng.random((b, w, 5)) < 0.3).astype(np.float32),
        "brhist": rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (b, w, f.n_queue)),
        "memdist": rng.uniform(-1.0, 1.0, (b, w, f.n_mem)).astype(np.float32),
    }


def port_from_reference(ref_cfg, port_cfg, seed=0):
    params = jax.jit(ref_model.init_tao, static_argnums=1)(jax.random.PRNGKey(seed), ref_cfg)
    np_tree = jax.tree.map(np.asarray, params)
    model = port_model.init_tao(port_cfg, device="cpu")
    model.load_state_dict(params_from_jax(np_tree))  # strict: same paths, same shapes
    return params, model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tao_forward_matches_reference(name):
    spec, b = CONFIGS[name]
    ref_cfg, port_cfg = configs(spec)
    params, model = port_from_reference(ref_cfg, port_cfg)
    batch = random_batch(port_cfg, b, seed=1)
    forward = jax.jit(ref_model.tao_forward, static_argnums=2)
    ref = forward(params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    with torch.inference_mode():
        got = port_model.tao_forward(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     port_cfg)
    assert set(got) == set(ref)
    for k in ("fetch_lat_logits", "exec_lat_logits", "mispred_logit", "dlevel_logits",
              "icache_logit", "tlb_logit"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    for k in ("fetch_lat", "exec_lat"):
        logits = np.sort(np.asarray(ref[f"{k}_logits"]), axis=-1)
        clear = logits[..., -1] - logits[..., -2] > 4 * ATOL
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[k].numpy()[clear], np.asarray(ref[k])[clear], err_msg=k)


def test_init_tao_matches_reference_structure():
    """The port's random init has the reference's parameter paths and
    shapes, draws from the given generator reproducibly, and keeps the
    reference's distributions (near-identity adaptation, zero biases)."""
    ref_cfg, port_cfg = configs(SMALL)
    shapes = jax.eval_shape(lambda key: ref_model.init_tao(key, ref_cfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    expected = {k: tuple(v.shape) for k, v in params_from_jax(tree).items()}
    a = port_model.init_tao(port_cfg, torch.Generator().manual_seed(3), device="cpu")
    b = port_model.init_tao(port_cfg, torch.Generator().manual_seed(3), device="cpu")
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == expected
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert torch.all(sd["embed.combine.bias"] == 0)
    assert float((sd["adapt.weight"] - torch.eye(port_cfg.d_model)).abs().max()) < 0.1
    w = sd["pred.blocks.0.up.weight"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(port_cfg.d_model) / 0.8796 + 1e-6


def test_latency_decode_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((50, port_model.NUM_LAT_BUCKETS)).astype(np.float32)
    logits[:10, 3] = logits[:10, 7] = 10.0  # exact ties: the first max wins
    got = port_model.expected_latency(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_model.expected_latency(jnp.asarray(logits))))
    assert np.all(got[:10] == port_model.LAT_REPS[3])
    x = np.concatenate([np.arange(-2, 300, 0.5), port_model.LAT_EDGES]).astype(np.float32)
    np.testing.assert_array_equal(
        port_model.bucketize_latency(torch.from_numpy(x)).numpy(),
        np.asarray(ref_model.bucketize_latency(jnp.asarray(x))),
    )
    np.testing.assert_array_equal(port_model.LAT_REPS, ref_model.LAT_REPS)


def test_config_defaults_match_reference():
    ref = dataclasses.asdict(ref_model.TaoConfig())
    # the reference's Pallas switch has no counterpart: on the card the
    # port's attention is always the hand-written kernel
    assert ref.pop("use_pallas") is False
    port = dataclasses.asdict(port_model.TaoConfig())
    assert port == ref
