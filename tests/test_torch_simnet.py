"""The port's SimNet baseline against the reference's, on the CPU.

  * ``simnet_features`` and ``simnet_windows``: bitwise (the same NumPy);
  * ``simnet_forward`` on weights carried over with ``params_from_jax``
    (the (k, cin, cout) kernels transposed to ``nn.Conv1d``'s (cout, cin,
    k)): within 1e-5 of JAX (float32 convolutions and matmuls in two
    orders);
  * three train steps from equal weights: losses within 1e-6 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import simnet as ref_simnet  # noqa: E402
from repro.core.align import build_adjusted_trace as ref_align  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro.uarch import UARCH_A, get_benchmark, run_detailed, run_functional  # noqa: E402

from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import simnet as port_simnet  # noqa: E402
from repro_torch.core.align import build_adjusted_trace  # noqa: E402
from repro_torch.train import optim as port_optim  # noqa: E402
from repro_torch.uarch import UARCH_A as PORT_UARCH_A  # noqa: E402
from repro_torch.uarch import get_benchmark as port_benchmark  # noqa: E402
from repro_torch.uarch import run_detailed as port_detailed  # noqa: E402
from repro_torch.uarch import run_functional as port_functional  # noqa: E402

CFG = dict(window=33, channels=24, n_conv=3, kernel_size=5)
LR = 1e-3


@pytest.fixture(scope="module")
def adjusted():
    """The adjusted (labelled) trace of mcf on UARCH_A, from each package."""
    prog = get_benchmark("mcf")
    ref = ref_align(run_detailed(prog, run_functional(prog, 3000), UARCH_A)[0]).adjusted
    pprog = port_benchmark("mcf")
    port = build_adjusted_trace(port_detailed(pprog, port_functional(pprog, 3000), PORT_UARCH_A)[0]).adjusted
    return ref, port


def test_features_and_windows_bitwise(adjusted):
    ref_adj, port_adj = adjusted
    ref, got = ref_simnet.simnet_features(ref_adj), port_simnet.simnet_features(port_adj)
    assert got.keys() == ref.keys() and got["x"].shape[1] == port_simnet.SimNetConfig().feat_dim
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for window in (33, 129, 5000):  # 5000 > the trace: one truncated window
        rw, gw = ref_simnet.simnet_windows(ref, window), port_simnet.simnet_windows(got, window)
        for k in rw:
            np.testing.assert_array_equal(gw[k], rw[k], err_msg=f"{k} {window}")


def models(seed=0):
    ref_cfg, port_cfg = ref_simnet.SimNetConfig(**CFG), port_simnet.SimNetConfig(**CFG)
    tree = jax.tree.map(np.asarray, ref_simnet.init_simnet(jax.random.PRNGKey(seed), ref_cfg))
    # non-zero biases, so that their layout is held too
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: a + (0.01 * rng.standard_normal(a.shape)).astype(np.float32)
                        if a.ndim == 1 else a, tree)
    model = port_simnet.init_simnet(port_cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return ref_cfg, port_cfg, tree, model


def test_converter_transposes_conv_kernels_to_conv1d_layout():
    _, port_cfg, tree, model = models()
    w = tree["convs"][0]["w"]  # (k, cin, cout)
    assert w.shape == (5, port_cfg.feat_dim, 24)
    assert tuple(model.convs[0].weight.shape) == (24, port_cfg.feat_dim, 5)
    np.testing.assert_array_equal(model.convs[0].weight.detach().numpy(), np.transpose(w, (2, 1, 0)))
    back = params_to_jax(model)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert x.shape == y.shape and np.array_equal(x, y)


def test_forward_matches_reference(adjusted):
    ref_cfg, port_cfg, tree, model = models(seed=1)
    feats = port_simnet.simnet_features(adjusted[1])
    x = port_simnet.simnet_windows(feats, CFG["window"])["x"][:6]
    ref = jax.jit(ref_simnet.simnet_forward, static_argnums=2)(jax.tree.map(jnp.asarray, tree),
                                                               jnp.asarray(x), ref_cfg)
    with torch.no_grad():
        got = port_simnet.simnet_forward(model, torch.from_numpy(x), port_cfg)
    assert got.shape == (6, CFG["window"], 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # causal: a change at position t moves no output before t
    x2 = x.copy()
    x2[:, 20] += 1.0
    with torch.no_grad():
        moved = port_simnet.simnet_forward(model, torch.from_numpy(x2), port_cfg)
    assert torch.equal(moved[:, :20], got[:, :20]) and not torch.equal(moved[:, 20:], got[:, 20:])


def test_three_steps_track_reference(adjusted):
    ref_cfg, port_cfg, tree, model = models(seed=2)
    wins = port_simnet.simnet_windows(port_simnet.simnet_features(adjusted[1]), CFG["window"])
    batches = [{k: v[i * 8:(i + 1) * 8] for k, v in wins.items()} for i in range(3)]
    ref_step = ref_simnet.make_simnet_step(ref_cfg, ref_optim.AdamWConfig(lr=LR))
    rp = jax.tree.map(jnp.asarray, tree)
    ropt = ref_optim.adamw_init(rp)
    step = port_simnet.make_simnet_step(port_cfg, port_optim.AdamWConfig(lr=LR))
    opt = port_optim.adamw_init(dict(model.named_parameters()))
    ref_losses, losses = [], []
    for b in batches:
        rp, ropt, rl = ref_step(rp, ropt, jax.tree.map(jnp.asarray, b))
        opt, loss = step(model, opt, b)
        ref_losses.append(float(rl))
        losses.append(loss.item())
    assert int(opt.step) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    assert losses[-1] < losses[0]
