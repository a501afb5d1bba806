"""The port's joint multi-µarch training (Algorithm 1 and its baselines)
against the reference's, on the CPU.

Parameters are made by the reference's ``init_multiarch`` and carried
over with ``params_from_jax``; batches come from the reference's data
path (detailed simulator on UARCH_A and UARCH_B, alignment, labelled
features, windows).  What each comparison holds, and why:

  * ``_normalize_grad`` on equal inputs: within 1e-6 (a float32 mean in
    another summation order);
  * one joint step's losses: 1e-6 relative; the embedding gradient after
    each method's combination within 1e-5 of its tensor's largest
    reference value (float32 matmuls and reductions in XLA's order
    against torch's, as ``tests/test_torch_train.py`` holds one step's
    gradients);
  * three steps: losses within 1e-5 relative, GradNorm's weights within
    1e-5 (they move by ±0.025 · ||g|| steps whose sign both sides agree
    on); under the three methods without adaptation ``adapt`` is bitwise
    unchanged (its gradient is zero, so AdamW leaves it);
  * ``eval_loss``: 1e-6 relative;
  * the joint tree through ``params_from_jax`` / ``params_to_jax``:
    bitwise both ways.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.core import multiarch as ref_ma  # noqa: E402
from repro.core.align import build_adjusted_trace  # noqa: E402
from repro.core.dataset import build_windows  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro.uarch import UARCH_A, UARCH_B, get_benchmark, run_detailed, run_functional  # noqa: E402

from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import multiarch as port_ma  # noqa: E402
from repro_torch.core.features import FeatureConfig  # noqa: E402
from repro_torch.core.model import TaoConfig  # noqa: E402
from repro_torch.train import optim as port_optim  # noqa: E402

LR = 2e-3
BATCH = 8
SMALL = dict(window=17, d_model=32, n_heads=2, n_layers=1, d_ff=64, d_cat=16)
FEATS = (64, 4, 8)


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_model.TaoConfig(features=ref_features.FeatureConfig(*FEATS), **SMALL)
    port_cfg = TaoConfig(features=FeatureConfig(*FEATS), **SMALL)
    prog = get_benchmark("dee")
    ft = run_functional(prog, 3000)
    batches = {}
    for name, ua in (("A", UARCH_A), ("B", UARCH_B)):
        det, _ = run_detailed(prog, ft, ua)
        ds = build_windows(ref_features.extract_features(build_adjusted_trace(det).adjusted,
                                                         ref_cfg.features), ref_cfg.window)
        batches[name] = [next(ds.batches(BATCH, rng=np.random.default_rng(s))) for s in range(3)]
    return ref_cfg, port_cfg, batches


def ref_params(ref_cfg, seed=0):
    return jax.tree.map(np.asarray, jax.jit(ref_ma.init_multiarch, static_argnums=1)(
        jax.random.PRNGKey(seed), ref_cfg))


def port_params(port_cfg, tree):
    model = port_ma.init_multiarch(port_cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_close_to_max(got_tree, ref_tree, tol, what):
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(ref_tree), jax.tree.leaves(got_tree)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max(),
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def test_normalize_grad_matches_reference():
    rng = np.random.default_rng(0)
    g = {"w": (rng.normal(size=(48, 16)) * 100).astype(np.float32),
         "b": (rng.normal(size=(16,)) * 1e-3).astype(np.float32),
         "t": rng.normal(size=(15, 64)).astype(np.float32)}
    ref = ref_ma._normalize_grad(jnp_tree(g))
    got = port_ma._normalize_grad({k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=1e-6, err_msg=k)
        assert got[k].dtype == torch.float32
    n = got["w"]
    assert float(n.max() - n.min()) <= 1.0 + 1e-6 and abs(float(n.mean())) < 1e-6


def ref_embed_grad(params, ba, bb, cfg, method, w):
    """The reference's combined embedding gradient and losses, from its own
    ``_forward_loss`` and ``_normalize_grad``; GradNorm's weighting is its
    one line ``0.5 * (wa * a + wb * b)``."""
    use_adapt = method == "tao"

    @jax.jit
    def vg(ep, ap, b):
        return jax.value_and_grad(lambda e: ref_ma._forward_loss(e, ap, b, cfg, use_adapt)[0])(ep)

    la, ga = vg(params["embed"], params["A"], ba)
    lb, gb = vg(params["embed"], params["B"], bb)
    if method == "granite":
        g = jax.tree.map(lambda a, b: 0.5 * (a + b), ga, gb)
    elif method in ("tao", "tao_no_adapt"):
        g = jax.tree.map(lambda a, b: 0.5 * (a + b), ref_ma._normalize_grad(ga), ref_ma._normalize_grad(gb))
    else:
        g = jax.tree.map(lambda a, b: 0.5 * (w[0] * a + w[1] * b), ga, gb)
    return float(la), float(lb), g


@pytest.mark.parametrize("method", port_ma.METHODS)
def test_one_joint_step_matches_reference(setup, method):
    ref_cfg, port_cfg, batches = setup
    ba, bb = batches["A"][0], batches["B"][0]
    tree = ref_params(ref_cfg)
    w = np.array([1.3, 0.7], np.float32)
    la, lb, ref_g = ref_embed_grad(jnp_tree(tree), jnp_tree(ba), jnp_tree(bb), ref_cfg, method, w)
    model = port_params(port_cfg, tree)
    tb = [port_ma.to_device(b, torch.device("cpu")) for b in (ba, bb)]
    gla, glb, grads, _ = port_ma.joint_grads(model, torch.from_numpy(w), torch.ones(2), *tb,
                                             port_cfg, method)
    np.testing.assert_allclose([gla.item(), glb.item()], [la, lb], rtol=1e-6)
    assert set(grads) == {k for k, _ in model.named_parameters()}
    got_g = params_to_jax({k: v for k, v in grads.items() if k.startswith("embed.")})["embed"]
    assert jax.tree.structure(got_g) == jax.tree.structure(ref_g)
    assert_close_to_max(got_g, ref_g, 1e-5, f"{method} embed")
    # the step itself: the same losses, every parameter moved once
    step = port_ma.make_joint_step(port_cfg, port_optim.AdamWConfig(lr=LR), method)
    opt = port_optim.adamw_init(dict(model.named_parameters()))
    opt, w_new, metrics = step(model, opt, torch.from_numpy(w), torch.ones(2), ba, bb)
    assert int(opt.step) == 1 and metrics["loss_a"].item() == gla.item()
    assert metrics["loss_b"].item() == glb.item() and np.isfinite(metrics["gnorm"].item())
    if method != "gradnorm":
        assert torch.equal(w_new, torch.from_numpy(w))


@pytest.mark.parametrize("method", port_ma.METHODS)
def test_three_joint_steps_track_reference(setup, method):
    """Three steps on three batch pairs from equal params, the first
    step's losses as GradNorm's initial losses (as ``Session.train_joint``
    sets them): losses, GradNorm's weights, and ``adapt`` left unchanged
    by the methods that do not run it."""
    ref_cfg, port_cfg, batches = setup
    tree = ref_params(ref_cfg, seed=1)
    ref_step = ref_ma.make_joint_step(ref_cfg, ref_optim.AdamWConfig(lr=LR), method=method)
    rp = jnp_tree(tree)
    ropt = ref_optim.adamw_init(rp)
    rw, ril = jnp.ones((2,)), jnp.ones((2,))
    model = port_params(port_cfg, tree)
    step = port_ma.make_joint_step(port_cfg, port_optim.AdamWConfig(lr=LR), method)
    opt = port_optim.adamw_init(dict(model.named_parameters()))
    w, il = torch.ones(2), torch.ones(2)
    ref_losses, losses, ref_w, ws = [], [], [], []
    for i in range(3):
        ba, bb = batches["A"][i], batches["B"][i]
        rp, ropt, rw, rm = ref_step(rp, ropt, rw, ril, jnp_tree(ba), jnp_tree(bb))
        opt, w, m = step(model, opt, w, il, ba, bb)
        ref_losses.append([float(rm["loss_a"]), float(rm["loss_b"])])
        losses.append([m["loss_a"].item(), m["loss_b"].item()])
        ref_w.append(np.asarray(rw))
        ws.append(w.numpy().copy())
        if i == 0:
            ril = jnp.asarray(ref_losses[0])
            il = torch.tensor(losses[0])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(ws, ref_w, rtol=0, atol=1e-5)
    if method == "gradnorm":
        assert not np.allclose(ws[-1], 1.0)  # the weights moved
        np.testing.assert_allclose([x.sum() for x in ws], 2.0, rtol=1e-6)
    init, now = params_from_jax(tree), model.state_dict()
    adapt = [k for k in init if ".adapt." in k]
    assert len(adapt) == 4
    unchanged = all(torch.equal(now[k], init[k]) for k in adapt)
    assert unchanged == (method != "tao"), method
    assert step.entry.compiles == 1  # one geometry met


def test_eval_loss_matches_reference(setup):
    ref_cfg, port_cfg, batches = setup
    tree = ref_params(ref_cfg, seed=2)
    model = port_params(port_cfg, tree)
    for arch in ("A", "B"):
        for use_adapt in (True, False):
            ref = ref_ma.eval_loss(jnp_tree(tree), [jnp_tree(b) for b in batches[arch]], ref_cfg, arch,
                                   use_adapt=use_adapt)
            got = port_ma.eval_loss(model, batches[arch], port_cfg, arch, use_adapt=use_adapt)
            np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=f"{arch} {use_adapt}")
    assert port_ma.eval_loss(model, [], port_cfg, "A") == 0.0


def test_multiarch_tree_round_trips_bitwise(setup):
    ref_cfg, port_cfg, _ = setup
    tree = ref_params(ref_cfg, seed=3)
    sd = params_from_jax(tree)
    model = port_ma.init_multiarch(port_cfg, torch.Generator().manual_seed(5), device="cpu")
    assert sd.keys() == model.state_dict().keys()
    assert {k.split(".")[0] for k in sd} == {"embed", "A", "B"}
    back = params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
    again = params_from_jax(params_to_jax(model))
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_unknown_method_raises(setup):
    _, port_cfg, _ = setup
    with pytest.raises(ValueError, match="not in"):
        port_ma.make_joint_step(port_cfg, port_optim.AdamWConfig(), "mean")
