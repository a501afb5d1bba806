"""The port's training path against the reference's, on the CPU.

Inputs come from the reference's own data path (detailed simulator,
alignment, labelled features, windows; NumPy throughout) or from a NumPy
seed, and parameters are made by the reference's ``init_tao`` and carried
over with ``params_from_jax``.  What each comparison holds, and why:

  * windows, the dedup keep-set, batch order and subsamples: bitwise (the
    same NumPy operations; the digests hash the same bytes);
  * the loss and each of its parts: 1e-6 relative (float32 reductions in
    other orders);
  * one step's gradients from equal params: each element within 1e-5 of
    its tensor's largest reference gradient (float32 matmuls and
    reductions in XLA's order against torch's; measured below 1e-6);
  * ``adamw_update`` on equal inputs: the moments bitwise, the parameters
    within 4 · 2^-24 (max(|p|, |p'|) + |p - p'|): the port spells out the
    fused multiply-adds and the division XLA compiles the reference's
    update to, and XLA's float32 sqrt is within an ulp of the correctly
    rounded one that torch takes;
  * the global norm: 1e-5 relative (a sum of squares over up to 10^5
    elements in two orders);
  * a trajectory of 6 steps: losses within 1e-6 relative; parameters
    within 2 lr a step, and 99% of them within 1e-5.  Adam divides by
    sqrt(v): where a gradient is near 0 its sign, and so the direction of a
    whole step of ~lr, can differ between the two sides from ulp-level
    differences; everywhere else the two stay within float32 noise;
  * the fine-tune: ``embed`` bitwise unchanged, adapt / pred as the
    trajectory.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dataset as ref_dataset  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.core.align import build_adjusted_trace  # noqa: E402
from repro.core.transfer import train_tao_impl as ref_train  # noqa: E402
from repro.core.transfer import transfer_finetune as ref_transfer  # noqa: E402
from repro.nn.core import softmax_cross_entropy as ref_ce  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro.uarch import UARCH_A, get_benchmark, run_detailed, run_functional  # noqa: E402

from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import dataset as port_dataset  # noqa: E402
from repro_torch.core import model as port_model  # noqa: E402
from repro_torch.core import transfer as port_transfer  # noqa: E402
from repro_torch.core.features import FeatureConfig, extract_features  # noqa: E402
from repro_torch.nn.core import softmax_cross_entropy  # noqa: E402
from repro_torch.train import optim as port_optim  # noqa: E402

CPU = torch.device("cpu")
SMALL = dict(window=17, d_model=32, n_heads=2, n_layers=1, d_ff=64, d_cat=16, features=(64, 4, 8))
DEFAULT = dict(features=(1024, 32, 64))  # the default TaoConfig's widths
# name: (config, instructions of lee, batch)
CONFIGS = {"small": (SMALL, 4000, 4), "default_width": (DEFAULT, 3000, 3)}


def configs(spec):
    kw = dict(spec)
    nb, nq, nm = kw.pop("features")
    ref = ref_model.TaoConfig(features=ref_features.FeatureConfig(nb, nq, nm), **kw)
    port = port_model.TaoConfig(features=FeatureConfig(nb, nq, nm), **kw)
    return ref, port


_ADJUSTED = {}


def adjusted(bench, n):
    """The reference's labelled (adjusted) trace of ``bench`` on UARCH_A."""
    if (bench, n) not in _ADJUSTED:
        prog = get_benchmark(bench)
        det, _ = run_detailed(prog, run_functional(prog, n), UARCH_A)
        _ADJUSTED[bench, n] = build_adjusted_trace(det).adjusted
    return _ADJUSTED[bench, n]


def feature_sets(ref_cfg, port_cfg, bench, n):
    adj = adjusted(bench, n)
    return ref_features.extract_features(adj, ref_cfg.features), extract_features(adj, port_cfg.features)


def as_port(ds):
    return port_dataset.WindowDataset(inputs=ds.inputs, labels=ds.labels)


def assert_tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def setup(name, seed=0):
    spec, n, b = CONFIGS[name]
    ref_cfg, port_cfg = configs(spec)
    ref_fs, _ = feature_sets(ref_cfg, port_cfg, "lee", n)
    ds = ref_dataset.build_windows(ref_fs, ref_cfg.window)
    params = jax.jit(ref_model.init_tao, static_argnums=1)(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, port_cfg, ds, params, b


# ---------------------------------------------------------------------------
# windows, dedup, batches
# ---------------------------------------------------------------------------

# (bench, instructions, window, stride, features, repeats): ``repeats``
# copies of the trace's features back to back, so windows repeat and the
# dedup drops them
WINDOW_CASES = {
    "lee_small_window": ("lee", 4000, 17, None, (64, 4, 8), 1),
    "mcf_overlapping": ("mcf", 3000, 9, 3, (64, 4, 8), 1),
    "dee_default": ("dee", 6000, 129, None, (1024, 32, 64), 1),
    "lee_repeated": ("lee", 1530, 17, None, (64, 4, 8), 3),
}


def repeated(fs, n):
    """``fs`` with every array (labels too) repeated ``n`` times."""
    return dataclasses.replace(
        fs, **{f.name: np.concatenate([getattr(fs, f.name)] * n) for f in dataclasses.fields(fs)
               if f.name != "labels"},
        labels={k: np.concatenate([v] * n) for k, v in fs.labels.items()})


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_build_windows_and_dedup_match_reference(case):
    bench, n, window, stride, feats, reps = WINDOW_CASES[case]
    ref_cfg, port_cfg = configs(dict(window=window, features=feats))
    ref_fs, port_fs = (repeated(fs, reps) for fs in feature_sets(ref_cfg, port_cfg, bench, n))
    views = [{k: port_dataset.window_view(getattr(port_fs, k), window, stride or window)
              for k in port_dataset.INPUT_KEYS},
             {k: port_dataset.window_view(port_fs.labels[k], window, stride or window)
              for k in port_dataset._LABEL_KEYS}]
    assert list(port_dataset.iter_window_digests(*views)) == list(
        ref_dataset.iter_window_digests(*views))
    keep = port_dataset._dedup_mask(*views)
    np.testing.assert_array_equal(keep, ref_dataset._dedup_mask(*views))
    ref = ref_dataset.build_windows(ref_fs, window, stride)
    got = port_dataset.build_windows(port_fs, window, stride)
    assert_tree_equal(got.inputs, ref.inputs)
    assert_tree_equal(got.labels, ref.labels)
    assert len(got) == keep.sum() and got.window == ref.window
    undeduped = port_dataset.build_windows(port_fs, window, stride, dedup=False)
    assert_tree_equal(undeduped.inputs, ref_dataset.build_windows(ref_fs, window, stride, dedup=False).inputs)
    if reps > 1:
        assert len(got) < len(undeduped)  # the dedup drops the repeats


def test_batches_subsample_and_concat_match_reference():
    ref_cfg, port_cfg = configs(dict(window=17, features=(64, 4, 8)))
    parts = [feature_sets(ref_cfg, port_cfg, b, 3000) for b in ("lee", "mcf")]
    ref = ref_dataset.concat_datasets([ref_dataset.build_windows(r, 17) for r, _ in parts])
    got = port_dataset.concat_datasets([port_dataset.build_windows(p, 17) for _, p in parts])
    assert_tree_equal(got.inputs, ref.inputs)
    assert_tree_equal(got.labels, ref.labels)
    for drop_last in (True, False):
        ref_b = list(ref.batches(7, rng=np.random.default_rng(5), drop_last=drop_last))
        got_b = list(got.batches(7, rng=np.random.default_rng(5), drop_last=drop_last))
        assert len(got_b) == len(ref_b) > 1
        for a, b in zip(got_b, ref_b):
            assert_tree_equal(a, b)
    assert_tree_equal(list(got.batches(7)), list(ref.batches(7)))
    sub, ref_sub = got.subsample(11, seed=4), ref.subsample(11, seed=4)
    assert_tree_equal((sub.inputs, sub.labels), (ref_sub.inputs, ref_sub.labels))
    assert got.subsample(10**6) is got


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((5, 7, 16))).astype(np.float32)
    labels = rng.integers(-1, 17, (5, 7)).astype(np.int32)  # out of range: no class
    got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), ref_ce(jnp.asarray(logits), jnp.asarray(labels)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_multi_metric_loss_and_parts_match_reference(name):
    ref_cfg, port_cfg, ds, _, b = setup(name)
    batch = next(ds.batches(b, rng=np.random.default_rng(1)))
    rng = np.random.default_rng(2)
    w, nb = ref_cfg.window, ref_model.NUM_LAT_BUCKETS
    preds = {
        "fetch_lat_logits": rng.standard_normal((b, w, nb)),
        "exec_lat_logits": rng.standard_normal((b, w, nb)),
        "mispred_logit": 4 * rng.standard_normal((b, w)),
        "dlevel_logits": rng.standard_normal((b, w, 4)),
        "icache_logit": 4 * rng.standard_normal((b, w)),
        "tlb_logit": 4 * rng.standard_normal((b, w)),
    }
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    ref_total, ref_parts = jax.jit(ref_model.multi_metric_loss)(
        jax.tree.map(jnp.asarray, preds), jax.tree.map(jnp.asarray, batch["labels"]))
    total, parts = port_model.multi_metric_loss(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in batch["labels"].items()})
    assert set(parts) == set(ref_parts) == set(port_model.LOSS_WEIGHTS)
    for k, v in ref_parts.items():
        np.testing.assert_allclose(parts[k].item(), float(v), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-6)
    assert port_model.LOSS_WEIGHTS == ref_model.LOSS_WEIGHTS
    assert port_model.LAT_SCALE == ref_model.LAT_SCALE


# ---------------------------------------------------------------------------
# one step's gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_step_gradients_match_reference(name):
    ref_cfg, port_cfg, ds, params, b = setup(name)
    batch = next(ds.batches(b, rng=np.random.default_rng(3)))

    def loss_fn(p, bt):
        return ref_model.multi_metric_loss(ref_model.tao_forward(p, bt, ref_cfg), bt["labels"])[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params, jax.tree.map(jnp.asarray, batch))
    model = port_model.init_tao(port_cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tb = port_transfer.to_device(batch, CPU)
    loss, _ = port_model.multi_metric_loss(port_model.tao_forward(model, tb, port_cfg), tb["labels"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    assert jax.tree.structure(grads) == jax.tree.structure(ref_grads)
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(ref_grads), jax.tree.leaves(grads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (300, 50), "b": (1300,), "t": (30, 40, 20)}


def opt_inputs(seed):
    rng = np.random.default_rng(seed)

    def draw(lo, hi, positive=False):
        out = {}
        for k, s in OPT_SHAPES.items():
            x = rng.standard_normal(s)
            out[k] = ((np.abs(x) if positive else x) * 10 ** rng.uniform(lo, hi, s)).astype(np.float32)
        return out

    return draw(-6, 0), draw(-6, 1), draw(-6, 0), draw(-8, 0, positive=True)


def tensors(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


@pytest.mark.parametrize("wd,lr", [(0.0, 3e-4), (0.01, 1e-2)])
def test_adamw_update_matches_reference(wd, lr):
    p, g, m, v = opt_inputs(int(wd * 100))
    rcfg = ref_optim.AdamWConfig(lr=lr, weight_decay=wd, clip_norm=None)
    pcfg = port_optim.AdamWConfig(lr=lr, weight_decay=wd, clip_norm=None)
    j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}  # noqa: E731
    rp, rs, rn = jax.jit(lambda *a: ref_optim.adamw_update(*a, rcfg))(
        j(p), j(g), ref_optim.AdamWState(jnp.int32(3), j(m), j(v)))
    state = port_optim.AdamWState(torch.tensor(3, dtype=torch.int32), tensors(m), tensors(v))
    tp, ts, tn = port_optim.adamw_update(tensors(p), tensors(g), state, pcfg)
    assert int(ts.step) == int(rs.step) == 4
    np.testing.assert_allclose(tn.item(), float(rn), rtol=1e-5)
    for k in OPT_SHAPES:
        np.testing.assert_array_equal(ts.mu[k].numpy(), np.asarray(rs.mu[k]))
        np.testing.assert_array_equal(ts.nu[k].numpy(), np.asarray(rs.nu[k]))
        ref = np.asarray(rp[k])
        scale = np.maximum(np.abs(p[k]), np.abs(ref)) + np.abs(p[k] - ref)
        assert np.all(np.abs(tp[k].numpy() - ref) <= 4 * 2.0**-24 * scale), k


def test_adamw_clip_and_first_step_match_reference():
    """The default config (clip 1.0) from ``adamw_init``: the global norm
    and the clipped gradients within 1e-5 relative, and the update equals
    the unclipped update of the clipped gradients bitwise."""
    p, g, _, _ = opt_inputs(7)
    clipped, norm = port_optim.clip_by_global_norm(tensors(g), 1.0)
    ref_clipped, ref_norm = jax.jit(lambda x: ref_optim.clip_by_global_norm(x, 1.0))(
        {k: jnp.asarray(x) for k, x in g.items()})
    np.testing.assert_allclose(norm.item(), float(ref_norm), rtol=1e-5)
    for k in OPT_SHAPES:
        np.testing.assert_allclose(clipped[k].numpy(), ref_clipped[k], rtol=1e-5, atol=0)
    params = tensors(p)
    state = port_optim.adamw_init(params)
    assert int(state.step) == 0 and all(not x.any() for x in list(state.mu.values()) + list(state.nu.values()))
    _, state, gnorm = port_optim.adamw_update(params, tensors(g), state, port_optim.AdamWConfig())
    plain = tensors(p)
    port_optim.adamw_update(plain, clipped, port_optim.adamw_init(plain),
                            port_optim.AdamWConfig(clip_norm=None))
    assert torch.equal(gnorm, norm)
    for k in OPT_SHAPES:
        assert torch.equal(params[k], plain[k])
    bf16 = port_optim.adamw_init(tensors(p), m_dtype="bfloat16")
    assert all(x.dtype == torch.bfloat16 for x in bf16.mu.values())


def test_lr_schedule_matches_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    ref = jax.vmap(ref_optim.make_lr_schedule(1e-3, 10, 100))(jnp.asarray(steps))
    got = port_optim.make_lr_schedule(1e-3, 10, 100)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# trainer and transfer
# ---------------------------------------------------------------------------

LR = 1e-3
EPOCHS = 2


def assert_trajectory(got_params, ref_params, steps):
    """Every parameter within 2 lr a step, 99% of them within 1e-5."""
    diffs = np.concatenate([np.abs(np.asarray(r) - g).ravel() for r, g in zip(
        jax.tree.leaves(ref_params), jax.tree.leaves(params_to_jax(got_params)))])
    assert diffs.max() <= 2 * LR * steps
    assert (diffs <= 1e-5).mean() >= 0.99


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_tao_impl_matches_reference(name):
    ref_cfg, port_cfg, ds, params, b = setup(name)
    sub = ds.subsample(3 * b, seed=1)  # 3 steps an epoch
    ref = ref_train(ref_cfg, sub, epochs=EPOCHS, batch_size=b, lr=LR, init_params=params, seed=3)
    got = port_transfer.train_tao_impl(
        port_cfg, as_port(sub), epochs=EPOCHS, batch_size=b, lr=LR,
        init_params=params_from_jax(jax.tree.map(np.asarray, params)), seed=3, device="cpu")
    assert got.steps == ref.steps == 3 * EPOCHS
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-6)
    assert got.eval_losses == ref.eval_losses == []
    assert_trajectory(got.params, ref.params, got.steps)


def test_transfer_finetune_freezes_embed_and_tracks_reference():
    ref_cfg, port_cfg, ds, params, b = setup("small", seed=1)
    sub = ds.subsample(3 * b, seed=2)
    ref = ref_transfer(ref_cfg, params["embed"], params, sub, epochs=EPOCHS, batch_size=b, lr=LR, seed=4)
    donor = port_model.init_tao(port_cfg, device="cpu")
    donor.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    before = {k: v.clone() for k, v in donor.state_dict().items()}
    got = port_transfer.transfer_finetune(port_cfg, donor.embed, donor, as_port(sub), epochs=EPOCHS,
                                          batch_size=b, lr=LR, seed=4, device="cpu")
    for k, v in got.params.embed.state_dict().items():
        assert torch.equal(v, before[f"embed.{k}"]), k
        assert not got.params.embed.get_parameter(k).requires_grad
    for k, v in donor.state_dict().items():  # the donor is left alone
        assert torch.equal(v, before[k]), k
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-6)
    assert_trajectory(got.params, ref.params, got.steps)
    # as a state dict too, and through train_tao_impl's own spelling
    again = port_transfer.train_tao_impl(port_cfg, as_port(sub), epochs=EPOCHS, batch_size=b, lr=LR,
                                         seed=4, init_params=donor.state_dict(), freeze_embed=True,
                                         device="cpu")
    for a, c in zip(again.params.state_dict().values(), got.params.state_dict().values()):
        assert torch.equal(a, c)


def test_headonly_step_computes_no_embed_gradient():
    _, port_cfg, ds, _, b = setup("small")
    model = port_model.init_tao(port_cfg, device="cpu")
    model.embed.requires_grad_(False)
    params = port_transfer.trainable_params(model, "headonly")
    assert params and not any(k.startswith("embed.") for k in params)
    opt = port_optim.adamw_init(params)
    step = port_transfer._make_step(port_cfg, port_optim.AdamWConfig(), "headonly")
    embed = {k: v.clone() for k, v in model.embed.state_dict().items()}
    opt, loss = step(model, opt, port_transfer.to_device(next(ds.batches(b)), CPU))
    assert int(opt.step) == 1 and np.isfinite(loss.item())
    assert all(p.grad is None for p in model.parameters())
    for k, v in model.embed.state_dict().items():
        assert torch.equal(v, embed[k])
    with pytest.raises(ValueError, match="trainable"):
        port_transfer.trainable_params(model, "embed")


def test_train_tao_impl_stops_at_target_loss_and_runs_eval():
    _, port_cfg, ds, _, b = setup("small")
    seen = []
    res = port_transfer.train_tao_impl(port_cfg, as_port(ds.subsample(2 * b)), epochs=5, batch_size=b,
                                       lr=LR, target_loss=1e9, device="cpu",
                                       eval_fn=lambda m: seen.append(m) or 0.5)
    assert len(res.losses) == 1 and res.eval_losses == [0.5] and seen == [res.params]
    assert res.steps == 2 and res.seconds > 0


# ---------------------------------------------------------------------------
# weights back to the reference's tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_to_jax_round_trip_is_bitwise(name):
    ref_cfg, port_cfg, _, params, _ = setup(name, seed=5)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_jax(params_from_jax(tree))
    assert_tree_equal(back, tree)
    model = port_model.init_tao(port_cfg, torch.Generator().manual_seed(3), device="cpu")
    sd = params_from_jax(params_to_jax(model))
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert dataclasses.is_dataclass(port_cfg)
