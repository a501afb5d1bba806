"""The port's LLM trainer against the reference's, on the CPU (dense).

``Model.loss`` under autograd, ``train.trainer`` (``TrainConfig``,
``TrainState``, ``init_state``, ``make_train_step`` with and without
microbatches, ``batch_axes``), ``data.pipeline`` and
``launch.train`` at ``qwen2-0.5b`` reduced (4 layers, d_model 64, 4 heads
of 16 over 2 kv heads, vocab 512).  ``jax.random`` cannot be reproduced in
torch, so the reference initializes the weights and they cross as NumPy
through ``convert.lm_params_from_jax``, which also carries the
reference's gradient tree to the port's parameter names; the same
pipeline batches (NumPy) go through both.

Tolerances (float32 params and compute, the reduced config's own):
  * loss within 1e-5 relative and every gradient leaf within 1e-4 of the
    leaf's largest |g| (measured: 4.8e-7 absolute on a loss of 6.27, and
    1.2e-6 of the largest |g|: matmul and reduction order);
  * three steps' ``loss``, ``grad_norm`` and ``lr`` within 1e-4
    relative (measured ~2e-7);
  * the parameters after three steps within 2e-6 + 2^-7 · (the sum of
    the steps' lr) where the reference's gradient is not near zero at any
    step: |g| >= 1e-3 of the leaf's largest |g| at each.  AdamW's first
    steps move a parameter by ≈ lr · sign(g), so where g is ~0 a
    rounding-level difference flips the step; and the first moment is
    stored in bfloat16 (``opt_m_dtype``, the default), so a rounding-level
    difference in g can move m by one bfloat16 ulp, at most 2^-7 of the
    step (measured: up to 4.29e-5 at lrs 0, 5e-3 and 4.86e-3, against a
    bound of 7.70e-5 + 2e-6).
In the bfloat16 config (the full configs' dtypes, on the reduced shapes)
a band: loss within 1e-3 relative, every gradient leaf within 5e-2 of its
largest |g|, three steps' loss within 1e-3 and grad_norm within 1e-2
relative (measured: loss 5.3e-5 absolute, gradients 2.1e-2 of the
largest, step losses 2.0e-4 relative, grad_norm 2.7e-3; both sides round
every product to bfloat16, in other orders).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.backbone as ref_backbone  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.dataset import WindowDataset as RefWindowDataset  # noqa: E402
from repro.data.pipeline import LMDataPipeline as RefLMDataPipeline  # noqa: E402
from repro.data.pipeline import TraceDataPipeline as RefTraceDataPipeline  # noqa: E402
from repro.data.pipeline import make_lm_batch_specs as ref_make_lm_batch_specs  # noqa: E402
from repro.models.backbone import Model as RefModel  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro.train.optim import adamw_init as ref_adamw_init  # noqa: E402

import repro_torch.launch.train as launch_train  # noqa: E402
import repro_torch.models.backbone as backbone  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.dataset import WindowDataset  # noqa: E402
from repro_torch.data import LMDataPipeline, TraceDataPipeline, make_lm_batch_specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TrainConfig,
    batch_axes,
    init_state,
    make_train_step,
    restore_into,
    state_axes,
    state_shardings,
)

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
KEY = jax.random.PRNGKey(0)
B, S = 4, 32
TC = dict(lr=5e-3, total_steps=10, warmup_steps=1)
STEPS = 3

LOSS_REL = 1e-5
GRAD_OF_MAX = 1e-4
METRIC_REL = 1e-4
PARAM_ATOL = 2e-6  # plus 2^-7 of the steps' summed lr (module note)
PARAM_MASK_OF_MAX = 1e-3  # |g| below this share of the leaf's largest at a step: not compared
BF16_LOSS_REL = 1e-3
BF16_GRAD_OF_MAX = 5e-2
BF16_STEP_LOSS_REL = 1e-3
BF16_GNORM_REL = 1e-2


def np32(tree):
    """A reference tree as NumPy float32 (bfloat16 widened exactly)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def t_(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def j_(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def build(dtype="float32", arch=ARCH):
    """(reference cfg, Model, params), port Model on the same weights."""
    changes = dict(param_dtype=dtype, compute_dtype=dtype)
    ref_cfg = dataclasses.replace(ref_get_arch(arch, reduced=True), **changes)
    ref = RefModel(ref_cfg)
    params = jax.jit(ref.init)(KEY)
    port = Model(dataclasses.replace(get_arch(arch, reduced=True), **changes), device="cpu")
    port.load_state_dict(lm_params_from_jax(np32(params)))
    return ref_cfg, ref, params, port


def batches(cfg, n, seed=1, batch=B, seq=S):
    pipe = RefLMDataPipeline(cfg, batch=batch, seq=seq, seed=seed)
    out = [pipe.make_batch(i) for i in range(n)]
    out[0]["labels"][0, :5] = -1  # masked positions
    return out


def port_grads(port, batch):
    """(loss, {name: gradient}) of the port's loss under autograd."""
    params = dict(port.named_parameters())
    loss, _ = port.loss(t_(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


_VALUE_AND_GRAD = {}  # one compiled value_and_grad per reference model


def ref_grads(ref, params, batch):
    if id(ref) not in _VALUE_AND_GRAD:  # the model kept beside it: its id stays its own
        _VALUE_AND_GRAD[id(ref)] = ref, jax.jit(jax.value_and_grad(ref.loss, has_aux=True))
    (loss, _), grads = _VALUE_AND_GRAD[id(ref)][1](params, j_(batch))
    return loss, lm_params_from_jax(np32(grads))


def assert_grads(got, ref, of_max):
    assert set(got) == set(ref)
    for name, g in got.items():
        r = ref[name].float()
        err = float((g.detach().float() - r).abs().max())
        assert err <= of_max * float(r.abs().max()), (name, err, float(r.abs().max()))


def ref_state(ref, params, tcfg):
    """The reference's init_state on the given params (without re-running
    its eager init)."""
    return ref_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt=ref_adamw_init(params, m_dtype=tcfg.opt_m_dtype))


def run_both(ref, params, port, data, ref_grads_out=None, **tc):
    """A step of each trainer per batch of ``data``: (their metrics, the
    reference's final state, the port's); the reference's gradients of
    each step are appended to ``ref_grads_out`` when it is given."""
    rtc = ref_trainer.TrainConfig(**tc)
    rstate = ref_state(ref, params, rtc)
    rstep = jax.jit(ref_trainer.make_train_step(ref, rtc))
    tcfg = TrainConfig(**tc)
    state = init_state(port, tcfg)
    step = make_train_step(port, tcfg)
    got, want = [], []
    for b in data:
        if ref_grads_out is not None:
            ref_grads_out.append(ref_grads(ref, rstate.params, b)[1])
        rstate, rm = rstep(rstate, j_(b))
        state, m = step(state, t_(b))
        want.append({k: float(v) for k, v in rm.items()})
        got.append({k: float(v) for k, v in m.items()})
    return got, want, rstate, state


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def f32():
    ref_cfg, ref, params, port = build()
    return ref_cfg, ref, params, port, batches(ref_cfg, STEPS)


@pytest.fixture(scope="module")
def bf16():
    ref_cfg, ref, params, port = build("bfloat16")
    return ref_cfg, ref, params, port, batches(ref_cfg, STEPS)


def test_loss_and_every_gradient_match_reference(f32):
    _, ref, params, port, data = f32
    loss, grads = port_grads(port, data[0])
    r_loss, r_grads = ref_grads(ref, params, data[0])
    assert rel(float(loss), float(r_loss)) <= LOSS_REL
    assert_grads(grads, r_grads, GRAD_OF_MAX)


def test_three_train_steps_match_reference(f32):
    _, ref, params, _, data = f32
    port = build()[3]  # its own copy: the steps update it in place
    step_grads = []
    got, want, rstate, state = run_both(ref, params, port, data, step_grads, **TC)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "grad_norm", "lr", "ce", "aux"}
        for k in ("loss", "grad_norm", "lr"):
            assert rel(g[k], w[k]) <= METRIC_REL, (k, g[k], w[k])
    assert int(state.step) == int(rstate.step) == STEPS
    r_params = lm_params_from_jax(np32(rstate.params))
    kept = 0
    for name, p in state.params.items():
        mask = torch.ones(p.shape, dtype=torch.bool)
        for g in step_grads:
            mask &= g[name].abs() >= PARAM_MASK_OF_MAX * float(g[name].abs().max())
        diff = (p.detach() - r_params[name]).abs()[mask]
        atol = PARAM_ATOL + 2.0**-7 * sum(w["lr"] for w in want)
        assert float(diff.max()) <= atol, (name, float(diff.max()), atol)
        kept += int(mask.sum())
    assert kept >= 0.8 * sum(p.numel() for p in state.params.values())  # measured 87%


def test_bfloat16_config_within_band(bf16):
    _, ref, params, port, data = bf16
    loss, grads = port_grads(port, data[0])
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
    r_loss, r_grads = ref_grads(ref, params, data[0])
    assert rel(float(loss), float(r_loss)) <= BF16_LOSS_REL
    assert_grads(grads, r_grads, BF16_GRAD_OF_MAX)
    got, want, _, state = run_both(ref, params, build("bfloat16")[3], data, **TC)
    assert state.opt.mu["embed.weight"].dtype == torch.bfloat16  # opt_m_dtype
    for g, w in zip(got, want):
        assert rel(g["loss"], w["loss"]) <= BF16_STEP_LOSS_REL, (g, w)
        assert rel(g["grad_norm"], w["grad_norm"]) <= BF16_GNORM_REL, (g, w)
        assert rel(g["lr"], w["lr"]) <= METRIC_REL


def test_microbatches_match_reference(f32):
    """microbatches=2: each half's gradients summed in float32 and halved,
    the loss the halves' mean, no loss parts, as the reference's."""
    _, ref, params, _, data = f32
    got, want, _, _ = run_both(ref, params, build()[3], data[:2], microbatches=2, **TC)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "grad_norm", "lr"}
        for k in g:
            assert rel(g[k], w[k]) <= METRIC_REL, (k, g[k], w[k])


def test_chunked_cross_entropy_under_autograd_matches_reference(f32, monkeypatch):
    """Several checkpointed chunks and a remainder (VOCAB_CHUNK 12 on 31
    shifted positions, on both sides): the loss and every gradient as the
    reference's, and the same as in one chunk."""
    _, ref, params, port, data = f32
    whole_loss, whole = port_grads(port, data[0])
    monkeypatch.setattr(backbone, "VOCAB_CHUNK", 12)
    monkeypatch.setattr(ref_backbone, "VOCAB_CHUNK", 12)
    loss, grads = port_grads(port, data[0])
    r_loss, r_grads = ref_grads(RefModel(ref.cfg), params, data[0])
    assert rel(float(loss), float(r_loss)) <= LOSS_REL
    assert_grads(grads, r_grads, GRAD_OF_MAX)
    assert rel(float(loss), float(whole_loss)) <= LOSS_REL
    assert_grads(grads, whole, GRAD_OF_MAX)


def test_loss_follows_grad_mode(f32):
    _, _, _, port, data = f32
    with torch.no_grad():
        loss, parts = port.loss(t_(data[0]))
    assert loss.grad_fn is None and not loss.requires_grad
    loss, parts = port.loss(t_(data[0]))
    assert loss.requires_grad and parts["ce"].requires_grad


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-2b", "hubert-xlarge"])
@pytest.mark.parametrize("seed,host", [(0, (0, 1)), (3, (0, 2)), (3, (1, 2))])
def test_lm_pipeline_bitwise_reference(arch, seed, host):
    """Every batch of every (seed, index, host slice) bitwise the
    reference's: tokens and labels, patches (vlm), frames (audio)."""
    host_id, num_hosts = host
    cfg, ref_cfg = get_arch(arch, reduced=True), ref_get_arch(arch, reduced=True)
    ours = LMDataPipeline(cfg, batch=4, seq=24, seed=seed, host_id=host_id, num_hosts=num_hosts)
    theirs = RefLMDataPipeline(ref_cfg, batch=4, seq=24, seed=seed, host_id=host_id,
                               num_hosts=num_hosts)
    for index in (0, 1, 7):
        a, b = ours.make_batch(index), theirs.make_batch(index)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, index)
    it, ref_it = iter(ours), iter(theirs)
    for _ in range(3):  # the cursor moves on as the next batch is asked for
        x, y = next(it), next(ref_it)
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert ours.state_dict() == theirs.state_dict() == {"next_index": 2, "seed": seed}
    fresh = LMDataPipeline(cfg, batch=4, seq=24, host_id=host_id, num_hosts=num_hosts)
    fresh.load_state_dict(ours.state_dict())
    assert np.array_equal(fresh.make_batch(fresh.next_index)["labels"], x["labels"])


def test_trace_pipeline_bitwise_reference():
    rng = np.random.default_rng(4)
    inputs = {"opcode": rng.integers(0, 50, (20, 9)).astype(np.int32),
              "regbits": rng.random((20, 9, 8)).astype(np.float32)}
    labels = {"fetch": rng.random((20, 9)).astype(np.float32)}
    ours = TraceDataPipeline(WindowDataset(inputs, labels), batch=6, seed=2)
    theirs = RefTraceDataPipeline(RefWindowDataset(inputs, labels), batch=6, seed=2)
    for index in (0, 5):
        a, b = ours.make_batch(index), theirs.make_batch(index)
        assert np.array_equal(a["opcode"], b["opcode"]) and np.array_equal(a["regbits"], b["regbits"])
        assert np.array_equal(a["labels"]["fetch"], b["labels"]["fetch"])
    it = iter(ours)
    next(it), next(it)
    assert ours.state_dict() == {"next_index": 1, "seed": 2}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-2b", "hubert-xlarge"])
def test_batch_specs_and_axes_match_reference(arch):
    cfg, ref_cfg = get_arch(arch, reduced=True), ref_get_arch(arch, reduced=True)
    ours, theirs = make_lm_batch_specs(cfg, 4, 16), ref_make_lm_batch_specs(ref_cfg, 4, 16)
    assert sorted(ours) == sorted(theirs)
    for k, (shape, dtype) in ours.items():
        assert shape == theirs[k].shape and str(dtype).replace("torch.", "") == str(theirs[k].dtype)
    model = Model(cfg, device="cpu")
    assert batch_axes(model) == ref_trainer.batch_axes(RefModel(ref_cfg))


def test_state_axes_and_shardings_raise(f32):
    port = f32[3]
    with pytest.raises(NotImplementedError, match="A.14"):
        state_axes(port)
    with pytest.raises(NotImplementedError, match="A.14"):
        state_shardings(port, init_state(port, TrainConfig()), None)


def test_resume_after_checkpoint_equals_uninterrupted_run(tmp_path):
    """Four steps straight, against two steps, a checkpoint (state and
    the pipeline's cursor), a restore into a fresh Model and two more:
    the last loss and every parameter bitwise the same."""
    cfg = get_arch(ARCH, reduced=True)
    tcfg = TrainConfig(lr=1e-3, total_steps=10, warmup_steps=1)

    def fresh():
        model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        return init_state(model, tcfg), make_train_step(model, tcfg)

    def run(state, step, start, n, pipe):
        m = None
        for i in range(start, start + n):
            state, m = step(state, t_(pipe.make_batch(i)))
        return state, m

    pipe = LMDataPipeline(cfg, batch=4, seq=32, seed=1)
    ref_state_, ref_m = run(*fresh(), 0, 4, pipe)

    s1, step1 = fresh()
    s1, _ = run(s1, step1, 0, 2, pipe)
    mgr = CheckpointManager(str(tmp_path), use_async=False)
    mgr.save(s1, 2, extra={"data": {"next_index": 2, "seed": 1}})
    s2, step2 = fresh()
    restored, extra = mgr.restore_latest(s2)
    s2 = restore_into(s2, restored)
    assert extra["step"] == 2 and int(s2.step) == 2
    pipe2 = LMDataPipeline(cfg, batch=4, seq=32)
    pipe2.load_state_dict(extra["data"])
    s2, m2 = run(s2, step2, pipe2.next_index, 2, pipe2)
    assert torch.equal(m2["loss"], ref_m["loss"])
    for name, p in s2.params.items():
        assert torch.equal(p, ref_state_.params[name]), name
    mgr.close()


def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` in a subprocess:
    3 steps with a checkpoint at step 2; then the same flags (in this
    process) resume from it and run step 2 again, to the same logged loss;
    ``--mesh`` is refused."""
    flags = ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    first = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *flags],
                           capture_output=True, text=True, env=env, timeout=300, check=True)
    lines = first.stdout.splitlines()
    assert lines[0].startswith("step     0 loss ") and lines[1].startswith("step     2 loss ")
    assert lines[-1].startswith("trained 3 steps in ")
    assert sorted(os.listdir(tmp_path)) == ["step_2"]
    capsys.readouterr()
    out = launch_train.run(launch_train.build_parser().parse_args(flags))
    again = capsys.readouterr().out.splitlines()
    assert again[0] == "[resume] from step 2"
    assert again[1] == lines[1]
    assert again[-1].startswith("trained 1 steps in ")
    assert out["start_step"] == 2 and out["steps_run"] == 1 and int(out["state"].step) == 3
    with pytest.raises(NotImplementedError, match="A.14"):
        launch_train.run(launch_train.build_parser().parse_args(["--device", "cpu", "--mesh", "data=2"]))
