"""The port's LLM trainer over the other families, against the reference's,
on the CPU.

At each family's reduced config (float32, 4 layers, d_model 64, vocab
512): ``qwen3-moe-235b-a22b`` (MoE with QK-norm, GQA), ``recurrentgemma-9b``
(RG-LRU units and local attention), ``deepseek-v2-lite-16b`` (MLA, MoE, a
dense first layer), ``qwen2-vl-2b`` (M-RoPE, patches over the first
positions), ``hubert-xlarge`` (a bidirectional encoder over frames) and
``mamba2-1.3b`` (the SSD scan, whose gradient on the CPU is autograd's
through the plain chunked version, as the reference's is jax.grad's through
its own).
The reference initializes the weights, which cross through
``convert.lm_params_from_jax`` with its gradient tree; the batch is one of
``LMDataPipeline``'s (NumPy), the same for both.

Band: the loss and its parts within 1e-5 relative, and every gradient leaf
within 1e-4 of the leaf's largest |g| (measured: losses within 5e-7
relative, gradients within 5.1e-6 of the largest: matmul and reduction
order; the MoE routing ids, and so the routed tokens, are the same).  Then,
as the reference's ``tests/test_models_smoke.py::test_train_step_improves``
asks of its trainer, six steps of the port's at lr 5e-3 lower the loss.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.data.pipeline import LMDataPipeline as RefLMDataPipeline  # noqa: E402
from repro.models.backbone import Model as RefModel  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import TrainConfig, init_state, make_train_step  # noqa: E402

FAMILIES = ("qwen3-moe-235b-a22b", "recurrentgemma-9b", "deepseek-v2-lite-16b", "qwen2-vl-2b",
            "hubert-xlarge", "mamba2-1.3b")
LOSS_REL = 1e-5
GRAD_OF_MAX = 1e-4


def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    ref_cfg = ref_get_arch(arch, reduced=True)
    ref = RefModel(ref_cfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    port = Model(get_arch(arch, reduced=True), device="cpu")
    port.load_state_dict(lm_params_from_jax(np32(params)))
    batch = RefLMDataPipeline(ref_cfg, batch=2, seq=32, seed=1).make_batch(0)
    (r_loss, r_parts), r_grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    named = dict(port.named_parameters())
    loss, parts = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    # an encoder's embedding table takes no part (its gradient is 0, as the
    # reference's)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        named.values(), torch.autograd.grad(loss, list(named.values()), allow_unused=True))]
    loss = loss.detach()
    for a, b in ((loss, r_loss), *((parts[k], r_parts[k]) for k in ("ce", "aux"))):
        assert abs(float(a) - float(b)) <= LOSS_REL * max(abs(float(b)), 1.0), (float(a), float(b))
    want = lm_params_from_jax(np32(r_grads))
    assert set(want) == set(named)
    for name, g in zip(named, grads):
        r = want[name]
        err = float((g - r).abs().max())
        assert err <= GRAD_OF_MAX * float(r.abs().max()), (name, err, float(r.abs().max()))


def smoke_batch(cfg, B=2, S=32):
    """The reference smoke test's batch: random tokens (seed 0) and labels
    (seed 1); for audio random frames and zero labels; for vlm patches."""
    if cfg.family == "audio":
        return {"frames": torch.from_numpy(np.random.default_rng(0).normal(
                    size=(B, S, cfg.frontend_dim)).astype(np.float32)),
                "labels": torch.zeros((B, S), dtype=torch.int64)}
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S))),
             "labels": torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(np.random.default_rng(2).normal(
            size=(B, cfg.vision_patches, cfg.frontend_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_improves(arch):
    cfg = get_arch(arch, reduced=True)
    model = Model(cfg, device="cpu")
    tcfg = TrainConfig(lr=5e-3, total_steps=10, warmup_steps=1)
    state, step = init_state(model, tcfg), make_train_step(model, tcfg)
    batch = smoke_batch(cfg)
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1]), arch
    assert losses[-1] < losses[0], (arch, losses)
    assert int(state.step) == 6

