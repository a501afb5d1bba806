"""The port's memory policies against the reference's, on the CPU:
``ArchConfig.remat`` (``models/backbone.py::_remat``) and
``ArchConfig.prefill_chunks`` (``Model.prefill``).

Reduced configs (float32, the reference's smoke sizes), batches from
``LMDataPipeline`` (NumPy, seeded).

  * "full" and "dots" change what the backward keeps, never a value: for
    seven architectures (dense, vlm, audio, moe, MLA with a dense first
    layer, ssm, hybrid units and tail) the loss and every gradient under
    each are BITWISE those under "none".  That the layers were recomputed
    is counted: each layer's mixer (attention, Mamba-2, RG-LRU) starts
    twice under "full" and "dots", once under "none"; and "dots" keeps the
    products without a batch dimension: the backward runs as many
    ``aten.mm`` / ``aten.addmm`` under "dots" as under "none", more under
    "full".
  * The port under "full" against ``jax.grad`` of the reference's
    ``Model.loss`` under "full" (qwen2-0.5b, mamba2-1.3b,
    recurrentgemma-9b; weights crossed by ``convert.lm_params_from_jax``):
    the loss within 1e-5 relative, every gradient within
    ``tests/test_torch_lm_train.py``'s ``GRAD_OF_MAX`` (1e-4) of the
    leaf's largest |g|.
  * ``prefill_chunks=2`` against the reference's chunked prefill
    (qwen2-0.5b, qwen3-moe-235b-a22b, recurrentgemma-9b; 4 prompts of 24
    tokens, inside the hybrid window): the logits and every cache leaf
    within 2e-4 (``tests/test_torch_dense.py``'s ``TOL``), and the MoE's
    routing ids, layer by layer and chunk by chunk, bitwise: each chunk
    routes its own tokens, as the reference's does.
  * An unknown ``remat`` raises.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.models.moe as ref_moe  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.data.pipeline import LMDataPipeline as RefLMDataPipeline  # noqa: E402
from repro.models.backbone import Model as RefModel  # noqa: E402

import repro_torch.models.moe as port_moe  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import LMDataPipeline  # noqa: E402
from repro_torch.models import MLA, Attention, Mamba2, Model  # noqa: E402
from repro_torch.models.rglru import RGLRU  # noqa: E402
from test_torch_dense import assert_cache, close  # noqa: E402
from test_torch_lm_train import GRAD_OF_MAX, LOSS_REL  # noqa: E402

BITWISE = ("qwen2-0.5b", "qwen2-vl-2b", "hubert-xlarge", "qwen3-moe-235b-a22b",
           "deepseek-v2-lite-16b", "mamba2-1.3b", "recurrentgemma-9b")
AGAINST_REFERENCE = ("qwen2-0.5b", "mamba2-1.3b", "recurrentgemma-9b")
CHUNKED = ("qwen2-0.5b", "qwen3-moe-235b-a22b", "recurrentgemma-9b")
MIXERS = (Attention, MLA, Mamba2, RGLRU)
SAVED_BY_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
B, S = 2, 32
PROMPTS, PROMPT = 4, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The models are tiny: one intra-op thread runs them faster than a
    pool that shares the machine with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def loss_and_grads(model, batch):
    named = dict(model.named_parameters())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    # an encoder's embedding table takes no part
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(named.values(), grads)]


class CountProducts(TorchDispatchMode):
    """Counts the products "dots" keeps among the ops it sees."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in SAVED_BY_DOTS
        return func(*args, **(kwargs or {}))


def run_mode(model, batch, remat):
    """(loss, gradients, mixer calls, products in the backward) under
    ``remat``."""
    model.cfg = dataclasses.replace(model.cfg, remat=remat)
    calls = [0]
    mixers = [m for m in model.modules() if isinstance(m, MIXERS)]
    hooks = [m.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
             for m in mixers]
    try:
        named = dict(model.named_parameters())
        loss, _ = model.loss(batch)
        with CountProducts() as products:
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    finally:
        for h in hooks:
            h.remove()
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(named.values(), grads)]
    return loss.detach(), grads, calls[0] // len(mixers), products.n


@pytest.mark.parametrize("arch", BITWISE)
def test_full_and_dots_are_bitwise_none(arch):
    cfg = get_arch(arch, reduced=True)
    assert cfg.remat == "none"
    model = Model(cfg, device="cpu")
    batch = as_tensors(LMDataPipeline(cfg, B, S, seed=1).make_batch(0))
    runs = {mode: run_mode(model, batch, mode) for mode in ("none", "full", "dots")}
    loss, grads, calls, products = runs["none"]
    assert calls == 1
    for mode in ("full", "dots"):
        m_loss, m_grads, m_calls, m_products = runs[mode]
        assert torch.equal(m_loss, loss), mode
        assert len(m_grads) == len(grads)
        for name, a, b in zip(dict(model.named_parameters()), m_grads, grads):
            assert torch.equal(a, b), (mode, name)
        assert m_calls == 2, mode  # each mixer ran again in the backward
        # "dots" recomputes no product it kept; "full" recomputes them all
        assert m_products == products if mode == "dots" else m_products > products, (
            mode, m_products, products)


def test_unknown_remat_raises():
    cfg = get_arch("qwen2-0.5b")
    assert cfg.remat == "full" and cfg.prefill_chunks == 1
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(cfg, remat="offload")


# both packages' configs under both policies: remat acts only under grad,
# prefill_chunks only in prefill, so one pair serves both kinds of test
POLICIES = {"remat": "full", "prefill_chunks": 2}


@functools.lru_cache(maxsize=None)
def reference_pair(arch):
    """(reference cfg, Model, params), port Model on the same weights, both
    configs under ``POLICIES``; built once per module."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch, reduced=True), **POLICIES)
    ref = RefModel(ref_cfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    port = Model(dataclasses.replace(get_arch(arch, reduced=True), **POLICIES), device="cpu")
    port.load_state_dict(lm_params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                         params)))
    return (ref_cfg, ref, params), port


@pytest.mark.parametrize("arch", AGAINST_REFERENCE)
def test_full_remat_gradients_match_reference(arch):
    (ref_cfg, ref, params), port = reference_pair(arch)
    batch = RefLMDataPipeline(ref_cfg, batch=B, seq=S, seed=1).make_batch(0)
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(port, as_tensors(batch))
    assert abs(float(loss) - float(r_loss)) <= LOSS_REL * abs(float(r_loss))
    want = lm_params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), r_grads))
    named = dict(port.named_parameters())
    assert set(want) == set(named)
    for name, g in zip(named, grads):
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_OF_MAX * float(want[name].abs().max()), (name, err)


def record_routing(monkeypatch):
    """Patch both packages' routing functions to record each call's expert
    ids in call order -> (the port's list, the reference's list)."""
    port_ids, ref_ids = [], []
    port_route, r_route = port_moe.route, ref_moe._route

    def port_recording(logits, m):
        out = port_route(logits, m)
        port_ids.append(out[1].numpy().copy())
        return out

    def ref_recording(logits, m):
        out = r_route(logits, m)
        jax.debug.callback(lambda ids: ref_ids.append(np.asarray(ids)), out[1], ordered=True)
        return out

    monkeypatch.setattr(port_moe, "route", port_recording)
    monkeypatch.setattr(ref_moe, "_route", ref_recording)
    return port_ids, ref_ids


@pytest.mark.parametrize("arch", CHUNKED)
def test_chunked_prefill_matches_reference(arch, monkeypatch):
    (ref_cfg, ref, params), port = reference_pair(arch)
    toks = np.random.default_rng(5).integers(0, ref_cfg.vocab, (PROMPTS, PROMPT)).astype(np.int32)
    port_ids, ref_ids = record_routing(monkeypatch)
    logits, cache = port.prefill(torch.from_numpy(toks))
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    assert logits.shape == (PROMPTS, ref_cfg.vocab)
    close(logits.numpy(), r_logits)
    if arch == "recurrentgemma-9b":
        assert sorted(cache) == sorted(r_cache)
        for k in cache:
            assert_cache(cache[k], r_cache[k])
    else:
        assert_cache(cache, r_cache)
    if ref_cfg.moe is None:
        assert port_ids == ref_ids == []
        return
    # each of the 2 chunks routes its own 2 x 24 tokens, layer by layer
    assert len(port_ids) == len(ref_ids) == 2 * ref_cfg.n_layers
    for got, want in zip(port_ids, ref_ids):
        assert got.shape == (PROMPTS // 2 * PROMPT, ref_cfg.moe.top_k)
        np.testing.assert_array_equal(got, want)
