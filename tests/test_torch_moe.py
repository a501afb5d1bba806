"""The port's ``moe`` family against the reference's, on the CPU.

``qwen3-moe-235b-a22b`` (GQA, QK-norm, a MoE MLP in every layer, no
shared experts) and ``deepseek-v2-lite-16b`` (MLA attention, one dense
first layer in ``dense_layers``, MoE layers with two shared experts),
reduced by the reference's rules (4 layers, d_model 64, 8 experts, top-2,
expert d_ff 64, capacity_factor 8.0 (dropless), MLA ranks 32 / 16 / 8 /
16, float32).  The reference initializes the weights with ``jax.random``
and they cross as NumPy through ``convert.lm_params_from_jax``; the same
NumPy-seeded inputs go through both sides, each side its own copy.

What decides which slots a group keeps is held bitwise: the routing's
expert ids (ties to the lower expert, on constructed ties), and the
dispatch's ``rows`` / ``cols`` / ``keep`` / ``token_idx`` / ``order``,
on cases that drop (``capacity_factor`` below 1, with the token count a
multiple of the 16 groups and not).  Tolerances: the routing weights and
both aux losses within 1e-6 (float32 softmax and means in another sum
order); the dispatch buffer bitwise (copies); everything else within
atol = rtol = 2e-4 as in ``tests/test_torch_dense.py`` (float32 on both
sides; matmul, reduction and softmax order, the combine's sum over k in
slot order where the reference scatter-adds in expert order, ``cos`` /
``sin`` and rsqrt, over four layers and a 512-way head).  ``flash_ref``
in bfloat16 within 2^-7 of the largest |v| (both round the scores and P
to bfloat16; a product's sum order may put a rounding on the other side).
The reference runs its default path and, for qwen3-moe, its Pallas kernel
(``use_pallas=True``, interpret mode).  The reference's own smoke cases
(``tests/test_models_smoke.py``) run on the port, its handoff within 2e-3.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.backbone import Model as RefModel  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import MLA, Model, MoE, flash_ref  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from test_torch_dense import assert_cache, build, close, j_, np_, pad_seq, t_  # noqa: E402

QWEN3, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"
MOE = (QWEN3, DEEPSEEK)
B, S = 2, 48
ROUTE_TOL = 1e-6
HANDOFF_TOL = 2e-3  # the reference's test_prefill_matches_decode


def rng(seed):
    return np.random.default_rng(seed)


def tokens(seed, shape=(B, S)):
    return rng(seed).integers(0, 512, shape).astype(np.int32)


def configs(arch, **moe_changes):
    """The reference's and the port's reduced configs, with the same
    changes to their MoE fields."""
    ref_cfg, cfg = ref_get_arch(arch, reduced=True), get_arch(arch, reduced=True)
    return (dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_changes)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes)))


def sub_state(tree, node):
    """The reference's params of one module, crossed as the port's state dict."""
    sd = lm_params_from_jax({node: jax.tree.map(np.asarray, tree)})
    return {k.removeprefix(node + "."): v for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def built(arch):
    """``build(arch)``, once per module: the tests share the weights and
    write only the caches they make."""
    return build(arch)


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    return built(request.param)


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------


def tied_logits():
    """Rows whose top k include exact ties, across the k boundary too."""
    E = 8
    rows = [np.zeros(E), [1.0, 3.0, 3.0, 3.0, 0.0, 0.0, 3.0, 0.0],
            [2.0, 2.0, 5.0, 2.0, 2.0, 5.0, 2.0, 2.0], [0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0],
            -np.arange(E, dtype=float)[::-1], np.full(E, -7.5)]
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_route_matches_reference(case, top_k):
    ref_cfg, cfg = configs(DEEPSEEK, top_k=top_k)
    if case == "ties":
        logits = tied_logits()
    else:
        logits = (2.0 * rng(1).standard_normal((96, cfg.moe.num_experts))).astype(np.float32)
    w, ids, aux = port_moe.route(t_(logits), cfg.moe)
    r_w, r_ids, r_aux = ref_moe._route(j_(logits), ref_cfg.moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    close(w, r_w, ROUTE_TOL)
    for name in ("load_balance", "router_z"):
        close(aux[name], r_aux[name], ROUTE_TOL)
    if case == "ties":  # ties go to the lower expert, in lax.top_k's order
        want = [np.argsort(-row, kind="stable")[:top_k] for row in logits]
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want))


def dispatch_case(T, capacity_factor, seed):
    """Routed tokens of one layer: (port MoE config, reference's, xt (T, d),
    weights, ids, G, C)."""
    ref_cfg, cfg = configs(QWEN3, capacity_factor=capacity_factor)
    r = rng(seed)
    logits = r.standard_normal((T, cfg.moe.num_experts)).astype(np.float32)
    w, ids, _ = ref_moe._route(j_(logits), ref_cfg.moe)
    xt = r.standard_normal((T, cfg.d_model)).astype(np.float32)
    G, C = port_moe.capacity(cfg.moe, T)
    return cfg, ref_cfg, xt, np.asarray(w), np.asarray(ids), G, C


@pytest.mark.parametrize("T,capacity_factor", [(64, 0.5), (50, 0.5), (96, 1.25), (50, 8.0)])
def test_dispatch_and_combine_match_reference(T, capacity_factor):
    """``capacity_factor`` 0.5 drops slots both where the 16 groups divide T
    (64 tokens) and where one group takes all (50); 8.0 drops none."""
    cfg, _, xt, w, ids, G, C = dispatch_case(T, capacity_factor, seed=T)
    E, k, d, Tg = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model, T // G
    assert (G, C) == ((16 if T % 16 == 0 else 1),
                      max(1, int(capacity_factor * Tg * k / E)))
    disp = jax.vmap(functools.partial(ref_moe._dispatch_group, E=E, k=k, C=C, cd=jnp.float32))
    r_buf, r_meta = disp(j_(xt.reshape(G, Tg, d)), j_(w.reshape(G, Tg, k)),
                         j_(ids.reshape(G, Tg, k)))
    meta = port_moe.dispatch_meta(t_(ids).view(G, Tg, k), E, C)
    for name, got, want in zip(("rows", "cols", "keep", "token_idx", "order"), meta, r_meta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    kept = float(meta[2].float().mean())
    assert kept == 1.0 if capacity_factor >= E / k else kept < 1.0
    buf = port_moe.dispatch(t_(xt).view(G, Tg, d), meta, E, C)
    np.testing.assert_array_equal(buf.view(E, G, C, d).permute(1, 0, 2, 3).numpy(), np.asarray(r_buf))

    y = rng(T + 1).standard_normal((G, E, C, d)).astype(np.float32)
    comb = jax.vmap(functools.partial(ref_moe._combine_group, E=E, k=k, cd=jnp.float32, Tg=Tg, d=d))
    want = comb(j_(y), r_meta, j_(w.reshape(G, Tg, k)))
    y_port = t_(y).permute(1, 0, 2, 3).reshape(E, G * C, d)
    close(port_moe.combine(y_port, meta, t_(w).view(G, Tg, k), C), want)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("seq", [32, 25])
def test_moe_forward_matches_reference(arch, capacity_factor, seq):
    """With (deepseek) and without (qwen3) shared experts; dropless and
    dropping; 64 tokens (16 groups) and 50 (one)."""
    ref_cfg, cfg = configs(arch, capacity_factor=capacity_factor)
    params = ref_moe.init_moe(jax.random.PRNGKey(3), ref_cfg)
    moe = MoE(cfg, torch.Generator().manual_seed(0), device="cpu")
    moe.load_state_dict(sub_state(params, "moe"))
    assert moe.router.dtype == torch.float32 and hasattr(moe, "shared") == (arch == DEEPSEEK)
    x = rng(4).standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, aux = moe(t_(x))
    r_out, r_aux = jax.jit(functools.partial(ref_moe.moe_forward, cfg=ref_cfg))(params, j_(x))
    close(out, r_out)
    for name in ("load_balance", "router_z"):
        close(aux[name], r_aux[name], ROUTE_TOL)


def test_router_stays_float32_in_a_bfloat16_model():
    cfg = dataclasses.replace(get_arch(QWEN3, reduced=True), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    moe = MoE(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert moe.router.dtype == torch.float32 and moe.w_gate.dtype == torch.bfloat16
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.no_grad():
        out, aux = moe(x)
    assert out.dtype == torch.bfloat16
    assert aux["load_balance"].dtype == aux["router_z"].dtype == torch.float32


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def mla_pair():
    ref_cfg, cfg = ref_get_arch(DEEPSEEK, reduced=True), get_arch(DEEPSEEK, reduced=True)
    params = ref_attention.init_mla(jax.random.PRNGKey(5), ref_cfg)
    mla = MLA(cfg, torch.Generator().manual_seed(0), device="cpu")
    mla.load_state_dict(sub_state(params, "attn"))
    return ref_cfg, params, cfg, mla


def test_mla_forward_and_decode_match_reference():
    ref_cfg, params, cfg, mla = mla_pair()
    x = rng(6).standard_normal((B, 21, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32)[None], (B, 21))
    with torch.no_grad():
        out, (c_kv, k_rope) = mla(t_(x[:, :20]), t_(pos[:, :20]), return_kv=True)
    forward = jax.jit(functools.partial(ref_attention.mla_forward, cfg=ref_cfg, return_kv=True))
    r_out, (r_c, r_kr) = forward(params, j_(x[:, :20]), positions=j_(pos[:, :20]))
    assert tuple(c_kv.shape) == (B, 20, cfg.mla.kv_lora_rank)
    assert tuple(k_rope.shape) == (B, 20, cfg.mla.qk_rope_head_dim)
    for got, want in ((out, r_out), (c_kv, r_c), (k_rope, r_kr)):
        close(got, want)
    cache = {"c_kv": torch.cat([c_kv, torch.zeros_like(c_kv[:, :3])], 1),
             "k_rope": torch.cat([k_rope, torch.zeros_like(k_rope[:, :3])], 1)}
    r_cache = {k: j_(v.numpy()) for k, v in cache.items()}
    with torch.no_grad():
        dec, (c_row, kr_row) = mla.decode(t_(x[:, 20:]), cache, 20)
        full = mla(t_(x), t_(pos))
    decode = jax.jit(functools.partial(ref_attention.mla_decode, cfg=ref_cfg))
    r_dec, (r_c_row, r_kr_row) = decode(params, j_(x[:, 20:]), r_cache, jnp.int32(20))
    for got, want in ((dec, r_dec), (c_row, r_c_row), (kr_row, r_kr_row)):
        close(got, want)
    close(dec[:, 0], full[:, 20])  # the absorbed decode is the prefill's last row


@pytest.mark.parametrize("case", ["causal", "q_offset", "noncausal", "bfloat16"])
def test_flash_ref_matches_reference(case):
    """Dv != D, several query and key blocks with ragged ends; a causal
    case with q_offset (a continuation over a longer key sequence)."""
    Sq, Sk, off, causal, dtype = {"causal": (70, 70, 0, True, "float32"),
                                  "q_offset": (37, 90, 53, True, "float32"),
                                  "noncausal": (40, 75, 0, False, "float32"),
                                  "bfloat16": (70, 70, 0, True, "bfloat16")}[case]
    r = rng(7)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((2, 3, Sq, 24), (2, 3, Sk, 24), (2, 3, Sk, 16)))
    dt = getattr(torch, dtype)
    got = flash_ref(*(t_(a).to(dt) for a in (q, k, v)), causal=causal, q_offset=off,
                    block_q=16, block_k=32)
    want = ref_attention.flash_ref(*(j_(a).astype(dtype) for a in (q, k, v)), causal=causal,
                                   q_offset=off, block_q=16, block_k=32)
    assert got.shape == (2, 3, Sq, 16) and str(got.dtype).removeprefix("torch.") == str(want.dtype)
    close(np_(got), np.asarray(want).astype(np.float32), 2e-4 if dtype == "float32" else 2.0**-7)
    # the same function at the default 512-row blocks (one block here)
    close(np_(flash_ref(*(t_(a).to(dt) for a in (q, k, v)), causal=causal, q_offset=off)),
          np_(got), 2e-4 if dtype == "float32" else 2.0**-7)


# ---------------------------------------------------------------------------
# the model: prefill, decode, loss
# ---------------------------------------------------------------------------


def pad_ref(cache, n):
    return jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, n)] + [(0, 0)] * (a.ndim - 3)),
                        cache)


def test_prefill_and_two_decode_steps_match_reference(pair):
    (_, ref, params), (cfg, port) = pair
    toks = tokens(1, (B, S + 2))
    logits, cache = port.prefill(t_(toks[:, :S]))
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks[:, :S])})
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    assert sorted(cache) == (["c_kv", "k_rope"] if cfg.mla else ["k", "v"])
    close(logits, r_logits)
    assert_cache(cache, r_cache)
    cache, r_cache = pad_seq(cache, 2), pad_ref(r_cache, 2)
    step = jax.jit(ref.decode_step)
    for i in range(2):
        d, cache = port.decode_step(cache, t_(toks[:, S + i]), S + i)
        r_d, r_cache = step(params, r_cache, j_(toks[:, S + i]), jnp.int32(S + i))
        close(d, r_d)
        assert_cache(cache, r_cache)


def test_decode_from_init_cache_matches_reference(pair):
    """A zero cache from ``init_cache`` (bfloat16 on both sides), three steps
    from position 0.  A row rounded into the bfloat16 cache may land one
    ulp from the reference's (``assert_cache``), and the next step's logits
    would carry that (~1e-3 here on qwen3-moe, whose QK-normed k is of
    order 1), so each step starts from the reference's cache, bitwise."""
    (_, ref, params), (_, port) = pair
    toks = tokens(2, (B, 3))
    cache, r_cache = port.init_cache(B, 8), ref.init_cache(B, 8)
    assert_cache(cache, r_cache)
    step = jax.jit(ref.decode_step)
    for i in range(3):
        d, cache = port.decode_step(cache, t_(toks[:, i]), i)
        r_d, r_cache = step(params, r_cache, j_(toks[:, i]), jnp.int32(i))
        close(d, r_d)
        assert_cache(cache, r_cache)
        for k, v in cache.items():
            v.copy_(t_(np.asarray(r_cache[k]).astype(np.float32)))


def test_loss_matches_reference_ce_and_aux_apart(pair):
    (_, ref, params), (_, port) = pair
    toks = tokens(3)
    labels = toks.copy()
    labels[0, :5] = -1  # masked positions
    with torch.no_grad():  # the value only
        loss, metrics = port.loss({"tokens": t_(toks), "labels": t_(labels)})
    r_loss, r_metrics = jax.jit(ref.loss)(params, {"tokens": j_(toks), "labels": j_(labels)})
    close(metrics["ce"], r_metrics["ce"])
    close(metrics["aux"], r_metrics["aux"], ROUTE_TOL)
    close(loss, r_loss)
    assert float(metrics["aux"]) > 0 and metrics["aux"].dtype == torch.float32


@pytest.mark.parametrize("arch", MOE)
def test_model_with_dropping_capacity_matches_reference(arch):
    """capacity_factor 0.5: the prefill drops slots in every MoE layer, on
    both sides alike."""
    ref_cfg, cfg = configs(arch, capacity_factor=0.5)
    ref = RefModel(ref_cfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    port = Model(cfg, device="cpu")
    port.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params)))
    toks = tokens(4)
    logits, cache = port.prefill(t_(toks))
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks)})
    close(logits, r_logits)
    assert_cache(cache, r_cache)
    with torch.no_grad():  # the value only
        loss, metrics = port.loss({"tokens": t_(toks), "labels": t_(toks)})
    r_loss, r_metrics = jax.jit(ref.loss)(params, {"tokens": j_(toks), "labels": j_(toks)})
    close(loss, r_loss)
    close(metrics["aux"], r_metrics["aux"], ROUTE_TOL)


@pytest.mark.parametrize("entry", ["prefill", "loss"])
def test_qwen3_moe_matches_the_reference_pallas_kernel(entry):
    """``use_pallas=True`` on the reference side: its Pallas attention kernel
    in interpret mode (GQA 2:1 after QK-norm at this width), which the
    port's B4 (here its plain version) ports."""
    (ref_cfg, _, params), (_, port) = built(QWEN3)
    ref = RefModel(dataclasses.replace(ref_cfg, use_pallas=True))
    toks = tokens(5)
    if entry == "prefill":
        logits, cache = port.prefill(t_(toks))
        r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks)})
        close(logits, r_logits)
        assert_cache(cache, r_cache)
    else:
        with torch.no_grad():  # the value only
            loss, _ = port.loss({"tokens": t_(toks), "labels": t_(toks)})
        r_loss, _ = jax.jit(ref.loss)(params, {"tokens": j_(toks), "labels": j_(toks)})
        close(loss, r_loss)


def test_int8_kv_cache_dtype_gives_a_bfloat16_mla_cache():
    (_, ref, _), (_, port) = build(DEEPSEEK, kv_cache_dtype="int8")
    cache, r_cache = port.init_cache(B, 8), ref.init_cache(B, 8)
    assert sorted(cache) == ["c_kv", "k_rope"]
    assert_cache(cache, r_cache)
    assert cache["c_kv"].dtype == torch.bfloat16


@pytest.mark.parametrize("pos", [S, S + 5])
def test_mla_decode_past_the_cache_end_leaves_it_unchanged(pos):
    (_, ref, params), (_, port) = built(DEEPSEEK)
    toks = tokens(6, (B, S + 1))
    _, cache = port.prefill(t_(toks[:, :S]))
    _, r_cache = jax.jit(ref.prefill)(params, {"tokens": j_(toks[:, :S])})
    before = {k: v.clone() for k, v in cache.items()}
    d, after = port.decode_step(cache, t_(toks[:, S]), pos)
    r_d, _ = jax.jit(ref.decode_step)(params, r_cache, j_(toks[:, S]), jnp.int32(pos))
    close(d, r_d)
    for k in before:
        assert torch.equal(after[k], before[k]), k


# ---------------------------------------------------------------------------
# weights, layers, entry points
# ---------------------------------------------------------------------------


def test_lm_params_from_jax_loads_a_deepseek_tree():
    """The MLA ``attn`` keeps its leaves (no packed ``qkv``), the MoE leaves
    keep their names and layout, the shared experts map as an MLP, and the
    dense first layer unstacks into ``dense_layers``."""
    ref = RefModel(ref_get_arch(DEEPSEEK, reduced=True))
    params = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.PRNGKey(0)))
    sd = lm_params_from_jax(params)
    cfg = get_arch(DEEPSEEK, reduced=True)
    m, E = cfg.moe, cfg.moe.num_experts
    assert sd["layers.0.moe.router"].shape == (cfg.d_model, E)
    assert sd["layers.2.moe.w_gate"].shape == (E, cfg.d_model, m.d_ff_expert)
    assert sd["layers.2.moe.w_down"].shape == (E, m.d_ff_expert, cfg.d_model)
    np.testing.assert_array_equal(sd["layers.1.moe.w_up"].numpy(), params["layers"]["moe"]["w_up"][1])
    np.testing.assert_array_equal(sd["layers.0.moe.shared.w_gate.weight"].numpy(),
                                  params["layers"]["moe"]["shared"]["w_gate"][0].T)
    np.testing.assert_array_equal(sd["dense_layers.0.mlp.w_down.weight"].numpy(),
                                  params["dense_layers"]["mlp"]["w_down"][0].T)
    np.testing.assert_array_equal(sd["dense_layers.0.attn.w_uk"].numpy(),
                                  params["dense_layers"]["attn"]["w_uk"][0])
    assert "layers.0.attn.kv_norm.weight" in sd and not any(".qkv." in k for k in sd)
    port = Model(cfg, device="cpu")
    assert sorted(port.state_dict()) == sorted(sd)
    port.load_state_dict(sd)
    assert len(port.dense_layers) == 1 and len(port.layers) == cfg.n_layers - 1
    assert hasattr(port.dense_layers[0], "mlp") and all(hasattr(layer, "moe") for layer in port.layers)


@pytest.mark.parametrize("arch", MOE)
def test_full_width_model_raises_without_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_arch(arch))


# ---------------------------------------------------------------------------
# the reference's smoke cases (tests/test_models_smoke.py), on the port
# ---------------------------------------------------------------------------


def smoke_model(arch):
    return Model(get_arch(arch, reduced=True), device="cpu")


def smoke_batch(cfg, B=2, S=32):
    """``tests/test_models_smoke.py::_batch``, as torch tensors."""
    return {"tokens": t_(rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)),
            "labels": t_(rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32))}


@pytest.mark.parametrize("arch", MOE)
def test_forward_loss_finite(arch):
    model = smoke_model(arch)
    with torch.no_grad():  # the value only
        loss, metrics = model.loss(smoke_batch(model.cfg))
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), arch
    assert float(loss) > 0 and float(metrics["aux"]) > 0


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_shapes(arch):
    model = smoke_model(arch)
    cache = model.init_cache(2, 64)
    logits, cache = model.decode_step(cache, torch.zeros(2, dtype=torch.int32), 0)
    logits, cache = model.decode_step(cache, torch.ones(2, dtype=torch.int32), 1)
    assert logits.shape == (2, model.cfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_equals_longer_prefill(arch):
    """prefill(p ⧺ t) == prefill(p) + decode_step(t) at position len(p)
    (the reference's handoff test, within its 2e-3; dropless at the
    reduced capacity_factor 8.0)."""
    model = smoke_model(arch)
    P = 16
    toks = t_(tokens(14, (1, P + 1)))
    full, _ = model.prefill(toks)
    _, cache = model.prefill(toks[:, :P])
    dec, _ = model.decode_step(pad_seq(cache, 1), toks[:, P], P)
    np.testing.assert_allclose(dec[0].numpy(), full[0].numpy(), atol=HANDOFF_TOL, rtol=HANDOFF_TOL)
