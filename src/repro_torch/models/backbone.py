"""Language-model assembly and serving entry points, in PyTorch.

Counterpart of ``repro/models/backbone.py::Model`` for the ``ssm`` family
(a Mamba-2 stack), the ``dense`` family (a causal decoder), ``vlm`` (the
decoder with M-RoPE, its first positions' embeddings replaced by
projected image patches), ``audio`` (a bidirectional encoder over
projected frames, run through ``encode``), ``moe`` (the decoder with a
mixture-of-experts MLP, and MLA attention where ``cfg.mla``) and
``hybrid`` (RecurrentGemma: units of ``rec_per_unit`` RG-LRU layers and
one local-attention layer, then a tail of the remaining RG-LRU layers).
The stack is the embedding table, ``n_layers`` pre-norm residual
layers, ``final_norm`` and the head: the table itself when the
embeddings are tied, else ``lm_head``.  A config with a ``frontend`` also has ``frontend.proj``
(frontend_dim -> d_model, no bias), the modality stub's projection.  An
``ssm`` layer is ``ln`` + a ``Mamba2`` mixer; a decoder or encoder layer
``ln_attn`` + ``attn`` (``Attention``, or ``MLA`` when ``cfg.mla``) +
``ln_mlp`` + ``mlp`` (or ``moe``, a ``MoE``, in a ``moe`` model's layers),
its norms rmsnorm or layernorm by ``cfg.norm``, its attention
bidirectional when ``cfg.encoder_only``.  A ``moe`` config with
``first_dense_layers`` holds those layers, with a dense ``mlp``, in a
separate ``dense_layers`` list ahead of ``layers``, as the reference's
tree does.  A ``hybrid`` model's ``layers`` are its units, each
``recs`` (a list of recurrent layers: ``ln_mix`` + ``rec``, an ``RGLRU``,
+ ``ln_mlp`` + ``mlp``) and ``attn`` (a decoder layer whose attention
sees the last ``window`` positions), and ``tail`` the recurrent layers
past the last whole unit.  Where the reference scans stacked layer
params, the port runs ``nn.ModuleList``s eagerly; the caches keep the reference's stacked
layout so the two compare leaf by leaf: ``{"ssm": (L,B,H,N,P), "conv":
(L,B,K-1,C)}`` float32 for ``ssm``; ``{"k", "v"}`` (L,B,S,Hkv,hd) for
standard attention (plus ``k_scale`` / ``v_scale`` for an int8 cache),
``{"c_kv": (L,B,S,r), "k_rope": (L,B,S,rope)}`` for MLA, dense layers
first, in the compute dtype from ``prefill`` and in ``kv_cache_dtype``
from ``init_cache``; for ``hybrid`` ``{"attn": {"k", "v"} (U,B,W,Hkv,hd),
"rec": {"h": (R,B,w), "conv": (R,B,K-1,w)}}``, U units, W = min(length,
window) slots, the R recurrent layers' float32 states each unit's in
order, then the tail's.  The window cache is a ring: position p sits in
slot p mod W.  (The reference's prefill keeps the last ``window`` keys in
slots 0 … W-1 while its decode reads slot ``pos mod W``; the two agree
only when the prompt is at most the window or a multiple of it, and the
port keeps the ring throughout, so that prefill then decode equals the
prefill of the longer prompt.)  A decoder's ``decode_step`` writes its
rows (a hybrid's ring slot and recurrent states too) into the cache in
place and returns it: to decode n tokens after a prefill of S, copy its
cache into ``init_cache(B, S + n)``.  An encoder (``encoder_only``) has no
cache: ``prefill``, ``init_cache`` and ``decode_step`` refuse it, as the
reference routes its encoder only through ``encode``.  ``loss`` adds each
MoE layer's ``router_aux_weight · load_balance + router_z_weight ·
router_z`` to ``aux``.  The serving entry points (``prefill``,
``decode_step``, ``encode``) are forward only; ``loss`` follows the
caller's grad mode, as the reference's pure function does
(``train/trainer.py`` differentiates it; callers that only read its value
wrap it in ``torch.no_grad()``).  Under autograd each cross-entropy
chunk's logits are recomputed in the backward (``torch.utils.checkpoint``,
as the reference's ``@jax.checkpoint`` on ``ce_chunk``), so the float32
(B, chunk, V) logits and their gradient are live one chunk at a time.

Memory policies, the reference's.  ``cfg.remat`` sets what the layers keep
for the backward, at the reference's granularity (``_remat`` around each
scanned body: an ``ssm`` layer; a hybrid unit, its recurrent layers and
its attention together, then each tail layer; a decoder or encoder layer,
``dense_layers`` included, its MoE aux losses carried out): "none" keeps
every activation autograd saves; "full" keeps each layer's input and
recomputes the layer in the backward (a non-reentrant
``torch.utils.checkpoint``, so B4 and B5 launch twice a step: forward
and recomputation); "dots" keeps the outputs of products without a batch
dimension (``aten.mm`` / ``aten.addmm``, the torch reading of
``dots_with_no_batch_dims_saveable``) and recomputes the rest, the batched
products, the elementwise ops and the hand kernels included.  The values
are the same under all three, bitwise: only the memory and the work
differ.  Without grad no layer is checkpointed.  ``cfg.prefill_chunks``
= n > 1 with the batch a multiple of n prefills n slices of the batch one
after another (a vlm's patches cut with them) and concatenates the
logits and every cache leaf on its batch axis, as the reference's
``lax.map`` does; a MoE's dispatch groups then follow each slice's
tokens, as the reference's do.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from .. import resolve_device
from ..nn.core import LayerNorm, RMSNorm, trunc_normal_param
from .attention import (
    MLA,
    Attention,
    apply_kv_cache_update,
    apply_mla_cache_update,
    init_kv_cache,
    init_mla_cache,
)
from .config import ArchConfig
from .mamba2 import Mamba2, init_ssm_state
from .mlp import MLP
from .moe import MoE
from .rglru import RGLRU, init_rglru_state

__all__ = ["Model", "VOCAB_CHUNK"]

VOCAB_CHUNK = 2048  # logit/CE chunk along the sequence to bound live logits
FAMILIES = ("ssm", "dense", "vlm", "audio", "moe", "hybrid")


# the products "dots" keeps: those without a batch dimension
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """``fn`` under ``cfg.remat`` (module note): itself under "none" or
    without grad, else run through a non-reentrant checkpoint, selective
    under "dots"."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _DOTS_SAVED)
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False, **kw)


def _cat_batch(parts):
    """Prefill chunks' caches joined leaf by leaf on the batch axis (1, after
    the layers'), nested dicts included."""
    if isinstance(parts[0], dict):
        return {k: _cat_batch([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts, dim=1)


def _norm(cfg: ArchConfig, *, device) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, dtype=getattr(torch, cfg.param_dtype), device=device)


class SSMLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        self.ln = _norm(cfg, device=device)
        self.mixer = Mamba2(cfg, generator, device=device)


class DecoderLayer(nn.Module):
    """``ln_attn``, ``attn`` (``MLA`` when ``cfg.mla``, else ``Attention``),
    ``ln_mlp`` and ``moe`` (a ``MoE``) when ``moe``, else ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device, moe: bool = False):
        super().__init__()
        self.ln_attn = _norm(cfg, device=device)
        self.attn = (MLA if cfg.mla else Attention)(cfg, generator, device=device)
        self.ln_mlp = _norm(cfg, device=device)
        if moe:
            self.moe = MoE(cfg, generator, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, generator,
                           param_dtype=getattr(torch, cfg.param_dtype),
                           compute_dtype=getattr(torch, cfg.compute_dtype), device=device)

    def ffn(self, x: torch.Tensor):
        """The MLP half on the normalized ``x`` -> (out, the MoE's aux
        losses or None)."""
        if hasattr(self, "moe"):
            return self.moe(x)
        return self.mlp(x), None


class RecurrentLayer(nn.Module):
    """A hybrid model's recurrent layer: ``ln_mix``, ``rec`` (an ``RGLRU``),
    ``ln_mlp`` and ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        self.ln_mix = _norm(cfg, device=device)
        self.rec = RGLRU(cfg, generator, device=device)
        self.ln_mlp = _norm(cfg, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, generator,
                       param_dtype=getattr(torch, cfg.param_dtype),
                       compute_dtype=getattr(torch, cfg.compute_dtype), device=device)


class HybridUnit(nn.Module):
    """``recs`` (``rec_per_unit`` recurrent layers) and ``attn`` (one
    decoder layer, local attention), as the reference's unit holds them."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        self.recs = nn.ModuleList(RecurrentLayer(cfg, generator, device=device)
                                  for _ in range(cfg.hybrid.rec_per_unit))
        self.attn = DecoderLayer(cfg, generator, device=device)


class Frontend(nn.Module):
    """The modality stub: ``proj`` maps precomputed frame or patch
    embeddings (..., frontend_dim) to the model width, drawn as the
    reference draws it (std 1/sqrt(frontend_dim))."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        self.proj = nn.Linear(cfg.frontend_dim, cfg.d_model, bias=False, device="meta")
        self.proj.weight = trunc_normal_param((cfg.d_model, cfg.frontend_dim),
                                              1.0 / math.sqrt(cfg.frontend_dim), generator,
                                              device=device, dtype=getattr(torch, cfg.param_dtype))


class Model(nn.Module):
    """A language model of the ``ssm``, ``dense``, ``vlm``, ``audio``,
    ``moe`` or ``hybrid`` family: ``prefill`` / ``decode_step`` /
    ``init_cache`` for serving a decoder, ``encode`` for an encoder,
    ``loss`` (differentiable under grad mode).

    ``Model(cfg, device=None, generator=None)`` builds the parameters on
    ``device`` (``cuda`` by default; raises without it unless
    ``device="cpu"``) from ``generator`` (seed 0 on that device when
    None), with the reference's distributions.  ``device="meta"`` builds
    the shapes only, nothing allocated or drawn (the reference's
    ``jax.eval_shape(model.init, key)``).  Load the reference's
    weights with ``load_state_dict(convert.lm_params_from_jax(tree))``."""

    def __init__(
        self,
        cfg: ArchConfig,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r} (have {FAMILIES})")
        if cfg.family == "hybrid" and cfg.hybrid.attn_per_unit != 1:
            raise NotImplementedError(
                f"{cfg.name}: a hybrid unit holds one attention layer, as the reference's "
                f"does; attn_per_unit={cfg.hybrid.attn_per_unit}"
            )
        dev = resolve_device(device)
        # on ``meta`` the parameters are shapes only: nothing is drawn
        g = (generator if generator is not None or dev.type == "meta"
             else torch.Generator(device=dev).manual_seed(0))
        pd = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.cd = getattr(torch, cfg.compute_dtype)
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model, device="meta")
        self.embed.weight = trunc_normal_param((cfg.vocab, cfg.d_model), 0.02, g, device=dev, dtype=pd)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab, bias=False, device="meta")
            self.lm_head.weight = trunc_normal_param((cfg.vocab, cfg.d_model), cfg.d_model ** -0.5, g,
                                                     device=dev, dtype=pd)
        if cfg.frontend is not None:
            self.frontend = Frontend(cfg, g, device=dev)
        if cfg.family == "ssm":
            self.layers = nn.ModuleList(SSMLayer(cfg, g, device=dev) for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            n_units, rem = divmod(cfg.n_layers, cfg.hybrid.rec_per_unit + 1)
            self.layers = nn.ModuleList(HybridUnit(cfg, g, device=dev) for _ in range(n_units))
            if rem:
                self.tail = nn.ModuleList(RecurrentLayer(cfg, g, device=dev) for _ in range(rem))
        else:
            nd = cfg.moe.first_dense_layers if cfg.moe else 0
            if nd:
                self.dense_layers = nn.ModuleList(DecoderLayer(cfg, g, device=dev) for _ in range(nd))
            self.layers = nn.ModuleList(DecoderLayer(cfg, g, device=dev, moe=cfg.moe is not None)
                                        for _ in range(cfg.n_layers - nd))
        self.final_norm = _norm(cfg, device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed.weight.to(self.cd)[tokens]

    def _inputs(self, tokens: Optional[torch.Tensor] = None, frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The stack's input (B, S, d) in the compute dtype, as the
        reference's ``_embed_inputs`` builds it: ``frames`` (B,S,frontend_dim)
        through ``frontend.proj`` for ``audio``; else the token embeddings,
        for ``vlm`` with the first P positions replaced by ``patches``
        (B,P,frontend_dim) through ``frontend.proj``."""
        cfg = self.cfg
        if cfg.family == "audio":
            return F.linear(frames.to(self.cd), self.frontend.proj.weight.to(self.cd))
        if (patches is not None) != (cfg.family == "vlm"):
            raise ValueError(
                f"{cfg.name}: the vlm family takes patches (B, {cfg.vision_patches}, "
                f"{cfg.frontend_dim}) beside its tokens, and no other family takes any; "
                f"got family {cfg.family!r} with patches={patches is not None}"
            )
        x = self._embed(tokens)
        if cfg.family == "vlm":
            p = F.linear(patches.to(self.cd), self.frontend.proj.weight.to(self.cd))
            x = torch.cat([p, x[:, p.shape[1]:]], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the head (the tied table or ``lm_head``):
        (..., d) -> (..., V) float32."""
        head = self.lm_head.weight if hasattr(self, "lm_head") else self.embed.weight
        return F.linear(self.final_norm(x), head.to(self.cd)).float()

    def _decoder_layers(self):
        """Every attention layer in order: ``dense_layers`` first."""
        return [*getattr(self, "dense_layers", ()), *self.layers]

    def _layer(self, layer: DecoderLayer, x: torch.Tensor, positions: torch.Tensor,
               return_kv: bool = False, window: Optional[int] = None):
        """One pre-norm layer, causal unless ``encoder_only``, local where
        ``window`` is given -> (x, its cache rows when ``return_kv``, the
        MoE's aux losses or None)."""
        h = layer.ln_attn(x)
        if self.cfg.mla:
            out = layer.attn(h, positions, return_kv=return_kv)
        else:
            out = layer.attn(h, positions, causal=not self.cfg.encoder_only, window=window,
                             return_kv=return_kv)
        attn, kv = out if return_kv else (out, None)
        x = x + attn
        y, aux = layer.ffn(layer.ln_mlp(x))
        return x + y, kv, aux

    def _rec_layers(self):
        """Every recurrent layer of a hybrid stack, in its states' order:
        each unit's, then the tail's."""
        return [*(r for unit in self.layers for r in unit.recs), *getattr(self, "tail", ())]

    @staticmethod
    def _rec_layer(layer: RecurrentLayer, x: torch.Tensor, return_state: bool = False):
        """One recurrent layer -> (x, its state when ``return_state``)."""
        out = layer.rec(layer.ln_mix(x), return_state=return_state)
        out, st = out if return_state else (out, None)
        x = x + out
        return x + layer.mlp(layer.ln_mlp(x)), st

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device).expand(B, S)

    def _decoder_only(self, entry: str) -> None:
        if self.cfg.encoder_only:
            raise NotImplementedError(
                f"{self.cfg.name} is an encoder (encoder_only): it has no {entry}; an encoder "
                "runs through encode(frames), as the reference serves it"
            )

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process prompts (B, S) of token ids (and, for ``vlm``, their
        ``patches`` (B, P, frontend_dim), which take the first P positions):
        returns the last position's logits (B, V) float32 and the decode
        cache, in ``cfg.prefill_chunks`` slices of the batch where B is a
        multiple of it (module note)."""
        self._decoder_only("prefill")
        nc = self.cfg.prefill_chunks
        if nc > 1 and tokens.shape[0] % nc == 0:
            cut = [None] * nc if patches is None else patches.chunk(nc)
            parts = [self._prefill(t, p) for t, p in zip(tokens.chunk(nc), cut)]
            return (torch.cat([lg for lg, _ in parts]), _cat_batch([c for _, c in parts]))
        return self._prefill(tokens, patches)

    def _prefill(self, tokens: torch.Tensor, patches: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self._inputs(tokens, patches=patches)
        if self.cfg.family == "ssm":
            states = []
            for layer in self.layers:
                out, st = layer.mixer(layer.ln(x), return_state=True)
                x = x + out
                states.append(st)
            cache = {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}
        elif self.cfg.family == "hybrid":
            x, cache = self._hybrid_prefill(x)
        else:
            cfg = self.cfg
            B, S = tokens.shape
            positions = self._positions(x)
            L = cfg.n_layers
            if cfg.mla:
                shapes = {"c_kv": (L, B, S, cfg.mla.kv_lora_rank),
                          "k_rope": (L, B, S, cfg.mla.qk_rope_head_dim)}
            else:
                shapes = dict.fromkeys(("k", "v"), (L, B, S, cfg.n_kv_heads, cfg.resolved_head_dim))
            cache = {n: torch.empty(sh, dtype=self.cd, device=x.device) for n, sh in shapes.items()}
            for i, layer in enumerate(self._decoder_layers()):
                x, rows, _ = self._layer(layer, x, positions, return_kv=True)
                for t, r in zip(cache.values(), rows):
                    t[i].copy_(r)
        return self._logits(x[:, -1]), cache

    def _hybrid_prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """The hybrid stack over the prompt's embeddings ``x`` -> its output
        and its cache: each unit's last min(S, window) keys and values at
        ring slot p mod window, and each recurrent layer's states."""
        cfg = self.cfg
        B, S = x.shape[:2]
        W = min(S, cfg.hybrid.window)
        positions = self._positions(x)
        rec = init_rglru_state(cfg, len(self._rec_layers()), B, x.device)
        kv_shape = (len(self.layers), B, W, cfg.n_kv_heads, cfg.resolved_head_dim)
        attn = {n: torch.empty(kv_shape, dtype=self.cd, device=x.device) for n in ("k", "v")}
        i = 0
        for u, unit in enumerate(self.layers):
            for layer in unit.recs:
                x, st = self._rec_layer(layer, x, return_state=True)
                for n, t in st.items():
                    rec[n][i].copy_(t)
                i += 1
            x, rows, _ = self._layer(unit.attn, x, positions, return_kv=True,
                                     window=cfg.hybrid.window)
            for t, r in zip(attn.values(), rows):
                t[u].copy_(torch.roll(r[:, S - W:], S % W, dims=1))
        for layer in getattr(self, "tail", ()):
            x, st = self._rec_layer(layer, x, return_state=True)
            for n, t in st.items():
                rec[n][i].copy_(t)
            i += 1
        return x, {"attn": attn, "rec": rec}

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zero cache for ``batch`` sequences: a Mamba-2 state (which does not
        grow with ``max_len``), a KV cache (MLA's compressed one where
        ``cfg.mla``) of ``max_len`` positions, or for ``hybrid`` a ring of
        min(``max_len``, window) slots per unit and the recurrent states."""
        self._decoder_only("cache")
        cfg = self.cfg
        if cfg.family == "ssm":
            return init_ssm_state(cfg, cfg.n_layers, batch, self.device)
        if cfg.family == "hybrid":
            n_rec = len(self._rec_layers())
            return {"attn": init_kv_cache(cfg, len(self.layers), batch,
                                          min(max_len, cfg.hybrid.window), self.device),
                    "rec": init_rglru_state(cfg, n_rec, batch, self.device)}
        init = init_mla_cache if cfg.mla else init_kv_cache
        return init(cfg, cfg.n_layers, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    pos=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token per sequence: tokens (B,) -> logits (B, V) float32 and
        the new cache.  ``pos`` (an int) is the tokens' position: an
        attention stack attends over the cache's positions before it and
        writes the new k / v there, in place (nothing where ``pos`` is past
        the cache); a hybrid stack's ring writes slot ``pos`` mod its slots,
        leaving that slot's stale entry out of the attention; a state-space
        stack does not read it."""
        self._decoder_only("decode_step")
        x = self._embed(tokens)[:, None, :]
        if self.cfg.family == "ssm":
            states = []
            for i, layer in enumerate(self.layers):
                out, st = layer.mixer.decode(
                    layer.ln(x), {"ssm": cache["ssm"][i], "conv": cache["conv"][i]})
                x = x + out
                states.append(st)
            new_cache = {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}
            return self._logits(x[:, 0]), new_cache
        pos = int(pos)
        if self.cfg.family == "hybrid":
            return self._hybrid_decode(cache, x, pos)
        rows = []
        for i, layer in enumerate(self._decoder_layers()):
            out, row = layer.attn.decode(layer.ln_attn(x), {n: t[i] for n, t in cache.items()}, pos)
            x = x + out
            x = x + layer.ffn(layer.ln_mlp(x))[0]
            rows.append(row)
        update = apply_mla_cache_update if self.cfg.mla else apply_kv_cache_update
        cache = update(cache, tuple(torch.stack(r) for r in zip(*rows)), pos)
        return self._logits(x[:, 0]), cache

    def _hybrid_decode(self, cache: Dict, x: torch.Tensor, pos: int):
        """``decode_step`` of a hybrid stack on the token embeddings ``x``
        (B, 1, d); the caches are written in place."""
        attn, rec = cache["attn"], cache["rec"]
        slot = pos % attn["k"].shape[2]
        rows, i = [], 0

        def rec_step(layer, x, i):
            out, st = layer.rec.decode(layer.ln_mix(x), {n: t[i] for n, t in rec.items()})
            for n, t in st.items():
                rec[n][i].copy_(t)
            x = x + out
            return x + layer.mlp(layer.ln_mlp(x))

        for u, unit in enumerate(self.layers):
            for layer in unit.recs:
                x = rec_step(layer, x, i)
                i += 1
            layer = unit.attn
            out, row = layer.attn.decode(layer.ln_attn(x), {n: t[u] for n, t in attn.items()},
                                         pos, exclude_slot=slot)
            x = x + out
            x = x + layer.ffn(layer.ln_mlp(x))[0]
            rows.append(row)
        for layer in getattr(self, "tail", ()):
            x = rec_step(layer, x, i)
            i += 1
        apply_kv_cache_update(attn, tuple(torch.stack(r) for r in zip(*rows)), slot)
        return self._logits(x[:, 0]), cache

    def _hidden(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stack's output (B, S, d) on its input ``x``, before the final
        norm, and the sum of its MoE layers' weighted aux losses (float32);
        each layer (a hybrid's unit) under ``_remat``."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "ssm":
            def ssm_body(layer, x):
                return x + layer.mixer(layer.ln(x))

            body = _remat(ssm_body, cfg)
            for layer in self.layers:
                x = body(layer, x)
            return x, aux
        positions = self._positions(x)
        if cfg.family == "hybrid":
            def unit_body(unit, x):
                for layer in unit.recs:
                    x = self._rec_layer(layer, x)[0]
                return self._layer(unit.attn, x, positions, window=cfg.hybrid.window)[0]

            body = _remat(unit_body, cfg)
            for unit in self.layers:
                x = body(unit, x)
            rec_body = _remat(lambda layer, x: self._rec_layer(layer, x)[0], cfg)
            for layer in getattr(self, "tail", ()):
                x = rec_body(layer, x)
            return x, aux

        def layer_body(layer, x, aux):
            x, _, layer_aux = self._layer(layer, x, positions)
            if layer_aux is not None:
                m = cfg.moe
                aux = aux + (m.router_aux_weight * layer_aux["load_balance"]
                             + m.router_z_weight * layer_aux["router_z"])
            return x, aux

        body = _remat(layer_body, cfg)
        for layer in self._decoder_layers():
            x, aux = body(layer, x, aux)
        return x, aux

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Encoder inference (the ``audio`` family): frames (B, S,
        frontend_dim) -> frame logits (B, S, V) float32 through the
        bidirectional stack, the final norm and the head."""
        if self.cfg.family != "audio":
            raise NotImplementedError(
                f"{self.cfg.name}: encode takes frames, the audio family's input; family "
                f"{self.cfg.family!r} serves through prefill / decode_step"
            )
        return self._logits(self._hidden(self._inputs(frames=frames))[0])

    def _ce_chunk(self, xs: torch.Tensor, ys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk's summed masked cross-entropy and its count of labels
        >= 0: xs (B, c, d) before the final norm, ys (B, c)."""
        logits = self._logits(xs)
        gold = logits.gather(-1, ys.clamp(min=0)[..., None])[..., 0]
        mask = (ys >= 0).float()
        return ((torch.logsumexp(logits, -1) - gold) * mask).sum(), mask.sum()

    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy over ``batch["labels"]`` (B, S), labels < 0 masked:
        next-token for a decoder (on ``"tokens"``, and ``"patches"`` for
        ``vlm``), per frame for an encoder (on ``"frames"``, no shift), in
        sequence chunks of ``VOCAB_CHUNK`` so the full-vocabulary logits are
        never all live (under autograd each chunk is recomputed in the
        backward).  Returns (ce + aux, {"ce", "aux"}); ``aux`` is the MoE
        layers' weighted router losses, 0 for the other families."""
        x, aux = self._hidden(self._inputs(batch.get("tokens"), batch.get("frames"),
                                           batch.get("patches")))
        xs, labels = x, batch["labels"]
        if not self.cfg.encoder_only:
            xs, labels = x[:, :-1], labels[:, 1:]
        S = labels.shape[1]
        csz = min(VOCAB_CHUNK, S)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, S, csz):  # the last chunk takes the remainder
            args = (xs[:, lo : lo + csz], labels[:, lo : lo + csz])
            if torch.is_grad_enabled():
                part, n = checkpoint(self._ce_chunk, *args, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                part, n = self._ce_chunk(*args)
            tot = tot + part
            cnt = cnt + n
        ce = tot / cnt.clamp(min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}
