"""Language-model assembly and serving entry points, in PyTorch.

Counterpart of ``repro/models/backbone.py::Model`` for the ``ssm`` family
(a Mamba-2 stack); the reference's other families are ROADMAP item A10.
The stack is the embedding table, ``n_layers`` pre-norm residual layers
(``ln`` + a ``Mamba2`` mixer), ``final_norm`` and a head tied to the
table.  Where the reference scans stacked layer params, the port runs an
``nn.ModuleList`` eagerly; the cache keeps the reference's stacked layout
(``{"ssm": (L,B,H,N,P), "conv": (L,B,K-1,C)}``, float32) so the two
compare leaf by leaf.  Every entry point is forward only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..nn.core import RMSNorm, trunc_normal_param
from .config import ArchConfig
from .mamba2 import Mamba2, init_ssm_state

__all__ = ["Model", "VOCAB_CHUNK"]

VOCAB_CHUNK = 2048  # logit/CE chunk along the sequence to bound live logits


class SSMLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *, device):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype=getattr(torch, cfg.param_dtype), device=device)
        self.mixer = Mamba2(cfg, generator, device=device)


class Model(nn.Module):
    """A Mamba-2 language model: ``prefill`` / ``decode_step`` /
    ``init_cache`` for serving, ``loss`` (forward only).

    ``Model(cfg, device=None, generator=None)`` builds the parameters on
    ``device`` (``cuda`` by default; raises without it unless
    ``device="cpu"``) from ``generator`` (seed 0 on that device when
    None), with the reference's distributions.  Load the reference's
    weights with ``load_state_dict(convert.lm_params_from_jax(tree))``."""

    def __init__(
        self,
        cfg: ArchConfig,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported (only 'ssm'); "
                "the other families are ROADMAP item A10"
            )
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        pd = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model, device="meta")
        self.embed.weight = trunc_normal_param((cfg.vocab, cfg.d_model), 0.02, g, device=dev, dtype=pd)
        self.layers = nn.ModuleList(SSMLayer(cfg, g, device=dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype=pd, device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed.weight.to(getattr(torch, self.cfg.compute_dtype))[tokens]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the tied head: (..., d) -> (..., V) float32."""
        head = self.embed.weight.to(getattr(torch, self.cfg.compute_dtype))
        return F.linear(self.final_norm(x), head).float()

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process prompts (B, S) of token ids: returns the last position's
        logits (B, V) float32 and the decode cache."""
        x = self._embed(tokens)
        states = []
        for layer in self.layers:
            out, st = layer.mixer(layer.ln(x), return_state=True)
            x = x + out
            states.append(st)
        cache = {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}
        return self._logits(x[:, -1]), cache

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zero cache for ``batch`` sequences (a Mamba-2 state does not grow
        with ``max_len``)."""
        return init_ssm_state(self.cfg, self.cfg.n_layers, batch, self.device)

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    pos=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token per sequence: tokens (B,) -> logits (B, V) float32 and
        the new cache.  ``pos`` is unused by a state-space stack (kept for
        the reference's signature)."""
        x = self._embed(tokens)[:, None, :]
        states = []
        for i, layer in enumerate(self.layers):
            out, st = layer.mixer.decode(
                layer.ln(x), {"ssm": cache["ssm"][i], "conv": cache["conv"][i]})
            x = x + out
            states.append(st)
        new_cache = {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}
        return self._logits(x[:, 0]), new_cache

    @torch.no_grad()
    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy over ``batch["tokens"]`` / ``["labels"]``
        (B, S), labels < 0 masked, in sequence chunks of ``VOCAB_CHUNK`` so
        the full-vocabulary logits are never all live.  Returns (loss,
        {"ce", "aux"}); a Mamba-2 stack has no auxiliary loss."""
        x = self._embed(batch["tokens"])
        for layer in self.layers:
            x = x + layer.mixer(layer.ln(x))
        xs, labels = x[:, :-1], batch["labels"][:, 1:]
        S = labels.shape[1]
        csz = min(VOCAB_CHUNK, S)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, S, csz):  # the last chunk takes the remainder
            logits = self._logits(xs[:, lo : lo + csz])
            ys = labels[:, lo : lo + csz]
            gold = logits.gather(-1, ys.clamp(min=0)[..., None])[..., 0]
            mask = (ys >= 0).float()
            tot = tot + ((torch.logsumexp(logits, -1) - gold) * mask).sum()
            cnt = cnt + mask.sum()
        ce = tot / cnt.clamp(min=1.0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + aux, {"ce": ce, "aux": aux}
