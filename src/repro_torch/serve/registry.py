"""Named model resolution for the trace server (PyTorch port of
``repro/serve/registry.py``).

The artifact store is content-addressed — perfect for "has anyone computed
this?", useless for "give me the model called ``skylake-l1d32``".  The
registry bridges the two: a name maps to a ``serve_model`` store entry
(key = ``content_key("serve_model", name)``) whose payload is the params
tree and whose manifest extra carries the full ``TaoConfig`` (plain
dataclass fields), so any process sharing the store root can resolve a
name into a ready-to-simulate ``TrainedModel`` — trained heads and
transfer-adapted heads alike, since both are just ``TrainedModel``s.

Entries are the reference's, both ways: the key holds no ``TaoConfig``,
the params tree is in the reference's layout (``params_to_jax``), the
config dict carries the reference's ``use_pallas`` (False; the port has
no such field and drops it on resolve), and the model's route is stored
under the reference's name for it, ``sim_feature_backend`` (``fused`` ↔
``"fused"``, ``staged`` ↔ ``"pallas"``, ``host`` ↔ ``"numpy"``).  The
int8 tree goes in under ``quantized_params_key``, the key and layout
``TrainedModel.quantized_params`` reads.

Resolution order is memory first (models registered in-process, e.g. a
freshly transfer-adapted head), then the store.  ``resolve`` loads
through ``ArtifactStore.get``, which pins the entry for the duration of
the read — a GC racing in another process cannot delete it mid-stream.
A store-resolved model's weights are placed on the registry's ``device``
(default ``cuda``; without CUDA the registry raises unless
``device="cpu"``), under the caller's ``device_lock`` when one is given.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..convert import params_from_jax, params_to_jax, qparams_to_jax
from ..core.features import FeatureConfig
from ..core.model import TaoConfig, init_tao
from ..store import ArtifactStore, content_key
from .types import ServeError

__all__ = ["ModelRegistry"]

_KIND = "serve_model"
# the port's route -> the reference's feature_backend, as stored
_BACKEND_OF_ROUTE = {"fused": "fused", "staged": "pallas", "host": "numpy"}
_ROUTE_OF_BACKEND = {v: k for k, v in _BACKEND_OF_ROUTE.items()}


def _cfg_to_dict(cfg: TaoConfig) -> Dict:
    """The reference's ``dataclasses.asdict`` of its ``TaoConfig``: the
    port's fields, with ``use_pallas`` (False) in its place before
    ``dtype``."""
    d = dataclasses.asdict(cfg)          # features nests as a plain dict
    dtype = d.pop("dtype")
    d["use_pallas"] = False
    d["dtype"] = dtype
    return d


def _cfg_from_dict(d: Dict) -> TaoConfig:
    d = dict(d)
    d.pop("use_pallas", None)
    feats = d.pop("features", None)
    if feats is not None:
        d["features"] = FeatureConfig(**feats)
    return TaoConfig(**d)


class ModelRegistry:
    """name -> ``TrainedModel``, in memory and (optionally) via the store."""

    def __init__(
        self,
        store: Optional[Union[ArtifactStore, str]] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if isinstance(store, str):
            store = ArtifactStore(store)
        self.store = store
        self.device = resolve_device(device)
        self._models: Dict[str, "object"] = {}   # name -> TrainedModel

    @staticmethod
    def key(name: str) -> str:
        return content_key(_KIND, name)

    # ---- registration ----------------------------------------------------

    def register(self, name: str, model, *, publish: bool = False) -> None:
        """Bind ``name`` to an in-process ``TrainedModel`` (a trained or
        transfer-adapted head).  ``publish=True`` also writes it to the
        store so other processes can resolve the same name."""
        self._models[name] = model
        if publish:
            self.publish(name, model)

    def publish(self, name: str, model, *, overwrite: bool = False) -> bool:
        """Persist ``name -> model`` into the store.  Names are mutable
        bindings over an immutable store, so re-publishing an existing
        name requires ``overwrite=True`` (which deletes the old entry
        first); without it a name collision raises.  Reads the weights
        back from the model's device (and quantizes them there)."""
        if self.store is None:
            raise ValueError("registry has no store to publish into")
        key = self.key(name)
        if self.store.has(_KIND, key):
            if not overwrite:
                raise ValueError(
                    f"model name {name!r} is already published; pass "
                    "overwrite=True to rebind it"
                )
            self.store.delete(_KIND, key)
        ok = self.store.put(
            _KIND,
            key,
            params_to_jax(model.params),
            {
                "name": name,
                "cfg": _cfg_to_dict(model.cfg),
                "sim_batch_size": int(model.sim_batch_size),
                "sim_feature_backend": _BACKEND_OF_ROUTE[model.sim_route],
                "sim_precision": getattr(model, "sim_precision", "fp32"),
            },
        )
        # Publish time is when the int8 scales are computed — every process
        # that later resolves this name and simulates with precision="int8"
        # reuses the same stored quantized tree instead of re-deriving it.
        from ..api.session import quantized_params_key  # lazy: api imports serve
        from ..core.quant import QUANT_VERSION, quantize_tao_params

        qkey = quantized_params_key(model.params)
        if not self.store.has("params_int8", qkey):
            self.store.put(
                "params_int8",
                qkey,
                qparams_to_jax(quantize_tao_params(model.params)),
                {"scheme": "w8a8-per-channel", "version": QUANT_VERSION,
                 "name": name},
            )
        return ok

    # ---- resolution ------------------------------------------------------

    def resolve(self, name: str, *, device_lock=None):
        """The ``TrainedModel`` for ``name`` (memory first, then store).
        Raises ``ServeError(UNKNOWN_MODEL)`` when neither knows it.  A
        store-resolved model is cached in memory, so its engines (and the
        captured steps behind them) persist across requests; its weights
        are placed on the device under ``device_lock`` (a server's, so the
        placement never runs beside its dispatch thread's captures)."""
        model = self._models.get(name)
        if model is not None:
            return model
        if self.store is not None:
            hit = self.store.get(_KIND, self.key(name))
            if hit is not None:
                from ..api.session import TrainedModel  # lazy: api imports serve

                tree, extra = hit
                cfg = _cfg_from_dict(extra["cfg"])
                params = init_tao(cfg, device="cpu")
                params.load_state_dict(params_from_jax(tree))
                with device_lock if device_lock is not None else contextlib.nullcontext():
                    model = TrainedModel(
                        params=params,
                        cfg=cfg,
                        name=extra.get("name", name),
                        sim_batch_size=int(extra.get("sim_batch_size", 64)),
                        sim_route=_ROUTE_OF_BACKEND[extra.get("sim_feature_backend", "numpy")],
                        sim_precision=extra.get("sim_precision", "fp32"),
                        store=self.store,
                        device=self.device,
                    )
                self._models[name] = model
                return model
        raise ServeError(
            "UNKNOWN_MODEL",
            f"model {name!r} is not registered"
            + (" (and not published in the store)" if self.store else ""),
        )

    def names(self) -> Tuple[str, ...]:
        """Every resolvable name: in-memory bindings plus published ones."""
        out = set(self._models)
        out.update(name for name, _ in self.published())
        return tuple(sorted(out))

    def published(self) -> Iterator[Tuple[str, Dict]]:
        """``(name, extra)`` for every store-published model (manifest
        scan only — params stay on disk until resolved)."""
        if self.store is None:
            return
        for _, extra in self.store.list_extras(_KIND):
            if "name" in extra:
                yield extra["name"], extra

    def __contains__(self, name: str) -> bool:
        if name in self._models:
            return True
        return self.store is not None and self.store.has(_KIND, self.key(name))

    def __len__(self) -> int:
        return len(self.names())
