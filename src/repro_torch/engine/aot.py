"""Ahead-of-time capture of the engine's step: one CUDA graph per geometry.

Counterpart of the AOT helpers of ``repro/engine/aot.py``.  The reference
lowers its jitted step from ``ShapeDtypeStruct``s and compiles it once per
geometry; here the step is captured once per geometry as a
``torch.cuda.CUDAGraph`` and replayed once per batch, so a batch costs one
replay instead of ~100 eager dispatches:

  * ``static_like`` — zero tensors of a tree's shapes and dtypes (the
    counterpart of ``abstract_like``; a ``meta`` tensor plays the
    ``ShapeDtypeStruct``);
  * ``capture_bytes_estimate`` — the device bytes an entry retains: its
    static buffers plus the graph's private memory pool (the counterpart
    of ``compile_bytes_estimate``);
  * ``CapturedStep`` — the capture itself and the replay;
  * ``graph_kernel_names`` — the kernel nodes of a captured graph, read
    from the graph (``csrc/graph_nodes.cu``): what one replay launches.

The graph reads three sets of static buffers that it owns: a device copy
of the parameter module of the entry's shape (a ``Tao``, or under int8 a
``QuantTao``, whose int8 codes, scales and padded weights are buffers;
engines copy theirs in with one ``torch._foreach_copy_`` of every
parameter and buffer per simulate, so engines of one shape share the
entry), the carry, which every replay updates in place, and the step's
eight batch inputs.  The train steps (``train/trainer.py``) are captured
the same way with ``train=True``: in grad mode, the module copy keeping
each parameter's ``requires_grad``, the carry the optimizer state, which
the step updates in place (the parameters too), and ``store`` copies the
static state back to the caller's.  A hand-written kernel's launch during
a capture is recorded, not run: ``CudaKernel.captured`` counts it, and
each replay adds the graph's launches of each kernel to that kernel's
``launches``.

The reference's persistent compilation cache keeps XLA executables on
disk across processes.  A CUDA graph does not outlive its process, so the
port's counterpart is the directory of ``nvcc``-built kernel libraries
(``kernels/_cuda.py``), which every process of a checkout already
shares: ``enable_persistent_cache`` points it at a directory,
``build_cache_counters`` (the reference's ``xla_cache_counters``) counts
this process's lookups in it, and ``persistent_cache_status`` reports it
in the reference's keys.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..kernels import _cuda
from ..kernels._cuda import KERNELS, CudaKernel

__all__ = [
    "WARMUP_RUNS",
    "CapturedStep",
    "build_cache_counters",
    "capture_bytes_estimate",
    "enable_persistent_cache",
    "graph_kernel_names",
    "persistent_cache_status",
    "static_like",
    "tree_map",
]

# enable_persistent_cache() honours this variable when no directory is
# passed, as the reference's does
_ENV_DIR = "REPRO_COMPILE_CACHE"

# eager runs of the step on the static inputs before the capture: each
# kernel's first-use build and attribute setup, and cuBLAS's handles and
# workspaces, happen there and not inside the capture
WARMUP_RUNS = 2

_GRAPH_NODES = CudaKernel(
    "graph_nodes.cu",
    "tao_graph_kernel_names",
    [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)],
)
_NAMES_BYTES = 1 << 20


def enable_persistent_cache(directory: Optional[str] = None) -> str:
    """Point the kernel build cache at ``directory`` (default:
    ``$REPRO_COMPILE_CACHE``, else ``build/`` at the checkout root) and
    return its absolute path.  Idempotent; a later call repoints it.
    Kernels already loaded keep their libraries; every later ``build``
    looks there, and builds into it what it does not find."""
    if directory is None:
        directory = os.environ.get(_ENV_DIR) or str(_cuda.DEFAULT_BUILD_DIR)
    path = Path(directory).expanduser().resolve()
    path.mkdir(parents=True, exist_ok=True)
    _cuda.BUILD_DIR = path
    return str(path)


def build_cache_counters() -> Dict[str, int]:
    """This process's kernel-library lookups: ``requests``, ``hits``
    (a library found in the cache directory, no ``nvcc``) and ``misses``
    (an ``nvcc`` run).  A warm process shows ``misses == 0``."""
    return dict(_cuda.BUILD_COUNTERS)


def persistent_cache_status() -> Dict[str, Any]:
    """JSON-friendly snapshot in the reference's keys: whether the cache
    is on (always: built libraries persist in the directory), where, how
    many libraries it holds and their bytes, and this process's lookups."""
    d = _cuda.BUILD_DIR
    libs = [p for p in d.glob("*.so") if ".tmp." not in p.name] if d.is_dir() else []
    nbytes = 0
    for p in libs:
        with contextlib.suppress(OSError):
            nbytes += p.stat().st_size
    return {
        "enabled": True,
        "dir": str(d),
        "entries": len(libs),
        "bytes": nbytes,
        **build_cache_counters(),
    }


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` of every leaf of a tree of dicts, lists, tuples and
    NamedTuples, in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _pairs(dst: Any, src: Any):
    """(dst leaf, src leaf) of two trees of ``dst``'s structure."""
    if isinstance(dst, dict):
        return [p for k, v in dst.items() for p in _pairs(v, src[k])]
    if isinstance(dst, (list, tuple)):
        return [p for d, s in zip(dst, src) for p in _pairs(d, s)]
    return [(dst, src)]


def _copy_tree_(dst: Any, src: Any) -> None:
    """Copy ``src``'s leaves (tensors, or NumPy arrays) into ``dst``'s: the
    copies within a device as one ``torch._foreach_copy_`` per dtype pair
    (a few launches for an optimizer state's hundreds of tensors), a copy
    from another device on its own."""
    groups: Dict[tuple, tuple] = {}
    for d, s in _pairs(dst, src):
        if d is s:
            continue
        s = torch.as_tensor(s)
        if s.device == d.device:
            ds, ss = groups.setdefault((d.dtype, s.dtype), ([], []))
            ds.append(d)
            ss.append(s)
        else:
            d.copy_(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def static_like(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Zero tensors of ``tree``'s shapes and dtypes (on ``device``, default
    each leaf's own): the buffers a graph reads its inputs from.  ``meta``
    leaves declare a shape without data, as the reference's
    ``ShapeDtypeStruct``s do."""
    return tree_map(
        lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device or t.device), tree)


def capture_bytes_estimate(static: Any, pool_bytes: int) -> int:
    """Device bytes a captured entry retains: its static tensors (a tree of
    dicts, lists and tuples) plus the ``pool_bytes`` its graph's private
    memory pool reserved during the capture."""
    return sum(t.numel() * t.element_size() for t in _leaves(static)) + pool_bytes


def graph_kernel_names(graph: torch.cuda.CUDAGraph) -> List[str]:
    """The function name of every kernel node of a graph captured with
    ``keep_graph=True`` (child graphs included), in the graph's node
    order: the kernels one replay launches."""
    buf = ctypes.create_string_buffer(_NAMES_BYTES)
    count = ctypes.c_int(0)
    err = _GRAPH_NODES._entry()(graph.raw_cuda_graph(), buf, _NAMES_BYTES, ctypes.byref(count), None)
    if err != 0:
        raise RuntimeError(f"tao_graph_kernel_names: CUresult {err}")
    names = buf.value.decode().splitlines()
    if len(names) != count.value:
        raise RuntimeError(f"tao_graph_kernel_names: {count.value} kernel nodes, {len(names)} names")
    return names


class CapturedStep:
    """One step captured as a CUDA graph, with the static buffers it reads.

    ``fn(params, carry, batch) -> (new_carry, per)`` is the eager step:
    the engine's, or with ``train=True`` a train step, whose carry is the
    optimizer state and which updates the parameters in place.  The
    capture runs it ``WARMUP_RUNS`` times on a side stream on zero inputs,
    then once under capture, where it also writes the new carry into the
    static carry (``copy_``); the graph's outputs ``per`` (the engine's
    per-instruction arrays under ``collect``, a train step's loss) are
    overwritten by the next replay.  The warm-up runs update the static
    state too, so a caller's state is copied in (``load``) after the
    capture, never before.  Any error of the capture raises: nothing falls
    back to the eager step.  One run at a time may use an instance.
    """

    def __init__(self, fn: Callable, params: nn.Module, carry: Any, batch: Any,
                 train: bool = False):
        """``params``: the module ``fn`` reads (its parameters and buffers
        are copied; with ``train`` each keeps its ``requires_grad``, which
        says what the step differentiates); ``carry``: the initial carry (a
        tree of tensors); ``batch``: one batch's tensors (``meta`` ones
        will do); their shapes and dtypes are captured."""
        with torch.inference_mode(False):  # plain tensors, updated in place
            self.params = copy.deepcopy(params)
            if not train:
                self.params.requires_grad_(False)
        self._param_list = [*self.params.parameters(), *self.params.buffers()]
        with torch.inference_mode(not train), torch.set_grad_enabled(train):
            self._capture(fn, carry, batch)

    def _capture(self, fn: Callable, carry: Dict, batch: Dict) -> None:
        dev = self._param_list[0].device
        self.carry = static_like(carry, dev)
        self.batch = static_like(batch, dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn(self.params, self.carry, self.batch)
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        captured = {k: k.captured for k in KERNELS}
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                new, self.per = fn(self.params, self.carry, self.batch)
                _copy_tree_(self.carry, new)
            except BaseException:
                # the capture is invalid already; end it and raise the cause
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        # each hand-written kernel's launches per replay
        self.launches: Dict[CudaKernel, int] = {
            k: k.captured - n for k, n in captured.items() if k.captured > n}
        self.replays = 0
        self.bytes_estimate = capture_bytes_estimate(
            (self._param_list, self.carry, self.batch),
            torch.cuda.memory_reserved(dev) - reserved,
        )

    @torch.no_grad()
    def load(self, params: nn.Module, carry: Any) -> None:
        """Copy an engine's weights and a trace's initial carry in (a
        trainer's parameters and optimizer state)."""
        torch._foreach_copy_(self._param_list, [*params.parameters(), *params.buffers()])
        _copy_tree_(self.carry, carry)

    @torch.no_grad()
    def store(self, params: nn.Module, carry: Any) -> None:
        """Copy the static parameters and carry back into a trainer's
        module and state tree (of ``carry``'s structure), in place."""
        torch._foreach_copy_([*params.parameters(), *params.buffers()], self._param_list)
        _copy_tree_(carry, self.carry)

    def replay(self, batch: Any) -> Any:
        """Copy one batch (a tree of tensors or NumPy arrays) into the
        static inputs and run the graph; returns the static outputs (valid
        until the next replay)."""
        _copy_tree_(self.batch, batch)
        self.graph.replay()
        self.replays += 1
        for k, n in self.launches.items():
            k.launches += n
        return self.per
