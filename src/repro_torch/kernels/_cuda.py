"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.  Libraries go to
``BUILD_DIR`` (``build/`` at the checkout root unless
``engine.aot.enable_persistent_cache`` points it elsewhere), named by a
hash of the source, the headers it includes from ``csrc/`` and the flags,
so an edited source or header rebuilds and an unchanged one is reused, by
this process and by every later one.
``build()`` starts one ``nvcc`` per source, all together, and counts its
lookups in ``BUILD_COUNTERS``: a hit is a library found in the directory,
a miss an ``nvcc`` run.

A ``CudaKernel`` is one C entry point.  Every entry point takes the CUDA
stream as its last argument, launches on it without synchronising, and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0 and
otherwise adds one to ``launches`` — the count that shows a run went
through the kernel.  On a stream that is being captured into a CUDA graph
the kernel is recorded, not run, so ``launch`` adds one to ``captured``
instead; whoever replays the graph adds its launches (``engine/aot.py``).
``KERNELS`` lists every entry point.  Every source also exports
``tao_error_string`` (the text of a CUDA error code) for that message.
``sass_counts`` reads a built library's machine code (``cuobjdump``): which
tensor-core instructions each kernel holds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "CSRC", "BUILD_COUNTERS", "BUILD_DIR", "DEFAULT_BUILD_DIR", "KERNELS", "NVCC_FLAGS", "CudaKernel",
    "build", "check_cuda_tensor", "included_sources", "library_path", "sass_counts",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
BUILD_DIR = DEFAULT_BUILD_DIR

# library lookups of build() in this process: requests = hits + misses
BUILD_COUNTERS: Dict[str, int] = {"requests": 0, "hits": 0, "misses": 0}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel into the build log
)


# every C entry point, in the order the modules made them
KERNELS: List["CudaKernel"] = []


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on the machine with the card"
        )
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def included_sources(source: Path) -> List[Path]:
    """``source`` and every file it pulls in by a local ``#include "..."``
    (resolved beside the including file), recursively, each once, in the
    order first met."""
    seen: List[Path] = []
    stack = [Path(source).resolve()]
    while stack:
        path = stack.pop()
        if path in seen:
            continue
        seen.append(path)
        names = _LOCAL_INCLUDE.findall(path.read_bytes())
        stack.extend(reversed([(path.parent / n.decode()).resolve() for n in names]))
    return seen


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives: keyed by the hash of
    the text of the source and of every header it includes from beside it
    (``included_sources``), and of the compiler flags."""
    h = hashlib.sha256()
    for path in included_sources(source):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Optional[Iterable[Path]] = None) -> Dict[Path, Path]:
    """Compile every source (default: all of ``csrc/*.cu``) whose library
    is missing, one ``nvcc`` process per source, all started together.
    Returns {source: library}; raises with the compiler's log on failure."""
    sources = sorted(CSRC.glob("*.cu")) if sources is None else list(sources)
    libs = {s: library_path(s) for s in sources}
    pending: List[tuple] = []
    try:
        for src, lib in libs.items():
            BUILD_COUNTERS["requests"] += 1
            if lib.exists():
                BUILD_COUNTERS["hits"] += 1
                continue
            BUILD_COUNTERS["misses"] += 1
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            log = lib.with_suffix(".log")
            with open(log, "w") as logf:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=logf,
                    stderr=subprocess.STDOUT,
                )
            pending.append((proc, tmp, lib, log))
        for proc, tmp, lib, log in pending:
            if proc.wait() != 0:
                raise RuntimeError(
                    f"nvcc failed for {lib.stem}:\n{log.read_text()}"
                )
            os.replace(tmp, lib)  # atomic: concurrent builders agree
    finally:
        for proc, *_ in pending:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def sass_counts(source: Path, kernel: str) -> Dict[str, Dict[str, int]]:
    """Instructions in the SASS of the library built from ``source``
    (``cuobjdump -sass``, from the toolkit beside ``nvcc``), for each
    function whose mangled name holds ``kernel``: {mangled name: {"HMMA":
    mma.sync instructions, "HGMMA": wgmma instructions, "total": all
    instructions}}."""
    lib = build([source])[source]
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts: Dict[str, Dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                counts[name] = {"HMMA": 0, "HGMMA": 0, "total": 0}
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name]["total"] += 1
            for op in ("HMMA", "HGMMA"):
                counts[name][op] += re.search(rf"\b{op}\b", line) is not None
    return counts


def check_cuda_tensor(
    name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]
) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what a C entry point may be given a pointer to."""
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


class CudaKernel:
    """One C entry point of a ``csrc`` source, loaded at first launch."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + the stream
        self.launches = 0
        self.captured = 0
        self._lib = None
        self._fn = None
        KERNELS.append(self)

    def _entry(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn  # the CDLL must outlive fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream (or record the launch, while the
        stream is captured); raise on a launch error."""
        err = self._entry()(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            describe = self._lib.tao_error_string
            describe.argtypes = [ctypes.c_int]
            describe.restype = ctypes.c_char_p
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} ({describe(err).decode()})"
            )
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
