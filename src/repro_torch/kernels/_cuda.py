"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.  Libraries go to ``build/``
at the checkout root, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  ``build()`` starts
one ``nvcc`` per source, all together.

A ``CudaKernel`` is one C entry point.  Every entry point takes the CUDA
stream as its last argument, launches on it without synchronising, and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0 and
otherwise adds one to ``launches`` — the count that shows a run went
through the kernel.  Every source also exports ``tao_error_string`` (the
text of a CUDA error code) for that message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "CudaKernel", "build", "library_path"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel into the build log
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on the machine with the card"
        )
    return path


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives: keyed by the hash of
    the source text and the compiler flags."""
    h = hashlib.sha256(source.read_bytes())
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
            if lib.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
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


class CudaKernel:
    """One C entry point of a ``csrc`` source, loaded at first launch."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + the stream
        self.launches = 0
        self._lib = None
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn  # the CDLL must outlive fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise on a launch error."""
        err = self._entry()(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            describe = self._lib.tao_error_string
            describe.argtypes = [ctypes.c_int]
            describe.restype = ctypes.c_char_p
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} ({describe(err).decode()})"
            )
        self.launches += 1
