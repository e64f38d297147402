"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``gsky_tpu_torch/csrc`` is compiled with nvcc on
first use into ``build/`` beside the package (one shared library per
source, named by the hash of its content and flags) and loaded through
ctypes with a plain C interface: every launch entry point takes device
pointers, sizes and the CUDA stream, and returns ``cudaGetLastError()``
after its launch.  `build_all` starts one nvcc per source at once, so
the libraries build in parallel.

`compile_count` is the process's count of what it compiles or loads:
each nvcc build, each library load, and the first launch of each kernel
symbol (which loads its module's code under CUDA's lazy loading).  It
is the port's ``gsky_compiles_total`` (`server.prewarm`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_compiles = 0
_compiles_lock = threading.Lock()


def _note_compile() -> None:
    global _compiles
    with _compiles_lock:
        _compiles += 1


def compile_count() -> int:
    """nvcc builds, library loads and first launches of a kernel symbol
    in this process."""
    with _compiles_lock:
        return _compiles


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


class CudaLibrary:
    """One csrc source: its build target and its loaded entry points.
    ``signatures`` maps each C symbol to its ctypes argtypes without the
    trailing stream pointer (appended here); every symbol returns int."""

    def __init__(self, source: str, signatures: Dict[str, list]):
        self.src = CSRC / source
        self.signatures = signatures
        self._lib = None
        self._lock = threading.Lock()

    def target(self) -> Path:
        tag = hashlib.sha1(self.src.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD / f"lib{self.src.stem}-{tag}.so"

    def start_build(self):
        """(target, temporary output, nvcc process); the process is None
        when a library built from the same source already exists."""
        out = self.target()
        if out.exists():
            return out, None, None
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        return out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.src)])

    def build(self) -> Path:
        return build_all([self])[0]

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for sym, argtypes in self.signatures.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                self._lib = lib
                _note_compile()
            return self._lib


def build_all(libs: Sequence[CudaLibrary]) -> List[Path]:
    """Build every library that is not built yet, one nvcc each, all
    started together (libraries of the same content build once);
    raises if any compile fails."""
    started = {}
    for lib in libs:
        if lib.target() not in started:
            started[lib.target()] = (lib, lib.start_build())
    failed = []
    for lib, (out, tmp, proc) in started.values():
        if proc is None:
            continue
        if proc.wait() != 0:
            failed.append(str(lib.src))
            continue
        os.replace(tmp, out)
        _note_compile()
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}")
    return [lib.target() for lib in libs]


class Kernel:
    """One C launch entry point of a library, with its launch count
    (incremented only where the kernel is launched).  A call names the
    device its operands lie on: the kernel launches there, on that
    device's current stream, whichever device is current."""

    def __init__(self, library: CudaLibrary, symbol: str):
        self.library = library
        self.symbol = symbol
        self.launches = 0
        self._launched = False      # a first launch loads the symbol
        self._lock = threading.Lock()

    def __call__(self, device, *args) -> None:
        fn = getattr(self.library.load(), self.symbol)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc}")
        with self._lock:
            self.launches += 1
            first, self._launched = not self._launched, True
        if first:
            _note_compile()


def check_cuda(*tensors, dtypes):
    """Device, dtype and contiguity checks before pointers go to C."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"tensor of {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
