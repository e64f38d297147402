"""Fused warp-render kernels for Hopper: build, bind, launch.

Counterpart of the warp-render half of `gsky_tpu/ops/pallas_tpu.py`.
`csrc/warp_render.cu` holds both hand kernels of the GetMap path,
which share one per-pixel body (`granule_sample` + the priority mosaic
in `ops.warp`):

- B1, the paged kernel (`ops.paged`), replaces
  `gsky_tpu/ops/paged.py::_paged_render_kernel`;
- B2, the bucketed kernel here, replaces
  `gsky_tpu/ops/pallas_tpu.py::_warp_render_kernel`: the same body,
  gathering from a dense (B, bh, bw) scene stack.

The library is compiled with nvcc on first use into ``build/`` beside
the package (keyed by the source's content hash) and loaded through
ctypes with a plain C interface.  Each wrapper launches its kernel for
CUDA tensors and counts the launch; for CPU tensors it runs the plain
PyTorch version beside it.  There is no fallback: a CUDA launch that
fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from .warp import METHODS, NEAR, _bilerp_grid, composite_scale, \
    granule_sample, mosaic_update, params16

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "warp_render.cu"
_BUILD = _SRC.parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# n_ns values the kernels are instantiated for (n_ns is pow2-bucketed)
MAX_NS = 8

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build_library() -> Path:
    """Compile csrc/warp_render.cu into build/ unless a library built
    from the same source already exists; returns its path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD / f"libwarp_render-{tag}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                   check=True)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.launch_paged_render.argtypes = \
                [ci, ci] + [vp] * 7 + [ci] * 6 + [vp]
            lib.launch_paged_render.restype = ci
            lib.launch_warp_render.argtypes = \
                [ci, ci] + [vp] * 6 + [ci] * 5 + [vp]
            lib.launch_warp_render.restype = ci
            _lib = lib
        return _lib


def method_code(method: str) -> int:
    if method not in METHODS:
        raise KeyError(f"unknown resample method {method!r}")
    return 0 if method in NEAR else (1 if method == "bilinear" else 2)


class Kernel:
    """One C launch entry point of the library, with its launch count
    (incremented only where the kernel is launched)."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        self._lock = threading.Lock()

    def __call__(self, *args) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_library(), self.symbol)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc}")
        with self._lock:
            self.launches += 1


paged_render_kernel = Kernel("launch_paged_render")
warp_render_kernel = Kernel("launch_warp_render")


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


def check_ns(n_ns: int) -> None:
    if not 1 <= n_ns <= MAX_NS or n_ns & (n_ns - 1):
        raise ValueError(f"n_ns={n_ns}: kernels are built for powers of "
                         f"two up to {MAX_NS}")


def warp_render_scored_plain(stack, sx, sy, params, method: str,
                             n_ns: int):
    """Plain PyTorch version of kernel B2: stack (B, WR, WC) f32
    (NaN = invalid), sx/sy (h, w) f32, params (B, 16) f32 ->
    (canv, best) each (n_ns, h, w) f32, best -inf = invalid."""
    B, WR, WC = stack.shape
    h, w = sx.shape
    canv = torch.zeros((n_ns, h, w), dtype=torch.float32,
                       device=sx.device)
    best = torch.full((n_ns, h, w), float("-inf"), dtype=torch.float32,
                      device=sx.device)
    for t in range(B):
        flat = stack[t].reshape(-1)
        p = params[t]
        val, ok = granule_sample(sx, sy, p, method, WR, WC,
                                 lambda ri, ci: flat[ri * WC + ci])
        mosaic_update(canv, best, val, ok, p[9], p[10])
    return canv, best


def warp_render_scored(stack, sx, sy, params, method: str, n_ns: int):
    """Kernel B2 on CUDA tensors, its plain version on CPU tensors."""
    if stack.device.type == "cpu":
        return warp_render_scored_plain(stack, sx, sy, params, method,
                                        n_ns)
    if stack.device.type != "cuda":
        raise ValueError(f"unsupported device {stack.device}")
    check_ns(n_ns)
    check_cuda(stack, sx, sy, params, dtypes=[torch.float32] * 4)
    B, WR, WC = stack.shape
    h, w = sx.shape
    if sy.shape != (h, w) or params.shape != (B, 16):
        raise ValueError("bad B2 operand shapes")
    canv = torch.empty((n_ns, h, w), dtype=torch.float32,
                       device=stack.device)
    best = torch.empty_like(canv)
    warp_render_kernel(method_code(method), n_ns, stack.data_ptr(),
                       params.data_ptr(), sx.data_ptr(), sy.data_ptr(),
                       canv.data_ptr(), best.data_ptr(), B, WR, WC, h, w)
    return canv, best


def warp_scenes_scored(stack, ctrl, params, method: str = "near",
                       n_ns: int = 1, out_hw=(256, 256), step: int = 16):
    """Counterpart of `warp_scenes_scored_pallas`: control-grid upsample
    + kernel B2.  stack (B, sh, sw) f32, ctrl (2, gh, gw), params
    (B, 11) -> (canvases, best) (n_ns, h, w)."""
    h, w = out_hw
    sx = _bilerp_grid(ctrl[0], h, w, step).contiguous()
    sy = _bilerp_grid(ctrl[1], h, w, step).contiguous()
    return warp_render_scored(stack.contiguous(), sx, sy, params16(params),
                              method, n_ns)


def render_scenes(stack, ctrl, params, scale_params, method: str = "near",
                  n_ns: int = 1, out_hw=(256, 256), step: int = 16,
                  auto: bool = True, colour_scale: int = 0):
    """Counterpart of `render_scenes_pallas`: kernel B2, then the
    composite/byte-scale epilogue.  Returns the uint8 (h, w) tile."""
    canv, best = warp_scenes_scored(stack, ctrl, params, method, n_ns,
                                    out_hw, step)
    return composite_scale(canv, best > float("-inf"), scale_params, auto,
                           colour_scale)
