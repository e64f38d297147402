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

The library is built and bound by `ops.cuda_lib` (nvcc at first use
into ``build/``, ctypes, ``cudaGetLastError`` after every launch).
Each wrapper launches its kernel for CUDA tensors and counts the
launch; for CPU tensors it runs the plain PyTorch version beside it.
There is no fallback: a CUDA launch that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLibrary, Kernel, check_cuda
from .warp import METHODS, NEAR, _bilerp_grid, composite_scale, \
    granule_sample, mosaic_update, params16

# n_ns values the kernels are instantiated for (n_ns is pow2-bucketed)
MAX_NS = 8

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("warp_render.cu", {
    "launch_paged_render": [_CI, _CI] + [_VP] * 7 + [_CI] * 8 + [_VP],
    "launch_warp_render": [_CI, _CI] + [_VP] * 6 + [_CI] * 5,
})


def method_code(method: str) -> int:
    if method not in METHODS:
        raise KeyError(f"unknown resample method {method!r}")
    return 0 if method in NEAR else (1 if method == "bilinear" else 2)


paged_render_kernel = Kernel(LIBRARY, "launch_paged_render")
warp_render_kernel = Kernel(LIBRARY, "launch_warp_render")


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
