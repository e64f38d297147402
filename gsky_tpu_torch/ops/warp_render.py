"""Fused warp-render kernels for Hopper: build, bind, launch.

Counterpart of the warp-render half of `gsky_tpu/ops/pallas_tpu.py`.
`csrc/warp_render.cu` holds both hand kernels of the GetMap path,
which share one per-pixel body (`granule_sample` + the priority mosaic
in `ops.warp`):

- B1, the paged kernel (`ops.paged`), replaces
  `gsky_tpu/ops/paged.py::_paged_render_kernel`;
- B2, the bucketed kernel here, replaces
  `gsky_tpu/ops/pallas_tpu.py::_warp_render_kernel`: the same body,
  gathering from B scenes of one (WR, WC) shape.  The reference indexes
  one dense (B, WR, WC) stack; B2 takes a base pointer per scene, so the
  executor hands it the cached scenes and copies none of them.  A
  stacked tensor is taken too: its rows are the scenes.

Both kernels take their output tile at launch (``blk`` = (rows,
cols), `check_tile`; None is `DEFAULT_TILE`, 8 x 32).  The tile
changes no value: the plain versions accept it and ignore it.

B2 has two routes on the GetMap path: `render_scenes` (a single-band
tile: the per-namespace mosaic composited into one plane) and
`render_scenes_bands` (an RGB style: one byte plane per selected
namespace), both over the cached scenes.

The library is built and bound by `ops.cuda_lib` (nvcc at first use
into ``build/``, ctypes, ``cudaGetLastError`` after every launch).
Each wrapper launches its kernel for CUDA tensors and counts the
launch; for CPU tensors it runs the plain PyTorch version beside it.
There is no fallback: a CUDA launch that fails raises.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict

import torch

from .cuda_lib import CudaLibrary, Kernel, check_cuda
from .scale import _log10, _masked_extrema, auto_byte_scale, scale_to_byte
from .warp import METHODS, NEAR, _bilerp_grid, composite_scale, \
    granule_sample, mosaic_update, params16

# n_ns values the kernels are instantiated for (n_ns is pow2-bucketed)
MAX_NS = 8

# the output tiles B1 and B2 take, (rows, cols): the columns whole warps
# (a warp is 32 consecutive columns of one row), at most MAX_TILE_THREADS
# threads (the kernels' launch bound, kMaxThreads in csrc/warp_render.cu,
# a quarter of the card's 1024 a block); DEFAULT_TILE when none is planned
WARP = 32
MAX_TILE_THREADS = 256
DEFAULT_TILE = (8, 32)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("warp_render.cu", {
    "launch_paged_render": [_CI, _CI] + [_VP] * 7 + [_CI] * 8 + [_VP] * 2
    + [_CI] * 2,
    "launch_warp_render": [_CI, _CI] + [_VP] * 7 + [_CI] * 7,
    "launch_empty": [],
})
# scene pointers B2 takes by value in its launch parameters (kInline in
# csrc/warp_render.cu); a call over more scenes passes a device table
INLINE_SCENES = 32
_TABLES_MAX = 64
_tables: OrderedDict = OrderedDict()
_tables_lock = threading.Lock()


def method_code(method: str) -> int:
    if method not in METHODS:
        raise KeyError(f"unknown resample method {method!r}")
    return 0 if method in NEAR else (1 if method == "bilinear" else 2)


paged_render_kernel = Kernel(LIBRARY, "launch_paged_render")
warp_render_kernel = Kernel(LIBRARY, "launch_warp_render")
# a kernel that does nothing: the launch floor, for measurements only
empty_kernel = Kernel(LIBRARY, "launch_empty")


def tile_ok(rows: int, cols: int) -> bool:
    """Whether B1 and B2 take a (rows, cols) output tile."""
    return rows >= 1 and cols >= WARP and cols % WARP == 0 \
        and rows * cols <= MAX_TILE_THREADS


def check_tile(blk):
    """The (rows, cols) tile of a launch: `DEFAULT_TILE` for None;
    raises ValueError for a tile the kernels do not take."""
    if blk is None:
        return DEFAULT_TILE
    rows, cols = (int(v) for v in blk)
    if not tile_ok(rows, cols):
        raise ValueError(f"output tile {rows}x{cols}: the columns must be a "
                         f"multiple of {WARP}, at most {MAX_TILE_THREADS} "
                         f"threads")
    return rows, cols


def check_ns(n_ns: int) -> None:
    if not 1 <= n_ns <= MAX_NS or n_ns & (n_ns - 1):
        raise ValueError(f"n_ns={n_ns}: kernels are built for powers of "
                         f"two up to {MAX_NS}")


def scene_list(scenes):
    """B2's scenes: a (B, WR, WC) stack's rows, or the given sequence of
    (WR, WC) tensors."""
    return list(scenes.unbind(0)) if torch.is_tensor(scenes) \
        else list(scenes)


def warp_render_scored_plain(scenes, sx, sy, params, method: str,
                             n_ns: int, blk=None):
    """Plain PyTorch version of kernel B2: B scenes (a sequence of
    (WR, WC) f32 tensors or a (B, WR, WC) stack, NaN = invalid), sx/sy
    (h, w) f32, params (B, 16) f32 -> (canv, best) each (n_ns, h, w)
    f32, best -inf = invalid.  One granule at a time, in order; the
    output tile ``blk`` changes nothing here."""
    h, w = sx.shape
    canv = torch.zeros((n_ns, h, w), dtype=torch.float32,
                       device=sx.device)
    best = torch.full((n_ns, h, w), float("-inf"), dtype=torch.float32,
                      device=sx.device)
    for p, scene in zip(params, scene_list(scenes)):
        WR, WC = scene.shape
        flat = scene.reshape(-1)
        val, ok = granule_sample(sx, sy, p, method, WR, WC,
                                 lambda ri, ci: flat[ri * WC + ci])
        mosaic_update(canv, best, val, ok, p[9], p[10])
    return canv, best


def _pointer_table(device, ptrs) -> torch.Tensor:
    """A device array of scene pointers, built once per pointer list: its
    content is its key, so a cached table is right for any scenes that
    lie at those addresses."""
    key = (device, tuple(ptrs))
    with _tables_lock:
        table = _tables.get(key)
        if table is not None:
            _tables.move_to_end(key)
            return table
    table = torch.tensor(ptrs, dtype=torch.int64, device=device)
    with _tables_lock:
        _tables[key] = table
        while len(_tables) > _TABLES_MAX:
            _tables.popitem(last=False)
    return table


def warp_render_scored(scenes, sx, sy, params, method: str, n_ns: int,
                       blk=None):
    """Kernel B2 on CUDA tensors, its plain version on CPU tensors.
    ``scenes``: B contiguous (WR, WC) f32 tensors of one shape, or a
    (B, WR, WC) stack; each is read where it lies.  ``blk``: the output
    tile (rows, cols), None for `DEFAULT_TILE`."""
    scenes = scene_list(scenes)
    if not scenes:
        raise ValueError("B2 needs at least one scene")
    rows, cols = check_tile(blk)
    dev = scenes[0].device
    if dev.type == "cpu":
        return warp_render_scored_plain(scenes, sx, sy, params, method,
                                        n_ns, blk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_ns(n_ns)
    B = len(scenes)
    check_cuda(*scenes, sx, sy, params, dtypes=[torch.float32] * (B + 3))
    WR, WC = scenes[0].shape
    h, w = sx.shape
    if any(s.shape != (WR, WC) for s in scenes) or sy.shape != (h, w) \
            or params.shape != (B, 16):
        raise ValueError("bad B2 operand shapes")
    if WR * WC >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError("B2 indexes a scene and a tile in 32 bits")
    ptrs = [s.data_ptr() for s in scenes]
    if B <= INLINE_SCENES:
        inline, table = (ctypes.c_void_p * B)(*ptrs), None
    else:
        inline, table = None, _pointer_table(dev, ptrs).data_ptr()
    canv = torch.empty((n_ns, h, w), dtype=torch.float32, device=dev)
    best = torch.empty_like(canv)
    warp_render_kernel(dev, method_code(method), n_ns, inline, table,
                       params.data_ptr(), sx.data_ptr(), sy.data_ptr(),
                       canv.data_ptr(), best.data_ptr(), B, WR, WC, h, w,
                       rows, cols)
    return canv, best


def warp_scenes_scored(scenes, ctrl, params, method: str = "near",
                       n_ns: int = 1, out_hw=(256, 256), step: int = 16,
                       blk=None):
    """Counterpart of `warp_scenes_scored_pallas`: control-grid upsample
    + kernel B2.  scenes: B (sh, sw) f32 tensors or a (B, sh, sw) stack;
    ctrl (2, gh, gw), params (B, 11) -> (canvases, best) (n_ns, h, w).
    ``blk``: B2's output tile."""
    h, w = out_hw
    sx, sy = (g.contiguous() for g in _bilerp_grid(ctrl, h, w, step))
    return warp_render_scored([s.contiguous() for s in scene_list(scenes)],
                              sx, sy, params16(params), method, n_ns, blk)


def render_scenes(scenes, ctrl, params, scale_params, method: str = "near",
                  n_ns: int = 1, out_hw=(256, 256), step: int = 16,
                  auto: bool = True, colour_scale: int = 0, blk=None):
    """Counterpart of `render_scenes_pallas`: kernel B2, then the
    composite/byte-scale epilogue.  Returns the uint8 (h, w) tile."""
    canv, best = warp_scenes_scored(scenes, ctrl, params, method, n_ns,
                                    out_hw, step, blk)
    return composite_scale(canv, best > float("-inf"), scale_params, auto,
                           colour_scale)


def render_scenes_bands(scenes, ctrl, params, scale_params, out_sel,
                        method: str = "near", n_ns: int = 1,
                        out_hw=(256, 256), step: int = 16,
                        auto: bool = True, colour_scale: int = 0, blk=None):
    """Counterpart of `gsky_tpu/ops/warp.py::render_scenes_bands_ctrl`:
    kernel B2's per-namespace mosaic, then one byte plane per selected
    namespace, ``out_sel`` (n_out,) the namespace of each output band.
    Auto scaling takes each band's own min and max (log10 first under
    ``colour_scale == 1``); otherwise `scale_to_byte` with
    ``scale_params`` (offset, scale, clip).  Returns uint8 (n_out, h,
    w)."""
    canv, best = warp_scenes_scored(scenes, ctrl, params, method, n_ns,
                                    out_hw, step, blk)
    sel = torch.as_tensor(out_sel, dtype=torch.long, device=canv.device)
    data = canv[sel]
    ok = (best > float("-inf"))[sel]
    if auto:
        if colour_scale == 1:
            logged = _log10(data)
            bad = ~torch.isfinite(logged)
            data = torch.where(bad, torch.zeros_like(logged), logged)
            ok = ok & ~bad
        planes = []
        for d, o in zip(data, ok):
            mn, mx = _masked_extrema(d, o)
            planes.append(auto_byte_scale(d, o, mn, mx, o.any()))
        return torch.stack(planes)
    sp = [float(v) for v in scale_params]
    return scale_to_byte(data, ok, sp[0], sp[1], sp[2],
                         colour_scale=colour_scale, auto=False)
