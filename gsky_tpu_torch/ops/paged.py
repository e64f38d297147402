"""Ragged paged rendering: kernel B1 and the paged GetMap entry points.

Counterpart of `gsky_tpu/ops/paged.py`.  Gather windows live in
fixed-size (page_rows, page_cols) f32 pages of a shared device pool
(`pipeline.pages.PagePool`, slot 0 the all-NaN null page); a per-tile
page table (N, T, S) int32 plus one 16-wide params row per granule
drive kernel B1, the paged warp-render (`csrc/warp_render.cu`,
replacing `gsky_tpu/ops/paged.py::_paged_render_kernel`).

The JAX program materialises ``pool[tables]`` in an XLA prologue and
DMAs each granule's page block into VMEM.  Kernel B1 instead walks the
table itself: each tap reads ``pool[tables[n, t, lp]]`` directly, so the
gathered page block is never written out; the function computed is the
same.  The Pallas VMEM eligibility gate (`paged_vmem_ok`) has no
counterpart for the same reason: B1 stages nothing in shared memory.
"""

from __future__ import annotations

import os

import torch

from .warp import _bilerp_grid, composite_scale, granule_sample, \
    mosaic_update
from .warp_render import check_cuda, check_ns, method_code, \
    paged_render_kernel

# params row width: slots 0..10 are the bucketed kernel's contract
# (affine, true extent, nodata, priority, ns id), 11/12 the page-grid
# window origin, 13/14 the page-aligned window extent, 15 the page
# columns per page row (the table's row stride)
PARAMS_W = 16


def page_shape():
    """(page_rows, page_cols) from GSKY_PAGE_SIZE ("RxC", default
    128x512), clamped exactly as the JAX package clamps it (rows a
    multiple of 8, cols of 128) so both pools cut scenes the same way."""
    v = os.environ.get("GSKY_PAGE_SIZE", "128x512").lower()
    try:
        r, c = v.split("x")
        pr, pc = int(r), int(c)
    except (ValueError, AttributeError):
        pr, pc = 128, 512
    pr = max(8, (pr // 8) * 8)
    pc = max(128, (pc // 128) * 128)
    return pr, pc


def page_slots() -> int:
    """Max page-table slots per granule (GSKY_PAGE_SLOTS, default 8):
    windows needing more pages decline to the bucketed path."""
    try:
        s = int(os.environ.get("GSKY_PAGE_SLOTS", "8"))
    except ValueError:
        s = 8
    return max(1, min(64, s))


def table_gather_bytes(tables, pr: int, pc: int) -> int:
    """Bytes of pool pages a (G, T, S) table block lists: every slot is
    one (pr, pc) f32 page."""
    g, t, s = (int(tables.shape[0]), int(tables.shape[1]),
               int(tables.shape[2]))
    return g * t * s * int(pr) * int(pc) * 4


def paged_render_scored_plain(pool, tables, params, sx, sy, method: str,
                              n_ns: int):
    """Plain PyTorch version of kernel B1: pool (cap, pr, pc) f32,
    tables (N, T, S) int32, params (N*T, 16) f32, sx/sy (N, h, w) f32 ->
    (canv, best) each (N, n_ns, h, w) f32, best -inf = invalid."""
    N, T, S = tables.shape
    pr, pc = int(pool.shape[1]), int(pool.shape[2])
    page = pr * pc
    h, w = sx.shape[1:]
    canv = torch.zeros((N, n_ns, h, w), dtype=torch.float32,
                       device=sx.device)
    best = torch.full((N, n_ns, h, w), float("-inf"), dtype=torch.float32,
                      device=sx.device)
    for n in range(N):
        for t in range(T):
            p = params[n * T + t]
            # the kernel walks the table per tap; here the granule's
            # page block is gathered once and indexed flat
            flat = pool[tables[n, t].long()].reshape(S * page)
            ppc = int(p[15])

            def fetch(ri, ci, flat=flat, ppc=ppc):
                lp = torch.div(ri, pr, rounding_mode="floor") * ppc \
                    + torch.div(ci, pc, rounding_mode="floor")
                idx = lp * page + torch.remainder(ri, pr) * pc \
                    + torch.remainder(ci, pc)
                return flat[idx.clamp(0, S * page - 1)]

            val, ok = granule_sample(sx[n], sy[n], p, method, int(p[13]),
                                     int(p[14]), fetch)
            mosaic_update(canv[n], best[n], val, ok, p[9], p[10])
    return canv, best


def paged_render_scored(pool, tables, params, sx, sy, method: str,
                        n_ns: int):
    """Kernel B1 on CUDA tensors, its plain version on CPU tensors."""
    if pool.device.type == "cpu":
        return paged_render_scored_plain(pool, tables, params, sx, sy,
                                         method, n_ns)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    check_ns(n_ns)
    check_cuda(pool, tables, params, sx, sy,
               dtypes=[torch.float32, torch.int32, torch.float32,
                       torch.float32, torch.float32])
    N, T, S = tables.shape
    cap, pr, pc = pool.shape
    h, w = sx.shape[1:]
    if params.shape != (N * T, PARAMS_W) or sx.shape != (N, h, w) \
            or sy.shape != sx.shape:
        raise ValueError("bad B1 operand shapes")
    canv = torch.empty((N, n_ns, h, w), dtype=torch.float32,
                       device=pool.device)
    best = torch.empty_like(canv)
    paged_render_kernel(method_code(method), n_ns, pool.data_ptr(),
                        tables.data_ptr(), params.data_ptr(), sx.data_ptr(),
                        sy.data_ptr(), canv.data_ptr(), best.data_ptr(),
                        N, T, S, pr, pc, h * w)
    return canv, best


def _dense_grids(ctrls, h: int, w: int, step: int):
    sx = torch.stack([_bilerp_grid(c[0], h, w, step) for c in ctrls])
    sy = torch.stack([_bilerp_grid(c[1], h, w, step) for c in ctrls])
    return sx.contiguous(), sy.contiguous()


def warp_scored_paged(pool, tables, params, ctrls, method: str = "near",
                      n_ns: int = 1, out_hw=(256, 256), step: int = 16):
    """Counterpart of `gsky_tpu/ops/paged.py::warp_scored_paged` over N
    tiles: pool (cap, pr, pc), tables (N, T, S) int32, params (N*T, 16),
    ctrls (N, 2, gh, gw) -> (canvases, best) each (N, n_ns, h, w)."""
    h, w = out_hw
    sx, sy = _dense_grids(ctrls, h, w, step)
    return paged_render_scored(pool, tables.contiguous(),
                               params.contiguous(), sx, sy, method, n_ns)


def render_byte_paged(pool, tables, params, ctrls, sps,
                      method: str = "near", n_ns: int = 1,
                      out_hw=(256, 256), step: int = 16,
                      auto: bool = True, colour_scale: int = 0):
    """Counterpart of `gsky_tpu/ops/paged.py::render_byte_paged`: kernel B1,
    then the composite/byte-scale epilogue per tile.  sps (N, 3)
    (offset, scale, clip).  Returns uint8 (N, h, w) tiles."""
    canv, best = warp_scored_paged(pool, tables, params, ctrls, method,
                                   n_ns, out_hw, step)
    return torch.stack([
        composite_scale(c, b > float("-inf"), sp, auto, colour_scale)
        for c, b, sp in zip(canv, best, sps)])
