"""Ragged paged rendering: kernel B1 and the paged GetMap entry points.

Counterpart of `gsky_tpu/ops/paged.py`.  Gather windows live in
fixed-size (page_rows, page_cols) f32 pages of a shared device pool
(`pipeline.pages.PagePool`, slot 0 the all-NaN null page); a per-tile
page table (N, T, S) int32 plus one 16-wide params row per granule
drive kernel B1, the paged warp-render (`csrc/warp_render.cu`,
replacing `gsky_tpu/ops/paged.py::_paged_render_kernel`).

The JAX program materialises ``pool[tables]`` in an XLA prologue and
DMAs each granule's whole page block into VMEM.  A Hopper block's
shared memory cannot hold a page block, so kernel B1 stages each output
block's own tap footprint instead: per (block, granule) the box of the
in-bounds taps of its pixels, walked out of the table into shared
memory; a box over `STAGE_BUDGET` is read from the pool directly, and
the blocks that do so are counted on the device (`direct_blocks`).
`block_boxes` is the plain mirror of those boxes, at any output tile.
The function computed is the same, at any tile (``blk``, planned by
`pipeline.autoplan.plan_block`).

`paged_vmem_ok` is the reference's VMEM eligibility gate with its
constants, at the reference's Pallas block (``blk``, default 128 x
128).  B1 has no VMEM and no such limit: the gate is kept as a routing
and merging rule, so that the port sends a tile to the same leg (B1 or
B2), and merges the same lanes, as the reference does.

A wave (`pipeline.waves`) renders N tiles in one B1 launch.  With the
wave planner's superblocks (`pipeline.autoplan`) its tables are (G, T,
S), G <= N union windows, and ``sb_of`` (N,) int32 gives each lane its
row; the JAX program gathers ``pool[tables][sb_of]``, B1 reads the row
in place.  `wave_drill_stats` reduces a drill wave's K blocks through
B3's K-block form.  `pool_inf_counts` is the pool audit's scan for
inf.

Fused band algebra (`render_expr_paged`): an expression lane's mosaic
slot i is the expression's variable i, so B1 renders every referenced
band of a tile in one launch (n_ns = the slot count, pow2-padded) and
`expr_epilogue` evaluates the expression over its planes; the lifted
literals arrive as an (N, C) float32 operand.  Epilogue and byte scale
are plain torch ops after the kernel, as the reference runs them in
XLA after its Pallas body.  `expr_fused_stats` counts the paths
expression requests took (percall, wave, unfused) and the distinct
fingerprints launched.
"""

from __future__ import annotations

import os
import threading

import torch

from .scale import scale_to_byte
from .warp import NEAR, _bilerp_grid, composite_scale, granule_coords, \
    granule_sample, mosaic_update
from .warp_render import DEFAULT_TILE, check_cuda, check_ns, check_tile, \
    method_code, paged_render_kernel

# params row width: slots 0..10 are the bucketed kernel's contract
# (affine, true extent, nodata, priority, ns id), 11/12 the page-grid
# window origin, 13/14 the page-aligned window extent, 15 the page
# columns per page row (the table's row stride)
PARAMS_W = 16

# B1's default output block (rows, cols): the launch's tile when none is
# planned
BLOCK = DEFAULT_TILE
# B1's staging budget: the dynamic shared memory of a block, in bytes,
# whatever its tile.
# At native resolution a 32 x 8 block's cubic footprint in one granule
# is about (32 + 3) x (8 + 3) f32 = 1.5 KB; eight granules staged at
# once take 12 KB, which leaves the SM room for many blocks.  A box of
# one granule larger than this is read from the pool directly.
STAGE_BUDGET = 12 * 1024

_direct_lock = threading.Lock()
_direct = {}            # torch.device -> (1,) int32 count on that device


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _direct_counter(device) -> torch.Tensor:
    dev = _device_key(device)
    with _direct_lock:
        t = _direct.get(dev)
        if t is None:
            t = _direct[dev] = torch.zeros(1, dtype=torch.int32,
                                           device=dev)
        return t


def direct_blocks(device="cuda") -> int:
    """Blocks of kernel B1 on ``device`` that read a granule's taps from
    the pool directly (a box over `STAGE_BUDGET`) since the last
    `reset_direct_blocks`.  Reading it synchronises with the device."""
    return int(_direct_counter(device).item())


def reset_direct_blocks(device="cuda") -> None:
    _direct_counter(device).zero_()


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


# most table slots a granule may list: page_slots()' cap, and the size of
# kernel B1's shared-memory copy of a table (kMaxSlots)
MAX_SLOTS = 64


def page_slots() -> int:
    """Max page-table slots per granule (GSKY_PAGE_SLOTS, default 8):
    windows needing more pages decline to the bucketed path."""
    try:
        s = int(os.environ.get("GSKY_PAGE_SLOTS", "8"))
    except ValueError:
        s = 8
    return max(1, min(MAX_SLOTS, s))


# the reference's paged-leg gate (`gsky_tpu/ops/pallas_tpu.py`
# `_WARP_BLK`, `_WARP_VMEM_BUDGET`): one output block of 128 x 128 and a
# 10 MiB working set
GATE_BLOCK = 128
GATE_BUDGET = 10 * 1024 * 1024


def paged_vmem_ok(slots: int, n_ns: int, pr: int, pc: int,
                  blk=None) -> bool:
    """The reference's `paged_vmem_ok`: whether a page list of ``slots``
    (pr, pc) f32 pages, double-buffered, plus the ``n_ns`` canv/best
    accumulators and the sx/sy blocks of one (bh, bw) Pallas block
    ``blk`` (None: 128 x 128; each x2) fits its VMEM budget.  False
    sends the tile to the bucketed leg, as in the reference."""
    bh, bw = blk if blk is not None else (GATE_BLOCK, GATE_BLOCK)
    pages = slots * pr * pc * 4 * 2
    acc = n_ns * bh * bw * 4 * 2 * 2
    grids = bh * bw * 4 * 2 * 2
    return pages + acc + grids <= GATE_BUDGET


def table_gather_bytes(tables, pr: int, pc: int) -> int:
    """Bytes of pool pages a (G, T, S) table block lists: every slot is
    one (pr, pc) f32 page."""
    g, t, s = (int(tables.shape[0]), int(tables.shape[1]),
               int(tables.shape[2]))
    return g * t * s * int(pr) * int(pc) * 4


def paged_render_scored_plain(pool, tables, params, sx, sy, method: str,
                              n_ns: int, sb_of=None, blk=None):
    """Plain PyTorch version of kernel B1: pool (cap, pr, pc) f32,
    tables (N, T, S) int32, params (N*T, 16) f32, sx/sy (N, h, w) f32 ->
    (canv, best) each (N, n_ns, h, w) f32, best -inf = invalid.  With
    ``sb_of`` (N,) int32, tables is (G, T, S) and lane n reads row
    sb_of[n].  The output tile ``blk`` changes nothing here."""
    _, T, S = tables.shape
    N = int(sx.shape[0])
    rows = range(N) if sb_of is None else [int(g) for g in sb_of.tolist()]
    pr, pc = int(pool.shape[1]), int(pool.shape[2])
    page = pr * pc
    h, w = sx.shape[1:]
    canv = torch.zeros((N, n_ns, h, w), dtype=torch.float32,
                       device=sx.device)
    best = torch.full((N, n_ns, h, w), float("-inf"), dtype=torch.float32,
                      device=sx.device)
    for n, row in enumerate(rows):
        for t in range(T):
            p = params[n * T + t]
            # the kernel walks the table per tap; here the granule's
            # page block is gathered once and indexed flat
            flat = pool[tables[row, t].long()].reshape(S * page)
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


def block_boxes(sx, sy, params, method: str, block=BLOCK):
    """Plain mirror of kernel B1's staged boxes for one tile: sx/sy
    (h, w) f32, params (T, 16) f32 -> (boxes, fits).  ``boxes`` (by, bx,
    T, 4) int64 holds, per output block of ``block`` = (rows, cols)
    pixels and granule, (r_lo, r_hi, c_lo, c_hi) of the window-relative
    source elements its in-bounds taps read (r_lo > r_hi where there is
    none: padding rows, off-window or non-finite coordinates); ``fits``
    (by, bx, T) bool is False where the box the kernel would stage — its
    columns widened to whole 16-byte quads, [c_lo & ~3, (c_hi | 3)] —
    is larger than `STAGE_BUDGET`, and the kernel reads it from the pool
    directly.  A block counts in `direct_blocks` when any of its
    granules does not fit."""
    h, w = sx.shape
    bh, bw = block
    nby, nbx = -(-h // bh), -(-w // bw)
    big = 1 << 40
    empty = torch.tensor([big, -big, big, -big], dtype=torch.int64,
                         device=sx.device)
    T = int(params.shape[0])
    boxes = empty.repeat(nby, nbx, T, 1)
    lo, span = (0, 0) if method in NEAR else \
        ((0, 1) if method == "bilinear" else (-1, 3))
    for t in range(T):
        p = params[t]
        if not float(p[10]) >= 0:
            continue                          # padding row
        rows, cols = granule_coords(sx, sy, p)
        finite = torch.isfinite(rows) & torch.isfinite(cols)
        if method in NEAR:
            zero = torch.zeros_like(rows)
            r0 = torch.floor(torch.where(finite, rows, zero) + 0.5)
            c0 = torch.floor(torch.where(finite, cols, zero) + 0.5)
        else:
            ten = torch.full_like(rows, -10.0)
            r0 = torch.floor(torch.where(finite, rows, ten))
            c0 = torch.floor(torch.where(finite, cols, ten))
        r0, c0 = r0.to(torch.int64), c0.to(torch.int64)
        wr, wc = int(p[13]), int(p[14])
        one = torch.stack([(r0 + lo).clamp_min(0),
                           (r0 + lo + span).clamp_max(wr - 1),
                           (c0 + lo).clamp_min(0),
                           (c0 + lo + span).clamp_max(wc - 1)], -1)
        has = (one[..., 0] <= one[..., 1]) & (one[..., 2] <= one[..., 3])
        if method in NEAR:
            has &= finite
        one = torch.where(has[..., None], one, empty)
        grid = empty.repeat(nby * bh, nbx * bw, 1)
        grid[:h, :w] = one
        grid = grid.reshape(nby, bh, nbx, bw, 4)
        boxes[:, :, t, 0::2] = grid[..., 0::2].amin(dim=(1, 3))
        boxes[:, :, t, 1::2] = grid[..., 1::2].amax(dim=(1, 3))
    has = (boxes[..., 0] <= boxes[..., 1]) & (boxes[..., 2] <= boxes[..., 3])
    elems = (boxes[..., 1] - boxes[..., 0] + 1) \
        * ((boxes[..., 3] | 3) + 1 - (boxes[..., 2] & ~3))
    fits = ~has | (elems * 4 <= STAGE_BUDGET)
    return boxes, fits


def paged_render_scored(pool, tables, params, sx, sy, method: str,
                        n_ns: int, sb_of=None, blk=None):
    """Kernel B1 on CUDA tensors, its plain version on CPU tensors.
    ``sb_of``: None, or (N,) int32 rows of a (G, T, S) ``tables``;
    ``blk``: the output tile (rows, cols), None for `BLOCK`."""
    rows, cols = check_tile(blk)
    if pool.device.type == "cpu":
        return paged_render_scored_plain(pool, tables, params, sx, sy,
                                         method, n_ns, sb_of, blk)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    check_ns(n_ns)
    check_cuda(pool, tables, params, sx, sy,
               dtypes=[torch.float32, torch.int32, torch.float32,
                       torch.float32, torch.float32])
    G, T, S = tables.shape
    N = int(sx.shape[0])
    cap, pr, pc = pool.shape
    h, w = sx.shape[1:]
    if params.shape != (N * T, PARAMS_W) or sx.shape != (N, h, w) \
            or sy.shape != sx.shape \
            or (sb_of is None and G != N) \
            or (sb_of is not None and tuple(sb_of.shape) != (N,)):
        raise ValueError("bad B1 operand shapes")
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"B1 takes 1 to {MAX_SLOTS} table slots, got {S}")
    if pc % 4:
        raise ValueError(f"B1 stages whole 16-byte quads: page columns "
                         f"{pc} must be a multiple of 4")
    sb_ptr = None
    if sb_of is not None:
        check_cuda(pool, sb_of, dtypes=[torch.float32, torch.int32])
        # a row past the table would read outside it: checked here (one
        # small readback), not on the device
        if sb_of.numel() and not 0 <= int(sb_of.min()) <= \
                int(sb_of.max()) < G:
            raise ValueError(f"sb_of indexes rows outside 0..{G - 1}")
        sb_ptr = sb_of.data_ptr()
    canv = torch.empty((N, n_ns, h, w), dtype=torch.float32,
                       device=pool.device)
    best = torch.empty_like(canv)
    paged_render_kernel(pool.device, method_code(method), n_ns,
                        pool.data_ptr(), tables.data_ptr(), params.data_ptr(),
                        sx.data_ptr(), sy.data_ptr(), canv.data_ptr(),
                        best.data_ptr(), N, T, S, pr, pc, h, w, STAGE_BUDGET,
                        _direct_counter(pool.device).data_ptr(), sb_ptr,
                        rows, cols)
    return canv, best


def _dense_grids(ctrls, h: int, w: int, step: int):
    grids = _bilerp_grid(ctrls, h, w, step)       # (N, 2, h, w)
    return grids[:, 0].contiguous(), grids[:, 1].contiguous()


def warp_scored_paged(pool, tables, params, ctrls, method: str = "near",
                      n_ns: int = 1, out_hw=(256, 256), step: int = 16,
                      sb_of=None, blk=None):
    """Counterpart of `gsky_tpu/ops/paged.py::warp_scored_paged` over N
    tiles: pool (cap, pr, pc), tables (N, T, S) int32 (or (G, T, S) with
    ``sb_of`` (N,) int32), params (N*T, 16), ctrls (N, 2, gh, gw) ->
    (canvases, best) each (N, n_ns, h, w).  ``blk``: B1's output tile."""
    h, w = out_hw
    sx, sy = _dense_grids(ctrls, h, w, step)
    return paged_render_scored(
        pool, tables.contiguous(), params.contiguous(), sx, sy, method,
        n_ns, None if sb_of is None else sb_of.contiguous(), blk)


def render_byte_paged(pool, tables, params, ctrls, sps,
                      method: str = "near", n_ns: int = 1,
                      out_hw=(256, 256), step: int = 16,
                      auto: bool = True, colour_scale: int = 0,
                      sb_of=None, blk=None):
    """Counterpart of `gsky_tpu/ops/paged.py::render_byte_paged`: kernel B1,
    then the composite/byte-scale epilogue per tile.  sps (N, 3)
    (offset, scale, clip).  Returns uint8 (N, h, w) tiles."""
    canv, best = warp_scored_paged(pool, tables, params, ctrls, method,
                                   n_ns, out_hw, step, sb_of, blk)
    return torch.stack([
        composite_scale(c, b > float("-inf"), sp, auto, colour_scale)
        for c, b, sp in zip(canv, best, sps)])


# -- fused expression epilogue ----------------------------------------

_EXPR_LOCK = threading.Lock()
_EXPR_FPS: set = set()
_EXPR_FUSED: dict = {}


def note_expr_program(fp_hash: str) -> None:
    """Record a fingerprint launched through the fused epilogue."""
    with _EXPR_LOCK:
        _EXPR_FPS.add(str(fp_hash))


def note_expr_fused(path: str) -> None:
    """Count one expression request routed through ``path`` (percall,
    wave or unfused)."""
    with _EXPR_LOCK:
        _EXPR_FUSED[path] = _EXPR_FUSED.get(path, 0) + 1


def expr_fused_stats() -> dict:
    """{"programs": distinct fingerprints launched, "paths": requests
    per path}."""
    with _EXPR_LOCK:
        return {"programs": len(_EXPR_FPS), "paths": dict(_EXPR_FUSED)}


def reset_expr_fused_stats() -> None:
    with _EXPR_LOCK:
        _EXPR_FPS.clear()
        _EXPR_FUSED.clear()


def _fp_slot_ids(key) -> set:
    """Slot indices a normalized fingerprint key references (walked,
    not assumed, so validity never widens)."""
    tag = key[0]
    if tag == "slot":
        return {key[1]}
    if tag == "const":
        return set()
    if tag == "un":
        return _fp_slot_ids(key[2])
    if tag == "bin":
        return _fp_slot_ids(key[2]) | _fp_slot_ids(key[3])
    out = set()
    for n in (key[1:] if tag == "tern" else key[2]):
        out |= _fp_slot_ids(n)
    return out


def expr_epilogue(canv, best, fp: tuple, consts):
    """The expression over a scored mosaic: canv / best (N, n_ns, h, w)
    f32 (slot i = variable i), consts (N, C) f32 -> (plane (N, h, w)
    f32, ok (N, h, w) bool).  The op sequence is the interpreter's
    (`ops.expr.eval_fingerprint`); a pixel is valid iff it is valid in
    every referenced slot and the result is finite, and 0.0 where it is
    not (`CompiledExpr.eval_masked`)."""
    from .expr import eval_fingerprint
    slot_ids = _fp_slot_ids(fp)
    n_slots = (max(slot_ids) + 1) if slot_ids else 0
    planes = [canv[:, i] for i in range(n_slots)]
    cbs = [consts[:, k][:, None, None] for k in range(consts.shape[1])]
    N, _, h, w = canv.shape
    out = eval_fingerprint(fp, planes, cbs)
    out = torch.as_tensor(out, dtype=torch.float32, device=canv.device)
    out = torch.broadcast_to(out.to(torch.float32), (N, h, w))
    ok = None
    for i in sorted(slot_ids):
        m = best[:, i] > float("-inf")
        ok = m if ok is None else ok & m
    if ok is None:
        ok = torch.ones((N, h, w), dtype=torch.bool, device=canv.device)
    ok = ok & torch.isfinite(out)
    return torch.where(ok, out, torch.zeros_like(out)), ok


def scale_lanes(planes, oks, sps, auto: bool, colour_scale: int):
    """`scale_to_byte` per lane: planes / oks (N, h, w), sps (N, 3)
    (offset, scale, clip) -> uint8 (N, h, w)."""
    sps = sps.tolist() if torch.is_tensor(sps) else \
        [[float(v) for v in sp] for sp in sps]
    return torch.stack([
        scale_to_byte(d, o, sp[0], sp[1], sp[2], colour_scale, auto)
        for d, o, sp in zip(planes, oks, sps)])


def render_expr_paged(pool, tables, params, ctrls, sps, consts,
                      method: str = "near", n_ns: int = 1,
                      out_hw=(256, 256), step: int = 16,
                      auto: bool = True, colour_scale: int = 0,
                      fp: tuple = ("const", 0), fp_hash=None, sb_of=None,
                      blk=None):
    """Counterpart of `gsky_tpu/ops/paged.py::render_expr_paged`: kernel
    B1 over N tiles (``render_byte_paged``'s operands), the expression
    epilogue with ``consts`` (N, C) f32, then `scale_to_byte` per lane.
    ``fp_hash``, when given, is recorded in `expr_fused_stats`.
    Returns uint8 (N, h, w) tiles."""
    if fp_hash is not None:
        note_expr_program(fp_hash)
    canv, best = warp_scored_paged(pool, tables, params, ctrls, method,
                                   n_ns, out_hw, step, sb_of, blk)
    plane, ok = expr_epilogue(canv, best, fp, consts)
    return scale_lanes(plane, ok, sps, auto, colour_scale)


def wave_drill_stats(datas, valids, clip_lower=-3.0e38, clip_upper=3.0e38,
                     pixel_count: bool = False):
    """Counterpart of `gsky_tpu/ops/paged.py::wave_drill_stats` over K
    drills' (B, N) data/valid blocks -> (vals (K, B) f32, counts (K, B)
    int32).  The masked mean goes through B3's K-block form
    (`ops.stats.masked_stats_many`), its mean taken in float64 and
    rounded to float32 as the per-call drill takes it; pixel-count mode
    through the plain reduction, as per call.  Every row is reduced
    alone, so each drill's result equals its per-call one."""
    from .drill import masked_mean
    from .stats import masked_stats_many
    datas, valids = list(datas), list(valids)
    if pixel_count:
        # integer counts only: block by block, no stack is copied
        outs = [masked_mean(d, v, clip_lower, clip_upper, pixel_count=True)
                for d, v in zip(datas, valids)]
        return (torch.stack([v for v, _ in outs]),
                torch.stack([c for _, c in outs]))
    s, c = masked_stats_many(datas, valids, clip_lower, clip_upper)
    vals = torch.where(c > 0, s.double() / c.clamp_min(1).double(),
                       torch.zeros((), dtype=torch.float64,
                                   device=s.device)).to(torch.float32)
    return vals, c


def pool_inf_counts(pool) -> torch.Tensor:
    """Per-slot +-inf population of the page pool: (capacity,) int32,
    the cheap first pass of the pool's integrity audit
    (`pipeline.pages.PagePool.audit`).  NaN is the legal validity
    encoding; nothing that stages a page writes inf, so a non-zero count
    convicts the slot without reading the page back.  The reference's
    is a plain XLA reduction, not a Pallas kernel: this is plain torch."""
    return torch.isinf(pool).sum((1, 2)).to(torch.int32)
