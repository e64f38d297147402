"""Reprojection warp: control-grid upsample, resampling taps, composite.

Counterpart of the device half of `gsky_tpu/ops/warp.py` on the GetMap
paths, as plain PyTorch ops:

- `_bilerp_grid`: the dense dst->src coordinate grid rebuilt from the
  sparse control points (the approx-transformer analogue);
- `_cubic_weights`: Catmull-Rom weights, a = -0.5;
- `granule_coords`: one granule's window-relative source coordinates,
  shared by the taps and by B1's staged boxes (`ops.paged.block_boxes`);
- `granule_sample`: ONE granule's per-pixel body — affine, true-extent
  NaN poisoning, window rebase, nearest / bilinear / cubic taps with
  tap-side validity — written once and shared by the plain versions of
  both hand kernels (`ops.paged`, `ops.warp_render`), which differ only
  in how a tap is fetched.  `csrc/warp_render.cu` implements the same
  body in CUDA C++;
- `composite_scale`: first-valid composite across namespaces + byte
  scaling;
- `combine_scored`: per-pixel priority combine of partial mosaics (one
  per source-CRS group);
- `warp_gather_batch`: the modular path's dense-coordinate gather warp
  of decoded windows (`_nearest`, `_bilinear`, `_cubic`), batched over
  a leading granule axis as the reference vmaps it;
- `render_rgba_ctrl`: the single-scene RGB tile (three bands of one
  grid) to RGBA bytes, the tap indices and weights computed once for
  the three bands (`_resample_c`, `_gather2d_c`).  The reference packs
  the three scenes into one (sh, sw, 3) copy; here each tap gathers
  from the three cached scenes where they lie, which gives the same
  values and holds no copy.

Op order is the reference's, term for term, so that results agree to
the bit wherever the reference itself does not contract a multiply-add.
"""

from __future__ import annotations

import torch

from .scale import _log10, _masked_extrema, auto_byte_scale, scale_to_byte

NEAR = ("near", "nearest")
METHODS = NEAR + ("bilinear", "cubic")


def _bilerp_grid(ctrl, h: int, w: int, step: int):
    """Upsample control-point grids (..., gh, gw) f32 to (..., h, w) by
    bilinear interpolation between every ``step``-th dst pixel centre.
    Each lerp's multiply-add is fused where XLA's lowering of the
    reference's jitted upsample fuses it, as in the tap sum: the first
    product into the rounded second, ``fma(c00, 1 - ty, c10 * ty)``.
    Unfused, about a third of the coordinates differ by an ulp, and a
    nearest tap whose coordinate lies that close to a pixel edge flips."""
    gh, gw = ctrl.shape[-2:]
    dev = ctrl.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] / step
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] / step
    y0 = torch.clamp(torch.floor(yy).to(torch.int32), 0, gh - 2)
    x0 = torch.clamp(torch.floor(xx).to(torch.int32), 0, gw - 2)
    ty = yy - y0
    tx = xx - x0
    y0 = y0.long()
    x0 = x0.long()
    c00 = ctrl[..., y0, x0]
    c10 = ctrl[..., y0 + 1, x0]
    c01 = ctrl[..., y0, x0 + 1]
    c11 = ctrl[..., y0 + 1, x0 + 1]
    top = fma(c00, 1 - ty, c10 * ty)
    bottom = fma(c01, 1 - ty, c11 * ty)
    return fma(top, 1 - tx, bottom * tx)


def fma(x, y, z):
    """Single-rounded float32 ``x * y + z`` (IEEE fusedMultiplyAdd).

    PyTorch has no fma op.  The f32 product is exact in float64; the
    float64 sum is taken with round-to-odd (TwoSum error term, then the
    last bit forced odd when inexact), which makes the final rounding to
    float32 correctly rounded — no double-rounding error."""
    x, y, z = (torch.as_tensor(v, dtype=torch.float32) for v in (x, y, z))
    dev = next((v.device for v in (x, y, z) if v.dim()), x.device)
    a = x.to(dev, torch.float64) * y.to(dev, torch.float64)
    b = z.to(dev, torch.float64)
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    even = (s.view(torch.int64) & 1) == 0
    bump = (err != 0) & even & torch.isfinite(s)
    s = torch.where(bump, torch.nextafter(s, s + err), s)
    return s.to(torch.float32)


def _cubic_weights(f):
    """Catmull-Rom (a=-0.5) weights for taps at offsets -1,0,1,2, with
    w1's multiply-add fused where the reference's XLA lowering fuses it
    (``(a+2)*f3 - (a+3)*f2`` as ``fma(-(a+3), f2, (a+2)*f3)``)."""
    a = -0.5
    f2 = f * f
    f3 = f2 * f
    w0 = a * (f3 - 2 * f2 + f)
    w1 = fma(-(a + 3), f2, (a + 2) * f3) + 1
    w2 = -(a + 2) * f3 + (2 * a + 3) * f2 - a * f
    w3 = a * (f2 - f3)
    return (w0, w1, w2, w3)


def granule_coords(sx, sy, p):
    """One granule's window-relative source coordinates (rows, cols) at
    each dst pixel: the affine (slots 0-5), NaN rows outside the true
    extent (6/7), the window-origin rebase (11/12).  The taps of
    `granule_sample` and the staged boxes of `ops.paged.block_boxes`
    both start here, as the CUDA kernels' `granule_coords` does."""
    # the affine and the tap sum use fused multiply-adds exactly where
    # the reference's XLA lowering contracts them; every other op rounds
    # on its own (the CUDA kernels build with -fmad=false and call fmaf
    # at the same places)
    cols = fma(p[2], sy, fma(p[1], sx, p[0])) - 0.5
    rows = fma(p[5], sy, fma(p[4], sx, p[3])) - 0.5
    oob = (rows < -0.5) | (rows > p[6] - 0.5) \
        | (cols < -0.5) | (cols > p[7] - 0.5)
    rows = torch.where(oob, torch.full_like(rows, float("nan")), rows)
    rows = rows - p[11]     # window-origin rebase (exact: integer
    cols = cols - p[12]     # <= 4096 off an f32 coordinate < 2^12)
    return rows, cols


def granule_sample(sx, sy, p, method: str, wr: int, wc: int, fetch):
    """One granule's resample onto the dst grid.

    sx/sy (h, w) f32 origin-relative src-CRS coords; ``p`` the granule's
    16-wide f32 params row (slots 0-5 affine, 6/7 true extent, 8 nodata,
    11/12 window origin); (wr, wc) the window extent taps are clipped
    to; ``fetch(ri, ci)`` the window value at clipped int64 indices.
    Returns (val (h, w) f32, ok (h, w) bool)."""
    if method not in METHODS:
        raise KeyError(f"unknown resample method {method!r}")
    rows, cols = granule_coords(sx, sy, p)
    nd = p[8]

    def tap(ri, ci, inb):
        v = fetch(ri.clamp(0, wr - 1).long(), ci.clamp(0, wc - 1).long())
        ok = inb & torch.isfinite(v) & (v != nd)
        return torch.where(ok, v, torch.zeros_like(v)), ok

    if method in NEAR:
        finite = torch.isfinite(rows) & torch.isfinite(cols)
        # 0.5 + 1e-10 rounds to 0.5 in f32; NaN coordinates are zeroed
        # before the int conversion (their taps are masked by `finite`)
        zero = torch.zeros_like(rows)
        ri = torch.floor(torch.where(finite, rows, zero) + 0.5) \
            .to(torch.int32)
        ci = torch.floor(torch.where(finite, cols, zero) + 0.5) \
            .to(torch.int32)
        inb = (ri >= 0) & (ri < wr) & (ci >= 0) & (ci < wc) & finite
        return tap(ri, ci, inb)
    finite = torch.isfinite(rows) & torch.isfinite(cols)
    rows = torch.where(finite, rows, torch.full_like(rows, -10.0))
    cols = torch.where(finite, cols, torch.full_like(cols, -10.0))
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    fr = rows - r0
    fc = cols - c0
    r0 = r0.to(torch.int32)
    c0 = c0.to(torch.int32)
    if method == "bilinear":
        taps = [(dr, dc, (fr if dr else 1 - fr) * (fc if dc else 1 - fc))
                for dr in (0, 1) for dc in (0, 1)]
        thresh = 1e-6
    else:                       # cubic (Catmull-Rom)
        wr_ = _cubic_weights(fr)
        wc_ = _cubic_weights(fc)
        taps = [(dr - 1, dc - 1, wr_[dr] * wc_[dc])
                for dr in range(4) for dc in range(4)]
        thresh = 0.05
    terms = []
    wacc = torch.zeros_like(rows)
    for dr, dc, wt in taps:
        ri = r0 + dr
        ci = c0 + dc
        inb = (ri >= 0) & (ri < wr) & (ci >= 0) & (ci < wc)
        v, okt = tap(ri, ci, inb)
        okf = okt.to(torch.float32)
        terms.append((wt * okf, v))
        wacc = wacc + wt * okf
    # acc = sum of (wt*okf)*v in tap order; the second add fuses the
    # FIRST product into the rounded second one, every later add fuses
    # its own product
    acc = fma(terms[0][0], terms[0][1], terms[1][0] * terms[1][1])
    for wo, v in terms[2:]:
        acc = fma(wo, v, acc)
    ok = finite & (wacc > thresh)
    val = acc / torch.where(wacc > thresh, wacc, torch.ones_like(wacc))
    return val, ok


def _sat_int32(x):
    """float32 -> int32 the way XLA converts: NaN to 0, out-of-range
    values saturate (torch's own cast gives INT_MIN for NaN and inf).
    Only the clipped tap index of an invalid pixel depends on it."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    # 2147483520 is the largest float32 below 2^31
    return x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)


def _gather2d(src, ri, ci):
    """Per-granule flat gather from src (B, H, W) at pre-clipped integer
    indices ri/ci (B, h, w)."""
    B, H, W = src.shape
    idx = (ri.long() * W + ci.long()).reshape(B, -1)
    return src.reshape(B, -1).gather(1, idx).reshape(ri.shape)


def _nearest(src, valid, rows, cols):
    H, W = src.shape[-2:]
    # the C kernel's (int)(px + 1e-10) in corner-based coords; in f32
    # 0.5 + 1e-10 is 0.5
    ri = _sat_int32(torch.floor(rows + 0.5))
    ci = _sat_int32(torch.floor(cols + 0.5))
    inb = (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W) \
        & torch.isfinite(rows) & torch.isfinite(cols)
    ri = ri.clamp(0, H - 1)
    ci = ci.clamp(0, W - 1)
    return _gather2d(src, ri, ci), inb & _gather2d(valid, ri, ci)


def _interp(src, valid, rows, cols, taps_of, thresh):
    """Shared body of `_bilinear` and `_cubic`: ``taps_of(fr, fc)`` gives
    [(dr, dc, weight)].  Where XLA's CPU lowering of the reference
    contracts multiply-adds, this fuses them (`fma`): the weight masked by
    tap validity is a select (so an invalid tap weighs +0.0), and the tap
    sum fuses the FIRST product into the rounded second, then every later
    product into the running sum.  A source value is never zeroed: a NaN
    under an invalid tap poisons the sum, as in the reference."""
    H, W = src.shape[-2:]
    finite = torch.isfinite(rows) & torch.isfinite(cols)
    rows = torch.where(finite, rows, torch.full_like(rows, -10.0))
    cols = torch.where(finite, cols, torch.full_like(cols, -10.0))
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    fr = rows - r0
    fc = cols - c0
    r0 = _sat_int32(r0)
    c0 = _sat_int32(c0)
    zero = torch.zeros_like(rows)
    terms = []
    wacc = zero
    for dr, dc, w in taps_of(fr, fc):
        ri = r0 + dr
        ci = c0 + dc
        inb = (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
        ric = ri.clamp(0, H - 1)
        cic = ci.clamp(0, W - 1)
        v = _gather2d(src, ric, cic)
        wo = torch.where(inb & _gather2d(valid, ric, cic), w, zero)
        terms.append((wo, v))
        wacc = wacc + wo
    acc = fma(terms[0][0], terms[0][1], terms[1][0] * terms[1][1])
    for wo, v in terms[2:]:
        acc = fma(wo, v, acc)
    big = wacc > thresh
    return acc / torch.where(big, wacc, torch.ones_like(wacc)), finite & big


def _bilinear(src, valid, rows, cols):
    return _interp(src, valid, rows, cols, lambda fr, fc: [
        (dr, dc, (fr if dr else 1 - fr) * (fc if dc else 1 - fc))
        for dr in (0, 1) for dc in (0, 1)], 1e-6)


def _cubic(src, valid, rows, cols):
    def taps(fr, fc):
        wr = _cubic_weights(fr)
        wc = _cubic_weights(fc)
        return [(dr - 1, dc - 1, wr[dr] * wc[dc])
                for dr in range(4) for dc in range(4)]
    # require meaningful positive total weight (cubic weights can cancel)
    return _interp(src, valid, rows, cols, taps, 0.05)


_GATHER = {"near": _nearest, "nearest": _nearest, "bilinear": _bilinear,
           "cubic": _cubic}


def warp_gather_batch(src, valid, rows, cols, method: str = "near"):
    """Resample each granule of src (B, H, W) f32 with validity valid
    (B, H, W) bool at fractional index coordinates rows/cols (B, h, w)
    f32 (integer k = the centre of source pixel k).  Returns (out (B, h,
    w) f32, ok (B, h, w) bool), on the inputs' device."""
    if method not in _GATHER:
        raise KeyError(f"unknown resample method {method!r}")
    return _GATHER[method](src, valid, rows, cols)


def warp_gather(src, valid, rows, cols, method: str = "near"):
    """`warp_gather_batch` of one (H, W) granule."""
    out, ok = warp_gather_batch(src[None], valid[None], rows[None],
                                cols[None], method)
    return out[0], ok[0]


def mosaic_update(canv, best, val, ok, prio, ns):
    """Strictly-greater priority mosaic step for one granule into
    per-namespace canv/best (n_ns, h, w), in place: first-seen wins
    ties, which equals the reference's argmax because priorities are
    unique by contract."""
    ninf = torch.full_like(val, float("-inf"))
    for m in range(canv.shape[0]):
        member = ns == float(m)
        s_m = torch.where(member & ok, prio, ninf)
        take = s_m > best[m]
        canv[m] = torch.where(take, val, canv[m])
        best[m] = torch.where(take, s_m, best[m])


def params16(params):
    """(B, >=11) f32 granule params -> the kernels' (B, 16) rows, with
    the window-origin slots 11/12 zero (the whole scene is the window)."""
    out = torch.zeros((params.shape[0], 16), dtype=torch.float32,
                      device=params.device)
    out[:, :11] = params[:, :11].to(torch.float32)
    return out


def composite_scale(canv, vals, scale_params, auto: bool,
                    colour_scale: int):
    """First-valid composite across namespace canvases + byte scaling:
    canv (n_ns, h, w) f32, vals (n_ns, h, w) bool -> uint8 (h, w),
    255 = nodata.  ``scale_params`` is (offset, scale, clip)."""
    # jnp.argmax on bool picks the lowest True index; torch.argmax takes
    # no bool, and returns the first maximum of the uint8 cast
    idx = torch.argmax(vals.to(torch.uint8), dim=0)
    data = torch.gather(canv, 0, idx[None])[0]
    ok = vals.any(dim=0)
    if auto:
        if colour_scale == 1:
            logged = _log10(data)
            bad = ~torch.isfinite(logged)
            data = torch.where(bad, torch.zeros_like(logged), logged)
            ok = ok & ~bad
        mn, mx = _masked_extrema(data, ok)
        return auto_byte_scale(data, ok, mn, mx, ok.any())
    return scale_to_byte(data, ok, float(scale_params[0]),
                         float(scale_params[1]), float(scale_params[2]),
                         colour_scale=colour_scale, auto=False)


def combine_scored(canvs, bests):
    """Combine G partial mosaics by per-pixel priority: canvs and bests
    (G, n_ns, h, w) f32 (best -inf = no data) -> (canvases (n_ns, h, w)
    with 0.0 where no partial has data, valids bool).  Ties go to the
    first partial, as `jnp.argmax` gives them."""
    idx = torch.argmax(bests, dim=0)
    canv = torch.gather(canvs, 0, idx[None])[0]
    ok = bests.amax(dim=0) > float("-inf")
    return torch.where(ok, canv, torch.zeros_like(canv)), ok


def _gather2d_c(planes, ri, ci):
    """Channel gather from C (H, W) planes at pre-clipped integer
    indices ri/ci (h, w): one flat index for all channels -> (h, w, C)."""
    W = planes[0].shape[1]
    idx = ri.long() * W + ci.long()
    return torch.stack([p.reshape(-1)[idx] for p in planes], -1)


def _resample_c(planes, nodata, rows, cols, method: str):
    """Counterpart of `gsky_tpu/ops/warp.py::_resample_c`: resample C
    (H, W) planes of one grid at fractional index coordinates rows/cols
    (h, w), the index math once for all channels -> (out (h, w, C) f32,
    ok (h, w, C) bool).  A tap is valid when finite and != ``nodata``;
    the tap sum fuses multiply-adds as `granule_sample` does."""
    if method not in METHODS:
        raise KeyError(f"unknown resample method {method!r}")
    H, W = planes[0].shape
    nd = float(nodata)

    def tap(ri, ci, inb):
        v = _gather2d_c(planes, ri.clamp(0, H - 1), ci.clamp(0, W - 1))
        ok = inb[..., None] & torch.isfinite(v) & (v != nd)
        return torch.where(ok, v, torch.zeros_like(v)), ok

    finite = torch.isfinite(rows) & torch.isfinite(cols)
    if method in NEAR:
        zero = torch.zeros_like(rows)
        ri = torch.floor(torch.where(finite, rows, zero) + 0.5) \
            .to(torch.int32)
        ci = torch.floor(torch.where(finite, cols, zero) + 0.5) \
            .to(torch.int32)
        inb = (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W) & finite
        return tap(ri, ci, inb)
    rows = torch.where(finite, rows, torch.full_like(rows, -10.0))
    cols = torch.where(finite, cols, torch.full_like(cols, -10.0))
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    fr = rows - r0
    fc = cols - c0
    r0 = r0.to(torch.int32)
    c0 = c0.to(torch.int32)
    if method == "bilinear":
        taps = [(dr, dc, (fr if dr else 1 - fr) * (fc if dc else 1 - fc))
                for dr in (0, 1) for dc in (0, 1)]
        thresh = 1e-6
    else:                       # cubic (Catmull-Rom)
        wr = _cubic_weights(fr)
        wc = _cubic_weights(fc)
        taps = [(dr - 1, dc - 1, wr[dr] * wc[dc])
                for dr in range(4) for dc in range(4)]
        thresh = 0.05
    terms = []
    wacc = torch.zeros(rows.shape + (len(planes),), dtype=torch.float32,
                       device=rows.device)
    for dr, dc, wt in taps:
        ri = r0 + dr
        ci = c0 + dc
        inb = (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
        v, okt = tap(ri, ci, inb)
        wo = wt[..., None] * okt.to(torch.float32)
        terms.append((wo, v))
        wacc = wacc + wo
    acc = fma(terms[0][0], terms[0][1], terms[1][0] * terms[1][1])
    for wo, v in terms[2:]:
        acc = fma(wo, v, acc)
    ok = finite[..., None] & (wacc > thresh)
    out = acc / torch.where(wacc > thresh, wacc, torch.ones_like(wacc))
    return out, ok


def render_rgba_ctrl(planes, ctrl, param, scale_params,
                     method: str = "near", out_hw=(256, 256),
                     step: int = 16, auto: bool = True,
                     colour_scale: int = 0):
    """Counterpart of `gsky_tpu/ops/warp.py::render_rgba_ctrl`: three
    (sh, sw) f32 scenes of one grid (the cached scenes, NaN = invalid),
    ctrl (2, gh, gw), ``param`` the (11,) granule params -> the RGBA
    tile uint8 (h, w, 4).  Auto scaling takes each band's own min and
    max; alpha is 0 exactly where all three bytes are 255."""
    h, w = out_hw
    sx, sy = _bilerp_grid(ctrl, h, w, step)
    p = torch.zeros(16, dtype=torch.float32, device=sx.device)
    p[:11] = param[:11].to(torch.float32)
    rows, cols = granule_coords(sx, sy, p)      # slots 11/12 are 0
    data, ok = _resample_c(planes, float(p[8]), rows, cols, method)
    if auto:
        if colour_scale == 1:
            logged = _log10(data)
            bad = ~torch.isfinite(logged)
            data = torch.where(bad, torch.zeros_like(logged), logged)
            ok = ok & ~bad
        rgb = []
        for c in range(data.shape[-1]):
            d, o = data[..., c], ok[..., c]
            mn, mx = _masked_extrema(d, o)
            rgb.append(auto_byte_scale(d, o, mn, mx, o.any()))
        rgb = torch.stack(rgb, -1)
    else:
        sp = [float(v) for v in scale_params]
        rgb = scale_to_byte(data.movedim(-1, 0), ok.movedim(-1, 0), sp[0],
                            sp[1], sp[2], colour_scale=colour_scale,
                            auto=False).movedim(0, -1)
    alpha = torch.where((rgb == 255).all(-1), 0, 255).to(torch.uint8)
    return torch.cat([rgb, alpha[..., None]], -1)
