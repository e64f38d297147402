"""Drill (WPS polygon time-series) reductions.

Counterpart of `gsky_tpu/ops/drill.py`, with the band (timestep) axis
as a batch dimension:

- masked mean per band over the pixels inside the rasterized polygon
  and not nodata; values outside [clip_lower, clip_upper] are left out
  of the mean, and counted as totals in pixel-count mode;
- pixel-count mode: value = fraction of valid pixels within the clip,
  count = all valid pixels;
- deciles of the sorted valid values (no clip); ``torch.sort`` takes the
  place of XLA's sort;
- `window_gather`: the polygon window of a resident (T, H, W) stack;
- `interp_strided`: statistics of strided timesteps interpolated
  between the read endpoints.

`masked_mean_impl` and `deciles_impl` take numpy arrays (the cold
host-read path, the same numpy code as the reference's) or torch
tensors (the resident-stack path).  The masked sum of the resident path
is kernel B3 (`ops.stats`); `masked_mean` here is the plain reduction
the pixel-count mode stays on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .stats import clip_f32

_BIG = 3.0e38


def _masked_mean_np(data, valid, clip_lower, clip_upper, pixel_count):
    data = data.astype(np.float32)
    inclip = valid & (data >= clip_lower) & (data <= clip_upper)
    n_inclip = np.sum(inclip, axis=-1)
    if pixel_count:
        total = np.sum(valid, axis=-1)
        value = np.where(total > 0, n_inclip / np.maximum(total, 1), 0.0)
        return value.astype(np.float32), total.astype(np.int32)
    s = np.sum(np.where(inclip, data, 0.0), axis=-1, dtype=np.float32)
    value = np.where(n_inclip > 0, s / np.maximum(n_inclip, 1), 0.0)
    return value.astype(np.float32), n_inclip.astype(np.int32)


def _masked_mean_torch(data, valid, clip_lower, clip_upper, pixel_count):
    data = data.to(torch.float32)
    lo, hi = clip_f32(clip_lower, clip_upper)
    valid = valid.to(torch.bool)
    inclip = valid & (data >= lo) & (data <= hi)
    n_inclip = inclip.sum(dim=-1)
    if pixel_count:
        total = valid.sum(dim=-1)
        # float64 division, rounded once to float32: the reference's
        # integer-over-integer division
        value = torch.where(total > 0, n_inclip.double()
                            / total.clamp_min(1).double(), 0.0)
        return value.to(torch.float32), total.to(torch.int32)
    s = torch.where(inclip, data, 0.0).sum(dim=-1, dtype=torch.float32)
    value = torch.where(n_inclip > 0,
                        s.double() / n_inclip.clamp_min(1).double(), 0.0)
    return value.to(torch.float32), n_inclip.to(torch.int32)


def masked_mean_impl(data, valid, clip_lower, clip_upper,
                     pixel_count: bool):
    """data (B, N), valid (B, N) bool, numpy arrays or torch tensors ->
    (value (B,) f32, count (B,) int32).

    Normal mode: value = mean of the valid pixels within the clip,
    count = their number.  Pixel-count mode: value = #{valid within
    clip} / #{valid}, count = #{valid}."""
    if isinstance(data, np.ndarray):
        return _masked_mean_np(data, valid, clip_lower, clip_upper,
                               pixel_count)
    return _masked_mean_torch(data, valid, clip_lower, clip_upper,
                              pixel_count)


def masked_mean(data, valid, clip_lower=-3.0e38, clip_upper=3.0e38,
                pixel_count: bool = False):
    """`masked_mean_impl` with the reference's keyword defaults."""
    return masked_mean_impl(data, valid, clip_lower, clip_upper, pixel_count)


def _deciles_np(data, valid, D):
    data = data.astype(np.float32)
    B, N = data.shape
    buf = np.sort(np.where(valid, data, np.float32(_BIG)), axis=-1)
    n = np.sum(valid, axis=-1)
    step = n // (D + 1)
    is_even = (n % (D + 1)) == 0
    i = np.arange(D)
    nmax = np.maximum(n - 1, 0)[:, None]          # last VALID index
    idx = np.clip((i[None, :] + 1) * step[:, None], 0, nmax)
    idx2 = np.clip(idx + 1, 0, nmax)
    v1 = np.take_along_axis(buf, idx, axis=-1)
    v2 = np.take_along_axis(buf, idx2, axis=-1)
    with np.errstate(over="ignore"):     # padding slots: BIG + BIG
        main = np.where(is_even[:, None], (v1 + v2) / 2.0, v1)
    nn = np.maximum(n, 1)
    count_k = (D - np.arange(D)[None, :] - 1) // nn[:, None] + 1
    count_k = np.where(np.arange(D)[None, :] < nn[:, None], count_k, 0)
    cum = np.cumsum(count_k, axis=-1)
    j = np.sum((i[None, None, :] >= cum[:, :, None]).astype(np.int32),
               axis=1)
    j = np.clip(j, 0, N - 1)
    pad = np.take_along_axis(buf, j, axis=-1)
    out = np.where((step > 0)[:, None], main, pad)
    return np.where((n > 0)[:, None], out, 0.0)


def _deciles_torch(data, valid, D):
    data = data.to(torch.float32)
    valid = valid.to(torch.bool)
    B, N = data.shape
    dev = data.device
    buf = torch.sort(torch.where(valid, data, _BIG), dim=-1).values
    n = valid.sum(dim=-1)
    step = torch.div(n, D + 1, rounding_mode="floor")
    is_even = (n % (D + 1)) == 0
    i = torch.arange(D, device=dev)
    nmax = (n - 1).clamp_min(0)[:, None]
    idx = torch.minimum(((i[None, :] + 1) * step[:, None]).clamp_min(0),
                        nmax)
    idx2 = torch.minimum((idx + 1).clamp_min(0), nmax)
    v1 = torch.gather(buf, -1, idx)
    v2 = torch.gather(buf, -1, idx2)
    main = torch.where(is_even[:, None], (v1 + v2) / 2.0, v1)
    nn = n.clamp_min(1)
    ar = torch.arange(D, device=dev)[None, :]
    count_k = torch.div(D - ar - 1, nn[:, None], rounding_mode="floor") + 1
    count_k = torch.where(ar < nn[:, None], count_k, 0)
    cum = torch.cumsum(count_k, dim=-1)
    j = (i[None, None, :] >= cum[:, :, None]).to(torch.int64).sum(dim=1)
    j = j.clamp(0, N - 1)
    pad = torch.gather(buf, -1, j)
    out = torch.where((step > 0)[:, None], main, pad)
    return torch.where((n > 0)[:, None], out, 0.0)


def deciles_impl(data, valid, n_deciles: int):
    """Per-band deciles matching `computeDeciles` (`drill.go:229-273`):
    data (B, N), valid (B, N) bool -> (B, n_deciles) f32.  step =
    n // (D+1); decile i = buf[(i+1)*step], averaged with the next
    element when n % (D+1) == 0; n < D+1 pads cyclically; bands with no
    valid pixel give zeros."""
    if isinstance(data, np.ndarray):
        return _deciles_np(data, valid, n_deciles)
    return _deciles_torch(data, valid, n_deciles)


def deciles(data, valid, n_deciles: int):
    return deciles_impl(data, valid, n_deciles)


def window_gather(stack, tsel, r0: int, c0: int, mask, nodata,
                  use_nodata: bool, out_hw: Tuple[int, int]):
    """Slice a polygon window out of a resident variable stack.

    stack (T, H, W) in the file's dtype (uint16/uint32 held widened to
    int32/int64), tsel (B,) int64 timestep indices, (r0, c0) the window
    origin (clamped by the caller so r0+h <= H), mask (h, w) bool (True
    inside the polygon, shifted to the clamped origin), ``nodata`` a
    Python number already cast to the file's dtype, ``use_nodata``
    False when the request's nodata is not representable there (it
    then matches nothing).  The nodata test runs before the f32 cast;
    NaN is invalid (``~isnan``, not ``isfinite``: inf stays valid).

    Returns (dataf (B, h*w) f32, validf (B, h*w) bool), contiguous, on
    the stack's device."""
    h, w = out_hw
    raw = stack[:, r0:r0 + h, c0:c0 + w][tsel]      # (B, h, w)
    sub = raw.to(torch.float32)
    valid = mask[None] & ~torch.isnan(sub)
    if use_nodata:
        valid &= raw != nodata
    B = sub.shape[0]
    return sub.reshape(B, h * w).contiguous(), \
        valid.reshape(B, h * w).contiguous()


def interp_strided(values: np.ndarray, counts: np.ndarray,
                   band_positions: np.ndarray,
                   n_bands: int) -> Tuple[np.ndarray, np.ndarray]:
    """Linear interpolation of statistics between strided endpoint
    bands (`drill.go:119-214`).  values/counts (K, C) at
    ``band_positions`` (sorted, including 0 and n_bands-1) -> (n_bands,
    C): interior rows get v0 + ip*(v1-v0)/gap and round((c0+c1)/2)."""
    K, C = values.shape
    out_v = np.zeros((n_bands, C), dtype=np.float64)
    out_c = np.zeros((n_bands, C), dtype=np.int32)
    for k in range(K):
        out_v[band_positions[k]] = values[k]
        out_c[band_positions[k]] = counts[k]
    for k in range(K - 1):
        b0, b1 = band_positions[k], band_positions[k + 1]
        gap = b1 - b0
        if gap <= 1:
            continue
        beta = (values[k + 1] - values[k]) / gap
        cmid = np.round((counts[k] + counts[k + 1]) / 2.0).astype(np.int32)
        for ip in range(1, gap):
            out_v[b0 + ip] = values[k] + ip * beta
            out_c[b0 + ip] = cmid
    return out_v, out_c
