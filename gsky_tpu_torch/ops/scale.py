"""Colour scaling to uint8.

Counterpart of `gsky_tpu/ops/scale.py` (semantics of
`utils/raster_scaler.go`): effective scale ``scale`` if > 0, else
``254/clip`` if clip > 0, else 1; auto min-max mode; optional log10
colour scale; per pixel ``byte = trunc(clamp(v + offset, 0, clip) *
scale)``; nodata encodes as 255.

Float32 op order follows the reference.  Two PyTorch habits would
change bits and are avoided: ``254.0 / t`` is evaluated by PyTorch as
``t.reciprocal() * 254.0``, so the divisions below divide tensor by
tensor; and ``log10`` is taken as ``log(x) / log(10)``, which is how
`jnp.log10` lowers.
"""

from __future__ import annotations

import numpy as np
import torch

NODATA_BYTE = 255


def _log10(x):
    return torch.log(x) / torch.log(torch.full((), 10.0, dtype=x.dtype,
                                               device=x.device))


def auto_byte_scale(data, valid, mn, mx, any_valid):
    """The auto min-max byte mapping given precomputed extrema."""
    zero = torch.zeros((), dtype=torch.float32, device=data.device)
    mn = torch.where(any_valid, mn, zero)
    mx = torch.where(any_valid, mx, zero)
    mx = torch.where(mx == mn, mx + 0.1, mx)
    clip_e = mx - mn
    v = torch.clamp_min(torch.minimum(data - mn, clip_e), 0.0)
    s = torch.full((), 254.0, dtype=torch.float32,
                   device=data.device) / clip_e
    b = torch.clamp(torch.floor(v * s), 0, 254).to(torch.uint8)
    return torch.where(valid, b, torch.full_like(b, NODATA_BYTE))


def _masked_extrema(data, valid):
    big = torch.full((), 3.4e38, dtype=torch.float32, device=data.device)
    mn = torch.where(valid, data, big).min()
    mx = torch.where(valid, data, -big).max()
    return mn, mx


def scale_to_byte(data, valid, offset=0.0, scale=0.0, clip=0.0,
                  colour_scale: int = 0, auto: bool = False):
    """data (..., H, W) f32, valid bool mask -> uint8 with 255 = nodata.
    ``auto`` selects min-max mode; offset/scale/clip are then ignored."""
    data = data.to(torch.float32)
    if colour_scale == 1:  # log10 colour scale (ColourLogScale)
        logged = _log10(data)
        # f32 log10 lands a ulp below exact decades; snap values within
        # a few ulp of an integer back onto it (reference semantics)
        snapped = torch.round(logged)
        logged = torch.where(
            torch.abs(logged - snapped)
            <= 4.8e-7 * torch.clamp_min(torch.abs(snapped), 1.0),
            snapped, logged)
        bad = ~torch.isfinite(logged)
        data = torch.where(bad, torch.zeros_like(logged), logged)
        valid = valid & ~bad
    if auto:
        mn, mx = _masked_extrema(data, valid)
        return auto_byte_scale(data, valid, mn, mx, valid.any())
    offset_e = np.float32(offset)
    clip_e = np.float32(clip)
    if np.float32(scale) > 0.0:
        scale_e = np.float32(scale)
    elif clip_e > 0.0:
        scale_e = np.float32(254.0) / np.maximum(clip_e, np.float32(1e-30))
    else:
        scale_e = np.float32(1.0)
    v = data + float(offset_e)
    v = torch.minimum(v, torch.full((), float(clip_e), dtype=torch.float32,
                                    device=data.device))
    v = torch.clamp_min(v, 0.0)
    b = torch.clamp(torch.floor(v * float(scale_e)), 0, 254).to(torch.uint8)
    return torch.where(valid, b, torch.full_like(b, NODATA_BYTE))


def scale_params_auto(offset, scale, clip) -> bool:
    """Auto min-max scaling applies when no offset, scale or clip is
    configured."""
    return offset == 0.0 and scale == 0.0 and clip == 0.0
