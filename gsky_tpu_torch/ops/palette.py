"""Colour palettes: 256-entry gradient ramps and their LUT apply.

Counterpart of `gsky_tpu/ops/palette.py` (semantics of
`utils/palette.go`): interpolated mode divides 0..255 into
len(colours)-1 sections (early sections get the remainder "bonus"
entry), interpolating R, G, B with integer division truncating toward
zero and holding A from the section's lower colour; non-interpolated
mode paints equal blocks.  The ramps are built in numpy; the LUT apply
is a torch index on the byte tile's device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

RGBA = Tuple[int, int, int, int]


def _tdiv(n: int, d: int) -> int:
    """Integer division truncating toward zero (Go's)."""
    return -((-n) // d) if n < 0 else n // d


def gradient_palette(colours: Sequence[RGBA],
                     interpolate: bool = True) -> np.ndarray:
    """The (256, 4) uint8 ramp of ``colours``."""
    colours = [tuple(int(x) for x in c) for c in colours]
    ramp = np.zeros((256, 4), dtype=np.uint8)
    if interpolate:
        if len(colours) < 2:
            raise ValueError("interpolated palette needs >= 2 colours")
        bins = len(colours) - 1
        section = 256 // bins
        bonus = 256 - section * bins
        index = 0
        for s in range(bins):
            a, b = colours[s], colours[s + 1]
            for i in range(section + (1 if s < bonus else 0)):
                for ch in range(3):
                    ramp[index, ch] = (a[ch] + _tdiv(i * (b[ch] - a[ch]),
                                                     section)) & 0xFF
                ramp[index, 3] = a[3]
                index += 1
    else:
        bins = len(colours)
        section = 256 // bins
        bonus = 256 - section * bins
        index = 0
        for s, c in enumerate(colours):
            length = section + (1 if s < bonus else 0)
            ramp[index:index + length] = c
            index += length
    return ramp


def with_nodata_entry(lut: np.ndarray) -> np.ndarray:
    """A copy whose 0xFF entry is fully transparent (255 is the nodata
    byte)."""
    out = lut.copy()
    out[255] = (0, 0, 0, 0)
    return out


def apply_palette(byte_img: torch.Tensor, lut) -> torch.Tensor:
    """byte_img (H, W) uint8 (255 = nodata), lut (256, 4) uint8 ->
    (H, W, 4) RGBA on the image's device."""
    lut = torch.as_tensor(np.asarray(lut, np.uint8), device=byte_img.device)
    return lut[byte_img.to(torch.int64)]
