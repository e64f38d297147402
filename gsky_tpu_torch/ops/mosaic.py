"""Temporal mosaic + bit-mask compute, on the pipeline's device.

Counterpart of `gsky_tpu/ops/mosaic.py`.  The reference mosaics granules
newest-wins, older granules filling the remaining nodata holes; equal
timestamps: the later-arriving granule wins.  That loop is one "first
valid along the priority axis" reduction: kernel B4
(`ops.first_valid`) for a (T, H, W) stack whose power-of-two-padded T
is at most 128, the argmax form (`mosaic_first_valid`) otherwise.  The
two fill an all-invalid pixel differently (0.0 against the top layer's
value), so `mosaic_stack` routes exactly as the reference does.  There
is no race and no fallback: for a CUDA stack B4 launches or raises.

Mask bands exclude pixels where (value & mask_value) > 0, or where any
(filter, value) bit-test pair matches.  PyTorch has no bitwise or
comparison kernels for uint16/uint32, so those bands are widened to
int32/int64, which keeps values and bit patterns; signed bands stay in
their own dtype, so a high-bit mask on an int8 band never excludes a
negative value.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import first_valid
from .warp import fma

# the B4 granule-axis bound (`gsky_tpu/ops/pallas_tpu.py::_MOSAIC_T_MAX`)
_MOSAIC_T_MAX = 128

# torch dtype of an integer band -> its numpy storage dtype
_NP_OF = {torch.uint8: np.uint8, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64}
# numpy storage dtype -> the torch dtype its bitwise tests run in
_WIDE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
         np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.int32,
         np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.int64,
         np.dtype(np.int64): torch.int64}


def priority_order(timestamps: Sequence[float]) -> List[int]:
    """Granule indices in mosaic priority order (highest first): newest
    timestamp first; among equal timestamps, later arrival first."""
    return sorted(range(len(timestamps)),
                  key=lambda i: (-timestamps[i], -i))


def mosaic_first_valid(stack, valid):
    """The argmax form: stack (T, ..., H, W) f32 in priority order,
    valid (T, ..., H, W) bool.  Per pixel the value of the first valid
    layer, the top layer's value where none is valid.  Returns (out,
    ok)."""
    # torch.argmax takes no bool; on uint8 it returns the first maximum
    idx = torch.argmax(valid.to(torch.uint8), dim=0)
    out = torch.gather(stack, 0, idx[None])[0]
    return out, valid.any(dim=0)


def mosaic_weighted(stack, valid, weights):
    """Weighted blend over the granule axis: out = sum(w*v*valid) /
    sum(w*valid), in the reference's order: one multiply-add per layer,
    fused, into a sum that starts at 0 (a single layer is a plain
    product)."""
    w = torch.where(valid, weights.reshape((-1,) + (1,) * (stack.dim() - 1)),
                    torch.zeros((), dtype=torch.float32, device=stack.device))
    if stack.shape[0] == 1:
        acc, wsum = w[0] * stack[0], w[0]
    else:
        acc = torch.zeros(stack.shape[1:], dtype=torch.float32,
                          device=stack.device)
        wsum = torch.zeros_like(acc)
        for t in range(stack.shape[0]):
            acc = fma(w[t], stack[t], acc)
            wsum = wsum + w[t]
    ok = wsum > 0
    return acc / torch.where(ok, wsum, torch.ones_like(wsum)), ok


def _parse_bits(s: str) -> int:
    return int(s, 2)


def _cast_wrap(value: int, dtype) -> int:
    """Wrap an unsigned bit pattern into dtype (Go's uintN->intN cast)."""
    return int(np.array([value], np.uint64).astype(dtype)[0])


def _cast_clamp_signed(value: int, dtype) -> int:
    """Go parses bit tests with strconv.ParseInt at the band's bit width:
    out-of-range values clamp to the signed max, then cast into the
    band's type."""
    bits = np.dtype(dtype).itemsize * 8
    smax = (1 << (bits - 1)) - 1
    smin = -(1 << (bits - 1))
    return _cast_wrap(max(min(value, smax), smin), dtype)


def compute_bit_mask(data, mask_value: Optional[str],
                     bit_tests: Sequence[str] = (), dtype=None):
    """True where the pixel is EXCLUDED by the mask band.

    data: integer tensor; ``dtype`` the band's numpy storage dtype when
    ``data`` holds it widened (default: data's own dtype).  Constants
    are wrapped and clamped in the storage dtype, and the tests run in
    a dtype that holds every storage value with its bits.  mask_value:
    binary string like "100000"; bit_tests: flat (filter, value) pairs
    of binary strings."""
    if data.dtype.is_floating_point or data.dtype == torch.bool:
        raise ValueError(f"mask band must be integer, got {data.dtype}")
    storage = np.dtype(dtype) if dtype is not None else \
        np.dtype(_NP_OF[data.dtype])
    data = data.to(_WIDE[storage])

    def const(v):
        return torch.tensor(v, dtype=data.dtype, device=data.device)

    if mask_value:
        return (data & const(_cast_wrap(_parse_bits(mask_value),
                                        storage))) > 0
    if not bit_tests or len(bit_tests) % 2 != 0:
        raise ValueError("mask needs value or (filter,value) bit-test pairs")
    out = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    for j in range(0, len(bit_tests), 2):
        f = _cast_clamp_signed(_parse_bits(bit_tests[j]), storage)
        v = _cast_clamp_signed(_parse_bits(bit_tests[j + 1]), storage)
        out = out | ((data & const(f)) == const(v))
    return out


def mosaic_stack(rasters, nodata_masks, timestamps,
                 exclude_masks=None, weights=None):
    """Order granule canvases by mosaic priority and reduce them; the
    result stays on the canvases' device.

    rasters: (H, W) f32 tensors (already warped to the canvas grid);
    nodata_masks: (H, W) bool (True = valid); exclude_masks: optional
    (H, W) bool (True = excluded by the mask band); weights: optional
    per-granule weights -> weighted blend.  The granule axis routes as
    if padded to a power of two with invalid layers, which change no
    result, so none are built."""
    order = priority_order(timestamps)
    stack = torch.stack([rasters[i] for i in order])
    valid = torch.stack([nodata_masks[i] for i in order])
    if exclude_masks is not None:
        valid = valid & ~torch.stack([exclude_masks[i] for i in order])
    T = stack.shape[0]
    Tp = 1
    while Tp < T:
        Tp *= 2
    if weights is not None:
        w = torch.tensor([float(weights[i]) for i in order],
                         dtype=torch.float32, device=stack.device)
        return mosaic_weighted(stack, valid, w)
    if stack.dim() == 3 and Tp <= _MOSAIC_T_MAX:
        return first_valid.mosaic_first_valid_kernel(stack, valid)
    return mosaic_first_valid(stack, valid)


def mosaic_stack_host(rasters, nodata_masks, timestamps,
                      exclude_masks=None, weights=None):
    """`mosaic_stack` with the result pulled back to host numpy."""
    out, ok = mosaic_stack(rasters, nodata_masks, timestamps,
                           exclude_masks, weights)
    return out.cpu().numpy(), ok.cpu().numpy()
