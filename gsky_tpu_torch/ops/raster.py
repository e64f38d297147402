"""Raster value types: GDAL type names and the nodata mask.

Counterpart of the host parts of `gsky_tpu/ops/raster.py` the tile path
uses (the crawler's type tag and the scene cache's validity encode).
"""

from __future__ import annotations

import numpy as np

DTYPE_NP = {
    "Byte": np.uint8,
    "SignedByte": np.int8,
    "Int16": np.int16,
    "UInt16": np.uint16,
    "Int32": np.int32,
    "UInt32": np.uint32,
    "Float32": np.float32,
    "Float64": np.float64,
}

NP_TO_GDAL = {np.dtype(v): k for k, v in DTYPE_NP.items()}


def nodata_mask(data: np.ndarray, nodata) -> np.ndarray:
    """True where VALID.  NaN nodata means 'NaN is nodata'; NaN data
    values are always invalid."""
    finite = ~np.isnan(data) if data.dtype.kind == "f" \
        else np.ones(data.shape, bool)
    if nodata is None:
        return finite
    if isinstance(nodata, float) and np.isnan(nodata):
        return finite
    return finite & (data != nodata)
