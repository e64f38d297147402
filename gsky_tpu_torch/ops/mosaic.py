"""Temporal mosaic ordering.

Counterpart of `gsky_tpu/ops/mosaic.py::priority_order`: the granule
priority the fused warp-render kernels mosaic by.
"""

from __future__ import annotations

from typing import List, Sequence


def priority_order(timestamps: Sequence[float]) -> List[int]:
    """Granule indices in mosaic priority order (highest first): newest
    timestamp first; among equal timestamps, later arrival first."""
    return sorted(range(len(timestamps)),
                  key=lambda i: (-timestamps[i], -i))
