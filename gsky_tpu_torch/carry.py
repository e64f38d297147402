"""Carrying state across from the JAX package.

This system's state is data, not weights: the metadata index, staged
page pools, device scenes, decoded granule windows and resident drill
stacks.  These helpers load a JAX-side snapshot, taken as numpy arrays
or plain dicts, into the port's containers, so both packages can be fed
identical state.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .device import resolve_device
from .geo.crs import CRS
from .geo.transform import GeoTransform
from .index.store import MASStore
from .pipeline.decode import DecodedWindow
from .pipeline.drill_cache import DeviceStack, stack_from_numpy
from .pipeline.pages import PagePool
from .pipeline.scene_cache import DeviceScene


def pool_from_reference(pool_np: np.ndarray, slots, device="cuda") \
        -> PagePool:
    """A port `PagePool` holding a JAX pool's pages: ``pool_np`` is
    ``np.asarray(jax_pool._pool)`` (capacity, pr, pc) f32 and ``slots``
    its ``_slots`` map {(serial, pi, pj): slot} in LRU order."""
    pool_np = np.asarray(pool_np, np.float32)
    cap, pr, pc = pool_np.shape
    pool = PagePool(capacity=cap, page_rows=pr, page_cols=pc,
                    device=device)
    used = set()
    pool._slots = OrderedDict()
    for key, slot in slots.items():
        pool._slots[tuple(int(k) for k in key)] = int(slot)
        used.add(int(slot))
    pool._free = [s for s in range(cap - 1, 0, -1) if s not in used]
    pool._pool = torch.from_numpy(pool_np.copy()).to(pool.device)
    return pool


def scene_from_numpy(data: np.ndarray, height: int, width: int,
                     gt: GeoTransform, crs: CRS, serial: int,
                     nodata: float = float("nan"),
                     device="cuda") -> DeviceScene:
    """A `DeviceScene` from the same NaN-encoded, bucket-padded f32
    array a JAX `DeviceScene.dev` holds."""
    dev = torch.from_numpy(np.ascontiguousarray(data, np.float32)) \
        .to(resolve_device(device))
    return DeviceScene(dev=dev, height=int(height), width=int(width),
                       nodata=float(nodata), gt=gt, crs=crs,
                       serial=int(serial))


def decoded_window_from_numpy(data: np.ndarray, valid: np.ndarray,
                              window_gt: GeoTransform, src_crs: CRS,
                              granule, device="cuda") -> DecodedWindow:
    """A port `DecodedWindow` on ``device`` from a JAX `DecodedWindow`'s
    numpy data (h, w) f32 and valid (h, w) bool, its window geotransform
    and source CRS (taken as the port's types) and the port's granule."""
    dev = resolve_device(device)
    return DecodedWindow(
        granule,
        torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev),
        window_gt, src_crs)


def drill_stack_from_numpy(stack_np: np.ndarray, nodata,
                           device="cuda") -> DeviceStack:
    """A resident drill `DeviceStack` from the (T, H, W) native-dtype
    array a JAX `DeviceStack.dev` holds (``np.asarray(st.dev)``) and its
    nodata (NaN or None when absent)."""
    return stack_from_numpy(np.array(stack_np), nodata, device)


def store_from_reference(records: Iterable[Dict],
                         store: Optional[object] = None):
    """A port MAS store holding the records a JAX `MASStore` ingested
    (the crawler's ``{"filename", "file_type", "geo_metadata"}`` dicts),
    so both packages index the same datasets even where one crawler
    would read a file differently.  ``store``: a `MASStore` or
    `MASShardedStore` to fill (default a new in-memory `MASStore`)."""
    store = store if store is not None else MASStore()
    store.ingest_many([copy.deepcopy(r) for r in records])
    return store
