"""Dataset -> granule expansion: the axis-intersection odometer.

Counterpart of `gsky_tpu/pipeline/granule.py` (the same logic: it is
host-only and runs unchanged).

Port of the tile indexer's generalised N-D axis selection
(`processor/tile_indexer.go:459-531,590-813`): for each MAS dataset,
intersect the request's time range / axis selectors with the dataset's
axes, then emit one granule per (file, band/axis-combination), suffixing
namespaces with ``var#axis=value`` when an axis expands into multiple
values.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..index.client import Dataset
from .types import AxisSelector, Granule


def _select_time_indices(timestamps: Sequence[float],
                         start: Optional[float],
                         end: Optional[float]) -> List[int]:
    """Indices of timestamps within [start, end] (end exclusive when a
    range is given, matching `doSelectionByRange`'s t >= start && t < end;
    a point query start==end selects exact matches)."""
    if not timestamps:
        return []
    if start is None:
        return list(range(len(timestamps)))
    out = []
    for i, t in enumerate(timestamps):
        if end is None or end == start:
            if abs(t - start) < 1.0:
                out.append(i)
        elif start <= t < end:
            out.append(i)
    return out


def expand_granules(datasets: Sequence[Dataset],
                    start_time: Optional[float],
                    end_time: Optional[float],
                    axes: Sequence[AxisSelector] = ()) -> List[Granule]:
    """One granule per (dataset, selected time, selected extra-axis
    combination)."""
    out: List[Granule] = []
    axsel = {a.name: a for a in axes}
    for ds in datasets:
        up = ds.ds_name.upper()
        # GMT grids share the .nc extension but are flat one-band
        # rasters — they route through the registry, not the NetCDF
        # variable model
        is_nc = not up.startswith("GMT:") and (
            up.startswith("NETCDF:")
            or ds.file_path.lower().endswith((".nc", ".nc4")))
        var_name = ""
        if is_nc:
            var_name = ds.ds_name.split(":")[-1].strip('"')
        # band number recorded by the crawler for multiband GeoTIFFs
        band0 = 1
        if not is_nc and ":" in ds.ds_name \
                and ds.ds_name.rsplit(":", 1)[-1].isdigit():
            band0 = int(ds.ds_name.rsplit(":", 1)[-1])

        # time selection
        tsel = axsel.get("time")
        if tsel is not None and tsel.start is not None:
            tidx = _select_time_indices(ds.timestamps, tsel.start, tsel.end)
        else:
            tidx = _select_time_indices(ds.timestamps, start_time, end_time)
        if not ds.timestamps:
            tidx = [-1]  # untimed dataset: single granule

        # extra axes (odometer over value selections)
        extra = [a for a in ds.axes if a.name != "time"]
        combos: List[List[tuple]] = [[]]
        for ax in extra:
            sel = axsel.get(ax.name)
            values = list(ax.params)
            idxs = list(range(len(values)))
            if sel is not None:
                if sel.in_values:
                    idxs = [i for i, v in enumerate(values)
                            if any(abs(v - w) < 1e-9 for w in sel.in_values)]
                elif sel.start is not None:
                    hi = sel.end if sel.end is not None else sel.start
                    if hi == sel.start:
                        idxs = [i for i, v in enumerate(values)
                                if abs(v - sel.start) < 1e-9]
                    else:
                        idxs = [i for i, v in enumerate(values)
                                if sel.start <= v < hi]
                elif sel.idx_start is not None:
                    stop = sel.idx_end + 1 if sel.idx_end is not None \
                        else len(values)
                    idxs = list(range(sel.idx_start, min(stop, len(values)),
                                      max(sel.idx_step, 1)))
            elif len(values) > 1:
                idxs = idxs[:1]  # unselected multi-value axis: first value
            combos = [c + [(ax, i)] for c in combos for i in idxs]

        for ti in tidx:
            for combo in combos:
                ns = ds.namespace
                band = band0
                time_index = ti if ti >= 0 else None
                if is_nc and ti >= 0:
                    band = ti + 1
                # apply extra-axis strides to the band index and suffix
                # namespaces (`tile_indexer.go:493-516`)
                for ax, i in combo:
                    if ax.strides:
                        band += ax.strides[0] * i
                    val = ax.params[i] if i < len(ax.params) else i
                    ns = f"{ns}#{ax.name}={val:g}"
                ts = ds.timestamps[ti] if ti >= 0 else 0.0
                out.append(Granule(
                    path=ds.file_path,
                    ds_name=ds.ds_name,
                    namespace=ns,
                    base_namespace=ds.namespace,
                    band=band,
                    time_index=time_index,
                    timestamp=ts,
                    srs=ds.srs,
                    geo_transform=list(ds.geo_transform or ()),
                    nodata=ds.nodata,
                    array_type=ds.array_type,
                    is_netcdf=is_nc,
                    var_name=var_name,
                    geo_loc=ds.geo_loc,
                    polygon=ds.polygon,
                ))
    # dedup (the gRPC stage dedups granules, `tile_grpc.go:78-83`)
    seen = set()
    uniq = []
    for g in out:
        key = (g.path, g.namespace, g.band, g.timestamp)
        if key not in seen:
            seen.add(key)
            uniq.append(g)
    return uniq
