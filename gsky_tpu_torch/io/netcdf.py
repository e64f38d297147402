"""NetCDF reading and writing, with CF georeferencing.

Counterpart of `gsky_tpu/io/netcdf.py`: NetCDF-3 classic and 64-bit
offset through a built-in streaming parser (only the header is held in
memory; `read_slice` reads the byte range of one (time, y, x)
hyperslab), NetCDF-4 (HDF5) through ``h5py`` where it imports, the CF
helpers (time units, grid mapping -> CRS, fill values -> nodata) and
the NetCDF-3 CF writer.  ``h5py`` is imported when an HDF5 file is
opened, never at module import; without it such a file raises
ValueError naming the missing package.
"""

from __future__ import annotations

import datetime as dt
import os
import re
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geo.crs import CRS, EPSG4326, Ellipsoid, parse_crs
from ..geo.transform import GeoTransform

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"

# ---------------------------------------------------------------------------
# CF time
# ---------------------------------------------------------------------------

_UNIT_SECONDS = {
    "second": 1.0, "seconds": 1.0, "sec": 1.0, "secs": 1.0, "s": 1.0,
    "minute": 60.0, "minutes": 60.0, "min": 60.0, "mins": 60.0,
    "hour": 3600.0, "hours": 3600.0, "h": 3600.0, "hr": 3600.0,
    "hrs": 3600.0,
    "day": 86400.0, "days": 86400.0, "d": 86400.0,
}

_EPOCH = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)


def parse_cf_time_units(units: str) -> Tuple[float, float]:
    """'days since 2000-01-01 00:00:0.0' -> (seconds_per_unit,
    epoch_unix_seconds)."""
    m = re.match(
        r"\s*(\w+)\s+since\s+(\d{1,4})-(\d{1,2})-(\d{1,2})"
        r"(?:[T ](\d{1,2}):(\d{1,2}):(\d{1,2}(?:\.\d*)?))?",
        units)
    if not m:
        raise ValueError(f"cannot parse CF time units {units!r}")
    mult = _UNIT_SECONDS.get(m.group(1).lower())
    if mult is None:
        raise ValueError(f"unsupported CF time unit {m.group(1)!r}")
    sec = float(m.group(7) or 0)
    base = dt.datetime(int(m.group(2)), int(m.group(3)), int(m.group(4)),
                       int(m.group(5) or 0), int(m.group(6) or 0),
                       int(sec), int((sec % 1) * 1e6),
                       tzinfo=dt.timezone.utc)
    return mult, (base - _EPOCH).total_seconds()


def cf_times_to_unix(values: np.ndarray, units: str) -> np.ndarray:
    mult, epoch = parse_cf_time_units(units)
    return np.asarray(values, np.float64) * mult + epoch


# ---------------------------------------------------------------------------
# CF grid mapping -> CRS
# ---------------------------------------------------------------------------

def crs_from_cf(attrs: Dict[str, object]) -> CRS:
    """A CRS from a CF grid-mapping variable's attributes (or its
    embedded ``spatial_ref`` / ``crs_wkt``)."""
    for key in ("spatial_ref", "crs_wkt"):
        wkt = attrs.get(key)
        if isinstance(wkt, bytes):
            wkt = wkt.decode("latin-1")
        if isinstance(wkt, str) and wkt.strip():
            try:
                return parse_crs(wkt)
            except ValueError:
                pass
    name = attrs.get("grid_mapping_name", "")
    if isinstance(name, bytes):
        name = name.decode("latin-1")

    def f(key, default=0.0):
        v = attrs.get(key, default)
        if isinstance(v, (np.ndarray, list, tuple)):
            v = np.asarray(v).reshape(-1)[0]
        return float(v)

    a = f("semi_major_axis", 6378137.0)
    b = f("semi_minor_axis", 0.0)
    inv_f = f("inverse_flattening", 0.0)
    if inv_f:
        ellps = Ellipsoid(a, 1.0 / inv_f)
    elif b:
        ellps = Ellipsoid(a, (a - b) / a)
    else:
        ellps = Ellipsoid(a, 1.0 / 298.257223563)

    if name == "latitude_longitude" or not name:
        return EPSG4326
    if name == "transverse_mercator":
        return CRS("tmerc", ellps,
                   lon0=f("longitude_of_central_meridian"),
                   lat0=f("latitude_of_projection_origin"),
                   k0=f("scale_factor_at_central_meridian", 1.0),
                   x0=f("false_easting"), y0=f("false_northing"))
    if name == "albers_conical_equal_area":
        sp = attrs.get("standard_parallel", (0.0, 0.0))
        sp = np.asarray(sp).reshape(-1)
        return CRS("aea", ellps,
                   lon0=f("longitude_of_central_meridian"),
                   lat0=f("latitude_of_projection_origin"),
                   lat1=float(sp[0]), lat2=float(sp[-1]),
                   x0=f("false_easting"), y0=f("false_northing"))
    if name == "lambert_conformal_conic":
        sp = np.asarray(attrs.get("standard_parallel", (0.0,))).reshape(-1)
        return CRS("lcc", ellps,
                   lon0=f("longitude_of_central_meridian"),
                   lat0=f("latitude_of_projection_origin"),
                   lat1=float(sp[0]), lat2=float(sp[-1]),
                   x0=f("false_easting"), y0=f("false_northing"))
    if name == "sinusoidal":
        return CRS("sinu", Ellipsoid(a, 0.0),
                   lon0=f("longitude_of_projection_origin"),
                   x0=f("false_easting"), y0=f("false_northing"))
    if name == "geostationary":
        return CRS("geos", ellps,
                   lon0=f("longitude_of_projection_origin"),
                   h=f("perspective_point_height"),
                   x0=f("false_easting"), y0=f("false_northing"))
    if name == "mercator":
        return CRS("merc", ellps,
                   lon0=f("longitude_of_projection_origin"),
                   k0=f("scale_factor_at_projection_origin", 1.0),
                   x0=f("false_easting"), y0=f("false_northing"))
    raise ValueError(f"unsupported grid_mapping_name {name!r}")


# ---------------------------------------------------------------------------
# Variable model
# ---------------------------------------------------------------------------

@dataclass
class NCVar:
    name: str
    dims: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: np.dtype
    attrs: Dict[str, object]
    _reader: object = field(repr=False, default=None)

    def __getitem__(self, key):
        return self._reader(key)

    @property
    def nodata(self) -> Optional[float]:
        unsigned = str(self.attrs.get("_Unsigned", "")).lower() \
            in ("true", "1")
        for k in ("_FillValue", "missing_value", "nodata"):
            if k in self.attrs:
                v = self.attrs[k]
                if isinstance(v, (np.ndarray, list, tuple)):
                    v = np.asarray(v).reshape(-1)[0]
                if unsigned and isinstance(v, np.signedinteger):
                    v = v.astype(v.dtype).view(
                        np.dtype(f"u{v.dtype.itemsize}"))
                try:
                    return float(v)
                except (TypeError, ValueError):
                    return None
        return None


def _h5py():
    """The ``h5py`` module, imported on first use: NetCDF-4 is optional,
    and a file that needs it raises ValueError (the error the crawler
    records) when it is missing."""
    try:
        import h5py
    except ImportError as e:
        raise ValueError(
            "NetCDF-4/HDF5 files need the optional h5py package, which "
            f"is not installed ({e})") from None
    return h5py


class NetCDF:
    """Uniform facade over NetCDF-3 (built-in) and NetCDF-4 (h5py)."""

    def __init__(self, path: str):
        self.path = path
        self._nc3 = None
        self._h5 = None
        with open(path, "rb") as fp:
            magic = fp.read(8)
        if magic[:3] == b"CDF":
            self._nc3 = _NC3File(path)
            self.variables = self._nc3.variables
            self.attrs = self._nc3.attrs
        elif magic[:8] == _HDF5_MAGIC:
            h5py = _h5py()
            self._h5 = h5py.File(path, "r")
            self.variables = {}
            self._h5_datasets: Dict[str, object] = {}
            self.attrs = {k: self._h5.attrs[k] for k in self._h5.attrs}

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    attrs = {k: obj.attrs[k] for k in obj.attrs}
                    dims = tuple(
                        (d.label or (d[0].name.split("/")[-1]
                                     if len(d) else ""))
                        for d in obj.dims) if obj.dims else ()
                    if not any(dims):
                        dims = tuple(f"dim{i}" for i in range(obj.ndim))
                    key = name.split("/")[-1]
                    self.variables[key] = NCVar(
                        key, dims, obj.shape, obj.dtype, attrs,
                        _reader=obj.__getitem__)
                    self._h5_datasets[key] = obj
            self._h5.visititems(visit)
        else:
            raise ValueError(f"{path}: not a NetCDF file")

    def close(self):
        if self._h5 is not None:
            self._h5.close()
        if self._nc3 is not None:
            self._nc3._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- georeferencing ------------------------------------------------------

    def raster_vars(self) -> List[NCVar]:
        """Data variables with >= 2 dims whose trailing dims look
        spatial."""
        out = []
        coord_names = {"x", "y", "lon", "lat", "longitude", "latitude",
                       "time", "crs", "spatial_ref"}
        for v in self.variables.values():
            if v.name.lower() in coord_names or v.name.startswith("lambert"):
                continue
            if len(v.shape) >= 2 and v.shape[-1] > 1 and v.shape[-2] > 1 \
                    and v.dtype.kind in "iuf":
                out.append(v)
        return out

    def geoloc_vars(self) -> Optional[Tuple[NCVar, NCVar]]:
        """The 2-D (lon, lat) geolocation-array pair of a curvilinear
        product, or None for regular grids."""
        def find(names, std_names):
            for v in self.variables.values():
                sn = v.attrs.get("standard_name", b"")
                if isinstance(sn, bytes):
                    sn = sn.decode("latin-1")
                if (v.name.lower() in names or sn in std_names) \
                        and len(v.shape) == 2:
                    return v
            return None

        gx = find(("lon", "longitude", "lons"), ("longitude",))
        gy = find(("lat", "latitude", "lats"), ("latitude",))
        if gx is None or gy is None or gx.shape != gy.shape:
            return None
        return gx, gy

    def _axis_var(self, names: Sequence[str],
                  std_names: Sequence[str]) -> Optional[NCVar]:
        for v in self.variables.values():
            sn = v.attrs.get("standard_name", b"")
            if isinstance(sn, bytes):
                sn = sn.decode("latin-1")
            if v.name.lower() in names or sn in std_names:
                if len(v.shape) == 1:
                    return v
        return None

    def geotransform(self, var: Optional[NCVar] = None) -> GeoTransform:
        xv = self._axis_var(("x", "lon", "longitude"),
                            ("projection_x_coordinate", "longitude"))
        yv = self._axis_var(("y", "lat", "latitude"),
                            ("projection_y_coordinate", "latitude"))
        if xv is None or yv is None:
            raise ValueError("no coordinate variables found")
        x = np.asarray(xv[:], np.float64)
        y = np.asarray(yv[:], np.float64)
        dx = (x[-1] - x[0]) / (len(x) - 1)
        dy = (y[-1] - y[0]) / (len(y) - 1)
        # coords are cell centres
        return GeoTransform(x[0] - dx / 2, dx, 0.0, y[0] - dy / 2, 0.0, dy)

    def crs(self, var: Optional[NCVar] = None) -> CRS:
        gm_name = None
        if var is not None:
            gm = var.attrs.get("grid_mapping")
            if isinstance(gm, bytes):
                gm = gm.decode("latin-1")
            gm_name = gm
        candidates = []
        if gm_name and gm_name in self.variables:
            candidates.append(self.variables[gm_name])
        for v in self.variables.values():
            if "grid_mapping_name" in v.attrs or "spatial_ref" in v.attrs:
                candidates.append(v)
        for c in candidates:
            try:
                return crs_from_cf(c.attrs)
            except ValueError:
                continue
        # lon/lat coordinate names imply geographic
        return EPSG4326

    def timestamps(self) -> Optional[np.ndarray]:
        tv = self._axis_var(("time", "t"), ("time",))
        if tv is None:
            return None
        units = tv.attrs.get("units", b"")
        if isinstance(units, bytes):
            units = units.decode("latin-1")
        if not units:
            return np.asarray(tv[:], np.float64)
        return cf_times_to_unix(np.asarray(tv[:]), units)

    def read_slice(self, var_name: str, time_index: Optional[int] = None,
                   window: Optional[Tuple[int, int, int, int]] = None,
                   step: int = 1) -> np.ndarray:
        """One (y, x) hyperslab of one timestep.  window = (col0, row0,
        w, h) in full-resolution pixels; ``step`` > 1 keeps every
        step-th pixel."""
        v = self.variables[var_name]
        if window is not None:
            c0, r0, w, h = window
            ys = slice(r0, r0 + h, step if step > 1 else None)
            xs = slice(c0, c0 + w, step if step > 1 else None)
        elif step > 1:
            ys = slice(None, None, step)
            xs = slice(None, None, step)
        else:
            ys = slice(None)
            xs = slice(None)
        if len(v.shape) == 2:
            return np.asarray(v[(ys, xs)])
        if len(v.shape) == 3:
            t = 0 if time_index is None else time_index
            return np.asarray(v[(t, ys, xs)])
        if len(v.shape) == 4:
            t = 0 if time_index is None else time_index
            return np.asarray(v[(t, 0, ys, xs)])
        raise ValueError(f"unsupported rank {len(v.shape)} for {var_name}")

    def chunk_map(self, var_name: str) -> Dict[str, object]:
        """The chunk index of one variable, for ranged readers: NetCDF-3
        layouts are exact byte arithmetic (begin, record stride, row
        bytes); NetCDF-4 reports the HDF5 chunk shape and count (h5py
        owns the B-tree)."""
        v = self.variables[var_name]
        if self._nc3 is not None:
            rd = v._reader
            if not isinstance(rd, _NC3Reader):
                raise ValueError(f"{var_name}: no NC3 layout")
            itemsize = rd.dt.itemsize
            return {"kind": "nc3", "begin": rd.begin,
                    "record": rd.is_record, "rec_stride": rd.rec_stride,
                    "itemsize": itemsize, "shape": tuple(v.shape),
                    "row_bytes": int(v.shape[-1]) * itemsize}
        ds = self._h5_datasets.get(var_name)
        if ds is None:
            raise KeyError(var_name)
        out: Dict[str, object] = {
            "kind": "hdf5", "shape": tuple(v.shape),
            "chunks": tuple(ds.chunks) if ds.chunks else None}
        try:
            out["nchunks"] = int(ds.id.get_num_chunks())
        except Exception:
            out["nchunks"] = None
        return out


# ---------------------------------------------------------------------------
# NetCDF-3 classic parser
# ---------------------------------------------------------------------------

_NC3_DTYPES = {1: np.dtype(">i1"), 2: np.dtype("S1"), 3: np.dtype(">i2"),
               4: np.dtype(">i4"), 5: np.dtype(">f4"), 6: np.dtype(">f8")}


class _NC3File:
    """Streaming reader: only the header is parsed into memory; data
    reads seek and read the exact byte ranges."""

    def __init__(self, path: str):
        self.path = path
        self._fp = open(path, "rb")
        self._fp_lock = threading.Lock()
        self._size = os.fstat(self._fp.fileno()).st_size
        b = self._fp.read(4)
        if b[:3] != b"CDF" or b[3] not in (1, 2):
            raise ValueError("not a NetCDF classic file")
        self._64bit = b[3] == 2
        self.numrecs = self._u32()
        self.dims: List[Tuple[str, int]] = []
        self.attrs: Dict[str, object] = {}
        self.variables: Dict[str, NCVar] = {}
        self._parse_dims()
        self.attrs = self._parse_atts()
        self._parse_vars()

    def read_at(self, pos: int, n: int) -> bytes:
        # bound by the actual file: a corrupt header can declare huge
        # dims, and fp.read(n) allocates n bytes before reading
        if pos < 0 or n < 0 or pos + n > self._size:
            raise ValueError(
                f"corrupt NetCDF: read [{pos}, {pos + n}) beyond "
                f"file size {self._size}")
        with self._fp_lock:  # shared handles are read from many threads
            self._fp.seek(pos)
            return self._fp.read(n)

    # -- primitive header readers --

    def _u32(self) -> int:
        return struct.unpack(">I", self._fp.read(4))[0]

    def _u64(self) -> int:
        return struct.unpack(">Q", self._fp.read(8))[0]

    def _offset(self) -> int:
        return self._u64() if self._64bit else self._u32()

    def _header_read(self, n: int) -> bytes:
        if n < 0 or n > self._size:
            raise ValueError(
                f"corrupt NetCDF: header field declares {n} bytes "
                f"(file is {self._size})")
        return self._fp.read(n)

    def _name(self) -> str:
        n = self._u32()
        s = self._header_read(n).decode("utf-8")
        self._fp.read((4 - n % 4) % 4)
        return s

    def _parse_dims(self):
        tag = self._u32()
        n = self._u32()
        if tag == 0 and n == 0:
            return
        if tag != 0x0A:
            raise ValueError("bad NC_DIMENSION tag")
        for _ in range(n):
            name = self._name()
            size = self._u32()
            self.dims.append((name, size))

    def _parse_atts(self) -> Dict[str, object]:
        tag = self._u32()
        n = self._u32()
        out: Dict[str, object] = {}
        if tag == 0 and n == 0:
            return out
        if tag != 0x0C:
            raise ValueError("bad NC_ATTRIBUTE tag")
        for _ in range(n):
            name = self._name()
            typ = self._u32()
            cnt = self._u32()
            dt_ = _NC3_DTYPES[typ]
            nb = dt_.itemsize * cnt
            raw = self._header_read(nb)
            self._fp.read((4 - nb % 4) % 4)
            if typ == 2:
                out[name] = raw.decode("latin-1")
            else:
                arr = np.frombuffer(raw, dt_)
                out[name] = arr[0] if cnt == 1 else arr
        return out

    def _parse_vars(self):
        tag = self._u32()
        n = self._u32()
        if tag == 0 and n == 0:
            return
        if tag != 0x0B:
            raise ValueError("bad NC_VARIABLE tag")
        rec_vars = []
        for _ in range(n):
            name = self._name()
            ndims = self._u32()
            dimids = [self._u32() for _ in range(ndims)]
            attrs = self._parse_atts()
            typ = self._u32()
            vsize = self._u32()
            begin = self._offset()
            dt_ = _NC3_DTYPES[typ]
            dim_names = tuple(self.dims[d][0] for d in dimids)
            shape = tuple(self.dims[d][1] for d in dimids)
            is_record = bool(shape) and shape[0] == 0
            if is_record:
                shape = (self.numrecs,) + shape[1:]
            var = NCVar(name, dim_names, shape, dt_.newbyteorder("="), attrs)
            var._reader = _NC3Reader(self, var, dt_, begin, vsize, is_record)
            self.variables[name] = var
            if is_record:
                rec_vars.append(var)
        # record stride: the sum of padded vsizes, except with exactly
        # one record variable, whose records are packed unpadded
        if len(rec_vars) == 1:
            self._rec_stride = rec_vars[0]._reader.vsize_unpadded
        else:
            self._rec_stride = sum(v._reader.vsize_padded for v in rec_vars)
        for v in rec_vars:
            v._reader.rec_stride = self._rec_stride


class _NC3Reader:
    def __init__(self, f: _NC3File, var: NCVar, dt_: np.dtype, begin: int,
                 vsize: int, is_record: bool):
        self.f = f
        self.var = var
        self.dt = dt_
        self.begin = begin
        self.is_record = is_record
        per_rec = int(np.prod(var.shape[1:], dtype=np.int64)) if is_record \
            else int(np.prod(var.shape, dtype=np.int64))
        nb = per_rec * dt_.itemsize
        self.vsize_unpadded = nb
        self.vsize_padded = nb + ((4 - nb % 4) % 4)
        self.rec_stride = self.vsize_padded

    def __call__(self, key):
        var = self.var
        if self.is_record:
            # materialise the requested records only (seek per record)
            shape_rest = var.shape[1:]
            per_rec = int(np.prod(shape_rest, dtype=np.int64))
            if isinstance(key, tuple):
                tkey, rest = key[0], key[1:]
            else:
                tkey, rest = key, ()
            if isinstance(tkey, slice):
                idxs = range(var.shape[0])[tkey]
            else:
                t = int(tkey)
                if t < 0:
                    t += var.shape[0]
                if not 0 <= t < var.shape[0]:
                    raise IndexError(
                        f"record index {tkey} out of range for "
                        f"{var.name} with {var.shape[0]} records")
                idxs = [t]
            recs = []
            for t in idxs:
                off = self.begin + t * self.rec_stride
                raw = self.f.read_at(off, per_rec * self.dt.itemsize)
                recs.append(np.frombuffer(raw, self.dt).reshape(shape_rest))
            if isinstance(tkey, slice):
                arr = np.stack(recs)
                out = arr[(slice(None),) + rest] if rest else arr
            else:
                arr = recs[0]
                out = arr[rest] if rest else arr
        else:
            out = self._fixed(key, var)
        out = np.ascontiguousarray(out).astype(self.dt.newbyteorder("="))
        # NetCDF-3 has no unsigned types; honour the _Unsigned convention
        if str(var.attrs.get("_Unsigned", "")).lower() in ("true", "1") \
                and out.dtype.kind == "i":
            out = out.view(np.dtype(f"u{out.dtype.itemsize}"))
        return out

    def _fixed(self, key, var):
        """Fixed (non-record) variable read.  A selection on the leading
        axis reads only that byte range: serving one timestep of a
        (T, H, W) stack does not read all T frames."""
        itemsize = self.dt.itemsize
        if key is not None and var.shape:
            per0 = int(np.prod(var.shape[1:], dtype=np.int64))
            k0, rest = (key[0], key[1:]) if isinstance(key, tuple) \
                else (key, ())
            if isinstance(k0, (int, np.integer)):
                t = int(k0)
                if t < 0:
                    t += var.shape[0]
                if not 0 <= t < var.shape[0]:
                    raise IndexError(
                        f"index {k0} out of range for {var.name}")
                raw = self.f.read_at(self.begin + t * per0 * itemsize,
                                     per0 * itemsize)
                arr = np.frombuffer(raw, self.dt).reshape(var.shape[1:])
                return arr[rest] if rest else arr
            if isinstance(k0, slice):
                lo, hi, step = k0.indices(var.shape[0])
                if step == 1 and hi > lo:
                    raw = self.f.read_at(
                        self.begin + lo * per0 * itemsize,
                        (hi - lo) * per0 * itemsize)
                    arr = np.frombuffer(raw, self.dt).reshape(
                        (hi - lo,) + var.shape[1:])
                    return arr[(slice(None),) + rest] if rest else arr
        total = int(np.prod(var.shape, dtype=np.int64))
        raw = self.f.read_at(self.begin, total * itemsize)
        arr = np.frombuffer(raw, self.dt).reshape(var.shape)
        return arr[key] if key is not None else arr


# ---------------------------------------------------------------------------
# NetCDF-3 classic writer
# ---------------------------------------------------------------------------

def write_netcdf3(path: str, arrays: Dict[str, np.ndarray],
                  x: np.ndarray, y: np.ndarray,
                  crs: CRS = EPSG4326,
                  times: Optional[np.ndarray] = None,
                  nodata: Optional[float] = None,
                  global_attrs: Optional[Dict[str, str]] = None):
    """Minimal CF NetCDF-3 writer: variables shaped (y, x) or
    (time, y, x).  Writes the same bytes as the reference's writer."""
    for name, arr in arrays.items():
        shp = np.asarray(arr).shape
        want = (len(y), len(x))
        if shp[-2:] != want:
            # declaring (y, x) dims over differently-shaped data would
            # write a corrupt file (header/data size mismatch)
            raise ValueError(
                f"variable {name!r} shape {shp} does not match the "
                f"declared (y, x) dims {want}")
    dims: List[Tuple[str, int]] = []
    if times is not None:
        dims.append(("time", len(times)))
    dims.append(("y", len(y)))
    dims.append(("x", len(x)))

    variables = []  # (name, dims, attrs, np_array)
    variables.append(("x", ("x",), {
        "standard_name": "projection_x_coordinate" if not crs.is_geographic
        else "longitude", "units": "m" if not crs.is_geographic else
        "degrees_east"}, np.asarray(x, np.float64)))
    variables.append(("y", ("y",), {
        "standard_name": "projection_y_coordinate" if not crs.is_geographic
        else "latitude", "units": "m" if not crs.is_geographic else
        "degrees_north"}, np.asarray(y, np.float64)))
    if times is not None:
        variables.append(("time", ("time",), {
            "standard_name": "time",
            "units": "seconds since 1970-01-01 00:00:00"},
            np.asarray(times, np.float64)))
    crs_attrs: Dict[str, object] = {"spatial_ref": crs.to_wkt()}
    variables.append(("crs", (), crs_attrs, np.zeros((), np.int32)))
    for vname, arr in arrays.items():
        va: Dict[str, object] = {"grid_mapping": "crs"}
        if arr.dtype.kind == "u":
            va["_Unsigned"] = "true"
        if nodata is not None:
            va["_FillValue"] = np.asarray(nodata, arr.dtype)
        vdims = ("time", "y", "x") if (times is not None and arr.ndim == 3) \
            else ("y", "x")
        variables.append((vname, vdims, va, arr))

    write_netcdf3_raw(path, dims, variables,
                      dict(global_attrs or {"Conventions": "CF-1.6"}))


def _nc3_name_pad(s: bytes) -> bytes:
    return struct.pack(">I", len(s)) + s + b"\0" * ((4 - len(s) % 4) % 4)


def _nc3_type(arr: np.ndarray) -> Tuple[int, np.ndarray]:
    """-> (nc_type, the array as the big-endian type it is stored as).
    NetCDF-3 has no unsigned types: u1/u2/u4 are bit-reinterpreted into
    the signed type of the same width (the _Unsigned convention)."""
    k = np.dtype(arr.dtype).newbyteorder("=").str[1:]
    if k in ("u1", "u2", "u4"):
        typ = {"u1": 1, "u2": 3, "u4": 4}[k]
        return typ, arr.astype(f">u{arr.dtype.itemsize}").view(
            _NC3_DTYPES[typ])
    if k == "i8":
        if arr.size and (arr.max() > 2**31 - 1 or arr.min() < -2**31):
            raise ValueError("int64 values exceed NetCDF-3 int range")
        arr = arr.astype(np.int32)
        k = "i4"
    if k not in ("i1", "i2", "i4", "f4", "f8"):
        raise ValueError(f"dtype {arr.dtype} not representable in "
                         "NetCDF-3 classic")
    typ = {"i1": 1, "i2": 3, "i4": 4, "f4": 5, "f8": 6}[k]
    return typ, arr.astype(_NC3_DTYPES[typ])


def _nc3_atts(d: Dict[str, object]) -> bytes:
    if not d:
        return struct.pack(">II", 0, 0)
    out = struct.pack(">II", 0x0C, len(d))
    for k, v in d.items():
        out += _nc3_name_pad(k.encode())
        if isinstance(v, str):
            raw = v.encode("latin-1")
            out += struct.pack(">II", 2, len(raw)) + raw \
                + b"\0" * ((4 - len(raw) % 4) % 4)
        else:
            arr = np.atleast_1d(np.asarray(v))
            typ, be = _nc3_type(arr)
            raw = be.tobytes()
            out += struct.pack(">II", typ, len(arr)) + raw \
                + b"\0" * ((4 - len(raw) % 4) % 4)
    return out


def write_netcdf3_raw(path: str, dims, variables, global_attrs):
    """Low-level NetCDF-3 classic writer: ``dims`` an ordered list of
    (name, size), ``variables`` a list of (name, dim_names, attrs,
    array).  The data section is streamed variable by variable, so a
    gigabyte stack is not copied into one bytes object first."""
    dimid = {name: i for i, (name, _) in enumerate(dims)}
    header = b"CDF\x01" + struct.pack(">I", 0)  # numrecs 0 (no record vars)
    header += struct.pack(">II", 0x0A, len(dims))
    for dname, dsize in dims:
        header += _nc3_name_pad(dname.encode()) + struct.pack(">I", dsize)
    header += _nc3_atts(dict(global_attrs or {}))

    entries = []
    for vname, vdims, vattrs, arr in variables:
        typ, be = _nc3_type(np.asarray(arr))
        ent = _nc3_name_pad(vname.encode())
        ent += struct.pack(">I", len(vdims))
        for dn in vdims:
            ent += struct.pack(">I", dimid[dn])
        ent += _nc3_atts(vattrs)
        nbytes = be.nbytes
        vsize = nbytes + ((4 - nbytes % 4) % 4)
        ent += struct.pack(">II", typ, vsize)
        entries.append((ent, vsize, be))

    begin = len(header) + 8 + sum(len(e) + 4 for e, _, _ in entries)
    var_table = struct.pack(">II", 0x0B, len(entries))
    for ent, vsize, _ in entries:
        var_table += ent + struct.pack(">I", begin)
        begin += vsize
    with open(path, "wb") as fp:
        fp.write(header + var_table)
        for _, vsize, be in entries:
            np.ascontiguousarray(be).tofile(fp)
            fp.write(b"\0" * (vsize - be.nbytes))
