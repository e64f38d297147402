"""From-scratch HDF4 (SD / HDF-EOS grid) reader and writer.

Counterpart of `gsky_tpu/io/hdf4.py`: a native decoder for MODIS
archives, pure ``struct`` and ``zlib``.  Scope (checked, and erroring
clearly outside it):

  * physical layer: the DD (data-descriptor) block list; contiguous
    data elements; SPECIAL_COMP elements with DEFLATE or NONE codecs
    (the common MODIS layout).  Linked-block and chunked elements are
    detected and rejected with a clear error.
  * object layer: scientific data sets via NDG (tag 720) groups —
    SDD dimension records (701), NT number types (106), SD raw data
    (702) — plus the SD-API naming/attribute structure: a Vgroup
    (1965, class "Var0.0") per dataset whose name is the SDS name,
    containing the NDG and "Attr0.0" Vdatas (_FillValue, ...); global
    "Attr0.0" Vdatas carry file attributes.
  * georeferencing: the HDF-EOS ``StructMetadata.0`` global attribute's
    GRID section (UpperLeftPointMtrs / LowerRightMtrs / XDim / YDim /
    Projection) -> GeoTransform + CRS (GCTP_SNSOID -> the MODIS
    sinusoidal CRS, GCTP_GEO -> EPSG:4326 with packed-DMS corners).

All multi-byte fields are big-endian (the HDF4 on-disk convention);
number types with the little-endian bit (0x40) are honoured for array
data.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geo.crs import CRS, CRS_SINU_MODIS, EPSG4326
from ..geo.transform import GeoTransform

MAGIC = b"\x0e\x03\x13\x01"

DFTAG_NULL = 0
DFTAG_VERSION = 30
DFTAG_COMPRESSED = 40
DFTAG_NT = 106
DFTAG_SDD = 701
DFTAG_SD = 702
DFTAG_NDG = 720
DFTAG_VH = 1962
DFTAG_VS = 1963
DFTAG_VG = 1965

SPECIAL_BIT = 0x4000
SPECIAL_LINKED = 1
SPECIAL_EXT = 2
SPECIAL_COMP = 3

COMP_NONE = 0
COMP_DEFLATE = 4

# DFNT number-type codes -> numpy dtypes (big-endian base; the 0x40
# bit marks little-endian storage)
_DFNT = {3: "u1", 4: "S1", 5: "f4", 6: "f8",
         20: "i1", 21: "u1", 22: "i2", 23: "u2", 24: "i4", 25: "u4"}
_DFNT_LITEND = 0x40
_NP_TO_DFNT = {"uint8": 21, "int8": 20, "int16": 22, "uint16": 23,
               "int32": 24, "uint32": 25, "float32": 5, "float64": 6}


def _dfnt_dtype(code: int) -> np.dtype:
    base = _DFNT.get(code & ~_DFNT_LITEND)
    if base is None:
        raise ValueError(f"unsupported HDF4 number type {code}")
    order = "<" if code & _DFNT_LITEND else ">"
    return np.dtype(order + base) if base != "S1" else np.dtype("S1")


class _RawFile:
    """DD-level access: (tag, ref) -> bytes, special elements resolved."""

    # a corrupt DD count/offset/length must never drive allocation —
    # every size is validated against the stat'd file size, and the DD
    # list itself is capped (bounds-hardening parity with the GeoTIFF
    # and NetCDF parsers)
    _MAX_DDS = 65536

    def __init__(self, path: str):
        self.path = path
        self._size = os.stat(path).st_size
        self._fp = open(path, "rb")
        # the handle cache shares one open handle across the decode
        # thread pool; seek+read must not interleave
        self._lock = threading.Lock()
        if self._fp.read(4) != MAGIC:
            self._fp.close()
            raise ValueError(f"{path}: not an HDF4 file")
        self.dds: List[Tuple[int, int, int, int]] = []  # tag,ref,off,len
        pos = 4
        visited = set()
        while pos and pos not in visited and pos < self._size:
            visited.add(pos)       # corrupt next-pointers must not loop
            self._fp.seek(pos)
            head = self._fp.read(6)
            if len(head) < 6:
                break
            ndd, nxt = struct.unpack(">hI", head)
            raw = self._fp.read(12 * max(ndd, 0))
            for i in range(len(raw) // 12):
                tag, ref, off, ln = struct.unpack_from(">HHII", raw,
                                                       i * 12)
                if tag != DFTAG_NULL and off + ln <= self._size:
                    self.dds.append((tag, ref, off, ln))
            if len(self.dds) > self._MAX_DDS:
                self._fp.close()
                raise ValueError(
                    f"{path}: DD list exceeds {self._MAX_DDS} entries")
            pos = nxt
        self._by_id: Dict[Tuple[int, int], Tuple[int, int]] = {
            (t, r): (o, ln) for t, r, o, ln in self.dds}

    def close(self) -> None:
        self._fp.close()

    def refs(self, tag: int) -> List[int]:
        return [r for t, r, _, _ in self.dds if t & ~SPECIAL_BIT == tag]

    def raw(self, tag: int, ref: int) -> Optional[bytes]:
        hit = self._by_id.get((tag, ref))
        if hit is None:
            return None
        off, ln = hit
        with self._lock:
            self._fp.seek(off)
            return self._fp.read(ln)

    def element(self, tag: int, ref: int) -> Optional[bytes]:
        """Data element bytes with special-element indirection resolved
        (the caller uses the BASE tag; the file may store tag|0x4000)."""
        plain = self._by_id.get((tag, ref))
        if plain is not None:
            return self.raw(tag, ref)
        spec = self._by_id.get((tag | SPECIAL_BIT, ref))
        if spec is None:
            return None
        off, ln = spec
        with self._lock:
            self._fp.seek(off)
            head = self._fp.read(ln if ln < 64 else 64)
        if len(head) < 2:
            raise ValueError(
                f"{self.path}: truncated special-element header")
        (code,) = struct.unpack_from(">H", head, 0)
        if code == SPECIAL_COMP:
            # version u16, uncompressed length u32, comp_ref u16,
            # model u16, comp_type u16 (hcomp.c header)
            if len(head) < 14:
                raise ValueError(
                    f"{self.path}: truncated SPECIAL_COMP header")
            _ver, total, comp_ref, _model, ctype = \
                struct.unpack_from(">HIHHH", head, 2)
            payload = self.raw(DFTAG_COMPRESSED, comp_ref)
            if payload is None:
                raise ValueError(
                    f"{self.path}: missing compressed element "
                    f"{comp_ref}")
            if total > (1 << 30):
                raise ValueError(
                    f"{self.path}: compressed element claims "
                    f"{total} bytes")
            if ctype == COMP_DEFLATE:
                # bounded inflate (a crafted header must not drive the
                # allocation past its own declared, capped size) that
                # still validates completeness: max_length=0 would mean
                # UNLIMITED, and a short/overlong stream must raise,
                # not decode into silent garbage
                if total == 0:
                    return b""
                d = zlib.decompressobj()
                try:
                    out = d.decompress(payload, total)
                except zlib.error as e:
                    raise ValueError(
                        f"{self.path}: corrupt deflate stream: {e}"
                    ) from e
                if len(out) == total and not d.eof:
                    # the output cap can stop right before the stream
                    # terminator on a well-formed stream; one more
                    # bounded pull must yield nothing and hit EOF
                    if d.decompress(d.unconsumed_tail, 1) or not d.eof:
                        raise ValueError(
                            f"{self.path}: compressed element longer "
                            f"than its declared {total} bytes")
                if len(out) != total:
                    raise ValueError(
                        f"{self.path}: compressed element decodes to "
                        f"{len(out)} of {total} declared bytes")
            elif ctype == COMP_NONE:
                out = payload
            else:
                raise ValueError(
                    f"{self.path}: unsupported HDF4 compression "
                    f"{ctype} (deflate and none are supported)")
            return out[:total]
        raise ValueError(
            f"{self.path}: unsupported HDF4 special element {code} "
            f"(linked and chunked storage are not supported)")


def _cut(buf: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    return buf[pos:pos + n], pos + n


def _parse_vgroup(buf: bytes):
    """(members [(tag, ref)], name, vclass) from a VG element."""
    (nelt,) = struct.unpack_from(">H", buf, 0)
    pos = 2
    tags = struct.unpack_from(f">{nelt}H", buf, pos)
    pos += 2 * nelt
    refs = struct.unpack_from(f">{nelt}H", buf, pos)
    pos += 2 * nelt
    (namelen,) = struct.unpack_from(">H", buf, pos)
    pos += 2
    name, pos = _cut(buf, pos, namelen)
    (classlen,) = struct.unpack_from(">H", buf, pos)
    pos += 2
    vclass, pos = _cut(buf, pos, classlen)
    return (list(zip(tags, refs)), name.decode("latin-1"),
            vclass.decode("latin-1"))


def _parse_vh(buf: bytes):
    """(name, vclass, nvert, ivsize, field_types, field_orders)."""
    interlace, nvert, ivsize, nfields = struct.unpack_from(">HIHH",
                                                           buf, 0)
    pos = 10
    types = struct.unpack_from(f">{nfields}H", buf, pos)
    pos += 2 * nfields
    pos += 2 * nfields        # isize
    pos += 2 * nfields        # offset
    orders = struct.unpack_from(f">{nfields}H", buf, pos)
    pos += 2 * nfields
    for _ in range(nfields):
        (fl,) = struct.unpack_from(">H", buf, pos)
        pos += 2 + fl
    (namelen,) = struct.unpack_from(">H", buf, pos)
    pos += 2
    name, pos = _cut(buf, pos, namelen)
    (classlen,) = struct.unpack_from(">H", buf, pos)
    pos += 2
    vclass, pos = _cut(buf, pos, classlen)
    return (name.decode("latin-1"), vclass.decode("latin-1"),
            nvert, ivsize, types, orders)


def _attr_value(rawfile: _RawFile, ref: int):
    """(name, value) of an "Attr0.0" Vdata, or None.  Values decode as
    the field type over ALL stored bytes (tolerant of the two libmfhdf
    conventions: nvert=count/order=1 and nvert=1/order=count)."""
    vh = rawfile.raw(DFTAG_VH, ref)
    if vh is None:
        return None
    try:
        name, vclass, nvert, ivsize, types, _ = _parse_vh(vh)
    except struct.error:
        return None                # truncated Vdata description
    if vclass != "Attr0.0" or not types:
        return None
    vs = rawfile.element(DFTAG_VS, ref)
    if vs is None:
        return None
    try:
        dt = _dfnt_dtype(types[0])
    except ValueError:
        return None
    if dt.kind == "S":
        return name, vs.rstrip(b"\x00").decode("latin-1",
                                               errors="replace")
    n = len(vs) // dt.itemsize
    vals = np.frombuffer(vs[:n * dt.itemsize], dt)
    return name, (vals[0].item() if n == 1 else vals)


class _SDSInfo:
    __slots__ = ("name", "dims", "dtype", "sd_ref", "fill", "attrs")

    def __init__(self, name, dims, dtype, sd_ref, fill, attrs):
        self.name = name
        self.dims = dims
        self.dtype = dtype
        self.sd_ref = sd_ref
        self.fill = fill
        self.attrs = attrs


# -- HDF-EOS StructMetadata ---------------------------------------------------

def _dms_to_deg(v: float) -> float:
    """HDF-EOS packed DMS (±DDDMMMSSS.ss) -> decimal degrees."""
    sign = -1.0 if v < 0 else 1.0
    v = abs(v)
    deg = int(v // 1_000_000)
    mins = int((v - deg * 1_000_000) // 1000)
    sec = v - deg * 1_000_000 - mins * 1000
    return sign * (deg + mins / 60.0 + sec / 3600.0)


def parse_struct_metadata(text: str):
    """(GeoTransform, CRS, (ydim, xdim)) from the first GRID block of a
    StructMetadata.0 document, or None."""
    gx = re.search(r"XDim\s*=\s*(\d+)", text)
    gy = re.search(r"YDim\s*=\s*(\d+)", text)
    ul = re.search(r"UpperLeftPointMtrs\s*=\s*\(([^,]+),([^)]+)\)", text)
    lr = re.search(r"LowerRightMtrs\s*=\s*\(([^,]+),([^)]+)\)", text)
    pj = re.search(r"Projection\s*=\s*GCTP_(\w+)", text)
    if not (gx and gy and ul and lr):
        return None
    xdim, ydim = int(gx.group(1)), int(gy.group(1))
    ulx, uly = float(ul.group(1)), float(ul.group(2))
    lrx, lry = float(lr.group(1)), float(lr.group(2))
    proj = pj.group(1) if pj else "SNSOID"
    if proj == "GEO":
        ulx, uly = _dms_to_deg(ulx), _dms_to_deg(uly)
        lrx, lry = _dms_to_deg(lrx), _dms_to_deg(lry)
        crs: CRS = EPSG4326
    elif proj == "SNSOID":
        crs = CRS_SINU_MODIS
    else:
        return None
    gt = GeoTransform(ulx, (lrx - ulx) / xdim, 0.0,
                      uly, 0.0, (lry - uly) / ydim)
    return gt, crs, (ydim, xdim)


# -- public reader -----------------------------------------------------------

class HDF4:
    """Flat-band registry handle over an HDF4 SD file: band k is the
    k-th scientific data set (crawler order == file order).  For rank-3
    datasets ``read`` serves plane 0 (MODIS grids are rank 2; the full
    axis model belongs to the NetCDF facade, not the flat tier)."""

    def __init__(self, path: str):
        self.path = path
        self._raw = _RawFile(path)
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_lock = threading.Lock()
        self.sds: List[_SDSInfo] = []
        self.global_attrs: Dict[str, object] = {}
        self._load_structure()
        first2d = next((s for s in self.sds if len(s.dims) >= 2), None)
        self.height = int(first2d.dims[-2]) if first2d else 0
        self.width = int(first2d.dims[-1]) if first2d else 0
        self.dtype = first2d.dtype if first2d else np.dtype(">f4")
        self.nodata = self.sds[0].fill if self.sds else None
        self.overviews: tuple = ()
        self.gt: Optional[GeoTransform] = None
        self.crs: Optional[CRS] = None
        sm = self.global_attrs.get("StructMetadata.0")
        if isinstance(sm, str):
            made = parse_struct_metadata(sm)
            if made is not None:
                self.gt, self.crs, _ = made

    @property
    def bands(self) -> int:
        return len(self.sds)

    def _parse_ndg(self, ref: int):
        """(dims, dtype, sd_ref) from an NDG's SDD member, or None."""
        grp = self._raw.raw(DFTAG_NDG, ref)
        if grp is None:
            return None
        members = [struct.unpack_from(">HH", grp, i)
                   for i in range(0, len(grp) - 3, 4)]
        sdd_ref = next((r for t, r in members if t == DFTAG_SDD), None)
        sd_ref = next((r for t, r in members if t == DFTAG_SD), None)
        if sdd_ref is None or sd_ref is None:
            return None
        sdd = self._raw.raw(DFTAG_SDD, sdd_ref)
        if sdd is None or len(sdd) < 2:
            return None
        (rank,) = struct.unpack_from(">H", sdd, 0)
        if rank > 16 or len(sdd) < 2 + 4 * rank + 4:
            return None            # corrupt dimension record
        dims = struct.unpack_from(f">{rank}i", sdd, 2)
        if any(d <= 0 for d in dims):
            return None
        nt_tag, nt_ref = struct.unpack_from(">HH", sdd, 2 + 4 * rank)
        nt = self._raw.raw(nt_tag, nt_ref)
        if nt is None or len(nt) < 4:
            return None
        try:
            dtype = _dfnt_dtype(nt[1])
        except ValueError:
            return None            # exotic number type: skip the SDS
        return list(dims), dtype, sd_ref

    def _load_structure(self) -> None:
        raw = self._raw
        in_group_vdatas = set()
        ndg_named = {}
        # modern SD layout: one "Var0.0" Vgroup per dataset
        for ref in raw.refs(DFTAG_VG):
            vg = raw.raw(DFTAG_VG, ref)
            if vg is None:
                continue
            try:
                members, name, vclass = _parse_vgroup(vg)
            except struct.error:
                continue           # truncated group record
            if not vclass.startswith("Var"):
                continue
            attrs = {}
            ndg_ref = None
            for t, r in members:
                if t == DFTAG_NDG:
                    ndg_ref = r
                elif t in (DFTAG_VH, DFTAG_VS):
                    in_group_vdatas.add(r)
                    made = _attr_value(raw, r)
                    if made is not None:
                        attrs[made[0]] = made[1]
            if ndg_ref is None:
                continue
            parsed = self._parse_ndg(ndg_ref)
            if parsed is None:
                continue
            dims, dtype, sd_ref = parsed
            fill = attrs.get("_FillValue")
            ndg_named[ndg_ref] = True
            self.sds.append(_SDSInfo(name, dims, dtype, sd_ref,
                                     float(fill) if fill is not None
                                     and np.ndim(fill) == 0 else None,
                                     attrs))
        # legacy DFSD layout: bare NDGs without a Var group
        for ref in raw.refs(DFTAG_NDG):
            if ref in ndg_named:
                continue
            parsed = self._parse_ndg(ref)
            if parsed is None:
                continue
            dims, dtype, sd_ref = parsed
            self.sds.append(_SDSInfo(f"sds_{ref}", dims, dtype, sd_ref,
                                     None, {}))
        # global attributes: Attr0.0 Vdatas not owned by a Var group
        for ref in raw.refs(DFTAG_VH):
            if ref in in_group_vdatas:
                continue
            made = _attr_value(raw, ref)
            if made is not None:
                self.global_attrs[made[0]] = made[1]

    def _full(self, band: int) -> np.ndarray:
        with self._cache_lock:
            arr = self._cache.get(band)
        if arr is not None:
            return arr
        info = self.sds[band - 1]
        buf = self._raw.element(DFTAG_SD, info.sd_ref)
        if buf is None:
            raise ValueError(f"{self.path}: SDS {info.name!r} has no "
                             f"data element")
        n = int(np.prod(info.dims))
        if n * info.dtype.itemsize > len(buf):
            raise ValueError(
                f"{self.path}: SDS {info.name!r} dims {info.dims} "
                f"exceed its {len(buf)}-byte data element")
        arr = np.frombuffer(buf[:n * info.dtype.itemsize],
                            info.dtype).reshape(info.dims)
        while arr.ndim > 2:
            arr = arr[0]
        with self._cache_lock:
            # keep at most two decoded planes resident (MODIS 250 m
            # grids are ~46 MB each)
            if len(self._cache) >= 2:
                self._cache.pop(next(iter(self._cache)))
            self._cache[band] = arr
        return arr

    def read(self, band: int = 1,
             window: Optional[Tuple[int, int, int, int]] = None
             ) -> np.ndarray:
        """Band data as native-endian numpy; ``window`` is
        (col0, row0, w, h) like every registry handle."""
        if not 1 <= band <= len(self.sds):
            raise IndexError(f"band {band} of {len(self.sds)}")
        arr = self._full(band)
        if window is not None:
            c0, r0, w, h = window
            arr = arr[r0:r0 + h, c0:c0 + w]
        return np.ascontiguousarray(
            arr.astype(arr.dtype.newbyteorder("=")))

    def nodata_for(self, band: int) -> Optional[float]:
        return self.sds[band - 1].fill if 1 <= band <= len(self.sds) \
            else None

    def close(self) -> None:
        self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def is_hdf4(path: str) -> bool:
    try:
        with open(path, "rb") as fp:
            return fp.read(4) == MAGIC
    except OSError:
        return False


# -- writer (fixtures / export) ----------------------------------------------

class _Writer:
    def __init__(self):
        self.objs: List[Tuple[int, int, bytes]] = []
        self._ref = 1

    def ref(self) -> int:
        r = self._ref
        self._ref += 1
        return r

    def add(self, tag: int, data: bytes, ref: Optional[int] = None) -> int:
        if ref is None:
            ref = self.ref()
        self.objs.append((tag, ref, data))
        return ref

    def tobytes(self) -> bytes:
        ndd = len(self.objs)
        head = MAGIC + struct.pack(">hI", ndd, 0)
        off = len(head) + 12 * ndd
        dd = b""
        body = b""
        for tag, ref, data in self.objs:
            dd += struct.pack(">HHII", tag, ref, off, len(data))
            body += data
            off += len(data)
        return head + dd + body


def _pack_vgroup(members, name: str, vclass: str) -> bytes:
    n = len(members)
    out = struct.pack(">H", n)
    out += struct.pack(f">{n}H", *[t for t, _ in members]) if n else b""
    out += struct.pack(f">{n}H", *[r for _, r in members]) if n else b""
    nb = name.encode("latin-1")
    cb = vclass.encode("latin-1")
    out += struct.pack(">H", len(nb)) + nb
    out += struct.pack(">H", len(cb)) + cb
    out += struct.pack(">HHHH", 0, 0, 3, 0)   # extag, exref, version, more
    return out


def _pack_vh(name: str, vclass: str, dfnt: int, isize: int, order: int,
             nvert: int) -> bytes:
    out = struct.pack(">HIHH", 0, nvert, isize * order, 1)
    out += struct.pack(">H", dfnt)
    out += struct.pack(">H", isize)
    out += struct.pack(">H", 0)
    out += struct.pack(">H", order)
    fld = b"VALUES"
    out += struct.pack(">H", len(fld)) + fld
    nb = name.encode("latin-1")
    cb = vclass.encode("latin-1")
    out += struct.pack(">H", len(nb)) + nb
    out += struct.pack(">H", len(cb)) + cb
    out += struct.pack(">HHHH", 0, 0, 3, 0)
    return out


def _struct_metadata(gt: GeoTransform, crs: Optional[CRS],
                     ydim: int, xdim: int) -> str:
    lrx = gt.x0 + gt.dx * xdim
    lry = gt.y0 + gt.dy * ydim
    sinu = crs is not None and getattr(crs, "proj", "") == "sinu"
    if sinu:
        proj = "GCTP_SNSOID"
        ulx, uly = gt.x0, gt.y0
    else:
        proj = "GCTP_GEO"

        def _to_dms(v: float) -> float:
            sign = -1.0 if v < 0 else 1.0
            v = abs(v)
            deg = int(v)
            mins = int((v - deg) * 60)
            sec = ((v - deg) * 60 - mins) * 60
            return sign * (deg * 1_000_000 + mins * 1000 + sec)

        ulx, uly = _to_dms(gt.x0), _to_dms(gt.y0)
        lrx, lry = _to_dms(lrx), _to_dms(lry)
    return (
        "GROUP=GridStructure\n\tGROUP=GRID_1\n"
        "\t\tGridName=\"grid\"\n"
        f"\t\tXDim={xdim}\n\t\tYDim={ydim}\n"
        f"\t\tUpperLeftPointMtrs=({ulx:.6f},{uly:.6f})\n"
        f"\t\tLowerRightMtrs=({lrx:.6f},{lry:.6f})\n"
        f"\t\tProjection={proj}\n"
        "\tEND_GROUP=GRID_1\nEND_GROUP=GridStructure\nEND\n")


def write_hdf4(path: str, arrays: Dict[str, np.ndarray],
               gt: Optional[GeoTransform] = None,
               crs: Optional[CRS] = None,
               fills: Optional[Dict[str, float]] = None,
               compress: Optional[str] = None) -> None:
    """Write 2-D arrays as HDF4 scientific data sets in the modern SD
    layout this module reads (and libdf-based tools read back): NDG +
    SDD + NT + SD per array, a "Var0.0" Vgroup carrying the name and
    ``_FillValue``, and a StructMetadata.0 global attribute when ``gt``
    is given.  ``compress='deflate'`` stores each SD as a SPECIAL_COMP
    element (the MODIS layout)."""
    w = _Writer()
    w.add(DFTAG_VERSION, struct.pack(">III", 4, 2, 15) + b"gsky\x00")
    fills = fills or {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.ndim != 2:
            raise ValueError(f"{name}: writer takes 2-D arrays")
        dfnt = _NP_TO_DFNT.get(arr.dtype.name)
        if dfnt is None:
            raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
        be = arr.astype(arr.dtype.newbyteorder(">"))
        nt_ref = w.add(DFTAG_NT, bytes([1, dfnt, be.dtype.itemsize * 8,
                                        0]))
        sdd = struct.pack(">H", 2) + struct.pack(">2i", *be.shape)
        sdd += struct.pack(">HH", DFTAG_NT, nt_ref)
        sdd += struct.pack(">HH", DFTAG_NT, nt_ref) * 2   # dim scales
        sdd_ref = w.add(DFTAG_SDD, sdd)
        payload = be.tobytes()
        sd_ref = w.ref()
        if compress == "deflate":
            comp_ref = w.add(DFTAG_COMPRESSED,
                             zlib.compress(payload, 6))
            head = struct.pack(">HHIHHHH", SPECIAL_COMP, 0,
                               len(payload), comp_ref, 0, COMP_DEFLATE,
                               6)
            w.add(DFTAG_SD | SPECIAL_BIT, head, ref=sd_ref)
        else:
            w.add(DFTAG_SD, payload, ref=sd_ref)
        ndg = struct.pack(">HH", DFTAG_SDD, sdd_ref) \
            + struct.pack(">HH", DFTAG_SD, sd_ref)
        ndg_ref = w.add(DFTAG_NDG, ndg)
        members = [(DFTAG_NDG, ndg_ref)]
        fill = fills.get(name)
        if fill is not None:
            fv = np.asarray(fill, be.dtype.newbyteorder(">"))
            ar = w.ref()
            w.add(DFTAG_VH, _pack_vh("_FillValue", "Attr0.0", dfnt,
                                     fv.itemsize, 1, 1), ref=ar)
            w.add(DFTAG_VS, fv.tobytes(), ref=ar)
            members += [(DFTAG_VH, ar), (DFTAG_VS, ar)]
        w.add(DFTAG_VG, _pack_vgroup(members, name, "Var0.0"))
    if gt is not None:
        h0, w0 = next(iter(arrays.values())).shape
        text = _struct_metadata(gt, crs, h0, w0).encode("latin-1")
        ar = w.ref()
        w.add(DFTAG_VH, _pack_vh("StructMetadata.0", "Attr0.0", 4, 1,
                                 len(text), 1), ref=ar)
        w.add(DFTAG_VS, text, ref=ar)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        fp.write(w.tobytes())
    os.replace(tmp, path)
