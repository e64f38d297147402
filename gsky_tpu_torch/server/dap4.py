"""DAP4: the constraint-expression parser, the binary encoder, and the
bridge to WCS GetCoverage.

Counterpart of `gsky_tpu/server/dap4.py`:

- `parse_constraint_expr` reads ``dap4.ce`` expressions of the form
  ``dataset{var1;axis[idx-sels];...} | filters``, whose relational
  filters (``time >= 2020-01-01T00:00:00.000Z``, ``1 < x < 10``) may
  have ISO timestamps for endpoints;
- `dap_to_wcs` maps them onto a `WCSParams`: x/y filters clamp the
  bbox, other axes become axis selections, plain variables the bands;
- `encode_dap4` writes the coverage as a DAP4 chunked body: a DMR XML
  chunk, one float64 chunk per extra axis, then the band data in
  chunks of at most 0xffffff bytes, little-endian, with the chunk flags
  LAST=1 / ERR=2 / LITTLE_ENDIAN=4 / NOCHECKSUM=8;
- `CoverageSpool` and `stream_dap4` are the streamed leg
  (``GSKY_DAP_STREAM``): the export engine writes the coverage into a
  band-major float32 spool file, and the body is replayed from it row
  batch by row batch, byte for byte what `encode_dap4` gives, holding
  one row batch and one chunk in memory.
"""

from __future__ import annotations

import datetime as dt
import math
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..geo.crs import EPSG4326
from ..geo.transform import BBox
from ..index.store import ISO
from .params import OWSError, WCSParams

_VAR_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

# chunk flags (netcdf-c libdap4/d4chunk.c, cited by the reference)
LAST_CHUNK = 1
ERR_CHUNK = 2
LITTLE_ENDIAN_CHUNK = 4
NOCHECKSUM_CHUNK = 8

MAX_CHUNK = 0xFFFFFF


# ---------------------------------------------------------------------------
# constraint expressions
# ---------------------------------------------------------------------------


@dataclass
class DapIdxSelector:
    """``[start:step:end]`` / ``[start:end]`` / ``[i]`` / ``[]``."""

    start: Optional[int] = None
    end: Optional[int] = None
    step: Optional[int] = None
    is_range: bool = True
    is_all: bool = False


@dataclass
class DapVarParam:
    name: str = ""
    val_start: Optional[float] = None
    val_end: Optional[float] = None
    idx_selectors: List[DapIdxSelector] = field(default_factory=list)
    is_axis: bool = False


@dataclass
class DapConstraints:
    dataset: str = ""
    var_params: List[DapVarParam] = field(default_factory=list)


def _parse_endpoint(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        pass
    try:
        t = dt.datetime.strptime(s, ISO).replace(tzinfo=dt.timezone.utc)
        return float(t.timestamp())
    except ValueError:
        raise ValueError(f"invalid endpoint: {s}")


def _parse_selectors(text: str) -> List[DapIdxSelector]:
    parts = [p.strip() for p in text.split(",")]
    parts = [p for p in parts if p]
    if not parts:
        return [DapIdxSelector(is_range=True, is_all=True)]
    sels = []
    for p in parts:
        bits = p.split(":")
        if len(bits) > 3:
            raise ValueError(f"invalid selector: {p}")
        sel = DapIdxSelector(is_range=len(bits) > 1)
        vals: List[Optional[int]] = []
        for b in bits:
            b = b.strip()
            if not b:
                vals.append(None)
                continue
            try:
                v = int(b)
            except ValueError:
                raise ValueError(f"invalid selector: {p}")
            if v < 0:
                raise ValueError(f"index must be non-negative: {p}")
            vals.append(v)
        sel.start = vals[0]
        if len(bits) == 2:
            sel.end = vals[1]
        elif len(bits) == 3:
            sel.step = vals[1]
            sel.end = vals[2]
        sels.append(sel)
    return sels


def _parse_variables(text: str, ce: DapConstraints) -> None:
    for va in text.split(";"):
        va = va.strip()
        if not va:
            continue
        i = va.find("[")
        if i < 0:
            if not _VAR_NAME.match(va):
                raise ValueError(f"invalid variable name: {va}")
            ce.var_params.append(DapVarParam(name=va))
            continue
        name = va[:i].strip()
        if not name:
            raise ValueError(f"variable not found: {va}")
        if not _VAR_NAME.match(name):
            raise ValueError(f"invalid variable name: {name}")
        if not va.endswith("]"):
            raise ValueError(f"missing ]: {va}")
        # strip every [...] group, allowing var[a][b] like the spec
        sel_text = va[i + 1:-1].replace("][", ",")
        ce.var_params.append(DapVarParam(
            name=name, is_axis=True,
            idx_selectors=_parse_selectors(sel_text)))


_REL = {">": 0, ">=": 0, "<": 1, "<=": 1, "=": 2}


def _find_rel(s: str, start: int) -> Tuple[int, str]:
    for i in range(start, len(s)):
        if s[i] in ("<", ">", "="):
            op = s[i]
            if i + 1 < len(s) and s[i + 1] == "=" and op != "=":
                return i + 1, op + "="
            return i, op
    return -1, ""


def _parse_filters(text: str, ce: DapConstraints) -> None:
    for flt in text.split(","):
        flt = flt.strip()
        if not flt:
            continue
        i1, op1 = _find_rel(flt, 0)
        if i1 < 0:
            raise ValueError(f"invalid filter expression: {flt}")
        left = flt[:i1 - (len(op1) - 1)].strip()
        if not left:
            raise ValueError(f"filter expression missing left op: {flt}")
        i2, op2 = _find_rel(flt, i1 + 1)
        vp = DapVarParam(is_axis=True)
        if i2 < 0:
            right = flt[i1 + 1:].strip()
            if not right:
                raise ValueError(f"invalid filter expression: {flt}")
            if not _VAR_NAME.match(left):
                raise ValueError(f"invalid variable name for the left "
                                 f"op: {left}")
            vp.name = left
            val = _parse_endpoint(right)
            if _REL[op1] == 0:         # var >= val
                vp.val_start = val
                vp.val_end = math.inf
            elif _REL[op1] == 1:       # var <= val
                vp.val_start = -math.inf
                vp.val_end = val
            else:                      # var = val
                vp.val_start = val
        else:
            mid = flt[i1 + 1:i2 - (len(op2) - 1)].strip()
            right = flt[i2 + 1:].strip()
            if not mid or not right:
                raise ValueError(f"invalid filter expression: {flt}")
            if _REL[op1] != _REL[op2] or _REL[op1] not in (0, 1):
                raise ValueError(f"invalid filter expression: {flt}")
            if not _VAR_NAME.match(mid):
                raise ValueError(f"invalid variable name for the middle "
                                 f"op: {mid}")
            vp.name = mid
            lo = _parse_endpoint(left)
            hi = _parse_endpoint(right)
            if _REL[op1] == 0:         # hi > var > lo
                lo, hi = hi, lo
            if lo > hi:
                raise ValueError(f"lower endpoint greater than upper "
                                 f"endpoint: {flt}")
            vp.val_start = lo
            vp.val_end = hi
        ce.var_params.append(vp)


def parse_constraint_expr(ce_str: str) -> DapConstraints:
    """`ParseDap4ConstraintExpr` (`utils/dap4_ce_parser.go:96-152`)."""
    parts = ce_str.strip().split("|")
    if len(parts) > 2:
        raise ValueError("only a single filter expression is supported")
    subset = parts[0].strip()
    filters = parts[1].strip() if len(parts) == 2 else ""

    i = subset.find("{")
    if i < 0 or not subset[:i].strip():
        raise ValueError("dataset not found")
    if not subset.endswith("}"):
        raise ValueError("missing }")
    ce = DapConstraints(dataset=subset[:i].strip())
    _parse_variables(subset[i + 1:-1], ce)
    _parse_filters(filters, ce)

    seen = set()
    for vp in ce.var_params:
        if vp.name in seen:
            raise ValueError(f"duplicated constraint for variable: "
                             f"{vp.name}")
        seen.add(vp.name)
    return ce


# ---------------------------------------------------------------------------
# WCS bridge (`dap.go:38-166`)
# ---------------------------------------------------------------------------


def dap_to_wcs(ce: DapConstraints, cfg):
    """Build a WCSParams for the constraint set.  x/y filters clamp the
    bbox (defaults: layer default_geo_bbox or the whole world); other
    axis params pass through; non-axis variables form the band list."""
    lay = cfg.layer(ce.dataset)
    if lay is None:
        raise OWSError(f"dataset not found: {ce.dataset}",
                       "CoverageNotDefined")
    if lay.service_disabled("dap4"):
        raise OWSError(f"dap4 is disabled for this dataset: {ce.dataset}",
                       "OperationNotSupported")

    default_bbox = list(lay.default_geo_bbox) if len(
        lay.default_geo_bbox) == 4 else [-180.0, -90.0, 180.0, 90.0]
    p = WCSParams()
    p.request = "GetCoverage"
    p.coverages = [ce.dataset]
    p.crs = EPSG4326
    p.format = "dap4"
    bbox = list(default_bbox)
    if len(lay.default_geo_size) == 2:
        # default_geo_size is (height, width) ordered — Width comes from
        # element 1 and Height from element 0 in the reference
        # (`dap.go:73-74`)
        p.height, p.width = lay.default_geo_size
    bands: List[str] = []
    for vp in ce.var_params:
        if not vp.is_axis:
            bands.append(vp.name)
            continue
        if vp.name in ("x", "y"):
            if vp.idx_selectors:
                raise OWSError("index-based selection is not supported "
                               f"for axis: {vp.name}", "InvalidAxis")
            # NB: an equality filter (`x = v`) carries only val_start and
            # so clamps only the lower bound — matching the reference
            # (`dap.go:84-98` skips BBox[hi] when ValEnd is nil)
            lo_i, hi_i = (0, 2) if vp.name == "x" else (1, 3)
            if vp.val_start is not None and math.isfinite(vp.val_start) \
                    and default_bbox[lo_i] <= vp.val_start <= default_bbox[hi_i]:
                bbox[lo_i] = vp.val_start
            if vp.val_end is not None and math.isfinite(vp.val_end) \
                    and default_bbox[lo_i] <= vp.val_end <= default_bbox[hi_i]:
                bbox[hi_i] = vp.val_end
            continue
        if vp.name == "time":
            if vp.val_start is not None and math.isfinite(vp.val_start):
                p.times.append(vp.val_start)
            if vp.val_end is not None and math.isfinite(vp.val_end):
                p.times.append(vp.val_end)
            continue
        if vp.idx_selectors:
            p.axis_idx[vp.name] = [
                (s.start, s.end, s.step, s.is_range, s.is_all)
                for s in vp.idx_selectors]
        else:
            p.axes[vp.name] = (vp.val_start, vp.val_end)
    if not bands:
        extra = [vp for vp in ce.var_params
                 if vp.is_axis and vp.name not in ("x", "y")]
        if not extra:
            raise OWSError("querying special variables (i.e. x, y) is "
                           "not supported", "InvalidParameterValue")
    p.bbox = BBox(*bbox)
    p.bands_override = bands
    return p


# ---------------------------------------------------------------------------
# encoder (`utils/dap4_encoders.go`)
# ---------------------------------------------------------------------------


def _chunk(data: bytes, flags: int = LITTLE_ENDIAN_CHUNK |
           NOCHECKSUM_CHUNK) -> bytes:
    if len(data) > MAX_CHUNK:
        raise ValueError("exceeding maximum chunk size")
    hdr = struct.pack(">I", len(data))
    return bytes([flags]) + hdr[1:] + data


def last_chunk() -> bytes:
    return bytes([LAST_CHUNK, 0, 0, 0])


def err_chunk() -> bytes:
    return bytes([ERR_CHUNK, 0, 0, 0])


def split_dimensions(band_names: List[str]):
    """Split namespaces like ``var#axis=value`` into unique var names +
    ordered per-axis value lists (`getDimensions`,
    `dap4_encoders.go:229-296`)."""
    var_names: List[str] = []
    axis_names: List[str] = []
    axis_vals: Dict[str, List[float]] = {}
    seen_vars = set()
    i_var = 0
    for dim in band_names:
        parts = dim.split("#")
        if len(parts) > 2:
            raise ValueError(f"invalid dim format: {dim}")
        var = parts[0]
        if var and var not in seen_vars and var != "EmptyTile":
            seen_vars.add(var)
            if not _VAR_NAME.match(var):
                i_var += 1
                var = f"var{i_var}"
            var_names.append(var)
        if len(parts) == 1:
            continue
        for axis in parts[1].split(","):
            kv = axis.split("=")
            if len(kv) != 2:
                raise ValueError(f"invalid axis format: {dim}")
            name, sval = kv
            if name not in axis_vals:
                axis_vals[name] = []
                axis_names.append(name)
            try:
                val = float(sval)
            except ValueError:
                val = _parse_endpoint(sval)
            if val not in axis_vals[name]:
                axis_vals[name].append(val)
    return var_names, axis_names, axis_vals


def build_dmr(axis_names: List[str], axis_vals: Dict[str, List[float]],
              var_names: List[str], var_dtype: str,
              width: int, height: int) -> bytes:
    """DMR XML naming the dims + typed vars (`buildMdr`,
    `dap4_encoders.go:155-219`); newlines stripped like the reference."""
    out = ['<Dataset name="D" dapVersion="4.0" dmrVersion="1.0" '
           'xml:base="file:dap4/gsky.xml" '
           'xmlns="http://xml.opendap.org/ns/DAP/4.0#" '
           'xmlns:dap="http://xml.opendap.org/ns/DAP/4.0#">'
           '<Attribute name="_DAP4_Little_Endian" type="UInt8">'
           '<Value value="1"/></Attribute>']
    for ns in axis_names:
        out.append(f'<Dimension name="{ns}" size="{len(axis_vals[ns])}"/>')
    if var_names:
        out.append(f'<Dimension name="y" size="{height}"/>')
        out.append(f'<Dimension name="x" size="{width}"/>')
    for ns in axis_names:
        out.append(f'<Float64 name="{ns}"><Dim name="{ns}"/></Float64>')
    for v in var_names:
        dims = "".join(f'<Dim name="{ns}"/>' for ns in axis_names)
        out.append(f'<{var_dtype} name="{v}">{dims}'
                   f'<Dim name="y"/><Dim name="x"/></{var_dtype}>')
    out.append("</Dataset>")
    return "".join(out).encode()


_DTYPES = {"uint8": "Byte", "uint16": "UInt16", "int16": "Int16",
           "uint32": "UInt32", "int32": "Int32", "float32": "Float32",
           "float64": "Float64"}


def encode_dap4(band_names: List[str],
                arrays: Dict[str, np.ndarray]) -> bytes:
    """One in-memory DAP4 response over the rendered canvases
    (`EncodeDap4`, `dap4_encoders.go:22-153`)."""
    var_names, axis_names, axis_vals = split_dimensions(band_names)
    first = arrays[band_names[0]]
    height, width = first.shape
    dtype = np.dtype(first.dtype)
    var_dtype = _DTYPES.get(dtype.name)
    if var_dtype is None:
        raise ValueError(f"unsupported dap4 dtype: {dtype}")

    out = [_chunk(build_dmr(axis_names, axis_vals, var_names, var_dtype,
                            width, height))]
    for ns in axis_names:
        out.append(_chunk(
            np.asarray(axis_vals[ns], "<f8").tobytes()))
    for name in band_names:
        data = np.ascontiguousarray(arrays[name]).astype(
            dtype.newbyteorder("<"), copy=False).tobytes()
        for off in range(0, len(data), MAX_CHUNK):
            out.append(_chunk(data[off:off + MAX_CHUNK]))
    out.append(last_chunk())
    return b"".join(out)


CONTENT_TYPE = "application/vnd.opendap.org.dap4.data"


# ---------------------------------------------------------------------------
# streamed encoder
# ---------------------------------------------------------------------------


def dap_stream_enabled() -> bool:
    """GSKY_DAP_STREAM gate (default on), read per request.  ``0``
    keeps the in-RAM `encode_dap4` leg, byte for byte the same body."""
    return os.environ.get("GSKY_DAP_STREAM", "1") != "0"


class CoverageSpool:
    """Band-major ``<f4`` scratch file between the export engine and
    the DAP4 rechunker.

    ``write_region`` implements the writer interface `ExportPipeline`
    expects (the GeoTIFF streaming writer's contract): nodata-filled
    (n_bands, th, tw) float32 blocks at output offsets, written with
    positioned I/O so the engine's encode workers never contend on a
    shared file cursor.  ``read_rows`` hands row batches back to the
    streamer in on-the-wire byte order — the spool stores exactly the
    little-endian bytes the response will carry."""

    def __init__(self, path: str, n_bands: int, height: int,
                 width: int):
        self.path = path
        self.n_bands = int(n_bands)
        self.height = int(height)
        self.width = int(width)
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC,
                          0o600)
        os.ftruncate(self.fd, self.n_bands * self.height
                     * self.width * 4)

    def write_region(self, ox: int, oy: int, block) -> None:
        b = np.ascontiguousarray(
            np.asarray(block, np.float32).astype("<f4", copy=False))
        _n, th, tw = b.shape
        for i in range(min(self.n_bands, b.shape[0])):
            for r in range(th):
                off = ((i * self.height + oy + r) * self.width
                       + ox) * 4
                os.pwrite(self.fd, b[i, r].tobytes(), off)

    def read_rows(self, band: int, row0: int, nrows: int) -> bytes:
        off = (band * self.height + row0) * self.width * 4
        return os.pread(self.fd, nrows * self.width * 4, off)

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class _Rechunker:
    """Re-slice an arbitrary byte feed into `encode_dap4`'s chunking:
    emit a full chunk at every exact MAX_CHUNK boundary, flush the
    remainder at band end.  ``peak`` records the largest resident
    buffer."""

    def __init__(self):
        self.buf = bytearray()
        self.peak = 0

    def push(self, data: bytes) -> bytes:
        self.buf += data
        if len(self.buf) > self.peak:
            self.peak = len(self.buf)
        out = []
        while len(self.buf) >= MAX_CHUNK:
            out.append(_chunk(bytes(self.buf[:MAX_CHUNK])))
            del self.buf[:MAX_CHUNK]
        return b"".join(out)

    def flush(self) -> bytes:
        if not self.buf:
            return b""
        out = _chunk(bytes(self.buf))
        self.buf.clear()
        return out


def stream_dap4(band_names: List[str], spool: CoverageSpool,
                stats: Optional[Dict] = None,
                row_batch: Optional[int] = None) -> Iterator[bytes]:
    """Yield the DAP4 response for a spooled float32 coverage,
    byte-identical to ``encode_dap4(band_names, arrays)`` over the
    same canvases, holding at most one row batch + one partial chunk
    resident.  ``stats`` (filled at exhaustion) gets ``peak_buffer``
    and ``bytes``."""
    var_names, axis_names, axis_vals = split_dimensions(band_names)
    # the spool is float32 by contract — the dtype the in-RAM leg's
    # canvases carry, so the DMR matches
    yield _chunk(build_dmr(axis_names, axis_vals, var_names,
                           "Float32", spool.width, spool.height))
    for ns in axis_names:
        yield _chunk(np.asarray(axis_vals[ns], "<f8").tobytes())
    if row_batch is None:
        # ~1 MiB of rows per read keeps the replay syscall-cheap while
        # the resident bound stays row_batch + MAX_CHUNK
        row_batch = max(1, min(spool.height,
                               (1 << 20) // max(1, spool.width * 4)))
    rc = _Rechunker()
    total = 0
    for bi in range(len(band_names)):
        for r0 in range(0, spool.height, row_batch):
            nr = min(row_batch, spool.height - r0)
            out = rc.push(spool.read_rows(bi, r0, nr))
            if out:
                total += len(out)
                yield out
        out = rc.flush()
        if out:
            total += len(out)
            yield out
    yield last_chunk()
    if stats is not None:
        stats["peak_buffer"] = rc.peak
        stats["bytes"] = total
