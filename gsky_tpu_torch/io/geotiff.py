"""GeoTIFF codec, from scratch (no GDAL).

Counterpart of `gsky_tpu/io/geotiff.py`.  Reader: classic TIFF +
BigTIFF, little/big endian, striped + tiled, chunky and separate
layouts, compression none/LZW/deflate/packbits (pure-Python LZW and
PackBits decoders), predictor 1/2/3, sample formats uint/int/float
8/16/32/64 bits, GDAL_NODATA, GeoKey directory -> CRS, overview IFDs.
Writer: tiled GeoTIFF with optional deflate, geokeys from EPSG CRSs,
GDAL_NODATA and reduced-resolution overview IFDs.
"""

from __future__ import annotations

import struct
import threading
import zlib
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..geo.crs import CRS, EPSG4326, parse_crs
from ..geo.transform import BBox, GeoTransform

# TIFF tag ids
T_WIDTH, T_HEIGHT = 256, 257
T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 258, 259, 262
T_STRIP_OFFSETS, T_SAMPLES, T_ROWS_PER_STRIP, T_STRIP_COUNTS = \
    273, 277, 278, 279
T_PLANAR = 284
T_PREDICTOR = 317
T_TILE_W, T_TILE_H, T_TILE_OFFSETS, T_TILE_COUNTS = 322, 323, 324, 325
T_SAMPLE_FORMAT = 339
T_MODEL_PIXEL_SCALE, T_MODEL_TIEPOINT, T_MODEL_TRANSFORM = \
    33550, 33922, 34264
T_GEO_DIR, T_GEO_DOUBLES, T_GEO_ASCII = 34735, 34736, 34737
T_GDAL_NODATA = 42113
T_NEWSUBFILETYPE = 254

COMP_NONE, COMP_LZW, COMP_PACKBITS = 1, 5, 32773
COMP_DEFLATE, COMP_DEFLATE_OLD = 8, 32946

# TIFF field types -> (struct fmt, size)
_FIELD = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8)}


def _np_dtype(bits: int, fmt: int):
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{kind}{bits // 8}")


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early code-size change)."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    CLEAR, EOI = 256, 257
    bitpos = 0
    width = 9
    prev: Optional[bytes] = None
    n = len(data) * 8
    while bitpos + width <= n:
        byte0 = bitpos >> 3
        chunk = int.from_bytes(data[byte0:byte0 + 3].ljust(3, b"\0"), "big")
        code = (chunk >> (24 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        if code == CLEAR:
            table = table[:258]
            width = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
            out += entry
            prev = entry
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("corrupt LZW stream")
            out += entry
            table.append(prev + entry[:1])
            prev = entry
        # early change: TIFF bumps width when next code would not fit
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
        if len(out) >= expected:
            break
    return bytes(out[:expected])


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        nv = data[i]
        n = nv - 256 if nv > 127 else nv
        i += 1
        if n >= 0:
            out += data[i:i + n + 1]
            i += n + 1
        elif n != -128:
            out += data[i:i + 1] * (1 - n)
            i += 1
    return bytes(out[:expected])


def _decompress(data: bytes, comp: int, expected: int) -> bytes:
    if comp == COMP_NONE:
        return data[:expected]
    if comp in (COMP_DEFLATE, COMP_DEFLATE_OLD):
        return zlib.decompress(data)[:expected]
    if comp == COMP_LZW:
        return _lzw_decode(data, expected)
    if comp == COMP_PACKBITS:
        return _packbits_decode(data, expected)
    raise ValueError(f"unsupported TIFF compression {comp}")


@dataclass
class IFD:
    tags: Dict[int, tuple]
    offset: int

    def val(self, tag: int, default=None):
        v = self.tags.get(tag)
        if v is None:
            return default
        return v[0] if len(v) == 1 else v

    def arr(self, tag: int) -> tuple:
        return self.tags.get(tag, ())

    @property
    def width(self) -> int:
        return int(self.val(T_WIDTH))

    @property
    def height(self) -> int:
        return int(self.val(T_HEIGHT))


class GeoTIFF:
    """Reader.  Open, inspect, read windows; overview IFDs exposed as
    `overviews` (list of (factor, IFD))."""

    def __init__(self, path_or_fp: Union[str, BinaryIO]):
        if isinstance(path_or_fp, (str, bytes)):
            self._fp = open(path_or_fp, "rb")
            self.path = path_or_fp
        else:
            self._fp = path_or_fp
            self.path = getattr(path_or_fp, "name", "<memory>")
        self._fp_lock = threading.Lock()
        try:
            cur = self._fp.tell()
            self._fp.seek(0, 2)
            self._file_size = self._fp.tell()
            self._fp.seek(cur)
        except OSError:
            self._file_size = 1 << 40
        self._parse_header()
        self._parse_geo()

    def close(self):
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _parse_header(self):
        fp = self._fp
        fp.seek(0)
        magic = fp.read(4)
        if magic[:2] == b"II":
            self._e = "<"
        elif magic[:2] == b"MM":
            self._e = ">"
        else:
            raise ValueError("not a TIFF file")
        ver = struct.unpack(self._e + "H", magic[2:4])[0]
        self.bigtiff = ver == 43
        if self.bigtiff:
            fp.read(4)  # offset size + pad
            first = struct.unpack(self._e + "Q", fp.read(8))[0]
        elif ver == 42:
            first = struct.unpack(self._e + "I", fp.read(4))[0]
        else:
            raise ValueError(f"bad TIFF version {ver}")
        self.ifds: List[IFD] = []
        off = first
        seen = set()
        try:
            while off and off not in seen and len(self.ifds) < 64:
                seen.add(off)
                ifd, off = self._read_ifd(off)
                self.ifds.append(ifd)
        except struct.error as e:
            raise ValueError(f"corrupt TIFF: {e}") from e
        if not self.ifds:
            raise ValueError("corrupt TIFF: no IFDs")
        main = [i for i in self.ifds
                if not (int(i.val(T_NEWSUBFILETYPE, 0)) & 1)]
        self.ifd = main[0] if main else self.ifds[0]
        self.overviews: List[Tuple[int, IFD]] = []
        for i in self.ifds:
            if i is self.ifd:
                continue
            if int(i.val(T_NEWSUBFILETYPE, 0)) & 1 \
                    or i.width < self.ifd.width:
                f = int(round(self.ifd.width / i.width))
                self.overviews.append((f, i))
        self.overviews.sort(key=lambda t: t[0])

    def _read_ifd(self, off: int) -> Tuple[IFD, int]:
        fp = self._fp
        e = self._e
        fp.seek(off)
        if self.bigtiff:
            n = struct.unpack(e + "Q", fp.read(8))[0]
            entry_size, count_fmt, off_fmt = 20, "Q", "Q"
        else:
            n = struct.unpack(e + "H", fp.read(2))[0]
            entry_size, count_fmt, off_fmt = 12, "I", "I"
        if entry_size * n > self._file_size:
            raise ValueError(f"corrupt TIFF: IFD declares {n} entries")
        raw = fp.read(entry_size * n)
        next_off = struct.unpack(
            e + off_fmt, fp.read(struct.calcsize(off_fmt)))[0]
        tags = {}
        inline = 8 if self.bigtiff else 4
        for k in range(n):
            ent = raw[k * entry_size:(k + 1) * entry_size]
            tag, typ = struct.unpack(e + "HH", ent[:4])
            cnt = struct.unpack(
                e + count_fmt, ent[4:4 + struct.calcsize(count_fmt)])[0]
            if typ not in _FIELD:
                continue
            fmt, size = _FIELD[typ]
            total = size * cnt
            if total > self._file_size:
                raise ValueError(
                    f"corrupt TIFF: tag {tag} declares {total} bytes")
            payload = ent[4 + struct.calcsize(count_fmt):]
            if total <= inline:
                data = payload[:total]
            else:
                ptr = struct.unpack(
                    e + off_fmt, payload[:struct.calcsize(off_fmt)])[0]
                cur = fp.tell()
                fp.seek(ptr)
                data = fp.read(total)
                fp.seek(cur)
            if typ == 2:  # ascii
                tags[tag] = (data.split(b"\0")[0].decode("latin-1"),)
            elif typ in (5, 10):  # (signed) rationals
                c = "I" if typ == 5 else "i"
                vals = struct.unpack(e + c * 2 * cnt, data)
                tags[tag] = tuple(vals[i] / (vals[i + 1] or 1)
                                  for i in range(0, len(vals), 2))
            else:
                tags[tag] = struct.unpack(e + fmt * cnt, data)
        return IFD(tags, off), next_off

    def _parse_geo(self):
        ifd = self.ifd
        scale = ifd.arr(T_MODEL_PIXEL_SCALE)
        tie = ifd.arr(T_MODEL_TIEPOINT)
        xform = ifd.arr(T_MODEL_TRANSFORM)
        if xform and len(xform) >= 16:
            self.gt = GeoTransform(xform[3], xform[0], xform[1],
                                   xform[7], xform[4], xform[5])
        elif scale and tie:
            sx, sy = scale[0], scale[1]
            px, py, _, gx, gy, _ = tie[:6]
            self.gt = GeoTransform(gx - px * sx, sx, 0.0,
                                   gy + py * sy, 0.0, -sy)
        else:
            self.gt = GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
        self.crs = self._geokeys_to_crs()
        nd = ifd.val(T_GDAL_NODATA)
        self.nodata: Optional[float] = None
        if nd is not None:
            try:
                self.nodata = float(str(nd).strip())
            except ValueError:
                pass

    def _geokeys_to_crs(self) -> CRS:
        d = self.ifd.arr(T_GEO_DIR)
        if not d:
            return EPSG4326
        keys = {}
        doubles = self.ifd.arr(T_GEO_DOUBLES)
        ascii_ = self.ifd.val(T_GEO_ASCII, "")
        for i in range(4, len(d), 4):
            kid, loc, cnt, val = d[i:i + 4]
            if loc == 0:
                keys[kid] = val
            elif loc == T_GEO_DOUBLES:
                keys[kid] = doubles[val:val + cnt]
            elif loc == T_GEO_ASCII:
                keys[kid] = ascii_[val:val + cnt].rstrip("|")
        # 3072 ProjectedCSType, 2048 GeographicType
        for key in (3072, 2048):
            code = keys.get(key)
            if isinstance(code, int) and 1024 <= code <= 32767:
                try:
                    return parse_crs(int(code))
                except ValueError:
                    pass
        for key in (1026, 2049, 3073):
            cit = keys.get(key)
            if isinstance(cit, str) and cit:
                try:
                    return parse_crs(cit)
                except ValueError:
                    pass
        return EPSG4326

    @property
    def width(self) -> int:
        return self.ifd.width

    @property
    def height(self) -> int:
        return self.ifd.height

    @property
    def count(self) -> int:
        return int(self.ifd.val(T_SAMPLES, 1))

    @property
    def dtype(self) -> np.dtype:
        bits = self.ifd.arr(T_BITS) or (8,)
        fmt = self.ifd.arr(T_SAMPLE_FORMAT) or (1,)
        return _np_dtype(int(bits[0]), int(fmt[0]))

    def bbox(self) -> BBox:
        return self.gt.bbox(self.width, self.height)

    def read(self, band: int = 1,
             window: Optional[Tuple[int, int, int, int]] = None,
             ifd: Optional[IFD] = None) -> np.ndarray:
        """Read one band (1-based).  window = (col0, row0, w, h).
        Returns (h, w) in storage dtype."""
        ifd = ifd or self.ifd
        W, H = ifd.width, ifd.height
        if window is None:
            window = (0, 0, W, H)
        c0, r0, w, h = window
        if c0 < 0 or r0 < 0 or c0 + w > W or r0 + h > H:
            raise ValueError(f"window {window} outside raster {W}x{H}")
        if w * h > (1 << 31):
            raise ValueError(f"window {w}x{h} implausibly large")
        samples = int(ifd.val(T_SAMPLES, 1))
        planar = int(ifd.val(T_PLANAR, 1))
        bits = ifd.arr(T_BITS) or (8,)
        fmts = ifd.arr(T_SAMPLE_FORMAT) or (1,)
        dt = _np_dtype(int(bits[0]), int(fmts[0])).newbyteorder(self._e)
        comp = int(ifd.val(T_COMPRESSION, 1))
        pred = int(ifd.val(T_PREDICTOR, 1))
        out = np.zeros((h, w), dtype=dt.newbyteorder("="))
        bi = band - 1
        if not (0 <= bi < samples):
            raise ValueError(f"band {band} out of range (1..{samples})")

        if ifd.tags.get(T_TILE_OFFSETS):
            tw = int(ifd.val(T_TILE_W))
            th = int(ifd.val(T_TILE_H))
            offsets = ifd.arr(T_TILE_OFFSETS)
            counts = ifd.arr(T_TILE_COUNTS)
            tiles_x = (W + tw - 1) // tw
            tiles_y = (H + th - 1) // th
            plane_off = bi * tiles_x * tiles_y if planar == 2 else 0
            spp = 1 if planar == 2 else samples
            blocks = [(ty, tx)
                      for ty in range(r0 // th, (r0 + h - 1) // th + 1)
                      for tx in range(c0 // tw, (c0 + w - 1) // tw + 1)]
            raws = self._fetch_blocks(
                [(offsets[plane_off + ty * tiles_x + tx],
                  counts[plane_off + ty * tiles_x + tx])
                 for ty, tx in blocks])
            for (ty, tx), raw in zip(blocks, raws):
                block = self._decode_raw(raw, comp, pred, th, tw, spp, dt)
                data = block[..., 0 if planar == 2 else bi]
                br0, bc0 = ty * th, tx * tw
                rr0 = max(r0, br0)
                rr1 = min(r0 + h, br0 + th)
                cc0 = max(c0, bc0)
                cc1 = min(c0 + w, bc0 + tw)
                out[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0] = \
                    data[rr0 - br0:rr1 - br0, cc0 - bc0:cc1 - bc0]
        else:
            rps = int(ifd.val(T_ROWS_PER_STRIP, H))
            offsets = ifd.arr(T_STRIP_OFFSETS)
            counts = ifd.arr(T_STRIP_COUNTS)
            strips = (H + rps - 1) // rps
            plane_off = bi * strips if planar == 2 else 0
            spp = 1 if planar == 2 else samples
            rows = list(range(r0 // rps, (r0 + h - 1) // rps + 1))
            raws = self._fetch_blocks(
                [(offsets[plane_off + s], counts[plane_off + s])
                 for s in rows])
            for s, raw in zip(rows, raws):
                srows = min(rps, H - s * rps)
                block = self._decode_raw(raw, comp, pred, srows, W, spp, dt)
                data = block[..., 0 if planar == 2 else bi]
                br0 = s * rps
                rr0 = max(r0, br0)
                rr1 = min(r0 + h, br0 + srows)
                out[rr0 - r0:rr1 - r0, :] = \
                    data[rr0 - br0:rr1 - br0, c0:c0 + w]
        return out

    def _fetch_blocks(self, ranges) -> List[bytes]:
        """Raw (compressed) bytes for each (offset, nbytes) block, with
        bounds enforced: a corrupt header must not drive a huge read."""
        for offset, nbytes in ranges:
            if offset < 0 or nbytes < 0 \
                    or offset + nbytes > self._file_size:
                raise ValueError(
                    f"corrupt TIFF: block [{offset}, {offset + nbytes}) "
                    f"beyond file size {self._file_size}")
        out = []
        with self._fp_lock:  # shared handles are read from worker threads
            for offset, nbytes in ranges:
                self._fp.seek(offset)
                out.append(self._fp.read(nbytes))
        return out

    def _decode_raw(self, raw: bytes, comp: int, pred: int, rows: int,
                    cols: int, samples: int, dt: np.dtype) -> np.ndarray:
        expected = rows * cols * samples * dt.itemsize
        if expected > (1 << 31):
            raise ValueError(
                f"corrupt TIFF: block declares {expected} bytes")
        data = _decompress(raw, comp, expected)
        if len(data) < expected:
            data = data + b"\0" * (expected - len(data))
        if pred == 3:
            # float predictor: per row, bytes stored plane-separated and
            # horizontally differenced as uint8
            b = np.frombuffer(data, np.uint8).reshape(
                rows, cols * samples * dt.itemsize)
            b = np.cumsum(b, axis=1, dtype=np.uint8)
            b = b.reshape(rows, dt.itemsize, cols * samples)
            b = np.transpose(b, (0, 2, 1))[:, :, ::-1]
            arr = np.ascontiguousarray(b).view(
                dt.newbyteorder("<")).reshape(rows, cols, samples)
            return arr.astype(dt.newbyteorder("="))
        arr = np.frombuffer(data, dt).reshape(rows, cols, samples)
        if pred == 2:
            arr = arr.astype(dt.newbyteorder("="), copy=True)
            return np.cumsum(arr, axis=1, dtype=arr.dtype)
        return arr.astype(dt.newbyteorder("="), copy=False).reshape(
            rows, cols, samples)

    def pick_overview(self, stride: float):
        """(fx, fy, ifd) for the coarsest overview whose decimation
        factor fits under ``stride``; (1.0, 1.0, None) for full
        resolution."""
        best = None
        for f, ifd in self.overviews:
            if f <= stride:
                best = ifd
        if best is None:
            return 1.0, 1.0, None
        return self.width / best.width, self.height / best.height, best


_SAMPLE_FMT = {"u": 1, "i": 2, "f": 3}


class GeoTIFFWriter:
    """Streaming tiled GeoTIFF writer: tiles append to disk as written,
    in any order and from any thread (a WCS export's encode workers
    stream its tiles here), the IFDs at close().  Unwritten tiles
    resolve to a shared nodata-filled block."""

    def __init__(self, path: str, bands: int, height: int, width: int,
                 dtype, gt: GeoTransform, crs: CRS,
                 nodata: Optional[float] = None, tile_size: int = 256,
                 compress: bool = True):
        self.path = path
        self.bands = bands
        self.height = height
        self.width = width
        self.dtype = np.dtype(dtype)
        self.gt = gt
        self.crs = crs
        self.nodata = nodata
        self.tile_size = tile_size
        self.compress = compress
        self.tiles_x = (width + tile_size - 1) // tile_size
        self.tiles_y = (height + tile_size - 1) // tile_size
        self._tiles: dict = {}      # (ty, tx) -> (offset, nbytes)
        self._ovr: List[dict] = []
        self._lock = threading.Lock()
        self._fp = open(path, "wb")
        self._fp.write(b"II*\0\0\0\0\0")   # IFD offset patched at close
        self._pos = 8
        self._closed = False

    def _encode_block(self, block: np.ndarray) -> bytes:
        ts = self.tile_size
        full = np.full((ts, ts, self.bands),
                       self.nodata if self.nodata is not None else 0,
                       dtype=self.dtype)
        h, w = block.shape[1], block.shape[2]
        full[:h, :w, :] = np.transpose(block, (1, 2, 0))
        raw = full.astype(self.dtype.newbyteorder("<")).tobytes()
        return zlib.compress(raw, 6) if self.compress else raw

    def _append(self, blob: bytes) -> Tuple[int, int]:
        with self._lock:
            off = self._pos
            self._fp.write(blob)
            self._pos += len(blob)
            return off, len(blob)

    def write_tile(self, tx: int, ty: int, block: np.ndarray) -> None:
        """block: (bands, th, tw) in storage dtype; edge tiles may be
        smaller than tile_size (padded with nodata)."""
        blob = self._encode_block(np.asarray(block, self.dtype))
        self._tiles[(ty, tx)] = self._append(blob)

    def write_region(self, x0: int, y0: int, data: np.ndarray) -> None:
        """Write a region (bands, h, w) at pixel (x0, y0), which must lie
        on a tile boundary; its tiles are encoded one by one."""
        ts = self.tile_size
        _, h, w = data.shape
        for ty in range(y0 // ts, (y0 + h + ts - 1) // ts):
            for tx in range(x0 // ts, (x0 + w + ts - 1) // ts):
                r0 = ty * ts - y0
                c0 = tx * ts - x0
                sub = data[:, max(r0, 0):r0 + ts, max(c0, 0):c0 + ts]
                if sub.shape[1] and sub.shape[2]:
                    self.write_tile(tx, ty, sub)

    def append_overview(self, data) -> None:
        """Append one reduced-resolution level, (bands, oh, ow) or
        (oh, ow); its IFD (NewSubfileType=1) chains after the main IFD
        at close().  Call in coarsening order."""
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[None]
        oh, ow = data.shape[1], data.shape[2]
        ts = self.tile_size
        txs = (ow + ts - 1) // ts
        tys = (oh + ts - 1) // ts
        tiles = {}
        for ty in range(tys):
            for tx in range(txs):
                block = data[:, ty * ts:min((ty + 1) * ts, oh),
                             tx * ts:min((tx + 1) * ts, ow)] \
                    .astype(self.dtype)
                tiles[(ty, tx)] = self._append(self._encode_block(block))
        self._ovr.append({"h": oh, "w": ow, "tiles": tiles,
                          "tiles_x": txs, "tiles_y": tys})

    def _base_tags(self, width, height, tile_map, txs, tys):
        dt = self.dtype
        order = [(ty, tx) for ty in range(tys) for tx in range(txs)]
        return [
            (T_WIDTH, 3, [width]),
            (T_HEIGHT, 3, [height]),
            (T_BITS, 3, [dt.itemsize * 8] * self.bands),
            (T_COMPRESSION, 3,
             [COMP_DEFLATE if self.compress else COMP_NONE]),
            (T_PHOTOMETRIC, 3, [1]),
            (T_SAMPLES, 3, [self.bands]),
            (T_PLANAR, 3, [1]),
            (T_TILE_W, 3, [self.tile_size]),
            (T_TILE_H, 3, [self.tile_size]),
            (T_SAMPLE_FORMAT, 3, [_SAMPLE_FMT[dt.kind]] * self.bands),
            (T_TILE_OFFSETS, 4, [tile_map[k][0] for k in order]),
            (T_TILE_COUNTS, 4, [tile_map[k][1] for k in order]),
        ]

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        fp = self._fp
        missing = [(ty, tx) for ty in range(self.tiles_y)
                   for tx in range(self.tiles_x)
                   if (ty, tx) not in self._tiles]
        if missing:
            nd = self._append(self._encode_block(
                np.full((self.bands, 1, 1),
                        self.nodata if self.nodata is not None else 0,
                        self.dtype)))
            for k in missing:
                self._tiles[k] = nd

        gt_ = self.gt
        crs = self.crs
        if crs.is_geographic:
            geo_keys = [(1024, 0, 1, 2), (1025, 0, 1, 1),
                        (2048, 0, 1, crs.epsg or 4326)]
        elif crs.epsg:
            geo_keys = [(1024, 0, 1, 1), (1025, 0, 1, 1),
                        (3072, 0, 1, crs.epsg)]
        else:
            geo_keys = [(1024, 0, 1, 1), (1025, 0, 1, 1),
                        (3072, 0, 1, 32767)]
        ascii_params = "" if (crs.epsg or crs.is_geographic) \
            else crs.to_proj4() + "|"
        if ascii_params:
            geo_keys.append((3073, T_GEO_ASCII, len(ascii_params), 0))
        geo_dir = [1, 1, 0, len(geo_keys)]
        for k in geo_keys:
            geo_dir += list(k)

        tags = self._base_tags(self.width, self.height, self._tiles,
                               self.tiles_x, self.tiles_y)
        tags.append((T_GEO_DIR, 3, geo_dir))
        if gt_.is_north_up and gt_.dy < 0:
            tags.append((T_MODEL_PIXEL_SCALE, 12, [gt_.dx, -gt_.dy, 0.0]))
            tags.append((T_MODEL_TIEPOINT, 12,
                         [0.0, 0.0, 0.0, gt_.x0, gt_.y0, 0.0]))
        else:
            tags.append((T_MODEL_TRANSFORM, 12,
                         [gt_.dx, gt_.rx, 0.0, gt_.x0,
                          gt_.ry, gt_.dy, 0.0, gt_.y0,
                          0.0, 0.0, 0.0, 0.0,
                          0.0, 0.0, 0.0, 1.0]))
        if ascii_params:
            tags.append((T_GEO_ASCII, 2, ascii_params))
        if self.nodata is not None:
            nd = str(int(self.nodata)) \
                if float(self.nodata).is_integer() \
                else repr(float(self.nodata))
            tags.append((T_GDAL_NODATA, 2, nd))
        tags.sort(key=lambda t: t[0])

        ifd_off, next_ptr = self._write_ifd(tags)
        fp.seek(4)
        fp.write(struct.pack("<I", ifd_off))
        fp.seek(self._pos)
        for ov in self._ovr:
            otags = [(T_NEWSUBFILETYPE, 4, [1])] + self._base_tags(
                ov["w"], ov["h"], ov["tiles"], ov["tiles_x"],
                ov["tiles_y"])
            otags.sort(key=lambda t: t[0])
            o_off, o_next = self._write_ifd(otags)
            fp.seek(next_ptr)
            fp.write(struct.pack("<I", o_off))
            fp.seek(self._pos)
            next_ptr = o_next
        fp.close()

    def _write_ifd(self, tags) -> Tuple[int, int]:
        """Pack + write one IFD (out-of-line values first) at the end of
        file.  Returns (ifd offset, offset of its next-IFD pointer)."""
        e = "<"
        fp = self._fp
        blobs = []
        entries = []
        for tag, typ, vals in tags:
            if typ == 2:
                data_b = vals.encode("latin-1") + b"\0"
                cnt = len(data_b)
            else:
                fmtc, _ = _FIELD[typ]
                data_b = struct.pack(e + fmtc * len(vals), *vals)
                cnt = len(vals)
            if len(data_b) <= 4:
                entries.append([tag, typ, cnt, data_b.ljust(4, b"\0")])
            else:
                entries.append([tag, typ, cnt, data_b])
                blobs.append(len(entries) - 1)
        ool_pos = self._pos
        for i in blobs:
            data_b = entries[i][3]
            fp.write(data_b)
            entries[i][3] = struct.pack(e + "I", ool_pos)
            ool_pos += len(data_b)
        ifd_off = ool_pos
        fp.write(struct.pack(e + "H", len(entries)))
        for tag, typ, cnt, inline in entries:
            fp.write(struct.pack(e + "HHI", tag, typ, cnt) + inline)
        next_ptr = ifd_off + 2 + 12 * len(entries)
        fp.write(struct.pack(e + "I", 0))
        self._pos = next_ptr + 4
        return ifd_off, next_ptr


def write_geotiff(path: str, data, gt: GeoTransform, crs: CRS,
                  nodata: Optional[float] = None, tile_size: int = 256,
                  compress: bool = True, overviews: Sequence[int] = ()):
    """Write a (H, W) or (bands, H, W) array as a tiled GeoTIFF.
    ``overviews`` lists decimation factors to embed as reduced-resolution
    IFDs, sampled nearest at block centres (offset f//2)."""
    if isinstance(data, np.ndarray) and data.ndim == 2:
        data = data[None]
    bands = len(data)
    H, W = data[0].shape
    dt = np.result_type(*[np.asarray(b).dtype for b in data]) \
        if not isinstance(data, np.ndarray) else data.dtype
    w = GeoTIFFWriter(path, bands, H, W, dt, gt, crs, nodata=nodata,
                      tile_size=tile_size, compress=compress)
    ts = tile_size
    for ty in range(w.tiles_y):
        for tx in range(w.tiles_x):
            r1 = min((ty + 1) * ts, H)
            c1 = min((tx + 1) * ts, W)
            block = np.stack([np.asarray(b)[ty * ts:r1, tx * ts:c1]
                              for b in data]).astype(dt)
            w.write_tile(tx, ty, block)
    for f in sorted(overviews):
        if f < 2 or H // f < 1 or W // f < 1:
            continue
        w.append_overview(np.stack(
            [np.asarray(b)[f // 2::f, f // 2::f][:H // f, :W // f]
             for b in data]).astype(dt))
    w.close()
