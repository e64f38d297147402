"""PNG and JPEG encoding of rendered tiles, with zlib, struct and numpy.

Counterpart of `gsky_tpu/io/png.py`.  PNG (semantics of
`utils/ogc_encoders.go` EncodePNG): one byte band becomes a paletted PNG
(PLTE + tRNS; without a palette a grey ramp whose index 0xFF is
transparent), three bands RGBA with alpha 0 where all three are 0xFF,
four bands RGBA.  The reference encodes through PIL; the bytes here
differ from PIL's (rows are written unfiltered), the decoded pixels do
not.  `decode_png` reads 8-bit greyscale, palette, RGB and RGBA images
with any of the five row filters, so it reads PIL's PNGs too.

`encode_jpeg` is the counterpart of the reference's PIL call at quality
85 (`tile_jpg_enc.go`): a baseline JFIF encoder in numpy (one band
greyscale, three bands YCbCr 4:2:0) with libjpeg's integer arithmetic,
so its bytes equal those PIL writes through libjpeg for the same byte
planes.

`ApngAssembler` splices encoded PNG frames into one Animated PNG (a
TIME animation's container) by chunk surgery alone: no pixel is decoded
and nothing is compressed again, so frame 0's IDAT stream is the lone
GetMap's.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

NODATA_BYTE = 255

_SIG = b"\x89PNG\r\n\x1a\n"
_GREY, _RGB, _PALETTE, _GREY_ALPHA, _RGBA = 0, 2, 3, 4, 6
_CHANNELS = {_GREY: 1, _RGB: 3, _PALETTE: 1, _GREY_ALPHA: 2, _RGBA: 4}

# zlib level 1 by default: levels 6-9 buy ~10% smaller tiles for over
# twice the encode time.  GSKY_PNG_LEVEL or a layer's
# png_compress_level trade CPU for bytes.
_LEVEL_ENV = "GSKY_PNG_LEVEL"
_DEFAULT_LEVEL = 1


def _resolve_level(level: Optional[int]) -> int:
    """The zlib level: the call's (a layer's config), else
    GSKY_PNG_LEVEL, else 1; outside 0-9 is an error, not a clamp."""
    if level is None:
        env = os.environ.get(_LEVEL_ENV)
        if env is None or env == "":
            return _DEFAULT_LEVEL
        try:
            level = int(env)
        except ValueError:
            raise ValueError(
                f"{_LEVEL_ENV} must be an integer 0-9, got {env!r}")
    level = int(level)
    if not 0 <= level <= 9:
        raise ValueError(f"PNG compress level must be 0-9, got {level}")
    return level


def _chunk(typ: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + typ + payload
            + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))


def _encode(pixels: np.ndarray, colour_type: int, level: int,
            extra: Sequence[bytes] = ()) -> bytes:
    """pixels (H, W) or (H, W, C) uint8 -> PNG bytes, rows unfiltered."""
    h, w = pixels.shape[:2]
    rows = np.ascontiguousarray(pixels, np.uint8).reshape(h, -1)
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 0                       # filter type None
    raw[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    return b"".join([_SIG, _chunk(b"IHDR", ihdr), *extra,
                     _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)),
                     _chunk(b"IEND", b"")])


def encode_png(bands: Sequence[np.ndarray],
               palette: Optional[np.ndarray] = None,
               compress_level: Optional[int] = None) -> bytes:
    """bands: 1, 3 or 4 (H, W) uint8 arrays; palette: (256, 4) uint8
    RGBA LUT for one band; compress_level: zlib 0-9 (None ->
    GSKY_PNG_LEVEL -> 1)."""
    level = _resolve_level(compress_level)
    if len(bands) == 1:
        if palette is None:
            lut = np.stack([np.arange(256)] * 3 + [np.full(256, 255)], 1)
            lut = lut.astype(np.uint8)
            lut[NODATA_BYTE] = (0, 0, 0, 0)
        else:
            lut = np.asarray(palette, np.uint8)
            if lut.shape != (256, 4):
                raise ValueError("palette must be (256,4) RGBA")
        return _encode(np.asarray(bands[0], np.uint8), _PALETTE, level,
                       [_chunk(b"PLTE", lut[:, :3].tobytes()),
                        _chunk(b"tRNS", lut[:, 3].tobytes())])
    if len(bands) == 3:
        rgb = np.stack([np.asarray(b, np.uint8) for b in bands], -1)
        nodata = (rgb == NODATA_BYTE).all(-1)
        alpha = np.where(nodata, 0, 255).astype(np.uint8)
        return _encode(np.concatenate([rgb, alpha[..., None]], -1), _RGBA,
                       level)
    if len(bands) == 4:
        return encode_rgba_png(np.stack(bands, -1), level)
    raise ValueError(f"cannot encode {len(bands)} bands as PNG")


def encode_rgba_png(rgba: np.ndarray,
                    compress_level: Optional[int] = None) -> bytes:
    """(H, W, 4) uint8 -> PNG bytes."""
    return _encode(np.asarray(rgba, np.uint8), _RGBA,
                   _resolve_level(compress_level))


def empty_tile_png(width: int, height: int,
                   tile_image: Optional[bytes] = None,
                   compress_level: Optional[int] = None) -> bytes:
    """A transparent PNG of the requested size, or ``tile_image`` (PNG
    bytes) repeated over it from the top-left corner: the zoom-limit
    placeholder."""
    canvas = np.zeros((height, width, 4), np.uint8)
    if tile_image:
        tile = decode_png(tile_image)
        th, tw = tile.shape[:2]
        for y in range(0, height, th):
            for x in range(0, width, tw):
                canvas[y:y + th, x:x + tw] = tile[:height - y, :width - x]
    return encode_rgba_png(canvas, compress_level)


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of an
    8-bit image: (h, stride) uint8."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    buf = buf[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ft, line = int(buf[r, 0]), buf[r, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:                          # Sub
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:                          # Up
            cur = line + prev
        elif ft in (3, 4):                     # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else \
                        (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ft}")
        out[r] = cur
        prev = out[r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA: palette entries and tRNS
    transparency applied, greyscale spread to R, G and B."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG stream")
    off, idat = 8, []
    ihdr = plte = trns = None
    while off + 12 <= len(data):
        ln = struct.unpack(">I", data[off:off + 4])[0]
        typ = data[off + 4:off + 8]
        payload = data[off + 8:off + 8 + ln]
        off += 12 + ln
        if typ == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif typ == b"PLTE":
            plte = payload
        elif typ == b"tRNS":
            trns = payload
        elif typ == b"IDAT":
            idat.append(payload)
        elif typ == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch) \
        .reshape(h, w, ch)
    out = np.empty((h, w, 4), np.uint8)
    if ctype == _PALETTE:
        if plte is None:
            raise ValueError("paletted PNG without PLTE")
        lut = np.full((256, 4), 255, np.uint8)
        n = len(plte) // 3
        lut[:n, :3] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
        if trns:
            lut[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        return lut[px[..., 0]]
    if ctype in (_GREY, _GREY_ALPHA):
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1] if ctype == _GREY_ALPHA else 255
        if ctype == _GREY and trns:
            grey = struct.unpack(">H", trns[:2])[0]
            out[..., 3][px[..., 0] == grey] = 0
        return out
    out[..., :3] = px[..., :3]
    out[..., 3] = px[..., 3] if ctype == _RGBA else 255
    if ctype == _RGB and trns:
        key = np.array(struct.unpack(">HHH", trns[:6]))
        out[..., 3][(px == key).all(-1)] = 0
    return out



def _png_chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(type, payload) of each chunk of one PNG byte stream."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG stream")
    off, n = 8, len(data)
    while off + 12 <= n:
        ln = struct.unpack(">I", data[off:off + 4])[0]
        yield data[off + 4:off + 8], data[off + 8:off + 8 + ln]
        off += 12 + ln


class ApngAssembler:
    """An Animated PNG built frame by frame from encoded PNGs of one
    size and palette.  ``frame(png)`` returns the frame's container
    bytes: frame 0 brings the signature, its IHDR, the ``acTL`` chunk
    and its own ancillary chunks (palette, transparency); every frame an
    ``fcTL`` (the whole canvas, replacing the last frame) and its IDAT
    data, typed ``fdAT`` after frame 0.  ``trailer()`` closes it."""

    def __init__(self, num_frames: int, delay_ms: int = 500,
                 num_plays: int = 0):
        if num_frames < 1:
            raise ValueError("APNG needs at least one frame")
        self.num_frames = int(num_frames)
        self.delay_ms = max(1, min(65535, int(delay_ms)))
        self.num_plays = int(num_plays)
        self._seq = 0
        self._n = 0
        self._w = 0
        self._h = 0

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _fctl(self) -> bytes:
        return _chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", self._next_seq(), self._w, self._h, 0, 0,
            self.delay_ms, 1000, 0, 0))

    def frame(self, png: bytes) -> bytes:
        if self._n >= self.num_frames:
            raise ValueError("more frames than declared in acTL")
        head: List[Tuple[bytes, bytes]] = []
        idats: List[bytes] = []
        for typ, payload in _png_chunks(png):
            if typ == b"IDAT":
                idats.append(payload)
            elif typ != b"IEND" and not idats:
                head.append((typ, payload))
        if not idats or not head or head[0][0] != b"IHDR":
            raise ValueError("malformed PNG frame")
        parts: List[bytes] = []
        if self._n == 0:
            ihdr = head[0][1]
            self._w, self._h = struct.unpack(">II", ihdr[0:8])
            parts.append(_SIG)
            parts.append(_chunk(b"IHDR", ihdr))
            parts.append(_chunk(b"acTL", struct.pack(
                ">II", self.num_frames, self.num_plays)))
            parts.extend(_chunk(typ, payload) for typ, payload in head[1:])
            parts.append(self._fctl())
            parts.extend(_chunk(b"IDAT", payload) for payload in idats)
        else:
            parts.append(self._fctl())
            for payload in idats:
                parts.append(_chunk(
                    b"fdAT", struct.pack(">I", self._next_seq()) + payload))
        self._n += 1
        return b"".join(parts)

    def trailer(self) -> bytes:
        if self._n != self.num_frames:
            raise ValueError(
                f"assembled {self._n} of {self.num_frames} frames")
        return _chunk(b"IEND", b"")


def encode_apng(frames: Sequence[bytes], delay_ms: int = 500,
                num_plays: int = 0) -> bytes:
    """Encoded PNG frames -> one Animated PNG."""
    asm = ApngAssembler(len(frames), delay_ms, num_plays)
    return b"".join([asm.frame(f) for f in frames] + [asm.trailer()])


def apng_frames(data: bytes) -> List[bytes]:
    """The frames of an Animated PNG as stand-alone PNGs (its header
    chunks, then each frame's IDAT or fdAT data as IDAT)."""
    head: List[bytes] = []
    frames: List[List[bytes]] = []
    for typ, payload in _png_chunks(data):
        if typ == b"fcTL":
            frames.append([])
        elif typ == b"IDAT":
            frames[-1].append(payload)
        elif typ == b"fdAT":
            frames[-1].append(payload[4:])
        elif typ not in (b"acTL", b"IEND"):
            head.append(_chunk(typ, payload))
    return [_SIG + b"".join(head)
            + b"".join(_chunk(b"IDAT", p) for p in parts)
            + _chunk(b"IEND", b"") for parts in frames]


# -- JPEG ---------------------------------------------------------------
#
# A baseline sequential JFIF encoder in numpy, with libjpeg's integer
# arithmetic at each step, so that its bytes can equal what libjpeg
# writes for the same settings: fixed-point RGB -> YCbCr (jccolor.c),
# h2v2 downsampling with its alternating bias (jcsample.c), edges
# replicated to whole blocks and dummy blocks at the right and bottom
# (jcprepct.c, jccoefct.c), the "islow" DCT (jfdctint.c), quantisation
# by reciprocal multiplication (jcdctmgr.c), the Annex K tables scaled
# by quality, the standard Huffman tables.

_JPEG_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61,
              12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56,
              14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77,
              24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101,
              72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99,
              18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99,
              47, 66, 99, 99, 99, 99, 99, 99,
              99, 99, 99, 99, 99, 99, 99, 99,
              99, 99, 99, 99, 99, 99, 99, 99,
              99, 99, 99, 99, 99, 99, 99, 99,
              99, 99, 99, 99, 99, 99, 99, 99]))

# natural-order index of each zig-zag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the standard Huffman tables (Annex K.3): code counts by length 1-16,
# then the symbols; luminance DC, luminance AC, chrominance DC, AC
_DC_VALS = bytes(range(12))
_HUFF = (
    (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), _DC_VALS),
    (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), _DC_VALS),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")))


def _huff_codes(bits: bytes, vals: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) by symbol, from a table's counts and symbols
    (Annex C)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_HUFF_CODES = [_huff_codes(b, v) for b, v in _HUFF]


def _quant_tables(quality: int) -> List[np.ndarray]:
    """The luminance and chrominance tables at ``quality``, natural
    order (libjpeg's `jpeg_quality_scaling`, baseline-clamped)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in _JPEG_QUANT]


def _ycc(rgb: np.ndarray) -> List[np.ndarray]:
    """(H, W, 3) uint8 -> Y, Cb, Cr planes (int64), libjpeg's fixed
    point (16 fraction bits; Cb and Cr round with 0.5 - epsilon)."""
    def fix(x):
        return int(x * 65536 + 0.5)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b
          + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b
          + off + half - 1) >> 16
    return [y, cb, cr]


def _pad_edges(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """``plane`` grown to (h, w) by repeating its last row and column."""
    ph, pw = plane.shape
    return np.pad(plane, ((0, h - ph), (0, w - pw)), mode="edge")


def _downsample_h2v2(plane: np.ndarray, blocks_w: int) -> np.ndarray:
    """2 x 2 averages with libjpeg's bias, 1 and 2 alternating along a
    row; the input first widened to 16 x ``blocks_w`` columns and an
    even row count by repeating its edges."""
    h = plane.shape[0] + plane.shape[0] % 2
    p = _pad_edges(plane, h, 16 * blocks_w)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.tile(np.array([1, 2], np.int64), s.shape[1] // 2)
    return (s + bias) >> 2


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer DCT over (N, 8, 8) level-shifted
    samples: output scaled up by 8, as `jpeg_fdct_islow` leaves it."""
    c13, p1 = 13, 2

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, shift_even, shift_odd, last):
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2
        out = np.empty_like(d)
        if last:
            out[..., 0] = descale(t10 + t11, p1)
            out[..., 4] = descale(t10 - t11, p1)
        else:
            out[..., 0] = (t10 + t11) << p1
            out[..., 4] = (t10 - t11) << p1
        z1 = (t12 + t13) * 4433
        out[..., 2] = descale(z1 + t13 * 6270, shift_even)
        out[..., 6] = descale(z1 - t12 * 15137, shift_even)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[..., 7] = descale(t4 + z1 + z3, shift_odd)
        out[..., 5] = descale(t5 + z2 + z4, shift_odd)
        out[..., 3] = descale(t6 + z2 + z3, shift_odd)
        out[..., 1] = descale(t7 + z1 + z4, shift_odd)
        return out

    rows = one_pass(blocks, c13 - p1, c13 - p1, False)
    cols = one_pass(rows.swapaxes(1, 2), c13 + p1, c13 + p1, True)
    return cols.swapaxes(1, 2)


def _quantise(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Round each DCT output over 8 x its quantiser, by the reciprocal
    multiply libjpeg-turbo makes (16-bit elements): (N, 64) natural
    order -> (N, 64)."""
    div = (table * 8).astype(np.int64)
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (np.int64(1) << r) // div, (np.int64(1) << r) % div
    corr = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr <= div // 2, fq, fq + 1))
    corr = np.where(~pow2 & (fr <= div // 2), corr + 1, corr)
    r = np.where(pow2, r - 1, r)
    mag = ((np.abs(coefs) + corr) * fq) >> r
    return np.where(coefs < 0, -mag, mag)


def _component_blocks(plane: np.ndarray, h_blocks: int, w_blocks: int,
                      rows: int, cols: int) -> np.ndarray:
    """The quantisable samples of one component in (rows, cols) blocks:
    the plane's real blocks (edges repeated to whole blocks), the
    ``rows`` x ``cols`` grid past them left for dummy blocks."""
    p = _pad_edges(plane, 8 * h_blocks, 8 * w_blocks) - 128
    grid = np.zeros((rows, cols, 8, 8), np.int64)
    grid[:h_blocks, :w_blocks] = p.reshape(
        h_blocks, 8, w_blocks, 8).swapaxes(1, 2)
    return grid


def _scan_blocks(planes, sampling, tables):
    """Quantised zig-zag coefficients of every block in scan order
    (N, 64), each block's table index (0 luminance, 1 chrominance) and
    its component."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height, width = planes[0].shape
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    per_comp = []
    for ci, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        w_blocks = -(-width * hs // (8 * hmax))
        h_blocks = -(-height * vs // (8 * vmax))
        grid = _component_blocks(plane, h_blocks, w_blocks, mcuy * vs,
                                 mcux * hs)
        n = grid.shape[0] * grid.shape[1]
        q = _quantise(_fdct_islow(grid.reshape(n, 8, 8)).reshape(n, 64),
                      tables[min(ci, 1)])
        q = q.reshape(grid.shape[0], grid.shape[1], 64)
        # dummy blocks: AC 0, DC the block's left neighbour's (right
        # edge) or, past the last block row, the previous block row's
        # last in the same MCU
        q[:, w_blocks:, 1:] = 0
        q[h_blocks:, :, 1:] = 0
        for bx in range(w_blocks, q.shape[1]):
            q[:h_blocks, bx, 0] = q[:h_blocks, bx - 1, 0]
        for by in range(h_blocks, q.shape[0]):
            q[by, :, 0] = np.repeat(q[by - 1, hs - 1::hs, 0], hs)
        # (mcuy, vs, mcux, hs, 64) -> (mcuy, mcux, vs, hs, 64)
        q = q.reshape(mcuy, vs, mcux, hs, 64).transpose(0, 2, 1, 3, 4)
        per_comp.append(q.reshape(mcuy * mcux, vs * hs, 64))
    scan = np.concatenate(per_comp, axis=1)         # (MCUs, blocks, 64)
    kinds = np.concatenate([np.full(vs * hs, min(ci, 1))
                            for ci, (hs, vs) in enumerate(sampling)])
    comp = np.concatenate([np.full(vs * hs, ci)
                           for ci, (hs, vs) in enumerate(sampling)])
    zz = scan[..., _ZIGZAG].reshape(-1, 64)
    return zz, np.tile(kinds, scan.shape[0]), np.tile(comp, scan.shape[0])


def _bit_count(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category; 0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _entropy_code(zz: np.ndarray, kinds: np.ndarray,
                  comp: np.ndarray) -> bytes:
    """The Huffman-coded scan of blocks ``zz`` (N, 64) zig-zag, padded
    with 1 bits and byte-stuffed."""
    n = zz.shape[0]
    # DC: the difference from the same component's previous block
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for ci in np.unique(comp):
        sel = np.nonzero(comp == ci)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    keys, vals, lens = [], [], []
    dc_tab = kinds * 2                      # table 0 or 2
    ac_tab = kinds * 2 + 1                  # table 1 or 3
    codes = np.stack([c for c, _ in _HUFF_CODES])       # (4, 256)
    clens = np.stack([l for _, l in _HUFF_CODES])
    blk = np.arange(n, dtype=np.int64)

    s = _bit_count(diff)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    keys.append(blk * 256)
    vals.append((codes[dc_tab, s] << s) | extra)
    lens.append(clens[dc_tab, s] + s)

    # AC: each non-zero coefficient with its run of zeros before it;
    # runs of 16 or more need a ZRL (0xF0) per 16
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s = _bit_count(v)
    extra = np.where(v < 0, v - 1, v) & ((1 << s) - 1)
    sym = ((run & 15) << 4) | s
    tab = ac_tab[b]
    keys.append(b * 256 + 2 * k)
    vals.append((codes[tab, sym] << s) | extra)
    lens.append(clens[tab, sym] + s)
    nzrl = run >> 4
    zb = np.repeat(b, nzrl)
    ztab = ac_tab[zb]
    keys.append(zb * 256 + 2 * np.repeat(k, nzrl) - 1)
    vals.append(codes[ztab, 0xF0])
    lens.append(clens[ztab, 0xF0])
    # EOB where a block's last coefficient is zero
    last = np.full(n, 0, np.int64)
    last[b] = k                         # k ascends within a block
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 256 + 255)
    vals.append(codes[ac_tab[eob], 0])
    lens.append(clens[ac_tab[eob], 0])

    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    # bit-pack, most significant bit first
    total = int(lens.sum())
    start = np.cumsum(lens) - lens
    item = np.repeat(np.arange(len(lens)), lens)
    shift = np.repeat(start + lens - 1, lens) - np.arange(total)
    bits = ((vals[item] >> shift) & 1).astype(np.uint8)
    pad = -total % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


def encode_jpeg(bands: Sequence[np.ndarray], quality: int = 85) -> bytes:
    """1 band -> greyscale JPEG, 3 bands -> YCbCr 4:2:0 JPEG (baseline,
    JFIF 1.01, standard Huffman tables); any other count raises."""
    if len(bands) == 1:
        planes = [np.asarray(bands[0], np.uint8).astype(np.int64)]
        sampling = [(1, 1)]
    elif len(bands) == 3:
        rgb = np.stack([np.asarray(b, np.uint8) for b in bands], -1)
        planes = _ycc(rgb)
        sampling = [(2, 2), (1, 1), (1, 1)]
    else:
        raise ValueError(f"cannot encode {len(bands)} bands as JPEG")
    height, width = planes[0].shape
    tables = _quant_tables(quality)
    if len(planes) == 3:
        cw = -(-width // 16)
        planes = [planes[0]] + [_downsample_h2v2(p, cw) for p in planes[1:]]
    zz, kinds, comp = _scan_blocks(planes, sampling, tables)
    head = [b"\xff\xd8",
            _marker(0xE0, b"JFIF\x00" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))]
    for i in range(min(len(planes), 2)):
        head.append(_marker(0xDB, bytes([i]) + bytes(
            tables[i][_ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, height, width, len(planes))
    for ci, (hs, vs) in enumerate(sampling):
        sof += bytes([ci + 1, (hs << 4) | vs, min(ci, 1)])
    head.append(_marker(0xC0, sof))
    for i, (bits, vals) in enumerate(_HUFF[:2 * min(len(planes), 2)]):
        tc, th = i % 2, i // 2
        head.append(_marker(0xC4, bytes([(tc << 4) | th]) + bits + vals))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        t = min(ci, 1)
        sos += bytes([ci + 1, (t << 4) | t])
    head.append(_marker(0xDA, sos + bytes([0, 63, 0])))
    return b"".join(head) + _entropy_code(zz, kinds, comp) + b"\xff\xd9"
