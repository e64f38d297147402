"""PNG encoding and decoding of rendered tiles, with zlib and struct.

Counterpart of the PNG half of `gsky_tpu/io/png.py` (semantics of
`utils/ogc_encoders.go` EncodePNG): one byte band becomes a paletted PNG
(PLTE + tRNS; without a palette a grey ramp whose index 0xFF is
transparent), three bands RGBA with alpha 0 where all three are 0xFF,
four bands RGBA.  The reference encodes through PIL; the bytes here
differ from PIL's (rows are written unfiltered), the decoded pixels do
not.  `decode_png` reads 8-bit greyscale, palette, RGB and RGBA images
with any of the five row filters, so it reads PIL's PNGs too.

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
