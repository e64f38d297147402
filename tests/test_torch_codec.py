"""The port's native GeoTIFF codec (`gsky_tpu_torch/native/codec.cpp`)
against its plain Python versions and the JAX package's decoders.

The library is built with the host C++ compiler on first use.  Every
comparison is exact: the decoders move bytes, with no arithmetic that
could round.  LZW streams come from a full TIFF-LZW encoder here (code
widths 9-12, the KwKwK case, CLEAR mid-stream and when the table
fills) and from PIL's libtiff writer; predictor 2 and 3 blocks from
hand-made TIFFs.  `lzw_literal` and `write_lzw_geotiff` (9-bit literal
codes with a CLEAR every 254 codes, horizontal predictor, overviews)
make the compressed archives of the ingest and server tests.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import pytest
from PIL import Image

import gsky_tpu.io.geotiff as jg

from gsky_tpu_torch import native
from gsky_tpu_torch.io import geotiff as tg
from gsky_tpu_torch.io.geotiff import GeoTIFF, GeoTIFFWriter

CLEAR, EOI = 256, 257


# ---------------------------------------------------------------------------
# test-side encoders
# ---------------------------------------------------------------------------

def lzw_encode(data: bytes, clear_every: int = 0, seen=None) -> bytes:
    """TIFF LZW: MSB-first codes, the decoder's early width change, a
    CLEAR when the table would pass 4093 entries and, with
    ``clear_every``, after that many codes.  ``seen`` (a dict) gets the
    code widths used and the CLEARs and KwKwK codes emitted."""
    codes = []

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = reset()
    codes.append((CLEAR, width))
    since = 0
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width))
        since += 1
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
        w = bytes([c])
        if nxt >= 4094 or (clear_every and since >= clear_every):
            codes.append((CLEAR, width))
            table, nxt, width = reset()
            since = 0
    if w:
        codes.append((table[w], width))
        # the decoder adds an entry on this code before it reads EOI
        if since and nxt + 1 >= (1 << width) and width < 12:
            width += 1
    codes.append((EOI, width))
    if seen is not None:
        seen["widths"] = sorted({wd for _, wd in codes})
        seen["clears"] = sum(c == CLEAR for c, _ in codes)
    acc, nbits = 0, 0
    for code, wd in codes:
        acc = (acc << wd) | code
        nbits += wd
    pad = -nbits % 8
    return (acc << pad).to_bytes((nbits + pad) // 8, "big")


def lzw_literal(raw: bytes) -> bytes:
    """A valid TIFF LZW stream of 9-bit literal codes: a CLEAR every 254
    codes keeps the table from widening them, eight codes pack into
    nine bytes.  Vectorised, for Landsat-size bands."""
    b = np.frombuffer(raw, np.uint8)
    n = b.size
    per = 253
    groups = max(1, -(-n // per))
    codes = np.empty((groups, per + 1), np.uint16)
    codes[:, 0] = CLEAR
    lit = np.zeros(groups * per, np.uint16)
    lit[:n] = b
    codes[:, 1:] = lit.reshape(groups, per)
    total = n + groups + 1
    c = np.zeros(total + (-total % 8), np.uint16)
    c[:n + groups] = codes.reshape(-1)[:n + groups]
    c[n + groups] = EOI
    c = c.reshape(-1, 8)
    out = np.empty((len(c), 9), np.uint8)
    out[:, 0] = c[:, 0] >> 1
    for k in range(1, 8):
        out[:, k] = ((c[:, k - 1] & ((1 << k) - 1)) << (8 - k)) \
            | (c[:, k] >> (k + 1))
    out[:, 8] = c[:, 7] & 0xFF
    return out.tobytes()


def predict_h(block: np.ndarray) -> np.ndarray:
    """Predictor 2 on a (rows, cols) integer block (wrapping deltas)."""
    d = block.copy()
    d[:, 1:] = block[:, 1:] - block[:, :-1]
    return d


class LZWGeoTIFFWriter(GeoTIFFWriter):
    """The port's tiled writer with LZW (9-bit literal codes) and the
    horizontal predictor in place of deflate."""

    def _encode_block(self, block: np.ndarray) -> bytes:
        ts = self.tile_size
        full = np.full((ts, ts), self.nodata if self.nodata is not None
                       else 0, dtype=self.dtype)
        full[:block.shape[1], :block.shape[2]] = block[0]
        raw = predict_h(full).astype(self.dtype.newbyteorder("<")).tobytes()
        return lzw_literal(raw)

    def _base_tags(self, width, height, tile_map, txs, tys):
        tags = super()._base_tags(width, height, tile_map, txs, tys)
        tags = [(t, typ, [tg.COMP_LZW] if t == tg.T_COMPRESSION else v)
                for t, typ, v in tags]
        return tags + [(tg.T_PREDICTOR, 3, [2])]


def write_lzw_geotiff(path, data, gt, crs, nodata=None, tile_size=512,
                      overviews=(2, 4)):
    """One integer band as a tiled LZW + predictor-2 GeoTIFF, with
    overview IFDs sampled at block centres as `write_geotiff`'s."""
    H, W = data.shape
    w = LZWGeoTIFFWriter(path, 1, H, W, data.dtype, gt, crs, nodata=nodata,
                         tile_size=tile_size, compress=False)
    ts = tile_size
    for ty in range(w.tiles_y):
        for tx in range(w.tiles_x):
            w.write_tile(tx, ty, data[None, ty * ts:(ty + 1) * ts,
                                      tx * ts:(tx + 1) * ts])
    for f in sorted(overviews):
        w.append_overview(data[f // 2::f, f // 2::f][:H // f, :W // f])
    w.close()


def strip_tiff(path, data, compression, predictor, blob):
    """A single-strip little-endian TIFF holding ``blob`` as the
    encoded strip of ``data``'s shape and dtype."""
    h, w = data.shape
    dt = data.dtype
    fmt = {"u": 1, "i": 2, "f": 3}[dt.kind]
    tags = [
        (256, 3, [w]), (257, 3, [h]), (258, 3, [dt.itemsize * 8]),
        (259, 3, [compression]), (262, 3, [1]), (273, 4, [8]),
        (277, 3, [1]), (278, 3, [h]), (279, 4, [len(blob)]),
        (317, 3, [predictor]), (339, 3, [fmt]),
    ]
    buf = b"II*\0" + struct.pack("<I", 8 + len(blob)) + blob
    buf += struct.pack("<H", len(tags))
    for tag, typ, vals in tags:
        fmtc = {3: "H", 4: "I"}[typ]
        buf += struct.pack("<HHI", tag, typ, len(vals)) + struct.pack(
            "<" + fmtc * len(vals), *vals).ljust(4, b"\0")
    buf += struct.pack("<I", 0)
    with open(path, "wb") as fp:
        fp.write(buf)
    return str(path)


def predicted(data: np.ndarray, predictor: int) -> bytes:
    """The raw strip bytes of ``data`` under predictor 2 or 3."""
    h, w = data.shape
    if predictor == 2:
        return predict_h(data).astype(data.dtype.newbyteorder("<")).tobytes()
    be = data.astype(data.dtype.newbyteorder(">")).view(np.uint8)
    planes = np.transpose(be.reshape(h, w, data.dtype.itemsize),
                          (0, 2, 1)).reshape(h, -1)
    enc = planes.copy()
    enc[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return enc.tobytes()


# ---------------------------------------------------------------------------
# LZW and PackBits streams
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(13)
    noise = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    smooth = np.cumsum(rng.integers(-2, 3, 30000)).astype(np.uint8).tobytes()
    return {
        "empty": b"",
        "one": b"\x07",
        "kwkwk": b"a" * 5000,                      # code == next code
        "text": b"TOBEORNOTTOBEORTOBEORNOT#" * 400,
        "noise": noise,                            # widths 9-12, table full
        "smooth": smooth,
        "mixed": noise[:3000] + b"\0" * 7000 + smooth[:9000],
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("clear_every", [0, 300])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_lzw_codec_equals_plain_and_reference(name, clear_every):
    data = PAYLOADS[name]
    enc = lzw_encode(data, clear_every)
    got = native.codec().lzw_decode(enc, len(data))
    assert got == tg.lzw_decode_plain(enc, len(data)) == data
    assert jg._lzw_decode(enc, len(data)) == data
    # a short output buffer truncates identically
    n = len(data) // 3
    assert native.codec().lzw_decode(enc, n) == \
        tg.lzw_decode_plain(enc, n) == data[:n]


def test_lzw_encoder_reaches_every_width():
    """The noise payload's stream widens to 12-bit codes and fills the
    table (CLEAR emitted mid-stream), so the decoder's every branch
    runs."""
    data = PAYLOADS["noise"]
    seen = {}
    enc = lzw_encode(data, seen=seen)
    assert seen["widths"] == [9, 10, 11, 12] and seen["clears"] >= 5
    assert native.codec().lzw_decode(enc, len(data)) == data


def test_lzw_literal_stream():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 100_003, dtype=np.uint8).tobytes()
    enc = lzw_literal(data)
    assert len(enc) == -(-(len(data) + -(-len(data) // 253) + 1) // 8) * 9
    assert native.codec().lzw_decode(enc, len(data)) == \
        tg.lzw_decode_plain(enc, len(data)) == \
        jg._lzw_decode(enc, len(data)) == data


@pytest.mark.parametrize("stream", [
    # a code beyond the next free one, after one or two literals
    [CLEAR, 65, 300],
    [CLEAR, 65, 66, 400],
])
def test_corrupt_lzw_raises_the_same_error(stream):
    bits = "".join(format(c, "09b") for c in stream)
    bits += "0" * (-len(bits) % 8)
    enc = int(bits, 2).to_bytes(len(bits) // 8, "big")
    for decode in (native.codec().lzw_decode, tg.lzw_decode_plain,
                   jg._lzw_decode):
        with pytest.raises(ValueError, match="corrupt LZW stream"):
            decode(enc, 64)


def packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and (
                j + 1 >= len(data) or data[j + 1] != data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_packbits_codec_equals_plain_and_reference(name):
    data = PAYLOADS[name]
    enc = packbits_encode(data) + b"\x80"      # a no-op code (-128)
    assert native.codec().packbits_decode(enc, len(data)) == \
        tg.packbits_decode_plain(enc, len(data)) == \
        jg._packbits_decode(enc, len(data)) == data
    # a literal run cut short by the end of the stream
    cut = bytes([40]) + data[:10]
    assert native.codec().packbits_decode(cut, 41) == \
        tg.packbits_decode_plain(cut, 41)


# ---------------------------------------------------------------------------
# predictors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint16", "int32"])
@pytest.mark.parametrize("samples", [1, 3])
def test_unpredict_h_equals_plain(dtype, samples):
    rng = np.random.default_rng(21)
    info = np.iinfo(dtype)
    arr = rng.integers(info.min, info.max, (17, 31, samples),
                       dtype=np.int64).astype(dtype)
    got = arr.copy()
    assert native.codec().unpredict_h(got)
    np.testing.assert_array_equal(got, tg.unpredict_h_plain(arr))


def test_unpredict_h_declines_non_contiguous():
    arr = np.zeros((8, 16, 2), np.int16)[:, ::2, :]
    assert not native.codec().unpredict_h(arr)
    assert not native.codec().unpredict_h(np.zeros((4, 4, 1), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_unpredict_fp_equals_plain(dtype):
    rng = np.random.default_rng(22)
    data = rng.normal(size=(9, 23)).astype(dtype)
    raw = predicted(data, 3)
    rows, cols, item = data.shape[0], data.shape[1], data.dtype.itemsize
    got = native.codec().unpredict_fp(raw, rows, cols, 1, item)
    assert got == tg.unpredict_fp_plain(raw, rows, cols, 1, item)
    np.testing.assert_array_equal(
        np.frombuffer(got, data.dtype.newbyteorder("<")).reshape(rows, cols),
        data)


# ---------------------------------------------------------------------------
# files: the reader through the codec, against the JAX package's reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["tiff_lzw", "packbits"])
@pytest.mark.parametrize("mode,dtype", [("L", "uint8"), ("I;16", "uint16"),
                                        ("I", "int32"), ("F", "float32")])
def test_pil_written_files(tmp_path, compression, mode, dtype):
    rng = np.random.default_rng(31)
    data = (rng.normal(size=(67, 93)) * 40).astype(dtype)
    data[10:40, 5:60] = data[0, 0]                # runs for PackBits
    p = str(tmp_path / f"{compression}_{dtype}.tif")
    Image.fromarray(data, mode=mode).save(p, compression=compression)
    with GeoTIFF(p) as t, jg.GeoTIFF(p) as j:
        np.testing.assert_array_equal(t.read(1), data)
        np.testing.assert_array_equal(t.read(1), j.read(1))
        np.testing.assert_array_equal(t.read(1, (7, 9, 50, 40)),
                                      data[9:49, 7:57])


@pytest.mark.parametrize("compression", [1, 5])
@pytest.mark.parametrize("dtype,predictor", [
    ("uint8", 2), ("int16", 2), ("uint16", 2), ("float32", 3),
    ("float64", 3)])
def test_predictor_files(tmp_path, compression, dtype, predictor):
    rng = np.random.default_rng(41)
    data = (rng.normal(size=(24, 37)) * 300).astype(dtype)
    raw = predicted(data, predictor)
    blob = lzw_encode(raw) if compression == 5 else raw
    p = strip_tiff(tmp_path / "p.tif", data, compression, predictor, blob)
    with GeoTIFF(p) as t, jg.GeoTIFF(p) as j:
        np.testing.assert_array_equal(t.read(1), data)
        np.testing.assert_array_equal(t.read(1), j.read(1))


def test_reader_decodes_through_the_codec(tmp_path, monkeypatch):
    """LZW and predictor 2 in `GeoTIFF.read` call the built library;
    the plain Python decoders are not on the read path."""
    calls = []
    lib = native.codec()
    for name in ("lzw_decode", "unpredict_h"):
        fn = getattr(lib, name)
        monkeypatch.setattr(lib, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    monkeypatch.setattr(tg, "lzw_decode_plain", None)
    monkeypatch.setattr(tg, "unpredict_h_plain", None)
    from gsky_tpu_torch.geo.crs import EPSG4326
    from gsky_tpu_torch.geo.transform import GeoTransform
    data = np.arange(600 * 700, dtype=np.int16).reshape(600, 700) % 977
    p = str(tmp_path / "lzw.tif")
    write_lzw_geotiff(p, data, GeoTransform(0, 1, 0, 0, 0, -1), EPSG4326,
                      nodata=-1, tile_size=256, overviews=(2,))
    with GeoTIFF(p) as t:
        np.testing.assert_array_equal(t.read(1), data)
        np.testing.assert_array_equal(t.read(1, ifd=t.overviews[0][1]),
                                      data[1::2, 1::2][:300, :350])
    # 3 x 3 tiles of the band, 2 x 2 of its overview
    assert calls.count("lzw_decode") == calls.count("unpredict_h") == 9 + 4


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_build_is_content_addressed_under_build():
    path = native.codec().path
    assert path.parent == native.BUILD and path.exists()
    assert path == native.target()
    assert native.target().name.startswith("libgskycodec-")


@pytest.mark.parametrize("cxx", ["/nonexistent/c++", "false"])
def test_failed_build_raises_naming_the_compiler(tmp_path, monkeypatch, cxx):
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError,
                       match="native codec: .*" + re.escape(cxx)):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
