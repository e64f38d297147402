"""Port parity, JPEG output: the port's own baseline encoder
(`gsky_tpu_torch.io.png.encode_jpeg`, numpy) against PIL's at quality
85, which the reference calls (`gsky_tpu.io.png.encode_jpeg`), and
``image/jpeg`` GetMap tiles of both servers on `test_torch_server`'s
archive and config.

Bounds: the SOF0 sampling factors and the DQT tables equal PIL's; the
bytes equal PIL's for the same byte tile (asserted where they are, as
for every tile here), else PIL's decode of both within max |d| 8 and
mean |d| 0.5 per channel, and a PSNR against the source at least PIL's
less 0.1 dB.  Over HTTP: status and content type equal, the body equal
to the reference's where the byte tiles are (nearest) and its decode
within the JPEG bounds otherwise; launches as the PNG tile's; two bands
answer 500 in both packages."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from gsky_tpu.io.png import encode_jpeg as jencode_jpeg
from gsky_tpu_torch.io.png import encode_jpeg

from test_torch_server import MASKED, METHODS, NATIVE, S2_BOXES, T_DATA, \
    T_MASK, _both, _getmap, env, wrappers  # noqa: F401 (fixtures)


def _segments(data):
    """(marker, payload) of a JPEG's header segments up to SOS."""
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    out, i = [], 2
    while True:
        marker = data[i + 1]
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((marker, data[i + 4:i + 2 + n]))
        if marker == 0xDA:
            return out
        i += 2 + n


def _sof(data):
    """(height, width, ((id, h, v, tq), ...)) of the SOF0 segment."""
    (p,) = [p for m, p in _segments(data) if m == 0xC0]
    _, h, w, n = struct.unpack(">BHHB", p[:6])
    return h, w, tuple((p[6 + 3 * i], p[7 + 3 * i] >> 4,
                        p[7 + 3 * i] & 15, p[8 + 3 * i]) for i in range(n))


def _dqt(data):
    return [p for m, p in _segments(data) if m == 0xDB]


def _decode(data):
    return np.asarray(Image.open(io.BytesIO(data))).astype(np.int64)


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _tile(kind, h, w, bands, seed):
    """A seeded byte tile like a rendered one: a smooth field with noise
    and a nodata (255) block, or noise alone, or flat."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(bands):
        if kind == "noise":
            t = rng.integers(0, 256, (h, w))
        elif kind == "flat":
            t = np.full((h, w), 37 + 50 * b)
        else:
            yy, xx = np.mgrid[0:h, 0:w]
            t = 120 + 80 * np.sin(xx / (9.0 + b)) * np.cos(yy / 13.0) \
                + rng.normal(0, 9, (h, w))
            t[h // 5:h // 3, w // 4:w // 2] = 255
        out.append(np.clip(t, 0, 255).astype(np.uint8))
    return out


TILES = {f"{kind} {h}x{w} {n}": (kind, h, w, n)
         for kind, h, w in (("field", 256, 256), ("field", 80, 96),
                            ("field", 37, 53), ("noise", 64, 64),
                            ("flat", 17, 33))
         for n in (1, 3)}


@pytest.mark.parametrize("case", sorted(TILES))
def test_encoder_matches_pil(case):
    kind, h, w, n = TILES[case]
    bands = _tile(kind, h, w, n, seed=len(case))
    got, ref = encode_jpeg(bands), jencode_jpeg(bands)
    assert _sof(got) == _sof(ref)
    assert _sof(got)[:2] == (h, w)
    assert _dqt(got) == _dqt(ref)
    if got == ref:
        return
    a, b = _decode(got), _decode(ref)
    d = np.abs(a - b).reshape(h, w, -1)
    assert d.max() <= 8 and (d.mean(axis=(0, 1)) <= 0.5).all(), case
    src = np.stack(bands, -1).squeeze()
    assert _psnr(a, src) >= _psnr(b, src) - 0.1


def test_quality_85_header_is_pils():
    """4:2:0 sampling and the Annex K tables at quality 85, as PIL
    writes them on this host; one band is one component."""
    rgb = encode_jpeg(_tile("field", 32, 32, 3, 1))
    assert _sof(rgb)[2] == ((1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1))
    lum, chrom = _dqt(rgb)
    zz_first = [0, 1, 5, 6, 14, 15, 27, 28]     # natural row 0, zig-zag
    assert [lum[1 + i] for i in zz_first] == [5, 3, 3, 5, 7, 12, 15, 18]
    assert [chrom[1 + i] for i in zz_first] == [5, 5, 7, 14, 30, 30, 30,
                                                30]
    seg = dict(_segments(rgb))
    assert seg[0xE0] == b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    grey = encode_jpeg(_tile("field", 32, 32, 1, 1))
    assert _sof(grey)[2] == ((1, 1, 1, 0),)
    assert len(_dqt(grey)) == 1


@pytest.mark.parametrize("n", [2, 4, 0])
def test_other_band_counts_raise(n):
    bands = _tile("flat", 8, 8, n, 0)
    with pytest.raises(ValueError, match=f"cannot encode {n} bands"):
        encode_jpeg(bands)
    with pytest.raises(ValueError, match=f"cannot encode {n} bands"):
        jencode_jpeg(bands)


# ---------------------------------------------------------------------------
# JPEG GetMap
# ---------------------------------------------------------------------------

def _same_jpeg(ref, got, exact, what=""):
    assert got[:2] == ref[:2] == (200, "image/jpeg"), (what, got[:2],
                                                       ref[:2], got[2][:200])
    if exact:
        assert got[2] == ref[2], what
        return
    a, b = _decode(ref[2]), _decode(got[2])
    d = np.abs(a - b)
    assert d.max() <= 8 and d.mean() <= 0.5, (what, d.max(), d.mean())


@pytest.mark.parametrize("fmt", ["image/jpeg", "image/jpg"])
@pytest.mark.parametrize("method", METHODS)
def test_fused_single_band(env, wrappers, method, fmt):
    for box in NATIVE:
        ref, got = _both(env, _getmap("plain", box, style=method,
                                      time=T_DATA, fmt=fmt))
        _same_jpeg(ref, got, method == "near", method)
    assert wrappers == {"B1": len(NATIVE), "B2": 0, "B4": 0}


def test_palette_is_not_applied(env, wrappers):
    """A JPEG is the byte plane, without the layer's palette, in both."""
    ref, got = _both(env, _getmap("palette", NATIVE[0], time=T_DATA,
                                  fmt="image/jpeg"))
    _same_jpeg(ref, got, True)
    assert _sof(got[2])[2] == ((1, 1, 1, 0),)
    assert wrappers == {"B1": 1, "B2": 0, "B4": 0}


@pytest.mark.parametrize("style", ["near", "bilinear", "four"])
def test_rgb_rungs(env, wrappers, style):
    """The RGBA rung's red, green and blue (no launch) and the planes
    rung's three planes (one B2 launch) as a YCbCr JPEG; a four-band
    style's JPEG is its first three bands, in both packages."""
    for rung, box in S2_BOXES.items():
        ref, got = _both(env, _getmap("truecolour", box, style=style,
                                      time=T_DATA, fmt="image/jpeg"))
        _same_jpeg(ref, got, style != "bilinear", (style, rung))
        assert len(_sof(got[2])[2]) == 3
        img = _decode(got[2])
        assert (img[..., 0] != img[..., 1]).any()      # colour
    want = 2 if style == "four" else 1
    assert wrappers == {"B1": 0, "B2": want, "B4": 0}


def test_two_bands_answer_500(env, wrappers):
    for rung, box in S2_BOXES.items():
        ref, got = _both(env, _getmap("truecolour", box, style="two",
                                      time=T_DATA, fmt="image/jpeg"))
        assert got[:2] == ref[:2] == (500, "application/vnd.ogc.se_xml")
        assert b"cannot encode 2 bands as JPEG" in got[2]
        assert b"cannot encode 2 bands as JPEG" in ref[2]
    assert wrappers["B2"] == 2


@pytest.mark.parametrize("layer", ["masked", "ndvi"])
def test_masked_layers(env, wrappers, layer):
    calls = env["b4_calls"]
    n0 = len(calls)
    ref, got = _both(env, _getmap(layer, MASKED[0], time=T_MASK,
                                  fmt="image/jpeg"))
    _same_jpeg(ref, got, False, layer)
    assert len(calls) - n0 == wrappers["B4"] == (1 if layer == "masked"
                                                 else 2)
    assert wrappers["B1"] == wrappers["B2"] == 0


def test_jpeg_of_the_png_tile(env):
    """The JPEG body is `encode_jpeg` of the PNG tile's byte plane."""
    from gsky_tpu_torch.io.png import decode_png
    _, png = _both(env, _getmap("plain", NATIVE[0], style="near",
                                time=T_DATA))
    _, jpg = _both(env, _getmap("plain", NATIVE[0], style="near",
                                time=T_DATA, fmt="image/jpeg"))
    rgba = decode_png(png[2])
    plane = np.where(rgba[..., 3] == 0, 255, rgba[..., 0]).astype(np.uint8)
    assert jpg[2] == encode_jpeg([plane])
