"""Port parity, the OWS front end's host modules: PNG encode and decode,
palettes, the priority combine of partial mosaics, request parameters
and config.json, against the JAX package (whose PNG codec is PIL).

Bounds: decoded pixels identical (the PNG bytes need not be: the port
writes rows unfiltered, PIL filters them); palettes and the combine
bit-exact; parsed requests and configs equal field for field."""

import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from gsky_tpu.io import png as jpng
from gsky_tpu.ops import palette as jpalette
from gsky_tpu.ops.warp import combine_scored as jcombine_scored
from gsky_tpu.server import config as jconfig
from gsky_tpu.server import params as jparams

from gsky_tpu_torch.io import png as tpng
from gsky_tpu_torch.ops import palette as tpalette
from gsky_tpu_torch.ops.warp import combine_scored
from gsky_tpu_torch.server import config as tconfig
from gsky_tpu_torch.server import params as tparams

LEVELS = list(range(10))


def _pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _tile(seed, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 255, shape, dtype=np.uint8)
    t[:5, :7] = 255                                  # nodata
    return t


def _filter_types(data: bytes):
    """The row filter types of a PNG stream."""
    off, idat, w, h, ctype = 8, [], 0, 0, 0
    while off < len(data):
        ln = struct.unpack(">I", data[off:off + 4])[0]
        typ = data[off + 4:off + 8]
        if typ == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", data[off + 8:off + 18])
        elif typ == b"IDAT":
            idat.append(data[off + 8:off + 8 + ln])
        off += 12 + ln
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


# ---------------------------------------------------------------------------
# encode_png / decode_png
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["L", "P", "RGB", "RGBA"])
def test_round_trip(kind, level):
    bands = [_tile(1), _tile(2), _tile(3), _tile(4)]
    palette = None
    if kind == "P":
        palette = tpalette.with_nodata_entry(tpalette.gradient_palette(
            [(0, 0, 128, 255), (40, 200, 40, 180), (255, 255, 0, 255)]))
    n = {"L": 1, "P": 1, "RGB": 3, "RGBA": 4}[kind]
    data = tpng.encode_png(bands[:n], palette, compress_level=level)
    got = tpng.decode_png(data)
    np.testing.assert_array_equal(got, _pil_rgba(data))
    # and the reference encoder's pixels
    ref = jpng.encode_png(bands[:n], palette, compress_level=level)
    np.testing.assert_array_equal(got, _pil_rgba(ref))
    if kind in ("L", "P"):
        assert (got[:5, :7, 3] == 0).all()          # nodata transparent
    if kind == "RGBA":
        np.testing.assert_array_equal(got, np.stack(bands, -1))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_decode_reads_the_reference_encoder(level):
    """Every body the reference writes through PIL, with the row filters
    PIL picks (None, Sub, Up and Paeth here)."""
    yy, xx = np.mgrid[0:48, 0:61]
    smooth = ((np.sin(xx / 7) + np.cos(yy / 5)) * 60 + 128).astype(np.uint8)
    seen = set()
    for bands in ([_tile(5, (48, 61))], [smooth, smooth.T[:48, :48].repeat(
            2, 1)[:, :61], _tile(6, (48, 61))],
            [smooth, _tile(7, (48, 61)), smooth[::-1], _tile(8, (48, 61))]):
        for body in (jpng.encode_png(bands, compress_level=level),
                     jpng.encode_rgba_png(np.stack(
                         [bands[0]] * 3 + [bands[-1]], -1),
                         compress_level=level)):
            np.testing.assert_array_equal(tpng.decode_png(body),
                                          _pil_rgba(body))
            seen |= _filter_types(body)
    assert {1, 2, 4} <= seen


def _filtered_png(pixels, ctype, ft):
    """An 8-bit PNG whose every row uses filter type ``ft`` (0-4),
    written here by the PNG specification's own equations."""
    h, w = pixels.shape[:2]
    bpp = pixels.shape[2] if pixels.ndim == 3 else 1
    rows = pixels.reshape(h, -1).astype(np.int64)
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for r in rows:
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if ft == 0:
            pred = np.zeros_like(r)
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(bytes([ft]) + ((r - pred) % 256).astype(np.uint8)
                   .tobytes())
        prev = r
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    chunks = [(b"IHDR", ihdr)]
    if ctype == 3:
        chunks.append((b"PLTE", bytes(range(256)) * 3))
        chunks.append((b"tRNS", bytes(range(0, 256, 2))))
    chunks.append((b"IDAT", zlib.compress(b"".join(out))))
    chunks.append((b"IEND", b""))
    return b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(p)) + t + p
        + struct.pack(">I", zlib.crc32(t + p) & 0xFFFFFFFF)
        for t, p in chunks)


@pytest.mark.parametrize("ft", range(5))
@pytest.mark.parametrize("ctype", [0, 2, 3, 6])
def test_decode_every_filter_type(ctype, ft):
    rng = np.random.default_rng(10 * ctype + ft)
    ch = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    px = rng.integers(0, 256, (19, 23, ch), dtype=np.uint8)
    data = _filtered_png(px[..., 0] if ch == 1 else px, ctype, ft)
    got = tpng.decode_png(data)
    np.testing.assert_array_equal(got, _pil_rgba(data))


@pytest.mark.parametrize("with_image", [False, True])
def test_empty_tile(with_image):
    image = None
    if with_image:
        tile = _tile(9, (24, 40))
        image = jpng.encode_png([tile])
    for w, h in ((64, 48), (100, 90), (256, 256)):
        got = tpng.decode_png(tpng.empty_tile_png(w, h, image))
        want = _pil_rgba(jpng.empty_tile_png(w, h, image))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (h, w, 4)
        assert got[..., 3].any() == with_image


def test_compress_level_setting(monkeypatch):
    t = [(np.arange(64 * 64) // 7 % 11).astype(np.uint8).reshape(64, 64)]
    monkeypatch.setenv("GSKY_PNG_LEVEL", "0")
    stored = tpng.encode_png(t)
    monkeypatch.delenv("GSKY_PNG_LEVEL")
    assert len(stored) > 64 * 64 > len(tpng.encode_png(t)) \
        >= len(tpng.encode_png(t, compress_level=9))
    monkeypatch.setenv("GSKY_PNG_LEVEL", "x")
    with pytest.raises(ValueError):
        tpng.encode_png(t)
    monkeypatch.delenv("GSKY_PNG_LEVEL")
    for bad in (-1, 10):
        with pytest.raises(ValueError):
            tpng.encode_png(t, compress_level=bad)
    with pytest.raises(ValueError):
        tpng.encode_png([t[0], t[0]])


# ---------------------------------------------------------------------------
# palettes and the combine
# ---------------------------------------------------------------------------

PALETTES = [
    ([(0, 0, 128, 255), (255, 255, 0, 255)], True),
    ([(255, 0, 0, 255), (0, 255, 0, 128), (0, 0, 255, 0)], True),
    ([(200, 10, 30, 255)] * 2 + [(5, 250, 100, 40), (90, 90, 90, 255),
                                 (0, 0, 0, 255), (255, 255, 255, 255),
                                 (12, 34, 56, 78)], True),
    ([(255, 0, 0, 255), (0, 255, 0, 255), (0, 0, 255, 255)], False),
    ([(i * 9 % 256, i * 31 % 256, i * 77 % 256, 255) for i in range(11)],
     False),
]


@pytest.mark.parametrize("case", range(len(PALETTES)))
def test_palette_luts_match(case):
    colours, interp = PALETTES[case]
    want = jpalette.gradient_palette(colours, interp)
    got = tpalette.gradient_palette(colours, interp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpalette.with_nodata_entry(got),
                                  jpalette.with_nodata_entry(want))
    img = _tile(case, (17, 19))
    np.testing.assert_array_equal(
        tpalette.apply_palette(torch.from_numpy(img), got).numpy(),
        np.asarray(jpalette.apply_palette(jnp.asarray(img), want)))


@pytest.mark.parametrize("G,n_ns", [(1, 1), (2, 1), (2, 2), (3, 4)])
def test_combine_scored_matches(G, n_ns):
    rng = np.random.default_rng(G * 10 + n_ns)
    canvs = rng.normal(0, 100, (G, n_ns, 33, 29)).astype(np.float32)
    # priorities from a few levels (ties across partials), -inf = none
    bests = rng.integers(1, 4, (G, n_ns, 33, 29)).astype(np.float32)
    bests[rng.random(bests.shape) < 0.4] = -np.inf
    bests[:, :, :3] = -np.inf                        # no partial has data
    want_c, want_v = jcombine_scored(jnp.asarray(canvs), jnp.asarray(bests))
    got_c, got_v = combine_scored(torch.from_numpy(canvs),
                                  torch.from_numpy(bests))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_c.numpy().view(np.int32),
                                  np.asarray(want_c).view(np.int32))


# ---------------------------------------------------------------------------
# request parameters and config.json
# ---------------------------------------------------------------------------

QUERIES = [
    {"service": "WMS", "request": "GetMap", "version": "1.3.0",
     "layers": "a,b", "styles": ",x", "crs": "EPSG:4326",
     "bbox": "-35.5,148.0,-35.0,148.5", "width": "256.0",
     "height": "128", "format": "image/png",
     "time": "2020-01-11T00:00:00.000Z,2020-01-10,now", "dim_depth": "5"},
    {"SERVICE": "WMS", "REQUEST": "GetMap", "VERSION": "1.1.1",
     "LAYERS": "a", "SRS": "EPSG:4326", "BBOX": "148.0,-35.5,148.5,-35.0",
     "WIDTH": "64", "HEIGHT": "64", "I": "3", "J": "4"},
    {"request": "GetMap", "layer": "a", "crs": "EPSG:3857",
     "bbox": "1,2,3,4"},
    {"request": "getcapabilities"},
]
BAD_QUERIES = [
    {"request": "GetMap", "version": "1.2.0"},
    {"request": "GetMap", "bbox": "1,2,3,4"},
    {"request": "GetMap", "crs": "EPSG:3857", "bbox": "1,2,3"},
    {"request": "GetMap", "crs": "EPSG:3857", "bbox": "3,2,1,4"},
    {"request": "GetMap", "crs": "nonsense"},
    {"request": "GetMap", "width": "wide"},
    {"request": "GetMap", "time": "yesterday"},
    {"foo": "bar"},
]


def _wms_fields(p):
    d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    d["crs"] = p.crs.name() if p.crs is not None else None
    d["bbox"] = None if p.bbox is None else (
        p.bbox.xmin, p.bbox.ymin, p.bbox.xmax, p.bbox.ymax)
    return d


@pytest.mark.parametrize("case", range(len(QUERIES)))
def test_parse_wms_matches(case):
    q = QUERIES[case]
    jq = jparams.normalise_query(q)
    tq = tparams.normalise_query({k: [v] for k, v in q.items()})
    assert tq == jq
    assert tparams.infer_service(tq) == jparams.infer_service(jq)
    assert _wms_fields(tparams.parse_wms(tq)) == \
        _wms_fields(jparams.parse_wms(jq))


@pytest.mark.parametrize("case", range(len(BAD_QUERIES)))
def test_parse_wms_errors_match(case):
    q = BAD_QUERIES[case]
    with pytest.raises(jparams.OWSError) as je:
        jparams.parse_wms(q) if "request" in q else \
            jparams.infer_service(q)
    with pytest.raises(tparams.OWSError) as te:
        tparams.parse_wms(q) if "request" in q else \
            tparams.infer_service(q)
    assert (te.value.code, te.value.status, str(te.value)) == \
        (je.value.code, je.value.status, str(je.value))


def _plain(x):
    """A dataclass tree as plain data, without its private caches."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if not f.name.startswith("_")}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


CONFIG = """{* a comment the template pass strips *}
{
  "service_config": {"ows_hostname": "maps.example", "mas_address": "m:8888",
                     "mas_timeout": 0, "worker_nodes": []},
  "layers": [
    {"name": "a", "title": "A", "abstract": $gdoc$line one
"quoted"$gdoc$, "data_source": "/d/a", "rgb_products": ["b1", "x=b1*2"],
     "start_isodate": "2020-01-01T00:00:00.000Z",
     "end_isodate": "2020-03-01T00:00:00.000Z", "step_days": 16,
     "time_generator": "regular", "offset_value": "1.5", "clip_value": 9,
     "scale_value": 0.5, "colour_scale": 1, "zoom_limit": 80,
     "mask": {"id": "qa", "value": 4, "bit_tests": [1, "10"],
              "inclusive": true},
     "palette": {"name": "p", "interpolate": false,
                 "colours": [{"R": 1, "G": 2, "B": 3}]},
     "styles": [{"name": "s", "rgb_products": ["b2"],
                 "png_compress_level": 0}],
     "overviews": [{"name": "o", "data_source": "/d/o", "zoom_limit": 500}],
     "axes": [{"name": "depth", "default": "5", "values": ["5", "10"]}],
     "default_geo_bbox": [1, 2, 3, 4], "index_res_limit": 0.1,
     "index_tile_x_size": 0.5, "wms_max_width": 1024,
     "cache_max_age": 0, "disable_services": ["wcs"]},
    {"name": "m", "data_source": "/d/m", "time_generator": "monthly",
     "start_isodate": "2019-11-15T00:00:00.000Z",
     "end_isodate": "2020-02-15T00:00:00.000Z"},
    {"name": "c", "data_source": "/d/c", "time_generator": "chirps20",
     "start_isodate": "2020-01-01T00:00:00.000Z",
     "end_isodate": "2020-02-01T00:00:00.000Z",
     "input_layers": [{"name": "i", "data_source": "/d/i"}]}
  ],
  "processes": [{"identifier": "drill", "max_area": 100,
                 "drill_algo": "deciles", "approx": false,
                 "data_sources": [{"data_source": "/d/a"}]}]
}
"""


def test_config_tree_matches(tmp_path):
    (tmp_path / "ns").mkdir()
    for d in (tmp_path, tmp_path / "ns"):
        (d / "config.json").write_text(CONFIG)
    want = jconfig.load_config_tree(str(tmp_path))
    got = tconfig.load_config_tree(str(tmp_path))
    assert sorted(got) == sorted(want) == ["", "ns"]
    for ns in want:
        assert _plain(got[ns]) == _plain(want[ns])
    lay = got[""].layer("a")
    assert lay.rgb_expressions.expr_names == ["b1", "x"]
    assert lay.style("s").data_source == "/d/a"
    assert len(got[""].layer("c").dates) == 6
    with pytest.raises(ValueError):
        tconfig.Layer.from_json({"name": "x", "png_compress_level": 10})


def test_config_dates_from_the_index(tmp_path):
    """``time_generator: "mas"``: dates from the MAS ?timestamps op, with
    its token (an unchanged index answers an empty list and the layer
    keeps its dates)."""
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.index.store import MASStore as JMASStore
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.index.store import MASStore
    stores = (JMASStore(), MASStore())
    for i, st in enumerate(stores):
        for k, stamps in enumerate((["2020-01-10T00:00:00.000Z",
                                     "2020-01-12T00:00:00.000Z"],
                                    ["2020-01-11T00:00:00.000Z"])):
            st.ingest({"filename": f"/d/f{k}.tif", "file_type": "tif",
                       "geo_metadata": [{
                           "ds_name": f"/d/f{k}.tif", "namespace": "n",
                           "array_type": "Int16", "srs": "EPSG:4326",
                           "geo_transform": [0, 1, 0, 0, 0, -1],
                           "timestamps": stamps,
                           "polygon": "POLYGON((0 0,1 0,1 -1,0 -1,0 0))",
                           "nodata": 0}]})
    (tmp_path / "config.json").write_text(json.dumps({
        "service_config": {"mas_address": "m"},
        "layers": [{"name": "a", "data_source": "/d",
                    "time_generator": "mas",
                    "styles": [{"name": "s"}]}]}))
    jc, tc = JMASClient(stores[0]), MASClient(stores[1])
    want = jconfig.ConfigWatcher(str(tmp_path), lambda a: jc,
                                 install_signal=False).get("")
    watcher = tconfig.ConfigWatcher(str(tmp_path), lambda a: tc,
                                    install_signal=False)
    got = watcher.get("")
    assert _plain(got) == _plain(want)
    lay = got.layer("a")
    assert lay.dates == ["2020-01-10T00:00:00.000Z",
                         "2020-01-11T00:00:00.000Z",
                         "2020-01-12T00:00:00.000Z"]
    assert lay.styles[0].dates == lay.dates
    assert lay.effective_end_date == "2020-01-12T00:00:00.000Z"
    assert tc.timestamps("/d", token=lay.timestamp_token) == \
        jc.timestamps("/d", token=lay.timestamp_token) == \
        {"timestamps": [], "token": lay.timestamp_token}
    tconfig.get_layer_dates(lay, tc)
    assert len(lay.dates) == 3                   # the cache is kept
    watcher.reload()
    assert watcher.get("").layer("a").dates == lay.dates


def test_ingest_file(tmp_path):
    """`-local_mas`'s loader reads JSON lines and TSV crawl files, as
    the reference's does."""
    from gsky_tpu.index.api import ingest_file as jingest
    from gsky_tpu.index.store import MASStore as JMASStore
    from gsky_tpu_torch.index.api import ingest_file
    from gsky_tpu_torch.index.store import MASStore
    rec = {"file_type": "tif", "geo_metadata": [{
        "ds_name": "x", "namespace": "n", "array_type": "Int16",
        "srs": "EPSG:4326", "geo_transform": [0, 1, 0, 0, 0, -1],
        "timestamps": ["2020-01-10T00:00:00.000Z"],
        "polygon": "POLYGON((0 0,1 0,1 -1,0 -1,0 0))", "nodata": 0}]}
    lines = tmp_path / "crawl.tsv"
    lines.write_text(
        "/d/a.tif\tgdal\t" + json.dumps(rec) + "\n\n"
        + json.dumps(dict(rec, filename="/d/b.tif")) + "\n")
    for loader, store in ((jingest, JMASStore()), (ingest_file, MASStore())):
        assert loader(store, str(lines)) == 2
        got = store.intersects("/d", metadata="gdal")["gdal"]
        assert sorted(g["file_path"] for g in got) == ["/d/a.tif",
                                                       "/d/b.tif"]
