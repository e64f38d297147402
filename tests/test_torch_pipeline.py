"""Port parity, pipeline tier: the page pool, the host modules and the
single-band GetMap slice as a whole, against the JAX package.

The archive is written once with the JAX package's `write_geotiff`;
each package ingests it with its own crawler and MAS store, and the
same request goes through the JAX `TilePipeline` (Pallas kernels in
interpret mode, waves off) and the port's (``device="cpu"``: the plain
PyTorch versions of the kernels).  Nearest gives identical bytes;
bilinear and cubic may differ in at most 0.1% of pixels, the bound the
reference applies between its own programs for a floor() flipped by a
fused multiply-add."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsky_tpu.geo.crs import parse_crs as jparse_crs
from gsky_tpu.geo.transform import BBox as JBBox
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.geo.transform import transform_bbox as jtransform_bbox
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.geotiff import write_geotiff as jwrite_geotiff
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
from gsky_tpu.pipeline.types import GeoTileRequest as JRequest

from gsky_tpu_torch.carry import scene_from_numpy
from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import BBox
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.geotiff import GeoTIFF, write_geotiff
from gsky_tpu_torch.pipeline.executor import WarpExecutor
from gsky_tpu_torch.pipeline.pages import PagePool
from gsky_tpu_torch.pipeline.tile import TilePipeline
from gsky_tpu_torch.pipeline.types import GeoTileRequest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "LC08_B4"


def _archive(root, scenes=3, size=700):
    """Overlapping UTM-55S int16 granules (30 m, nodata -999 corner,
    dates 2020-01-10..) written by the JAX package."""
    utm = jparse_crs("EPSG:32755")
    rng = np.random.default_rng(99)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    paths = []
    for i in range(scenes):
        gt = JGT(590000.0 + i * 3000.0, 30.0, 0.0,
                 6105000.0 - i * 2000.0, 0.0, -30.0)
        field = 3000 + 1500 * np.sin(xx / (40 + 7 * i)) \
            * np.cos(yy / (55 - 5 * i))
        data = (field + rng.normal(0, 150, field.shape)).astype(np.int16)
        data[(xx + yy) < size // 4] = -999
        p = os.path.join(root, f"LC08_202001{10 + i:02d}_T1.tif")
        jwrite_geotiff(p, data, gt, utm, nodata=-999)
        paths.append(p)
    return paths


def _stores(paths):
    jstore, tstore = JMASStore(), MASStore()
    for p in paths:
        for ex, st in ((jextract, jstore), (extract, tstore)):
            rec = ex(p)
            assert not rec.get("error"), rec
            for ds in rec["geo_metadata"]:
                ds["namespace"] = NS     # one product namespace
            st.ingest(rec)
    return jstore, tstore


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_archive"))
    paths = _archive(root)
    jstore, tstore = _stores(paths)
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


def _bbox3857(dx=0.0, dy=0.0, size=9000.0):
    utm = jparse_crs("EPSG:32755")
    merc = jparse_crs("EPSG:3857")
    c = jtransform_bbox(JBBox(610000.0, 6093000.0, 610001.0, 6093001.0),
                        utm, merc)
    x0, y0 = c.xmin + dx, c.ymin + dy
    return (x0, y0, x0 + size, y0 + size)


def _zoomed_bbox3857(zoom, cx=612000.0, cy=6092500.0, px=256):
    """A ``px``-pixel EPSG:3857 tile centred on the UTM point (cx, cy) at
    ``zoom`` times the archive's 30 m ground resolution; by default over
    the scenes' east edge, so that it holds nodata."""
    utm = jparse_crs("EPSG:32755")
    merc = jparse_crs("EPSG:3857")
    c = jtransform_bbox(JBBox(cx, cy, cx + 1.0, cy + 1.0), utm, merc)
    lat = np.degrees(np.arctan(np.sinh(c.ymin / 6378137.0)))
    half = px * 30.0 * zoom / np.cos(np.radians(lat)) / 2
    return (c.xmin - half, c.ymin - half, c.xmin + half, c.ymin + half)


def _utm_bbox3857(x0, y0, x1, y1):
    b = jtransform_bbox(JBBox(x0, y0, x1, y1), jparse_crs("EPSG:32755"),
                        jparse_crs("EPSG:3857"))
    return (b.xmin, b.ymin, b.xmax, b.ymax)


def _render_both(archive, method, box, hw=(96, 80), env=None):
    env = env or {}
    saved = {k: os.environ.get(k) for k in
             ("GSKY_PALLAS", "GSKY_WAVES", "GSKY_RENDER_BATCH") +
             tuple(env)}
    os.environ.update({"GSKY_PALLAS": "interpret", "GSKY_WAVES": "0",
                       "GSKY_RENDER_BATCH": "0", **env})
    jpages.reset_default_pool()
    jex = JWarpExecutor()
    try:
        jreq = JRequest(collection=archive["root"], bands=[NS],
                        bbox=JBBox(*box), crs=jparse_crs("EPSG:3857"),
                        width=hw[1], height=hw[0], resample=method)
        jtile = np.asarray(JTilePipeline(
            JMASClient(archive["jstore"]), executor=jex)
            .render_composite_byte(jreq))
        treq = GeoTileRequest(collection=archive["root"], bands=[NS],
                              bbox=BBox(*box), crs=parse_crs("EPSG:3857"),
                              width=hw[1], height=hw[0], resample=method)
        pipe = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        ttile = pipe.render_composite_byte(treq)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jpages.reset_default_pool()
    return jtile, ttile.numpy(), pipe, jex


def _assert_match(method, jtile, ttile):
    assert ttile.dtype == np.uint8 and ttile.shape == jtile.shape
    assert (ttile != 255).any() and (ttile == 255).any()
    diff = np.count_nonzero(jtile != ttile)
    if method == "near":
        assert diff == 0
    else:
        assert diff <= jtile.size // 1000, f"{diff} pixels differ"


class TestSlice:
    @pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
    def test_paged_leg_matches_jax_pipeline(self, archive, method):
        jtile, ttile, pipe, _ = _render_both(archive, method, _bbox3857())
        _assert_match(method, jtile, ttile)
        assert pipe.executor.paged_engaged == 1
        assert pipe.executor.paged_declined == 0

    @pytest.mark.parametrize("method,zoom", [
        pytest.param(m, z, id=m if z == 1 else f"{m}-zoom{z}")
        for z in (1, 2, 4) for m in ("near", "bilinear", "cubic")])
    def test_bucketed_leg_matches_jax_pipeline(self, archive, method, zoom):
        # zoom 1: one page slot per granule.  Zoom 2 and 4: a 256-px tile
        # at 2x and 4x the native ground resolution needs windows of more
        # than the default 8 pages.  Both packages decline the paged leg
        # and render through the bucketed kernel
        if zoom == 1:
            jtile, ttile, pipe, jex = _render_both(
                archive, method, _bbox3857(), env={"GSKY_PAGE_SLOTS": "1"})
        else:
            jtile, ttile, pipe, jex = _render_both(
                archive, method, _zoomed_bbox3857(zoom), hw=(256, 256))
        _assert_match(method, jtile, ttile)
        assert pipe.executor.paged_declined == 1
        assert (jex.paged_engaged, jex.paged_declined) == (0, 1)
        assert pipe.executor.paged_gated == 0

    @pytest.mark.parametrize("slots", [None, "1"])
    def test_stage_spans_cover_both_legs(self, archive, slots):
        env = {"GSKY_PAGE_SLOTS": slots} if slots else {}
        _, _, pipe, _ = _render_both(archive, "near", _bbox3857(), env=env)
        spans = pipe.executor.spans
        assert set(spans) == {"index", "groups", "tables", "dispatch"}
        assert all(v > 0 for v in spans.values()), spans

    def test_fixed_scale_and_second_tile(self, archive):
        box = _bbox3857(dx=4000.0, dy=-3000.0)
        jtile, ttile, _, _ = _render_both(archive, "near", box)
        _assert_match("near", jtile, ttile)

    def test_index_and_granules_match(self, archive):
        box = _bbox3857()
        jreq = JRequest(collection=archive["root"], bands=[NS],
                        bbox=JBBox(*box), crs=jparse_crs("EPSG:3857"))
        treq = GeoTileRequest(collection=archive["root"], bands=[NS],
                              bbox=BBox(*box), crs=parse_crs("EPSG:3857"))
        jg = JTilePipeline(JMASClient(archive["jstore"])).index(jreq)
        tg = TilePipeline(MASClient(archive["tstore"]),
                          device="cpu").index(treq)
        assert [(g.path, g.namespace, g.timestamp, g.nodata,
                 tuple(g.geo_transform)) for g in jg] == \
            [(g.path, g.namespace, g.timestamp, g.nodata,
              tuple(g.geo_transform)) for g in tg]
        assert len(tg) == 3


@pytest.fixture(scope="module")
def big_archive(tmp_path_factory):
    """Two 1300-px granules: bucket 1536, a grid of 12 x 3 pages of
    128 x 512, so that one window can need more than 16 pages."""
    root = str(tmp_path_factory.mktemp("torch_big_archive"))
    paths = _archive(root, scenes=2, size=1300)
    jstore, tstore = _stores(paths)
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


# (UTM box, pages the larger granule's window needs): scene 0 rows
# 300-500 x columns 100-400; rows 100-1200 x columns 100-1200
GATE_WINDOWS = {
    "3pages": ((593000.0, 6090000.0, 602000.0, 6096000.0), 3),
    "30pages": ((593000.0, 6069000.0, 626000.0, 6102000.0), 30),
}


class TestPagedGate:
    """The reference declines the paged leg when its page list fails the
    VMEM gate (S * 128 * 512 * 4 * 2 bytes of pages, double-buffered,
    plus accumulators, over 10 MiB: S = 32 always).  The port routes
    every tile to the same leg as the reference."""

    @pytest.mark.parametrize("window", sorted(GATE_WINDOWS))
    @pytest.mark.parametrize("slots", ["1", "8", "16", "32"])
    def test_port_takes_the_reference_leg(self, big_archive, slots,
                                          window):
        box, pages = GATE_WINDOWS[window]
        jtile, ttile, pipe, jex = _render_both(
            big_archive, "near", _utm_bbox3857(*box), hw=(32, 32),
            env={"GSKY_PAGE_SLOTS": slots})
        ex = pipe.executor
        assert (ex.paged_engaged, ex.paged_declined) == \
            (jex.paged_engaged, jex.paged_declined)
        np.testing.assert_array_equal(jtile, ttile)
        capped = pages > int(slots)
        gated = not capped and pages > 16
        assert ex.paged_declined == int(capped or gated)
        assert ex.paged_gated == int(gated)

    def test_gate_constants(self):
        from gsky_tpu.ops import paged as jpaged
        from gsky_tpu_torch.ops import paged as tpaged
        for slots in (1, 2, 4, 8, 16, 32, 64):
            for n_ns in (1, 2, 4, 8):
                for pr, pc in ((128, 512), (64, 128), (256, 1024)):
                    assert tpaged.paged_vmem_ok(slots, n_ns, pr, pc) == \
                        jpaged.paged_vmem_ok(slots, n_ns, pr, pc)


class TestGeoTIFF:
    @pytest.mark.parametrize("compress", [True, False])
    def test_round_trip_with_overviews(self, tmp_path, compress):
        data = np.random.default_rng(3).integers(
            -500, 5000, (300, 517)).astype(np.int16)
        utm = parse_crs("EPSG:32755")
        from gsky_tpu_torch.geo.transform import GeoTransform
        p = str(tmp_path / "x.tif")
        write_geotiff(p, data, GeoTransform(5e5, 30, 0, 6e6, 0, -30), utm,
                      nodata=-999, compress=compress, overviews=(2, 4))
        with GeoTIFF(p) as g:
            np.testing.assert_array_equal(g.read(1), data)
            np.testing.assert_array_equal(
                g.read(1, (10, 20, 100, 50)), data[20:70, 10:110])
            assert [f for f, _ in g.overviews] == [2, 4]
            np.testing.assert_array_equal(
                g.read(1, ifd=g.overviews[0][1]), data[1::2, 1::2])
            assert g.nodata == -999 and g.crs == utm

    def test_reads_reference_files(self, archive):
        import gsky_tpu.io.geotiff as jg
        for p in archive["paths"]:
            with GeoTIFF(p) as t, jg.GeoTIFF(p) as j:
                np.testing.assert_array_equal(t.read(1), j.read(1))
                assert t.gt.to_gdal() == j.gt.to_gdal()
                assert t.crs.to_wkt() == j.crs.to_wkt()

    @pytest.mark.parametrize("codec", ["lzw", "packbits"])
    def test_stripped_lzw_and_packbits(self, codec):
        from gsky_tpu_torch.io import geotiff as tg
        raw = bytes(range(40)) * 3
        if codec == "packbits":
            enc = bytes([119]) + raw     # one literal run of 120 bytes
            assert tg._packbits_decode(enc, len(raw)) == raw
        else:
            # CLEAR, the literal codes, EOI — 9-bit MSB-first codes
            codes = [256] + list(raw[:200]) + [257]
            bits = "".join(format(c, "09b") for c in codes)
            bits += "0" * (-len(bits) % 8)
            enc = int(bits, 2).to_bytes(len(bits) // 8, "big")
            out = tg._lzw_decode(enc, len(raw))
            assert out[:len(raw)] == raw[:len(out)]


class TestPagePool:
    def _scene(self, serial=7, size=300):
        rng = np.random.default_rng(serial)
        return rng.uniform(0, 1, (size, size)).astype(np.float32)

    def test_tables_identical_to_jax_pool(self):
        scene = self._scene()
        jp = jpages.PagePool(capacity=16, page_rows=64, page_cols=128)
        tp = PagePool(capacity=16, page_rows=64, page_cols=128,
                      device="cpu")
        for i0, i1, j0, j1 in ((0, 1, 0, 1), (1, 3, 1, 2), (4, 4, 0, 2)):
            tj = jp.table_for(jnp.asarray(scene), 7, i0, i1, j0, j1)
            tt = tp.table_for(torch.from_numpy(scene), 7, i0, i1, j0, j1)
            np.testing.assert_array_equal(tj, tt)
        np.testing.assert_array_equal(np.asarray(jp._pool),
                                      tp._pool.numpy())
        assert list(jp._slots.items()) == list(tp._slots.items())

    def test_lru_pins_and_decline(self):
        scene = torch.from_numpy(self._scene())
        tp = PagePool(capacity=4, page_rows=64, page_cols=128,
                      device="cpu")
        a = tp.table_for(scene, 1, 0, 0, 0, 2)      # 3 pages, pinned
        assert tp.table_for(scene, 1, 1, 1, 0, 0) is None   # all pinned
        assert tp.stats()["declined"] == 1 and tp.stats()["pinned"] == 3
        tp.unpin(a)
        b = tp.table_for(scene, 1, 1, 1, 0, 0)      # evicts LRU (0, 0)
        assert b is not None and tp.evictions == 1
        assert (1, 0, 0) not in tp._slots and (1, 0, 1) in tp._slots
        again = tp.table_for(scene, 1, 0, 0, 1, 1)  # hit, no stage
        assert tp.hits == 1 and int(again[0]) == int(a[1])
        page = tp._pool[int(b[0])]
        np.testing.assert_array_equal(page.numpy(),
                                      scene[64:128, 0:128].numpy())

    def test_null_page_and_edge_padding(self):
        scene = torch.from_numpy(self._scene(size=100))
        tp = PagePool(capacity=4, page_rows=64, page_cols=128,
                      device="cpu")
        t = tp.table_for(scene, 2, 1, 1, 0, 0)
        page = tp._pool[int(t[0])].numpy()
        np.testing.assert_array_equal(page[:36, :100],
                                      scene[64:100].numpy())
        assert np.isnan(page[36:]).all() and np.isnan(page[:, 100:]).all()
        assert torch.isnan(tp._pool[0]).all()


def test_scene_from_numpy_feeds_the_executor_the_reference_scene():
    from gsky_tpu_torch.geo.transform import GeoTransform
    arr = np.full((256, 256), np.nan, np.float32)
    arr[:200, :210] = 5.0
    s = scene_from_numpy(arr, 200, 210, GeoTransform(0, 30, 0, 0, 0, -30),
                         parse_crs("EPSG:32755"), serial=99, device="cpu")
    assert s.bucket == (256, 256) and s.serial == 99
    assert torch.equal(torch.isnan(s.dev), torch.from_numpy(np.isnan(arr)))


def test_port_imports_no_jax_and_no_reference_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gsky_tpu_torch\n"
        "for m in pkgutil.walk_packages(gsky_tpu_torch.__path__,"
        " 'gsky_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'gsky_tpu' or"
        " k.startswith('gsky_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    store = MASStore()
    with pytest.raises(RuntimeError, match="CUDA"):
        TilePipeline(MASClient(store))
    with pytest.raises(RuntimeError, match="CUDA"):
        WarpExecutor()
    with pytest.raises(RuntimeError, match="CUDA"):
        PagePool(capacity=4)


def _default_device_calls():
    """The port's public functions below the entry points, each called
    with no device: a granule window decode, a decode of several, the
    expression evaluation over an empty environment, and a constant-only
    masked expression (no tensor to take a device from)."""
    from gsky_tpu_torch.ops.expr import compile_expr, \
        parse_band_expressions
    from gsky_tpu_torch.pipeline import decode
    from gsky_tpu_torch.pipeline.tile import evaluate_expressions
    from gsky_tpu_torch.pipeline.types import Granule
    g = Granule("/nonexistent.tif", "ds", "b", "b", 1, None, 0.0,
                "EPSG:32755", [0.0, 30.0, 0.0, 0.0, 0.0, -30.0], -999.0)
    box, crs = BBox(0.0, -300.0, 300.0, 0.0), parse_crs("EPSG:32755")
    return {
        "decode_window": lambda: decode.decode_window(g, box, crs),
        "decode_all": lambda: decode.decode_all([g], box, crs),
        "evaluate_expressions": lambda: evaluate_expressions(
            parse_band_expressions(["b"]), {}, {}, 4, 4),
        "eval_masked": lambda: compile_expr("1 + 2").eval_masked({}, {}),
    }


@pytest.mark.parametrize("name", ["decode_window", "decode_all",
                                  "evaluate_expressions", "eval_masked"])
def test_functions_below_the_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call = _default_device_calls()[name]
    # no fallback: the missing card raises, it is not absorbed as a
    # failed granule or answered on the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
