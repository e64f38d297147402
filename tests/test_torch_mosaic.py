"""Port parity, the masked temporal-mosaic GetMap slice: the modular
`TilePipeline.process` route and the modules under it, against the JAX
package on the same seeded inputs.

The JAX reference runs with GSKY_PALLAS=interpret and a hermetic kernel
ledger; `mosaic_first_valid_pallas` is wrapped by a spy that counts its
calls and runs it in interpret mode (the reference's dispatch calls it
without ``interpret``, which only a TPU backend takes), so the JAX run
really reaches kernel B4.  The port runs with ``device="cpu"``: the
plain versions of the kernels.

Bounds: nearest warps, masks, mosaics and arithmetic expressions are
bit-exact; bilinear and cubic warps within 2 ulp (the port fuses the
multiply-adds XLA's CPU lowering of `warp_gather_batch` contracts, so
they agree to the bit on these inputs); transcendental calls within the
ulps stated at `_ULP`; byte tiles identical for nearest and within 0.1%
of bytes for the interpolated methods and NDVI."""

import dataclasses
import datetime as dt
import os

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
from gsky_tpu.io.netcdf import write_netcdf3 as jwrite_netcdf3
from gsky_tpu.ops import expr as jexpr
from gsky_tpu.ops import mosaic as jmosaic
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.ops.scale import scale_to_byte as jscale_to_byte
from gsky_tpu.pipeline import decode as jdecode
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
from gsky_tpu.pipeline.types import AxisSelector as JAxisSelector
from gsky_tpu.pipeline.types import GeoTileRequest as JRequest
from gsky_tpu.pipeline.types import MaskSpec as JMaskSpec

from gsky_tpu_torch.carry import decoded_window_from_numpy
from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import BBox, GeoTransform
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.ops import expr as texpr
from gsky_tpu_torch.ops import first_valid as tfv
from gsky_tpu_torch.ops import mosaic as tmosaic
from gsky_tpu_torch.ops.scale import scale_to_byte
from gsky_tpu_torch.pipeline import decode as tdecode
from gsky_tpu_torch.pipeline.executor import MODULAR_SPANS, WarpExecutor
from gsky_tpu_torch.pipeline.tile import TilePipeline
from gsky_tpu_torch.pipeline.types import AxisSelector, GeoTileRequest
from gsky_tpu_torch.pipeline.types import MaskSpec
from gsky_tpu_torch.resilience import TooManyFailures, degrade

UTM = "EPSG:32755"
MERC = "EPSG:3857"
SIZE = 300
# (file tag, date): the first two acquisitions share a timestamp
DATES = [("a", "20200110"), ("b", "20200110"), ("c", "20200126"),
         ("d", "20200211")]
CLEAR, CLOUD, SHADOW, QA_FILL = 322, 352, 328, 1
CLOUD_SHADOW = ["100000", "100000", "1000", "1000"]


def _ts(d):
    return dt.datetime.strptime(d, "%Y%m%d").replace(
        tzinfo=dt.timezone.utc).timestamp()


T0, T1 = _ts("20200101"), _ts("20200301")


@pytest.fixture
def jax_b4(monkeypatch, tmp_path):
    """The JAX reference's B4 in interpret mode, spied: the list of
    stack shapes it was called with."""
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("GSKY_WAVES", "0")
    monkeypatch.setenv("GSKY_RENDER_BATCH", "0")
    monkeypatch.setattr(jpt, "_FAILED", set())
    calls = []
    orig = jpt.mosaic_first_valid_pallas

    def spy(stack, valid, interpret=False):
        calls.append(tuple(stack.shape))
        return orig(stack, valid, interpret=True)

    monkeypatch.setattr(jpt, "mosaic_first_valid_pallas", spy)
    jpages.reset_default_pool()
    yield calls
    jpages.reset_default_pool()


# ---------------------------------------------------------------------------
# the archive: 4 acquisitions of B4, B5 (int16) and pixel_qa (uint16)
# ---------------------------------------------------------------------------

def _blobs(rng, n, shape, r_lo=10, r_hi=35):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    m = np.zeros(shape, bool)
    for _ in range(n):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(r_lo, r_hi) ** 2
    return m


def _write_archive(root):
    """Per acquisition three single-band GeoTIFFs (JAX writer): bands
    under ``root/bands``, pixel_qa under ``root/qa``.  Each date is
    shifted; B4/B5 have a -999 collar, pixel_qa a fill (1) collar and
    cloud / shadow blobs."""
    utm = jparse_crs(UTM)
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    paths = []
    for i, (tag, date) in enumerate(DATES):
        gt = JGT(590000.0 + 600.0 * i, 30.0, 0.0,
                 6105000.0 - 450.0 * i, 0.0, -30.0)
        collar = (xx + yy) < 50 + 10 * i
        b4 = 800 + 600 * np.sin(xx / (23 + 3 * i)) * np.cos(yy / 31) \
            + rng.normal(0, 40, (SIZE, SIZE))
        b5 = 2600 + 900 * np.cos(xx / 41) * np.sin(yy / (19 + 2 * i)) \
            + rng.normal(0, 60, (SIZE, SIZE))
        qa = np.full((SIZE, SIZE), CLEAR, np.uint16)
        qa[_blobs(rng, 6, (SIZE, SIZE))] = CLOUD
        qa[_blobs(rng, 4, (SIZE, SIZE), 8, 20)] = SHADOW
        qa[collar] = QA_FILL
        bands = {"LC08_B4": b4.astype(np.int16), "LC08_B5": b5.astype(np.int16)}
        for ns, arr in bands.items():
            arr[collar] = -999
            p = os.path.join(root, "bands", f"{ns}_{date}_{tag}.tif")
            jwrite_geotiff(p, arr, gt, utm, nodata=-999)
            paths.append((p, ns))
        p = os.path.join(root, "qa", f"pixel_qa_{date}_{tag}.tif")
        jwrite_geotiff(p, qa, gt, utm, nodata=QA_FILL)
        paths.append((p, "pixel_qa"))
    return paths


def _stores(paths, axes=None):
    jstore, tstore = JMASStore(), MASStore()
    for p, ns in paths:
        for ex, st in ((jextract, jstore), (extract, tstore)):
            rec = ex(p)
            assert not rec.get("error"), rec
            for ds in rec["geo_metadata"]:
                ds["namespace"] = ns
                if axes and ns == "LC08_B4":
                    ds["axes"] = axes
            st.ingest(rec)
    return jstore, tstore


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mosaic_archive"))
    os.makedirs(os.path.join(root, "bands"))
    os.makedirs(os.path.join(root, "qa"))
    paths = _write_archive(root)
    jstore, tstore = _stores(paths)
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


def _box(dx=0.0, dy=0.0, size=7000.0):
    """An EPSG:3857 box over the acquisitions' overlap, cutting the
    collars."""
    c = jtransform_bbox(JBBox(592000.0, 6097000.0, 592001.0, 6097001.0),
                        jparse_crs(UTM), jparse_crs(MERC))
    x0, y0 = c.xmin + dx, c.ymin + dy
    return (x0, y0, x0 + size, y0 + size)


def _requests(root, bands, method, mask, box=None, hw=(96, 80),
              collection=None, axes=()):
    box = box or _box()
    coll = collection or root
    jmask = tmask = None
    if mask is not None:
        jmask = JMaskSpec(**dataclasses.asdict(mask))
        tmask = mask
    jreq = JRequest(collection=coll, bands=list(bands), bbox=JBBox(*box),
                    crs=jparse_crs(MERC), width=hw[1], height=hw[0],
                    start_time=T0, end_time=T1, mask=jmask, resample=method,
                    axes=[JAxisSelector(**dataclasses.asdict(a))
                          for a in axes])
    treq = GeoTileRequest(collection=coll, bands=list(bands),
                          bbox=BBox(*box), crs=parse_crs(MERC),
                          width=hw[1], height=hw[0], start_time=T0,
                          end_time=T1, mask=tmask, resample=method,
                          axes=list(axes))
    return jreq, treq


def _process_both(jstore, tstore, jreq, treq):
    jres = JTilePipeline(JMASClient(jstore),
                         executor=JWarpExecutor()).process(jreq)
    pipe = TilePipeline(MASClient(tstore), device="cpu")
    return jres, pipe.process(treq), pipe


def _close(got, want, nulp):
    """Bit-exact at ``nulp`` 0 (signed zeros and NaN payloads included),
    else NaN in the same places and the rest within ``nulp``."""
    if nulp == 0:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_almost_equal_nulp(got[~nan], want[~nan],
                                              nulp=nulp)


def _same_result(jres, tres, nulp=0):
    """TileResult equality: namespaces, valid exact, data within
    ``nulp`` (bit-exact at 0, signed zeros included)."""
    assert tres.namespaces == jres.namespaces
    assert (tres.granule_count, tres.file_count) == \
        (jres.granule_count, jres.file_count)
    for ns in jres.namespaces:
        jv = np.asarray(jres.valid[ns])
        tv = tres.valid[ns].numpy()
        np.testing.assert_array_equal(tv, jv)
        jd = np.asarray(jres.data[ns], np.float32)
        td = tres.data[ns].numpy()
        assert td.dtype == np.float32 and td.shape == jd.shape
        _close(td, jd, nulp)


def _same_bytes(method, jres, tres, ns, **kw):
    jb = np.asarray(jscale_to_byte(jnp.asarray(jres.data[ns]),
                                   jnp.asarray(jres.valid[ns]), **kw))
    tb = scale_to_byte(tres.data[ns], tres.valid[ns], **kw).numpy()
    diff = np.count_nonzero(jb != tb)
    if method == "near":
        assert diff == 0
    else:
        assert diff <= jb.size // 1000, f"{diff} bytes differ"
    assert (tb != 255).any()
    return tb


MASKS = {
    "value": MaskSpec(id="pixel_qa", value="101000"),
    "bit_tests": MaskSpec(id="pixel_qa", bit_tests=list(CLOUD_SHADOW)),
    "inclusive": MaskSpec(id="pixel_qa", value="101000", inclusive=True),
}


class TestProcess:
    @pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
    @pytest.mark.parametrize("mask", sorted(MASKS))
    def test_single_band_matches_jax(self, archive, jax_b4, method, mask):
        jreq, treq = _requests(archive["root"], ["LC08_B4"], method,
                               MASKS[mask])
        jres, tres, pipe = _process_both(archive["jstore"],
                                         archive["tstore"], jreq, treq)
        # four acquisitions of LC08_B4 in one mosaic: B4 at T = 4
        assert jax_b4 == [(4, 96, 80)]
        _same_result(jres, tres, nulp=0 if method == "near" else 2)
        _same_bytes(method, jres, tres, "LC08_B4", auto=True)
        assert set(MODULAR_SPANS) <= set(pipe.executor.spans)
        assert all(pipe.executor.spans[k] > 0 for k in MODULAR_SPANS)

    def test_ndvi_expression_bilinear(self, archive, jax_b4):
        jreq, treq = _requests(
            archive["root"], ["ndvi=(LC08_B5-LC08_B4)/(LC08_B5+LC08_B4)"],
            "bilinear", MaskSpec(id="pixel_qa", bit_tests=CLOUD_SHADOW))
        jres, tres, _ = _process_both(archive["jstore"], archive["tstore"],
                                      jreq, treq)
        assert jax_b4 == [(4, 96, 80), (4, 96, 80)]
        assert tres.namespaces == ["ndvi"]
        _same_result(jres, tres, nulp=2)
        _same_bytes("bilinear", jres, tres, "ndvi", auto=True)

    def test_mask_in_a_separate_collection(self, archive, jax_b4):
        mask = MaskSpec(id="pixel_qa", value="101000",
                        data_source=os.path.join(archive["root"], "qa"))
        jreq, treq = _requests(archive["root"], ["LC08_B4"], "near", mask,
                               collection=os.path.join(archive["root"],
                                                       "bands"))
        jp = JTilePipeline(JMASClient(archive["jstore"]))
        tp = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        jg, tg = jp.index(jreq), tp.index(treq)
        assert [(g.path, g.namespace, g.timestamp) for g in tg] == \
            [(g.path, g.namespace, g.timestamp) for g in jg]
        assert {g.base_namespace for g in tg} == {"LC08_B4", "pixel_qa"}
        jres, tres, _ = _process_both(archive["jstore"], archive["tstore"],
                                      jreq, treq)
        _same_result(jres, tres)
        # the same mask from the data collection gives the same tile
        jreq2, treq2 = _requests(archive["root"], ["LC08_B4"], "near",
                                 MaskSpec(id="pixel_qa", value="101000"))
        same = TilePipeline(MASClient(archive["tstore"]),
                            device="cpu").process(treq2)
        assert torch.equal(same.valid["LC08_B4"], tres.valid["LC08_B4"])

    def test_mask_excludes_and_equal_timestamps_or_together(self, archive):
        _, treq = _requests(archive["root"], ["LC08_B4"], "near", None)
        pipe = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        open_ = pipe.process(dataclasses.replace(
            treq, mask=MaskSpec(id="pixel_qa", value="0")))
        masked = pipe.process(dataclasses.replace(treq,
                                                  mask=MASKS["value"]))
        ov, mv = open_.valid["LC08_B4"], masked.valid["LC08_B4"]
        assert bool((ov & ~mv).any()) and not bool((mv & ~ov).any())
        # the two acquisitions sharing a timestamp: the later-arriving
        # one wins where both are valid
        g = pipe.index(treq)
        stamps = [x.timestamp for x in g if x.namespace == "LC08_B4"]
        assert stamps.count(_ts("20200110")) == 2
        order = tmosaic.priority_order(stamps)
        assert order[:2] == [3, 2] and stamps[0] == stamps[1]

    def test_axis_suffixed_namespaces_pass_through(self, archive, jax_b4):
        axes = [{"name": "level", "params": [1.0, 2.0], "strides": [0],
                 "shape": [2]}]
        jstore, tstore = _stores(archive["paths"], axes=axes)
        jreq, treq = _requests(
            archive["root"], ["LC08_B4"], "near", MASKS["bit_tests"],
            axes=[AxisSelector(name="level", in_values=[1.0, 2.0])])
        jres, tres, _ = _process_both(jstore, tstore, jreq, treq)
        assert tres.namespaces == ["LC08_B4", "LC08_B4#level=1",
                                   "LC08_B4#level=2"]
        assert not bool(tres.valid["LC08_B4"].any())   # ambiguous
        _same_result(jres, tres)

    def test_no_granules_and_missing_band(self, archive, jax_b4):
        far = (0.0, 0.0, 5000.0, 5000.0)
        jreq, treq = _requests(archive["root"], ["LC08_B4", "nope"], "near",
                               MASKS["value"], box=far)
        jres, tres, _ = _process_both(archive["jstore"], archive["tstore"],
                                      jreq, treq)
        _same_result(jres, tres)
        jreq, treq = _requests(archive["root"], ["LC08_B4", "nope"], "near",
                               MASKS["value"])
        jres, tres, _ = _process_both(archive["jstore"], archive["tstore"],
                                      jreq, treq)
        _same_result(jres, tres)
        assert not bool(tres.valid["nope"].any())


class TestNoOpMask:
    """``value="0"`` excludes nothing: it only sends the request down
    the modular route (tests/test_pipeline.py::dataclasses_replace_mask)."""

    @pytest.mark.parametrize("method", ["near", "bilinear"])
    def test_matches_jax_modular(self, archive, jax_b4, method):
        noop = MaskSpec(id="pixel_qa", value="0")
        jreq, treq = _requests(archive["root"], ["LC08_B4"], method, noop)
        jres, tres, _ = _process_both(archive["jstore"], archive["tstore"],
                                      jreq, treq)
        _same_result(jres, tres, nulp=0 if method == "near" else 2)

    def test_against_the_fused_route(self, archive):
        # the fused route projects through a control-point grid, the
        # modular one every pixel: nodata in the same places, < 2% of
        # the other values differ (the reference's own bound between
        # its two routes, tests/test_pipeline.py TestMultiCRSMosaic)
        _, treq = _requests(archive["root"], ["LC08_B4"], "near", None,
                            hw=(128, 128))
        pipe = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        # a host array from its wave (waves on), a tensor per call
        fused = np.asarray(pipe.render_composite_byte(
            treq, scale=0.1, clip=2540.0, auto=False))
        res = pipe.process(dataclasses.replace(
            treq, mask=MaskSpec(id="pixel_qa", value="0")))
        mod = scale_to_byte(res.data["LC08_B4"], res.valid["LC08_B4"],
                            scale=0.1, clip=2540.0).numpy()
        np.testing.assert_array_equal(mod == 255, fused == 255)
        ok = mod != 255
        assert ok.any()
        assert np.mean(mod[ok] != fused[ok]) < 0.02


class TestMosaicStack:
    def _inputs(self, T, seed, hw=(40, 50)):
        rng = np.random.default_rng(seed)
        rasters = [(rng.normal(size=hw) * 100).astype(np.float32)
                   for _ in range(T)]
        valids = [rng.uniform(size=hw) < 0.02 + 0.5 / T for _ in range(T)]
        stamps = [float(rng.integers(0, 4)) for _ in range(T)]
        return rasters, valids, stamps

    def _both(self, rasters, valids, stamps, **kw):
        jo, jok = jmosaic.mosaic_stack(rasters, valids, stamps, **kw)
        tkw = {k: ([torch.from_numpy(x) for x in v]
                   if k == "exclude_masks" else v) for k, v in kw.items()}
        to, tok = tmosaic.mosaic_stack(
            [torch.from_numpy(r) for r in rasters],
            [torch.from_numpy(v) for v in valids], stamps, **tkw)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(to.numpy().view(np.int32),
                                      np.asarray(jo).view(np.int32))
        return to, tok

    @pytest.mark.parametrize("T", [1, 3, 8, 100])
    def test_b4_leg(self, jax_b4, monkeypatch, T):
        calls = []
        plain = tfv.mosaic_first_valid_plain
        monkeypatch.setattr(tfv, "mosaic_first_valid_plain",
                            lambda *a: calls.append(a[0].shape) or plain(*a))
        rasters, valids, stamps = self._inputs(T, T)
        rng = np.random.default_rng(T + 1)
        excl = [rng.uniform(size=(40, 50)) < 0.3 for _ in range(T)]
        out, ok = self._both(rasters, valids, stamps, exclude_masks=excl)
        tp = 1 << (T - 1).bit_length()
        assert jax_b4 == [(tp, 40, 50)] and calls == [(T, 40, 50)]
        assert (out.numpy()[~ok.numpy()] == 0).all()

    def test_argmax_leg_past_128_layers(self, jax_b4, monkeypatch):
        calls = []
        monkeypatch.setattr(tfv, "mosaic_first_valid_plain",
                            lambda *a: calls.append(1))
        rasters, valids, stamps = self._inputs(129, 5, hw=(12, 16))
        out, ok = self._both(rasters, valids, stamps)
        assert jax_b4 == [] and calls == []
        # the argmax form fills with the top layer's value, not 0.0
        assert (~ok.numpy()).any() and (out.numpy()[~ok.numpy()] != 0).any()

    @pytest.mark.parametrize("T", [1, 3, 6])
    def test_weighted_leg(self, jax_b4, T):
        rasters, valids, stamps = self._inputs(T, 40 + T)
        w = list(np.random.default_rng(T).uniform(0.2, 2.0, T))
        self._both(rasters, valids, stamps, weights=w)
        assert jax_b4 == []

    def test_host_form(self):
        rasters, valids, stamps = self._inputs(3, 9)
        o, ok = tmosaic.mosaic_stack_host(
            [torch.from_numpy(r) for r in rasters],
            [torch.from_numpy(v) for v in valids], stamps)
        assert isinstance(o, np.ndarray) and ok.dtype == bool


class TestBitMask:
    CASES = [("100000", ()), ("10000000", ()), ("1" * 16, ()),
             ("1" * 40, ()), ("0", ()),
             ("", ("100000", "100000", "1000", "1000")),
             ("", ("10000000", "10000000")),
             ("", ("1" * 20, "1" * 20)),
             ("", ("11", "1", "1" * 33, "0"))]

    @pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint8,
                                       np.uint16, np.int32, np.uint32])
    @pytest.mark.parametrize("case", range(9))
    def test_matches_jax(self, dtype, case):
        value, tests = self.CASES[case]
        info = np.iinfo(dtype)
        rng = np.random.default_rng(case)
        data = rng.integers(int(info.min), int(info.max), (32, 33),
                            dtype=np.int64, endpoint=True).astype(dtype)
        data.flat[:4] = [info.min, info.max, 0, CLOUD % (int(info.max) + 1)]
        want = np.asarray(jmosaic.compute_bit_mask(jnp.asarray(data),
                                                   value or None, tests))
        wide = torch.from_numpy(data.astype(np.int64))
        got = tmosaic.compute_bit_mask(wide, value or None, tests, dtype)
        np.testing.assert_array_equal(got.numpy(), want)
        if dtype not in (np.uint16, np.uint32):
            native = tmosaic.compute_bit_mask(torch.from_numpy(data),
                                              value or None, tests)
            np.testing.assert_array_equal(native.numpy(), want)

    def test_int8_high_bit_keeps_negatives(self):
        data = torch.tensor([-128, -1, 127, 64], dtype=torch.int8)
        got = tmosaic.compute_bit_mask(data, "10000000")
        assert got.tolist() == [False, False, False, False]

    def test_rejects_float_and_unpaired_tests(self):
        with pytest.raises(ValueError):
            tmosaic.compute_bit_mask(torch.zeros(3), "1")
        with pytest.raises(ValueError):
            tmosaic.compute_bit_mask(torch.zeros(3, dtype=torch.int16),
                                     None, ["1"])

    def test_restore_int_saturates_like_xla(self):
        from gsky_tpu.pipeline.tile import _restore_int as jrestore
        from gsky_tpu_torch.pipeline.tile import _restore_int
        x = np.array([np.nan, np.inf, -np.inf, 3e9, -5.7, 70000.5, 322.0,
                      65535.9, -129.0], np.float32)
        for at in ("Byte", "SignedByte", "Int16", "UInt16", "Int32",
                   "UInt32", "Float32"):
            want = np.asarray(jrestore(jnp.asarray(x), at))
            got, storage = _restore_int(torch.from_numpy(x), at)
            assert storage == want.dtype
            np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                          want.astype(np.int64))


# ---------------------------------------------------------------------------
# decode and warp
# ---------------------------------------------------------------------------

def _granule_pair(path, gt, srs, nodata, **kw):
    from gsky_tpu.pipeline.types import Granule as JGranule
    from gsky_tpu_torch.pipeline.types import Granule
    args = dict(path=path, ds_name=path, namespace="x", base_namespace="x",
                band=1, time_index=None, timestamp=0.0, srs=srs,
                geo_transform=list(gt), nodata=nodata, **kw)
    return JGranule(**args), Granule(**args)


def _same_window(jw, tw, device="cpu"):
    assert (jw is None) == (tw is None)
    if jw is None:
        return
    np.testing.assert_array_equal(tw.data.numpy(), jw.data)
    np.testing.assert_array_equal(tw.valid.numpy(), jw.valid)
    assert tw.window_gt.to_gdal() == jw.window_gt.to_gdal()
    assert tw.src_crs.to_wkt() == jw.src_crs.to_wkt()
    assert tw.data.device.type == device


class TestDecode:
    def test_geotiff_overviews_at_two_zooms(self, tmp_path):
        utm = jparse_crs(UTM)
        rng = np.random.default_rng(4)
        data = rng.integers(-500, 4000, (900, 1000)).astype(np.int16)
        data[:40] = -999
        gt = (590000.0, 30.0, 0.0, 6105000.0, 0.0, -30.0)
        p = str(tmp_path / "ov.tif")
        jwrite_geotiff(p, data, JGT(*gt), utm, nodata=-999,
                       overviews=(2, 4))
        jg, tg = _granule_pair(p, gt, UTM, -999.0, array_type="Int16")
        for size, hw in ((3000.0, (100, 100)), (12000.0, (128, 128)),
                         (24000.0, (96, 120)), (60000.0, (64, 64))):
            c = jtransform_bbox(JBBox(592000.0, 6090000.0, 592000.0 + size,
                                      6090000.0 + size), utm,
                                jparse_crs(MERC))
            for method in ("near", "cubic"):
                jw = jdecode.decode_window(jg, c, jparse_crs(MERC), method,
                                           hw)
                tw = tdecode.decode_window(
                    tg, BBox(c.xmin, c.ymin, c.xmax, c.ymax),
                    parse_crs(MERC), method, hw, device="cpu")
                _same_window(jw, tw)
        # zoomed out far enough to read from an overview: a window whose
        # pixels are 2 or 4 source pixels wide
        assert abs(tw.window_gt.dx) in (60.0, 120.0)

    def test_netcdf_strided_read(self, tmp_path):
        rng = np.random.default_rng(6)
        T, H, W = 3, 240, 260
        x = 140.0 + 0.01 * (np.arange(W) + 0.5)
        y = -30.0 - 0.01 * (np.arange(H) + 0.5)
        arr = rng.normal(size=(T, H, W)).astype(np.float32)
        arr[:, :20] = -9999.0
        arr[1, 50:60, 50:60] = np.nan
        p = str(tmp_path / "stack_20200101.nc")
        times = 1577836800.0 + 86400.0 * np.arange(T)
        jwrite_netcdf3(p, {"v": arr}, x, y, times=times, nodata=-9999.0)
        rec = jextract(p)
        md = [d for d in rec["geo_metadata"] if d["namespace"] == "v"][0]
        gt = md["geotransform"]
        jg, tg = _granule_pair(p, gt, "EPSG:4326", -9999.0,
                               is_netcdf=True, var_name="v",
                               array_type="Float32")
        jg.time_index = tg.time_index = 1
        e = jparse_crs("EPSG:4326")
        for box, hw in (((140.3, -31.5, 141.2, -30.2), (256, 256)),
                        ((140.3, -31.5, 141.2, -30.2), (40, 30)),
                        ((140.0, -32.4, 142.6, -30.0), (20, 20))):
            jw = jdecode.decode_window(jg, JBBox(*box), e, "bilinear", hw)
            tw = tdecode.decode_window(tg, BBox(*box),
                                       parse_crs("EPSG:4326"), "bilinear",
                                       hw, device="cpu")
            _same_window(jw, tw)
        assert abs(tw.window_gt.dx) > 0.02          # strided

    def test_decode_all_and_partial_failure(self, archive, monkeypatch):
        _, treq = _requests(archive["root"], ["LC08_B4"], "near", None)
        tp = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        gs = tp.index(treq)
        jreq, _ = _requests(archive["root"], ["LC08_B4"], "near", None)
        jgs = JTilePipeline(JMASClient(archive["jstore"])).index(jreq)
        tws = tdecode.decode_all(gs, treq.bbox, treq.crs, "near",
                                 dst_hw=(96, 80), device="cpu")
        jws = jdecode.decode_all(jgs, jreq.bbox, jreq.crs, "near",
                                 dst_hw=(96, 80))
        for jw, tw in zip(jws, tws):
            _same_window(jw, tw)
        # one granule of twelve fails: degraded, not failed; all fail:
        # TooManyFailures
        bad = dataclasses.replace(gs[0], path="/nonexistent.tif")
        errs = []
        out = tdecode.decode_all([bad] + gs[1:], treq.bbox, treq.crs,
                                 errors=errs, device="cpu")
        assert out[0] is None and len(errs) == 1
        before = degrade.degraded["decode"]
        res = tp.render(dataclasses.replace(
            treq, mask=MaskSpec(id="pixel_qa", value="0")),
            [bad] + tp.index(treq)[1:])
        assert bool(res.valid["LC08_B4"].any())
        assert degrade.degraded["decode"] == before + 1
        with pytest.raises(TooManyFailures):
            tp.render(dataclasses.replace(
                treq, mask=MaskSpec(id="pixel_qa", value="0")),
                [dataclasses.replace(g, path="/nonexistent.tif")
                 for g in gs])

    @pytest.mark.parametrize("kind", ["oom", "accelerator", "cuda call",
                                      "io", "format"])
    def test_device_failures_pass_through_safe_decode(self, archive,
                                                      monkeypatch, kind):
        """A failure of the card fails the request; a granule's own read
        or format failure degrades to a missing granule."""
        _, treq = _requests(archive["root"], ["LC08_B4"], "near", None)
        gs = TilePipeline(MASClient(archive["tstore"]),
                          device="cpu").index(treq)
        acc = getattr(torch, "AcceleratorError", None)
        if kind == "accelerator" and acc is None:
            pytest.skip("this torch has no AcceleratorError")
        exc = {"oom": lambda: torch.cuda.OutOfMemoryError(
                   "CUDA out of memory. Tried to allocate 2.00 GiB"),
               "accelerator": lambda: acc(
                   "CUDA error: an illegal memory access was encountered"),
               "cuda call": lambda: RuntimeError(
                   "launch_warp_render failed: CUDA error 700"),
               "io": lambda: OSError("short read"),
               "format": lambda: ValueError("not a TIFF file")}[kind]

        def failing(*a, **k):
            raise exc()

        monkeypatch.setattr(tdecode, "decode_window", failing)
        errs = []
        if kind in ("io", "format"):
            out = tdecode.decode_all(gs, treq.bbox, treq.crs, errors=errs,
                                     device="cpu")
            assert out == [None] * len(gs) and len(errs) == len(gs)
        else:
            with pytest.raises(RuntimeError):
                tdecode.decode_all(gs, treq.bbox, treq.crs, errors=errs,
                                   device="cpu")
            assert errs == []

    def test_geoloc_granule_is_refused(self, archive):
        _, treq = _requests(archive["root"], ["LC08_B4"], "near",
                            MASKS["value"])
        tp = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        gs = tp.index(treq)
        gs[0] = dataclasses.replace(gs[0], geo_loc={"x_var": "lon"})
        with pytest.raises(NotImplementedError, match="A.8"):
            tp.render(treq, gs)
        with pytest.raises(NotImplementedError):
            tdecode.decode_window(gs[0], treq.bbox, treq.crs)


class TestWarpAll:
    """Both executors' `warp_all` fed identical windows (JAX windows
    carried into the port's with `decoded_window_from_numpy`): five
    windows over three shape buckets, one bucket padded from 3 to 4."""

    SHAPES = [(50, 60), (70, 130), (45, 58), (200, 90), (33, 33)]

    def _windows(self):
        from gsky_tpu.pipeline.decode import DecodedWindow as JDW
        rng = np.random.default_rng(12)
        utm_j, utm_t = jparse_crs(UTM), parse_crs(UTM)
        jws, tws = [], []
        for k, (h, w) in enumerate(self.SHAPES):
            data = rng.uniform(100, 3000, (h, w)).astype(np.float32)
            valid = rng.uniform(size=(h, w)) > 0.1
            if k == 0:
                data[:5] = np.nan                 # NaN under invalid taps
                valid[:5] = False
            gt = (592000.0 + 90.0 * k, 30.0 + 3 * k, 0.0,
                  6097500.0 - 70.0 * k, 0.0, -30.0 - 2 * k)
            jws.append(JDW(None, data, valid, JGT(*gt), utm_j))
            tws.append(decoded_window_from_numpy(
                data, valid, GeoTransform(*gt), utm_t, None, device="cpu"))
        return jws, tws

    @pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
    def test_matches_jax(self, method):
        jws, tws = self._windows()
        jws.insert(2, None)
        tws.insert(2, None)
        box = _box(size=5000.0)
        jgt = JGT.from_bbox(JBBox(*box), 70, 64)
        tgt = GeoTransform.from_bbox(BBox(*box), 70, 64)
        jout = JWarpExecutor().warp_all(jws, jgt, jparse_crs(MERC), 64, 70,
                                        method)
        ex = WarpExecutor(device="cpu")
        tout = ex.warp_all(tws, tgt, parse_crs(MERC), 64, 70, method)
        assert jout[2] is None and tout[2] is None
        assert sorted(ex.bucket_stats) == [(64, 64, 4), (128, 256, 1),
                                           (256, 128, 1)]
        for j, t in zip(jout, tout):
            if j is None:
                continue
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
            _close(t[0].numpy(), np.asarray(j[0]),
                   0 if method == "near" else 2)
            assert t[1].numpy().any()


# ---------------------------------------------------------------------------
# expressions over torch
# ---------------------------------------------------------------------------

# the largest ulp difference allowed per transcendental call: the port
# evaluates with PyTorch's float32 kernels, the reference with XLA's
# CPU ones; neither is correctly rounded for these (XLA's sqrt neither)
_ULP = {"sqrt": 1, "log": 2, "log10": 3, "exp": 2, "sin": 2, "cos": 2,
        "tan": 2, "pow": 8, "**": 8}

EXPRS = ["a + b", "a - 2.5", "a * b - 3", "a / b", "7 / b", "b / 3",
         "-a", "a % b", "-a % 3.5", "a ** 2", "a > b", "a >= 50",
         "a < b", "a <= 10", "a == a", "a != b", "a > 20 && b < 60",
         "a > 90 || b < 0", "!(a > 50)", "a > b ? a : b - 1",
         "a > 60 ? 1 : 0", "abs(b)", "floor(b / 3) + ceil(a)",
         "min(a, b)", "max(a, 70)", "sqrt(a)", "log(a + 1)",
         "log10(a + 1)", "exp(b / 40)", "sin(a)", "cos(b)", "tan(b / 50)",
         "pow(a, 0.7)", "(b - a) / (b + a)", "a / (b - b)"]


@pytest.mark.parametrize("src", EXPRS)
def test_expression_over_torch_matches_jax(src):
    rng = np.random.default_rng(17)
    a = rng.uniform(0, 120, (16, 20)).astype(np.float32)
    b = rng.uniform(-5, 120, (16, 20)).astype(np.float32)
    va = rng.uniform(size=a.shape) > 0.2
    vb = rng.uniform(size=a.shape) > 0.2
    want = np.asarray(jexpr.compile_expr(src)(
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}), np.float32)
    got = texpr.compile_expr(src)(
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, xp=torch)
    assert got.dtype == torch.float32
    wo, wok = jexpr.compile_expr(src).eval_masked(
        {"a": jnp.asarray(a), "b": jnp.asarray(b)},
        {"a": jnp.asarray(va), "b": jnp.asarray(vb)})
    to, tok = texpr.compile_expr(src).eval_masked(
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
        {"a": torch.from_numpy(va), "b": torch.from_numpy(vb)},
        device="cpu")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(wok))
    nulp = max((u for f, u in _ULP.items() if f in src), default=0)
    for g, w in ((got.numpy(), want),
                 (to.numpy(), np.asarray(wo, np.float32))):
        if nulp:
            np.testing.assert_array_almost_equal_nulp(g, w, nulp=nulp)
        else:
            np.testing.assert_array_equal(g, w)


def test_constant_expressions_stay_float32():
    ce = texpr.compile_expr("sqrt(4) + 1 > 2 ? 0.5 : 1")
    out, ok = ce.eval_masked({}, {}, device="cpu")
    assert out.dtype == torch.float32 and out.item() == 0.5 and ok.item()
    c = texpr.compile_expr("a > 0 ? 2 : 3")(
        {"a": torch.tensor([1.0, -1.0])}, xp=torch)
    assert c.dtype == torch.float32 and c.tolist() == [2.0, 3.0]


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def test_process_defaults_to_cuda_and_needs_a_mask_band(archive, jax_b4):
    """`process` runs on the card unless asked for the CPU.  Without a
    mask band it takes `_render_fused` (the cached scenes, one dispatch
    per source-CRS group), as the reference's does: the same valid
    pixels and the same values there."""
    _, treq = _requests(archive["root"], ["LC08_B4"], "near",
                        MASKS["value"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TilePipeline(MASClient(archive["tstore"])).process(treq)
    jreq, treq = _requests(archive["root"], ["LC08_B4"], "near", None)
    jres, tres, _ = _process_both(archive["jstore"], archive["tstore"],
                                  jreq, treq)
    assert tres.namespaces == jres.namespaces == ["LC08_B4"]
    jv = np.asarray(jres.valid["LC08_B4"])
    tv = tres.valid["LC08_B4"].numpy()
    np.testing.assert_array_equal(tv, jv)
    assert jv.any()
    np.testing.assert_array_equal(
        tres.data["LC08_B4"].numpy()[tv],
        np.asarray(jres.data["LC08_B4"], np.float32)[jv])
