"""Port parity, the multi-band (RGB) GetMap rungs: `ops.warp._resample_c`
and `render_rgba_ctrl` (the RGBA rung, plain torch ops),
`ops.warp_render.render_scenes_bands` (the planes rung through kernel
B2), and `TilePipeline.render_rgb_auto` / `render_bands_byte` over a
small Sentinel-2-shaped archive, against the JAX package.

Inputs are made from a seed with numpy; the JAX side runs on the CPU
(`render_rgba_ctrl` and `render_scenes_bands_ctrl` are XLA programs,
no Pallas), the port with ``device="cpu"``.  Bounds: resampled values
and validity bit-exact; byte tiles identical for nearest and within
0.1% of bytes for bilinear, cubic and any log10 colour scale; the rung
taken ("rgba", "planes" or none) equal to the reference's."""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsky_tpu.geo.crs import parse_crs as jparse_crs
from gsky_tpu.geo.transform import BBox as JBBox
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.geo.transform import transform_bbox as jtransform_bbox
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.geotiff import write_geotiff as jwrite_geotiff
from gsky_tpu.pipeline import scene_cache as jscene_cache
from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
from gsky_tpu.pipeline.types import GeoTileRequest as JRequest

from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import BBox
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.ops import warp as twarp
from gsky_tpu_torch.ops import warp_render as trender
from gsky_tpu_torch.pipeline.scene_cache import SceneCache
from gsky_tpu_torch.pipeline.tile import TilePipeline
from gsky_tpu_torch.pipeline.types import GeoTileRequest

# gsky_tpu.ops re-exports a function named `warp` over its submodule
jwarp = importlib.import_module("gsky_tpu.ops.warp")

METHODS = ("near", "bilinear", "cubic")
# (auto, colour_scale, (offset, scale, clip)) of the scaling cases
SCALES = [(True, 0, (0.0, 0.0, 0.0)), (False, 0, (5.0, 0.0, 3000.0)),
          (True, 1, (0.0, 0.0, 0.0)), (False, 1, (0.0, 0.0, 4.0))]


def _same_bytes(exact, a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = int(np.count_nonzero(a != b))
    assert diff == 0 if exact else diff <= a.size // 1000, diff


def _planes(seed, S=96, nodata=np.nan):
    """Three bands of one grid with invalid patches (NaN or ``nodata``)
    in different places."""
    rng = np.random.default_rng(seed)
    planes = rng.uniform(1.0, 4000.0, (3, S, S)).astype(np.float32)
    planes[0, 10:30, 10:30] = nodata
    planes[1, 20:44, 24:48] = nodata
    planes[2, 50:60, :] = nodata
    planes[:, 70:80, 66:80] = nodata        # invalid in every band
    return planes


def _ctrl(S, h=64, w=64, step=16):
    gh = (h - 1 + step - 1) // step + 1
    gw = (w - 1 + step - 1) // step + 1
    return np.stack([
        np.linspace(4.0, S - 12.0, gw, dtype=np.float32)[None, :]
        .repeat(gh, 0),
        np.linspace(4.0, S - 12.0, gh, dtype=np.float32)[:, None]
        .repeat(gw, 1)]), (h, w), step


def _coords(ctrl, param, hw, step):
    """The rows/cols `render_rgba_ctrl` resamples at, from the
    reference's upsample and affine."""
    sx = jwarp._bilerp_grid(jnp.asarray(ctrl[0]), *hw, step)
    sy = jwarp._bilerp_grid(jnp.asarray(ctrl[1]), *hw, step)
    p = jnp.asarray(param)
    cols = (p[0] + p[1] * sx + p[2] * sy) - 0.5
    rows = (p[3] + p[4] * sx + p[5] * sy) - 0.5
    rows = jnp.where((rows < -0.5) | (rows > p[6] - 0.5) | (cols < -0.5)
                     | (cols > p[7] - 0.5), jnp.nan, rows)
    return np.array(rows, np.float32), np.array(cols, np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("nodata", [np.nan, 0.0])
def test_resample_c_matches_reference(method, nodata):
    planes = _planes(1, nodata=nodata)
    ctrl, hw, step = _ctrl(96)
    param = np.array([-0.2, 1.01, 0.02, 0.3, -0.01, 0.99, 93, 96, nodata,
                      0, 0], np.float32)
    rows, cols = _coords(ctrl, param, hw, step)
    jo, jk = jax.jit(
        lambda s, r, c: jwarp._resample_c(s, jnp.float32(nodata), r, c,
                                          method))(
        jnp.asarray(np.moveaxis(planes, 0, -1)), jnp.asarray(rows),
        jnp.asarray(cols))
    to, tk = twarp._resample_c([torch.from_numpy(p) for p in planes],
                               nodata, torch.from_numpy(rows),
                               torch.from_numpy(cols), method)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert tk.numpy().any() and not tk.numpy().all()


def test_gather2d_c_one_index_for_all_channels():
    planes = [torch.arange(12.0).reshape(3, 4) * (c + 1) for c in range(3)]
    ri = torch.tensor([[0, 2]])
    ci = torch.tensor([[3, 1]])
    got = twarp._gather2d_c(planes, ri, ci)
    assert tuple(got.shape) == (1, 2, 3)
    assert got[0, 0].tolist() == [3.0, 6.0, 9.0]
    assert got[0, 1].tolist() == [9.0, 18.0, 27.0]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("auto,cs,sp", SCALES)
def test_render_rgba_ctrl_matches_reference(method, auto, cs, sp):
    planes = _planes(2)
    ctrl, hw, step = _ctrl(96)
    param = np.array([-0.2, 1.01, 0.02, 0.3, -0.01, 0.99, 93, 96, np.nan,
                      0, 0], np.float32)
    sp = np.array(sp, np.float32)
    j = np.asarray(jwarp.render_rgba_ctrl(
        jnp.asarray(np.moveaxis(planes, 0, -1)), jnp.asarray(ctrl),
        jnp.asarray(param), jnp.asarray(sp), method, hw, step, auto, cs))
    t = twarp.render_rgba_ctrl(
        [torch.from_numpy(p) for p in planes], torch.from_numpy(ctrl),
        torch.from_numpy(param), torch.from_numpy(sp), method, hw, step,
        auto, cs).numpy()
    assert t.shape == hw + (4,)
    _same_bytes(method == "near" and cs == 0, j, t)
    # alpha is 0 exactly where the three bytes are 255
    np.testing.assert_array_equal(t[..., 3] == 0,
                                  (t[..., :3] == 255).all(-1))
    assert (t[..., 3] == 0).any() and (t[..., 3] == 255).any()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("auto,cs,sp", SCALES)
def test_render_scenes_bands_matches_reference(method, auto, cs, sp):
    """Six granules over three namespaces (n_ns 4, one slot unused),
    the bands selected out of order and one twice."""
    rng = np.random.default_rng(3)
    S = 128
    stack = rng.uniform(1.0, 4000.0, (6, S, S)).astype(np.float32)
    stack[0, 10:40, 10:40] = np.nan
    stack[4, :, :20] = np.nan
    ctrl, hw, step = _ctrl(S)
    params = np.zeros((6, 11), np.float32)
    for k in range(6):
        params[k] = [0.4 * k - 0.2, 1.01, 0.02, 0.3 * k, -0.01, 0.99,
                     S - 2 * k, S, np.nan, 100.0 - k, k % 3]
    out_sel = np.array([2, 0, 1, 0], np.int32)
    sp = np.array(sp, np.float32)
    j = np.asarray(jwarp.render_scenes_bands_ctrl(
        jnp.asarray(stack), jnp.asarray(ctrl), jnp.asarray(params),
        jnp.asarray(sp), jnp.asarray(out_sel), method, 4, hw, step, auto,
        cs))
    t = trender.render_scenes_bands(
        torch.from_numpy(stack), torch.from_numpy(ctrl),
        torch.from_numpy(params), sp, out_sel, method, 4, hw, step, auto,
        cs).numpy()
    assert t.shape == (4,) + hw
    _same_bytes(method == "near" and cs == 0, j, t)
    np.testing.assert_array_equal(t[1], t[3])


# ---------------------------------------------------------------------------
# the RGB ladder over an archive
# ---------------------------------------------------------------------------

UTM55 = "EPSG:32755"
MERC = "EPSG:3857"
BANDS = ("B02", "B03", "B04")
SIZE, RES, OVERLAP = 400, 10.0, 40
# two tiles of one UTM zone overlapping by OVERLAP pixels, as adjacent
# MGRS tiles overlap
ORIGINS = ((600000.0, 6100000.0),
           (600000.0 + (SIZE - OVERLAP) * RES, 6100000.0))


def _write_archive(root):
    utm = jparse_crs(UTM55)
    rng = np.random.default_rng(41)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    out = []
    for t, (x0, y0) in enumerate(ORIGINS):
        for b, band in enumerate(BANDS):
            field = 1200 + 800 * np.sin(xx / (11 + 3 * b + t)) \
                * np.cos(yy / (17 + b))
            data = (field + rng.normal(0, 40, field.shape)) \
                .astype(np.uint16)
            data[(xx + yy) < 60 + 20 * t] = 0
            p = os.path.join(root, f"T55HFA{t}_20200110_{band}.tif")
            jwrite_geotiff(p, data, JGT(x0, RES, 0.0, y0, 0.0, -RES), utm,
                           nodata=0)
            out.append((p, band))
    return out


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rgb_archive"))
    jstore, tstore = JMASStore(), MASStore()
    for p, ns in _write_archive(root):
        for ex, st in ((jextract, jstore), (extract, tstore)):
            rec = ex(p)
            assert not rec.get("error"), rec
            for ds in rec["geo_metadata"]:
                ds["namespace"] = ns
            st.ingest(rec)
    return {"root": root, "jstore": jstore, "tstore": tstore}


def _box(x, y, size):
    c = jtransform_bbox(JBBox(x, y, x + 1.0, y + 1.0), jparse_crs(UTM55),
                        jparse_crs(MERC))
    return (c.xmin, c.ymin - size, c.xmin + size, c.ymin)


INSIDE = _box(601000.0, 6099000.0, 1500.0)      # tile 0 alone
OVERLAP_BOX = _box(603000.0, 6098500.0, 1500.0)  # both tiles


@pytest.fixture
def kernels(monkeypatch):
    """Calls of the port's B1 and B2 wrappers while the test runs."""
    from gsky_tpu_torch.ops import paged, warp_render
    calls = {"B1": 0, "B2": 0}
    for key, mod, name in (("B1", paged, "paged_render_scored"),
                           ("B2", warp_render, "warp_render_scored")):
        def counted(*a, _f=getattr(mod, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _requests(archive, bands, box, method, hw=(80, 96)):
    kw = dict(bands=list(bands), width=hw[1], height=hw[0],
              resample=method)
    return (JRequest(collection=archive["root"], bbox=JBBox(*box),
                     crs=jparse_crs(MERC), **kw),
            GeoTileRequest(collection=archive["root"], bbox=BBox(*box),
                           crs=parse_crs(MERC), **kw))


def _pipes(archive):
    return (JTilePipeline(JMASClient(archive["jstore"]),
                          executor=JWarpExecutor()),
            TilePipeline(MASClient(archive["tstore"]), device="cpu"))


def _rgb_both(archive, bands, box, method, auto=True, sp=(0.0, 0.0, 0.0),
              cs=0):
    jreq, treq = _requests(archive, bands, box, method)
    jpipe, tpipe = _pipes(archive)
    args = tuple(sp) + (cs, auto)
    j = jpipe.render_rgb_auto(jreq, *args)
    t = tpipe.render_rgb_auto(treq, *args)
    if j is None or t is None:
        assert j is None and t is None
        return None, None, tpipe
    assert t[0] == j[0]
    return (j[0], np.asarray(j[1])), (t[0], t[1].numpy()), tpipe


@pytest.mark.parametrize("method", METHODS)
def test_one_scene_takes_the_rgba_rung(archive, kernels, method):
    j, t, _ = _rgb_both(archive, ("B04", "B03", "B02"), INSIDE, method)
    assert t[0] == "rgba" and t[1].shape == (80, 96, 4)
    _same_bytes(method == "near", j[1], t[1])
    assert (t[1][..., 3] == 255).mean() > 0.5
    assert kernels == {"B1": 0, "B2": 0}        # plain torch ops only


@pytest.mark.parametrize("method", METHODS)
def test_two_scenes_take_the_planes_rung(archive, kernels, method):
    j, t, _ = _rgb_both(archive, ("B04", "B03", "B02"), OVERLAP_BOX,
                        method)
    assert t[0] == "planes" and t[1].shape == (3, 80, 96)
    _same_bytes(method == "near", j[1], t[1])
    assert kernels == {"B1": 0, "B2": 1}        # one B2 launch, n_ns 4


@pytest.mark.parametrize("auto,cs,sp", SCALES[1:])
def test_rgb_ladder_scaling(archive, auto, cs, sp):
    for box in (INSIDE, OVERLAP_BOX):
        j, t, _ = _rgb_both(archive, ("B04", "B03", "B02"), box, "near",
                            auto, sp, cs)
        _same_bytes(cs == 0, j[1], t[1])


def test_degenerate_one_namespace_style(archive, kernels):
    """``B04, B04, B04``: one namespace, so the granule set is not one
    per band; the planes rung selects namespace 0 three times."""
    j, t, _ = _rgb_both(archive, ("B04", "B04", "B04"), INSIDE, "near")
    assert t[0] == "planes"
    np.testing.assert_array_equal(j[1], t[1])
    assert (t[1][0] == t[1][1]).all() and (t[1][1] == t[1][2]).all()
    assert kernels["B2"] == 1


@pytest.mark.parametrize("bands", [("B04", "B03"),
                                   ("B04", "B03", "B02", "B04")])
def test_two_and_four_band_planes(archive, kernels, bands):
    jreq, treq = _requests(archive, bands, OVERLAP_BOX, "bilinear")
    jpipe, tpipe = _pipes(archive)
    j = np.asarray(jpipe.render_bands_byte(jreq))
    t = tpipe.render_bands_byte(treq).numpy()
    assert t.shape == (len(bands), 80, 96)
    _same_bytes(False, j, t)
    assert kernels["B2"] == 1


def test_unmatched_band_and_algebra_decline(archive):
    for bands in (("B04", "B03", "B08"), ("r=B04*1", "B03", "B02")):
        j, t, _ = _rgb_both(archive, bands, INSIDE, "near")
        assert j is None and t is None


def test_uncacheable_scenes_decline_both_rungs(archive, monkeypatch):
    """Scenes over the cache's size limit (as a full Sentinel-2 band is
    over the default 64 Mpx) decline both rungs in both packages."""
    monkeypatch.setattr(jscene_cache, "default_scene_cache",
                        jscene_cache.SceneCache(max_scene_px=1))
    for box in (INSIDE, OVERLAP_BOX):
        jreq, treq = _requests(archive, BANDS, box, "near")
        jpipe, tpipe = _pipes(archive)
        tpipe.executor.cache = SceneCache(max_scene_px=1, device="cpu")
        assert jpipe.render_rgb_auto(jreq) is None
        assert tpipe.render_rgb_auto(treq) is None
