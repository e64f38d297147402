"""Port parity, the ``GSKY_SPMD=1`` routes of the real pipeline: archive
-> MAS -> scene cache -> the mesh's `SpmdRenderer`, and the drill's
sharded reductions, the counterpart of `tests/test_spmd_pipeline.py`.

The JAX reference runs over the conftest's 8 virtual CPU devices (its
sharded programs, Pallas in interpret mode); the port over 8 CPU
members (``GSKY_CPU_DEVICES=8``, B2's and B3's plain versions) or one.
Bounds: the port's sharded tile equal to its own single-device tile
(``GSKY_SPMD=0``) bit for bit where the single-device leg is B2 too,
and within 1e-3 of pixels of the JAX sharded tile (the reference's own
bound between its sharded and single-device programs); drills within
rtol 1e-5 with counts exact; with one member the single-device path
serves, as the reference's does on a one-device host; a WPS drill under
``GSKY_SPMD=1`` answers 200 with the reference's CSV."""

import os

import numpy as np
import pytest
import torch

from gsky_tpu.pipeline import drill_cache as jDC
from gsky_tpu.mesh import dispatch as JMD

from gsky_tpu_torch.mesh import dispatch as TMD
from gsky_tpu_torch.ops import stats as tstats
from gsky_tpu_torch.ops import warp_render as trender
from gsky_tpu_torch.parallel import spmd as tspmd

import test_torch_drill as td
import test_torch_pipeline as tp
from test_torch_wcs import both, wenv  # noqa: F401  (the module fixture)
from test_torch_wps import POLY, _kvp, _rows, _same_csv

MEMBERS = 8


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("GSKY_CPU_DEVICES", str(MEMBERS))
    for var in ("GSKY_SPMD", "GSKY_MESH", "GSKY_MESH_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    JMD.reset_mesh()
    TMD.reset_mesh()
    yield
    JMD.reset_mesh()
    TMD.reset_mesh()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spmd_archive"))
    paths = tp._archive(root)
    jstore, tstore = tp._stores(paths)
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


@pytest.fixture
def b2_calls(monkeypatch):
    """Counts B2's wrapper calls on the mesh's bodies."""
    calls = []
    real = trender.warp_render_scored

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tspmd, "warp_render_scored", spy)
    return calls


@pytest.mark.parametrize("method,hw", [("near", (96, 80)),
                                       ("bilinear", (64, 97)),
                                       ("cubic", (96, 80))])
def test_composite_matches_single_device_and_reference(archive, b2_calls,
                                                       method, hw):
    box = tp._bbox3857()
    jtile, ttile, pipe, _ = tp._render_both(archive, method, box, hw,
                                            env={"GSKY_SPMD": "1"})
    routes = pipe.executor.route_counts
    assert sum(n for k, n in routes.items()
               if k.startswith("render_byte_spmd:")) == 1, routes
    assert len(b2_calls) == MEMBERS
    assert ttile.shape == hw and (ttile != 255).any()
    assert np.mean(ttile != jtile) <= 1e-3
    # the port's single-device B2 leg over the same scenes
    _, one, _, _ = tp._render_both(archive, method, box, hw,
                                   env={"GSKY_SPMD": "0",
                                        "GSKY_PAGE_SLOTS": "1"})
    np.testing.assert_array_equal(ttile, one)


def test_process_path_mosaic(archive, b2_calls, monkeypatch):
    """The modular path (`process`) through the sharded scored mosaic:
    the canvases equal the single-device B2 leg's."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.pipeline.tile import TilePipeline
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    monkeypatch.setenv("GSKY_WAVES", "0")
    req = GeoTileRequest(collection=archive["root"], bands=[tp.NS],
                         bbox=BBox(*tp._bbox3857()),
                         crs=parse_crs("EPSG:3857"), width=80, height=96,
                         resample="bilinear")
    monkeypatch.setenv("GSKY_SPMD", "1")
    pipe = TilePipeline(MASClient(archive["tstore"]), device="cpu")
    res_s = pipe.process(req)
    assert len(b2_calls) == MEMBERS
    assert any(k.startswith("scene_mosaic_spmd:")
               for k in pipe.executor.route_counts)
    monkeypatch.setenv("GSKY_SPMD", "0")
    monkeypatch.setenv("GSKY_PAGE_SLOTS", "1")
    res_1 = TilePipeline(MASClient(archive["tstore"]),
                         device="cpu").process(req)
    for ns in res_1.namespaces:
        assert torch.equal(res_s.valid[ns], res_1.valid[ns])
        assert torch.equal(res_s.data[ns], res_1.data[ns])


def test_expr_route_declines_under_spmd(archive, monkeypatch):
    from gsky_tpu_torch.pipeline.executor import WarpExecutor
    monkeypatch.setenv("GSKY_SPMD", "1")
    ex = WarpExecutor(device="cpu")
    # one scene group: the GSKY_SPMD routes have no expression epilogue,
    # so the fused expression tile declines before its pages stage
    monkeypatch.setattr(ex, "_scene_groups", lambda *a: [object()])
    assert ex.render_expr_byte([], [], [], None, None, 8, 8, 1, None) \
        is None
    assert ex.paged_engaged == ex.paged_declined == 0


# ---------------------------------------------------------------------------
# the drill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drill_archive(tmp_path_factory):
    from gsky_tpu.index.crawler import extract as jextract
    from gsky_tpu.index.store import MASStore as JMASStore
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    root = str(tmp_path_factory.mktemp("spmd_drill"))
    paths = td._write_archive(root)
    jstore, tstore = JMASStore(), MASStore()
    for p in paths:
        jstore.ingest(jextract(p, approx_stats=True))
        tstore.ingest(extract(p, approx_stats=True))
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


@pytest.mark.parametrize("members", [1, MEMBERS])
@pytest.mark.parametrize("case", ["two_files_two_vars", "clip",
                                  "pixel_count", "int16_clip"])
def test_drill_means_match(drill_archive, monkeypatch, members, case):
    """Resident-stack drills through the sharded reductions: the JAX
    reference's sharded psum on 8 devices, the port's B3 on each of 8
    members (or, with one member, its single-device path): counts
    exact, means within rtol 1e-5."""
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_WAVES", "0")
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")
    monkeypatch.setenv("GSKY_CPU_DEVICES", str(members))
    calls = []
    real = tstats.masked_stats_plain
    monkeypatch.setattr(tstats, "masked_stats_plain",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    try:
        jp, tpipe = td._pipelines(drill_archive)
        jreq, treq = td._requests(drill_archive, **td.CASES[case])
        monkeypatch.setenv("GSKY_SPMD", "1")
        jres, tres = jp.process(jreq), tpipe.process(treq)
    finally:
        jDC.default_drill_cache.clear()
    assert jres.dates
    td._assert_same(jres, tres)
    if members > 1:
        assert TMD.active_mesh() is not None
        # B3 once a member a reduction, on (bands / 2, pixels / 4)
        assert calls and len(calls) % MEMBERS == 0
    else:
        assert TMD.active_mesh() is None


def test_spmd_drill_with_deciles_stays_single_device(drill_archive,
                                                     monkeypatch):
    monkeypatch.setenv("GSKY_WAVES", "0")
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")
    monkeypatch.setenv("GSKY_SPMD", "1")
    try:
        jp, tpipe = td._pipelines(drill_archive)
        jreq, treq = td._requests(drill_archive, **td.CASES["deciles"])
        td._assert_same(jp.process(jreq), tpipe.process(treq))
    finally:
        jDC.default_drill_cache.clear()
    # deciles need a global sort: no reduction ran over the mesh
    assert TMD.active_mesh().mesh.member_stats() == [0] * MEMBERS


@pytest.mark.parametrize("members", [1, MEMBERS])
def test_wps_drill_under_spmd_answers_200(wenv, monkeypatch,  # noqa: F811
                                          members):
    """A WPS drill with GSKY_SPMD=1 gets the reference's answer, with
    one member (its single-device path) as with eight."""
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")
    monkeypatch.setenv("GSKY_CPU_DEVICES", str(members))
    monkeypatch.setenv("GSKY_SPMD", "1")
    try:
        blocks = _same_csv(*both(wenv, _kvp("fc_drill", POLY)))
    finally:
        jDC.default_drill_cache.clear()
    assert len(_rows(blocks[0])) == 3


def test_spmd_disabled_by_default():
    assert os.environ.get("GSKY_SPMD", "0") != "1"
    assert tspmd.default_spmd("cpu") is None
    assert not tspmd.spmd_enabled("cpu")
