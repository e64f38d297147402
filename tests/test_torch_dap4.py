"""Port parity, DAP4: the port's `server/dap4.py` (constraint parser,
`dap_to_wcs`, `encode_dap4`, `CoverageSpool` and `stream_dap4`) and
its ``dap4.ce`` endpoint against the JAX package's.

Pure functions are compared field by field on the same inputs (arrays
seeded with numpy); the endpoint through both servers of
`test_torch_wcs` (fixture ``wenv``), the port's streamed body
re-assembled from its chunks.  Bounds: bodies equal byte for byte
(nearest resampling), errors with the same status and exception code.
"""

import dataclasses
import os
import struct
import urllib.request
from urllib.parse import quote

import numpy as np
import pytest

from gsky_tpu.server import dap4 as jdap4
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher

from gsky_tpu_torch.server import dap4
from gsky_tpu_torch.server.config import ConfigWatcher
from gsky_tpu_torch.server.params import OWSError

from test_torch_wcs import TIMEOUT, _code, _wcs_fields, both, port_get, \
    wenv  # noqa: F401  (the module fixture)

CES = [
    "dataset{var1}",
    "ds{a;b;t[0:2]}",
    "ds{t[]}",
    "ds{t[5]}",
    "ds{t[1:2:9]}",
    "ds{t[1][2:3]}",
    "ds{t[:4]}",
    "ds{v} | 1 < x < 10, y >= -35",
    "ds{v} | 10 > x > 1",
    "ds{v} | x = 3",
    "ds{v} | x <= 3.5, time >= 2020-01-10T00:00:00.000Z",
    "ds{v} | 2020-01-10T00:00:00.000Z <= time <= 2020-02-10T00:00:00.000Z",
    "  ds { v ; w }  ",
    # errors
    "noselector", "{v}", "ds{v", "ds{v;v}", "ds{1bad}", "ds{t[-1]}",
    "ds{t[1:2:3:4]}", "ds{v} | x", "ds{v} | 1 < x > 2", "ds{v} | 5 < x < 1",
    "ds{v}|a|b", "ds{t[a]}", "ds{v} | x >= noon", "ds{v} | < 3",
    "ds{v} | 1 < 2bad < 3", "ds{t[1}", "ds{[1]}",
]


def _parsed(mod, ce):
    try:
        return ("ok", dataclasses.asdict(mod.parse_constraint_expr(ce)))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("i", range(len(CES)))
def test_constraint_parser(i):
    assert _parsed(dap4, CES[i]) == _parsed(jdap4, CES[i])


BRIDGE = [
    "cov{B4}",
    "cov{B4} | 148.1 < x < 148.2, -35.25 < y < -35.15",
    "cov{B4} | x = 148.1, y <= -35.2",
    "cov{B4} | 140 < x < 150",
    "cov{B4} | time >= 2020-01-10T00:00:00.000Z",
    "cov{B4} | 2020-01-10T00:00:00.000Z < time < 2020-01-12T00:00:00.000Z",
    "cov{B4;level[0:1:2]}",
    "cov{B4;level[]; depth[3]}",
    "cov{B4} | 1 < level < 2",
    "dap_nc{phot_veg}",
    "dap_nc{level[1]}",
    "cov{x[1:2]}",
    "cov{x}",
    "cov{B4} | 1 < x < 2, 3 < y < 4",
    "nope{v}",
    "dap_off{phot_veg}",
]


@pytest.mark.parametrize("i", range(len(BRIDGE)))
def test_dap_to_wcs(wenv, i):
    jcfg = JConfigWatcher(wenv["conf"], install_signal=False).get("")
    tcfg = ConfigWatcher(wenv["conf"], install_signal=False).get("")
    ce = BRIDGE[i]

    def run(mod, cfg):
        try:
            return ("ok", _wcs_fields(mod.dap_to_wcs(
                mod.parse_constraint_expr(ce), cfg)))
        except Exception as e:          # each package's OWSError
            return ("error", type(e).__name__, str(e),
                    getattr(e, "code", ""))

    assert run(dap4, tcfg) == run(jdap4, jcfg)


def _arrays(names, h, w, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for n in names:
        a = rng.normal(0, 1000, (h, w)).astype(np.float32)
        a[rng.random((h, w)) < 0.1] = -9999.0
        out[n] = a
    return out


ENCODE_CASES = [
    (["va", "vb"], 7, 9),
    (["v#t=100", "v#t=200", "w#t=100"], 33, 17),
    (["2bad name", "x_y"], 3, 5),
    (["v#level=1,time=2020-01-10T00:00:00.000Z"], 4, 4),
    (["v"], 1, dap4.MAX_CHUNK // 4 + 10),
    (["a", "b"], 700, 3000),
]


@pytest.mark.parametrize("i", range(len(ENCODE_CASES)))
def test_encode_dap4(i):
    names, h, w = ENCODE_CASES[i]
    arrays = _arrays(names, h, w, i)
    assert dap4.encode_dap4(names, arrays) == \
        jdap4.encode_dap4(names, arrays)


@pytest.mark.parametrize("i", range(len(ENCODE_CASES)))
@pytest.mark.parametrize("row_batch", [None, 1, 5])
def test_stream_equals_encode(tmp_path, i, row_batch):
    """The spool written region by region in any order, replayed as a
    stream, gives `encode_dap4`'s body byte for byte."""
    names, h, w = ENCODE_CASES[i]
    arrays = _arrays(names, h, w, i)
    spool = dap4.CoverageSpool(str(tmp_path / "s.raw"), len(names), h, w)
    block = np.stack([arrays[n] for n in names])
    th, tw = max(1, h // 2), max(1, w // 3)
    regions = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
    for x, y in reversed(regions):
        spool.write_region(x, y, block[:, y:y + th, x:x + tw])
    stats = {}
    body = b"".join(dap4.stream_dap4(names, spool, stats, row_batch))
    spool.close()
    assert body == dap4.encode_dap4(names, arrays)
    assert stats["bytes"] > 0
    assert stats["peak_buffer"] < dap4.MAX_CHUNK + 4 * w * (row_batch or
                                                            (1 << 20))
    assert not os.path.exists(tmp_path / "s.raw")


def _chunks(body):
    out, off = [], 0
    while off < len(body):
        flags = body[off]
        (n,) = struct.unpack(">I", b"\x00" + body[off + 1:off + 4])
        out.append((flags, body[off + 4:off + 4 + n]))
        off += 4 + n
        if flags & dap4.LAST_CHUNK:
            break
    return out, off


def _dap(ce):
    return "/ows?dap4.ce=" + quote(ce)


def _no_spool(wenv):
    return not [f for f in os.listdir(f"{wenv['root']}/tmp_port")
                if f.startswith("dap_")]


def test_streamed_dap4_body(wenv, monkeypatch):
    """A multi-tile coverage (2 x 3 tiles) streams from the export spool
    in both packages; the port's chunks re-assembled are the reference's
    body, and the in-RAM leg (GSKY_DAP_STREAM=0) gives the same bytes."""
    from gsky_tpu_torch.server import ows
    from gsky_tpu_torch.server.ows import OWSServer
    seen = []
    real = OWSServer.handle

    def spy(self, *a, **k):
        r = real(self, *a, **k)
        seen.append(r.chunks is not None)
        return r

    monkeypatch.setattr(OWSServer, "handle", spy)
    url = _dap("dap_nc{phot_veg} | time >= 2020-01-11T00:00:00.000Z")
    ref, got = both(wenv, url)
    assert got == ref, (got[:2], ref[:2], got[2][:300])
    assert ref[:2] == (200, dap4.CONTENT_TYPE)
    assert seen == [True]
    chunks, used = _chunks(got[2])
    assert used == len(got[2])
    data = np.frombuffer(chunks[1][1], "<f4").reshape(100, 130)
    ok = data != -9999.0
    assert ok.mean() > 0.5 and 0 <= data[ok].mean() <= 100
    assert wenv["port"].last_export["tiles"] == 6
    monkeypatch.setenv("GSKY_DAP_STREAM", "0")
    inram = port_get(wenv, url)
    assert seen[-1] is False and inram == got
    assert _no_spool(wenv)
    assert ows.dap4 is dap4


@pytest.mark.parametrize("ce", [
    "cov{B4} | 148.1 < x < 148.14, -35.22 < y < -35.19, "
    "time >= 2020-01-10T00:00:00.000Z",
    "cov{B4} | 148.12 < x < 148.13, -35.22 < y < -35.21, "
    "time >= 2020-01-10T00:00:00.000Z",
    # no time: the layer's newest date is the NetCDF stack's, which has
    # no B4: no data
    "cov{B4} | 148.1 < x < 148.11, -35.22 < y < -35.21",
    "dap_nc{phot_veg;bare_soil} | 148 < x < 148.5, -35.5 < y < -35, "
    "time = 2020-01-12T00:00:00.000Z",
])
def test_dap4_matches_reference(wenv, ce):
    """Auto-sized coverages (no default_geo_size) and default-sized
    ones, one band or two."""
    ref, got = both(wenv, _dap(ce))
    assert got[:2] == ref[:2], got[2][:300]
    if "time" not in ce:
        assert got[0] == 400 and _code(got[2]) == _code(ref[2])
        return
    assert got[:2] == (200, dap4.CONTENT_TYPE)
    assert got[2] == ref[2]
    chunks, used = _chunks(got[2])
    assert used == len(got[2]) and chunks[-1][0] & dap4.LAST_CHUNK


@pytest.mark.parametrize("ce", ["garbage", "nope{v}", "dap_off{phot_veg}",
                                "cov{x}", "cov{B4} | 1 < x > 2",
                                "cov{B4;B4}"])
def test_dap4_errors(wenv, ce):
    ref, got = both(wenv, _dap(ce))
    assert got[:2] == ref[:2], (got, ref)
    assert _code(got[2]) == _code(ref[2])


def test_dap4_over_a_socket(wenv):
    """The streamed body over HTTP: Transfer-Encoding chunked, the body
    urllib re-assembles equal to the handler's."""
    httpd = wenv["port"].serve("127.0.0.1", 0)
    try:
        url = _dap("dap_nc{phot_veg} | time >= 2020-01-11T00:00:00.000Z")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_address[1]}{url}",
                timeout=TIMEOUT) as r:
            assert r.headers["Transfer-Encoding"] == "chunked"
            assert r.headers["Content-Type"] == dap4.CONTENT_TYPE
            body = r.read()
        assert body == port_get(wenv, url)[2]
        assert _no_spool(wenv)
    finally:
        httpd.shutdown()
        httpd.server_close()
