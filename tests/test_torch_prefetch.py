"""Port parity, the prefetch planner (`gsky_tpu_torch.ingest.prefetch`)
against the reference's `gsky_tpu.ingest.prefetch`: the same key
streams (pans, zooms, jumps, scans, repeats) give the same predictions,
the same warmed keys and the same hit, miss and wasted outcomes in each
package's ingest ledger.  The planners warm through a recording
callback, stepped to idle after every observation so that the outcomes
do not depend on thread timing; pressure, budget, TTL and close() are
held alike.  End to end, both servers pan a client east along one row:
their planners score the same outcomes and the port's tiles equal the
reference's.  Both packages' planners, ledgers and pressure monitors are
reset around every test; every wait has a timeout."""

import threading
import time

import numpy as np
import pytest

from gsky_tpu import resilience as jres
from gsky_tpu.ingest import prefetch as jprefetch
from gsky_tpu.ingest import stats as jstats
from gsky_tpu.io.png import decode_png as jdecode_png

from gsky_tpu_torch import resilience as tres
from gsky_tpu_torch.ingest import prefetch as tprefetch
from gsky_tpu_torch.ingest import stats as tstats
from gsky_tpu_torch.io.png import decode_png

from test_torch_gateway import garch, getmap, make_env  # noqa: F401
from test_torch_server import _box

PKGS = {"jax": (jprefetch, jstats, jres), "torch": (tprefetch, tstats, tres)}
TIMEOUT = 30


@pytest.fixture(autouse=True)
def _clean():
    for mod, st, res in PKGS.values():
        mod.reset_default_planner()
        st.reset()
        res.reset()
    yield
    for mod, st, res in PKGS.values():
        mod.reset_default_planner()
        st.reset()
        res.reset()


class Recorder:
    """A warm callback that records its keys, returns ``nbytes`` and
    tracks the warms in flight."""

    def __init__(self, nbytes=1 << 20, inner=None):
        self.keys = []
        self.nbytes = nbytes
        self.inner = inner
        self.busy = 0
        self.lock = threading.Lock()

    def __call__(self, layer, qb, width, height, crs, time_s):
        with self.lock:
            self.busy += 1
        try:
            self.keys.append((layer, tuple(qb), width, height, crs,
                              time_s))
            if self.inner is not None:
                return self.inner(layer, qb, width, height, crs, time_s)
            return self.nbytes
        finally:
            with self.lock:
                self.busy -= 1


def _idle(planner, rec):
    """Wait until the planner has nothing pending and no warm running."""
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        with planner._lock:
            pending = len(planner._pending)
        if not pending and rec.busy == 0:
            time.sleep(0.01)
            with planner._lock:
                if not planner._pending and rec.busy == 0:
                    return
        time.sleep(0.005)
    raise AssertionError("planner did not go idle")


def _run(stream, pkg, **rec_kw):
    mod, st, _ = PKGS[pkg]
    rec = Recorder(**rec_kw)
    pl = mod.PrefetchPlanner(warm_fn=rec)
    try:
        for key in stream:
            pl.observe(*key)
            _idle(pl, rec)
        out = pl.stats()
    finally:
        pl.close()
    return out, rec.keys, st.snapshot()["prefetch"]


W = 1000.0


def _pan(n, dx=W, dy=0.0, x0=500000.0, y0=6100000.0, layer="ns\x1fa",
         t=None):
    return [(layer, (x0 + i * dx, y0 + i * dy, x0 + i * dx + W,
                     y0 + i * dy + W), 256, 256, "EPSG:3857", t)
            for i in range(n)]


def _zoom(n, x0=500000.0, y0=6100000.0, w=64000.0):
    out = []
    cx, cy = x0 + w / 2, y0 + w / 2
    for i in range(n):
        half = w / 2 ** (i + 1)
        out.append(("ns\x1fa", (cx - half, cy - half, cx + half, cy + half),
                    256, 256, "EPSG:3857", None))
    return out


def _random(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    x, y = 500000.0, 6100000.0
    for _ in range(n):
        move = rng.integers(0, 4)
        if move == 0:
            x += W
        elif move == 1:
            y -= W
        elif move == 2:
            x += float(rng.integers(-20, 20)) * W
        out.append(("ns\x1fa", (x, y, x + W, y + W), 256, 256,
                    "EPSG:3857", None))
    return out


STREAMS = {
    "pan_east": _pan(8),
    "pan_diagonal": _pan(8, dx=W, dy=-W),
    "pan_half_steps": _pan(10, dx=W / 2),
    "zoom_in": _zoom(6),
    "two_layers": [k for pair in zip(_pan(6), _pan(6, layer="ns\x1fb"))
                   for k in pair],
    "timed": _pan(6, t=(1578614400.0, 1578700800.0)),
    "repeat": _pan(1) * 4 + _pan(5),
    "random_0": _random(30, 0),
    "random_1": _random(30, 1),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_outcomes_equal_the_reference(name):
    ref = _run(STREAMS[name], "jax")
    got = _run(STREAMS[name], "torch")
    assert got[1] == ref[1]             # the same keys warmed, in order
    assert got[2] == ref[2]             # hit, miss, wasted
    for k in ("predicted", "warmed", "warm_errors", "pending", "ready",
              "hit", "miss", "wasted", "declined_pressure",
              "declined_budget", "declined_disabled"):
        assert got[0][k] == ref[0][k], k


def test_a_pan_scores_hits():
    stats, keys, led = _run(_pan(8), "torch")
    # from the third tile on, each was predicted two observations back
    assert led["hit"] == 6 and led["miss"] == 2
    assert stats["predicted"] >= 12 and len(keys) == stats["warmed"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ttl_expiry_counts_wasted(pkg, monkeypatch):
    monkeypatch.setenv("GSKY_PREFETCH_TTL_S", "0")
    stats, _, led = _run(_pan(3) + _pan(1, x0=900000.0), pkg)
    assert led["hit"] == 0 and led["wasted"] >= 2


def test_ttl_outcomes_equal_the_reference(monkeypatch):
    monkeypatch.setenv("GSKY_PREFETCH_TTL_S", "0")
    stream = _pan(4) + _pan(2, x0=900000.0)
    assert _run(stream, "torch")[2] == _run(stream, "jax")[2]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pressure_declines(pkg):
    mod, _, res = PKGS[pkg]
    res.default_monitor().force(1)
    try:
        stats, keys, _ = _run(_pan(4), pkg)
    finally:
        res.default_monitor().force(None)
        res.default_monitor().reset()
    assert keys == [] and stats["declined_pressure"] >= 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_budget_declines(pkg, monkeypatch):
    monkeypatch.setenv("GSKY_PREFETCH_BUDGET_MB", "1")
    stats, keys, _ = _run(_pan(6), pkg, nbytes=2 << 20)
    assert len(keys) == 1 and stats["declined_budget"] >= 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_disabled_declines(pkg, monkeypatch):
    monkeypatch.setenv("GSKY_PREFETCH", "0")
    stats, keys, _ = _run(_pan(4), pkg)
    assert keys == [] and stats["declined_disabled"] >= 2
    assert stats["enabled"] is False


def test_note_scan_warms_in_order():
    rec = Recorder()
    pl = tprefetch.PrefetchPlanner(warm_fn=rec)
    try:
        boxes = [(0.0, 0.0, 1.0, 1.0), (1.0, 0.0, 2.0, 1.0),
                 (2.0, 0.0, 3.0, 1.0)]
        pl.note_scan("ns\x1fa", boxes, 64, 64, "EPSG:4326")
        _idle(pl, rec)
        assert [k[1] for k in rec.keys] == boxes
        assert pl.stats()["predicted"] == 3
    finally:
        pl.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_close_cancels_a_warm_in_flight(pkg):
    mod, _, res = PKGS[pkg]
    started, seen = threading.Event(), []

    def warm(*key):
        started.set()
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            res.check_cancel("prefetch")
            time.sleep(0.01)
        seen.append("ran to the end")
    pl = mod.PrefetchPlanner(warm_fn=warm)
    for key in _pan(2):
        pl.observe(*key)
    assert started.wait(TIMEOUT)
    t0 = time.monotonic()
    pl.close()
    assert time.monotonic() - t0 < 5.0
    assert seen == [] and not pl._worker.is_alive()
    assert res.cancel_stats()["stages"].get("prefetch") == 1


def test_default_planner_is_one_per_process():
    a = tprefetch.default_planner()
    assert tprefetch.default_planner() is a
    tprefetch.reset_default_planner()
    assert tprefetch.default_planner() is not a


# ---------------------------------------------------------------------------
# end to end: a client pans east through both servers
# ---------------------------------------------------------------------------

PAN = [_box(596000.0 + 1500.0 * i, 6100000.0, 1500.0) for i in range(8)]


def test_server_pan_outcomes_equal_the_reference(make_env, monkeypatch):
    """Eight tiles east along one row: each server's planner warms the
    predicted tiles' scenes through the server's own callback and
    scores the same outcomes; the port's tiles equal the reference's,
    one kernel-B1 call each."""
    from gsky_tpu_torch.ops import paged
    b1 = []
    f = paged.paged_render_scored
    monkeypatch.setattr(paged, "paged_render_scored",
                        lambda *a, **k: b1.append(1) or f(*a, **k))
    env = make_env()
    recs = {}
    for pkg, server in (("jax", env.jserver), ("torch", env.port)):
        pl = PKGS[pkg][0].default_planner()
        recs[pkg] = Recorder(inner=server._prefetch_warm)
        pl.warm_fn = recs[pkg]
    urls = [getmap(box=b) for b in PAN]
    ref, got = [], []
    for u in urls:
        ref.append(env.jax1(u))
        _idle(jprefetch.default_planner(), recs["jax"])
        got.append(env.torch1(u))
        _idle(tprefetch.default_planner(), recs["torch"])
    for (js, _, jb, _), (ts, _, tb, _) in zip(ref, got):
        assert js == ts == 200
        assert np.array_equal(jdecode_png(jb), decode_png(tb))
    assert len(b1) == len(urls)
    assert tstats.snapshot()["prefetch"] == jstats.snapshot()["prefetch"]
    assert tstats.snapshot()["prefetch"]["hit"] >= 4
    assert recs["torch"].keys == recs["jax"].keys
    js_, ts_ = (jprefetch.default_planner().stats(),
                tprefetch.default_planner().stats())
    for k in ("predicted", "warmed", "warm_errors", "hit", "miss",
              "wasted"):
        assert ts_[k] == js_[k], k
    assert ts_["warm_errors"] == 0
