"""Port parity, wave serving: `gsky_tpu_torch.pipeline.waves` and the
wave branches of the executor, the drill and the staged GetMap path,
against the JAX package's wave path and against the port's per-call
path (``GSKY_WAVES=0``).

The JAX reference runs with ``GSKY_PALLAS=interpret`` and waves on, as
`tests/test_waves.py` sets it up; the port with ``device="cpu"`` (the
kernels' plain versions).  Inputs are made from a seed with numpy.
Bounds: nearest identical; byte tiles of the interpolated methods
within 0.1% of bytes, canvases within 2 ulp; drills rtol 1e-5, counts
equal; against the port's own per-call path, identical.  Every wait on
a request has a timeout, and a fixture shuts every scheduler down."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsky_tpu.pipeline import autoplan as japlan
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import waves as jwaves
from gsky_tpu.pipeline.pages import PagePool as JPagePool

from gsky_tpu_torch.carry import pool_from_reference
from gsky_tpu_torch.ops import paged as tpaged
from gsky_tpu_torch.ops import warp_render as trender
from gsky_tpu_torch.pipeline import autoplan as tplan
from gsky_tpu_torch.pipeline import waves as twaves

import test_torch_kernels as tk

PR, PC = 64, 128
TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """The reference's Pallas in interpret mode and a hermetic race
    ledger; both packages' schedulers and planner counters fresh, and
    shut down afterwards."""
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("GSKY_RENDER_BATCH", "0")
    for k in ("GSKY_WAVES", "GSKY_WAVE_PIPELINE", "GSKY_WAVE_MAX",
              "GSKY_PLAN", "GSKY_WAVE_TICK_MS"):
        monkeypatch.delenv(k, raising=False)
    jwaves.reset_waves()
    twaves.reset_waves()
    japlan.reset_plan_state()
    tplan.reset_plan_state()
    yield
    jwaves.reset_waves()
    twaves.reset_waves()


def _run_threads(fns):
    """Call each of ``fns`` in its own thread; their results, in order.
    A thread that has not returned within TIMEOUT fails the test."""
    out = [None] * len(fns)
    errs = [None] * len(fns)

    def go(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:   # noqa: BLE001 - reported below
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,), daemon=True)
          for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "a wave request never returned"
    return out, errs


def _ok(out, errs):
    for e in errs:
        if e is not None:
            raise e
    return out


# ---------------------------------------------------------------------------
# the scheduler over kernel inputs
# ---------------------------------------------------------------------------

def _tile(seed, B, S=512, shift=0.0):
    """One tile over B granules of S x S scenes, its footprint rows and
    columns 4-90 (+ shift): a window of 2 x 1 pages of 64 x 128."""
    stack, ctrl, params, h, w, step, n_ns = tk._inputs(
        seed=seed, B=B, S=S, c_lo=4.0 + shift, c_hi=84.0 + shift)
    return stack, ctrl, params, h, w, step, n_ns


def _stage_window(pool, stack, params, serial0, i1=1, j1=0):
    """Stage pages (0..i1) x (0..j1) of each granule: (T, S) tables and
    (T, 16) params (pinned)."""
    B = stack.shape[0]
    S = 1
    while S < (i1 + 1) * (j1 + 1):
        S *= 2
    tables = np.zeros((B, S), np.int32)
    p16 = np.zeros((B, 16), np.float32)
    p16[:, :11] = params
    for k in range(B):
        t = pool.table_for(jnp.asarray(stack[k]), serial0 + k, 0, i1, 0, j1)
        tables[k, :t.size] = t
        p16[k, 11:16] = [0, 0, (i1 + 1) * PR, (j1 + 1) * PC, j1 + 1]
    return tables, p16


def _wave_inputs(n, superblock=False):
    """n tiles in one JAX pool: ragged granule counts (1-3), or, with
    ``superblock``, n tiles over the same scenes and windows (one
    superblock for the planner) with their own ctrl grids."""
    jpool = JPagePool(capacity=256, page_rows=PR, page_cols=PC)
    tiles = []
    for i in range(n):
        if superblock:
            stack, ctrl, params, h, w, step, n_ns = _tile(5, 3)
            ctrl = ctrl + np.float32(2.0 * i)
            tables, p16 = _stage_window(jpool, stack, params, 100)
            serials = (100, 101, 102)
        else:
            stack, ctrl, params, h, w, step, n_ns = _tile(10 + i, 1 + i % 3)
            tables, p16 = _stage_window(jpool, stack, params, 100 * (i + 1))
            serials = (i,)
        tiles.append(dict(stack=stack, ctrl=ctrl, params=params,
                          tables=tables, p16=p16, serials=serials))
    return jpool, tiles, (h, w), step, n_ns


SP = np.array([10.0, 250.0, 0.0], np.float32)


def _jax_wave(jpool, tiles, kind, statics):
    sched = jwaves.default_waves()

    def one(t):
        xla = (jnp.asarray(t["stack"]), t["params"], None, None)
        if kind == "byte":
            return sched.render_byte(jpool, t["tables"], t["p16"],
                                     t["ctrl"], SP, statics, xla, None,
                                     serials=t["serials"])
        return sched.warp_scored(jpool, t["tables"], t["p16"], t["ctrl"],
                                 statics, xla, None, serials=t["serials"])

    out = _ok(*_run_threads([lambda t=t: one(t) for t in tiles]))
    return [np.asarray(o) if kind == "byte"
            else (np.asarray(o[0]), np.asarray(o[1])) for o in out], sched


def _port_pool(jpool):
    return pool_from_reference(np.asarray(jpool._pool), jpool._slots,
                               device="cpu")


def _port_wave(tpool, tiles, kind, statics, sched):
    def one(t):
        lane = twaves.BucketedLane(
            [torch.from_numpy(s) for s in t["stack"]], t["params"],
            torch.from_numpy(t["ctrl"]), tuple(t["stack"].shape))
        # the lane's pages pinned, as the executor hands them over
        for k in range(t["tables"].shape[0]):
            with tpool.lock:
                for s in t["tables"][k].tolist():
                    tpool._pins[s] = tpool._pins.get(s, 0) + 1
        if kind == "byte":
            return sched.render_byte(tpool, t["tables"], t["p16"],
                                     t["ctrl"], SP, statics, lane,
                                     serials=t["serials"])
        return sched.warp_scored(tpool, t["tables"], t["p16"], t["ctrl"],
                                 statics, lane, serials=t["serials"])

    return _ok(*_run_threads([lambda t=t: one(t) for t in tiles]))


def _port_per_call(tpool, t, kind, statics):
    with tpool.locked_pool() as parr:
        args = (parr, torch.from_numpy(t["tables"][None]),
                torch.from_numpy(t["p16"]),
                torch.from_numpy(t["ctrl"])[None])
        if kind == "byte":
            return tpaged.render_byte_paged(*args, torch.from_numpy(SP[None]),
                                            *statics)[0].numpy()
        c, b = tpaged.warp_scored_paged(*args, *statics)
        return c[0].numpy(), (b[0] > float("-inf")).numpy()


def _same_bytes(method, a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = int(np.count_nonzero(a != b))
    assert diff == 0 if method == "near" else diff <= a.size // 1000, diff


def _same_scored(method, a, b):
    np.testing.assert_array_equal(a[1], b[1])
    if method == "near":
        np.testing.assert_array_equal(a[0], b[0])
    else:
        np.testing.assert_array_almost_equal_nulp(a[0], b[0], nulp=2)


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("kind,method,superblock", [
    ("byte", "near", False), ("byte", "bilinear", True),
    ("scored", "cubic", False), ("scored", "near", True)])
def test_wave_matches_reference_and_per_call(monkeypatch, pipeline, kind,
                                             method, superblock):
    monkeypatch.setenv("GSKY_WAVE_PIPELINE", pipeline)
    jpool, tiles, hw, step, n_ns = _wave_inputs(4, superblock)
    statics = (method, n_ns, hw, step) + \
        ((True, 0) if kind == "byte" else ())
    tpool = _port_pool(jpool)
    ref, _ = _jax_wave(jpool, tiles, kind, statics)
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)
    try:
        got = _port_wave(tpool, tiles, kind, statics, sched)
        st = sched.stats()
    finally:
        sched.shutdown()
    assert st["requests"] == 4 and st["failed"] == 0
    assert st["occupancy"] == {4: 1}, st          # one launch for 4 tiles
    assert st["superblock_lanes"] == (4 if superblock else 0)
    assert tpool.stats()["pinned"] == 0           # unpinned after launch
    for t, r, g in zip(tiles, ref, got):
        one = _port_per_call(tpool, t, kind, statics)
        if kind == "byte":
            _same_bytes(method, r, g)
            np.testing.assert_array_equal(g, one)
        else:
            _same_scored(method, r, g)
            np.testing.assert_array_equal(g[0], one[0])
            np.testing.assert_array_equal(g[1], one[1])


def test_one_launch_per_wave(monkeypatch):
    """B1's wrapper is called once for a wave of four tiles."""
    jpool, tiles, hw, step, n_ns = _wave_inputs(4)
    tpool = _port_pool(jpool)
    calls = []
    real = tpaged.paged_render_scored
    monkeypatch.setattr(tpaged, "paged_render_scored",
                        lambda *a: calls.append(a[2].shape) or real(*a))
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)
    try:
        _port_wave(tpool, tiles, "byte", ("near", n_ns, hw, step, True, 0),
                   sched)
    finally:
        sched.shutdown()
    assert len(calls) == 1 and calls[0][0] == 4 * 3   # N * T params rows


def test_bucketed_route_runs_b2_per_lane(monkeypatch):
    """Lanes whose stacks are smaller than their padded tables take the
    planner's bucketed route: B2 once a lane, no B1, bytes as per call.
    The reference's scheduler waits its longest tick for companions, so
    that its three lanes meet in one wave on a loaded host too."""
    monkeypatch.setenv("GSKY_WAVE_TICK_MS", "100")
    jpool, tiles, hw, step, n_ns = _wave_inputs(3)
    for t in tiles:
        t["stack"] = t["stack"][:, :96, :96].copy()
        t["params"][:, 6:8] = 96.0
        t["p16"][:, 6:8] = 96.0
    tpool = _port_pool(jpool)
    b1, b2 = [], []
    r1, r2 = tpaged.paged_render_scored, trender.warp_render_scored
    monkeypatch.setattr(tpaged, "paged_render_scored",
                        lambda *a: b1.append(1) or r1(*a))
    monkeypatch.setattr(trender, "warp_render_scored",
                        lambda *a: b2.append(1) or r2(*a))
    statics = ("near", n_ns, hw, step, True, 0)
    ref, _ = _jax_wave(jpool, tiles, "byte", statics)
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)
    try:
        got = _port_wave(tpool, tiles, "byte", statics, sched)
        st = sched.stats()
    finally:
        sched.shutdown()
    assert (len(b1), len(b2)) == (0, 3) and st["bucketed_lanes"] == 3
    assert japlan.plan_stats()["routes"]["bucketed"] == 1
    for r, g in zip(ref, got):
        _same_bytes("near", r, g)


def test_failed_launch_fails_every_entry(monkeypatch):
    """A wave whose launch fails fails over entry by entry, as the
    reference's does: each tile is rendered again through its per-call
    leg (the port's: B2 over the lane's scenes, once a lane), the bytes
    and the fallback count equal the reference's, no request fails and
    every pin is released."""
    from gsky_tpu.ops.warp import render_scenes_ctrl
    jpool, tiles, hw, step, n_ns = _wave_inputs(3)
    statics = ("near", n_ns, hw, step, True, 0)
    tpool = _port_pool(jpool)
    jsched = jwaves.default_waves()
    monkeypatch.setattr(
        jsched, "_dispatch_group",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("launch failed")))

    def jone(t):
        def percall():
            return np.asarray(render_scenes_ctrl(
                jnp.asarray(t["stack"]), jnp.asarray(t["ctrl"]),
                jnp.asarray(t["params"]), jnp.asarray(SP), *statics))
        xla = (jnp.asarray(t["stack"]), t["params"], None, None)
        return jsched.render_byte(jpool, t["tables"], t["p16"], t["ctrl"],
                                  SP, statics, xla, percall,
                                  serials=t["serials"])

    ref = _ok(*_run_threads([lambda t=t: jone(t) for t in tiles]))
    jst = jsched.stats()
    monkeypatch.setattr(
        tpaged, "render_byte_paged",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("launch failed")))
    b2 = []
    real = trender.warp_render_scored
    monkeypatch.setattr(trender, "warp_render_scored",
                        lambda *a: b2.append(1) or real(*a))
    sched = twaves.WaveScheduler("cpu", tick_ms=500.0)
    try:
        got = _port_wave(tpool, tiles, "byte", statics, sched)
        st = sched.stats()
    finally:
        sched.shutdown()
    assert jst["fallbacks"] == st["fallbacks"] == 3
    assert st["failed"] == 0 and len(b2) == 3
    assert tpool.stats()["pinned"] == 0
    for r, g in zip(ref, got):
        _same_bytes("near", np.asarray(r), g)


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_planner_error_leaves_the_wave_unplanned(monkeypatch, pipeline):
    """A planner that raises (on the synchronous leg and at staged
    assembly) leaves its group unplanned in both packages: the wave is
    served in one launch, nothing fails over, and the bytes are equal."""
    monkeypatch.setenv("GSKY_WAVE_PIPELINE", pipeline)

    def broken(*a, **k):
        raise RuntimeError("planner defect")

    monkeypatch.setattr(japlan, "plan_wave_group", broken)
    monkeypatch.setattr(tplan, "plan_wave_group", broken)
    jpool, tiles, hw, step, n_ns = _wave_inputs(4, superblock=True)
    statics = ("bilinear", n_ns, hw, step, True, 0)
    tpool = _port_pool(jpool)
    ref, jsched = _jax_wave(jpool, tiles, "byte", statics)
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)
    try:
        got = _port_wave(tpool, tiles, "byte", statics, sched)
        st = sched.stats()
    finally:
        sched.shutdown()
    assert jsched.stats()["fallbacks"] == 0
    assert st["occupancy"] == {4: 1} and st["superblock_lanes"] == 0
    assert (st["fallbacks"], st["failed"]) == (0, 0)
    for r, g in zip(ref, got):
        _same_bytes("bilinear", r, g)


def test_wave_max_splits_waves(monkeypatch):
    monkeypatch.setenv("GSKY_WAVE_MAX", "2")
    jpool, tiles, hw, step, n_ns = _wave_inputs(5)
    tpool = _port_pool(jpool)
    sched = twaves.WaveScheduler("cpu", tick_ms=300.0)
    try:
        _port_wave(tpool, tiles, "byte", ("near", n_ns, hw, step, True, 0),
                   sched)
        st = sched.stats()
    finally:
        sched.shutdown()
    assert sum(n * c for n, c in st["occupancy"].items()) == 5
    assert max(st["occupancy"]) <= 2 and st["waves"] >= 3


def test_many_threads_get_their_own_lanes():
    """More request threads than cores, a short switch interval: every
    drill gets its own rows back, none is lost or doubled."""
    import sys
    blocks = [tk._b3_inputs(300 + k, 3, 257) for k in range(48)]
    sched = twaves.WaveScheduler("cpu", tick_ms=0.5)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _ok(*_run_threads([
            lambda d=d, v=v: sched.drill_stats(
                torch.from_numpy(d), torch.from_numpy(v), -80.0, 120.0,
                False) for d, v in blocks]))
        st = sched.stats()
    finally:
        sys.setswitchinterval(old)
        sched.shutdown()
    assert st["requests"] == 48 and st["failed"] == 0
    assert sum(n * c for n, c in st["occupancy"].items()) == 48
    for (d, v), (vals, counts) in zip(blocks, got):
        one_v, one_c = tpaged.wave_drill_stats(
            [torch.from_numpy(d)], [torch.from_numpy(v)], -80.0, 120.0)
        np.testing.assert_array_equal(vals, one_v[0].numpy())
        np.testing.assert_array_equal(counts, one_c[0].numpy())


def test_stack_tables_pads_with_null_rows():
    e = [twaves._Entry("byte", (), {"tables": np.full((1, 2), 7, np.int32),
                                    "params16": np.ones((1, 16), np.float32)}),
         twaves._Entry("byte", (), {"tables": np.full((3, 4), 9, np.int32),
                                    "params16": np.ones((3, 16), np.float32)})]
    tables, params = twaves._stack_tables(e)
    assert tables.shape == (2, 3, 4) and params.shape == (6, 16)
    assert (tables[0, 0, :2] == 7).all() and (tables[0, 0, 2:] == 0).all()
    assert (tables[0, 1:] == 0).all() and (params[1:3, 10] == -1).all()
    assert (params[:1] == 1).all() and (params[3:] == 1).all()


@pytest.mark.parametrize("name,env,values", [
    ("wave_max", "GSKY_WAVE_MAX", ["0", "16", "99", "x"]),
    ("wave_tick_ms", "GSKY_WAVE_TICK_MS", ["-1", "2", "500", "x"]),
    ("wave_queue_depth", "GSKY_WAVE_QUEUE", ["0", "3", "9", "x"]),
    ("wave_stage_slots", "GSKY_WAVE_STAGE_SLOTS", ["1", "3", "9", "x"]),
    ("wave_pipeline_enabled", "GSKY_WAVE_PIPELINE", ["0", "1"]),
    ("waves_enabled", "GSKY_WAVES", ["0", "1"])])
def test_knobs_clamp_as_the_reference(monkeypatch, name, env, values):
    for v in values + [None]:
        if v is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, v)
        assert getattr(twaves, name)() == getattr(jwaves, name)(), (env, v)


def test_shutdown_fails_pending_entries():
    sched = twaves.WaveScheduler("cpu", tick_ms=60000.0)
    out, errs = [], []

    def go():
        try:
            out.append(sched.drill_stats(torch.zeros((2, 8)),
                                         torch.ones((2, 8), dtype=torch.bool),
                                         -1.0, 1.0, False))
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while sched.stats()["requests"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    sched.shutdown()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and not out
    assert errs and "shut down" in str(errs[0])


def test_one_scheduler_per_device():
    a = twaves.default_waves("cpu")
    assert twaves.default_waves("cpu") is a
    assert twaves.active_waves("cpu") is a
    assert "cpu" in twaves.wave_stats()
    twaves.reset_waves()
    assert twaves.active_waves("cpu") is None
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            twaves.default_waves("cuda")


# ---------------------------------------------------------------------------
# drill waves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pixel_count", [False, True])
def test_drill_wave_matches_reference_and_per_call(pixel_count):
    blocks = [tk._b3_inputs(50 + k, 6, 3000, edge=True) for k in range(4)]
    jsched = jwaves.default_waves()
    ref = _ok(*_run_threads([
        lambda d=d, v=v: jsched.drill_stats(d, v, -80.0, 120.0, pixel_count,
                                            None) for d, v in blocks]))
    tsched = twaves.WaveScheduler("cpu", tick_ms=1000.0)
    try:
        got = _ok(*_run_threads([
            lambda d=d, v=v: tsched.drill_stats(
                torch.from_numpy(d), torch.from_numpy(v), -80.0, 120.0,
                pixel_count) for d, v in blocks]))
        st = tsched.stats()
    finally:
        tsched.shutdown()
    assert st["occupancy"] == {4: 1}
    for (d, v), (vj, cj), (vt, ct) in zip(blocks, ref, got):
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_allclose(vt, np.asarray(vj), rtol=1e-5, atol=1e-6)
        one_v, one_c = tpaged.wave_drill_stats(
            [torch.from_numpy(d)], [torch.from_numpy(v)], -80.0, 120.0,
            pixel_count)
        np.testing.assert_array_equal(vt, one_v[0].numpy())
        np.testing.assert_array_equal(ct, one_c[0].numpy())


def test_failed_drill_wave_takes_the_per_call_reduction(monkeypatch):
    """A drill wave whose launch fails serves each drill through the
    per-call reduction its caller hands over, in both packages: the
    same fallback count, the port's results its per-call B3's."""
    blocks = [tk._b3_inputs(70 + k, 4, 2500, edge=True) for k in range(3)]
    jsched = jwaves.default_waves()
    monkeypatch.setattr(
        jsched, "_dispatch_group",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("launch failed")))
    ref = _ok(*_run_threads([
        lambda d=d, v=v: jsched.drill_stats(
            d, v, -80.0, 120.0, False,
            lambda d=d, v=v: ("per call", d.shape)) for d, v in blocks]))
    tsched = twaves.WaveScheduler("cpu", tick_ms=500.0)
    monkeypatch.setattr(
        tsched, "_dispatch_group",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("launch failed")))
    from gsky_tpu_torch.ops.stats import masked_stats
    try:
        got = _ok(*_run_threads([
            lambda d=d, v=v: tsched.drill_stats(
                torch.from_numpy(d), torch.from_numpy(v), -80.0, 120.0,
                False, lambda d=d, v=v: tuple(
                    t.numpy() for t in masked_stats(
                        torch.from_numpy(d), torch.from_numpy(v), -80.0,
                        120.0))) for d, v in blocks]))
        st = tsched.stats()
    finally:
        tsched.shutdown()
    assert jsched.stats()["fallbacks"] == st["fallbacks"] == 3
    assert ref == [("per call", d.shape) for d, _ in blocks]
    for (d, v), (s, c) in zip(blocks, got):
        ws, wc = masked_stats(torch.from_numpy(d), torch.from_numpy(v),
                              -80.0, 120.0)
        np.testing.assert_array_equal(s, ws.numpy())
        np.testing.assert_array_equal(c, wc.numpy())


@pytest.fixture(scope="module")
def drill_archive(tmp_path_factory):
    import test_torch_drill as td
    from gsky_tpu.index.crawler import extract as jextract
    from gsky_tpu.index.store import MASStore as JMASStore
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    root = str(tmp_path_factory.mktemp("wave_drill"))
    paths = td._write_archive(root)
    jstore, tstore = JMASStore(), MASStore()
    for p in paths:
        jstore.ingest(jextract(p, approx_stats=True))
        tstore.ingest(extract(p, approx_stats=True))
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


@pytest.mark.parametrize("pixel_count", [False, True])
def test_drill_pipeline_waves(monkeypatch, drill_archive, pixel_count):
    """Concurrent warm drills through both packages' wave paths, and the
    port's per-call path."""
    import test_torch_drill as td
    from gsky_tpu.pipeline import drill_cache as jDC
    from gsky_tpu_torch.pipeline import drill_cache as tDC
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")
    jp, _ = td._pipelines(drill_archive)
    cache = tDC.DrillStackCache(device="cpu")
    _, tp = td._pipelines(drill_archive, cache=cache)
    jreq, treq = td._requests(drill_archive, bands=["a", "b"],
                              pixel_count=pixel_count)
    try:
        jp.process(jreq)                  # stacks resident: warm drills
        tp.process(treq)
        monkeypatch.setenv("GSKY_WAVES", "0")
        per_call = tp.process(treq)
        monkeypatch.setenv("GSKY_WAVES", "1")
        ref = _ok(*_run_threads([lambda: jp.process(jreq)] * 3))
        got = _ok(*_run_threads([lambda: tp.process(treq)] * 3))
    finally:
        jDC.default_drill_cache.clear()
    st = twaves.wave_stats()["cpu"]
    assert st["requests"] >= 3 and st["failed"] == 0
    for r, g in zip(ref, got):
        td._assert_same(r, g)
        td._assert_same(per_call, g, exact=True)


# ---------------------------------------------------------------------------
# the pipeline: executor wave branches and the staged GetMap path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tile_archive(tmp_path_factory):
    import test_torch_pipeline as tp
    root = str(tmp_path_factory.mktemp("wave_tiles"))
    paths = tp._archive(root)
    jstore, tstore = tp._stores(paths)
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


BOXES = [(0.0, 0.0), (3000.0, -2000.0), (-4000.0, 2500.0), (1500.0, 500.0)]


def _requests(archive, method):
    import test_torch_pipeline as tp
    from gsky_tpu.geo.crs import parse_crs as jparse_crs
    from gsky_tpu.geo.transform import BBox as JBBox
    from gsky_tpu.pipeline.types import GeoTileRequest as JRequest
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    out = []
    for dx, dy in BOXES:
        box = tp._bbox3857(dx=dx, dy=dy)
        out.append((JRequest(collection=archive["root"], bands=[tp.NS],
                             bbox=JBBox(*box), crs=jparse_crs("EPSG:3857"),
                             width=80, height=96, resample=method),
                    GeoTileRequest(collection=archive["root"], bands=[tp.NS],
                                   bbox=BBox(*box),
                                   crs=parse_crs("EPSG:3857"), width=80,
                                   height=96, resample=method)))
    return out


def _pipes(archive):
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.pipeline.tile import TilePipeline
    jpages.reset_default_pool()
    return (JTilePipeline(JMASClient(archive["jstore"]),
                          executor=JWarpExecutor()),
            TilePipeline(MASClient(archive["tstore"]), device="cpu"))


@pytest.mark.parametrize("method", ["near", "bilinear"])
def test_render_composite_byte_waves(monkeypatch, tile_archive, method):
    reqs = _requests(tile_archive, method)
    jpipe, tpipe = _pipes(tile_archive)
    try:
        ref = _ok(*_run_threads([lambda r=r: np.asarray(
            jpipe.render_composite_byte(r[0])) for r in reqs]))
        got = _ok(*_run_threads([lambda r=r: tpipe.render_composite_byte(
            r[1]) for r in reqs]))
        monkeypatch.setenv("GSKY_WAVES", "0")
        per_call = [tpipe.render_composite_byte(r[1]).numpy() for r in reqs]
    finally:
        jpages.reset_default_pool()
    st = twaves.wave_stats()["cpu"]
    assert st["requests"] == len(reqs) and st["failed"] == 0
    assert tpipe.executor.paged_engaged == 2 * len(reqs)
    assert tpipe.executor.pool.stats()["pinned"] == 0
    for r, g, one in zip(ref, got, per_call):
        assert isinstance(g, np.ndarray)
        _same_bytes(method, r, g)
        np.testing.assert_array_equal(g, one)


def test_fused_mosaic_scored_waves(monkeypatch, tile_archive):
    """`process` without a mask band: the fused mosaic's scored lanes."""
    reqs = _requests(tile_archive, "bilinear")
    jpipe, tpipe = _pipes(tile_archive)
    try:
        ref = _ok(*_run_threads([lambda r=r: jpipe.process(r[0])
                                 for r in reqs]))
        got = _ok(*_run_threads([lambda r=r: tpipe.process(r[1])
                                 for r in reqs]))
        monkeypatch.setenv("GSKY_WAVES", "0")
        per_call = [tpipe.process(r[1]) for r in reqs]
    finally:
        jpages.reset_default_pool()
    assert twaves.wave_stats()["cpu"]["requests"] == len(reqs)
    for r, g, one in zip(ref, got, per_call):
        for ns in r.namespaces:
            a = np.asarray(r.data[ns])
            np.testing.assert_array_equal(np.asarray(r.valid[ns]),
                                          g.valid[ns].numpy())
            np.testing.assert_array_almost_equal_nulp(
                np.where(np.asarray(r.valid[ns]), a, 0),
                np.where(g.valid[ns].numpy(), g.data[ns].numpy(), 0), 2)
            assert torch.equal(g.data[ns], one.data[ns])
            assert torch.equal(g.valid[ns], one.valid[ns])


@pytest.mark.parametrize("waves", ["0", "1"])
def test_render_staged_matches_reference(monkeypatch, tile_archive, waves):
    from gsky_tpu.pipeline.tile_stages import render_staged as jstaged
    from gsky_tpu_torch.pipeline import tile_stages as tstages
    monkeypatch.setenv("GSKY_WAVES", waves)
    monkeypatch.setenv("GSKY_TILE_DISPATCH_SLOTS", "1")
    tstages.reset_gates()
    reqs = _requests(tile_archive, "near")
    jpipe, tpipe = _pipes(tile_archive)
    try:
        ref = _ok(*_run_threads([lambda r=r: jstaged(
            jpipe, r[0], 1, 10.0, 250.0, 0.0) for r in reqs]))
        spans = [{} for _ in reqs]
        got = _ok(*_run_threads([lambda r=r, s=s: tstages.render_staged(
            tpipe, r[1], 1, 10.0, 250.0, 0.0, spans=s)
            for r, s in zip(reqs, spans)]))
        gates = tstages.gate_stats()
    finally:
        jpages.reset_default_pool()
        tstages.reset_gates()
    for r, g, s in zip(ref, got, spans):
        assert g[0] == r[0] == "composite"
        np.testing.assert_array_equal(g[1], np.asarray(r[1]))
        assert {"plan_s", "index_s", "decode_s", "dispatch_s",
                "readback_s"} <= set(s)
    assert gates["decode"]["entries"] == len(reqs)
    if waves == "1":            # the wave scheduler admits the dispatches
        assert "dispatch" not in gates
    else:
        assert gates["dispatch"]["entries"] == len(reqs)


def test_staged_gates_bound_and_count():
    """Six requests at a gate of two: two inside at once, four queued
    behind them, all six through."""
    from gsky_tpu_torch.pipeline import tile_stages as tstages
    g = tstages.StageGate("x", 2)
    inside, peak = [0], [0]
    lock = threading.Lock()
    release = threading.Event()

    def go():
        with g.enter():
            with lock:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            release.wait(timeout=TIMEOUT)
            with lock:
                inside[0] -= 1

    ts = [threading.Thread(target=go, daemon=True) for _ in range(6)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + TIMEOUT
    while g.stats()["waiting"] < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    with lock:
        assert inside[0] == 2
    release.set()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    st = g.stats()
    assert peak[0] == 2 and st["entries"] == 6 and st["limit"] == 2
    assert st["queue_max"] == 4 and st["waiting"] == 0 and st["busy_s"] > 0
