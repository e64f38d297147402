"""Port parity, the render batcher (`gsky_tpu_torch.pipeline.batcher`,
ROADMAP A.18) against the reference's `gsky_tpu.pipeline.batcher`,
mirroring the reference's `tests/test_batcher.py` case for case:
power-of-two padding, the wait timer cancelled by a full flush, the
whole-stack window (the port has no gather window), exception fan-out,
the throughput knee; plus what the port adds: one kernel-B1 call per
paged flush with pins released, cancellation of a waiter, wave
subsumption.  End to end, both servers over one archive
(`test_torch_gateway`'s) with ``GSKY_RENDER_BATCH=1`` and waves off:
the port's batched tiles equal its per-call tiles byte for byte and the
reference's batched tiles (decoded, nearest).  Every wait has a
timeout."""

import contextlib
import threading
import time
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest
import torch

import gsky_tpu.pipeline.batcher as jbatcher_mod
from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu.pipeline.batcher import RenderBatcher as JRenderBatcher

import gsky_tpu_torch.pipeline.batcher as batcher_mod
from gsky_tpu_torch.io.png import decode_png
from gsky_tpu_torch.ops import paged, warp_render
from gsky_tpu_torch.pipeline.batcher import RenderBatcher
from gsky_tpu_torch.resilience import (RequestCancelled, cancel_scope,
                                       reset_cancel_stats)

from test_torch_gateway import HOST, _layer, garch, make_env  # noqa: F401
from test_torch_server import MERC, T_DATA, _bbox, _box

H = W = 8
STATICS = ("near", 1, (H, W), 1, False, 0)
TIMEOUT = 30


class FakePool:
    """What a paged flush reads of a page pool; counts unpins."""

    def __init__(self):
        self.page_rows = self.page_cols = 4
        self.device = torch.device("cpu")
        self.unpinned = []
        self.arr = torch.zeros((8, 4, 4))

    @contextlib.contextmanager
    def locked_pool(self):
        yield self.arr

    def unpin(self, slots):
        self.unpinned.append(np.asarray(slots).tolist())


class FakeB1:
    """Stands in for `render_byte_paged`: records each flush's operands
    and answers lane i with the value of its first table slot."""

    def __init__(self):
        self.calls = []

    def __call__(self, pool, tables, params, ctrls, sps, method, n_ns,
                 out_hw, step, auto, colour_scale):
        self.calls.append({"n": int(tables.shape[0]),
                           "tables": tables.clone(),
                           "params": params.clone()})
        first = tables[:, 0, 0].to(torch.uint8)
        return first[:, None, None].expand(-1, *out_hw).clone()


@pytest.fixture
def fake(monkeypatch):
    fk = FakeB1()
    monkeypatch.setattr(paged, "render_byte_paged", fk)
    return fk


def _item(i, T=2, S=2):
    tables = np.full((T, S), i + 1, np.int32)
    params = np.zeros((T, 16), np.float32)
    params[:, 10] = 0.0
    ctrl = np.full((2, 2, 2), float(i), np.float32)
    sp = np.zeros(3, np.float32)
    return tables, params, ctrl, sp


def _submit(b, n, pool=None, key=("paged",), shapes=None):
    """n concurrent render_paged calls: (results, errors, pool)."""
    pool = pool or FakePool()
    results, errors = [None] * n, [None] * n

    def go(i):
        try:
            T, S = shapes[i] if shapes else (2, 2)
            tables, params, ctrl, sp = _item(i, T, S)
            results[i] = b.render_paged(key, pool, tables, params, ctrl,
                                        sp, STATICS, T * S)
        except BaseException as e:   # recorded for the asserts
            errors[i] = e
    ts = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    return results, errors, pool


@pytest.fixture(autouse=True)
def _waves_off(monkeypatch):
    monkeypatch.setenv("GSKY_WAVES", "0")
    monkeypatch.setenv("GSKY_PREFETCH", "0")
    reset_cancel_stats()


# ---------------------------------------------------------------------------
# padding, flushes, pins
# ---------------------------------------------------------------------------

class TestPadding:
    @pytest.mark.parametrize("n,padded", [(1, 1), (3, 4), (5, 8),
                                          (16, 16)])
    def test_pow2_padding(self, fake, n, padded):
        b = RenderBatcher(max_batch=16, max_wait_s=0.25)
        results, errors, pool = _submit(b, n)
        assert errors == [None] * n
        assert all(r is not None and r.shape == (H, W) for r in results)
        assert sum(c["n"] for c in fake.calls) >= padded
        assert max(c["n"] for c in fake.calls) == padded
        # each lane got its own tile back, padding lanes none
        assert sorted(int(r[0, 0]) for r in results) == \
            list(range(1, n + 1))
        assert sum(b.flush_sizes) == n
        assert len(pool.unpinned) == n

    def test_full_batch_is_single_dispatch(self, fake):
        b = RenderBatcher(max_batch=16, max_wait_s=5.0)
        results, errors, _ = _submit(b, 16)
        assert errors == [None] * 16
        assert [c["n"] for c in fake.calls] == [16]
        assert b.paged_batches == 1 and b.flush_sizes == [16]

    def test_ragged_tables_pad_to_the_largest(self, fake):
        b = RenderBatcher(max_batch=4, max_wait_s=5.0)
        shapes = [(1, 1), (2, 4), (4, 2), (2, 2)]
        _, errors, _ = _submit(b, 4, shapes=shapes)
        assert errors == [None] * 4
        call, = fake.calls
        assert tuple(call["tables"].shape) == (4, 4, 4)
        prm = call["params"].reshape(4, 4, 16)
        # rows past a lane's granules are padding: ns_id -1, null table
        for i in range(4):
            lane = int(call["tables"][i, 0, 0]) - 1
            T, S = shapes[lane]
            assert (prm[i, T:, 10] == -1).all()
            assert (prm[i, :T, 10] == 0).all()
            assert (call["tables"][i, T:] == 0).all()
            assert (call["tables"][i, :T, S:] == 0).all()
        assert b.pad_waste_bytes > 0

    def test_pow2_padding_equals_the_reference(self):
        """The padded sizes of both packages' flushes: the reference's
        dense leg, the port's paged leg."""
        calls = []

        def ref_kernel(stack, ctrls, params, sps, *a, **k):
            calls.append(int(np.asarray(ctrls).shape[0]))
            return np.zeros((np.asarray(ctrls).shape[0], H, W), np.uint8)
        mp = pytest.MonkeyPatch()
        mp.setattr(jbatcher_mod, "render_scenes_ctrl_many", ref_kernel)
        fk = FakeB1()
        mp.setattr(paged, "render_byte_paged", fk)
        try:
            for n in (1, 2, 3, 5, 7, 9, 16):
                jb = JRenderBatcher(max_batch=16, max_wait_s=5.0)
                jb.knee = n
                tb = RenderBatcher(max_batch=16, max_wait_s=5.0)
                tb.knee = n
                _jax_submit(jb, n)
                _submit(tb, n)
            assert calls == [c["n"] for c in fk.calls]
        finally:
            mp.undo()


def _jax_submit(b, n):
    stack = np.zeros((2, 32, 32), np.float32)

    def go(i):
        b.render(("k",), stack, np.full((2, 3), float(i), np.float32),
                 np.full(8, float(i), np.float32), np.zeros(4, np.float32),
                 STATICS)
    ts = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)


class TestTimerCancel:
    def test_full_flush_cancels_wait_timer(self, fake, monkeypatch):
        made = []
        real_timer = threading.Timer

        class RecordingTimer(real_timer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        monkeypatch.setattr(batcher_mod.threading, "Timer",
                            RecordingTimer)
        b = RenderBatcher(max_batch=4, max_wait_s=30.0)
        _submit(b, 4)
        assert len(made) == 1
        assert made[0].finished.is_set()
        made[0].join(timeout=1)
        assert not made[0].is_alive()

    def test_timer_flushes_a_partial_group(self, fake):
        b = RenderBatcher(max_batch=16, max_wait_s=0.05)
        t0 = time.monotonic()
        results, errors, _ = _submit(b, 3)
        assert errors == [None] * 3
        assert [c["n"] for c in fake.calls] == [4]
        assert time.monotonic() - t0 < TIMEOUT


class TestUnionWindow:
    """The port has no gather window (ROADMAP A.4): every dense flush
    reads the whole scenes."""

    def test_union_window_is_whole_stack(self):
        b = RenderBatcher()
        items = [(None, None, None, (2, 70, 4, 100), None),
                 (None, None, None, (4, 90, 2, 80), None)]
        assert b._union_window(items, None) == (None, None)

    def test_dense_flush_counts_full_batches(self, monkeypatch):
        calls = []

        def fake_b2(scenes, ctrl, params, sp, *statics):
            calls.append(float(ctrl[0, 0, 0]))
            return torch.full((H, W), int(ctrl[0, 0, 0]), dtype=torch.uint8)
        monkeypatch.setattr(warp_render, "render_scenes", fake_b2)
        b = RenderBatcher(max_batch=4, max_wait_s=5.0)
        out = [None] * 4

        def go(i):
            ctrl = torch.full((2, 2, 2), float(i))
            out[i] = b.render(("s", 1) + STATICS, [torch.zeros(4, 4)], ctrl,
                              torch.zeros(1, 16), np.zeros(3, np.float32),
                              STATICS)
        ts = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=TIMEOUT)
        assert sorted(calls) == [0.0, 1.0, 2.0, 3.0]
        assert [int(o[0, 0]) for o in out] == [0, 1, 2, 3]
        assert b.full_batches == 1 and b.win_batches == 0


class TestExceptionFanOut:
    def test_kernel_error_reaches_all_waiters(self, monkeypatch):
        def boom(*a, **kw):
            raise RuntimeError("kernel exploded")
        monkeypatch.setattr(paged, "render_byte_paged", boom)
        b = RenderBatcher(max_batch=4, max_wait_s=0.2)
        results, errors, pool = _submit(b, 4)
        assert results == [None] * 4
        assert all(isinstance(e, RuntimeError) for e in errors)
        # the pins come back even when the launch fails
        assert len(pool.unpinned) == 4

    def test_dense_error_reaches_all_waiters(self, monkeypatch):
        def boom(*a, **kw):
            raise RuntimeError("B2 failed")
        monkeypatch.setattr(warp_render, "render_scenes", boom)
        b = RenderBatcher(max_batch=2, max_wait_s=5.0)
        errs = []

        def go():
            try:
                b.render(("s",), [], torch.zeros(2, 2, 2), None,
                         np.zeros(3, np.float32), STATICS)
            except RuntimeError as e:
                errs.append(e)
        ts = [threading.Thread(target=go) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=TIMEOUT)
        assert len(errs) == 2


# ---------------------------------------------------------------------------
# the throughput knee
# ---------------------------------------------------------------------------

PKGS = {"jax": JRenderBatcher, "torch": RenderBatcher}


@pytest.fixture(params=sorted(PKGS))
def RB(request):
    return PKGS[request.param]


class TestThroughputKnee:
    def test_first_sample_per_size_discarded(self, RB):
        b = RB()
        b._observe(8, 8, 800.0)
        assert b.stats()["tile_ms"] == {}
        b._observe(8, 8, 80.0)
        assert b.stats()["tile_ms"] == {8: 10.0}

    def test_knee_ratchets_down_past_regression(self, RB):
        b = RB(max_batch=16)
        assert b.knee == 16
        for _ in range(3):
            b._observe(1, 1, 4.10)
        for _ in range(3):
            b._observe(8, 8, 8 * 9.29)
        assert b.knee == 4
        b._observe(8, 8, 8 * 0.5)
        assert b.knee == 4

    def test_size_within_ratio_keeps_knee(self, RB):
        b = RB(max_batch=16)
        for _ in range(3):
            b._observe(1, 1, 4.0)
        for _ in range(3):
            b._observe(8, 8, 8 * 4.5)
        assert b.knee == 16

    def test_flush_threshold_respects_knee(self, fake):
        b = RenderBatcher(max_batch=16, max_wait_s=30.0)
        b.knee = 2
        results, errors, _ = _submit(b, 2)
        assert errors == [None, None]
        assert [c["n"] for c in fake.calls] == [2]

    def test_env_cap_pins_knee(self, RB, monkeypatch):
        monkeypatch.setenv("GSKY_RENDER_BATCH_MAX", "2")
        assert RB(max_batch=16).knee == 2
        monkeypatch.setenv("GSKY_RENDER_BATCH_MAX", "not-a-number")
        assert RB(max_batch=16).knee == 16
        monkeypatch.setenv("GSKY_RENDER_BATCH_MAX", "64")
        assert RB(max_batch=16).knee == 16

    def test_note_oom_halves_the_knee(self, RB):
        b = RB(max_batch=16)
        b.note_oom()
        b.note_oom()
        assert b.knee == 4

    def test_stats_payload_shape(self, RB):
        b = RB()
        st = b.stats()
        assert set(st) == {"batch_knee", "tile_ms", "win_batches",
                           "full_batches", "paged_batches",
                           "pad_waste_bytes"}
        assert st["batch_knee"] == b.knee
        assert st["win_batches"] == st["full_batches"] == 0
        assert st["paged_batches"] == st["pad_waste_bytes"] == 0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_knee_sequence_equals_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        jb, tb = JRenderBatcher(max_batch=16), RenderBatcher(max_batch=16)
        for _ in range(60):
            np_size = int(2 ** rng.integers(0, 5))
            n = int(rng.integers(1, np_size + 1))
            ms = float(rng.uniform(1.0, 40.0)) * n
            jb._observe(np_size, n, ms)
            tb._observe(np_size, n, ms)
            assert tb.knee == jb.knee
        assert tb.stats()["tile_ms"] == jb.stats()["tile_ms"]


# ---------------------------------------------------------------------------
# cancellation and waves
# ---------------------------------------------------------------------------

def test_cancelled_waiter_unwinds_while_the_flush_serves_the_rest(
        monkeypatch):
    gate = threading.Event()
    fk = FakeB1()

    def slow(*a, **k):
        gate.wait(TIMEOUT)
        return fk(*a, **k)
    monkeypatch.setattr(paged, "render_byte_paged", slow)
    b = RenderBatcher(max_batch=2, max_wait_s=30.0)
    pool = FakePool()
    out, errs = {}, {}
    toks = {}

    def go(i):
        with cancel_scope() as tok:
            toks[i] = tok
            tables, params, ctrl, sp = _item(i)
            try:
                out[i] = b.render_paged(("paged",), pool, tables, params,
                                        ctrl, sp, STATICS, 4)
            except RequestCancelled as e:
                errs[i] = e
    ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + TIMEOUT
    while len(toks) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    toks[0].cancel("client-disconnect")
    ts[0].join(timeout=TIMEOUT)
    assert not ts[0].is_alive() and errs[0].stage == "batch"
    gate.set()
    ts[1].join(timeout=TIMEOUT)
    assert int(out[1][0, 0]) == 2
    assert len(pool.unpinned) == 2


def test_render_paged_joins_a_live_wave(monkeypatch):
    """With waves live the batcher opens no group: the tile is a lane of
    the device's wave."""
    from gsky_tpu_torch.pipeline import waves
    monkeypatch.setenv("GSKY_WAVES", "1")
    seen = []

    class FakeWaves:
        def render_byte(self, pool, tables, params16, ctrl, sp, statics,
                        lane, serials):
            seen.append(statics)
            return np.zeros((H, W), np.uint8)
    monkeypatch.setattr(waves, "active_waves", lambda dev: FakeWaves())
    b = RenderBatcher(max_batch=4, max_wait_s=30.0)
    tables, params, ctrl, sp = _item(0)
    b.render_paged(("paged",), FakePool(), tables, params, ctrl, sp,
                   STATICS, 4)
    assert seen == [STATICS] and b.paged_batches == 0


# ---------------------------------------------------------------------------
# end to end: batched tiles equal per-call tiles and the reference's
# ---------------------------------------------------------------------------

BOXES = [_box(598500.0 + 300.0 * i, 6100000.0 - 200.0 * i, 3000.0)
         for i in range(8)]


def _url(box, method=""):
    return (f"/ows?service=WMS&request=GetMap&version=1.3.0&layers=plain"
            f"&styles={method}&crs={MERC}&bbox={_bbox(box)}&width=64"
            f"&height=64&format=image/png&time={T_DATA}")


def _port_tiles(env, urls):
    out = [None] * len(urls)

    def go(i):
        u = urlsplit(urls[i])
        r = env.port.handle(u.path, parse_qs(u.query,
                                             keep_blank_values=True), HOST)
        out[i] = (r.status, r.read())
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(urls))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return out


@pytest.fixture
def b1_calls(monkeypatch):
    calls = []
    f = paged.paged_render_scored

    def counted(*a, **k):
        calls.append(int(a[1].shape[0]))
        return f(*a, **k)
    monkeypatch.setattr(paged, "paged_render_scored", counted)
    return calls


@pytest.mark.parametrize("method", ["near", "bilinear"])
def test_batched_tiles_equal_per_call_and_the_reference(
        make_env, garch, monkeypatch, b1_calls, method):
    root = garch["root"]
    env = make_env([_layer("plain", root, styles=[
        {"name": m, "title": m, "rgb_products": ["B4"], "resample": m}
        for m in ("near", "bilinear")])])
    urls = [_url(b, method) for b in BOXES]
    monkeypatch.setenv("GSKY_RENDER_BATCH", "0")
    percall = _port_tiles(env, urls)
    assert len(b1_calls) == 8
    del b1_calls[:]
    monkeypatch.setenv("GSKY_RENDER_BATCH", "1")
    for gw in env.gateways:
        gw.cache.clear()
    batcher = env.port.executor.batcher
    batched = _port_tiles(env, urls)
    assert [s for s, _ in batched] == [200] * 8
    assert [b for _, b in batched] == [b for _, b in percall]
    # one B1 call per flush, every tile in exactly one flush
    assert len(b1_calls) == batcher.paged_batches
    assert sum(batcher.flush_sizes) == 8
    ref = env.jax(urls)
    for (js, _, jb, _), (ts, tb) in zip(ref, batched):
        assert js == ts == 200
        a, b = jdecode_png(jb), decode_png(tb)
        diff = int(np.count_nonzero(a != b))
        assert diff <= (0 if method == "near" else a.size // 1000), diff


def test_declined_tiles_take_the_dense_leg(make_env, garch, monkeypatch):
    """Tiles the page pool declines take the bucketed leg: with the
    batcher on, its flushes run B2 and the tiles are the per-call
    ones."""
    from gsky_tpu_torch.pipeline.executor import WarpExecutor
    monkeypatch.setattr(WarpExecutor, "_paged_from_group",
                        lambda self, *a, **k: None)
    env = make_env()
    urls = [_url(b) for b in BOXES[:4]]
    monkeypatch.setenv("GSKY_RENDER_BATCH", "0")
    percall = _port_tiles(env, urls)
    monkeypatch.setenv("GSKY_RENDER_BATCH", "1")
    for gw in env.gateways:
        gw.cache.clear()
    batched = _port_tiles(env, urls)
    assert [st for st, _ in batched] == [200] * 4
    assert batched == percall
    assert env.port.executor.batcher.full_batches >= 1
    assert env.port.executor.batcher.paged_batches == 0
