"""Port parity, the worker boundary: `gsky_tpu_torch.worker` against
`gsky_tpu.worker`.

- The message codec (`worker.gskyrpc`): seeded random messages of every
  type, and the edge cases (negative ``int32``, NaN and +-0.0 doubles,
  empty and touched submessages, packed repeated fields, unknown
  fields), encode to the bytes ``gskyrpc_pb2`` (protobuf) writes, and
  each side parses the other's.
- Serialization, the decode-subprocess pool (a child crash, backpressure,
  an unknown op; its children are spawned with ``python -m``), the OOM
  monitor: the port of `tests/test_worker.py`'s tests of them.
- The worker node over gRPC (one port worker per module, pool of 2
  children, bound to port 0) beside the reference's worker (pool of
  1): a remote tile equals the port's local tile
  and the reference's remote tile (nearest bit for bit, the other
  methods within the port's stated 2 ulp), plain, sub-tiled, capped by
  ``max_msg``, HDF4 and geolocated; the ``info``, ``extent`` and
  ``drill`` ops (drill within rtol 1e-5 of the reference's); the
  crawler's ``-rpc``; ``close`` then a call raises; cancellation (a
  fired token stops the dispatch; a departed client's warp is skipped);
  ``NodeBusy`` is retryable; gRPC's statuses as the client sees them
  (``UNAVAILABLE`` fatal for the node, the rest not); one channel
  carrying ``CONC_PER_NODE`` RPCs at once; a revived node re-dialled
  within seconds; a server that cannot bind and a missing ``grpc``
  raise; the trace hop and ``gsky_worker_rpc_seconds``.
- Across the packages, both ways: the reference's `WorkerClient` gets
  from a port worker what it gets from its own (``info``, ``extent``, a
  masked remote tile, the drill, a page fetch), the port's client, page
  fetch and ``control_rpc`` work against the reference's worker, and a
  trace continues across the wire in both directions.

Every test that starts a server or a process runs under a time limit of
its own (`time_limit`, <= 30 s); the module fixtures that start them
too."""

import contextlib
import dataclasses
import json
import os
import random
import re
import signal
import subprocess
import threading
import time
import types

import grpc
import numpy as np
import pytest

from gsky_tpu.worker import gskyrpc_pb2 as jpb
from gsky_tpu.worker import serialize as jserialize

from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import BBox, GeoTransform
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.pipeline.tile import TilePipeline
from gsky_tpu_torch.pipeline.types import GeoTileRequest, Granule
from gsky_tpu_torch.resilience import (BackendUnavailable, RequestCancelled,
                                       cancel_scope, faults,
                                       reset_cancel_stats)
from gsky_tpu_torch.worker import gskyrpc as pb
from gsky_tpu_torch.worker.client import NodeBusy, WorkerClient
from gsky_tpu_torch.worker.oom import OOMMonitor
from gsky_tpu_torch.worker.pool import PoolFullError, ProcessPool
from gsky_tpu_torch.worker.serialize import (granule_from_pb, granule_to_pb,
                                             pack_raster, unpack_raster)
from gsky_tpu_torch.worker.server import METHOD, WorkerService, make_server

from test_torch_mosaic import (MASKS, _close, _requests, _same_result,
                               _stores, _write_archive, jax_b4)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# helpers: a time limit, a process that announces its port
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the block with TimeoutError once ``seconds`` pass (SIGALRM,
    on the main thread; elsewhere no limit)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def on_alarm(signum, frame):
        raise TimeoutError(f"over the {seconds} s time limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def start_process(cmd, marker, env=None):
    """Start ``cmd`` in the repo with stdout and stderr piped, read until
    a line with ``marker`` and ``listening on HOST:PORT``: (proc, port).
    Later lines collect in ``proc.lines`` (a reader thread,
    ``proc.reader``)."""
    e = dict(os.environ)
    e.update(env or {})
    e["PYTHONUNBUFFERED"] = "1"
    proc = subprocess.Popen(cmd, cwd=REPO, env=e, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.lines = []
    port = None
    for line in proc.stdout:
        proc.lines.append(line)
        m = re.search(r"listening on \S*:(\d+)", line)
        if m and marker in line:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        proc.wait(5)
        raise AssertionError("".join(proc.lines))
    proc.reader = threading.Thread(
        target=lambda: proc.lines.extend(proc.stdout), daemon=True)
    proc.reader.start()
    return proc, port


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

_DOUBLES = (0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1.5,
            -2.25e300, 5e-324, 1e-300)
_INT32 = (0, 1, -1, 127, 128, 300, 2 ** 31 - 1, -(2 ** 31))
_INT64 = (0, -1, 2 ** 63 - 1, -(2 ** 63), 1 << 40)
_STRINGS = ("", "a", "warp", "é漢字", "x" * 300)


def _rand_value(rng, kind):
    if kind == "double":
        return rng.choice(_DOUBLES + (rng.uniform(-1e9, 1e9),))
    if kind == "int32":
        return rng.choice(_INT32 + (rng.randint(-2 ** 31, 2 ** 31 - 1),))
    if kind == "int64":
        return rng.choice(_INT64 + (rng.randint(-2 ** 63, 2 ** 63 - 1),))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "string":
        return rng.choice(_STRINGS)
    return rng.choice([b"", b"\x00", bytes(rng.randrange(256)
                                           for _ in range(rng.randrange(600)))])


def _fill(rng, tm, jm):
    """Set the same random fields on the port's and protobuf's message:
    fields left out, set to defaults, submessages copied empty or
    filled, repeated fields extended (sometimes with nothing)."""
    for f in type(tm)._FIELDS:
        r = rng.random()
        if r < 0.25:
            continue
        if f.repeated:
            vals = [_rand_value(rng, f.kind)
                    for _ in range(rng.randrange(0, 6))]
            getattr(tm, f.name).extend(vals)
            getattr(jm, f.name).extend(vals)
        elif f.kind == "message":
            if r < 0.4:
                getattr(tm, f.name).CopyFrom(f.msg())
                getattr(jm, f.name).CopyFrom(
                    getattr(jpb, f.msg.__name__)())
            else:
                _fill(rng, getattr(tm, f.name), getattr(jm, f.name))
        else:
            v = _rand_value(rng, f.kind)
            setattr(tm, f.name, v)
            setattr(jm, f.name, v)


@pytest.mark.parametrize("name", [m.__name__ for m in pb.MESSAGES])
def test_codec_bytes_equal_protobuf(name):
    rng = random.Random(sum(map(ord, name)))
    for _ in range(250):
        tm, jm = getattr(pb, name)(), getattr(jpb, name)()
        _fill(rng, tm, jm)
        got, want = tm.SerializeToString(), jm.SerializeToString()
        assert got == want, (tm, jm)
        # each side parses the other's bytes to the same message
        assert getattr(pb, name).FromString(want).SerializeToString() \
            == want
        assert getattr(jpb, name).FromString(got).SerializeToString() \
            == got


def _both(build):
    t, j = build(pb), build(jpb)
    return t.SerializeToString(), j.SerializeToString()


EDGES = {
    "empty": lambda m: m.Result(),
    "negative int32": lambda m: m.Result(extent_width=-1,
                                         extent_height=-(2 ** 31)),
    "int64 bounds": lambda m: m.Metrics(bytes_read=-(2 ** 63)),
    "nan": lambda m: m.Result(nodata=float("nan")),
    "-0.0": lambda m: m.Result(nodata=-0.0),
    "+0.0": lambda m: m.Result(nodata=0.0),
    "default scalars": lambda m: m.Task(operation="", timeout_s=0.0,
                                        path=""),
    "copyfrom empty": lambda m: _touch(m, lambda r: r.metrics.CopyFrom(
        m.Metrics())),
    "granule copyfrom": lambda m: _touch(m.Task(operation="warp"),
                                         lambda t: t.granule.CopyFrom(
                                             m.Granule())),
    "extend nothing": lambda m: _touch(
        m, lambda r: r.series.means.extend([])),
    "del slice": lambda m: _touch(m, lambda r: r.series.means.__delitem__(
        slice(None))),
    "set default in sub": lambda m: _touch(
        m, lambda r: setattr(r.metrics, "bytes_read", 0)),
    "read only": lambda m: _touch(
        m, lambda r: (r.series.means, r.metrics.bytes_read, r.worker)),
    "nested set": lambda m: _touch(m.Task(), lambda t: setattr(
        t.drill, "has_clip", True)),
    "packed": lambda m: m.Result(shape=[3, -1, 2 ** 31 - 1],
                                 bbox=[-0.0, float("inf"), 1e300]),
    "del then extend": lambda m: _touch(m, lambda r: (
        r.shape.extend([4, 5]), r.shape.__delitem__(slice(None)),
        r.shape.extend([6, 7]))),
    "utf-8": lambda m: m.Task(path="é漢字/𝔤.tif"),
    "big bytes": lambda m: m.Result(raster=bytes(range(256)) * 4096),
}


def _touch(m, fn):
    """``fn`` applied to ``m``, or to a new Result of module ``m``."""
    r = m.Result() if isinstance(m, types.ModuleType) else m
    fn(r)
    return r


@pytest.mark.parametrize("case", sorted(EDGES))
def test_codec_edge_cases_equal_protobuf(case):
    got, want = _both(EDGES[case])
    assert got == want
    # the parse of either side's bytes re-encodes to them
    assert pb.Task.FromString(b"").SerializeToString() == b""
    name = type(EDGES[case](pb)).__name__
    assert getattr(pb, name).FromString(want).SerializeToString() == want


def test_codec_parse_forms_protobuf_accepts():
    # unpacked repeated numerics, a repeated submessage merging, the
    # last of a scalar winning, unknown fields of every wire type
    data = (b"\x20\x03\x20\x05"              # shape 3, 5 unpacked
            b"\x0a\x01a\x0a\x01b"            # error "a" then "b"
            b"\x62\x02\x10\x04\x62\x02\x10\x09"   # series.counts merged
            b"\x98\x01\x05"                   # field 19 varint
            b"\xa1\x01" + b"\x01" * 8 +       # field 20 fixed64
            b"\xaa\x01\x02hi"                 # field 21 bytes
            b"\xb5\x01" + b"\x02" * 4)        # field 22 fixed32
    t, j = pb.Result.FromString(data), jpb.Result.FromString(data)
    assert list(t.shape) == list(j.shape) == [3, 5]
    assert t.error == j.error == "b"
    assert list(t.series.counts) == list(j.series.counts) == [4, 9]
    # the port skips unknown fields where protobuf keeps them
    j.DiscardUnknownFields()
    assert t.SerializeToString() == j.SerializeToString()
    with pytest.raises(pb.DecodeError):
        pb.Result.FromString(b"\x12\x05ab")      # truncated bytes
    with pytest.raises(pb.DecodeError):
        pb.Result.FromString(b"\x0a\x02\xff\xfe")  # not UTF-8


def test_codec_type_checks_as_protobuf():
    for bad in (lambda m: m.Result(extent_width=1.5),
                lambda m: m.Result(error=3),
                lambda m: m.Result(raster="text"),
                lambda m: m.Result(nodata="1")):
        with pytest.raises(TypeError):
            bad(jpb)
        with pytest.raises(TypeError):
            bad(pb)
    for bad in (lambda m: m.Result(extent_width=2 ** 31),
                lambda m: m.Task(nope=1)):
        with pytest.raises(ValueError):
            bad(jpb)
        with pytest.raises(ValueError):
            bad(pb)
    t = pb.Task()
    with pytest.raises(AttributeError):
        t.granule = pb.Granule()
    assert not t.HasField("granule")
    t.granule.path = "p"
    assert t.HasField("granule")
    assert pb.Task.FromString(t.SerializeToString()) == t


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

GRANULES = [
    Granule(path="/a.tif", ds_name="a.tif", namespace="red#t=1",
            base_namespace="red", band=3, time_index=None,
            timestamp=1577836800.0, srs="EPSG:32755",
            geo_transform=[590000.0, 30.0, 0.0, 6105000.0, 0.0, -30.0],
            nodata=-999.0, array_type="Int16", is_netcdf=False),
    Granule(path="p", ds_name="d", namespace="n", base_namespace="n",
            band=1, time_index=2, timestamp=0.0, srs="EPSG:4326",
            geo_transform=[0, 1, 0, 0, 0, -1], nodata=None,
            array_type="Float32", is_netcdf=True, var_name="v",
            geo_loc={"x_var": "lon", "y_var": "lat", "step": 5},
            polygon="POLYGON((0 0,1 0,1 1,0 0))"),
    Granule(path="q", ds_name="d", namespace="n", base_namespace="n",
            band=1, time_index=0, timestamp=1.0, srs="", geo_transform=[],
            nodata=float("nan")),
]


@pytest.mark.parametrize("i", range(len(GRANULES)))
def test_granule_round_trip_and_bytes_equal_reference(i):
    from gsky_tpu.pipeline.types import Granule as JGranule
    g = GRANULES[i]
    m = granule_to_pb(g)
    # a NaN nodata travels as no nodata, as in the reference
    want = g if g.nodata is not None and g.nodata == g.nodata \
        else dataclasses.replace(g, nodata=None)
    assert granule_from_pb(m) == want
    jm = jserialize.granule_to_pb(JGranule(**dataclasses.asdict(g)))
    assert m.SerializeToString() == jm.SerializeToString()


def test_raster_pack_round_trip_and_bytes_equal_reference():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(37, 53)).astype(np.float32)
    valid = rng.uniform(size=(37, 53)) > 0.3
    res, jres = pb.Result(), jpb.Result()
    pack_raster(res, data, valid)
    jserialize.pack_raster(jres, data, valid)
    assert res.SerializeToString() == jres.SerializeToString()
    out = unpack_raster(res)
    np.testing.assert_array_equal(out[0], data)
    np.testing.assert_array_equal(out[1], valid)
    assert unpack_raster(pb.Result()) is None


# ---------------------------------------------------------------------------
# the decode pool, the OOM monitor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """`test_torch_mosaic`'s archive: four acquisitions of LC08_B4,
    LC08_B5 and pixel_qa, both packages' stores."""
    root = str(tmp_path_factory.mktemp("worker_archive"))
    os.makedirs(os.path.join(root, "bands"))
    os.makedirs(os.path.join(root, "qa"))
    paths = _write_archive(root)
    jstore, tstore = _stores(paths)
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


@pytest.fixture(scope="module")
def pool():
    with time_limit(30):
        p = ProcessPool(size=2, task_timeout=30.0, quiet=True)
    yield p
    p.close()


def _tif_granule(archive, ns="LC08_B4"):
    ds = next(d for d in MASClient(archive["tstore"]).intersects(
        archive["root"], namespaces=ns) if d.file_path.endswith(".tif"))
    return ds, Granule(path=ds.file_path, ds_name=ds.ds_name, namespace=ns,
                       base_namespace=ns, band=1, time_index=None,
                       timestamp=ds.timestamps[0] if ds.timestamps else 0.0,
                       srs=ds.srs, geo_transform=ds.geo_transform,
                       nodata=ds.nodata, array_type=ds.array_type)


def _decode_task(archive, width=64, height=64):
    ds, g = _tif_granule(archive)
    gt = GeoTransform.from_gdal(ds.geo_transform)
    task = pb.Task(operation="decode")
    task.granule.CopyFrom(granule_to_pb(g))
    task.dst.srs = ds.srs
    task.dst.geo_transform.extend(gt.to_gdal())
    task.dst.width = width
    task.dst.height = height
    task.dst.resample = "near"
    return task


def test_pool_decode_equals_the_reference_subprocess(pool, archive):
    from gsky_tpu.worker.pool import ProcessPool as JPool
    with time_limit(30):
        res = pool.submit(_decode_task(archive))
        assert not res.error, res.error
        out = unpack_raster(res)
        assert out is not None and out[0].shape[0] > 0
        assert res.metrics.bytes_read > 0 and len(res.window_gt) == 6
        jp = JPool(size=1, task_timeout=30.0, quiet=True)
        try:
            jres = jp.submit(jpb.Task.FromString(
                _decode_task(archive).SerializeToString()))
        finally:
            jp.close()
        assert res.SerializeToString() == jres.SerializeToString()


def test_pool_children_are_spawned_modules(pool):
    """The decode children are ``python -m gsky_tpu_torch.worker.subproc``
    processes (spawned, not forked copies of this one)."""
    with time_limit(30):
        deadline = time.time() + 20
        while len(pool.child_pids()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        for pid in pool.child_pids():
            with open(f"/proc/{pid}/cmdline", "rb") as fp:
                argv = fp.read().split(b"\0")
            assert b"gsky_tpu_torch.worker.subproc" in argv
            assert str(os.getpid()).encode() in argv


def test_pool_survives_child_crash(pool, archive):
    with time_limit(30):
        deadline = time.time() + 10
        while len(pool.child_pids()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        pids = pool.child_pids()
        assert len(pids) == 2
        os.kill(pids[0], signal.SIGKILL)
        ok = False
        deadline = time.time() + 15
        while time.time() < deadline:
            res = pool.submit(_decode_task(archive))
            if not res.error and unpack_raster(res) is not None:
                ok = True
                break
            time.sleep(0.2)
        assert ok, "pool did not recover from child crash"
        deadline = time.time() + 10
        while time.time() < deadline:
            now = set(pool.child_pids())
            if pids[0] not in now and len(now) == 2:
                break
            time.sleep(0.1)
        assert pids[0] not in set(pool.child_pids())


def test_pool_unknown_op(pool):
    with time_limit(30):
        res = pool.submit(pb.Task(operation="no_such_op"))
    assert "unknown operation" in res.error


def test_pool_backpressure_rejects():
    import queue as queue_mod
    p = ProcessPool.__new__(ProcessPool)
    p.closed = False
    p.queue = queue_mod.Queue(maxsize=1)
    p.task_timeout = 1.0
    p.queue.put_nowait(object())
    with pytest.raises(PoolFullError):
        p.submit(pb.Task(operation="decode"))


def test_pool_full_is_retryable_resilience_error():
    from gsky_tpu_torch.resilience.retry import RetryPolicy, call_with_retry
    assert PoolFullError("queue full").retryable is True
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise PoolFullError("queue full")
        return "ok"

    out = call_with_retry(
        flaky, RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0),
        sleep=lambda s: None)
    assert out == "ok" and len(attempts) == 3


def _service_with(submit, device="cpu"):
    import types
    from gsky_tpu_torch.fleet import DrainController
    svc = WorkerService.__new__(WorkerService)
    svc.pool = types.SimpleNamespace(
        size=1, queue=types.SimpleNamespace(maxsize=8), submit=submit,
        close=lambda: None, stats=lambda: {"size": 1})
    svc.drain = DrainController("t")
    svc.device = parse_device(device)
    return svc


def parse_device(device):
    import torch
    return torch.device(device)


def test_service_maps_errors_to_their_prefixes():
    from gsky_tpu_torch.device_guard import DeviceHang

    def full(task):
        raise PoolFullError("task queue full (cap 8)")

    def hung(task):
        raise DeviceHang("watchdog")

    assert _service_with(full).process(
        pb.Task(operation="extent")).error.startswith("backpressure:")
    assert _service_with(hung).process(
        pb.Task(operation="extent")).error.startswith("device:")
    # the elastic fleet's and the cache fabric's ops answer for real,
    # outside the drain gate: page_fetch refused while the fabric's page
    # tier is off, a malformed hand-off refused, a notice accepted
    from gsky_tpu_torch.fleet import elastic
    svc = WorkerService(pool=types.SimpleNamespace(
        size=1, queue=types.SimpleNamespace(maxsize=8), submit=full,
        close=lambda: None, stats=lambda: {"size": 1}), device="cpu")
    svc.drain.start_drain()
    assert svc.process(pb.Task(operation="extent")).error.startswith(
        "draining:")
    assert svc.process(pb.Task(operation="page_fetch")).error == \
        "fabric: page peering disabled"
    assert svc.process(pb.Task(operation="journal_handoff",
                               path="{")).error == \
        "elastic: malformed handoff"
    try:
        res = svc.process(pb.Task(operation="preempt",
                                  path='{"grace_s": 0}'))
        assert not res.error
        assert json.loads(res.info_json) == {"ok": True, "grace_s": 0.0}
        assert svc.preempted
        assert not svc.begin_preemption(5.0)        # the first one wins
    finally:
        faults.set_preempt_handler(None)
        elastic.reset_stats()


def test_oom_monitor_kills_biggest(tmp_path):
    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemTotal: 1000 kB\nMemAvailable: 100 kB\n")
    killed = []
    mon = OOMMonitor(child_pids=lambda: [os.getpid()],
                     threshold_bytes=10 << 20, meminfo_path=str(meminfo),
                     kill=killed.append)
    assert mon.check_once() == os.getpid()
    assert killed == [os.getpid()]


def test_oom_monitor_noop_above_threshold(tmp_path):
    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemAvailable: 8000000 kB\n")
    mon = OOMMonitor(child_pids=lambda: [os.getpid()],
                     threshold_bytes=1 << 20, meminfo_path=str(meminfo),
                     kill=lambda pid: (_ for _ in ()).throw(AssertionError))
    assert mon.check_once() is None


def test_oom_poll_interval_clamps_and_scales():
    from gsky_tpu_torch.worker.oom import MAX_POLL_S, MIN_POLL_S
    mon = OOMMonitor(child_pids=lambda: [], threshold_bytes=0)
    mon._last_avail, mon._last_t = 1 << 30, time.monotonic() - 1.0
    assert mon.poll_interval(2 << 30) == MAX_POLL_S
    mon2 = OOMMonitor(child_pids=lambda: [], threshold_bytes=1 << 30)
    mon2._last_avail = 100 << 30
    mon2._last_t = time.monotonic() - 0.001
    assert mon2.poll_interval((1 << 30) + (1 << 20)) == MIN_POLL_S
    threshold = (8 << 30) - (256 << 20)
    slow = OOMMonitor(child_pids=lambda: [], threshold_bytes=threshold)
    slow._last_avail = (8 << 30) + (64 << 20)
    slow._last_t = time.monotonic() - 1.0
    fast = OOMMonitor(child_pids=lambda: [], threshold_bytes=threshold)
    fast._last_avail = (8 << 30) + (1 << 30)
    fast._last_t = time.monotonic() - 1.0
    assert fast.poll_interval(8 << 30) < slow.poll_interval(8 << 30)


def test_oom_kill_skips_dead_children_and_fires_once(tmp_path):
    meminfo = tmp_path / "meminfo"
    killed, fired = [], []
    dead_pid = 2 ** 22 + 12345
    mon = OOMMonitor(child_pids=lambda: [dead_pid, os.getpid()],
                     threshold_bytes=500 << 20, meminfo_path=str(meminfo),
                     kill=killed.append, on_kill=fired.append)
    meminfo.write_text("MemAvailable: 2000000 kB\n")
    assert mon.check_once() is None
    meminfo.write_text("MemAvailable: 100000 kB\n")
    assert mon.check_once() == os.getpid()
    meminfo.write_text("MemAvailable: 2000000 kB\n")
    assert mon.check_once() is None
    assert killed == fired == [os.getpid()]


# ---------------------------------------------------------------------------
# the port's worker node and the reference's, both over gRPC
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_worker(pool):
    with time_limit(30):
        svc = WorkerService(pool=pool, device="cpu")
        srv = make_server(svc, "127.0.0.1:0").start()
    yield {"addr": f"127.0.0.1:{srv.port}", "svc": svc, "srv": srv}
    srv.stop(grace=1.0)


@pytest.fixture(scope="module")
def ref_worker():
    from gsky_tpu.worker.pool import ProcessPool as JPool
    from gsky_tpu.worker.server import WorkerService as JService
    from gsky_tpu.worker.server import make_grpc_server
    with time_limit(30):
        jp = JPool(size=1, task_timeout=30.0, quiet=True)
        server = make_grpc_server(JService(pool=jp), "127.0.0.1:0")
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
    yield f"127.0.0.1:{port}"
    server.stop(grace=None)
    jp.close()


@pytest.fixture
def clients(port_worker, ref_worker):
    from gsky_tpu.worker import WorkerClient as JClient
    made = []

    def make(which, **kw):
        c = WorkerClient([port_worker["addr"]], **kw) if which == "port" \
            else JClient([ref_worker], **kw)
        made.append(c)
        return c

    yield make
    for c in made:
        c.close()


def test_worker_info(port_worker, clients):
    with time_limit(30):
        c = clients("port")
        infos = c.worker_info()
        assert len(infos) == 1
        assert (infos[0].pool_size, infos[0].platform) == (2, "cpu")
        res = c.process(pb.Task(operation="worker_info"))
        info = json.loads(res.info_json)
        assert info["draining"] is False and info["inflight"] == 0
        assert info["pool"]["size"] == 2
        assert set(info["kernels"]) == {
            "launch_paged_render", "launch_warp_render",
            "launch_masked_stats", "launch_masked_stats_many",
            "launch_first_valid"}
        assert "state" in info["device"]
        assert c.autosize() == 2


def _remote_pair(archive, clients, method, mask, hw=(96, 80), **req_kw):
    """(port remote, port local, reference remote) TileResults of one
    request."""
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    jreq, treq = _requests(archive["root"], ["LC08_B4"], method, mask,
                           hw=hw)
    if req_kw:
        jreq = dataclasses.replace(jreq, **req_kw)
        treq = dataclasses.replace(treq, **req_kw)
    mas = MASClient(archive["tstore"])
    remote = TilePipeline(mas, device="cpu",
                          remote=clients("port")).process(treq)
    local = TilePipeline(mas, device="cpu").process(treq)
    jremote = JTilePipeline(JMASClient(archive["jstore"]),
                            remote=clients("ref")).process(jreq)
    return remote, local, jremote


@pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
def test_remote_masked_tile_equals_local_and_reference(
        archive, clients, jax_b4, method):
    """A masked tile (the local modular route): the remote one equals
    the port's local tile bit for bit and the reference's remote tile
    (nearest bit for bit, else within 2 ulp)."""
    with time_limit(30):
        remote, local, jremote = _remote_pair(
            archive, clients, method, MASKS["bit_tests"])
    _same_result(local, remote)
    _same_result(jremote, remote, nulp=0 if method == "near" else 2)
    assert remote.valid["LC08_B4"].numpy().mean() > 0.2


def test_remote_plain_tile_vs_local_and_reference(archive, clients, jax_b4):
    """An unmasked tile: the local one takes the fused route (its
    control-grid warp), the remote one the workers' gather, as in the
    reference: they agree on all but a few boundary pixels; the remote
    one equals the reference's remote tile bit for bit."""
    with time_limit(30):
        remote, local, jremote = _remote_pair(archive, clients, "near",
                                              None)
    _same_result(jremote, remote)
    lv, rv = local.valid["LC08_B4"].numpy(), remote.valid["LC08_B4"].numpy()
    assert np.mean(lv != rv) < 0.02
    both = lv & rv
    ld, rd = local.data["LC08_B4"].numpy(), remote.data["LC08_B4"].numpy()
    assert np.mean(ld[both] != rd[both]) < 0.02


def test_remote_sub_tiled_and_capped(archive, clients, jax_b4):
    """Sub-tiled RPCs (0.5 of the tile a side) reassemble to the whole
    tile; a ``max_msg`` of 1 MiB shards a 1024 x 1024 tile into RPCs
    under the cap and still matches the reference's capped tile."""
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    with time_limit(30):
        mas = MASClient(archive["tstore"])
        _, treq = _requests(archive["root"], ["LC08_B4"], "near", None)
        whole = TilePipeline(mas, device="cpu",
                             remote=clients("port")).process(treq)
        tiled = TilePipeline(mas, device="cpu",
                             remote=clients("port")).process(
            dataclasses.replace(treq, grpc_tile_x_size=0.5,
                                grpc_tile_y_size=0.5))
        _same_result(whole, tiled)
        small = clients("port", max_msg=1 << 20)
        jreq, big = _requests(archive["root"], ["LC08_B4"], "near", None,
                              hw=(1024, 1024))
        mx, my = small._sub_tile_grid(big)
        assert mx * my * 5 <= (1 << 20) < 1024 * 1024 * 5
        capped = TilePipeline(mas, device="cpu", remote=small).process(big)
        jcapped = JTilePipeline(
            JMASClient(archive["jstore"]),
            remote=clients("ref", max_msg=1 << 20)).process(jreq)
        _same_result(jcapped, capped)


def _hdf4_archive(root):
    """A sinusoidal MODIS-style HDF4 file (two SDS), both stores."""
    from gsky_tpu.geo.crs import CRS_SINU_MODIS
    from gsky_tpu.geo.transform import GeoTransform as JGT
    from gsky_tpu.index.crawler import extract as jextract
    from gsky_tpu.index.store import MASStore as JMASStore
    from gsky_tpu.io.hdf4 import write_hdf4
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    rng = np.random.default_rng(23)
    x0, y0 = CRS_SINU_MODIS.from_lonlat(148.0, -35.0)
    gt = JGT(float(x0), 463.3127, 0.0, float(y0), 0.0, -463.3127)
    p = os.path.join(root, "MOD13Q1.A2020010.h29v12.hdf")
    write_hdf4(p, {"NDVI": rng.uniform(0, 1, (96, 96)).astype(np.float32),
                   "EVI": rng.uniform(2, 3, (96, 96)).astype(np.float32)},
               gt=gt, crs=CRS_SINU_MODIS, compress="deflate")
    jstore, tstore = JMASStore(), MASStore()
    jstore.ingest(jextract(p))
    tstore.ingest(extract(p))
    px = np.array([10, 86], float)
    lon, lat = CRS_SINU_MODIS.to_lonlat(np.repeat(gt.x0 + px * gt.dx, 2),
                                        np.tile(gt.y0 + px * gt.dy, 2))
    ll = (lon.max() - (lon.max() - lon.min()) * 0.9, lat.min(),
          lon.min() + (lon.max() - lon.min()) * 0.9, lat.max())
    return jstore, tstore, ll


def _pair_requests(root, band, ll, hw, t0=None, crs="EPSG:3857",
                   method="near"):
    from gsky_tpu.geo.crs import parse_crs as jparse_crs
    from gsky_tpu.geo.transform import BBox as JBBox
    from gsky_tpu.geo.transform import transform_bbox as jtransform
    from gsky_tpu.pipeline.types import GeoTileRequest as JRequest
    from gsky_tpu_torch.geo.transform import transform_bbox
    jb = jtransform(JBBox(*ll), jparse_crs("EPSG:4326"), jparse_crs(crs))
    tb = transform_bbox(BBox(*ll), parse_crs("EPSG:4326"), parse_crs(crs))
    kw = {} if t0 is None else dict(start_time=t0 - 86400,
                                    end_time=t0 + 86400)
    return (JRequest(collection=root, bands=[band], bbox=jb,
                     crs=jparse_crs(crs), width=hw, height=hw,
                     resample=method, **kw),
            GeoTileRequest(collection=root, bands=[band], bbox=tb,
                           crs=parse_crs(crs), width=hw, height=hw,
                           resample=method, **kw))


def test_remote_hdf4_tile(clients, jax_b4, tmp_path):
    """Registry-format granules (native HDF4, sinusoidal) through the
    workers: band routing by ds_name and the registry decode in the
    subprocess; the remote tile equals the reference's remote tile and
    agrees with the local one."""
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    with time_limit(30):
        root = str(tmp_path)
        jstore, tstore, ll = _hdf4_archive(root)
        jreq, treq = _pair_requests(root, "EVI", ll, 64, t0=1578614400.0)
        mas = MASClient(tstore)
        remote = TilePipeline(mas, device="cpu",
                              remote=clients("port")).process(treq)
        local = TilePipeline(mas, device="cpu").process(treq)
        jremote = JTilePipeline(JMASClient(jstore),
                                remote=clients("ref")).process(jreq)
    assert remote.namespaces == ["EVI"]
    _same_result(jremote, remote)
    rv = remote.valid["EVI"].numpy()
    assert rv.mean() > 0.5
    np.testing.assert_array_equal(local.valid["EVI"].numpy(), rv)
    rd, ld = remote.data["EVI"].numpy(), local.data["EVI"].numpy()
    assert np.mean(~np.isclose(ld[rv], rd[rv], rtol=1e-6)) < 0.02
    assert 2.0 <= rd[rv].min() and rd[rv].max() <= 3.0


def test_remote_geolocated_tile(clients, jax_b4, tmp_path):
    """A curvilinear granule: geo_loc rides the message and the worker
    warps from its scene cache through the geolocation control grid
    (`warp_mosaic_scenes`, B1/B2): equal to the port's local tile."""
    from gsky_tpu.geo.crs import EPSG4326 as JEPSG4326
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.index.crawler import extract as jextract
    from gsky_tpu.index.store import MASStore as JMASStore
    from gsky_tpu.io.netcdf import write_netcdf3
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    with time_limit(30):
        GH, GW = 120, 160
        ii, jj = np.mgrid[0:GH, 0:GW].astype(np.float64)
        lon = 147.0 + 0.004 * jj + 0.0012 * ii
        lat = -34.0 - 0.003 * ii
        data = (1000 + ii * 3 + jj * 7).astype(np.float32)
        root = str(tmp_path / "glw")
        os.makedirs(root)
        p = os.path.join(root, "swath_20200110.nc")
        write_netcdf3(p, {"bt": data, "lon": lon, "lat": lat},
                      np.arange(GW, dtype=np.float64),
                      np.arange(GH, dtype=np.float64), JEPSG4326,
                      nodata=-9999.0)
        jstore, tstore = JMASStore(), MASStore()
        jstore.ingest(jextract(p))
        tstore.ingest(extract(p))
        jreq, treq = _pair_requests(root, "bt", (147.2, -34.35, 147.5,
                                                 -34.15), 96,
                                    crs="EPSG:4326")
        mas = MASClient(tstore)
        remote = TilePipeline(mas, device="cpu",
                              remote=clients("port")).process(treq)
        local = TilePipeline(mas, device="cpu").process(treq)
        jremote = JTilePipeline(JMASClient(jstore),
                                remote=clients("ref")).process(jreq)
    rv = remote.valid["bt"].numpy()
    assert rv.sum() > 1000
    _same_result(local, remote)
    jv = np.asarray(jremote.valid["bt"])
    assert np.mean(jv != rv) < 0.02
    jd = np.asarray(jremote.data["bt"])
    both = jv & rv
    assert np.mean(jd[both] != remote.data["bt"].numpy()[both]) < 0.02


def test_sub_tiled_assembly_when_one_job_per_granule():
    """Footprint pruning can leave one sub-tile RPC per granule; the
    results still assemble into full-tile canvases at their offsets."""
    c = WorkerClient.__new__(WorkerClient)
    c._max_msg = 64 << 20
    calls = []

    def fake_warp(granule, dst_gt, crs, width, height, resample,
                  route_key=None):
        calls.append((dst_gt.x0, dst_gt.y0, width, height))
        d = np.full((height, width), float(granule.band), np.float32)
        return d, np.ones((height, width), bool)

    c.warp = fake_warp

    class _Map:
        @staticmethod
        def map(fn, it):
            return [fn(x) for x in it]

    c._fanout = _Map()
    gt = GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, -1.0)

    def gran(band, poly):
        return Granule(path="p", ds_name="d", namespace="n",
                       base_namespace="n", band=band, time_index=None,
                       timestamp=0.0, srs="EPSG:4326",
                       geo_transform=list(gt.to_gdal()), nodata=None,
                       polygon=poly)

    g1 = gran(1, "POLYGON((10 -10,20 -10,20 -20,10 -20,10 -10))")
    g2 = gran(2, "POLYGON((40 -40,50 -40,50 -50,40 -50,40 -40))")
    req = GeoTileRequest(collection="c", bands=["n"], bbox=gt.bbox(64, 64),
                         crs=parse_crs("EPSG:4326"), width=64, height=64,
                         grpc_tile_x_size=0.5, grpc_tile_y_size=0.5)
    out = c.warp_many([g1, g2], req, "near")
    assert len(calls) == 2
    for k, g in enumerate((g1, g2)):
        d, v = out[k]
        assert d.shape == v.shape == (64, 64)
        assert v.sum() == 32 * 32
        assert d[v].min() == d[v].max() == float(g.band)
    assert out[0][1][:32, :32].all()
    assert out[1][1][32:, 32:].all()


# ---------------------------------------------------------------------------
# the info, extent and drill ops; the crawler's -rpc
# ---------------------------------------------------------------------------


def test_info_op(archive, clients):
    from gsky_tpu_torch.index.crawler import extract
    with time_limit(30):
        tif = archive["paths"][0][0]
        info = json.loads(clients("port").info(tif))
    assert info == json.loads(json.dumps(extract(tif)))
    assert info["filename"] == tif and info["geo_metadata"]


def test_extent_op_equals_the_reference(archive, clients):
    from gsky_tpu.geo.crs import EPSG3857 as JEPSG3857
    from gsky_tpu.pipeline.types import Granule as JGranule
    with time_limit(30):
        _, g = _tif_granule(archive)
        w, h = clients("port").extent(g, parse_crs("EPSG:3857"))
        jw, jh = clients("ref").extent(JGranule(**dataclasses.asdict(g)),
                                       JEPSG3857)
    assert (w, h) == (jw, jh) and w > 0 and h > 0


def _drill_stack(root):
    """A 6-step NetCDF stack (EPSG:4326, nodata -1), both packages'
    records of it."""
    from gsky_tpu.geo.crs import EPSG4326 as JEPSG4326
    from gsky_tpu.io.netcdf import write_netcdf3
    from gsky_tpu_torch.index.crawler import extract
    rng = np.random.default_rng(7)
    x = np.linspace(147.5, 149.5, 96)
    y = np.linspace(-34.5, -36.5, 80)
    times = 1578614400.0 + 86400.0 * np.arange(6)
    fc = rng.uniform(0, 100, (6, 80, 96)).astype(np.float32)
    fc[:, :10, :10] = -1.0
    fc[2, 30:50, 40:60] = -1.0
    p = os.path.join(root, "fc_2020.nc")
    write_netcdf3(p, {"phot_veg": fc}, x, y, JEPSG4326, times=times,
                  nodata=-1.0)
    return p, extract(p)["geo_metadata"][0]


@pytest.mark.parametrize("deciles", [False, True])
def test_drill_op_equals_the_reference(clients, tmp_path, deciles):
    """The worker's drill op (`pipeline.drill.drill_file`, kernel B3's
    plain version here) against the reference worker's, rtol 1e-5."""
    with time_limit(30):
        path, ds = _drill_stack(str(tmp_path))
        results = []
        for which, mod in (("port", pb), ("ref", jpb)):
            task = mod.Task(operation="drill")
            task.granule.path = path
            task.granule.ds_name = ds["ds_name"]
            task.granule.namespace = "phot_veg"
            task.granule.srs = "EPSG:4326"
            task.granule.geo_transform.extend(ds["geotransform"])
            task.granule.array_type = ds["array_type"]
            task.granule.nodata = -1.0
            task.granule.has_nodata = True
            task.drill.geometry_wkt = (
                "POLYGON((147.9 -35.9,149.1 -35.9,149.1 -34.9,"
                "147.9 -34.9,147.9 -35.9))")
            task.drill.time_indices.extend([0, 1, 2, 3, 4, 5])
            task.drill.deciles = deciles
            res = clients(which).process(task)
            assert not res.error, res.error
            results.append(res.series)
    got, want = results
    assert list(got.counts) == list(want.counts) and min(got.counts) > 0
    np.testing.assert_allclose(got.means, want.means, rtol=1e-5)
    np.testing.assert_allclose(got.deciles, want.deciles, rtol=1e-5)
    assert len(got.deciles) == (6 * 9 if deciles else 0)


def test_crawler_rpc_mode(archive, port_worker, capsys):
    from gsky_tpu_torch.index.crawler import extract, main
    with time_limit(30):
        tif = archive["paths"][0][0]
        assert main(["-fmt", "json", "-rpc", port_worker["addr"], tif]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec == json.loads(json.dumps(extract(tif)))
    assert rec["filename"] == tif and rec["geo_metadata"]


# ---------------------------------------------------------------------------
# lifecycle, cancellation, backpressure, the carrier
# ---------------------------------------------------------------------------


def test_client_close_idempotent_then_dispatch_raises(port_worker):
    with time_limit(30):
        c = WorkerClient([port_worker["addr"]])
        assert c.worker_info()
        c.close()
        c.close()
        with pytest.raises(BackendUnavailable):
            c.process(pb.Task(operation="worker_info"))


def test_dispatch_refuses_new_attempts_after_cancel(port_worker):
    reset_cancel_stats()
    with time_limit(30):
        c = WorkerClient([port_worker["addr"]])
        try:
            with cancel_scope() as tok:
                tok.cancel("client-disconnect")
                with pytest.raises(RequestCancelled):
                    c._dispatch(pb.Task(operation="worker_info"), None)
            assert c.fleet.load_of(port_worker["addr"]) == 0
        finally:
            c.close()
            reset_cancel_stats()


def test_inflight_rpc_future_cancelled_by_token():
    reset_cancel_stats()

    class FakeFuture:
        def __init__(self):
            self._ev = threading.Event()
            self.cancelled_ = False

        def cancel(self):
            self.cancelled_ = True
            self._ev.set()

        def result(self):
            self._ev.wait(5.0)
            if self.cancelled_:
                raise grpc.FutureCancelledError()
            return pb.Result()

    class FakeStub:
        def __init__(self):
            self.fut = FakeFuture()

        def future(self, task, timeout=None, metadata=None):
            return self.fut

    c = WorkerClient.__new__(WorkerClient)
    stub = FakeStub()
    with cancel_scope() as tok:
        threading.Timer(0.05, tok.cancel, ("disconnect",)).start()
        t0 = time.monotonic()
        with pytest.raises(RequestCancelled):
            c._call_cancellable(stub, pb.Task(operation="warp"), 1.0,
                                None, tok)
        assert time.monotonic() - t0 < 2.0
        assert stub.fut.cancelled_
    reset_cancel_stats()


def test_worker_server_skips_warp_for_departed_client(pool):
    class DeadCtx:
        def invocation_metadata(self):
            return ()

        def is_active(self):
            return False

    svc = WorkerService(pool=pool, device="cpu")
    res = svc.process(pb.Task(operation="warp"), DeadCtx())
    assert res.error.startswith("cancelled:")


def test_cancelled_rpc_closes_its_connection_and_the_warp_is_skipped(
        archive, port_worker):
    """A real cancellation: the token fires while the worker decodes
    (held 1 s by a pool latency fault); the caller unwinds at once, gRPC
    cancels the call, and the worker sees its client gone
    (``is_active()`` False) before the warp (`WarpExecutor.warp_all` is
    not called)."""
    svc = port_worker["svc"]
    warps = []
    orig = svc.executor.warp_all
    svc.executor.warp_all = lambda *a, **k: warps.append(1) or orig(*a, **k)
    c = WorkerClient([port_worker["addr"]])
    reset_cancel_stats()
    try:
        with time_limit(30):
            _, g = _tif_granule(archive)
            faults.configure("pool:latency:1s")
            task = pb.Task(operation="warp")
            task.granule.CopyFrom(granule_to_pb(g))
            gt = GeoTransform.from_gdal(g.geo_transform)
            task.dst.srs = g.srs
            task.dst.geo_transform.extend(gt.to_gdal())
            task.dst.width = task.dst.height = 64
            with cancel_scope() as tok:
                threading.Timer(0.2, tok.cancel, ("disconnect",)).start()
                t0 = time.monotonic()
                with pytest.raises(RequestCancelled):
                    c._call_cancellable(c._stubs[0], task, 10.0, None, tok)
                assert time.monotonic() - t0 < 0.9
            deadline = time.monotonic() + 5.0
            while svc.drain.inflight and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.2)
        assert warps == []
    finally:
        faults.reset()
        svc.executor.warp_all = orig
        c.close()
        reset_cancel_stats()


class _Busy:
    """A service that answers every op as a full pool does."""

    def process(self, task, ctx=None):
        return pb.Result(error="backpressure: worker task queue full")


def test_node_busy_is_retryable_and_failed_over():
    from gsky_tpu_torch.resilience import is_retryable
    assert NodeBusy("x").retryable and is_retryable(NodeBusy("x"))
    with time_limit(30):
        srv = make_server(_Busy(), "127.0.0.1:0").start()
        c = WorkerClient([f"127.0.0.1:{srv.port}"])
        try:
            with pytest.raises(NodeBusy):
                c.process(pb.Task(operation="extent"))
            # warp retries NodeBusy with backoff, then gives up
            with pytest.raises(BackendUnavailable) as e:
                c.warp(GRANULES[0], GeoTransform(0, 1, 0, 0, 0, -1),
                       parse_crs("EPSG:4326"), 8, 8)
            assert isinstance(e.value.__cause__, NodeBusy)
            assert c.fleet.monitor.healthy(f"127.0.0.1:{srv.port}")
        finally:
            c.close()
            srv.stop(grace=1.0)


class _Echo:
    """A service that answers with a raster of the requested size after
    ``delay`` seconds."""

    def __init__(self, delay=0.0):
        self.delay = delay

    def process(self, task, ctx=None):
        time.sleep(self.delay)
        return pb.Result(raster=b"\x01" * task.dst.width)


@contextlib.contextmanager
def _dead_port():
    """A port bound by a socket that does not listen: a connection to it
    is refused, and no server can take it meanwhile (the socket has no
    ``SO_REUSEPORT``, so a gRPC server's ``so_reuseport`` cannot share
    it)."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    try:
        yield s.getsockname()[1]
    finally:
        s.close()


STATUS_CASES = ["UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED-send",
                "RESOURCE_EXHAUSTED-receive", "RESOURCE_EXHAUSTED-client-send",
                "RESOURCE_EXHAUSTED-client-receive", "UNIMPLEMENTED",
                "CANCELLED"]


@pytest.mark.parametrize("case", STATUS_CASES)
def test_carrier_maps_grpc_status_codes(case):
    """gRPC's own statuses as the port's client meets them: a dead node
    ``UNAVAILABLE`` (fatal for the node), a slow one past the timeout
    ``DEADLINE_EXCEEDED``, a request or an answer over ``max_msg``
    ``RESOURCE_EXHAUSTED`` (the server's cap, or the client's own that
    `dial` sets on its channel), another method ``UNIMPLEMENTED``, a
    cancelled call ``CANCELLED``; only ``UNAVAILABLE`` is fatal."""
    from gsky_tpu_torch.worker.client import dial
    client_cap = "-client-" in case
    with time_limit(30), contextlib.ExitStack() as stack:
        srv = make_server(_Echo(delay=2.0 if case in (
            "DEADLINE_EXCEEDED", "CANCELLED") else 0.0),
            "127.0.0.1:0",
            **({} if client_cap else {"max_msg": 4096})).start()
        stack.callback(srv.stop, None)
        addr = f"127.0.0.1:{srv.port}"
        if case == "UNAVAILABLE":
            addr = f"127.0.0.1:{stack.enter_context(_dead_port())}"
        ch, call = dial(addr, max_msg=4096 if client_cap else 1 << 20)
        stack.callback(ch.close)
        t = pb.Task(operation="x")
        t.dst.width = 100
        timeout = 5.0
        if case == "DEADLINE_EXCEEDED":
            timeout = 0.3
        elif case.endswith("-send"):
            t.path = "p" * 5000                 # the request: over 4096
        elif case.endswith("-receive"):
            t.dst.width = 5000                  # the answer: over 4096
        if case == "UNIMPLEMENTED":
            call = ch.unary_unary(
                METHOD.replace("Process", "Other"),
                request_serializer=pb.Task.SerializeToString,
                response_deserializer=pb.Result.FromString)
        if case == "CANCELLED":
            fut = call.future(t, timeout=timeout)
            time.sleep(0.2)
            assert fut.cancel()
            with pytest.raises(grpc.FutureCancelledError):
                fut.result()
            assert fut.code() == grpc.StatusCode.CANCELLED
            assert not WorkerClient._is_fatal(fut)
            return
        if case.startswith("RESOURCE_EXHAUSTED"):
            ok = pb.Task(operation="x")         # under the caps: answered
            ok.dst.width = 100
            assert len(call(ok, timeout=5.0).raster) == 100
        with pytest.raises(grpc.RpcError) as e:
            call(t, timeout=timeout)
    code = case.split("-")[0]
    assert e.value.code() == getattr(grpc.StatusCode, code)
    assert WorkerClient._is_fatal(e.value) == (code == "UNAVAILABLE")


class _Gate:
    """A service whose every call waits for ``n`` calls to be inside it
    at once (a barrier): it answers only if they run concurrently."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=10.0)

    def process(self, task, ctx=None):
        self.barrier.wait()
        return pb.Result(raster=b"\x01")


def test_one_channel_runs_conc_per_node_rpcs_at_once():
    """One HTTP/2 channel a node carries `CONC_PER_NODE` RPCs at once:
    each waits inside the server until all have arrived."""
    from gsky_tpu_torch.worker.client import CONC_PER_NODE
    with time_limit(30):
        srv = make_server(_Gate(CONC_PER_NODE), "127.0.0.1:0").start()
        c = WorkerClient([f"127.0.0.1:{srv.port}"])
        try:
            futs = [c._stubs[0].future(pb.Task(operation="x"), timeout=15.0)
                    for _ in range(CONC_PER_NODE)]
            assert all(f.result().raster == b"\x01" for f in futs)
            assert len(c._channels) == 1
        finally:
            c.close()
            srv.stop(None)


def test_a_revived_node_is_redialled():
    """A node that dies and comes back on its address is reached again
    on the same channel within seconds (the reconnect backoff is capped
    at 3 s), not after gRPC's default backoff of up to 2 minutes.  The
    address stays held meanwhile by a socket that shares it
    (``SO_REUSEPORT``) but does not listen: a connection is refused,
    and no other server can take the port."""
    import socket
    hold = socket.socket()
    hold.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    hold.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{hold.getsockname()[1]}"
    t = pb.Task(operation="x")
    t.dst.width = 3
    with time_limit(30), contextlib.ExitStack() as stack:
        stack.callback(hold.close)
        c = WorkerClient([addr])
        stack.callback(c.close)
        srv = make_server(_Echo(), addr).start()
        assert len(c._stubs[0](t, timeout=5.0).raster) == 3
        srv.stop(None)
        with pytest.raises(grpc.RpcError) as e:
            c._stubs[0](t, timeout=5.0)
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        time.sleep(2.0)               # the channel backs off meanwhile
        srv = make_server(_Echo(), addr).start()
        stack.callback(srv.stop, None)
        t0 = time.monotonic()
        while True:
            try:
                assert len(c._stubs[0](t, timeout=1.0).raster) == 3
                break
            except grpc.RpcError:
                assert time.monotonic() - t0 < 6.0
                time.sleep(0.1)


def test_make_server_raises_when_it_cannot_bind():
    """A port another socket holds without ``SO_REUSEPORT`` cannot be
    bound (``so_reuseport`` shares a port only with its like): the
    server raises, it does not fall back to another port or carrier."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    try:
        with pytest.raises(RuntimeError):
            make_server(_Echo(), f"127.0.0.1:{s.getsockname()[1]}")
    finally:
        s.close()


def test_no_grpc_no_carrier():
    """Without ``grpc`` the worker package does not import: there is no
    other carrier to fall back to."""
    import sys
    with time_limit(60):
        r = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.modules['grpc'] = None; "
             "import gsky_tpu_torch.worker"],
            cwd=REPO, capture_output=True, text=True, timeout=55)
    assert r.returncode != 0
    assert "ModuleNotFoundError" in r.stderr and "grpc" in r.stderr


def test_worker_fault_site_fails_over_and_counts(port_worker):
    from gsky_tpu_torch.resilience import registry
    from gsky_tpu_torch import resilience
    resilience.reset()
    c = WorkerClient([port_worker["addr"]])
    try:
        with time_limit(30):
            faults.configure("worker:error:1.0")
            with pytest.raises(BackendUnavailable):
                c.process(pb.Task(operation="extent"))
            assert registry.stats()["faults_injected"].get("worker", 0) \
                >= 1
            faults.configure("node:error:1.0")
            res = c.process(pb.Task(operation="worker_info"))
            assert "InjectedFault" in res.error
    finally:
        faults.reset()
        c.close()
        resilience.reset()


def test_trace_hop_and_rpc_seconds(archive, port_worker):
    """The trace crosses the hop as gRPC metadata (``x-gsky-trace``):
    the worker's spans come back and join the caller's trace under its rpc.worker
    span; gsky_worker_rpc_seconds counts the call by op and outcome."""
    from gsky_tpu_torch import obs
    c = WorkerClient([port_worker["addr"]])
    try:
        with time_limit(30):
            before = _rpc_count(obs)
            _, g = _tif_granule(archive)
            gt = GeoTransform.from_gdal(g.geo_transform)
            with obs.start_trace("ows.request", path="/ows") as tr:
                out = c.warp(g, gt, parse_crs(g.srs), 64, 64)
            assert out is not None
            names = {s["name"] for s in tr.span_dicts()}
            assert {"rpc.worker", "worker.warp", "worker.decode",
                    "worker.dispatch", "worker.readback"} <= names
            assert _rpc_count(obs) == before + 1
            assert "gsky_fleet_routed_total" in \
                obs.parse_exposition(obs.render_metrics())
    finally:
        c.close()


def _rpc_count(obs):
    fam = obs.parse_exposition(obs.render_metrics()).get(
        "gsky_worker_rpc_seconds")
    for (name, labels), v in (fam or {"samples": {}})["samples"].items():
        if name.endswith("_count") and dict(labels) == {
                "op": "warp", "outcome": "ok"}:
            return v
    return 0.0


# ---------------------------------------------------------------------------
# across the packages: each package's client against the other's worker
# ---------------------------------------------------------------------------


def _same_jax_result(a, b, nulp=0):
    """Two reference TileResults equal: namespaces and counts, valid
    exact, data within ``nulp``."""
    assert a.namespaces == b.namespaces
    assert (a.granule_count, a.file_count) == (b.granule_count, b.file_count)
    for ns in a.namespaces:
        np.testing.assert_array_equal(np.asarray(a.valid[ns]),
                                      np.asarray(b.valid[ns]))
        _close(np.asarray(a.data[ns], np.float32),
               np.asarray(b.data[ns], np.float32), nulp)


def _drill_task(mod, path, ds, deciles=True):
    task = mod.Task(operation="drill")
    task.granule.path = path
    task.granule.ds_name = ds["ds_name"]
    task.granule.namespace = "phot_veg"
    task.granule.srs = "EPSG:4326"
    task.granule.geo_transform.extend(ds["geotransform"])
    task.granule.array_type = ds["array_type"]
    task.granule.nodata = -1.0
    task.granule.has_nodata = True
    task.drill.geometry_wkt = (
        "POLYGON((147.9 -35.9,149.1 -35.9,149.1 -34.9,"
        "147.9 -34.9,147.9 -35.9))")
    task.drill.time_indices.extend([0, 1, 2, 3, 4, 5])
    task.drill.deciles = deciles
    return task


def _ref_op(op, archive, client, tmp_path):
    """What the reference's ``client`` answers for ``op``."""
    from gsky_tpu.geo.crs import EPSG3857 as JEPSG3857
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    from gsky_tpu.pipeline.types import Granule as JGranule
    if op == "info":
        return json.loads(client.info(archive["paths"][0][0]))
    if op == "extent":
        _, g = _tif_granule(archive)
        return client.extent(JGranule(**dataclasses.asdict(g)), JEPSG3857)
    if op == "drill":
        path, ds = _drill_stack(str(tmp_path))
        res = client.process(_drill_task(jpb, path, ds))
        assert not res.error, res.error
        return res.series
    method = op.split("-")[1]
    jreq, _ = _requests(archive["root"], ["LC08_B4"], method,
                        MASKS["bit_tests"], hw=(96, 80))
    return JTilePipeline(JMASClient(archive["jstore"]),
                         remote=client).process(jreq)


@pytest.mark.parametrize("op", ["info", "extent", "masked-near",
                                "masked-cubic", "drill"])
def test_reference_client_gets_the_same_from_a_port_worker(
        archive, port_worker, ref_worker, jax_b4, tmp_path, op):
    """The reference's gRPC `WorkerClient` against a port worker answers
    what it answers against its own: ``info`` and ``extent`` equal, a
    masked remote tile (B4 on the reference's side) nearest bit for bit
    and cubic within 2 ulp, the drill's counts equal and its means and
    deciles within rtol 1e-5."""
    from gsky_tpu.worker import WorkerClient as JClient
    with time_limit(30):
        got, want = [], []
        for addr, out in ((port_worker["addr"], got), (ref_worker, want)):
            c = JClient([addr])
            try:
                out.append(_ref_op(op, archive, c, tmp_path))
            finally:
                c.close()
    got, want = got[0], want[0]
    if op == "drill":
        assert list(got.counts) == list(want.counts) and min(got.counts) > 0
        np.testing.assert_allclose(got.means, want.means, rtol=1e-5)
        np.testing.assert_allclose(got.deciles, want.deciles, rtol=1e-5)
        assert len(got.deciles) == 6 * 9
    elif op.startswith("masked"):
        _same_jax_result(want, got, nulp=0 if op == "masked-near" else 2)
        assert np.asarray(got.valid["LC08_B4"]).mean() > 0.2
    else:
        assert got == want


@pytest.mark.parametrize("op", ["worker_info", "info", "extent",
                                "masked-near", "masked-cubic", "drill"])
def test_port_client_against_a_reference_worker(
        archive, port_worker, ref_worker, jax_b4, tmp_path, op):
    """The port's `WorkerClient` against the reference's gRPC worker:
    the pool's size from ``worker_info``; ``info`` and ``extent`` what
    the reference's client gets from it; a masked remote tile (the
    warps the reference worker's, B4 the port's plain version) equal to
    the reference's remote tile bit for bit; the drill equal to the
    reference's own answer."""
    from gsky_tpu.worker import WorkerClient as JClient
    with time_limit(30):
        c = WorkerClient([ref_worker])
        jc = JClient([ref_worker])
        try:
            if op == "worker_info":
                infos = c.worker_info()
                assert [i.pool_size for i in infos] == [1]
                assert c.autosize() == 1
                return
            if op == "info":
                assert json.loads(c.info(archive["paths"][0][0])) == \
                    _ref_op(op, archive, jc, tmp_path)
                return
            if op == "extent":
                _, g = _tif_granule(archive)
                w, h = c.extent(g, parse_crs("EPSG:3857"))
                assert (w, h) == _ref_op(op, archive, jc, tmp_path)
                return
            if op == "drill":
                path, ds = _drill_stack(str(tmp_path))
                res = c.process(_drill_task(pb, path, ds))
                assert not res.error, res.error
                want = jc.process(_drill_task(jpb, path, ds)).series
                assert list(res.series.counts) == list(want.counts)
                np.testing.assert_allclose(res.series.means, want.means,
                                           rtol=1e-5)
                np.testing.assert_allclose(res.series.deciles,
                                           want.deciles, rtol=1e-5)
                return
            method = op.split("-")[1]
            _, treq = _requests(archive["root"], ["LC08_B4"], method,
                                MASKS["bit_tests"], hw=(96, 80))
            remote = TilePipeline(MASClient(archive["tstore"]), device="cpu",
                                  remote=c).process(treq)
            _same_result(_ref_op(op, archive, jc, tmp_path), remote)
            assert remote.valid["LC08_B4"].numpy().mean() > 0.2
        finally:
            c.close()
            jc.close()


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_page_fetch_across_packages(port_worker, ref_worker, monkeypatch,
                                    direction):
    """The page RPC between the packages: one package's fetch against
    the other's worker, both serving the same staged pages (the
    reference's pool and the port's copy of it), keeps every page the
    peer holds, each equal byte for byte to the pool's."""
    from gsky_tpu.fabric import pagerpc as jpagerpc
    from gsky_tpu.pipeline import pages as jpages
    from gsky_tpu_torch.fabric import pagerpc as tpagerpc
    from test_torch_fabric import WANT, _staged_pair
    jp, tp = _staged_pair()
    monkeypatch.setenv("GSKY_FABRIC", "1")
    monkeypatch.setattr(jpages, "_default", jp)
    monkeypatch.setattr(port_worker["svc"].executor, "pool", tp)
    keys = [tuple(k) for k in WANT if len(k) == 3]
    with time_limit(30):
        if direction == "port-to-reference":
            got = tpagerpc._rpc_fetch(ref_worker, keys, 8 << 20, 10.0)
        else:
            got = jpagerpc._grpc_fetch(port_worker["addr"], keys, 8 << 20,
                                       10.0)
    assert len(got) == 4
    for key, page in got.items():
        assert np.asarray(page).tobytes() == tp.read_page(*key).tobytes()


def test_control_rpc_against_a_reference_worker(ref_worker):
    """`fleet.elastic.control_rpc` (``worker_info``) against the
    reference's worker: its info document, as the reference's own
    control RPC reads it."""
    from gsky_tpu.fleet import elastic as jelastic
    from gsky_tpu_torch.fleet import elastic as telastic
    with time_limit(30):
        got = telastic.control_rpc(ref_worker, "worker_info")
        want = jelastic.control_rpc(ref_worker, "worker_info")
    assert got["draining"] is False and got.keys() == want.keys()
    assert got["pool"]["size"] == want["pool"]["size"] == 1


@pytest.mark.parametrize("direction", ["reference-client-port-worker",
                                       "port-client-reference-worker"])
def test_trace_crosses_packages(archive, port_worker, ref_worker,
                                direction):
    """A trace crosses the wire between the packages as ``x-gsky-trace``
    metadata: the worker continues it, and its spans (``worker.warp``
    and the decode and dispatch in it) join the caller's trace under the
    span that made the call."""
    with time_limit(30):
        _, g = _tif_granule(archive)
        if direction.startswith("reference"):
            from gsky_tpu import obs
            from gsky_tpu.geo.crs import parse_crs as jparse_crs
            from gsky_tpu.geo.transform import GeoTransform as JGT
            from gsky_tpu.pipeline.types import Granule as JGranule
            from gsky_tpu.worker import WorkerClient as JClient
            c = JClient([port_worker["addr"]])
            args = (JGranule(**dataclasses.asdict(g)),
                    JGT.from_gdal(g.geo_transform), jparse_crs(g.srs))
        else:
            from gsky_tpu_torch import obs
            c = WorkerClient([ref_worker])
            args = (g, GeoTransform.from_gdal(g.geo_transform),
                    parse_crs(g.srs))
        try:
            with obs.start_trace("ows.request", path="/ows") as tr:
                out = c.warp(*args, 64, 64)
        finally:
            c.close()
    assert out is not None and np.asarray(out[1]).any()
    spans = tr.span_dicts()
    names = {s["name"] for s in spans}
    assert {"rpc.worker", "worker.warp", "worker.decode",
            "worker.dispatch"} <= names
    # the metadata is taken as the dispatch starts: the worker's root
    # hangs under the span that called, here the trace's root
    root = next(s for s in spans if s["name"] == "ows.request")
    warp = next(s for s in spans if s["name"] == "worker.warp")
    assert warp["parent_id"] == root["span_id"]
    assert warp["process"] == "worker" and root["process"] != "worker"
