"""The port's soak, `tools/soak_torch.py`, on the CPU.

Every scenario runs in-process with ``device="cpu"`` (the kernels' plain
versions) over one small archive (four 512 x 512 scenes) for a few
seconds, and passes.  Each check bites: an executor cache that never
evicts and a scene cache that ignores its ``max_bytes`` fail ``churn``
(the executor's bound and the tool's are lowered together so that a
few seconds reach them), a handler that answers a bare 500 fails
``chaos``, a pin never released fails ``wave``.  The faults the soak
found on the card stay repaired: a 503 for too many failed granules
carries ``Retry-After`` (C.21), a served wave entry leaves no
reference cycle (which kept evicted scenes on the card), and the
server's process hands freed multi-MiB buffers back to the OS.

Parity: a seeded sample of each scenario's requests (churn GetMaps, the
hot grid, a GetCoverage, the wave's drill, ``dap4.ce`` subsets) goes to
the port's server and to the JAX package's over the same archive and
config (the reference with Pallas in interpret mode, its serial GetMap
ladder, waves and the batcher off, as `tests/test_torch_server.py` runs
it).  Nearest tiles decode to identical RGBA; GeoTIFF and DAP4 bodies
decode to identical values; drills agree within rtol 1e-5.

Child processes: the tool imported with ``jax``, ``gsky_tpu`` and
``bench`` blocked runs ``--help`` and a short churn under
``GSKY_TSAN=1``; ``--device cuda`` without CUDA exits non-zero naming
CUDA.  Every wait has a timeout (`time_limit`, SIGALRM; the children's
``timeout``)."""

import gc
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.geotiff import GeoTIFF as JGeoTIFF
from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher
from gsky_tpu.server.metrics import MetricsLogger as JMetricsLogger
from gsky_tpu.server.ows import OWSServer as JOWSServer

from gsky_tpu_torch import resilience
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.io.png import decode_png
from gsky_tpu_torch.pipeline import executor as texecutor
from gsky_tpu_torch.pipeline.pages import PagePool
from gsky_tpu_torch.pipeline.scene_cache import SceneCache
from gsky_tpu_torch.pipeline.waves import reset_waves
from gsky_tpu_torch.server import dap4
from gsky_tpu_torch.server.ows import OWSServer

from test_torch_dap4 import _chunks
from test_torch_server import _JaxClient
from test_torch_worker import time_limit
from test_torch_wps import _same_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import soak_torch as st  # noqa: E402

SHAPE = (512, 512)
SECONDS = dict.fromkeys(st.SCENARIOS, 2)
LIMIT_S = 120               # any one test's wall time
HOST = "soak.invalid"


def soak_args(seconds, *extra):
    return st.parse_args(["--device", "cpu", "--seconds", str(seconds),
                          "--conc", "4", *extra])


@pytest.fixture(scope="module")
def senv(tmp_path_factory):
    env = st.SoakEnv(str(tmp_path_factory.mktemp("soak")), 4, SHAPE,
                     "cpu")
    yield env
    env.close()


@pytest.fixture
def fresh(senv):
    """Process-wide state cleared around a scenario: the resilience
    counters, breakers and fault plan, the wave schedulers; a new MAS
    client (its breaker in the cleared registry); the scenario's
    servers closed after it."""
    resilience.reset()
    reset_waves()
    senv.mas = MASClient(senv.store)
    yield
    senv.close()
    reset_waves()
    resilience.reset()


def run(senv, name, seconds=None):
    with time_limit(LIMIT_S):
        return st.RUNS[name](senv, soak_args(seconds or SECONDS[name]))


# -- every scenario passes -------------------------------------------------

@pytest.mark.parametrize("name", [n for n in st.SCENARIOS if n not in (
    "hot", "overload", "ingest", "fleet",       # soak_ops, soak_fleet
    "occupancy", "algebra", "animation",        # soak_waves
    "fabric", "elastic")])                      # soak_fabric, _elastic
def test_scenario_passes(senv, fresh, name):
    out, ok = run(senv, name)
    assert ok, json.dumps(out)[:4000]
    assert out["scenario"] == name and out["device"] == "cpu"
    if name in ("churn", "wcs", "dap4"):
        # the RSS bound applies; the card's only on a card
        assert out["memory"]["ok"] and "device" not in out["memory"]


def test_hot_scenario(senv, fresh):
    """Every criterion of ``hot`` but tracing's cost: no failed request,
    the gateway's hit rate over 0.3, a strict ``/metrics``, the slowest
    trace reported, and tracing's cost measured in turns over the hit
    path.  Its verdict against the 2% bound is not asserted: on a shared
    CPU host the traced / untraced p50 of this in-process measurement
    spreads wider than the bound (-9.36% to +17.05% over five runs of
    the same tree), and the verdict with it (ROADMAP C.22)."""
    out, ok = run(senv, "hot")
    tr = out["trace_overhead"]
    assert out["baseline"]["failed"] == out["gateway"]["failed"] == 0
    assert tr["untraced"]["failed"] == tr["traced"]["failed"] == 0
    assert tr["untraced"]["requests"] > 0 and tr["traced"]["requests"] > 0
    assert out["gateway"]["hit_rate"] > 0.3
    assert not out["metrics"]["missing"]
    assert out["slowest_trace"]["critical_path"]
    assert ok is tr["ok"], json.dumps(out)[:4000]


# -- the checks bite ---------------------------------------------------------

@pytest.mark.parametrize("evicts", [True, False],
                         ids=["bounded", "never_evicts"])
def test_churn_holds_the_executor_cache(senv, fresh, monkeypatch, evicts):
    """The geo cache at the tool's bound (both lowered to 8) passes; an
    executor cache that never evicts fails."""
    monkeypatch.setattr(st, "GEO_CACHE_MAX", 8)
    monkeypatch.setattr(texecutor.WarpExecutor, "_GEO_CACHE_MAX",
                        8 if evicts else 1 << 40)
    out, ok = run(senv, "churn", 2)
    assert ok is evicts, json.dumps(out)[:2000]
    assert (out["caches"]["geo_cache"] <= 8) is evicts
    assert out["requests_failed"] == 0


class _IgnoresMaxBytes(SceneCache):
    """A scene cache whose configured ``max_bytes`` its eviction never
    reads."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._bound = self._max_bytes
        self._max_bytes = 1 << 62

    @property
    def max_bytes(self):
        return self._bound


@pytest.mark.parametrize("cache", [SceneCache, _IgnoresMaxBytes],
                         ids=["evicts", "ignores_max_bytes"])
def test_churn_holds_the_scene_cache(senv, fresh, monkeypatch, cache):
    """A budget of two and a half scenes over four dates: the cache
    evicts and stays within it; one that ignores its budget fails."""
    scene = 512 * 512 * 4
    monkeypatch.setattr(
        texecutor, "SceneCache",
        lambda device="cuda": cache(max_bytes=int(2.5 * scene),
                                    device=device))
    out, ok = run(senv, "churn", 2)
    bounded = cache is SceneCache
    assert ok is bounded, json.dumps(out)[:2000]
    assert out["scene_cache_max_bytes"] == int(2.5 * scene)
    assert (out["scene_cache_bytes"] <= out["scene_cache_max_bytes"]) \
        is bounded
    if bounded:
        assert out["scene_cache"]["evictions"] > 0


def test_chaos_fails_on_a_bare_500(senv, fresh, monkeypatch):
    def broken(self, *a, **k):
        raise RuntimeError("planted: an unhandled error")

    monkeypatch.setattr(OWSServer, "serve_wcs", broken)
    out, ok = run(senv, "chaos", 2)
    assert not ok
    assert out["responses"].get("hard_5xx", 0) > 0
    assert any(h.startswith("500 ") for h in out["hard_answers"])


def test_chaos_refusals_say_when_to_retry(senv, fresh):
    """C.21: a tile whose every granule fails to decode answers OGC 503
    ServerBusy with Retry-After (the reference sends none)."""
    from gsky_tpu_torch.resilience import faults
    srv, host = senv.server(gateway=None)
    faults.configure("decode:error:1.0", seed=1)
    try:
        with time_limit(LIMIT_S):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    senv.getmap(host, "landsat_chaos", 0.3, 0.5,
                                senv.unit * 0.25, senv.dates[0]),
                    timeout=60)
    finally:
        faults.configure(None)
    e = err.value
    body = e.read()
    assert e.code == 503 and b'exceptionCode="ServerBusy"' in body
    assert e.headers["Retry-After"] == "5"


def test_wave_fails_on_a_pin_never_released(senv, fresh, monkeypatch):
    monkeypatch.setattr(PagePool, "unpin", lambda self, slots: None)
    out, ok = run(senv, "wave", 1)
    assert not ok
    assert out["pool_pinned"] > 0


def test_wave_entries_leave_no_reference_cycle(senv, fresh):
    """A tile's wave entry is freed by reference counting once served.
    Its per-call leg used to close over the entry itself: the cycle kept
    the lane's scenes alive until the cyclic collector ran, and on the
    card the churn's ``memory_allocated`` grew by gigabytes a minute
    with scenes the cache had evicted."""
    _, host = senv.server(gateway=None)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with time_limit(LIMIT_S):
            for i in range(6):
                assert st.fetch_png(senv.churn_url(host, i, 0.1 * i, 0.3))
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        left = [type(o).__name__ for o in gc.garbage
                if type(o).__name__ in ("_Entry", "BucketedLane")
                or torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if enabled:
            gc.enable()
    assert left == []


# -- parity with the JAX package ------------------------------------------

@pytest.fixture(scope="module")
def pair(senv, tmp_path_factory):
    """The reference's server over the soak's archive (its crawler, the
    same namespaces) and config, and the port's over HTTP."""
    mp = pytest.MonkeyPatch()
    tmp = str(tmp_path_factory.mktemp("soak_ref"))
    for k, v in (("GSKY_TILE_PIPELINE", "0"), ("GSKY_WAVES", "0"),
                 ("GSKY_RENDER_BATCH", "0"), ("GSKY_PALLAS", "interpret"),
                 ("GSKY_KERNEL_LEDGER", f"{tmp}/ledger.jsonl")):
        mp.setenv(k, v)
    mp.setattr(jpt, "_FAILED", set())
    jpages.reset_default_pool()
    jstore = JMASStore()
    for i, p in enumerate(senv.paths):
        rec = jextract(p)
        assert not rec.get("error"), rec
        for ds in rec["geo_metadata"]:
            ds["namespace"] = st.product(i % st.N_PRODUCTS)
        jstore.ingest(rec)
    jmas = JMASClient(jstore)
    jserver = JOWSServer(JConfigWatcher(senv.conf_dir,
                                        mas_factory=lambda a: jmas,
                                        install_signal=False),
                         mas_factory=lambda a: jmas,
                         metrics=JMetricsLogger(), gateway=None,
                         fabric=None)
    client = _JaxClient(jserver)
    _, host = senv.server(gateway=None)
    yield {"jax": client, "host": host, "tmp": tmp}
    client.close()
    senv.close()
    jpages.reset_default_pool()
    mp.undo()


def _path(url):
    return url.split(HOST, 1)[1]


def _port_get(pair, path):
    try:
        with urllib.request.urlopen(f"http://{pair['host']}{path}",
                                    timeout=60) as r:
            return r.status, r.headers.get_content_type(), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get_content_type(), e.read()


def both(pair, url):
    path = _path(url)
    with time_limit(LIMIT_S):
        return pair["jax"].get(path), _port_get(pair, path)


def _same_png(ref, got, what):
    assert got[:2] == ref[:2] == (200, "image/png"), (what, got[2][:300])
    a, b = jdecode_png(ref[2]), decode_png(got[2])
    assert a.shape == b.shape and np.array_equal(a, b), \
        (what, int(np.count_nonzero(a != b)))
    return a


def test_churn_getmaps_equal_the_reference(senv, pair):
    """The churn's first four requests (seed 1): native and quarter-
    extent tiles over four dates; layer ``landsat`` resamples nearest."""
    rng = np.random.default_rng(1)
    data = 0
    for i in range(4):
        fx, fy = (float(rng.uniform(0.0, 0.75)) for _ in range(2))
        a = _same_png(*both(pair, senv.churn_url(HOST, i, fx, fy)),
                      f"churn {i}")
        data += int(np.count_nonzero(a[..., 3]))
    assert data > 0


@pytest.mark.parametrize("k", [0, 9, 27, 63])
def test_hot_grid_equals_the_reference(senv, pair, k):
    _same_png(*both(pair, senv.hot_url(HOST, senv.hot_tiles()[k])),
              f"hot {k}")


def _tiff(pair, body):
    path = f"{pair['tmp']}/body.tif"
    with open(path, "wb") as fp:
        fp.write(body)
    t = JGeoTIFF(path)
    try:
        return np.stack([np.asarray(t.read(b + 1), np.float32)
                         for b in range(t.count)])
    finally:
        t.close()


def test_getcoverage_equals_the_reference(senv, pair):
    """The wcs scenario's first export (seed 3), 1024 x 1024 in 16
    tiles: equal decoded values."""
    rng = np.random.default_rng(3)
    fx, fy = (float(rng.uniform(0.0, 0.5)) for _ in range(2))
    ref, got = both(pair, senv.wcs_url(HOST, fx, fy))
    assert got[:2] == ref[:2] and ref[0] == 200, got[2][:300]
    a, b = _tiff(pair, ref[2]), _tiff(pair, got[2])
    assert a.shape == b.shape == (4, 1024, 1024)
    assert np.array_equal(a, b), int(np.count_nonzero(a != b))


def test_wave_drill_equals_the_reference(senv, pair):
    blocks = _same_csv(*both(pair, senv.drill_url(HOST)))
    assert any(line.strip() for line in blocks[0].splitlines())


def _dap_values(body):
    chunks, used = _chunks(body)
    assert used == len(body) and chunks[-1][0] & dap4.LAST_CHUNK
    return np.frombuffer(b"".join(c for _, c in chunks[1:]), "<f4")


@pytest.mark.parametrize("i", [0, 1, 2])
def test_dap4_subsets_equal_the_reference(senv, pair, i):
    ref, got = both(pair, senv.dap_url(HOST, i))
    assert got[:2] == ref[:2] == (200, dap4.CONTENT_TYPE), got[2][:300]
    a, b = _dap_values(ref[2]), _dap_values(got[2])
    assert a.size > 0 and np.array_equal(a, b, equal_nan=True)


# -- child processes ----------------------------------------------------------

def _child(code, env=None, timeout=120):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})


def test_runs_without_jax_and_under_tsan():
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['gsky_tpu'] = None\n"
        "sys.modules['bench'] = None\n"
        "sys.path.insert(0, 'tools')\n"
        "import soak_torch\n"
        "try:\n"
        "    soak_torch.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "sys.exit(soak_torch.main(['--device', 'cpu', '--seconds', '1',\n"
        "    '--conc', '2', '--scenes', '2', '--scene-shape', '256x256']))\n")
    r = _child(code, {"GSKY_TSAN": "1"})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "--scenario" in r.stdout and "SOAK PASSED" in r.stdout
    assert "tsan: tracked_vars=" in r.stdout and "races=0" in r.stdout


def test_server_process_hands_freed_buffers_back():
    """`fix_mmap_threshold` (the command line's server and the soak set
    it): after glibc has seen an 8 MiB block freed, 4 MiB buffers
    freed by 8 threads between small ones that stay still leave the
    process (they are mmapped); without it most of them stay in the
    arenas, and the soak's wcs exports grew RSS by up to 355 MB a
    minute."""
    code = (
        "import sys, threading\n"
        "import numpy as np\n"
        "sys.path.insert(0, 'tools')\n"
        "from soak_torch import rss_mb\n"
        "from gsky_tpu_torch.server.main import fix_mmap_threshold\n"
        "assert fix_mmap_threshold()\n"
        "big = np.ones(8 << 20, np.uint8)\n"
        "del big\n"
        "base = rss_mb()\n"
        "keep = []\n"
        "def work():\n"
        "    for _ in range(16):\n"
        "        keep.append(np.ones(4 << 20, np.uint8))\n"
        "        keep.append(np.ones(64, np.uint8))\n"
        "ths = [threading.Thread(target=work) for _ in range(8)]\n"
        "[t.start() for t in ths]\n"
        "[t.join(60) for t in ths]\n"
        "peak = rss_mb()\n"
        "keep = [k for k in keep if k.size == 64]\n"
        "print(round(base), round(peak), round(rss_mb()))\n")
    r = _child(code)
    assert r.returncode == 0, r.stderr[-2000:]
    base, peak, after = (int(v) for v in r.stdout.split())
    assert peak - base > 400 and after - base < 64, r.stdout


def test_cuda_without_a_card_exits_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = subprocess.run([sys.executable, "tools/soak_torch.py", "--device",
                        "cuda", "--seconds", "1"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "SOAK" not in r.stdout
    assert "CUDA" in r.stderr
