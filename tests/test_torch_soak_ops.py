"""The soak's overload and ingest scenarios (`tools/soak_torch.py`) on
the CPU; the fleet's are in `test_torch_soak_fleet.py`, a file of its
own so that xdist's ``--dist loadfile`` runs the two side by side.

Each runs in-process with ``device="cpu"`` and passes: ``overload``
over four 512 x 512 scenes, ``ingest`` over the reference soak's own
four 1536 x 1536 (its walk is sparse against the files only at that
size: over 512-px scenes the ranged leg reads more than the whole
files, in both packages).  Each check bites, on the criterion it
breaks (``unmet``): an admission shed answered without
``Retry-After``, an AIMD controller that never moves its limit and a
cancelled request whose permit never comes back fail ``overload``, a
ranged leg that reads whole files fails ``ingest``.  The repairs the
scenarios called for: a closed server lets go of its scene cache and
page pool (its card memory), which the process-wide prefetch planner,
the wave drainer and the device guard's sync worker held, and the
planner holds a server's warm callback weakly; the prefetch budget
pays only for the scenes a warm loads (C.24; the reference charges
resident ones too).

Parity with the JAX package (`test_torch_soak.pair`: the reference with
Pallas in interpret mode): a seeded sample of the overload's GetMaps,
and the ingest walk's tiles in each leg (and the pixels where the
window route's tiles differ from the whole-scene route's, ROADMAP
C.23), all nearest, decoded RGBA identical.

Child processes, started together: the tool with ``jax``, ``gsky_tpu``
and ``bench`` blocked runs each new scenario's ``--help``; ``--device
cuda`` without CUDA exits naming CUDA.  Every wait has a timeout."""

import gc
import json
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest
import torch

from gsky_tpu.ingest import reset_default_planner as jreset_planner
from gsky_tpu.ingest import reset_sources as jreset_sources
from gsky_tpu.ingest import reset_staging_pool as jreset_staging
from gsky_tpu.ingest import stats as jingest_stats
from gsky_tpu.ingest.prefetch import default_planner as jdefault_planner
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline.scene_cache import default_scene_cache

from gsky_tpu_torch import resilience
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.ingest import (default_planner, reset_default_planner,
                                   reset_sources, reset_staging_pool,
                                   source)
from gsky_tpu_torch.ingest import prefetch
from gsky_tpu_torch.ingest import stats as ingest_stats
from gsky_tpu_torch.pipeline.waves import reset_waves
from gsky_tpu_torch.serving.admission import AdmissionController
from gsky_tpu_torch.server import ows

from test_torch_soak import (HOST, LIMIT_S, REPO, _same_png, both,
                             soak_args, st)
from test_torch_soak import pair, senv  # noqa: F401 (fixtures)
from test_torch_worker import time_limit

SECONDS = 2
INGEST_SHAPE = (1536, 1536)         # the reference soak's scenes
# the overload's storm concurrency (its --conc, as phase 28's): at the
# reference's 10 a quick host renders inside the 1 s queue deadline
# and sheds nothing
OVERLOAD_CONC = 64


@pytest.fixture(scope="module")
def ienv(tmp_path_factory):
    env = st.SoakEnv(str(tmp_path_factory.mktemp("soak_ingest")), 4,
                     INGEST_SHAPE, "cpu")
    yield env
    env.close()


def _fresh(env):
    """Process-wide state cleared around a scenario: the resilience
    counters, breakers, fault plan and pressure monitor, the wave
    schedulers, the ingest ledger, sources, staging pool and planner; a
    new MAS client (its breaker in the cleared registry); the
    scenario's servers closed after it."""
    def clear():
        resilience.reset()
        reset_waves()
        ingest_stats.reset()
        reset_sources()
        reset_staging_pool()
        reset_default_planner()

    clear()
    env.mas = MASClient(env.store)
    yield
    env.close()
    clear()


@pytest.fixture
def fresh(senv):
    yield from _fresh(senv)


@pytest.fixture
def ifresh(ienv):
    yield from _fresh(ienv)


def run(env, name, seconds=SECONDS):
    # the fleet's nodes boot, warm and are revived inside the run
    args = soak_args(seconds)
    if name == "overload":
        args.conc = OVERLOAD_CONC
    with time_limit(LIMIT_S * (3 if name == "fleet" else 1)):
        return st.RUNS[name](env, args)


# -- every scenario passes -------------------------------------------------

@pytest.mark.parametrize("name", ["overload", "ingest"])
def test_scenario_passes(senv, ienv, fresh, ifresh, name):
    out, ok = run(ienv if name == "ingest" else senv, name)
    assert ok and out["unmet"] == [], json.dumps(out)[:6000]
    assert out["scenario"] == name and out["device"] == "cpu"
    assert "card_memory" not in out
    if name == "overload":
        assert out["sheds"]["sheds"] > 0
        assert out["sheds"]["missing_retry_after"] == 0
        assert out["adjustments_since_reconfigure"] >= 1
        assert out["cancellation"]["drained"]
        assert "cancelled" in [h["answer"]
                               for h in out["cancellation"]["holds"]]
        assert out["pool"]["pinned"] == 0
    else:
        assert out["ranged"]["bytes_read"] < out["baseline"]["bytes_read"]
        assert out["ranged"]["whole_read_bytes"] == 0
        assert out["baseline"]["ranged_read_bytes"] == 0
        assert out["prefetch"]["planner"]["hit_rate"] >= 0.5
        assert all(out[leg]["pool"]["pinned"] == 0
                   for leg in st.INGEST_LEGS)


# -- the checks bite ---------------------------------------------------------
#
# Each planted fault fails its scenario on the criterion it breaks
# (``unmet``).  The overload's storm, cooldown and critical phases are
# cut to a second where the fault's criterion does not need them.

def short_overload(monkeypatch):
    monkeypatch.setattr(st, "OVERLOAD_MIN_S", dict.fromkeys(
        st.OVERLOAD_MIN_S, 1.0))


def test_overload_fails_on_a_shed_without_retry_after(senv, fresh,
                                                     monkeypatch):
    respond = ows._exception_response

    def no_retry_after(e, headers=None):
        return respond(e, {k: v for k, v in (headers or {}).items()
                           if k != "Retry-After"})

    monkeypatch.setattr(ows, "_exception_response", no_retry_after)
    short_overload(monkeypatch)
    out, ok = run(senv, "overload", 1)
    assert not ok and "retry_after" in out["unmet"], out["unmet"]
    assert out["sheds"]["sheds"] > 0
    assert out["sheds"]["missing_retry_after"] == out["sheds"]["sheds"]


def test_overload_fails_on_a_frozen_aimd(senv, fresh, monkeypatch):
    """An AIMD controller that never moves its limit.  The reference's
    criterion (``total_adjustments`` >= 1) holds all the same, since
    the run's own `reconfigure` to the scenario's knobs changes the
    ceiling; the adjustments after it are what fail."""
    monkeypatch.setattr(AdmissionController, "observe",
                        lambda self, service_class, latency_s: None)
    out, ok = run(senv, "overload")
    assert not ok
    assert out["unmet"] == ["adjusted_since_reconfigure"], out["unmet"]
    assert out["adjustments"] >= 1
    assert out["adjustments_since_reconfigure"] == 0


def test_overload_fails_on_a_permit_never_returned(senv, fresh,
                                                  monkeypatch):
    """A cancelled request's permit kept: its class never drains (the
    wait for it cut to 3 s)."""
    release = AdmissionController._release_adaptive

    def keeps_cancelled(self, state, cancelled=False):
        if not cancelled:
            release(self, state)

    monkeypatch.setattr(AdmissionController, "_release_adaptive",
                        keeps_cancelled)
    short_overload(monkeypatch)
    monkeypatch.setattr(st, "OVERLOAD_DRAIN_S", 3.0)
    out, ok = run(senv, "overload", 1)
    assert not ok and "drained" in out["unmet"], out["unmet"]
    assert not out["cancellation"]["drained"]
    assert out["admission"]["classes"]["WMS"]["in_use"] > 0


def test_ingest_fails_on_a_ranged_leg_that_reads_whole_files(
        ienv, ifresh, monkeypatch):
    fetch = source.fetch_ranges

    def whole_file(src, ranges):
        blob = fetch(src, [(0, src.size())])[0]
        return [blob[o:o + n] for o, n in ranges]

    monkeypatch.setattr(source, "fetch_ranges", whole_file)
    out, ok = run(ienv, "ingest")
    assert not ok and out["unmet"] == ["ranged_bytes"], out["unmet"]
    assert out["ranged"]["ranged_windows"] > 0
    assert out["ranged"]["bytes_read"] >= out["baseline"]["bytes_read"]


# -- a closed server lets go of its card memory --------------------------

@pytest.mark.parametrize("waves", ["1", "0"], ids=["waves", "per_call"])
def test_a_closed_server_frees_its_caches(senv, fresh, monkeypatch, waves):
    """A GetMap with ingest on binds the process-wide prefetch planner
    to the server; with waves on the drainer serves it.  After `release`
    (HTTP stopped, `OWSServer.close`) the executor, its scene cache and
    its page pool are collected, without resetting the planner or the
    schedulers: the planner's warm callback and the drainer's locals
    held the last server's on the card."""
    monkeypatch.setenv("GSKY_WAVES", waves)
    monkeypatch.setenv("GSKY_PREFETCH", "1")
    reset_waves()
    srv, host = senv.server(gateway=None)
    with time_limit(LIMIT_S):
        for i in range(2):
            assert st.fetch_png(senv.churn_url(host, i, 0.1 * i, 0.3))
    refs = [weakref.ref(o) for o in (srv.executor, srv.executor.cache,
                                     srv.executor.pool)]
    senv.release(srv)
    del srv
    gc.collect()
    assert [r() is None for r in refs] == [True] * 3


def test_the_planner_holds_a_server_weakly():
    """The prefetch planner holds a bound warm callback weakly: a
    server dropped without `close` is collected and its callback goes
    with it; `unbind` drops only the callback it is given; a plain
    function stays bound."""
    class Server:
        def warm(self, *a):
            return 0

    planner = prefetch.PrefetchPlanner()
    try:
        srv, other = Server(), Server()
        ref = weakref.ref(srv)
        planner.warm_fn = srv.warm
        planner.unbind(other.warm)
        assert planner.warm_fn == srv.warm
        del srv
        gc.collect()
        assert ref() is None and planner.warm_fn is None
        planner.warm_fn = other.warm
        planner.unbind(other.warm)
        assert planner.warm_fn is None

        def fn(*a):
            return 0

        planner.warm_fn = fn
        del fn
        gc.collect()
        assert planner.warm_fn is not None
    finally:
        planner.close()


def test_an_idle_sync_worker_keeps_no_job():
    """The device guard's sync worker runs a guarded readback's thunk
    and idles: it keeps neither the thunk nor what the thunk closes
    over (a wave's entries and their page pool, found held after the
    overload's server closed on the card)."""
    from gsky_tpu_torch.device_guard import supervisor

    class Held:
        pass

    held = Held()
    ref = weakref.ref(held)

    def thunk(h=held):
        return 1

    assert supervisor.supervised_sync("wave.readback", thunk) == 1
    del held, thunk
    t_end = time.time() + 5.0
    while ref() is not None and time.time() < t_end:
        gc.collect()
        time.sleep(0.05)
    assert ref() is None


# -- parity with the JAX package ------------------------------------------

def test_overload_getmaps_equal_the_reference(senv, pair):
    rng = np.random.default_rng(24)
    data = 0
    for i in sorted(rng.choice(4096, size=5, replace=False)):
        a = _same_png(*both(pair, senv.overload_url(HOST, int(i))),
                      f"overload {i}")
        data += int(np.count_nonzero(a[..., 3]))
    assert data > 0


def test_ingest_walk_equals_the_reference(senv, pair, monkeypatch):
    """Each leg's ten tiles (the temporal range over every scene) from
    both packages, caches emptied before each leg; then the pixels
    where the window route (the ranged leg) differs from the
    whole-scene route are the same in both (C.23)."""
    port = senv.servers[-1]
    tiles = {}
    for leg, knobs in st.INGEST_LEGS.items():
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        default_scene_cache.clear()
        jpages.reset_default_pool()
        for clear in (jingest_stats.reset, jreset_sources, jreset_staging,
                      jreset_planner, ingest_stats.reset, reset_sources,
                      reset_staging_pool, reset_default_planner):
            clear()
        port.executor.cache.clear()
        tiles[leg] = [
            _same_png(*both(pair, st.ingest_url(HOST, bb)), f"{leg} {i}")
            for i, bb in enumerate(st.ingest_walk(senv))]
        if leg == "ranged":
            assert port.executor.cache.window_routed > 0
    base = tiles["baseline"]
    assert all(np.array_equal(a, b)
               for a, b in zip(base, tiles["prefetch"]))
    # C.23: the reference's window-route tiles, compared with its own
    # whole-scene ones, differ in the same pixels (parity above: each
    # package's tile equals the other's)
    diff = [int(np.count_nonzero((a != b).any(-1)))
            for a, b in zip(base, tiles["ranged"])]
    assert max(diff) <= base[0][..., 0].size // 1000, diff


def test_prefetch_charges_only_the_scenes_it_loads(senv, pair,
                                                  monkeypatch):
    """C.24: every scene of the walk resident, a budget of 2 MB (two of
    the soak's 512-px scenes), then the walk: the port's planner warms
    its predictions free of charge and declines none for budget; the
    reference charges each warm the size of its resident scenes and
    declines the rest of the minute's predictions."""
    for k, v in {**st.INGEST_LEGS["prefetch"],
                 "GSKY_PREFETCH_BUDGET_MB": "2"}.items():
        monkeypatch.setenv(k, v)
    boxes = st.ingest_walk(senv)
    with time_limit(LIMIT_S):
        for bb in boxes:             # every scene the walk reads
            both(pair, st.ingest_url(HOST, bb))
        jreset_planner()
        reset_default_planner()
        for bb in boxes:
            both(pair, st.ingest_url(HOST, bb))
            time.sleep(0.35)         # the warm lands before the next tile
    port, ref = default_planner().stats(), jdefault_planner().stats()
    assert port["warmed"] > 0 and port["declined_budget"] == 0, port
    assert ref["warmed"] > 0 and ref["declined_budget"] > 0, ref
    assert port["hit"] > ref["hit"]


# -- child processes ----------------------------------------------------------

HELP_CODE = (
    "import sys\n"
    "sys.modules['jax'] = sys.modules['gsky_tpu'] = None\n"
    "sys.modules['bench'] = None\n"
    "sys.path.insert(0, 'tools')\n"
    "import soak_torch\n"
    "for name in ('overload', 'ingest', 'fleet'):\n"
    "    try:\n"
    "        soak_torch.main(['--scenario', name, '--help'])\n"
    "    except SystemExit as e:\n"
    "        assert e.code == 0, e.code\n"
    "print(sorted(soak_torch.RUNS))\n")
CUDA_RUNS = ("overload", "ingest", "fleet")


@pytest.fixture(scope="module")
def children():
    """This file's child processes, started together and each waited
    for with a timeout: ``help``, and on a host without CUDA each new
    scenario asked for cuda; name -> (returncode, stdout, stderr)."""
    runs = {"help": ["-c", HELP_CODE]}
    if not torch.cuda.is_available():
        for name in CUDA_RUNS:
            runs[name] = ["tools/soak_torch.py", "--scenario", name,
                          "--device", "cuda", "--seconds", "1"]
    procs = {k: subprocess.Popen([sys.executable, *a], cwd=REPO,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, a in runs.items()}
    out = {}
    try:
        for k, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=120)
            out[k] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    return out


def test_help_without_jax(children):
    rc, stdout, stderr = children["help"]
    assert rc == 0, stderr[-2000:]
    assert stdout.count("usage:") == 3
    for name in ("overload", "ingest", "fleet"):
        assert f"'{name}'" in stdout.splitlines()[-1]


@pytest.mark.parametrize("name", CUDA_RUNS)
def test_cuda_without_a_card_exits_naming_cuda(children, name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    rc, stdout, stderr = children[name]
    assert rc != 0 and "SOAK" not in stdout
    assert "CUDA" in stderr
