"""Port parity, the resilience layer's faults, registry, retries,
breakers and deadlines: `gsky_tpu_torch.resilience` against
`gsky_tpu.resilience` case for case (the fault, registry and deadline
cases of the reference's `tests/test_resilience.py`), each unit case run
over both packages, and the seeded fault draws held equal between them.
The MAS client's retries run over an in-process store behind the
``mas`` fault site, the decode faults through each package's window
decode (the reference's with its own Granule, the port's with
``device="cpu"``).  Both packages' counters, breakers and fault plans
are reset around every test."""

import contextvars
import os
import random
import threading

import numpy as np
import pytest

from gsky_tpu import resilience as jres
from gsky_tpu.geo.crs import EPSG4326 as JEPSG4326
from gsky_tpu.geo.transform import BBox as JBBox
from gsky_tpu.geo.transform import GeoTransform as JGeoTransform
from gsky_tpu.index import MASStore as JMASStore
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.io import write_geotiff as jwrite_geotiff
from gsky_tpu.pipeline.decode import decode_all as jdecode_all
from gsky_tpu.pipeline.types import Granule as JGranule

from gsky_tpu_torch import resilience as tres
from gsky_tpu_torch.geo.crs import EPSG4326
from gsky_tpu_torch.geo.transform import BBox, GeoTransform
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.geotiff import write_geotiff
from gsky_tpu_torch.pipeline.decode import decode_all
from gsky_tpu_torch.pipeline.types import Granule

PKGS = {"jax": jres, "torch": tres}


@pytest.fixture(autouse=True)
def _clean_resilience():
    jres.reset()
    tres.reset()
    yield
    jres.reset()
    tres.reset()


@pytest.fixture(params=sorted(PKGS))
def res(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# the fault spec and deterministic injection
# ---------------------------------------------------------------------------

def test_fault_spec_parse(res):
    rules = res.faults.parse_spec(
        "mas:error:0.2,worker:latency:500ms,decode:latency:2s:0.1")
    assert rules["mas"][0].kind == "error"
    assert rules["mas"][0].rate == 0.2
    assert rules["worker"][0].kind == "latency"
    assert rules["worker"][0].latency_s == 0.5
    assert rules["worker"][0].rate == 1.0
    assert rules["decode"][0].latency_s == 2.0
    assert rules["decode"][0].rate == 0.1


@pytest.mark.parametrize("spec", ["mas", "mas:error", "mas:explode:0.5",
                                  "mas:error:1.5"])
def test_fault_spec_rejects_bad_clauses(res, spec):
    with pytest.raises(ValueError):
        res.faults.parse_spec(spec)


SPECS = ["mas:error:0.5", "node:slow:10ms:0.3,node:error:0.4",
         "decode:hang:0ms:0.5,decode:error:0.25",
         "worker:latency:0ms:0.7,worker:error:0.1"]


def test_every_kind_parses_alike():
    spec = ("a:error:0.1,b:latency:5ms,c:slow:1s:0.5,d:hang:2s,"
            "e:kill:0,f:crash:0.5,g:oom:0.2,h:corrupt:0.3,"
            "i:preempt:10s:0.5,j:preempt_nograce:0.1")
    a = jres.faults.parse_spec(spec)
    b = tres.faults.parse_spec(spec)
    assert sorted(a) == sorted(b)
    for site in a:
        assert [(r.kind, r.rate, r.latency_s) for r in a[site]] == \
            [(r.kind, r.rate, r.latency_s) for r in b[site]]


def _outcomes(res, site, n):
    seq = []
    for _ in range(n):
        try:
            res.faults.inject(site)
            seq.append(0)
        except res.InjectedFault:
            seq.append(1)
    return seq


def test_injection_deterministic_per_seed(res):
    res.faults.configure("mas:error:0.5", seed=11)
    a = _outcomes(res, "mas", 32)
    res.faults.configure("mas:error:0.5", seed=11)
    assert _outcomes(res, "mas", 32) == a
    res.faults.configure("mas:error:0.5", seed=12)
    assert _outcomes(res, "mas", 32) != a
    assert 0 < sum(a) < 32


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("spec", SPECS)
def test_injection_draws_equal_the_reference(spec, seed):
    """The same (spec, seed) fires the same faults, call for call, at
    every site it names."""
    sites = sorted(jres.faults.parse_spec(spec))
    for res in (jres, tres):
        res.faults.configure(spec, seed=seed)
    for site in sites:
        assert _outcomes(tres, site, 64) == _outcomes(jres, site, 64)
    assert tres.registry.stats()["faults_injected"] == \
        jres.registry.stats()["faults_injected"]


def test_site_rng_equals_the_reference():
    for site in ("mas", "decode", "worker", "node", "pool"):
        for seed in (0, 1, 99):
            a = jres.faults.site_rng(site, seed)
            b = tres.faults.site_rng(site, seed)
            assert [a.random() for _ in range(8)] == \
                [b.random() for _ in range(8)]


def test_flag_draws_from_the_same_stream(res):
    res.faults.configure("device:corrupt:0.5", seed=3)
    got = [res.faults.flag("device", "corrupt") for _ in range(16)]
    res.faults.configure("device:corrupt:0.5", seed=3)
    assert [res.faults.flag("device", "corrupt") for _ in range(16)] == got


def test_flag_equals_the_reference():
    for res in (jres, tres):
        res.faults.configure("device:corrupt:0.5", seed=5)
    assert [tres.faults.flag("device", "corrupt") for _ in range(32)] == \
        [jres.faults.flag("device", "corrupt") for _ in range(32)]


def test_injection_counts_to_registry(res):
    res.faults.configure("decode:error:1.0", seed=0)
    with pytest.raises(res.InjectedFault):
        res.faults.inject("decode")
    assert res.registry.stats()["faults_injected"]["decode"] == 1


def test_inactive_plan_is_noop(res):
    assert not res.faults.active()
    res.faults.inject("mas")
    res.faults.configure("mas:error:1.0")
    res.faults.inject("worker")
    assert res.registry.stats()["faults_injected"] == {}


def test_env_spec_is_folded_in_lazily(monkeypatch):
    """GSKY_FAULTS and GSKY_FAULTS_SEED are read at the first inject, not
    at import; an explicit configure supersedes them."""
    for res in (jres, tres):
        res.faults._env_folded = False
        res.faults._PLAN = None
    monkeypatch.setenv("GSKY_FAULTS", "mas:error:0.5")
    monkeypatch.setenv("GSKY_FAULTS_SEED", "4")
    assert _outcomes(tres, "mas", 24) == _outcomes(jres, "mas", 24)
    assert tres.faults.active()


def test_injected_fault_is_connection_error(res):
    assert issubclass(res.InjectedFault, ConnectionError)
    assert res.is_retryable(res.InjectedFault("x"))


def test_latency_fault_sleeps(res, monkeypatch):
    slept = []
    monkeypatch.setattr(res.faults.time, "sleep", slept.append)
    res.faults.configure("decode:latency:250ms", seed=0)
    res.faults.inject("decode")
    assert slept == [0.25]


# ---------------------------------------------------------------------------
# the retry policy and the registry
# ---------------------------------------------------------------------------

def test_backoff_schedule_deterministic(res):
    pol = res.RetryPolicy(max_attempts=5, base_delay=0.1, multiplier=2.0,
                          max_delay=1.0, jitter=0.5)
    a = list(pol.delays(random.Random(3)))
    b = list(pol.delays(random.Random(3)))
    assert a == b and len(a) == 4
    for k, d in enumerate(a):
        nominal = min(0.1 * 2.0 ** k, 1.0)
        assert nominal * 0.5 <= d <= nominal * 1.5


def test_backoff_equals_the_reference():
    kw = dict(max_attempts=6, base_delay=0.05, multiplier=3.0,
              max_delay=0.7, jitter=0.4)
    assert list(tres.RetryPolicy(**kw).delays(random.Random(8))) == \
        list(jres.RetryPolicy(**kw).delays(random.Random(8)))


def test_retry_recovers_from_transient(res):
    calls, slept = [], []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("flaky")
        return "ok"
    out = res.call_with_retry(fn, res.RetryPolicy(max_attempts=4,
                                                  jitter=0.0),
                              site="t", sleep=slept.append)
    assert out == "ok" and len(calls) == 3
    assert slept == pytest.approx([0.1, 0.2])
    assert res.registry.stats()["retries"]["t"] == 2


def test_retry_skips_non_retryable(res):
    calls = []

    def fn():
        calls.append(1)
        raise ValueError("bad request")
    with pytest.raises(ValueError):
        res.call_with_retry(fn, res.RetryPolicy(max_attempts=5), site="t",
                            sleep=lambda s: None)
    assert len(calls) == 1


def test_retry_exhaustion_wraps_last_error(res):
    def fn():
        raise TimeoutError("still down")
    with pytest.raises(res.BackendUnavailable) as ei:
        res.call_with_retry(fn, res.RetryPolicy(max_attempts=3, jitter=0.0),
                            site="t", sleep=lambda s: None)
    assert isinstance(ei.value.__cause__, TimeoutError)
    assert res.registry.stats()["retry_exhausted"]["t"] == 1


def test_retry_respects_deadline(res):
    calls = []

    def fn():
        calls.append(1)
        raise ConnectionError("down")
    with pytest.raises(res.BackendUnavailable):
        res.call_with_retry(fn, res.RetryPolicy(max_attempts=5, jitter=0.0),
                            site="t", deadline=res.Deadline(0.05),
                            sleep=lambda s: None)
    assert len(calls) == 1


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_transitions(res):
    clk = FakeClock()
    br = res.CircuitBreaker("b", failure_threshold=3, reset_timeout=10.0,
                            clock=clk, register=False)
    assert br.state == "closed"
    for _ in range(3):
        assert br.allow()
        br.record_failure()
    assert br.state == "open" and br.opens == 1
    assert not br.allow()
    assert br.retry_after() == pytest.approx(10.0)
    clk.t += 10.0
    assert br.state == "half_open"
    assert br.allow()
    assert not br.allow()
    br.record_failure()
    assert br.state == "open" and br.opens == 2
    clk.t += 10.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed"
    assert br.allow() and br.allow()


def test_breaker_consecutive_not_cumulative(res):
    br = res.CircuitBreaker("b", failure_threshold=3, register=False)
    for _ in range(10):
        br.record_failure()
        br.record_success()
    assert br.state == "closed" and br.opens == 0


def test_breaker_open_shortcircuits_retry(res):
    clk = FakeClock()
    br = res.CircuitBreaker("b", failure_threshold=1, reset_timeout=10.0,
                            clock=clk, register=False)
    br.record_failure()
    calls = []
    with pytest.raises(res.BreakerOpen):
        res.call_with_retry(lambda: calls.append(1), site="t", breaker=br,
                            sleep=lambda s: None)
    assert calls == []


def test_semantic_error_does_not_open_breaker(res):
    br = res.CircuitBreaker("b", failure_threshold=1, register=False)

    def fn():
        raise ValueError("4xx-ish")
    for _ in range(5):
        with pytest.raises(ValueError):
            res.call_with_retry(fn, site="t", breaker=br,
                                sleep=lambda s: None)
    assert br.state == "closed"


def test_registry_snapshots_registered_breakers(res):
    br = res.get_breaker("mas:x", failure_threshold=2)
    br.record_failure()
    br.record_failure()
    snap = res.registry.stats()["breakers"]["mas:x"]
    assert snap["state"] == "open" and snap["opens"] == 1
    assert snap["failures"] == 2 and snap["consecutive_failures"] == 2


def test_registry_stats_keys_equal_the_reference():
    for res in (jres, tres):
        res.registry.count_retry("mas")
        res.registry.count_exhausted("mas")
        res.registry.count_fault("decode")
        res.registry.count_degraded()
        res.registry.count_deadline()
    a, b = jres.registry.stats(), tres.registry.stats()
    assert a == b


# ---------------------------------------------------------------------------
# deadline budgets
# ---------------------------------------------------------------------------

def test_deadline_decrements_and_exhausts(res):
    clk = FakeClock()
    dl = res.Deadline(10.0, clock=clk)
    assert dl.clamp(60.0) == pytest.approx(10.0)
    clk.t += 4.0
    assert dl.remaining() == pytest.approx(6.0)
    assert dl.clamp(3.0) == pytest.approx(3.0)
    clk.t += 7.0
    assert dl.expired()
    with pytest.raises(res.DeadlineExceeded):
        dl.clamp(1.0)
    assert res.registry.stats()["deadline_exhausted"] == 1


def test_deadline_exceeded_is_timeout(res):
    assert issubclass(res.DeadlineExceeded, TimeoutError)


def test_clamp_timeout_uses_context_scope(res):
    assert res.clamp_timeout(42.0) == 42.0
    with res.deadline_scope(res.Deadline(5.0)):
        assert res.clamp_timeout(60.0) <= 5.0
        assert res.clamp_timeout(1.0) == 1.0
    assert res.clamp_timeout(42.0) == 42.0


def test_deadline_scope_crosses_threads(res):
    with res.deadline_scope(res.Deadline(30.0)):
        ctx = contextvars.copy_context()
    got = []
    t = threading.Thread(target=lambda: got.append(
        ctx.run(lambda: res.clamp_timeout(60.0))))
    t.start()
    t.join(10)
    assert got and got[0] <= 30.0


# ---------------------------------------------------------------------------
# the MAS client behind the ``mas`` fault site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_mas_client_retries_injected_faults(pkg):
    res = PKGS[pkg]
    c = (JMASClient(JMASStore()) if pkg == "jax"
         else MASClient(MASStore()))
    c._retry = res.RetryPolicy(max_attempts=3, base_delay=0.001,
                               max_delay=0.002)
    res.faults.configure("mas:error:1.0", seed=0)
    with pytest.raises(res.BackendUnavailable) as ei:
        c.intersects("/does/not/matter")
    assert isinstance(ei.value.__cause__, res.InjectedFault)
    s = res.registry.stats()
    assert s["retries"]["mas"] == 2
    assert s["faults_injected"]["mas"] == 3
    with pytest.raises(res.BackendUnavailable):
        c.intersects("/does/not/matter")
    assert c._breaker.state == "open"
    with pytest.raises(res.BreakerOpen):
        c.intersects("/x")
    res.faults.reset()
    c._breaker.reset_timeout = 0.0
    assert c.intersects("/x") == []
    assert c._breaker.state == "closed"


def test_mas_client_seeded_faults_retry_alike():
    """mas:error:0.3 at seed 0: each package's client over its own store
    retries the same calls, fails the same ones, and counts alike."""
    outs = {}
    for pkg, res in PKGS.items():
        res.faults.configure("mas:error:0.3", seed=0)
        c = (JMASClient(JMASStore()) if pkg == "jax"
             else MASClient(MASStore()))
        c._retry = res.RetryPolicy(max_attempts=3, base_delay=0.0,
                                   max_delay=0.0, jitter=0.0)
        c._breaker.failure_threshold = 1000
        got = []
        for i in range(24):
            try:
                got.append(len(c.intersects(f"/p{i}")))
            except res.BackendUnavailable:
                got.append("down")
        outs[pkg] = (got, res.registry.stats()["retries"],
                     res.registry.stats()["faults_injected"])
    assert outs["jax"] == outs["torch"]


# ---------------------------------------------------------------------------
# decode faults through the window decode
# ---------------------------------------------------------------------------

def _two_granules(tmp_path, pkg):
    gt = (JGeoTransform if pkg == "jax" else GeoTransform)(
        148.0, 0.01, 0.0, -35.0, 0.0, -0.01)
    write = jwrite_geotiff if pkg == "jax" else write_geotiff
    crs = JEPSG4326 if pkg == "jax" else EPSG4326
    G = JGranule if pkg == "jax" else Granule
    gs = []
    for name in ("good", "bad"):
        p = os.path.join(str(tmp_path), f"{pkg}_{name}.tif")
        write(p, np.ones((64, 64), np.int16), gt, crs, nodata=-999)
        gs.append(G(path=p, ds_name=f"{name}.tif", namespace="b1",
                    base_namespace="b1", band=1, time_index=None,
                    timestamp=0.0, srs="EPSG:4326",
                    geo_transform=list(gt.to_gdal()), nodata=-999.0,
                    array_type="Int16", is_netcdf=False))
    with open(gs[1].path, "wb") as fp:
        fp.write(b"this is not a tiff")
    return gs


def _decode(pkg, gs, errs):
    if pkg == "jax":
        return jdecode_all(gs, JBBox(148.0, -35.64, 148.64, -35.0),
                           JEPSG4326, workers=1, errors=errs)
    return decode_all(gs, BBox(148.0, -35.64, 148.64, -35.0), EPSG4326,
                      workers=1, errors=errs, device="cpu")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_decode_all_reports_errors_separately(tmp_path, pkg):
    res = PKGS[pkg]
    gs = _two_granules(tmp_path, pkg)
    errs = []
    ws = _decode(pkg, gs, errs)
    assert ws[0] is not None and ws[1] is None
    assert len(errs) == 1
    with res.request_scope():
        res.check_partial(len(errs), len(gs), "decode")
        assert res.degraded_reasons() == ("decode",)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_decode_faults_flow_through_decode_all(tmp_path, pkg):
    res = PKGS[pkg]
    gs = _two_granules(tmp_path, pkg)[:1]
    res.faults.configure("decode:error:1.0", seed=0)
    errs = []
    ws = _decode(pkg, gs, errs)
    assert ws == [None]
    assert len(errs) == 1 and isinstance(errs[0], res.InjectedFault)
    assert res.registry.stats()["faults_injected"]["decode"] == 1
    with res.request_scope():
        with pytest.raises(res.TooManyFailures):
            check = res.check_partial
            check(len(errs), len(gs), "decode")


def test_seeded_decode_faults_fail_the_same_windows(tmp_path):
    """decode:error:0.5 at seed 9 over 12 decodes of the good granule:
    the same windows fail in both packages (one worker, so in order)."""
    got = {}
    for pkg, res in PKGS.items():
        g = _two_granules(tmp_path, pkg)[0]
        res.faults.configure("decode:error:0.5", seed=9)
        errs = []
        ws = _decode(pkg, [g] * 12, errs)
        got[pkg] = [w is None for w in ws]
    assert got["jax"] == got["torch"]
    assert 0 < sum(got["torch"]) < 12


def test_scene_load_fault_makes_the_scene_uncacheable(tmp_path):
    """The ``decode`` site in front of the scene load: a faulted load
    is uncacheable (None), counted, and the next load succeeds."""
    from gsky_tpu_torch.pipeline.scene_cache import SceneCache
    g = _two_granules(tmp_path, "torch")[0]
    cache = SceneCache(device="cpu")
    tres.faults.configure("decode:error:1.0", seed=0)
    assert cache.get(g) is None
    assert tres.registry.stats()["faults_injected"]["decode"] == 1
    tres.faults.reset()
    assert cache.get(g) is not None
