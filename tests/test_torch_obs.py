"""Port parity, observability primitives: the port's `obs` package
against the JAX package's on the same seeded inputs.

- ``prom``: a seeded sequence of counter, gauge and histogram operations
  (and a scrape-time collector) gives byte-equal exposition text in
  both; ``parse_exposition`` gives equal dicts and refuses the same
  malformed inputs; ``log_buckets`` gives equal ladders.
- ``trace``: one scenario per property (nesting and parent ids, the
  error attribute, root events, ``record_span``, ``GSKY_TRACE=0``,
  ``copy_context`` fan-out, ``bind`` across a raw thread, the
  ``traceparent`` / ``remote_trace`` round trip and its refusals,
  ``adopt_spans``) runs against each package; the span trees are equal
  once ids and times are replaced by their order of appearance.
- ``recorder``: a seeded stream of traces (durations, statuses,
  degradations) into each package's `FlightRecorder`; ``stats()`` and
  the JSONL dump equal after normalisation; ring eviction, the
  reservoir, the SLO file export and the env knobs.
- ``tsan``: each package's sanitizer reports one race on an unlocked
  counter, none on a locked one, and stays out of the way when off.
- the resilience hooks: a retry and a breaker trip tick
  ``gsky_trace_events_total`` and land on the trace's root in both.
"""

import contextvars
import importlib
import json
import random
import threading

import pytest

import gsky_tpu.obs as jobs
import gsky_tpu.obs.prom as jprom
import gsky_tpu.obs.recorder as jrecorder
import gsky_tpu.obs.tsan as jtsan
import gsky_tpu.resilience.breaker as jbreaker

import gsky_tpu_torch.obs as tobs
import gsky_tpu_torch.obs.prom as tprom
import gsky_tpu_torch.obs.recorder as trecorder
import gsky_tpu_torch.obs.tsan as ttsan
import gsky_tpu_torch.resilience.breaker as tbreaker

# the packages' `resilience` export the registry instance under the
# submodule's name
jregistry = importlib.import_module("gsky_tpu.resilience.registry")
tregistry = importlib.import_module("gsky_tpu_torch.resilience.registry")

PKGS = {
    "ref": {"obs": jobs, "prom": jprom, "recorder": jrecorder,
            "tsan": jtsan, "breaker": jbreaker, "registry": jregistry},
    "port": {"obs": tobs, "prom": tprom, "recorder": trecorder,
             "tsan": ttsan, "breaker": tbreaker, "registry": tregistry},
}


@pytest.fixture(autouse=True)
def _fresh_recorders():
    jrecorder.reset_recorder()
    trecorder.reset_recorder()
    yield
    jrecorder.reset_recorder()
    trecorder.reset_recorder()


def both(fn):
    """(reference result, port result) of ``fn(modules)``."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


# ---------------------------------------------------------------------------
# prom


def _registry_ops(prom, seed):
    """A seeded sequence of registry operations; the rendered text."""
    rng = random.Random(seed)
    reg = prom.Registry()
    c = reg.counter("gsky_t_requests_total", "Requests by route.",
                    ("route", "status"))
    g = reg.gauge("gsky_t_depth", 'Queue "depth"\nof the stage.')
    h = reg.histogram("gsky_t_latency_seconds", "Latency.", ("op",),
                      buckets=prom.log_buckets(0.001, 10.0))
    h2 = reg.histogram("gsky_t_occupancy", "Lanes per wave.",
                       buckets=[1.0, 2.0, 4.0, 8.0])
    plain = reg.counter("gsky_t_flushes_total", "Flushes.")
    for _ in range(rng.randint(20, 60)):
        op = rng.randrange(6)
        if op == 0:
            c.labels(route=rng.choice(["wms", "wcs", 'w"p\\s']),
                     status=str(rng.choice([200, 404, 503]))).inc(
                rng.choice([1, 2.5, 0]))
        elif op == 1:
            g.set(rng.uniform(-5, 5))
        elif op == 2:
            g.inc(rng.randint(0, 3))
            g.dec(rng.random())
        elif op == 3:
            h.labels(op=rng.choice(["warp", "encode"])).observe(
                10 ** rng.uniform(-4, 1.5))
        elif op == 4:
            h2.observe(float(rng.randint(1, 40)))
        else:
            plain.inc()
    rows = [({"k": rng.choice(["a", "b\nc"])}, rng.uniform(0, 9))]
    reg.register_collector(lambda: [
        ("gsky_t_extra", "gauge", "From a collector.", rows),
        ("gsky_t_depth", "gauge", "Shadowed by the metric.", [({}, 1)]),
        ("bad name", "gauge", "Dropped.", [({}, 1)])])
    reg.register_collector(lambda: 1 / 0)   # a broken collector is skipped
    return reg.render()


@pytest.mark.parametrize("seed", range(6))
def test_exposition_text_is_byte_equal(seed):
    ref, port = both(lambda m: _registry_ops(m["prom"], seed))
    assert port == ref
    assert both(lambda m: m["prom"].parse_exposition(
        _registry_ops(m["prom"], seed))) == (jprom.parse_exposition(ref),) * 2


def test_default_families_render_and_parse():
    for m in PKGS.values():
        fams = m["prom"].parse_exposition(m["obs"].render_metrics())
        assert {"gsky_requests_total", "gsky_request_seconds",
                "gsky_stage_seconds", "gsky_trace_events_total"} <= set(fams)


MALFORMED = {
    "sample without TYPE": "orphan_metric 1\n",
    "duplicate series": "# TYPE t_dup counter\nt_dup 1\nt_dup 2\n",
    "malformed sample": "# TYPE t_bad gauge\nt_bad one_point_five\n",
    "non-monotonic histogram": (
        "# TYPE t_hist histogram\n" 't_hist_bucket{le="0.1"} 5\n'
        't_hist_bucket{le="1"} 3\n' 't_hist_bucket{le="+Inf"} 5\n'
        "t_hist_count 5\nt_hist_sum 1\n"),
    "+Inf bucket disagrees with _count": (
        "# TYPE t_hist histogram\n" 't_hist_bucket{le="+Inf"} 5\n'
        "t_hist_count 6\nt_hist_sum 1\n"),
    "missing +Inf bucket": (
        "# TYPE t_hist histogram\n" 't_hist_bucket{le="1"} 5\n'
        "t_hist_count 5\n"),
    "duplicate TYPE": "# TYPE t_a gauge\n# TYPE t_a gauge\n",
    "unknown type": "# TYPE t_a weird\n",
    "trailing label junk": '# TYPE t_a gauge\nt_a{k="v"x} 1\n',
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_parser_refuses_the_same_inputs(case):
    for m in PKGS.values():
        with pytest.raises(ValueError):
            m["prom"].parse_exposition(MALFORMED[case])


@pytest.mark.parametrize("args", [(0.001, 60.0), (0.002, 120.0),
                                  (0.0005, 10.0), (0.01, 1000.0),
                                  (0.3, 7.0, 2), (1.0, 1e4, 1),
                                  (0.05, 3.0, 4)])
def test_log_buckets_ladders_equal(args):
    ref, port = both(lambda m: m["prom"].log_buckets(*args))
    assert port == ref


def test_log_buckets_refuse_bad_ranges():
    for m in PKGS.values():
        for lo, hi in ((0.0, 1.0), (1.0, 1.0), (2.0, 1.0)):
            with pytest.raises(ValueError):
                m["prom"].log_buckets(lo, hi)


# ---------------------------------------------------------------------------
# trace


def _normalise(spans):
    """A trace's span dicts with ids and times replaced by their order
    of appearance: [(name, parent name, process, attrs, event names)]."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    out = []
    for s in spans:
        attrs = {k: v for k, v in (s.get("attrs") or {}).items()}
        out.append((s["name"], by_id.get(s["parent_id"]), s["process"],
                    json.dumps(attrs, sort_keys=True),
                    tuple(sorted((e["name"], e.get("site", ""))
                                 for e in s.get("events", ())))))
    return sorted(out)


def _scenario_nesting(obs):
    with obs.start_trace("req", process="gateway", path="/ows") as tr:
        assert obs.current_trace_id() == tr.trace_id
        with obs.span("outer", n=1) as outer:
            with obs.span("inner") as inner:
                obs.set_attr(deep=True)
            assert inner.parent_id == outer.span_id
        assert outer.parent_id == tr.root.span_id
        obs.set_attr(verb="WMS.GetMap")
        with pytest.raises(RuntimeError):
            with obs.span("boom"):
                raise RuntimeError("nope")
        with obs.span("child"):
            obs.event("retry", site="mas")
        obs.record_span("admission.wait", 0.25, queued=3)
    assert obs.current_trace_id() is None
    spans = tr.span_dicts()
    rs = [s for s in spans if s["name"] == "admission.wait"][0]
    assert rs["dur_s"] == 0.25 and rs["t0"] <= spans[0]["t0"] + 60
    assert all(s["dur_s"] is not None for s in spans)
    return _normalise(spans)


def _scenario_fanout(obs):
    from concurrent.futures import ThreadPoolExecutor

    def job(i):
        with obs.span("fan.child", i=i):
            return obs.current_trace_id()

    seen = {}

    def raw(ctx):
        seen["bare"] = obs.current_trace_id()
        with obs.bind(ctx):
            seen["bound"] = obs.current_trace_id()
            with obs.span("raw.child"):
                pass
        seen["after"] = obs.current_trace_id()

    with obs.start_trace("req") as tr:
        with ThreadPoolExecutor(max_workers=4) as pool:
            ctxs = [(contextvars.copy_context(), i) for i in range(8)]
            tids = list(pool.map(lambda a: a[0].run(job, a[1]), ctxs))
        t = threading.Thread(target=raw, args=(obs.current_context(),))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert set(tids) == {tr.trace_id}
    assert seen == {"bare": None, "bound": tr.trace_id, "after": None}
    return _normalise(tr.span_dicts())


def _scenario_remote(obs):
    with obs.start_trace("req") as tr:
        header = obs.traceparent()
        assert header == f"{tr.trace_id}-{tr.root.span_id}"
        foreign = [{"span_id": "f1", "parent_id": tr.root.span_id,
                    "name": "worker.warp", "process": "worker",
                    "t0": 1.0, "dur_s": 0.5}]
        obs.adopt_spans(foreign)
        obs.adopt_spans(None)
    with obs.remote_trace(header, "worker.warp", op="warp") as wt:
        assert wt.trace_id == tr.trace_id
        assert wt.root.parent_id == tr.root.span_id
        with obs.span("worker.decode"):
            pass
    shipped = [(s["name"], s["process"]) for s in wt.span_dicts()]
    refused = []
    for bad in (None, "", "justonepart", "-", "tid-"):
        with obs.remote_trace(bad, "worker.warp") as t:
            refused.append(t is None)
    obs.adopt_spans(foreign)             # untraced: dropped
    return _normalise(tr.span_dicts()), shipped, refused


def _scenario_disabled(obs, monkeypatch):
    monkeypatch.setenv("GSKY_TRACE", "0")
    rec = obs.default_recorder()
    before = rec.stats()["recorded"]
    with obs.start_trace("req") as tr:
        assert tr is None
        with obs.span("child") as sp:
            sp.set(ignored=1)
            sp.event("x")
            null = sp
        assert obs.current_trace_id() is None
        assert obs.traceparent() is None
        obs.event("retry")
        obs.record_span("x", 0.1)
        obs.set_attr(a=1)
    with obs.span("again") as sp2:
        pass
    monkeypatch.delenv("GSKY_TRACE")
    # the shared no-op handle, and nothing recorded
    return sp2 is null, rec.stats()["recorded"] - before


@pytest.mark.parametrize("scenario", ["nesting", "fanout", "remote"])
def test_trace_scenarios_equal(scenario):
    fn = {"nesting": _scenario_nesting, "fanout": _scenario_fanout,
          "remote": _scenario_remote}[scenario]
    ref, port = both(lambda m: fn(m["obs"]))
    assert port == ref


def test_trace_off_is_a_noop(monkeypatch):
    ref, port = both(lambda m: _scenario_disabled(m["obs"], monkeypatch))
    assert port == ref == (True, 0)


def test_completed_trace_reaches_the_recorder():
    def run(m):
        obs = m["obs"]
        with obs.start_trace("req", path="/ows") as tr:
            tr.status = 200
            tr.degraded = ["decode"]
        got = obs.default_recorder().lookup(tr.trace_id)
        return got["status"], got["degraded"], got["attrs"], \
            len(got["spans"])
    ref, port = both(run)
    assert port == ref == (200, ["decode"], {"path": "/ows"}, 1)


def test_ids_are_unique_hex():
    ids = set()
    for _ in range(2000):
        ids.add(tobs.trace._new_id())
    assert len(ids) == 2000
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)


# ---------------------------------------------------------------------------
# recorder


def _mk(tid, dur_s, status=200, degraded=(), attrs=None):
    return {"trace_id": tid, "name": "ows.request", "t0": 100.0,
            "dur_s": dur_s, "status": status, "degraded": list(degraded),
            "attrs": attrs or {},
            "spans": [{"span_id": tid + "-r", "parent_id": None,
                       "name": "ows.request", "process": "gateway",
                       "t0": 100.0, "dur_s": dur_s}]}


def _stream(seed, n=120):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        dur = rng.choice([0.001, 0.01, 0.05]) * rng.uniform(0.5, 2) \
            if rng.random() < 0.8 else rng.uniform(0.4, 3.0)
        status = rng.choice([200] * 8 + [404, 503])
        deg = ["decode"] if rng.random() < 0.1 else []
        attrs = {"error": "RuntimeError"} if rng.random() < 0.05 else {}
        out.append(_mk(f"t{seed}_{i}", round(dur, 6), status, deg, attrs))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_recorder_ring_and_reservoir_equal(seed, tmp_path):
    def run(m):
        path = tmp_path / (m["obs"].__name__ + ".jsonl")
        rec = m["recorder"].FlightRecorder(
            capacity=16, reservoir=5, slo_s=0.5, trace_file=str(path),
            sample=0.0)
        for t in _stream(seed):
            rec.record(t)
        return (rec.stats(), rec.dump_jsonl(), rec.summary(),
                rec.slowest(), path.read_text(),
                [rec.lookup(t["trace_id"]) is not None
                 for t in _stream(seed)])
    ref, port = both(run)
    assert port == ref
    st = port[0]
    assert st["recorded"] == 120 and st["retained"] == 16
    assert st["evicted"] == 104 and st["reservoir"] == 5
    # the file holds every SLO violation, sampled or not
    assert len(port[4].splitlines()) == st["slo_violations"]


def test_recorder_sampled_file_export(tmp_path):
    def run(m):
        path = tmp_path / (m["obs"].__name__ + "_s.jsonl")
        rec = m["recorder"].FlightRecorder(
            capacity=4, reservoir=2, slo_s=0.5, trace_file=str(path),
            sample=1.0)
        rec.record(_mk("fast", 0.01))
        rec.record(_mk("slow", 0.8))
        return [json.loads(ln)["trace_id"]
                for ln in path.read_text().splitlines()]
    ref, port = both(run)
    assert port == ref == ["fast", "slow"]


def test_recorder_env_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("GSKY_TRACE_RING", "7")
    monkeypatch.setenv("GSKY_TRACE_RESERVOIR", "3")
    monkeypatch.setenv("GSKY_TRACE_SLO_S", "1.5")
    monkeypatch.setenv("GSKY_TRACE_FILE", str(tmp_path / "t.jsonl"))
    monkeypatch.setenv("GSKY_TRACE_SAMPLE", "0.25")

    def run(m):
        m["recorder"].reset_recorder()
        rec = m["obs"].default_recorder()
        return (rec.capacity, rec.reservoir_cap, rec.slo_s,
                rec.trace_file, rec.sample, rec.stats())
    ref, port = both(run)
    assert port == ref
    assert port[:5] == (7, 3, 1.5, str(tmp_path / "t.jsonl"), 0.25)


# ---------------------------------------------------------------------------
# tsan


def _two_writers(fn):
    """Two threads alive together write through ``fn``: sequential
    joined threads may reuse one thread id."""
    a_done, b_done = threading.Event(), threading.Event()

    def writer_a():
        for _ in range(50):
            fn()
        a_done.set()
        b_done.wait(5.0)

    def writer_b():
        a_done.wait(5.0)
        for _ in range(50):
            fn()
        b_done.set()

    ts = [threading.Thread(target=writer_a), threading.Thread(target=writer_b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
        assert not t.is_alive()


def _tsan_run(tsan, monkeypatch, locked):
    monkeypatch.setenv("GSKY_TSAN", "1")
    tsan.reset()
    tsan.install()
    try:
        class Box:
            def __init__(self):
                self.lock = threading.Lock()
                self.n = 0

        box = Box()
        assert isinstance(box.lock, tsan.TsanLock)
        assert tsan.track(box, "Box")

        def bump():
            if locked:
                with box.lock:
                    box.n += 1
            else:
                box.n += 1

        for _ in range(2):
            _two_writers(bump)
        races = [(r.name, r.attr) for r in tsan.races()]
        st = tsan.tsan_stats()
        return (races, tsan.race_count(), st["races"],
                "RACE on Box.n" in tsan.report(),
                st["enabled"] and st["installed"])
    finally:
        tsan.uninstall()
        tsan.reset()
        monkeypatch.delenv("GSKY_TSAN")


@pytest.mark.parametrize("locked", [False, True])
def test_tsan_verdicts_equal(monkeypatch, locked):
    ref, port = both(lambda m: _tsan_run(m["tsan"], monkeypatch, locked))
    assert port == ref
    if locked:
        assert port == ([], 0, 0, False, True)
    else:
        assert port == ([("Box", "n")], 1, 1, True, True)


def test_tsan_off_is_inert(monkeypatch):
    monkeypatch.delenv("GSKY_TSAN", raising=False)
    for m in PKGS.values():
        tsan = m["tsan"]
        assert not tsan.enabled()
        assert tsan.maybe_install() is False
        assert not tsan.installed()
        assert threading.Lock is tsan._REAL_LOCK

        class Box:
            def __init__(self):
                self.x = 0

        assert tsan.track(Box(), "Box") is False
    # the port's collector shows no tsan family while it is off
    fams = tprom.parse_exposition(tobs.render_metrics())
    assert "gsky_tsan_races_total" not in fams


# ---------------------------------------------------------------------------
# resilience hooks


def test_retry_and_breaker_events_equal():
    def run(m):
        metrics = importlib.import_module(m["obs"].__name__ + ".metrics")
        kinds = ("retry", "retry_exhausted", "breaker_open", "degraded",
                 "deadline_exceeded")
        before = {k: metrics.TRACE_EVENTS.labels(kind=k).value
                  for k in kinds}
        reg = m["registry"].ResilienceRegistry()
        br = m["breaker"].CircuitBreaker("t-node", failure_threshold=2,
                                         register=False)
        with m["obs"].start_trace("req") as tr:
            reg.count_retry("mas")
            reg.count_exhausted("mas")
            reg.count_degraded()
            reg.count_deadline()
            br.record_failure()
            br.record_failure()          # trips open
            br.record_failure()          # already open: no second event
        root = tr.span_dicts()[0]
        return (sorted((e["name"], e.get("site", ""))
                       for e in root.get("events", ())),
                {k: metrics.TRACE_EVENTS.labels(kind=k).value - before[k]
                 for k in kinds})
    ref, port = both(run)
    assert port == ref
    assert port[1] == dict.fromkeys(("retry", "retry_exhausted",
                                     "breaker_open", "degraded",
                                     "deadline_exceeded"), 1)
