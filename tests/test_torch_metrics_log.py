"""Port parity, the per-request metrics log: the port's
`server.metrics` against the JAX package's on the same seeded inputs.

`MetricsCollector.set_remote` over the four address forms; the
``/debug`` summary's counts and percentiles over seeded durations,
statuses and verbs; the rolling reservoir capping the window but not
the count; the staged tile and export folds; the stdout sink flushing
each record; size rotation, gzip and retention under a faked clock; the
record's ``trace_id`` taken from the request's trace; the record's
schema, key for key, and its ``cache`` block's tiers."""

import datetime as real_dt
import gzip
import importlib
import itertools
import json
import os
import random
import types

import pytest

import gsky_tpu.obs as jobs
import gsky_tpu.server.metrics as JM

import gsky_tpu_torch.obs as tobs
import gsky_tpu_torch.server.metrics as TM

MODS = {"ref": (JM, jobs), "port": (TM, tobs)}


def both(fn):
    return fn(*MODS["ref"]), fn(*MODS["port"])


@pytest.mark.parametrize("addr", ["10.1.2.3:5001", "[2001:db8::1]:8443",
                                  "10.1.2.3", "2001:db8::1", "",
                                  "[::1]"])
def test_set_remote_forms(addr):
    def run(M, _obs):
        c = M.MetricsLogger().collector()
        c.set_remote(addr)
        return (c.info["remote_addr"], c.info["remote_host"],
                c.info["remote_port"])
    ref, port = both(run)
    assert port == ref


def _info(service="WMS", request="GetMap", dur_ms=10.0, status=200,
          device_ms=0.0, rpc_ms=0.0, dap=False):
    q = {"dap4.ce": "/x"} if dap else {"service": service,
                                       "request": request}
    return {"url": {"query": q}, "req_duration": int(dur_ms * 1e6),
            "http_status": status, "device": {"duration": int(device_ms
                                                             * 1e6)},
            "rpc": {"duration": int(rpc_ms * 1e6)}}


def _stream(seed, n):
    rng = random.Random(seed)
    verbs = [("WMS", "GetMap"), ("WCS", "GetCoverage"),
             ("WPS", "Execute"), ("WMS", "GetCapabilities")]
    out = []
    for _ in range(n):
        svc, req = rng.choice(verbs)
        out.append(_info(svc, req, dur_ms=rng.lognormvariate(2, 1),
                         status=rng.choice([200] * 6 + [400, 404, 503]),
                         device_ms=rng.uniform(0, 5),
                         rpc_ms=rng.uniform(0, 20),
                         dap=rng.random() < 0.1))
    return out


def _requests_block(M, infos):
    ml = M.MetricsLogger()
    for info in infos:
        ml.record_summary(info)
    return ml.summary()["requests"]


@pytest.mark.parametrize("seed", range(4))
def test_summary_percentiles_equal(seed):
    infos = _stream(seed, 300)
    ref, port = both(lambda M, _o: _requests_block(M, infos))
    assert port == ref
    assert sum(v["count"] for v in port.values()) == 300


def test_known_distribution_and_reservoir():
    def run(M, _o):
        ml = M.MetricsLogger()
        for ms in range(1, 101):
            ml.record_summary(_info(dur_ms=ms))
        a = ml.summary()["requests"]["WMS.GetMap"]
        for _ in range(M.MetricsLogger._RESERVOIR + 88):
            ml.record_summary(_info(service="WCS", request="GetCoverage",
                                    dur_ms=5))
        b = ml.summary()["requests"]["WCS.GetCoverage"]
        return a, b
    ref, port = both(run)
    assert port == ref
    a, b = port
    assert (a["p50_ms"], a["p99_ms"], a["window"]) == (51.0, 100.0, 100)
    assert b["count"] == TM.MetricsLogger._RESERVOIR + 88
    assert b["window"] == TM.MetricsLogger._RESERVOIR


def test_tile_and_export_folds_equal():
    rng = random.Random(3)
    tiles = [{"plan_s": rng.random() / 100, "index_s": rng.random() / 50,
              "decode_s": rng.random() / 10, "dispatch_s": rng.random(),
              "readback_s": rng.random() / 5, "encode_s": rng.random() / 9,
              "granules": rng.randint(1, 6),
              "decode_queue_max": rng.randint(1, 4),
              "dispatch_queue_max": rng.randint(1, 3)} for _ in range(7)]
    exports = [{"tiles": 4, "granules": 3, "index_queries": 1,
                "decode_s": rng.random(), "warp_s": rng.random(),
                "encode_s": rng.random(), "wall_s": 2.0,
                "warp_queue_max": rng.randint(1, 4),
                "paged_engaged": 2} for _ in range(3)]

    def run(M, _o):
        ml = M.MetricsLogger()
        for t in tiles:
            ml.record_tile(dict(t))
        for e in exports:
            ml.record_export(dict(e))
        doc = ml.summary()
        doc["tile_stages"].pop("gates")
        return doc["tile_stages"], doc["export_pipeline"]
    ref, port = both(run)
    # each package's process-wide encode pool: the same stats, its own
    # history
    assert set(port[0].pop("encode_pool")) == set(ref[0].pop("encode_pool"))
    assert port == ref
    assert port[0]["tiles"] == 7 and port[1]["exports"] == 3


def test_stage_histograms_observed():
    def run(M, obs):
        fam = importlib.import_module(obs.__name__ + ".metrics") \
            .STAGE_SECONDS
        before = {s: fam.labels(stage=s).count
                  for s in ("dispatch", "export_warp")}
        ml = M.MetricsLogger()
        ml.record_tile({"dispatch_s": 0.5, "granules": 2})
        ml.record_export({"warp_s": 0.25})
        return {s: fam.labels(stage=s).count - before[s] for s in before}
    ref, port = both(run)
    assert port == ref == {"dispatch": 1, "export_warp": 1}


def test_stdout_sink_flushes_each_record(monkeypatch):
    def run(M, _o):
        events = []

        class FakeOut:
            def write(self, s):
                events.append(("write", s))

            def flush(self):
                events.append(("flush", None))
        monkeypatch.setattr(M.sys, "stdout", FakeOut())
        M.MetricsLogger().write({"a": 1})           # no sink: nothing
        M.MetricsLogger(verbose=True).write({"a": 1})
        return events
    ref, port = both(run)
    assert port == ref == [("write", '{"a":1}\n'), ("flush", None)]


def test_rotation_gzip_and_retention(tmp_path, monkeypatch):
    def run(M, _o):
        seq = itertools.count()

        class _FakeDateTime:
            @staticmethod
            def now(tz=None):
                return (real_dt.datetime(2026, 1, 1,
                                         tzinfo=real_dt.timezone.utc)
                        + real_dt.timedelta(seconds=next(seq)))
        monkeypatch.setattr(M, "dt", types.SimpleNamespace(
            datetime=_FakeDateTime, timezone=real_dt.timezone))
        d = tmp_path / M.__name__
        ml = M.MetricsLogger(log_dir=str(d))
        ml.max_size = 1          # every write overflows: rotate next
        ml.max_files = 2
        for i in range(6):
            ml.write({"i": i})
        ml.flush()
        names = sorted(os.listdir(d))
        recs = []
        for f in names:
            opener = gzip.open if f.endswith(".gz") else open
            with opener(d / f, "rt") as fp:
                recs.append([json.loads(ln) for ln in fp])
        return names, recs
    ref, port = both(run)
    assert port == ref
    names, recs = port
    assert sum(f.endswith(".log") for f in names) == 1
    assert sum(f.endswith(".log.gz") for f in names) == 2
    assert recs == [[{"i": 3}], [{"i": 4}], [{"i": 5}]]


def test_record_takes_the_trace_id():
    def run(M, obs):
        c = M.MetricsLogger().collector()
        with obs.start_trace("req") as tr:
            c.log(200)
        untraced = M.MetricsLogger().collector()
        untraced.log(404)
        return c.info["trace_id"] == tr.trace_id, untraced.info["trace_id"]
    ref, port = both(run)
    assert port == ref == (True, "")


def _shape(d):
    """A record's keys, nested, with the value types of its leaves."""
    if isinstance(d, dict):
        return {k: _shape(v) for k, v in d.items()}
    return type(d).__name__


def test_record_schema_equal():
    def run(M, _o):
        c = M.MetricsLogger().collector()
        c.set_url("/ows?service=WMS&request=GetMap&foo=1", "/ows",
                  {"service": "WMS", "request": "GetMap", "foo": "1",
                   "bbox": "0,0,1,1", "dap4.ce": "x"})
        c.set_remote("10.0.0.1:80")
        c.log(200)
        info = dict(c.info)
        cache = info.pop("cache")
        return _shape(info), sorted(cache), info["url"]
    ref, port = both(run)
    assert port == ref
    assert port[1] == ["drill_stack", "mas_query", "response", "scene"]
    assert sorted(port[2]["query"]) == ["bbox", "dap4.ce", "request",
                                        "service"]


def test_reserved_query_params_equal():
    assert TM.RESERVED_QUERY_PARAMS == JM.RESERVED_QUERY_PARAMS
