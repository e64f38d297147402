"""The soak's wave scenarios (`tools/soak_torch.py`: occupancy, algebra,
animation) on the CPU, over `test_torch_soak`'s archive (four 512 x 512
scenes) and config.

Each runs in-process with ``device="cpu"`` (the kernels' plain versions
under the wave scheduler) and passes with nothing ``unmet`` but the
criteria read on the host's clock (`soak_torch.HOST_CLOCK`: the
occupancy's gap comparison, C.26), which are reported.  Each check
bites, on the criterion it breaks: a scheduler that never stages a wave
fails ``occupancy``; a fingerprint keyed on the source text (the twin
styles then mint programs of their own), an escape hatch that never
takes the unfused leg and an escape-hatch volley with no data (the
tiles at a date where the first product has no granule) fail
``algebra``; a sequence whose frames go to the scheduler one at a time
(a wave each) fails ``animation``; a pin never released fails
``algebra``.  The legs and storms are cut where
the fault's criterion does not need them.  The repair the occupancy
called for on the card: a wave's assembly no longer waits for the
dispatch before it (the pool's staging generation read without its
lock).

Parity with the JAX package (`test_torch_soak.pair`: the reference
with Pallas in interpret mode over the same archive and config): the
algebra layer's default tile and each of its eleven styled tiles, the
``algebraDrill`` CSV, and each frame of one APNG sequence (both
packages with waves on), nearest, decoded pixels identical.

Child processes, started together: the tool with ``jax``, ``gsky_tpu``
and ``bench`` blocked runs each scenario's ``--help``; ``--device cuda``
without CUDA exits naming CUDA.  Every wait has a timeout."""

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu.pipeline import waves as jwaves

from gsky_tpu_torch import resilience
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.io.png import apng_frames, decode_png
from gsky_tpu_torch.ops import expr
from gsky_tpu_torch.pipeline import tile, waves
from gsky_tpu_torch.pipeline.pages import PagePool
from gsky_tpu_torch.server import ows

from test_torch_soak import (HOST, LIMIT_S, REPO, _path, _same_png, both,
                             soak_args, st)
from test_torch_soak import pair, senv  # noqa: F401 (fixtures)
from test_torch_worker import time_limit
from test_torch_wps import _same_csv

NAMES = ("occupancy", "algebra", "animation")
# occupancy's legs are max(8, seconds / 2): the reference's shortest
SECONDS = {"occupancy": 16, "algebra": 2, "animation": 2}


@pytest.fixture
def fresh(senv):
    """Process-wide state cleared around a scenario: the resilience
    registry, the wave schedulers; a new MAS client (its breaker in the
    cleared registry); the scenario's servers closed after it."""
    resilience.reset()
    waves.reset_waves()
    senv.mas = MASClient(senv.store)
    yield
    senv.close()
    waves.reset_waves()
    resilience.reset()


def run(env, name, seconds=None):
    with time_limit(LIMIT_S):
        return st.RUNS[name](env, soak_args(seconds or SECONDS[name]))


# -- every scenario passes -------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_scenario_passes(senv, fresh, name):
    out, ok = run(senv, name)
    clocked = st.HOST_CLOCK.get(name, ())
    assert set(out["unmet"]) <= set(clocked), json.dumps(out)[:6000]
    assert ok is (out["unmet"] == [])
    assert out["scenario"] == name and out["device"] == "cpu"
    assert "card_memory" not in out and out["pool"]["pinned"] == 0
    if name == "occupancy":
        # the legs in turns, each round's lead-in kept out of its gaps
        # (C.26)
        assert out["rounds"] == "SPPSPSSP"
        assert out["leg_s"] == 8
        assert out["synchronous"]["staged_waves"] == 0
        assert out["pipelined"]["staged_waves"] >= 1
        for leg in ("synchronous", "pipelined"):
            rounds = out[leg]["rounds"]
            assert len(rounds) == 4
            assert all(r["lead_in_ms"] is not None for r in rounds)
    elif name == "algebra":
        assert (out["sources"], out["structures"]) == (12, 10)
        assert out["fused"]["programs"] <= 10
        assert out["escape_hatch_unfused"] >= 6
        # the one-product sources first: they hold data at this date
        assert out["escape_hatch_probe"][:4] == [
            "logr", "quant", "clip", "curve"]
        assert out["escape_hatch_with_data"] >= 4
    else:
        assert out["warm_amortisation"] == {"frames": 4, "waves": 1}
        assert out["requests"]["mp4"] >= 1


# -- the checks bite ---------------------------------------------------------

def test_occupancy_fails_when_no_wave_is_staged(senv, fresh, monkeypatch):
    """The pipelined leg's scheduler assembles and dispatches on its
    ticker, as the synchronous one does (its legs cut to 2 s)."""
    monkeypatch.setattr(waves, "wave_pipeline_enabled", lambda: False)
    monkeypatch.setattr(st, "OCCUPANCY_MIN_S", 2.0)
    out, ok = run(senv, "occupancy", 2)
    assert not ok and "staged" in out["unmet"], out["unmet"]
    assert out["pipelined"]["staged_waves"] == 0
    assert out["pipelined"]["failed"] == 0


def test_algebra_fails_on_a_fingerprint_of_the_source(senv, fresh,
                                                     monkeypatch):
    """The server's fingerprint keyed on the source text: each slot of
    the key carries its variable's name and each constant its value (it
    evaluates as before), so the twins (``nd_rev`` of ``nd``, ``mask2``
    of ``mask1``) launch programs of their own, twelve over ten
    structures."""
    def named(key, fp):
        tag = key[0]
        if tag == "slot":
            return key + (fp.slots[key[1]],)
        if tag == "const":
            return key + (fp.consts[key[1]],)
        if tag in ("un", "bin"):
            return key[:2] + tuple(named(k, fp) for k in key[2:])
        if tag == "tern":
            return key[:1] + tuple(named(k, fp) for k in key[1:])
        return key[:2] + (tuple(named(k, fp) for k in key[2]),)

    def by_source(ce):
        fp = expr.fingerprint(ce)
        key = named(fp.key, fp)
        return dataclasses.replace(fp, key=key,
                                   hash=expr.fingerprint_hash(key))

    monkeypatch.setattr(tile, "fingerprint", by_source)
    out, ok = run(senv, "algebra", 1)
    assert not ok and out["unmet"] == ["fingerprint_sharing"], out["unmet"]
    assert out["fused"]["programs"] == 12 and out["structures"] == 10


def test_algebra_fails_on_an_escape_hatch_left_fused(senv, fresh,
                                                    monkeypatch):
    """``GSKY_EXPR_FUSE=0`` ignored: the volley is fused again, the same
    bytes, and the unfused counter stays."""
    monkeypatch.setattr(tile, "expr_fuse_enabled", lambda: True)
    out, ok = run(senv, "algebra", 1)
    assert not ok and out["unmet"] == ["escape_hatch_unfused"], \
        out["unmet"]
    assert out["escape_hatch_byte_identical"]
    assert out["escape_hatch_unfused"] == 0


def test_algebra_fails_on_an_escape_hatch_without_data(senv, fresh,
                                                      monkeypatch):
    """Every algebra tile at the second date, where the first product
    has no granule: the volley's bodies are all nodata, byte-identical
    and unfused as before, and show nothing of the fused arithmetic."""
    to_url = st.SoakEnv.algebra_url

    def second_date(self, host, style, tile):
        return to_url(self, host, style, tile).replace(
            st.iso(self.dates[0]), st.iso(self.dates[1]))

    monkeypatch.setattr(st.SoakEnv, "algebra_url", second_date)
    out, ok = run(senv, "algebra", 1)
    assert not ok and out["unmet"] == ["escape_hatch_has_data"], \
        out["unmet"]
    assert out["escape_hatch_byte_identical"]
    assert out["escape_hatch_with_data"] == 0


def test_algebra_fails_on_a_pin_never_released(senv, fresh, monkeypatch):
    monkeypatch.setattr(PagePool, "unpin", lambda self, slots: None)
    out, ok = run(senv, "algebra", 1)
    assert not ok and "unpinned" in out["unmet"], out["unmet"]
    assert out["pool_pinned"] > 0


def test_animation_fails_on_a_wave_a_frame(senv, fresh, monkeypatch):
    """A sequence's frames sent to the scheduler one at a time: each
    frame its own wave, the warm sequence not amortised."""
    monkeypatch.setattr(ows, "_anim_workers", lambda: 1)
    out, ok = run(senv, "animation", 1)
    assert not ok and out["unmet"] == ["warm_amortised"], out["unmet"]
    assert out["warm_amortisation"] == {"frames": 4, "waves": 4}


# -- the repair the occupancy called for -----------------------------------

def test_assembly_does_not_wait_for_a_dispatch():
    """A wave's assembly takes the pool's staging generation while the
    wave before it is dispatched under the pool's lock: it does not wait
    for that dispatch (on the card the pipelined leg's assembly waited
    15 ms at the median for the lock, and its gaps outgrew the
    synchronous leg's), and a teardown after it still voids the token."""
    pool = PagePool(capacity=4, page_rows=8, page_cols=128, device="cpu")
    held, release = threading.Event(), threading.Event()

    def dispatch():
        with pool.locked_pool():
            held.set()
            release.wait(10)

    t = threading.Thread(target=dispatch)
    t.start()
    try:
        assert held.wait(10)
        t0 = time.perf_counter()
        gen = pool.handoff()
        waited = time.perf_counter() - t0
    finally:
        release.set()
        t.join(10)
    assert waited < 0.5 and pool.handoff_ok(gen)
    pool.teardown()
    assert not pool.handoff_ok(gen) and pool.handoff_ok(pool.handoff())


# -- parity with the JAX package ------------------------------------------

@pytest.mark.parametrize("k", range(12))
def test_algebra_tiles_equal_the_reference(senv, pair, k):
    """The default ``nd`` tile (k 0) and each styled tile, at the warm
    lap's tile: fused in the port, the reference's per-call route.  At
    the soak's date only the first product has a granule (scene ``i``
    is product ``i % 4`` at its own date), so a style over both
    products is all nodata, in both packages (C.27); a style over the
    first alone has data."""
    lay = next(iter(senv.watcher.configs.values())).layer(
        "landsat_algebra")
    styles = [lay] + list(lay.styles)
    a = _same_png(*both(pair, senv.algebra_url(
        HOST, "" if k == 0 else styles[k].name, senv.algebra_tiles()[k])),
        f"algebra {k}")
    n_vars = len(expr.parse_band_expressions(
        styles[k].rgb_products).var_list)
    assert (np.count_nonzero(a[..., 3]) > 0) is (n_vars == 1)


def test_algebra_drill_equals_the_reference(senv, pair):
    """The ``algebraDrill`` over both dates of its products: one CSV of
    ``nd`` and ``dif``, no value at either date, since each date holds
    one of the two products (C.27), in both packages."""
    blocks = _same_csv(*both(pair, senv.drill_url(
        HOST, "algebraDrill", at=(0.40, 0.45))))
    assert [line.split(",") for line in blocks[0].splitlines()] == [
        ["2020-01-10", "", ""], ["2020-01-11", "", ""]]


def test_animation_frames_equal_the_reference(senv, pair, monkeypatch):
    """One sequence over every date, both packages on their wave path:
    the same four frames."""
    monkeypatch.setenv("GSKY_WAVES", "1")
    jwaves.reset_waves()
    waves.reset_waves()
    try:
        url = senv.anim_url(HOST, senv.anim_tiles()[12])
        with time_limit(LIMIT_S):
            status, ctype, body = pair["jax"].get(_path(url))
            with urllib.request.urlopen(
                    f"http://{pair['host']}{_path(url)}", timeout=60) as r:
                got, frames_hdr = r.read(), r.headers["X-Gsky-Anim-Frames"]
                assert (r.status, r.headers.get_content_type()) == \
                    (status, ctype) == (200, "image/apng")
    finally:
        jwaves.reset_waves()
        waves.reset_waves()
    ref = [jdecode_png(f) for f in apng_frames(body)]
    frames = [decode_png(f) for f in apng_frames(got)]
    assert frames_hdr == "4" and len(ref) == len(frames) == 4
    for i, (a, b) in enumerate(zip(ref, frames)):
        assert a.shape == b.shape and np.array_equal(a, b), \
            (i, int(np.count_nonzero(a != b)))
    assert any(np.count_nonzero(f[..., 3]) for f in frames)


# -- child processes ----------------------------------------------------------

HELP_CODE = (
    "import sys\n"
    "sys.modules['jax'] = sys.modules['gsky_tpu'] = None\n"
    "sys.modules['bench'] = None\n"
    "sys.path.insert(0, 'tools')\n"
    "import soak_torch\n"
    f"for name in {NAMES!r}:\n"
    "    try:\n"
    "        soak_torch.main(['--scenario', name, '--help'])\n"
    "    except SystemExit as e:\n"
    "        assert e.code == 0, e.code\n"
    "print(sorted(soak_torch.RUNS))\n")


@pytest.fixture(scope="module")
def children():
    """This file's child processes, started together and each waited
    for with a timeout: ``help``, and on a host without CUDA each
    scenario asked for cuda; name -> (returncode, stdout, stderr)."""
    runs = {"help": ["-c", HELP_CODE]}
    if not torch.cuda.is_available():
        for name in NAMES:
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
    assert stdout.count("usage:") == len(NAMES)
    for name in NAMES:
        assert f"'{name}'" in stdout.splitlines()[-1]


@pytest.mark.parametrize("name", NAMES)
def test_cuda_without_a_card_exits_naming_cuda(children, name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    rc, stdout, stderr = children[name]
    assert rc != 0 and "SOAK" not in stdout
    assert "CUDA" in stderr
