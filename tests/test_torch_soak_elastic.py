"""The soak's elastic scenario (`tools/soak_torch.py`) on the CPU, in a
file of its own so that xdist's ``--dist loadfile`` runs it beside the
other soak files.

One elastic run over four 512 x 512 scenes, the autoscaler over local
node processes on the CPU (`LocalSubprocessProvider`, ``-device cpu``, a
page journal each), is shared by the tests that read it: it passes with
nothing ``unmet``; its remote tiles mosaic in this process through B4's
wrapper; a join waited for the warm probe; both preemptions were
noticed, purged and counted; and the hand-off refilled the inherited hot
set from peers.  C.28: the page peer in this process is up before the
first node boots, so each preempted node held the seed lap's hot set
from its warm boot and ships it.  C.29: a third member joins, scaled up
by demand at the ramp's top load, before the quiet phase.  An
autoscaler in this process that never decides ``down`` fails the
scale-down, by name (the wait for it cut).

Parity with the JAX package (`test_torch_soak.pair`): the escape-hatch
leg's tile (``GSKY_ELASTIC=0``, the first grid tile of the default
namespace) equals the reference's, nearest, decoded RGBA identical.  The
tool with ``jax``, ``gsky_tpu`` and ``bench`` blocked runs the
scenario's ``--help``; ``--device cuda`` without CUDA exits naming CUDA.
Every wait has a timeout and every node is killed in teardown."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gsky_tpu_torch.fleet import elastic
from gsky_tpu_torch.ops import first_valid

from test_torch_soak import (HOST, LIMIT_S, REPO, _same_png, both,
                             soak_args, st)
from test_torch_soak import pair, senv  # noqa: F401 (fixtures)
from test_torch_soak_ops import _fresh
from test_torch_worker import time_limit

SECONDS = 2


def run(env, seconds=SECONDS):
    # node boots, launches, two preemptions and the waits between them
    with time_limit(LIMIT_S * 4):
        return st.RUNS["elastic"](env, soak_args(seconds))


@pytest.fixture(scope="module")
def elastic_run(senv):
    """One elastic run, B4's wrapper counted: (out, ok, B4 stack
    shapes)."""
    b4 = []
    kernel = first_valid.mosaic_first_valid_kernel

    def counted(stack, valid):
        b4.append(tuple(stack.shape))
        return kernel(stack, valid)

    fresh = _fresh(senv)
    next(fresh)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(first_valid, "mosaic_first_valid_kernel", counted)
            out, ok = run(senv)
    finally:
        next(fresh, None)
    return out, ok, b4


def test_elastic_passes(elastic_run):
    out, ok, b4 = elastic_run
    assert ok and out["unmet"] == [], str(out)[:6000]
    assert out["scenario"] == "elastic" and out["device"] == "cpu"
    assert "card_memory" not in out and out["pool"]["pinned"] == 0
    # the remote tiles mosaic here, through B4's wrapper
    assert b4 and all(s[1:] == (256, 256) for s in b4)
    assert out["hard_answers"] == []
    dirs = [d["dir"] for d in out["decisions"]]
    assert "up" in dirs and "join" in dirs and "down" in dirs
    assert out["counters"]["preemptions"]["graceful"] >= 1
    h = out["handoff"]
    assert h["entries"] > 0 and h["filled"] >= h["cold"] and not h["active"]
    assert out["elastic_off"] == {"identical": True, "dormant": True}
    # each boot's first answer found its decode child up
    pools = out["boot_pools"]
    assert len(pools) >= 3
    assert all(p["ready"] == p["size"] == 1 for p in pools.values()), pools
    assert set(out["boot_platforms"].values()) == {"cpu"}
    # where the time went, and when each decision came
    assert set(out["legs_s"]) >= {"boot", "ramp", "join", "steady", "down"}
    assert all(d["t_s"] >= 0 for d in out["decisions"])


def test_the_run_leaves_no_elastic_trace(elastic_run):
    """The knobs and counters are restored: a later scenario in this
    process renders no elastic family."""
    assert elastic.dormant()


def test_first_nodes_ship_the_seed_set_they_warm_booted(elastic_run):
    """C.28: with a journal a node, a node holds a hot set from its warm
    boot or a hand-off; the page peer is up before the first nodes boot,
    so each victim held the seed lap's pages from it."""
    out, _, _ = elastic_run
    notes = out["handoff_notes"]
    assert len(notes) == 2
    assert all(n["victim_peer_filled"] for n in notes), notes
    assert out["seeded"] > 0


def test_a_third_member_comes_from_demand_after_the_preemptions(
        elastic_run):
    """C.29: after the two preemptions the fleet is at its floor of two;
    under the ramp's top load the autoscaler launches a third member,
    which joins before the quiet phase, so that it has one to shed."""
    out, _, _ = elastic_run
    assert out["third_member"]
    d = out["decisions"]
    last_preempt = max(e["t_s"] for e in d if e["dir"] == "preempted")
    assert any(e["dir"] == "up" and e["t_s"] > last_preempt for e in d) \
        or sum(e["dir"] == "join" for e in d) >= 3, d


def test_elastic_fails_when_it_never_scales_down(senv, monkeypatch):
    """An autoscaler in this process whose scale-down does nothing: no
    ``down`` decision, and the scale-down fails (the wait for it cut to
    three seconds)."""
    monkeypatch.setattr(elastic.Autoscaler, "_scale_down",
                        lambda self, reason: None)
    monkeypatch.setattr(st, "ELASTIC_WAIT_S",
                        {**st.ELASTIC_WAIT_S, "down": 3.0})
    fresh = _fresh(senv)
    next(fresh)
    try:
        out, ok = run(senv)
    finally:
        next(fresh, None)
    assert not ok and "scale_down" in out["unmet"], out["unmet"]
    assert out["counters"]["decisions"]["down"] == 0
    assert "down" not in [d["dir"] for d in out["decisions"]]


# -- parity with the JAX package ------------------------------------------

def test_escape_hatch_tile_equals_the_reference(senv, pair, monkeypatch):
    """``GSKY_ELASTIC=0``: the escape-hatch leg's tile, the first of the
    grid in the default namespace, equals the reference's."""
    monkeypatch.setenv("GSKY_ELASTIC", "0")
    url = senv.fleet_url(HOST, senv.fleet_tiles()[0], "landsat", "")
    a = _same_png(*both(pair, url), "elastic escape hatch")
    assert np.count_nonzero(a[..., 3]) > 0


# -- child processes ----------------------------------------------------------

HELP_CODE = (
    "import sys\n"
    "sys.modules['jax'] = sys.modules['gsky_tpu'] = None\n"
    "sys.modules['bench'] = None\n"
    "sys.path.insert(0, 'tools')\n"
    "import soak_torch\n"
    "try:\n"
    "    soak_torch.main(['--scenario', 'elastic', '--help'])\n"
    "except SystemExit as e:\n"
    "    assert e.code == 0, e.code\n"
    "print(sorted(soak_torch.RUNS))\n")


def test_help_without_jax():
    r = subprocess.run([sys.executable, "-c", HELP_CODE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "usage:" in r.stdout
    assert "'elastic'" in r.stdout.splitlines()[-1]


def test_cuda_without_a_card_exits_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = subprocess.run([sys.executable, "tools/soak_torch.py",
                        "--scenario", "elastic", "--device", "cuda",
                        "--seconds", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "SOAK" not in r.stdout
    assert "CUDA" in r.stderr
