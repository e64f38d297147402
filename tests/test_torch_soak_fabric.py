"""The soak's fabric scenario (`tools/soak_torch.py`) on the CPU, in a
file of its own so that xdist's ``--dist loadfile`` runs it beside the
other soak files.

One fabric run over four 512 x 512 scenes, three worker nodes on the
CPU (``-device cpu``, a page journal each), is shared by the tests that
read it: it passes with nothing ``unmet``; its remote tiles mosaic in
this process through B4's wrapper; the cold replica serves the hot set
from the survivor's bytes; the revived node's warm boot refills its pool
from the page peer in this process (the real worker RPC over the pool
the seed lap filled); and every node it booted (the three and the
revived one) answered its first ``worker_info`` with its decode child
up.  A replay fabric whose peer fetch never hits fails the replay rate,
by name.

Parity with the JAX package (`test_torch_soak.pair`): the escape-hatch
leg's tile (``GSKY_FABRIC=0``, the fabric namespace through one port
worker node) equals the reference's over the same node, nearest,
decoded RGBA identical.  The tool with ``jax``, ``gsky_tpu`` and
``bench`` blocked runs the scenario's ``--help``; ``--device cuda``
without CUDA exits naming CUDA.  Every wait has a timeout and every node
is killed in teardown."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gsky_tpu_torch.fabric.replay import ReplayFabric
from gsky_tpu_torch.ops import first_valid

from test_torch_soak import (HOST, LIMIT_S, REPO, _path, _port_get,
                             _same_png, soak_args, st)
from test_torch_soak import pair, senv  # noqa: F401 (fixtures)
from test_torch_soak_fleet import _reference_server
from test_torch_soak_ops import _fresh
from test_torch_worker import time_limit

SECONDS = 2


def run(env, seconds=SECONDS):
    # three node boots, a revival and its warm boot inside the run
    with time_limit(LIMIT_S * 3):
        return st.RUNS["fabric"](env, soak_args(seconds))


@pytest.fixture(scope="module")
def fabric_run(senv):
    """One fabric run, B4's wrapper counted: (out, ok, B4 stack shapes)."""
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


def test_fabric_passes(fabric_run):
    out, ok, b4 = fabric_run
    assert ok and out["unmet"] == [], str(out)[:6000]
    assert out["scenario"] == "fabric" and out["device"] == "cpu"
    assert "card_memory" not in out and out["pool"]["pinned"] == 0
    # the remote tiles mosaic here, through B4's wrapper
    assert b4 and all(s[1:] == (256, 256) for s in b4)
    assert out["storm"].get("ok", 0) > 0 and out["hard_answers"] == []
    assert out["recovery_replay"]["rate"] >= 0.5
    assert out["fabric_off"] == {"identical": True,
                                 "outcomes": {"disabled": 1}}
    assert set(out["node_rss"]) == set(out["nodes"])
    assert all(r["end_mb"] > 0 and isinstance(r["kernels"], dict)
               for r in out["node_rss"].values())


def test_the_revived_node_refills_from_the_page_peer(fabric_run):
    """The killed node, revived with this process's page peer, took
    the seed lap's hot set (its own journal empty: ``journal_export``)
    and every page it restored came over ``page_fetch``."""
    out, _, _ = fabric_run
    ref = out["worker_refill"]
    assert ref["back"] and ref["seeded"] > 0
    assert ref["peer_filled"] == ref["rehydrated"] > 0, ref


def test_every_boot_listens_with_its_decode_child_up(fabric_run):
    out, _, _ = fabric_run
    pools = out["boot_pools"]
    assert len(pools) == 4, pools
    assert all(p["ready"] == p["size"] == 1 for p in pools.values()), pools
    # each boot's executor on the device asked for
    assert set(out["boot_platforms"]) == set(pools)
    assert set(out["boot_platforms"].values()) == {"cpu"}


def test_fabric_fails_when_replays_never_hit(senv, monkeypatch):
    """A replay fabric whose peer fetch never finds the owner's bytes:
    the cold replica renders its hot set, and the replay rate fails.
    The storm cut to two seconds."""
    monkeypatch.setattr(ReplayFabric, "_fetch_one",
                        lambda self, peer, key: None)
    monkeypatch.setattr(st, "FABRIC_MIN_S", 2.0)
    fresh = _fresh(senv)
    next(fresh)
    try:
        out, ok = run(senv)
    finally:
        next(fresh, None)
    assert not ok and "replay_rate" in out["unmet"], out["unmet"]
    assert out["recovery_replay"]["rate"] == 0.0
    assert out["recovery_peer_served"] == 0


# -- parity with the JAX package ------------------------------------------

@pytest.fixture
def fabric_node(senv, tmp_path):
    nodes = st.Nodes(str(tmp_path), "cpu")
    port = st.free_port()
    nodes.spawn(port, {"GSKY_POOL_JOURNAL":
                       str(tmp_path / "journal.jsonl")})
    try:
        with time_limit(LIMIT_S):
            assert nodes.wait_ready(port, 90), nodes.log_tail(port)
        senv.fleet_namespace([f"127.0.0.1:{port}"], "fabric")
        yield nodes, port
    finally:
        nodes.close()
        senv.fleet_namespace(None, "fabric")


def test_escape_hatch_tile_equals_the_reference(senv, pair, fabric_node,
                                               monkeypatch):
    """``GSKY_FABRIC=0``: the escape-hatch leg's tile (the fabric grid's
    first, through a port worker node, mosaicked here) equals the
    reference's, whose fabric namespace names the same node."""
    monkeypatch.setenv("GSKY_FABRIC", "0")
    tile = senv.fleet_tiles(st.FABRIC_GRID)[0]
    path = _path(senv.fleet_url(HOST, tile, "landsat_fabric", "/fabric"))
    ref = _reference_server(senv, monkeypatch)
    try:
        with time_limit(LIMIT_S):
            got = _port_get(pair, path)
            want = ref.get(path)
    finally:
        ref.close()
    a = _same_png(want, got, "fabric escape hatch")
    assert np.count_nonzero(a[..., 3]) > 0


# -- child processes ----------------------------------------------------------

HELP_CODE = (
    "import sys\n"
    "sys.modules['jax'] = sys.modules['gsky_tpu'] = None\n"
    "sys.modules['bench'] = None\n"
    "sys.path.insert(0, 'tools')\n"
    "import soak_torch\n"
    "try:\n"
    "    soak_torch.main(['--scenario', 'fabric', '--help'])\n"
    "except SystemExit as e:\n"
    "    assert e.code == 0, e.code\n"
    "print(sorted(soak_torch.RUNS))\n")


def test_help_without_jax():
    r = subprocess.run([sys.executable, "-c", HELP_CODE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "usage:" in r.stdout
    assert "'fabric'" in r.stdout.splitlines()[-1]


def test_cuda_without_a_card_exits_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = subprocess.run([sys.executable, "tools/soak_torch.py",
                        "--scenario", "fabric", "--device", "cuda",
                        "--seconds", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "SOAK" not in r.stdout
    assert "CUDA" in r.stderr
