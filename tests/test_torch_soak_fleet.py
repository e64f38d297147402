"""The soak's fleet scenario (`tools/soak_torch.py`) on the CPU, beside
`test_torch_soak_ops.py` (overload and ingest) in a file of its own, so
that xdist's ``--dist loadfile`` runs the two side by side.

One fleet run over four 512 x 512 scenes, three worker nodes on the CPU
(``-device cpu``), is shared by the tests that read it: it passes, its
remote tiles mosaic in this process through B4's wrapper, and every
node it booted (the three, the revived one, the hedge coda's slow one)
answered its first ``worker_info`` with its decode child up: a node
listens only then (one that answered while its child still imported
torch was re-admitted by its router and queued its first tiles
2.9-7.9 s on the card, which the router hedged away).  A router that
never reroutes from a dead node fails the scenario.

Parity with the JAX package (`test_torch_soak.pair`): a fleet tile
through the port's worker node equals the reference's over the same
node, nearest, decoded RGBA identical (the reference's local tile, its
fused route, within 0.1% of the pixels).  A worker node asked for cuda
on a host without CUDA exits naming CUDA and never serves from the
CPU.  Every wait has a timeout and every node is killed in a fixture's
teardown."""

import numpy as np
import pytest
import torch

from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher
from gsky_tpu.server.metrics import MetricsLogger as JMetricsLogger
from gsky_tpu.server.ows import OWSServer as JOWSServer

from gsky_tpu_torch.fleet.router import FleetRouter
from gsky_tpu_torch.ops import first_valid

from test_torch_soak import (HOST, LIMIT_S, _path, _port_get, _same_png,
                             st)
from test_torch_soak import pair, senv  # noqa: F401 (fixtures)
from test_torch_soak_ops import _fresh, run
from test_torch_server import _JaxClient
from test_torch_worker import time_limit


@pytest.fixture(scope="module")
def fleet_run(senv):
    """One fleet run, B4's wrapper counted: (out, ok, B4 stack shapes)."""
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
            out, ok = run(senv, "fleet")
    finally:
        next(fresh, None)
    return out, ok, b4


def test_fleet_passes(fleet_run):
    out, ok, b4 = fleet_run
    assert ok and out["unmet"] == [], str(out)[:6000]
    assert out["scenario"] == "fleet" and out["device"] == "cpu"
    assert "card_memory" not in out
    # the remote tiles mosaic here, through B4's wrapper
    assert b4 and all(s[1:] == (256, 256) for s in b4)
    assert out["revived_state"] == "healthy"
    assert set(out["node_rss"]) == set(out["nodes"])
    assert all(r["end_mb"] > 0 and isinstance(r["kernels"], dict)
               for r in out["node_rss"].values())


def test_a_node_listens_once_its_decode_children_are_up(fleet_run):
    """Each boot's first ``worker_info`` finds its decode child ready:
    the three nodes, the revived one and the slow one."""
    out, _, _ = fleet_run
    pools = out["boot_pools"]
    assert len(pools) == 5, pools
    assert all(p["ready"] == p["size"] == 1 for p in pools.values()), pools


def test_fleet_fails_on_a_router_that_never_reroutes(senv, monkeypatch):
    """Every key to its ring home, live or dead.  Load phases cut to
    two seconds."""
    monkeypatch.setattr(FleetRouter, "candidates",
                        lambda self, key: self.ring.preference(key)[:1]
                        if key is not None else self.ring.nodes)
    monkeypatch.setattr(st, "FLEET_MIN_S", 2.0)
    fresh = _fresh(senv)
    next(fresh)
    try:
        out, ok = run(senv, "fleet")
    finally:
        next(fresh, None)
    assert not ok and "rerouted" in out["unmet"], out["unmet"]
    assert out["rerouted"] == 0


@pytest.fixture
def one_node(senv, tmp_path):
    nodes = st.Nodes(str(tmp_path), "cpu")
    port = st.free_port()
    nodes.spawn(port)
    try:
        with time_limit(LIMIT_S):
            assert nodes.wait_ready(port, 90), nodes.log_tail(port)
        senv.fleet_namespace([f"127.0.0.1:{port}"])
        yield nodes, port
    finally:
        nodes.close()
        senv.fleet_namespace(None)


def _reference_server(senv, monkeypatch):
    """A reference `OWSServer` over the soak's archive and its config
    tree as it is now, behind its own client; B4 in interpret mode (its
    `mosaic_stack` calls it without, which a CPU backend refuses)."""
    b4 = jpt.mosaic_first_valid_pallas
    monkeypatch.setattr(jpt, "mosaic_first_valid_pallas",
                        lambda stack, valid, interpret=False:
                        b4(stack, valid, interpret=True))
    jstore = JMASStore()
    for i, p in enumerate(senv.paths):
        rec = jextract(p)
        for ds in rec["geo_metadata"]:
            ds["namespace"] = st.product(i % st.N_PRODUCTS)
        jstore.ingest(rec)
    jmas = JMASClient(jstore)
    server = JOWSServer(JConfigWatcher(senv.conf_dir,
                                       mas_factory=lambda a: jmas,
                                       install_signal=False),
                        mas_factory=lambda a: jmas,
                        metrics=JMetricsLogger(), gateway=None, fabric=None)
    return _JaxClient(server)


def test_fleet_tile_equals_the_reference(senv, pair, one_node, monkeypatch):
    """A fleet tile warped on the port's worker node and mosaicked here
    equals the reference's, whose fleet namespace names the same node
    (each package's worker against the other's:
    `tests/test_torch_worker.py`); the reference's local tile, through
    its fused route rather than the workers' gather, agrees on all but
    a few boundary pixels, as in the reference (`test_torch_worker.
    test_remote_plain_tile_vs_local_and_reference`)."""
    nodes, port = one_node
    tile = senv.fleet_tiles()[4]
    path = _path(senv.fleet_url(HOST, tile))
    ref = _reference_server(senv, monkeypatch)
    try:
        with time_limit(LIMIT_S):
            got = _port_get(pair, path)
            remote = ref.get(path)
            local = ref.get(_path(senv.fleet_url(HOST, tile, "landsat",
                                                 "")))
    finally:
        ref.close()
    a = _same_png(remote, got, "fleet tile")
    assert np.count_nonzero(a[..., 3]) > 0
    b = jdecode_png(local[2])
    assert np.mean((a != b).any(-1)) < 0.001
    assert nodes.info(port)["pool"]


def test_a_node_asked_for_cuda_never_serves_from_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    nodes = st.Nodes(str(tmp_path), "cuda")
    port = st.free_port()
    nodes.spawn(port)
    try:
        with time_limit(LIMIT_S):
            assert not nodes.wait_ready(port, 90)
            nodes.procs[port].wait(30)
    finally:
        nodes.close()
    assert nodes.procs[port].returncode != 0
    assert "CUDA" in nodes.log_tail(port)
