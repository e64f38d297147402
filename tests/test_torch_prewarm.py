"""Port parity, the server-start prewarm: `gsky_tpu_torch.server.prewarm`
against `gsky_tpu.server.prewarm` over one config.json (the one of
`test_torch_server`), loaded by both packages' config watchers.

The lattice is the reference's: the same `layer_specs`,
`layer_expr_specs` (fingerprints compared by hash) and
`wave_size_lattice` for the same configs and knobs, and the same
`_ctrl_grid` and `_params` inputs.  ``GSKY_PREWARM=0`` is a no-op.  On
the CPU there is nothing to build: `prewarm` runs the kernels' plain
versions, one B1 launch per (method, tile edge, wave size) point and one
B2 per (method, tile edge), allocates the executor's page pool, and
`compile_count` does not move."""

import json

import numpy as np
import pytest

from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.server import prewarm as jpw
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher

from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.ops import cuda_lib, paged, warp_render
from gsky_tpu_torch.pipeline.executor import WarpExecutor
from gsky_tpu_torch.server import prewarm as tpw
from gsky_tpu_torch.server.config import ConfigWatcher

import test_torch_server as ts


@pytest.fixture(scope="module")
def watchers(tmp_path_factory):
    root = tmp_path_factory.mktemp("prewarm")
    conf = root / "conf"
    conf.mkdir()
    with open(conf / "config.json", "w") as fp:
        json.dump(ts._config(str(root), str(root / "legend.png")), fp)
    jmas, tmas = JMASClient(JMASStore()), MASClient(MASStore())
    return (JConfigWatcher(str(conf), mas_factory=lambda a: jmas,
                           install_signal=False),
            ConfigWatcher(str(conf), mas_factory=lambda a: tmas,
                          install_signal=False))


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    # the reference's waves (and so its wave lattice) need its paged
    # kernels, which run here in interpret mode
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    for k in ("GSKY_WAVES", "GSKY_WAVE_MAX", "GSKY_PREWARM",
              "GSKY_PREWARM_SIZES", "GSKY_PREWARM_WAVE_SIZES",
              "GSKY_PREWARM_BUCKET"):
        monkeypatch.delenv(k, raising=False)


def test_layer_specs_as_the_reference(watchers):
    jw, tw = watchers
    specs = tpw.layer_specs(tw.configs)
    assert specs == jpw.layer_specs(jw.configs)
    assert {n for _m, n, _a, _c in specs} == {1, 2, 3, 4}


def test_layer_expr_specs_as_the_reference(watchers):
    jw, tw = watchers

    def view(specs):
        return [(m, a, cs, fp.hash, fp.n_slots, tuple(fp.consts))
                for m, a, cs, fp in specs]

    got = view(tpw.layer_expr_specs(tw.configs))
    assert got == view(jpw.layer_expr_specs(jw.configs)) and got


@pytest.mark.parametrize("env", [
    {}, {"GSKY_WAVES": "0"}, {"GSKY_WAVE_MAX": "8"},
    {"GSKY_WAVE_MAX": "1"}, {"GSKY_PREWARM_WAVE_SIZES": "3,1,100,x"},
    {"GSKY_PREWARM_WAVE_SIZES": "0"}])
def test_wave_size_lattice_as_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tpw.wave_size_lattice() == jpw.wave_size_lattice()


@pytest.mark.parametrize("hw,bucket,step", [(256, 512, 16), (100, 300, 16),
                                            (64, 64, 8)])
def test_inputs_as_the_reference(hw, bucket, step):
    np.testing.assert_array_equal(tpw._ctrl_grid(hw, hw, bucket, bucket,
                                                 step),
                                  jpw._ctrl_grid(hw, hw, bucket, bucket,
                                                 step))
    for n, pad, per_ns in ((1, None, False), (3, 4, True), (2, 8, False)):
        np.testing.assert_array_equal(
            tpw._params(n, bucket, bucket, pad, per_ns),
            jpw._params(n, bucket, bucket, pad, per_ns))


def test_prewarm_off_is_a_no_op(monkeypatch, watchers):
    monkeypatch.setenv("GSKY_PREWARM", "0")
    ex = WarpExecutor(device="cpu")
    calls = []
    monkeypatch.setattr(paged, "paged_render_scored",
                        lambda *a: calls.append(a))
    assert tpw.prewarm_from_watcher(watchers[1], ex) is None
    assert not ex.pool.allocated and not calls


def test_prewarm_on_the_cpu_runs_the_plain_versions(monkeypatch,
                                                    watchers):
    """One B1 launch per (method, tile edge, wave size) and one B2 per
    (method, tile edge) of every layer spec, one B1 per expression
    point; the plain versions run, nothing is built or loaded."""
    monkeypatch.setenv("GSKY_PREWARM_SIZES", "64,32")
    monkeypatch.setenv("GSKY_PREWARM_BUCKET", "128")
    monkeypatch.setenv("GSKY_WAVE_MAX", "4")
    b1, b2 = [], []
    r1, r2 = paged.paged_render_scored, warp_render.warp_render_scored
    monkeypatch.setattr(paged, "paged_render_scored",
                        lambda *a: b1.append(a[2].shape[0]) or r1(*a))
    monkeypatch.setattr(warp_render, "warp_render_scored",
                        lambda *a: b2.append(1) or r2(*a))
    builds = []
    monkeypatch.setattr(cuda_lib, "build_all",
                        lambda libs: builds.append(libs))
    ex = WarpExecutor(device="cpu")
    c0 = cuda_lib.compile_count()
    out = tpw.prewarm_from_watcher(watchers[1], ex)
    specs = tpw.layer_specs(watchers[1].configs)
    n_expr = len(tpw.layer_expr_specs(watchers[1].configs))
    waves = tpw.wave_size_lattice()
    assert waves == [1, 2, 4]
    assert out["failures"] == 0 and out["specs"] == len(specs)
    assert out["compiles"] == 0 and cuda_lib.compile_count() == c0
    assert not builds and ex.pool.allocated
    assert len(b2) == len(specs) * 2
    assert len(b1) == (len(specs) + n_expr) * 2 * len(waves)
    assert out["programs"] == len(b1) + len(b2)
    assert out["expr_programs"] == n_expr * 2 * len(waves)
    # B1's params rows: one granule a lane
    assert sorted(set(b1)) == waves
