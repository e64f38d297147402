"""Port parity, the sharded steps: `gsky_tpu_torch.parallel` (the mesh,
its collectives, the reference-shaped render and drill steps, the
production `SpmdRenderer`, the multi-process runtime) against the JAX
package's `gsky_tpu.parallel`, the counterpart of
`tests/test_parallel.py`.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's
on 8 CPU members.  Inputs are made from a seed with numpy.  Bounds: the
reference-shaped render steps byte-identical (nearest taps); the
drill steps' counts exact and means within rtol 1e-5; the coordinate
strip (`_bilerp_grid(x0=)`) bit for bit the full grid's columns and the
jitted reference's strip; `SpmdRenderer` over 8 members equal to the
port's one member bit for bit, and within 1e-3 of pixels of the JAX
sharded tile (the reference's own bound between its sharded and
single-device programs); its drill reductions within rtol 1e-5, counts
exact.  The multi-process tests run two gloo processes under a time
limit."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsky_tpu.parallel import make_mesh as jmake_mesh
from gsky_tpu.parallel import make_sharded_drill as jmake_drill
from gsky_tpu.parallel import make_sharded_render as jmake_render
from gsky_tpu.parallel import make_sharded_render_padded as jmake_padded
from gsky_tpu.parallel.spmd import SpmdRenderer as JSpmd

from gsky_tpu_torch.ops import stats as tstats
from gsky_tpu_torch.ops import warp as twarp
from gsky_tpu_torch.parallel import distributed as tdist
from gsky_tpu_torch.parallel import mesh as tmesh
from gsky_tpu_torch.parallel import (make_sharded_drill,
                                     make_sharded_render,
                                     make_sharded_render_padded)
from gsky_tpu_torch.parallel.spmd import SpmdRenderer

import test_torch_kernels as tk
from test_torch_worker import time_limit

# gsky_tpu.ops re-exports a function named `warp` over its submodule
jwarp = importlib.import_module("gsky_tpu.ops.warp")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMBERS = 8


@pytest.fixture(autouse=True)
def _members(monkeypatch):
    monkeypatch.setenv("GSKY_CPU_DEVICES", str(MEMBERS))
    monkeypatch.delenv("GSKY_MESH_DEVICES", raising=False)


@pytest.fixture(scope="module")
def meshes():
    return jmake_mesh(MEMBERS), tmesh.make_mesh(
        devices=["cpu"] * MEMBERS)


def _scene(T=8, NS=2, H=48, W=48, h=32, w=64, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 100, (T, NS, H, W)).astype(np.float32)
    valid = rng.uniform(size=(T, NS, H, W)) > 0.3
    rows = rng.uniform(-2, H + 1, (T, h, w)).astype(np.float32)
    cols = rng.uniform(-2, W + 1, (T, h, w)).astype(np.float32)
    lut = np.stack([np.arange(256), np.arange(256) // 2,
                    255 - np.arange(256), np.full(256, 255)],
                   axis=1).astype(np.uint8)
    return src, valid, rows, cols, lut


def _jndvi(bands, valids):
    a, b = bands[0], bands[1]
    ok = valids[0] & valids[1]
    return jnp.where(ok, (a - b) / jnp.maximum(a + b, 1e-6), 0.0), ok


def _tndvi(bands, valids):
    a, b = bands[0], bands[1]
    ok = valids[0] & valids[1]
    return torch.where(ok, (a - b) / torch.clamp_min(a + b, 1e-6),
                       torch.zeros_like(a)), ok


# ---------------------------------------------------------------------------
# the reference-shaped steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combine", ["gather", "ring"])
@pytest.mark.parametrize("expr", [False, True])
def test_sharded_render_as_the_reference(meshes, combine, expr):
    jm, tm = meshes
    src, valid, rows, cols, lut = _scene()
    want = np.asarray(jmake_render(jm, expr=_jndvi if expr else None,
                                   combine=combine)(src, valid, rows, cols,
                                                    lut))
    before = tm.member_stats()
    got = make_sharded_render(tm, expr=_tndvi if expr else None,
                              combine=combine)(src, valid, rows, cols, lut)
    assert got.shape == (32, 64, 4) and got.device == tm.out_device
    np.testing.assert_array_equal(got.numpy(), want)
    # every member ran its body once
    assert [a - b for a, b in zip(tm.member_stats(), before)] \
        == [1] * MEMBERS


@pytest.mark.parametrize("T,w,seed,combine", [(5, 50, 9, "gather"),
                                             (3, 20, 10, "ring"),
                                             (8, 97, 12, "gather")])
def test_padded_render_as_the_reference(meshes, T, w, seed, combine):
    jm, tm = meshes
    src, valid, rows, cols, lut = _scene(T=T, w=w, seed=seed)
    want = np.asarray(jmake_padded(jm, combine=combine)(src, valid, rows,
                                                        cols, lut))
    got = make_sharded_render_padded(tm, combine=combine)(src, valid, rows,
                                                          cols, lut)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prime_member_count_mesh():
    jm, tm = jmake_mesh(7), tmesh.make_mesh(7, devices=["cpu"] * 7)
    assert tm.shape == {"granule": 1, "x": 7} == dict(jm.shape)
    src, valid, rows, cols, lut = _scene(T=4, h=16, w=30, seed=11)
    want = np.asarray(jmake_padded(jm)(src, valid, rows, cols, lut))
    got = make_sharded_render_padded(tm)(src, valid, rows, cols, lut)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpadded_step_refuses_a_ragged_stack(meshes):
    _, tm = meshes
    src, valid, rows, cols, lut = _scene(T=5, w=50)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_render(tm)(src, valid, rows, cols, lut)


def test_sharded_drill_as_the_reference(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(7)
    T, H, W = 8, 32, 64
    data = rng.uniform(0, 10, (T, H, W)).astype(np.float32)
    valid = rng.uniform(size=(T, H, W)) > 0.2
    valid[3] = False                      # an empty timestep: NaN mean
    mask = rng.uniform(size=(H, W)) > 0.5
    jmeans, jcounts = (np.asarray(a) for a in
                       jmake_drill(jm)(data, valid, mask))
    means, counts = make_sharded_drill(tm)(data, valid, mask)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    np.testing.assert_allclose(means.numpy(), jmeans, rtol=1e-5,
                               equal_nan=True)
    assert np.isnan(means[3])


# ---------------------------------------------------------------------------
# the coordinate strip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,nx,step", [(64, 4, 16), (97, 4, 16),
                                       (256, 8, 16), (100, 3, 8)])
def test_bilerp_strip_is_the_full_grid_slice(w, nx, step):
    rng = np.random.default_rng(w + nx)
    h = 48
    wp = -(-w // nx) * nx
    wl = wp // nx
    gh = (h - 1 + step - 1) // step + 1
    gw = (wp - 1 + step - 1) // step + 1
    ctrl = (rng.normal(size=(gh, gw)) * 300 + 1e4).astype(np.float32)
    full = twarp._bilerp_grid(torch.from_numpy(ctrl), h, wp, step)
    jstrip = jax.jit(jwarp._bilerp_grid, static_argnums=(1, 2, 3))
    for x in range(nx):
        strip = twarp._bilerp_grid(torch.from_numpy(ctrl), h, wl, step,
                                   x0=x * wl)
        np.testing.assert_array_equal(strip.numpy(),
                                      full[:, x * wl:(x + 1) * wl].numpy())
        np.testing.assert_array_equal(
            strip.numpy(), np.asarray(jstrip(jnp.asarray(ctrl), h, wl, step,
                                             x * wl)))


# ---------------------------------------------------------------------------
# SpmdRenderer
# ---------------------------------------------------------------------------

def _spmd_inputs(seed, B=5, w=64):
    stack, ctrl, params, h, _, step, n_ns = tk._inputs(seed=seed, B=B,
                                                        S=96, h=64, w=w)
    return stack, ctrl, params, (h, w), step, n_ns


@pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
@pytest.mark.parametrize("B,w", [(5, 64), (8, 97)])
def test_spmd_mosaic_equals_one_member_and_the_reference(meshes, method, B,
                                                         w):
    jm, tm = meshes
    stack, ctrl, params, hw, step, n_ns = _spmd_inputs(B, B=B, w=w)
    one = SpmdRenderer(tmesh.make_mesh(devices=["cpu"]))
    scenes = torch.from_numpy(stack)
    args = (torch.from_numpy(ctrl), params, method, n_ns, hw, step)
    c8, b8 = SpmdRenderer(tm).mosaic_scored(scenes, *args)
    c1, b1 = one.mosaic_scored(scenes, *args)
    assert c8.shape == (n_ns,) + hw
    np.testing.assert_array_equal(c8.numpy(), c1.numpy())
    np.testing.assert_array_equal(b8.numpy(), b1.numpy())
    jc, jb = (np.asarray(a) for a in JSpmd(jm).mosaic_scored(
        jnp.asarray(stack), jnp.asarray(ctrl), params, method, n_ns, hw,
        step))
    ok, jok = b8.numpy() > -np.inf, jb > -np.inf
    assert np.mean(ok != jok) <= 1e-3
    both = ok & jok
    assert np.mean(~np.isclose(c8.numpy()[both], jc[both], rtol=1e-6)) \
        <= 1e-3


def test_spmd_bodies_move_their_shards_to_the_member(meshes, monkeypatch):
    """B2 on each member gets its granule shard's scenes, its strip's
    coordinates and its params, every operand on the member's device
    (a pointer from another card would be an illegal address)."""
    from gsky_tpu_torch.parallel import spmd as tspmd
    _, tm = meshes
    stack, ctrl, params, hw, step, n_ns = _spmd_inputs(4, B=5, w=97)
    seen = []
    real = tspmd.warp_render_scored

    def spy(scenes, sx, sy, prm, *a):
        seen.append(({s.device for s in scenes} | {sx.device, sy.device,
                                                   prm.device},
                     len(scenes), tuple(sx.shape)))
        return real(scenes, sx, sy, prm, *a)

    monkeypatch.setattr(tspmd, "warp_render_scored", spy)
    SpmdRenderer(tm).mosaic_scored(torch.from_numpy(stack),
                                   torch.from_numpy(ctrl), params, "near",
                                   n_ns, hw, step)
    ng, nx = tm.shape["granule"], tm.shape["x"]
    wl = -(-hw[1] // nx)
    assert [(devs, n, shape) for devs, n, shape in seen] == [
        ({m}, -(-5 // ng), (hw[0], wl)) for m in tm.members]


@pytest.mark.parametrize("method,auto,cs", [("near", True, 0),
                                            ("bilinear", True, 1),
                                            ("cubic", False, 0)])
def test_spmd_composite_equals_one_member_and_the_reference(meshes, method,
                                                            auto, cs):
    jm, tm = meshes
    stack, ctrl, params, hw, step, n_ns = _spmd_inputs(3, B=6, w=97)
    sp = np.array([10.0, 0.06, 250.0], np.float32)
    args = (torch.from_numpy(ctrl), params, sp, method, n_ns, hw, step,
            auto, cs)
    scenes = [torch.from_numpy(s) for s in stack]
    t8 = SpmdRenderer(tm).render_composite(scenes, *args)
    t1 = SpmdRenderer(tmesh.make_mesh(devices=["cpu"])).render_composite(
        scenes, *args)
    assert t8.dtype == torch.uint8 and t8.shape == hw
    np.testing.assert_array_equal(t8.numpy(), t1.numpy())
    want = np.asarray(JSpmd(jm).render_composite(
        jnp.asarray(stack), jnp.asarray(ctrl), params, jnp.asarray(sp),
        method, n_ns, hw, step, auto, cs))
    assert np.mean(t8.numpy() != want) <= 1e-3


@pytest.mark.parametrize("pixel_count", [False, True])
@pytest.mark.parametrize("B,N", [(6, 3000), (9, 4099)])
def test_spmd_masked_stats(meshes, pixel_count, B, N):
    jm, tm = meshes
    data, valid = tk._b3_inputs(B * 13 + N, B, N, edge=True)
    v8, c8 = SpmdRenderer(tm).masked_stats(
        torch.from_numpy(data), torch.from_numpy(valid), -80.0, 120.0,
        pixel_count)
    jv, jc = (np.asarray(a) for a in JSpmd(jm).masked_stats(
        data, valid, -80.0, 120.0, pixel_count))
    np.testing.assert_array_equal(c8.numpy(), jc)
    np.testing.assert_allclose(v8.numpy(), jv, rtol=1e-5, atol=1e-6)
    # against the single-device B3 sums (float32 reassociation only)
    s, c = tstats.masked_stats(torch.from_numpy(data),
                               torch.from_numpy(valid), -80.0, 120.0)
    if not pixel_count:
        np.testing.assert_array_equal(c8.numpy(), c.numpy())
        np.testing.assert_allclose(
            v8.numpy(), np.where(c > 0, s.numpy() / np.maximum(c, 1), 0.0),
            rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the multi-process runtime
# ---------------------------------------------------------------------------

def test_global_mesh_process_major_at_world_size_one():
    m = tdist.global_mesh(device="cpu")
    assert m.shape == {"granule": 1, "x": MEMBERS}
    assert tdist.local_members(m) == list(range(MEMBERS))
    with pytest.raises(ValueError):
        tdist.global_mesh(shape=(3, 3), device="cpu")


_MULTI = r"""
import sys, numpy as np, torch
import torch.distributed as dist
from gsky_tpu_torch.parallel.distributed import (gather_granules,
    global_mesh, init_multihost, local_members)
port, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
init_multihost(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
mesh = global_mesh(device="cpu")
assert mesh.shape == {"granule": world, "x": 2}, mesh.shape
assert local_members(mesh) == [2 * rank, 2 * rank + 1]
rng = np.random.default_rng(rank)
part = torch.from_numpy(rng.uniform(0, 9, (4, 6)).astype(np.float32))
ok = torch.from_numpy(rng.uniform(size=(4, 6)) > 0.5)
data, valid = gather_granules(part, ok)
# rank order is priority order: rank 0's valid pixels win
want_ok = torch.zeros_like(ok)
want = torch.zeros_like(part)
for r in range(world):
    g = np.random.default_rng(r)
    p = torch.from_numpy(g.uniform(0, 9, (4, 6)).astype(np.float32))
    o = torch.from_numpy(g.uniform(size=(4, 6)) > 0.5)
    take = o & ~want_ok
    want = torch.where(take, p, want)
    want_ok |= o
assert torch.equal(valid, want_ok) and torch.equal(data[valid], want[valid])
dist.destroy_process_group()
print("MULTIHOST-OK", rank)
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [1, 2])
def test_init_multihost_and_the_granule_combine(world):
    """`init_multihost` (gloo), `global_mesh` process-major and the
    granule combine across ranks, in fresh processes (a process group is
    process-wide)."""
    env = dict(os.environ, GSKY_CPU_DEVICES="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    port = str(_free_port())
    with time_limit(60):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MULTI, port, str(world), str(r)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            outs = [p.communicate() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-800:]
        assert f"MULTIHOST-OK {r}" in out
