"""Port parity, mesh serving: `gsky_tpu_torch.mesh` (the partition
rules, the mesh wave dispatch, per-member page pools) against the JAX
package's `gsky_tpu.mesh`, the counterpart of `tests/test_mesh.py`.

The JAX side runs on the conftest's 8 virtual CPU devices with Pallas
in interpret mode; the port's on 8 CPU members (``GSKY_CPU_DEVICES=8``,
the kernels' plain versions).  Inputs are made from a seed with numpy.
Bounds: the rules, `describe` and `RuleError` alike case for case; the
``granule`` and ``time`` layouts equal the port's single-device wave
exactly, and the JAX mesh wave as the wave tests hold the single-device
waves (nearest identical, 0.1% of bytes / 2 ulp otherwise, drills rtol
1e-5 with counts equal); the ``x`` layout equal to the port's
single-device bytes exactly and within 0.1% of the JAX ``x`` layout's.
Every wait has a timeout, and a fixture resets both packages' mesh,
pools and schedulers."""

import types

import numpy as np
import pytest
import torch

from gsky_tpu.device_guard import journal as jjournal
from gsky_tpu.mesh import dispatch as JMD
from gsky_tpu.mesh import pools as JMP
from gsky_tpu.mesh import rules as JMR
from gsky_tpu.ops import expr as jexpr
from gsky_tpu.parallel import mesh as jmesh
from gsky_tpu.pipeline import autoplan as japlan
from gsky_tpu.pipeline import waves as jwaves

from gsky_tpu_torch.device_guard import journal as tjournal
from gsky_tpu_torch.mesh import dispatch as TMD
from gsky_tpu_torch.mesh import pools as TMP
from gsky_tpu_torch.mesh import rules as TMR
from gsky_tpu_torch.ops import cuda_lib
from gsky_tpu_torch.ops import expr as texpr
from gsky_tpu_torch.ops import paged as tpaged
from gsky_tpu_torch.ops import warp_render as trender
from gsky_tpu_torch.parallel import mesh as tmesh
from gsky_tpu_torch.pipeline import autoplan as tplan
from gsky_tpu_torch.pipeline import waves as twaves

import test_torch_kernels as tk
import test_torch_waves as tw

MEMBERS = 8
MESH_VARS = ("GSKY_MESH", "GSKY_MESH_RULES", "GSKY_MESH_PLACE", "GSKY_SPMD",
             "GSKY_MESH_DEVICES", "GSKY_WAVES", "GSKY_WAVE_PIPELINE",
             "GSKY_WAVE_MAX", "GSKY_PLAN", "GSKY_WAVE_TICK_MS")


def _reset():
    jwaves.reset_waves()
    twaves.reset_waves()
    JMD.reset_mesh()
    TMD.reset_mesh()
    JMP.reset_mesh_pools()
    TMP.reset_mesh_pools()
    japlan.reset_plan_state()
    tplan.reset_plan_state()


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """Pallas interpret, hermetic ledger and journal, 8 CPU members,
    every mesh knob scrubbed; both packages' schedulers, dispatchers
    and pools fresh before and after."""
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "pool.jsonl"))
    monkeypatch.setenv("GSKY_RENDER_BATCH", "0")
    monkeypatch.setenv("GSKY_CPU_DEVICES", str(MEMBERS))
    monkeypatch.setenv("GSKY_PAGE_POOL_MB", "4")
    for var in MESH_VARS:
        monkeypatch.delenv(var, raising=False)
    _reset()
    yield
    _reset()


# ---------------------------------------------------------------------------
# the partition rules
# ---------------------------------------------------------------------------

DRILL_DESC = "kind=drill bands=5 pixels=4096 pixel_count=0 wave=8"
BYTE_DESC = "kind=byte method=near n_ns=1 h=256 w=256 step=16 wave=12"
WCS_DESC = "kind=byte method=near n_ns=1 h=256 w=4096 step=16 wave=2"
DESCS = [DRILL_DESC, BYTE_DESC, WCS_DESC,
         "kind=scored method=near n_ns=2 h=96 w=96 step=16 wave=3",
         BYTE_DESC.replace("w=256", "w=3999"),
         BYTE_DESC.replace("w=256", "w=4000"),
         BYTE_DESC.replace("w=256", "w=12000"),
         "kind=expr method=cubic n_ns=4 h=256 w=256 step=16 fp=ab12 wave=4",
         "kind=mystery wave=1", ""]
ENVS = ["", r"kind=drill=>replicated",
        r"kind=byte\b.*\bw=256\b=>x; kind=scored=>time",
        r" kind=drill=>time ; ; wave=1\b=>replicated;"]


@pytest.mark.parametrize("env", range(len(ENVS)))
@pytest.mark.parametrize("desc", range(len(DESCS)))
def test_rules_route_as_the_reference(monkeypatch, desc, env):
    monkeypatch.setenv("GSKY_MESH_RULES", ENVS[env])
    assert TMR.match_rules(DESCS[desc]) == JMR.match_rules(DESCS[desc])
    assert [(r.source, r.layout) for r in TMR.active_rules()] == \
        [(r.source, r.layout) for r in JMR.active_rules()]


def test_builtin_layouts():
    assert TMR.match_rules(DRILL_DESC) == "time"
    assert TMR.match_rules(WCS_DESC) == "x"
    assert TMR.match_rules(BYTE_DESC) == "granule"
    assert TMR.match_rules("kind=mystery wave=1") == "replicated"


def test_first_match_wins():
    rules = (TMR.Rule(r"kind=byte", "time"), TMR.Rule(r"kind=byte", "x"))
    assert TMR.match_rules(BYTE_DESC, rules) == "time"


BAD = [("rule", r"kind=(byte", "granule"), ("rule", r"kind=byte", "diagonal"),
       ("parse", "kind=byte granule", None), ("parse", "kind=(=>granule", None),
       ("parse", "kind=byte=>nowhere", None)]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_rule_errors_as_the_reference(case):
    how, a, b = BAD[case]
    msgs = []
    for mod in (JMR, TMR):
        with pytest.raises(mod.RuleError) as ei:
            if how == "rule":
                mod.Rule(a, b)
            else:
                mod.parse_rules(a)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_invalid_env_rules_loud_at_construction(monkeypatch):
    monkeypatch.setenv("GSKY_MESH_RULES", "kind=(=>granule")
    monkeypatch.setenv("GSKY_MESH", "1")
    with pytest.raises(TMR.RuleError):
        TMD.MeshDispatcher(device="cpu")


KEYS = [("byte", (("near", 2, (64, 64), 16, True, 0), 123), 3),
        ("scored", (("cubic", 1, (96, 4096), 16), 7), 1),
        ("drill", ((4, 96), -3e38, 3e38, False), 2),
        ("drill", ((1, 262144), 0.0, 10.0, True), 64)]


@pytest.mark.parametrize("case", range(len(KEYS)))
def test_describe_as_the_reference(case):
    kind, key, wave = KEYS[case]
    assert TMR.describe(kind, key, wave) == JMR.describe(kind, key, wave)


def test_describe_expr_as_the_reference():
    key = texpr.fingerprint(texpr.compile_expr("(a - b) / (a + b)")).key
    assert key == jexpr.fingerprint(jexpr.compile_expr("(a - b) / (a + b)")).key
    statics = ("near", 2, (256, 256), 16, True, 0, key)
    assert texpr.fingerprint_hash(key) == jexpr.fingerprint_hash(key)
    assert TMR.describe("expr", (statics, 1), 4) == \
        JMR.describe("expr", (statics, 1), 4)


# ---------------------------------------------------------------------------
# mesh members
# ---------------------------------------------------------------------------

def test_mesh_devices_of_the_knobs(monkeypatch):
    assert tmesh.mesh_devices("cpu") == [torch.device("cpu")] * MEMBERS
    monkeypatch.setenv("GSKY_MESH_DEVICES", "cpu,cpu,cpu")
    assert len(tmesh.mesh_devices("cpu")) == 3
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"granule": 1, "x": 3} and m.virtual
    monkeypatch.delenv("GSKY_MESH_DEVICES")
    monkeypatch.delenv("GSKY_CPU_DEVICES")
    assert tmesh.mesh_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        # CUDA members without CUDA: the mesh raises, it never falls
        # back to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.mesh_devices("cuda")
        monkeypatch.setenv("GSKY_MESH_DEVICES", "cuda:0,cuda:0")
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.mesh_devices("cpu")


@pytest.mark.parametrize("n", range(1, 13))
def test_mesh_factorisation_as_the_reference(n):
    assert tmesh._factor2(n) == jmesh._factor2(n)
    m = tmesh.make_mesh(n, devices=["cpu"] * n)
    assert tuple(m.shape.values()) == jmesh._factor2(n)
    assert m.devices.shape == jmesh._factor2(n) and m.size == n


def test_mesh_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tmesh.make_mesh(8, shape=(3, 2), device="cpu")
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(9, device="cpu")


def test_wrappers_refuse_operands_on_another_device():
    """The kernels' operand check: a pointer from another device would
    be an illegal address on the card, so the wrappers raise first."""
    a = torch.zeros(4)
    b = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="expected"):
        cuda_lib.check_cuda(a, b, dtypes=[torch.float32] * 2)


# ---------------------------------------------------------------------------
# wave parity: mesh against single device and against the reference
# ---------------------------------------------------------------------------

def _port_mesh_wave(tpool, tiles, kind, statics):
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)
    try:
        got = tw._port_wave(tpool, tiles, kind, statics, sched)
        return got, sched.stats()
    finally:
        sched.shutdown()


def _statics(kind, method, hw, step, n_ns):
    return (method, n_ns, hw, step) + ((True, 0) if kind == "byte" else ())


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("kind,method,superblock", [
    ("byte", "near", False), ("byte", "bilinear", True),
    ("scored", "cubic", False), ("scored", "near", True)])
def test_granule_wave_matches_single_device_and_reference(
        monkeypatch, pipeline, kind, method, superblock):
    monkeypatch.setenv("GSKY_WAVE_PIPELINE", pipeline)
    jpool, tiles, hw, step, n_ns = tw._wave_inputs(4, superblock)
    statics = _statics(kind, method, hw, step, n_ns)
    tpool = tw._port_pool(jpool)
    monkeypatch.setenv("GSKY_WAVES", "1")
    single, _ = _port_mesh_wave(tpool, tiles, kind, statics)
    monkeypatch.setenv("GSKY_MESH", "1")
    ref, _ = tw._jax_wave(jpool, tiles, kind, statics)
    assert JMD.mesh_stats()["waves_by_layout"].get("granule", 0) >= 1
    got, st = _port_mesh_wave(tpool, tiles, kind, statics)
    ms = TMD.mesh_stats()
    assert ms["chips"] == MEMBERS and ms["virtual"] is True
    assert ms["waves_by_layout"] == {"granule": 1}, ms
    assert ms["entries_by_layout"] == {"granule": 4}
    assert ms["launches_by_layout"] == {"granule": [1] * MEMBERS}
    assert st["failed"] == 0 and st["fallbacks"] == 0
    assert tpool.stats()["pinned"] == 0
    for r, g, one in zip(ref, got, single):
        if kind == "byte":
            np.testing.assert_array_equal(g, one)
            tw._same_bytes(method, r, g)
        else:
            np.testing.assert_array_equal(g[0], one[0])
            np.testing.assert_array_equal(g[1], one[1])
            tw._same_scored(method, r, g)


def test_granule_wave_launches_b1_once_per_member(monkeypatch):
    """B1's wrapper runs once on every member, on the member's rows,
    every operand on the member's device."""
    jpool, tiles, hw, step, n_ns = tw._wave_inputs(3)
    tpool = tw._port_pool(jpool)
    seen = []
    real = tpaged.paged_render_scored

    def spy(pool, tables, params, sx, sy, *a, **k):
        seen.append((tables.shape[0], {t.device for t in
                                       (pool, tables, params, sx, sy)}))
        return real(pool, tables, params, sx, sy, *a, **k)

    monkeypatch.setattr(tpaged, "paged_render_scored", spy)
    monkeypatch.setenv("GSKY_MESH", "1")
    _port_mesh_wave(tpool, tiles, "byte",
                    _statics("byte", "near", hw, step, n_ns))
    md = TMD.active_mesh()
    # 3 lanes pad to 4 then to 8 rows: one row a member
    assert [n for n, _ in seen] == [1] * MEMBERS
    assert all(devs == {md.mesh.members[i]}
               for i, (_, devs) in enumerate(seen))
    assert md.mesh.member_stats() == [1] * MEMBERS


def test_expr_wave_granule_matches_single_device(monkeypatch):
    """A fused expression wave over the granule layout: each member's
    B1 plus the expression epilogue, bytes equal to the single-device
    wave's."""
    jpool, tiles, hw, step, _ = tw._wave_inputs(4)
    tpool = tw._port_pool(jpool)
    fp = texpr.fingerprint(texpr.compile_expr("b4 - 25.0"))
    statics = ("near", 2, hw, step, True, 0, fp.key)

    def run():
        sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)

        def one(t):
            lane = twaves.BucketedLane(
                [torch.from_numpy(s) for s in t["stack"]], t["params"],
                torch.from_numpy(t["ctrl"]), tuple(t["stack"].shape))
            with tpool.lock:
                for s in t["tables"].reshape(-1).tolist():
                    tpool._pins[s] = tpool._pins.get(s, 0) + 1
            return sched.render_expr(tpool, t["tables"], t["p16"],
                                     t["ctrl"], tw.SP, fp.const_array(),
                                     statics,
                                     lane, serials=t["serials"])
        try:
            return tw._ok(*tw._run_threads([lambda t=t: one(t)
                                            for t in tiles]))
        finally:
            sched.shutdown()

    single = run()
    monkeypatch.setenv("GSKY_MESH", "1")
    got = run()
    assert TMD.mesh_stats()["entries_by_layout"] == {"granule": 4}
    assert tpaged.expr_fused_stats()["paths"].get("mesh") == 1
    for g, one in zip(got, single):
        np.testing.assert_array_equal(g, one)


def _drill_blocks(K=4):
    return [tk._b3_inputs(50 + k, 6, 3000, edge=True) for k in range(K)]


def _jax_drills(blocks, pix):
    sched = jwaves.default_waves()
    return tw._ok(*tw._run_threads([
        lambda d=d, v=v: sched.drill_stats(d, v, -80.0, 120.0, pix, None)
        for d, v in blocks]))


def _port_drills(blocks, pix):
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)
    try:
        return tw._ok(*tw._run_threads([
            lambda d=d, v=v: sched.drill_stats(
                torch.from_numpy(d), torch.from_numpy(v), -80.0, 120.0, pix)
            for d, v in blocks]))
    finally:
        sched.shutdown()


@pytest.mark.parametrize("pixel_count", [False, True])
def test_time_layout_drills_match(monkeypatch, pixel_count):
    blocks = _drill_blocks()
    single = _port_drills(blocks, pixel_count)
    monkeypatch.setenv("GSKY_MESH", "1")
    ref = _jax_drills(blocks, pixel_count)
    assert JMD.mesh_stats()["waves_by_layout"].get("time", 0) >= 1
    got = _port_drills(blocks, pixel_count)
    ms = TMD.mesh_stats()
    assert ms["waves_by_layout"] == {"time": 1}
    assert ms["launches_by_layout"] == {"time": [1] * MEMBERS}
    for (vj, cj), (vt, ct), (v1, c1) in zip(ref, got, single):
        np.testing.assert_array_equal(vt, v1)
        np.testing.assert_array_equal(ct, c1)
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_allclose(vt, np.asarray(vj), rtol=1e-5, atol=1e-6)


def test_replicated_rule_keeps_the_single_device_path(monkeypatch):
    jpool, tiles, hw, step, n_ns = tw._wave_inputs(2)
    tpool = tw._port_pool(jpool)
    statics = _statics("byte", "near", hw, step, n_ns)
    single, _ = _port_mesh_wave(tpool, tiles, "byte", statics)
    monkeypatch.setenv("GSKY_MESH", "1")
    monkeypatch.setenv("GSKY_MESH_RULES", "kind=byte=>replicated")
    got, _ = _port_mesh_wave(tpool, tiles, "byte", statics)
    ms = TMD.mesh_stats()
    assert ms["waves_by_layout"] == {"replicated": 1}
    assert ms["member_dispatches"] == [0] * MEMBERS
    for g, one in zip(got, single):
        np.testing.assert_array_equal(g, one)


@pytest.mark.parametrize("kind,method", [("byte", "near"),
                                         ("scored", "bilinear")])
def test_x_layout_matches_single_device_and_reference(monkeypatch, kind,
                                                      method):
    """GSKY_MESH_RULES sends the group to ``x``: B2 on every member over
    its granule shard and width strip, per entry."""
    jpool, tiles, hw, step, n_ns = tw._wave_inputs(2)
    tpool = tw._port_pool(jpool)
    statics = _statics(kind, method, hw, step, n_ns)
    single, _ = _port_mesh_wave(tpool, tiles, kind, statics)
    monkeypatch.setenv("GSKY_MESH", "1")
    monkeypatch.setenv("GSKY_MESH_RULES", f"kind={kind}=>x")
    ref, _ = tw._jax_wave(jpool, tiles, kind, statics)
    assert JMD.mesh_stats()["waves_by_layout"].get("x", 0) >= 1
    b1, b2 = [], []
    r1, r2 = tpaged.paged_render_scored, trender.warp_render_scored
    monkeypatch.setattr(tpaged, "paged_render_scored",
                        lambda *a, **k: b1.append(1) or r1(*a, **k))
    monkeypatch.setattr(trender, "warp_render_scored",
                        lambda *a, **k: b2.append(1) or r2(*a, **k))
    from gsky_tpu_torch.parallel import spmd as tspmd
    monkeypatch.setattr(tspmd, "warp_render_scored", trender.warp_render_scored)
    got, _ = _port_mesh_wave(tpool, tiles, kind, statics)
    ms = TMD.mesh_stats()
    assert ms["waves_by_layout"] == {"x": 1}
    assert (len(b1), len(b2)) == (0, 2 * MEMBERS)
    for r, g, one in zip(ref, got, single):
        if kind == "byte":
            np.testing.assert_array_equal(g, one)
            assert np.count_nonzero(g != r) <= g.size // 1000
        else:
            np.testing.assert_array_equal(g[0], one[0])
            np.testing.assert_array_equal(g[1], one[1])
            assert np.mean(g[1] != r[1]) <= 1e-3


def test_failed_mesh_wave_fails_entries_over_one_by_one(monkeypatch):
    """A member's launch that fails fails the mesh wave over entry by
    entry to their per-call legs (B2 over the lane's scenes), counted as
    fallbacks, as the single-device wave does."""
    jpool, tiles, hw, step, n_ns = tw._wave_inputs(3)
    tpool = tw._port_pool(jpool)
    statics = _statics("byte", "near", hw, step, n_ns)
    single, _ = _port_mesh_wave(tpool, tiles, "byte", statics)

    def boom(*a, **k):
        raise RuntimeError("member launch failed")

    monkeypatch.setattr(tpaged, "render_byte_paged", boom)
    monkeypatch.setenv("GSKY_MESH", "1")
    got, st = _port_mesh_wave(tpool, tiles, "byte", statics)
    assert st["fallbacks"] == 3 and st["failed"] == 0
    assert tpool.stats()["pinned"] == 0
    for g, one in zip(got, single):
        np.testing.assert_array_equal(g, one)


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_mesh_boot_failure_reaches_the_request(monkeypatch, pipeline):
    """A mesh that cannot be built raises to the request: no per-call
    leg serves it single-device behind the operator's back."""
    monkeypatch.setenv("GSKY_WAVE_PIPELINE", pipeline)
    jpool, tiles, hw, step, n_ns = tw._wave_inputs(2)
    tpool = tw._port_pool(jpool)
    monkeypatch.setenv("GSKY_MESH", "1")
    monkeypatch.setenv("GSKY_MESH_RULES", "kind=(=>granule")
    sched = twaves.WaveScheduler("cpu", tick_ms=200.0)
    try:
        out, errs = tw._run_threads([
            lambda t=t: tw._port_wave(tpool, [t], "byte",
                                      _statics("byte", "near", hw, step,
                                               n_ns), sched)
            for t in tiles])
        st = sched.stats()
    finally:
        sched.shutdown()
    assert all(isinstance(e, TMR.RuleError) for e in errs), errs
    assert st["fallbacks"] == 0 and st["failed"] == 2
    assert tpool.stats()["pinned"] == 0


# ---------------------------------------------------------------------------
# the sharded planner
# ---------------------------------------------------------------------------

def _entries(tiles, kind, statics, pool):
    return [types.SimpleNamespace(
        key=(statics, id(pool)),
        payload={"pool": pool, "tables": t["tables"], "params16": t["p16"],
                 "serials": t["serials"], "ctrl": t["ctrl"]})
        for t in tiles]


@pytest.mark.parametrize("n_chips", [2, 4, 8])
def test_plan_sharded_as_the_reference(n_chips):
    jpool, tiles, hw, step, n_ns = tw._wave_inputs(8, superblock=True)
    statics = _statics("byte", "near", hw, step, n_ns)
    tpool = tw._port_pool(jpool)
    Np = 8
    jp = japlan.plan_sharded("byte", _entries(tiles, "byte", statics, jpool),
                             n_chips, Np)
    tp = tplan.plan_sharded("byte", _entries(tiles, "byte", statics, tpool),
                            n_chips, Np)
    if n_chips == Np:
        # one lane a member: nothing merges, the unplanned split runs
        assert jp is None and tp is None
        return
    assert jp is not None and tp is not None
    np.testing.assert_array_equal(tp.tables, np.asarray(jp.tables))
    np.testing.assert_array_equal(tp.params, np.asarray(jp.params))
    np.testing.assert_array_equal(tp.sb_of, np.asarray(jp.sb_of))
    assert (tp.superblocks, tp.merged_lanes) == \
        (jp.superblocks, jp.merged_lanes)
    # no superblock crosses a member: sb_of stays member-local
    assert int(tp.sb_of.max()) < tp.tables.shape[0] // n_chips


# ---------------------------------------------------------------------------
# per-member pools and the journal's member tags
# ---------------------------------------------------------------------------

def test_chip_pool_lives_on_its_member(monkeypatch):
    monkeypatch.setenv("GSKY_MESH", "1")
    monkeypatch.setenv("GSKY_MESH_PLACE", "1")
    pools = TMP.default_mesh_pools("cpu")
    assert pools.n_chips == MEMBERS
    serial = 5
    chip = pools.chip_for(serial)
    assert chip == serial % MEMBERS == JMP.MeshPools.chip_for(
        types.SimpleNamespace(pools=[None] * MEMBERS), serial)
    cp = pools.pool_for(serial)
    assert cp.chip == chip
    stack = torch.from_numpy(tk._inputs(0, B=1)[0][0])
    slots = cp.table_for(stack, serial, 0, 0, 0, 0)
    with cp.locked_pool() as parr:
        assert parr.device == pools.device_for(serial)
    cp.unpin(slots)
    assert cp.stats()["chip"] == chip
    assert TMP.staging_pool(serial, "cpu") is cp
    assert TMP.staging_device(serial, "cpu") == pools.device_for(serial)
    assert pools.pinned_total() == 0
    _, chips = tjournal.replay_chips()
    assert chips == {(serial, 0, 0): chip}


def test_placement_gated_off_by_default(monkeypatch):
    monkeypatch.setenv("GSKY_MESH", "1")
    assert TMP.staging_pool(3, "cpu") is None
    assert TMP.staging_device(3, "cpu") is None


def test_journal_chip_tags_as_the_reference(tmp_path, monkeypatch):
    out = []
    for name, jn in (("ref", jjournal), ("port", tjournal)):
        monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / name))
        jn.record_stage(41, 0, 0, chip=2)
        jn.record_stage(41, 0, 1, chip=2)
        jn.record_stage(77, 1, 0)
        jn.record_heat(41, 0, 0, hits=3, chip=2)
        out.append((sorted(jn.replay()), jn.replay_chips()[1]))
    assert out[0] == out[1]
    assert out[1][1] == {(41, 0, 0): 2, (41, 0, 1): 2}


def test_rehydrate_all_restages_per_member(monkeypatch):
    """Warm recovery puts every journaled page back in its member's
    pool (the hash owner for untagged lines); a teardown of one member
    leaves the others' pages in place."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.pipeline.scene_cache import DeviceScene, SceneCache
    monkeypatch.setenv("GSKY_MESH", "1")
    monkeypatch.setenv("GSKY_MESH_PLACE", "1")
    pools = TMP.default_mesh_pools("cpu")

    def mk(s):
        return DeviceScene(dev=torch.zeros((8, 8)), height=8, width=8,
                           nodata=0.0,
                           gt=GeoTransform.from_gdal((0, 1, 0, 0, 0, -1)),
                           crs=parse_crs("EPSG:4326"), serial=s)

    cache = SceneCache(device="cpu")
    monkeypatch.setattr(cache, "_scenes", {("a",): mk(10), ("b",): mk(11)})
    tjournal.record_stage(10, 0, 0, chip=10 % MEMBERS)
    tjournal.record_stage(11, 0, 0)          # untagged: the hash owner
    counts = pools.rehydrate_all()
    assert counts == {10 % MEMBERS: 1, 11 % MEMBERS: 1}
    pools.teardown_chip(10 % MEMBERS)
    assert not pools.pools[10 % MEMBERS].has_page(10, 0, 0)
    assert pools.pools[11 % MEMBERS].has_page(11, 0, 0)
    again = pools.rehydrate_all()
    assert again == {10 % MEMBERS: 1}
    del cache


# ---------------------------------------------------------------------------
# prewarm and the compat routes
# ---------------------------------------------------------------------------

def test_prewarm_runs_the_mesh_lattice_on_every_member(monkeypatch):
    from gsky_tpu_torch.pipeline.pages import PagePool
    monkeypatch.setenv("GSKY_MESH", "1")
    md = TMD.default_mesh("cpu")
    assert md is not None and md.n_chips == MEMBERS
    pool = PagePool(capacity=8, page_rows=tw.PR, page_cols=tw.PC,
                    device="cpu")
    n = md.prewarm_programs(pool, {("near", 1, True, 0)}, sizes=[32],
                            wave_sizes=[MEMBERS], step=16, bucket=64)
    # 2 granule programs per lattice point + the drill's 2 variants
    assert n == 4 and md.stats()["programs"] == 4
    assert md.mesh.member_stats() == [4] * MEMBERS


def test_compat_spmd(monkeypatch):
    from gsky_tpu_torch.parallel import spmd as tspmd
    assert TMD.compat_spmd("cpu") is None
    monkeypatch.setenv("GSKY_SPMD", "1")
    a, b = tspmd.default_spmd("cpu"), TMD.compat_spmd("cpu")
    assert a is not None and a is b and a.mesh.size == MEMBERS
    assert tspmd.spmd_enabled("cpu")
    # one member: the single-device path serves (None), as the
    # reference's compat_spmd answers on a one-device host
    monkeypatch.setenv("GSKY_CPU_DEVICES", "1")
    assert TMD.compat_spmd("cpu") is None
    assert not tspmd.spmd_enabled("cpu")


def test_mesh_off_builds_no_dispatcher():
    assert TMD.default_mesh("cpu") is None
    assert TMD.active_mesh() is None and TMD.mesh_stats() == {}
    assert JMD.default_mesh() is None
