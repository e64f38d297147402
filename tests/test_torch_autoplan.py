"""Port parity, the wave planner: `gsky_tpu_torch.pipeline.autoplan`
against `gsky_tpu.pipeline.autoplan` on identical wave entries, and the
port's output-tile model.

Each case builds one group of lanes as numpy (page tables whose slots
are keyed by (granule, page row, page col), as a content-keyed pool
gives them; params rows with their page windows in slots 11-15; scene
serials; the shape of each lane's bucketed stack) and hands the same
values to both packages' `plan_wave_group`.  The plans must agree: the
same route, and equal ``tables``, ``params`` and ``sb_of`` arrays for a
superblock plan; the merge gate is held at the Pallas block the
reference plans for the group.  The block each carries is its own: a
Pallas block in the reference, a CUDA tile of kernel B1 in the port
(`plan_block`, the card's model).  Each case runs over the default
ladder, where the port's model keeps the default 8 x 32 (so where the
reference plans a Pallas block alone, a ``"ragged"`` plan, the port
returns None), and over a ladder without the default tile, where every
group plans a tile and the routes are the same in every case.

The tile model: the ladder's parse, None when the default wins or the
planner is off, the memo and its reset, the decisions counted in
``gsky_plan_block_shape``, and ROADMAP C.20: the reference replays a
costed shape from its kernel ledger into a later planner whose ladder
does not list it; the port keeps no ledger and does not.  The plain
versions of B1 and B2 take every tile and compute the same values."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gsky_tpu.pipeline import autoplan as japlan
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import waves as jwaves

from gsky_tpu_torch.obs.metrics import PLAN_BLOCK_SHAPE
from gsky_tpu_torch.ops import paged as tpaged
from gsky_tpu_torch.ops import warp_render as trender
from gsky_tpu_torch.pipeline import autoplan as tplan
from gsky_tpu_torch.pipeline import pages as tpages
from gsky_tpu_torch.pipeline import waves as twaves

PR, PC = 128, 512
STATICS = ("bilinear", 1, (256, 256), 16, True, 0)
# a ladder without the default tile: the port plans a tile for every group
NO_DEFAULT = "4x32,2x64"


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    for k in ("GSKY_PLAN", "GSKY_PLAN_HALO_MAX", "GSKY_PAGE_SLOTS",
              "GSKY_PLAN_BLOCKS"):
        monkeypatch.delenv(k, raising=False)
    japlan.reset_plan_state()
    tplan.reset_plan_state()
    yield
    japlan.reset_plan_state()
    tplan.reset_plan_state()


def _lane(windows, serials=(1, 2), stack=(2, 7936, 7936), affine=0.0,
          pr=PR, pc=PC):
    """One lane: per granule a page window (i0, i1, j0, j1) or None (a
    padding row) of (pr, pc) pages.  Slots are 1 + 1000 t + 50 pi + pj."""
    T = len(windows)
    npg = [1 if w is None else (w[1] - w[0] + 1) * (w[3] - w[2] + 1)
           for w in windows]
    S = 1
    while S < max(npg):
        S *= 2
    tables = np.zeros((T, S), np.int32)
    p16 = np.zeros((T, 16), np.float32)
    for t, w in enumerate(windows):
        if w is None:
            p16[t, 10] = -1.0
            continue
        i0, i1, j0, j1 = w
        tables[t, :npg[t]] = [1 + 1000 * t + 50 * pi + pj
                              for pi in range(i0, i1 + 1)
                              for pj in range(j0, j1 + 1)]
        p16[t, :11] = [0.5 + affine, 1.0, 0.0, 2.0 - affine, 0.0, 1.0,
                       7681.0, 7821.0, -999.0, 10.0 - t, t % 2]
        p16[t, 11:16] = [i0 * pr, j0 * pc, (i1 - i0 + 1) * pr,
                         (j1 - j0 + 1) * pc, j1 - j0 + 1]
    return {"tables": tables, "params16": p16, "serials": serials,
            "stack": stack}


def _entries(lanes, kind="byte", statics=STATICS, pr=PR, pc=PC):
    """The same lanes as JAX and as port wave entries."""
    pool = SimpleNamespace(page_rows=pr, page_cols=pc)
    key = (statics, id(pool))
    je, te = [], []
    for ln in lanes:
        stack = SimpleNamespace(shape=ln["stack"],
                                dtype=np.dtype(np.float32))
        common = {"pool": pool, "tables": ln["tables"],
                  "params16": ln["params16"], "serials": ln["serials"]}
        je.append(jwaves._Entry(kind, key, dict(
            common, xla=(stack, None, None, None)), None, None, None))
        te.append(twaves._Entry(kind, key, dict(
            common, xla=twaves.BucketedLane([], None, None, ln["stack"]))))
    return je, te


def _plans(lanes, kind="byte"):
    je, te = _entries(lanes, kind)
    return japlan.plan_wave_group(kind, je), tplan.plan_wave_group(kind, te)


def _same(jp, tp):
    """The plans agree (the route; for a superblock the arrays); the
    route, None for no plan."""
    if jp is None:
        assert tp is None, tp.route
        return None
    if tp is None:
        # the port's tile is the default where the reference planned a
        # Pallas block alone
        assert jp.route == "ragged" and \
            tplan.DEFAULT_TILE in tplan.plan_blocks()
        return None
    assert tp.route == jp.route
    assert tp.blk is None or tp.blk in tplan.plan_blocks()
    assert (tp.naive_bytes, tp.planned_bytes) == \
        (jp.naive_bytes, jp.planned_bytes)
    assert tp.bucketed_bytes == jp.bucketed_bytes
    if jp.route == "superblock":
        np.testing.assert_array_equal(tp.tables, np.asarray(jp.tables))
        np.testing.assert_array_equal(tp.params, np.asarray(jp.params))
        np.testing.assert_array_equal(tp.sb_of, np.asarray(jp.sb_of))
        assert tp.tables.dtype == np.int32 and tp.sb_of.dtype == np.int32
        assert tp.params.dtype == np.float32
        assert (tp.superblocks, tp.merged_lanes) == \
            (jp.superblocks, jp.merged_lanes)
    return tp.route


def _pan(n, di=0, dj=1, T=2, gap=0, **kw):
    """n lanes over the same granules, each window shifted (di, dj + gap)
    pages from the last: a pan walk."""
    return [_lane([(2 + di * k, 3 + di * k, 1 + (dj + gap) * k,
                    2 + (dj + gap) * k)] * T, **kw) for k in range(n)]


CASES = {
    "pan walk": lambda: _pan(4),
    "pan walk, 3 lanes": lambda: _pan(3),
    "pan walk, 5 lanes, rows": lambda: _pan(5, di=1, dj=0),
    "one tile many times": lambda: [_lane([(0, 1, 0, 1)] * 3)
                                    for _ in range(6)],
    "halo gap of 2": lambda: _pan(3, gap=2),
    "gap past the halo": lambda: _pan(3, gap=4),
    "other serials": lambda: [_lane([(0, 1, 0, 1)] * 2, serials=(k,))
                              for k in range(4)],
    "two scene sets": lambda: (_pan(3, serials=(7,)) +
                               _pan(2, serials=(8,))),
    "other affine": lambda: [_lane([(0, 1, 0, 1)] * 2, affine=0.25 * k)
                             for k in range(3)],
    "padding rows": lambda: [_lane([(1, 2, 0, 1), None, (1, 2, 1, 2)]),
                             _lane([(1, 2, 1, 2), None, (1, 2, 1, 2)])],
    "ragged granule counts": lambda: [_lane([(0, 1, 0, 0)]),
                                      _lane([(0, 1, 0, 1)] * 3),
                                      _lane([(0, 1, 0, 0)])],
    "over the slot cap": lambda: [_lane([(0, 1, 0, 1)]),
                                  _lane([(0, 1, 2, 3)]),
                                  _lane([(2, 3, 0, 3)])],
    "small stacks: bucketed": lambda: _pan(4, stack=(2, 256, 256)),
    "one lane": lambda: [_lane([(0, 2, 0, 2)] * 2)],
}


@pytest.mark.parametrize("ladder", [None, NO_DEFAULT])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_reference(case, ladder, monkeypatch):
    if ladder:
        monkeypatch.setenv("GSKY_PLAN_BLOCKS", ladder)
    jp, tp = _plans(CASES[case]())
    _same(jp, tp)
    if ladder and jp is not None:
        assert tp.route == jp.route and tp.blk in ((4, 32), (2, 64))


@pytest.mark.parametrize("ladder,want", [
    (None, {None, "superblock", "bucketed"}),
    (NO_DEFAULT, {"ragged", "superblock", "bucketed"})])
def test_cases_cover_every_route(ladder, want, monkeypatch):
    if ladder:
        monkeypatch.setenv("GSKY_PLAN_BLOCKS", ladder)
    routes = set()
    for c in CASES:
        _, tp = _plans(CASES[c]())
        routes.add(None if tp is None else tp.route)
    assert routes == want


@pytest.mark.parametrize("halo", ["0", "1", "4"])
def test_halo_knob(monkeypatch, halo):
    monkeypatch.setenv("GSKY_PLAN_HALO_MAX", halo)
    assert tplan.plan_halo_max() == japlan.plan_halo_max()
    lanes = [_lane([(0, 1, 0, 1)] * 2) for _ in range(3)] \
        + [_lane([(0, 1, 3, 3)] * 2)]
    jp, tp = _plans(lanes)
    assert _same(jp, tp) == "superblock"
    assert tp.superblocks == (2 if halo == "0" else 1)


@pytest.mark.parametrize("slots", ["2", "4", "16"])
def test_slot_knob(monkeypatch, slots):
    monkeypatch.setenv("GSKY_PAGE_SLOTS", slots)
    _same(*_plans(_pan(6)))


def test_plan_off_and_other_kinds(monkeypatch):
    jp, tp = _plans(_pan(4), kind="drill")
    assert jp is None and tp is None
    monkeypatch.setenv("GSKY_PLAN", "0")
    jp, tp = _plans(_pan(4))
    assert jp is None and tp is None
    assert tplan.plan_stats()["enabled"] is False


def test_scored_lanes_plan_alike():
    lanes = _pan(4)
    je, te = _entries(lanes, "scored", STATICS[:4])
    _same(japlan.plan_wave_group("scored", je),
          tplan.plan_wave_group("scored", te))


def test_stats_count_as_the_reference():
    for c in ("one tile many times", "other serials",
              "small stacks: bucketed"):
        je, te = _entries(CASES[c]())
        japlan.plan_wave_group("byte", je, stage="assembly")
        tplan.plan_wave_group("byte", te, stage="assembly")
    js, ts = japlan.plan_stats(), tplan.plan_stats()
    for k in ("superblocks", "merged_lanes", "gather_bytes_saved",
              "groups_planned", "assembly_planned", "routes", "halo_max"):
        assert ts[k] == js[k], k
    assert ts["superblocks"] > 0 and ts["routes"]["bucketed"] == 1


@pytest.mark.parametrize("u,r,halo", [
    ((0, 1, 0, 1), (1, 2, 1, 2), 0), ((0, 1, 0, 1), (3, 4, 0, 1), 1),
    ((0, 1, 0, 1), (3, 4, 0, 1), 0), ((2, 5, 2, 5), (0, 0, 9, 9), 3),
    ((0, 0, 0, 0), (0, 0, 3, 3), 2)])
def test_rect_union(u, r, halo):
    assert tplan._rect_union(u, r, halo) == japlan._rect_union(u, r, halo)


def test_union_table_equals_reference():
    rng = np.random.default_rng(5)
    members = []
    for i0, i1, j0, j1 in ((0, 1, 0, 2), (1, 3, 1, 2), (3, 3, 0, 0)):
        n = (i1 - i0 + 1) * (j1 - j0 + 1)
        members.append((rng.integers(1, 99, n).astype(np.int32),
                        i0, i1, j0, j1))
    np.testing.assert_array_equal(tpages.union_table(members, 0, 3, 0, 2),
                                  jpages.union_table(members, 0, 3, 0, 2))


def test_handoff_token():
    pool = tpages.PagePool(capacity=4, page_rows=8, page_cols=128,
                           device="cpu")
    gen = pool.handoff()
    assert pool.handoff_ok(gen) and not pool.handoff_ok(gen + 1)


def test_planner_error_raises():
    """A planner error is not an unplanned dispatch in the port."""
    je, te = _entries(_pan(3))
    te[1].payload["params16"] = te[1].payload["params16"][:, :11]
    with pytest.raises(IndexError):
        tplan.plan_wave_group("byte", te)


def test_planning_is_thread_safe():
    errs = []

    def go():
        try:
            for _ in range(5):
                _, te = _entries(_pan(4))
                tplan.plan_wave_group("byte", te)
        except Exception as e:   # noqa: BLE001 - asserted below
            errs.append(e)

    ts = [threading.Thread(target=go) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs and tplan.plan_stats()["groups_planned"] == 20


# ---------------------------------------------------------------------------
# the merge gate at the reference's block
# ---------------------------------------------------------------------------

# (n_ns, GSKY_PAGE_SLOTS, page rows, lane window columns - 1, the block
# the reference plans): an n_ns 8 expression group over 192 x 512 pages
# (a slot of the page list is 768 KB of the reference's double-buffered
# VMEM), whose block is 256 x 128; n_ns 4 over 128 x 512 pages with 16
# slots, whose block is 256 x 256
GATE_CASES = [(8, None, 192, 1, (256, 128)), (4, "16", PR, 3, (256, 256))]


@pytest.mark.parametrize("n_ns,slots,pr,wide,gate", GATE_CASES)
def test_gate_at_the_reference_block(n_ns, slots, pr, wide, gate,
                                     monkeypatch):
    """Two lanes one page column apart that would merge under the 128 x
    128 gate but not under the block the reference plans for the group:
    both packages keep them apart."""
    if slots:
        monkeypatch.setenv("GSKY_PAGE_SLOTS", slots)
    statics = ("bilinear", n_ns, (256, 256), 16, True, 0, ("const", 0))
    lanes = [_lane([(0, 1, k, k + wide)] * 2, pr=pr) for k in (0, 1)]
    je, te = _entries(lanes, "expr", statics, pr=pr)
    jp = japlan.plan_wave_group("expr", je)
    tp = tplan.plan_wave_group("expr", te)
    assert _same(jp, tp) is None and jp.route == "ragged"
    assert jp.blk == gate
    S = te[0].payload["tables"].shape[1]
    assert tplan._gate_block(256, 256, n_ns, "bilinear", 2, S, pr,
                             PC) == gate
    rows = [tplan._entry_rows(e, pr, PC) for e in te]
    # the 128 x 128 gate would have merged them
    assert len(tplan._cluster_and_merge(te, rows, n_ns, pr, PC,
                                        None)) == 1
    assert len(tplan._cluster_and_merge(te, rows, n_ns, pr, PC,
                                        gate)) == 2


def test_gate_block_equals_the_reference_choice():
    for n_ns in (1, 2, 4, 8):
        for S in (1, 2, 4, 8, 16):
            for method in ("near", "bilinear", "cubic"):
                for hw in ((256, 256), (1024, 1024), (100, 300)):
                    japlan.reset_plan_state()
                    want = japlan.plan_block(*hw, n_ns, method, T=3, S=S,
                                             pr=PR, pc=PC)
                    assert tplan._gate_block(*hw, n_ns, method, 3, S, PR,
                                             PC) == want


def test_sharded_plan_carries_the_member_tile(monkeypatch):
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", NO_DEFAULT)
    je, te = _entries([_lane([(0, 1, 0, 1)] * 2) for _ in range(8)])
    jp = japlan.plan_sharded("byte", je, 2, 8)
    tp = tplan.plan_sharded("byte", te, 2, 8)
    assert tp.route == jp.route == "superblock"
    np.testing.assert_array_equal(tp.tables, np.asarray(jp.tables))
    np.testing.assert_array_equal(tp.sb_of, np.asarray(jp.sb_of))
    assert tp.blk == tplan.plan_block(256, 256, 1, "bilinear", T=2,
                                      S=te[0].payload["tables"].shape[1],
                                      pr=PR, pc=PC, N=4)


# ---------------------------------------------------------------------------
# the tile model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,want", [
    ("", tplan._DEF_BLOCKS),
    ("8x32,4x64, 2X128,8x48,16x32,1x512,0x32,x,4x64,,3", (
        (8, 32), (4, 64), (2, 128))),
    ("8x48,foo", tplan._DEF_BLOCKS),
    ("1x256", ((1, 256),))])
def test_ladder_parse(env, want, monkeypatch):
    """CUDA tiles: the columns whole warps, at most 256 threads (the
    kernels' launch bound), duplicates once; nothing left is the
    default ladder, which lists 8 x 32 first."""
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", env)
    assert tplan.plan_blocks() == want
    assert tplan._DEF_BLOCKS[0] == trender.DEFAULT_TILE == (8, 32)
    assert all(trender.tile_ok(*t) for t in tplan._DEF_BLOCKS)


POINTS = [dict(h=256, w=256, n_ns=1, method=m, T=T, S=8, pr=PR, pc=PC,
               N=N) for m in ("near", "bilinear", "cubic")
          for T in (1, 4) for N in (1, 10)] + \
    [dict(h=1024, w=1024, n_ns=1, method=m, T=4, S=8, pr=PR, pc=PC)
     for m in ("bilinear", "cubic")] + \
    [dict(h=hw, w=hw, n_ns=1, method=m, T=4, S=0, win=(7936, 7936))
     for hw in (256, 1024) for m in ("near", "bilinear", "cubic")]


@pytest.mark.parametrize("point", POINTS)
def test_default_tile_wins_at_the_swept_points(point, monkeypatch):
    """The default ladder at phase 26a's points: the model keeps 8 x 32
    (None); with planning off it plans nothing whatever the ladder."""
    assert tplan.plan_block(**point) is None
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", NO_DEFAULT)
    assert tplan.plan_block(**point) in ((4, 32), (2, 64))
    monkeypatch.setenv("GSKY_PLAN", "0")
    assert tplan.plan_block(**point) is None


def test_model_ranks_thin_tiles_last():
    """What the sweep measured: a one-row tile and a two-row one of 32
    columns cost more than 8 x 32 for B1; so does a 1 x 256 tile over a
    wave."""
    cost = {t: tplan._block_cost("b1", 256, 256, 4, "bilinear", *t, N=10)
            for t in ((8, 32), (2, 32), (1, 32), (1, 256))}
    assert cost[(8, 32)] < cost[(2, 32)] < cost[(1, 32)]
    assert cost[(8, 32)] < cost[(1, 256)]


def _shape_count(shape):
    return sum(v for _, lab, v in PLAN_BLOCK_SHAPE.samples()
               if dict(lab)["shape"] == shape)


def test_memo_counts_and_reset(monkeypatch):
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", NO_DEFAULT)
    p = POINTS[0]
    n0 = _shape_count("4x32") + _shape_count("2x64")
    got = tplan.plan_block(**p)
    assert tplan.plan_block(**p) == got
    assert tplan.plan_stats()["costed_shapes"] == 1
    assert tplan.plan_stats()["blocks"] == ["4x32", "2x64"]
    assert _shape_count("4x32") + _shape_count("2x64") == n0 + 2
    d0 = _shape_count("8x32")
    monkeypatch.delenv("GSKY_PLAN_BLOCKS")
    assert tplan.plan_block(**p) is None      # another ladder, another key
    assert _shape_count("8x32") == d0 + 1
    assert tplan.plan_stats()["costed_shapes"] == 2
    tplan.reset_plan_state()
    assert tplan.plan_stats()["costed_shapes"] == 0
    monkeypatch.setenv("GSKY_PLAN", "0")
    assert tplan.plan_block(**p) is None
    assert _shape_count("8x32") == d0 + 1     # off: nothing counted


def test_stale_ladder_replay_c20(monkeypatch):
    """ROADMAP C.20: the reference persists a costed block to its kernel
    ledger and, after a reset, replays it into a planner whose ladder no
    longer lists it; the port's choice always comes from its ladder."""
    key = dict(h=256, w=256, n_ns=1, method="bilinear", T=4, S=8, pr=PR,
               pc=PC)
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", "256x128")
    assert japlan.plan_block(**key) == (256, 128)
    japlan.reset_plan_state()
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", "128x256,128x128")
    assert japlan.plan_block(**key) == (256, 128)       # off its ladder
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", "4x64")
    assert tplan.plan_block(**key) == (4, 64)
    tplan.reset_plan_state()
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", "2x64,4x32")
    assert tplan.plan_block(**key) in ((2, 64), (4, 32))
    monkeypatch.setenv("GSKY_PLAN_BLOCKS", "1x128")
    assert tplan.plan_block(**key) == (1, 128)          # no reset either


def _b1_inputs():
    rng = np.random.default_rng(20)
    pool = tpages.PagePool(capacity=12, page_rows=8, page_cols=128,
                           device="cpu")
    with pool.locked_pool() as parr:
        parr[1:] = torch.from_numpy(rng.uniform(
            -50, 100, tuple(parr[1:].shape)).astype(np.float32))
        parr[3, :2, :5] = float("nan")
    h, w = 37, 70
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    sx = torch.from_numpy(np.stack([xx * 1.3 + 2.0, xx * 0.7 + 40.0]))
    sy = torch.from_numpy(np.stack([yy * 0.4 + 1.0, yy * 0.3 + 3.0]))
    tables = torch.tensor([[[1, 2, 3, 4], [5, 6, 7, 8]],
                           [[9, 10, 0, 0], [5, 6, 7, 8]]], dtype=torch.int32)
    p = np.zeros((2, 2, 16), np.float32)
    for n in range(2):
        for t in range(2):
            p[n, t, :11] = [0.3 * t, 1, 0, 0.2, 0, 1, 16, 250 - 40 * t,
                            -50.0, 10 - t, t % 2]
            p[n, t, 11:16] = [0, 0, 16, 256, 2]
    return pool, tables, torch.from_numpy(p.reshape(4, 16)), sx, sy


@pytest.mark.parametrize("tile", [(8, 32), (4, 32), (2, 64), (4, 64),
                                  (1, 256), (2, 128), (1, 32)])
@pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
def test_plain_versions_take_every_tile(tile, method):
    """B1's and B2's plain versions (the wrappers on CPU tensors) take a
    planned tile and give the untiled call's values; B1 also under
    ``sb_of``."""
    pool, tables, params, sx, sy = _b1_inputs()
    with pool.locked_pool() as parr:
        want = tpaged.paged_render_scored(parr, tables, params, sx, sy,
                                          method, 2)
        got = tpaged.paged_render_scored(parr, tables, params, sx, sy,
                                         method, 2, None, tile)
        sb = torch.tensor([1, 0], dtype=torch.int32)
        rev = tpaged.paged_render_scored(parr, tables.flip(0).contiguous(),
                                         params, sx, sy, method, 2, sb, tile)
        scenes = [parr[1:5].reshape(32, 128).contiguous()] * 2
    for a, b in zip(got + rev, want + want):
        assert torch.equal(a, b)
    p2 = params[:2].clone()
    p2[:, 6], p2[:, 7] = 32, 128
    want = trender.warp_render_scored(scenes, sx[0], sy[0], p2, method, 2)
    got = trender.warp_render_scored(scenes, sx[0], sy[0], p2, method, 2,
                                     tile)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("tile", [(8, 48), (0, 32), (16, 32), (1, 1024),
                                  (2, 16)])
def test_wrappers_reject_a_tile_the_kernels_refuse(tile):
    pool, tables, params, sx, sy = _b1_inputs()
    with pool.locked_pool() as parr:
        with pytest.raises(ValueError, match="output tile"):
            tpaged.paged_render_scored(parr, tables, params, sx, sy,
                                       "near", 1, None, tile)
        with pytest.raises(ValueError, match="output tile"):
            trender.warp_render_scored([parr[1]], sx[0], sy[0],
                                       params[:1], "near", 1, tile)


@pytest.mark.parametrize("tile", [(8, 32), (4, 64), (1, 256), (2, 32)])
def test_block_boxes_at_every_tile(tile):
    """`block_boxes` tiles the output at any tile: its boxes cover every
    pixel's in-bounds taps, and a box over the staging budget is read
    directly whatever the tile."""
    pool, tables, params, sx, sy = _b1_inputs()
    boxes, fits = tpaged.block_boxes(sx[0], sy[0], params[:2], "cubic",
                                     tile)
    h, w = sx.shape[1:]
    assert boxes.shape[:3] == (-(-h // tile[0]), -(-w // tile[1]), 2)
    assert fits.all()
    big = params[:2].clone()
    big[:, 6], big[:, 7], big[:, 13], big[:, 14] = 4096, 4096, 4096, 4096
    _, fits = tpaged.block_boxes(sx[0] * 40, sy[0] * 40, big, "cubic", tile)
    assert not fits.all()
