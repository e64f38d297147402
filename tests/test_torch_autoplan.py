"""Port parity, the wave planner: `gsky_tpu_torch.pipeline.autoplan`
against `gsky_tpu.pipeline.autoplan` on identical wave entries.

Each case builds one group of lanes as numpy (page tables whose slots
are keyed by (granule, page row, page col), as a content-keyed pool
gives them; params rows with their page windows in slots 11-15; scene
serials; the shape of each lane's bucketed stack) and hands the same
values to both packages' `plan_wave_group`.  The plans must agree:
the same route, and equal ``tables``, ``params`` and ``sb_of`` arrays
for a superblock plan.  The reference also picks a Pallas output block
(`plan_block`), which the port leaves out; where it returns a
``"ragged"`` plan (a block, no superblock) the port returns None."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from gsky_tpu.pipeline import autoplan as japlan
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import waves as jwaves

from gsky_tpu_torch.pipeline import autoplan as tplan
from gsky_tpu_torch.pipeline import pages as tpages
from gsky_tpu_torch.pipeline import waves as twaves

PR, PC = 128, 512
STATICS = ("bilinear", 1, (256, 256), 16, True, 0)


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    for k in ("GSKY_PLAN", "GSKY_PLAN_HALO_MAX", "GSKY_PAGE_SLOTS"):
        monkeypatch.delenv(k, raising=False)
    japlan.reset_plan_state()
    tplan.reset_plan_state()
    yield
    japlan.reset_plan_state()
    tplan.reset_plan_state()


def _lane(windows, serials=(1, 2), stack=(2, 7936, 7936), affine=0.0):
    """One lane: per granule a page window (i0, i1, j0, j1) or None (a
    padding row).  Slots are 1 + 1000 t + 50 pi + pj."""
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
        p16[t, 11:16] = [i0 * PR, j0 * PC, (i1 - i0 + 1) * PR,
                         (j1 - j0 + 1) * PC, j1 - j0 + 1]
    return {"tables": tables, "params16": p16, "serials": serials,
            "stack": stack}


def _entries(lanes, kind="byte", statics=STATICS):
    """The same lanes as JAX and as port wave entries."""
    pool = SimpleNamespace(page_rows=PR, page_cols=PC)
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
    if jp is None or jp.route == "ragged":
        assert tp is None, tp.route
        return None
    assert tp is not None and tp.route == jp.route
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_reference(case):
    _same(*_plans(CASES[case]()))


def test_cases_cover_every_route():
    routes = {_same(*_plans(CASES[c]())) for c in CASES}
    assert routes == {None, "superblock", "bucketed"}


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
