"""Port parity, fused band algebra: `gsky_tpu_torch.ops.expr`'s
fingerprints, `ops.paged.expr_epilogue` / `render_expr_paged`, the
executor's `render_expr_byte`, `TilePipeline._expr_prep` and the
``expr`` wave kind, against the JAX package and against the port's own
unfused leg (per-band mosaic, `evaluate_expressions`, `scale_to_byte`).

Inputs are made from a seed with numpy and handed to both packages; the
JAX side runs its Pallas kernels in interpret mode (``GSKY_PALLAS=
interpret``, ``interpret=True``), the port on ``device="cpu"`` (the
kernels' plain versions).  Bounds: fingerprint keys, slots, literals
and hashes equal; epilogue planes bit-exact where the expression has no
transcendental call, within `test_torch_mosaic._ULP` where it has one
(PyTorch's and XLA's float32 transcendentals are not correctly rounded
alike), validity equal; byte tiles identical for nearest and within
0.1% of bytes for bilinear and cubic; the port's fused tiles identical
to its unfused ones; `expr_fused_stats()` paths equal the reference's
where both packages take the same leg."""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsky_tpu.geo.crs import parse_crs as jparse_crs
from gsky_tpu.geo.transform import BBox as JBBox
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.geo.transform import transform_bbox as jtransform_bbox
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.geotiff import write_geotiff as jwrite_geotiff
from gsky_tpu.ops import expr as jexpr
from gsky_tpu.ops import paged as jpaged
from gsky_tpu.ops.scale import scale_to_byte as jscale_to_byte
from gsky_tpu.pipeline import autoplan as japlan
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import waves as jwaves
from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
from gsky_tpu.pipeline.pages import PagePool as JPagePool
from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
from gsky_tpu.pipeline.types import GeoTileRequest as JRequest

from gsky_tpu_torch.carry import pool_from_reference
from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import BBox
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.ops import expr as texpr
from gsky_tpu_torch.ops import paged as tpaged
from gsky_tpu_torch.ops import warp_render as trender
from gsky_tpu_torch.ops.scale import scale_to_byte
from gsky_tpu_torch.pipeline import autoplan as tplan
from gsky_tpu_torch.pipeline import waves as twaves
from gsky_tpu_torch.pipeline.tile import TilePipeline, evaluate_expressions
from gsky_tpu_torch.pipeline.types import GeoTileRequest

from test_torch_kernels import PC, PR, _stage_full
from test_torch_mosaic import _ULP

METHODS = ("near", "bilinear", "cubic")
# every production of the grammar: arithmetic, comparisons, && || !,
# the ternary, calls, unary minus, % and **; literals only beside a
# variable (a literal-only subexpression folds in Python doubles in the
# interpreter, in float32 in the epilogue)
GRAMMAR = [
    "(a - b) / (a + b)",
    "a > 1200 ? a : b",
    "(a >= 800 && b < 2500) ? a - b : -b",
    "a < 600 || b != 0 ? max(a, b) : min(a, b)",
    "sqrt(abs(a - b)) + log10(b)",
    "!(a > b) * 254",
    "a % 97 + pow(b, 0.5)",
    "floor(a / 16) * 16 == a ? 1 : a",
    "a ** 2 - b * 0.5",
]
TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Interpret-mode Pallas and a hermetic race ledger for the
    reference; both packages' expression counters, schedulers and
    planner counters fresh."""
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("GSKY_RENDER_BATCH", "0")
    for k in ("GSKY_WAVES", "GSKY_EXPR_FUSE", "GSKY_PAGE_SLOTS",
              "GSKY_WAVE_PIPELINE", "GSKY_PLAN"):
        monkeypatch.delenv(k, raising=False)
    jpaged.reset_expr_fused_stats()
    tpaged.reset_expr_fused_stats()
    jwaves.reset_waves()
    twaves.reset_waves()
    japlan.reset_plan_state()
    tplan.reset_plan_state()
    yield
    jwaves.reset_waves()
    twaves.reset_waves()
    jpages.reset_default_pool()


def _bx(module, srcs):
    """Both packages' BandExpressions for raw expression strings (a
    comparison holds '=', which the config's ``name = expr`` split
    cannot carry)."""
    ces = [module.compile_expr(s) for s in srcs]
    return module.BandExpressions(
        expressions=ces, expr_names=[f"e{i}" for i in range(len(ces))],
        var_list=sorted({v for ce in ces for v in ce.variables}),
        expr_var_ref=[list(ce.variables) for ce in ces],
        expr_text=list(srcs), passthrough=False)


def _tile(seed, S=96, h=64, w=64, step=16, nan_a=((10, 30), (10, 30)),
          nan_b=((20, 44), (24, 48))):
    """Two granules (variable 'a' = granule 0, 'b' = granule 1) with
    overlapping but distinct NaN patches: all four valid/invalid
    quadrants."""
    rng = np.random.default_rng(seed)
    stack = rng.uniform(1.0, 4000.0, (2, S, S)).astype(np.float32)
    for k, patch in enumerate((nan_a, nan_b)):
        if patch is not None:
            stack[k, patch[0][0]:patch[0][1], patch[1][0]:patch[1][1]] = \
                np.nan
    gh = (h - 1 + step - 1) // step + 1
    gw = (w - 1 + step - 1) // step + 1
    ctrl = np.stack([
        np.linspace(4.0, S - 12.0, gw, dtype=np.float32)[None, :]
        .repeat(gh, 0),
        np.linspace(4.0, S - 12.0, gh, dtype=np.float32)[:, None]
        .repeat(gw, 1)])
    params = np.zeros((2, 11), np.float32)
    for k in range(2):
        params[k] = [0.4 * k - 0.2 + 0.003 * seed, 1.01, 0.02,
                     0.3 * k + 0.002 * seed, -0.01, 0.99, S, S, -999.0,
                     100.0 - k, k]
    return stack, ctrl, params, h, w, step


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _lane(src, stack, params, names=("a", "b")):
    """`_expr_prep`'s mapping for a crafted tile: granules of variables
    the expression does not reference dropped, namespace ids set to
    fingerprint slots.  (fingerprint, stack, params, n_ns)."""
    fp = texpr.fingerprint(texpr.compile_expr(src))
    keep = [k for k, v in enumerate(names[:len(stack)]) if v in fp.slots]
    p = params[keep].copy()
    for i, k in enumerate(keep):
        p[i, 10] = fp.slots.index(names[k])
    return fp, stack[keep], p, _pow2(fp.n_slots)


def _fused_both(src, tile, method, sp, auto=True, cs=0, names=("a", "b")):
    """The fused tile from both packages over one staged JAX pool and
    the port's copy of it: (JAX bytes, port bytes)."""
    stack, ctrl, params, h, w, step = tile
    fp, stack, p, n_ns = _lane(src, stack, params, names)
    jfp = jexpr.fingerprint(jexpr.compile_expr(src))
    jpool = JPagePool(capacity=64, page_rows=PR, page_cols=PC)
    tables, p16 = _stage_full(jpool, stack, p)
    consts = fp.const_array()
    with jpool.locked_pool() as parr:
        j = jpaged.render_expr_paged(
            parr, jnp.asarray(tables[None]), jnp.asarray(p16),
            jnp.asarray(ctrl)[None], jnp.asarray(sp[None]),
            jnp.asarray(consts[None]), method, n_ns, (h, w), step, auto,
            cs, jfp.key, interpret=True)
    tpool = pool_from_reference(np.asarray(jpool._pool), jpool._slots,
                                device="cpu")
    with tpool.locked_pool() as parr:
        t = tpaged.render_expr_paged(
            parr, torch.from_numpy(tables[None]), torch.from_numpy(p16),
            torch.from_numpy(ctrl)[None], sp[None],
            torch.from_numpy(consts[None]), method, n_ns, (h, w), step,
            auto, cs, fp.key, fp.hash)
    return np.asarray(j[0]), t[0].numpy()


def _unfused_port(src, tile, method, sp, auto=True, cs=0):
    """The port's unfused leg: B2's per-namespace mosaic, the
    interpreter (`evaluate_expressions`), `scale_to_byte`."""
    stack, ctrl, params, h, w, step = tile
    canv, best = trender.warp_scenes_scored(
        torch.from_numpy(stack), torch.from_numpy(ctrl),
        torch.from_numpy(params), method, 2, (h, w), step)
    exprs = _bx(texpr, [src])
    res = evaluate_expressions(
        exprs, {"a": canv[0], "b": canv[1]},
        {"a": best[0] > float("-inf"), "b": best[1] > float("-inf")},
        h, w, "cpu")
    return scale_to_byte(res.data["e0"], res.valid["e0"], float(sp[0]),
                         float(sp[1]), float(sp[2]), cs, auto).numpy()


def _host(x):
    """A byte tile on the host: a wave's result already is."""
    return x if isinstance(x, np.ndarray) else x.numpy()


def _same_bytes(method, a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = int(np.count_nonzero(a != b))
    assert diff == 0 if method == "near" else diff <= a.size // 1000, diff


def _nulp(src):
    return max((u for f, u in _ULP.items() if f in src), default=0)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

FP_SRCS = GRAMMAR + ["(b5 - b4) / (b5 + b4)", "nir > 0.3 ? nir - red : 0",
                     "LC08_B5#t1 * 2 + LC08_B4", "exp(-x / 100)"]


@pytest.mark.parametrize("src", FP_SRCS)
def test_fingerprint_matches_reference(src):
    j = jexpr.fingerprint(jexpr.compile_expr(src))
    t = texpr.fingerprint(texpr.compile_expr(src))
    assert t.key == j.key
    assert t.slots == j.slots
    assert t.consts == j.consts
    assert t.hash == j.hash and len(t.hash) == 12
    np.testing.assert_array_equal(t.const_array(), j.const_array())
    assert t.const_array().dtype == np.float32
    assert texpr.fingerprint_hash(t.key) == jexpr.fingerprint_hash(j.key)
    assert tuple(texpr.compile_expr(src).variables) == t.slots


def test_structure_shared_across_names_and_literals():
    a = texpr.fingerprint(texpr.compile_expr("(nir - red) / (nir + red)"))
    b = texpr.fingerprint(texpr.compile_expr("(b5 - b4) / (b5 + b4)"))
    assert a.key == b.key and a.hash == b.hash
    c = texpr.fingerprint(texpr.compile_expr("a > 1 ? 1 : 0"))
    d = texpr.fingerprint(texpr.compile_expr("a > 2 ? 1 : 0"))
    assert c.key == d.key
    assert (c.consts, d.consts) == ((1.0, 1.0, 0.0), (2.0, 1.0, 0.0))
    assert texpr.fingerprint(texpr.compile_expr("a >= 1 ? 1 : 0")).key \
        != c.key
    ce = texpr.compile_expr("b4 < b8 ? b8 : b4")
    assert texpr.fingerprint(ce) is texpr.fingerprint(ce)   # cached


def _planes(seed, shape=(3, 16, 20)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, 4000.0, shape).astype(np.float32),
            rng.uniform(1.0, 4000.0, shape).astype(np.float32))


@pytest.mark.parametrize("src", GRAMMAR)
def test_eval_fingerprint_matches_interpreter_and_reference(src):
    """Over tensors the fingerprint evaluator is the interpreter, op for
    op: identical to `CompiledExpr` with the literals as Python floats;
    against the reference's evaluator bit-exact but for
    transcendentals."""
    a, b = _planes(3)
    env = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    ce = texpr.compile_expr(src)
    fp = texpr.fingerprint(ce)
    consts = [torch.tensor(c, dtype=torch.float32) for c in fp.consts]
    got = texpr.eval_fingerprint(fp.key, [env[v] for v in fp.slots],
                                 consts)
    np.testing.assert_array_equal(got.numpy(), ce(env, torch).numpy())
    jfp = jexpr.fingerprint(jexpr.compile_expr(src))
    want = np.asarray(jexpr.eval_fingerprint(
        jfp.key, [jnp.asarray(a if v == "a" else b) for v in jfp.slots],
        [jnp.float32(c) for c in jfp.consts]), np.float32)
    nulp = _nulp(src)
    if nulp:
        np.testing.assert_array_almost_equal_nulp(got.numpy(), want, nulp)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src", GRAMMAR)
def test_expr_epilogue_matches_reference(src):
    """The epilogue over one scored mosaic block of 3 lanes, each lane
    its own literals row: validity equal, planes bit-exact but for
    transcendentals, 0.0 where invalid."""
    a, b = _planes(4)
    rng = np.random.default_rng(5)
    best = np.where(rng.uniform(size=(3, 2, 16, 20)) > 0.25,
                    np.float32(7.0), -np.inf).astype(np.float32)
    canv = np.stack([a, b], 1)
    fp = texpr.fingerprint(texpr.compile_expr(src))
    consts = np.stack([fp.const_array() * s for s in (1.0, 0.5, 2.0)])
    consts = consts.reshape(3, len(fp.consts)).astype(np.float32)
    jfp = jexpr.fingerprint(jexpr.compile_expr(src))
    jp, jok = jpaged.expr_epilogue(jnp.asarray(canv), jnp.asarray(best),
                                   jfp.key, jnp.asarray(consts))
    tp, tok = tpaged.expr_epilogue(torch.from_numpy(canv),
                                   torch.from_numpy(best), fp.key,
                                   torch.from_numpy(consts))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tp.dtype == torch.float32 and tuple(tp.shape) == (3, 16, 20)
    assert not tp.numpy()[~tok.numpy()].any()
    nulp = _nulp(src)
    if nulp:
        np.testing.assert_array_almost_equal_nulp(tp.numpy(),
                                                  np.asarray(jp), nulp)
    else:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


# ---------------------------------------------------------------------------
# the fused tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("src", GRAMMAR)
def test_render_expr_paged_matches_reference(method, src):
    sp = np.zeros(3, np.float32)
    j, t = _fused_both(src, _tile(0), method, sp)
    _same_bytes(method, j, t)
    assert (t != 255).any()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("src", GRAMMAR)
def test_fused_equals_the_ports_unfused_leg(method, src):
    """B1 + the epilogue equals the per-band mosaic + the interpreter
    + `scale_to_byte`, byte for byte."""
    tile = _tile(1)
    sp = np.zeros(3, np.float32)
    _, fused = _fused_both(src, tile, method, sp)
    np.testing.assert_array_equal(fused,
                                  _unfused_port(src, tile, method, sp))


@pytest.mark.parametrize("auto,cs,sp", [
    (False, 0, (10.0, 0.05, 0.0)), (False, 1, (0.0, 0.0, 4.0)),
    (True, 1, (0.0, 0.0, 0.0))])
def test_fixed_scale_and_log_colour_scale(auto, cs, sp):
    """Fixed scaling byte-exact against the reference; a log10 colour
    scale within 0.1% of bytes (its log10 is a transcendental); both
    identical to the port's unfused leg."""
    src = "a > 1200 ? a : b"
    tile = _tile(2)
    sp = np.array(sp, np.float32)
    j, t = _fused_both(src, tile, "near", sp, auto, cs)
    _same_bytes("near" if cs == 0 else "bilinear", j, t)
    np.testing.assert_array_equal(
        t, _unfused_port(src, tile, "near", sp, auto, cs))


def test_disjoint_validity_intersects():
    """A pixel is valid iff valid in every referenced band: NaN patches
    that cover different quarters of the tile."""
    src = "(a - b) / (a + b)"
    tile = _tile(3, nan_a=((0, 48), (0, 48)), nan_b=((24, 80), (24, 80)))
    sp = np.zeros(3, np.float32)
    j, t = _fused_both(src, tile, "near", sp)
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(t, _unfused_port(src, tile, "near", sp))
    assert (t == 255).any() and (t != 255).any()


def test_missing_variable_is_all_invalid():
    """A variable without a granule: its slot gathers nothing, every
    pixel is invalid, as the interpreter's missing band gives."""
    src = "(a - b) / (a + b)"
    stack, ctrl, params, h, w, step = _tile(4)
    tile = (stack[:1], ctrl, params[:1], h, w, step)
    j, t = _fused_both(src, tile, "near", np.zeros(3, np.float32),
                       names=("a",))
    np.testing.assert_array_equal(j, t)
    res = evaluate_expressions(
        _bx(texpr, [src]), {"a": torch.zeros((h, w))},
        {"a": torch.zeros((h, w), dtype=torch.bool)}, h, w, "cpu")
    want = scale_to_byte(res.data["e0"], res.valid["e0"], auto=True)
    np.testing.assert_array_equal(t, want.numpy())
    assert (t == 255).all()


def test_page_walk_across_two_bands_windows():
    """256-px scenes over 64 x 128 pages: both bands' taps cross page
    rows and columns."""
    src = "a > 1200 ? a : b"
    tile = _tile(5, S=256)
    jpool = JPagePool(capacity=64, page_rows=PR, page_cols=PC)
    tables, _ = _stage_full(jpool, tile[0], tile[2])
    assert tables.shape[1] >= 8
    sp = np.zeros(3, np.float32)
    for method in METHODS:
        j, t = _fused_both(src, tile, method, sp)
        _same_bytes(method, j, t)
        np.testing.assert_array_equal(t, _unfused_port(src, tile, method,
                                                       sp))


@pytest.mark.parametrize("seed", range(6))
def test_union_lane_spans_matches_reference(seed):
    rng = np.random.default_rng(seed)
    spans = []
    for _ in range(int(rng.integers(1, 6))):
        if rng.uniform() < 0.2:
            spans.append(None)
            continue
        i0, j0 = int(rng.integers(0, 5)), int(rng.integers(0, 5))
        spans.append((i0, i0 + int(rng.integers(0, 3)), j0,
                      j0 + int(rng.integers(0, 3))))
    npg = [(s[1] - s[0] + 1) * (s[3] - s[2] + 1) for s in spans if s]
    maxnpg = max(npg, default=1)
    for cap in (4, 8, 16, 64):
        assert tplan.union_lane_spans(list(spans), cap, maxnpg) == \
            japlan.union_lane_spans(list(spans), cap, maxnpg)


# ---------------------------------------------------------------------------
# qualification: `_expr_prep`
# ---------------------------------------------------------------------------

def _g(ns, ts):
    return SimpleNamespace(namespace=ns, timestamp=ts, path=f"/{ns}")


def _prep(cls, module, granules, srcs):
    p = cls.__new__(cls)
    p.remote = None
    p._timed_index = lambda req, spans=None: list(granules)
    return p.composite_prep(SimpleNamespace(mask=None,
                                            band_exprs=_bx(module, srcs)))


def _prep_both(granules, srcs):
    j = _prep(JTilePipeline, jexpr, granules, srcs)
    t = _prep(TilePipeline, texpr, granules, srcs)
    if j is None or t is None:
        assert j is None and t is None
        return None
    assert len(t) == len(j)
    assert [g.namespace for g in t[0]] == [g.namespace for g in j[0]]
    assert list(t[1:4]) == list(j[1:4])
    if len(t) == 5:
        assert (t[4].key, t[4].slots, t[4].consts) == \
            (j[4].key, j[4].slots, j[4].consts)
    return t


def test_prep_resolves_slots_and_drops_unreferenced_namespaces():
    made = _prep_both([_g("red", 1.0), _g("nir", 2.0), _g("nir", 3.0),
                       _g("cloud", 4.0)], ["(nir - red) / (nir + red)"])
    kept, ns_ids, prio, n_slots, fp = made
    assert n_slots == 2 and fp.slots == ("nir", "red")
    assert [g.namespace for g in kept] == ["red", "nir", "nir"]
    assert ns_ids == [1, 0, 0]
    assert prio[2] > prio[1] > prio[0]


def test_prep_resolves_a_unique_axis_candidate():
    made = _prep_both([_g("nir#t=1", 1.0), _g("red#t=1", 2.0)],
                      ["(nir - red) / (nir + red)"])
    assert made[1] == [0, 1]
    # two candidates for one variable: neither resolves, both drop
    made = _prep_both([_g("nir#t=1", 1.0), _g("nir#t=2", 2.0),
                       _g("red", 3.0)], ["(nir - red) / (nir + red)"])
    assert [g.namespace for g in made[0]] == ["red"] and made[1] == [1]


def test_prep_keeps_the_single_band_form_and_disqualifies(monkeypatch):
    assert len(_prep_both([_g("red", 1.0)], ["red"])) == 4
    gs = [_g("nir", 1.0), _g("red", 2.0)]
    assert _prep_both(gs, ["nir - red", "nir + red"]) is None
    assert _prep_both([], ["nir - red"]) is None
    assert _prep_both([_g("cloud", 1.0)], ["nir - red"]) is None
    monkeypatch.setenv("GSKY_EXPR_FUSE", "0")
    assert not texpr.expr_fuse_enabled()
    assert _prep_both(gs, ["nir - red"]) is None
    assert tpaged.expr_fused_stats()["paths"] == {"unfused": 1} == \
        jpaged.expr_fused_stats()["paths"]


def test_animation_prep_declines_band_algebra():
    p = TilePipeline(None, device="cpu")
    p._timed_index = lambda req, spans=None: [_g("nir", 1.0)]
    req = SimpleNamespace(mask=None, band_exprs=_bx(texpr, ["nir * 2"]))
    assert p.animation_prep(req, [1.0, 2.0]) is None


# ---------------------------------------------------------------------------
# end to end through the tile pipeline
# ---------------------------------------------------------------------------

UTM55 = "EPSG:32755"
MERC = "EPSG:3857"
# one date of nine single-band products b0..b8, two dates of nir/red
NINE = [f"b{i}" for i in range(9)]


def _write_archive(root):
    utm = jparse_crs(UTM55)
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:300, 0:300].astype(np.float32)
    out = []
    for ns, day, k in [("nir", 10, 0), ("red", 10, 1), ("nir", 11, 2),
                       ("red", 11, 3)] + [(n, 12, 4 + i)
                                          for i, n in enumerate(NINE)]:
        field = 1500 + 900 * np.sin(xx / (13 + 3 * k)) * np.cos(yy / 19)
        data = (field + rng.normal(0, 60, field.shape)).astype(np.int16)
        data[(xx + 2 * yy) < 90 + 10 * k] = -999
        gt = JGT(600000.0 + 600.0 * (k % 3), 30.0, 0.0,
                 6100000.0 - 450.0 * (k % 2), 0.0, -30.0)
        p = os.path.join(root, f"{ns}_202001{day:02d}_{k}.tif")
        jwrite_geotiff(p, data, gt, utm, nodata=-999)
        out.append((p, ns))
    return out


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("expr_archive"))
    jstore, tstore = JMASStore(), MASStore()
    for p, ns in _write_archive(root):
        for ex, st in ((jextract, jstore), (extract, tstore)):
            rec = ex(p)
            assert not rec.get("error"), rec
            for ds in rec["geo_metadata"]:
                ds["namespace"] = ns
            st.ingest(rec)
    return {"root": root, "jstore": jstore, "tstore": tstore}


def _box():
    c = jtransform_bbox(JBBox(601500.0, 6097500.0, 601501.0, 6097501.0),
                        jparse_crs(UTM55), jparse_crs(MERC))
    return (c.xmin, c.ymin - 4000.0, c.xmin + 4000.0, c.ymin)


def _render(archive, src, method, times=None, hw=(80, 96)):
    """(JAX tile, port tile, JAX fused-route tile or None, port fused-
    route tile or None): the fused route first, the modular route and
    `scale_to_byte` where it declines, as the OWS ladder serves it."""
    kw = dict(bands=[src], width=hw[1], height=hw[0], resample=method,
              start_time=times[0] if times else None,
              end_time=times[1] if times else None)
    jreq = JRequest(collection=archive["root"], bbox=JBBox(*_box()),
                    crs=jparse_crs(MERC), **kw)
    treq = GeoTileRequest(collection=archive["root"], bbox=BBox(*_box()),
                          crs=parse_crs(MERC), **kw)
    jpages.reset_default_pool()
    jpipe = JTilePipeline(JMASClient(archive["jstore"]),
                          executor=JWarpExecutor())
    tpipe = TilePipeline(MASClient(archive["tstore"]), device="cpu")
    out = []
    for pipe, req, scale, conv in (
            (jpipe, jreq, jscale_to_byte, np.asarray),
            (tpipe, treq, scale_to_byte, _host)):
        fused = pipe.render_composite_byte(req)
        if fused is not None:
            out.append((conv(fused), conv(fused)))
            continue
        res = pipe.process(req)
        name = res.namespaces[0]
        out.append((conv(scale(res.data[name], res.valid[name],
                               auto=True)), None))
    return out[0][0], out[1][0], out[0][1], out[1][1], tpipe


T_BOTH = (1578614400.0, 1578787200.0)       # 2020-01-10 .. 2020-01-12
T_NINE = (1578787200.0, 1578873600.0)       # 2020-01-12 .. 2020-01-13


@pytest.mark.parametrize("method", METHODS)
def test_pipeline_fuses_an_ndvi_tile_through_b1(archive, method,
                                                monkeypatch):
    calls = []
    real = tpaged.paged_render_scored
    monkeypatch.setattr(tpaged, "paged_render_scored",
                        lambda *a: calls.append(a[6]) or real(*a))
    monkeypatch.setenv("GSKY_WAVES", "0")
    src = "ndvi = (nir - red) / (nir + red)"
    j, t, jf, tf, pipe = _render(archive, src, method, T_BOTH)
    assert jf is not None and tf is not None
    _same_bytes(method, j, t)
    assert (t != 255).mean() > 0.5
    # one B1 launch at n_ns 2, the four granules' windows in one table
    assert calls == [2]
    assert pipe.executor.paged_engaged == 1
    assert tpaged.expr_fused_stats() == jpaged.expr_fused_stats() == \
        {"programs": 1, "paths": {"percall": 1}}


def test_escape_hatch_takes_the_unfused_leg(archive, monkeypatch):
    monkeypatch.setenv("GSKY_WAVES", "0")
    src = "thr = nir > 1500 ? nir - red : 0"
    j, t, jf, tf, _ = _render(archive, src, "near", T_BOTH)
    assert jf is not None and tf is not None
    monkeypatch.setenv("GSKY_EXPR_FUSE", "0")
    j0, t0, jf0, tf0, _ = _render(archive, src, "near", T_BOTH)
    assert jf0 is None and tf0 is None
    for a in (j, j0, t0):
        np.testing.assert_array_equal(t, a)
    assert tpaged.expr_fused_stats()["paths"] == \
        jpaged.expr_fused_stats()["paths"] == {"percall": 1, "unfused": 1}


def test_more_than_eight_slots_take_the_unfused_leg(archive, monkeypatch):
    """Nine variables pad to 16 mosaic slots, past the kernels' 8: the
    port declines the fused route (counted "unfused" and in
    `ns_declined`) and the modular route gives the reference's fused
    bytes."""
    monkeypatch.setenv("GSKY_WAVES", "0")
    src = "s = " + " + ".join(NINE)
    j, t, jf, tf, pipe = _render(archive, src, "near", T_NINE)
    assert jf is not None and tf is None
    np.testing.assert_array_equal(j, t)
    assert (t != 255).any()
    assert pipe.executor.ns_declined == 1
    assert tpaged.expr_fused_stats()["paths"] == {"unfused": 1}
    assert jpaged.expr_fused_stats()["paths"] == {"percall": 1}


# ---------------------------------------------------------------------------
# the `expr` wave kind
# ---------------------------------------------------------------------------

def _run_threads(fns):
    out, errs = [None] * len(fns), [None] * len(fns)

    def go(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:   # noqa: BLE001 - raised below
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,), daemon=True)
          for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "a wave request never returned"
    for e in errs:
        if e is not None:
            raise e
    return out


@pytest.mark.parametrize("method", ["near", "bilinear"])
def test_expr_wave_equals_per_call_and_groups_by_fingerprint(method):
    """Two expressions of one structure (their literals differ) share a
    launch; a third structure gets its own.  Every lane equals its
    per-call fused tile and the reference's."""
    srcs = ["a > 1200 ? a : b", "a > 900 ? a : b", "(a - b) / (a + b)"]
    sp = np.array([0.0, 0.0, 0.0], np.float32)
    jpool = JPagePool(capacity=64, page_rows=PR, page_cols=PC)
    lanes = []
    for i, src in enumerate(srcs):
        stack, ctrl, params, h, w, step = _tile(10 + i)
        fp, stack, p, n_ns = _lane(src, stack, params)
        tables, p16 = _stage_full(jpool, stack, p, serial0=100 * (i + 1))
        lanes.append((src, fp, stack, p, ctrl, tables, p16, n_ns, h, w,
                      step))
    tpool = pool_from_reference(np.asarray(jpool._pool), jpool._slots,
                                device="cpu")
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)

    def one(lane):
        src, fp, stack, p, ctrl, tables, p16, n_ns, h, w, step = lane
        with tpool.lock:              # pinned, as the executor hands over
            for s in tables.reshape(-1).tolist():
                tpool._pins[s] = tpool._pins.get(s, 0) + 1
        # a large dense stack in the planner's estimate: the lanes stay
        # on B1 (the bucketed route has its own test)
        bl = twaves.BucketedLane([torch.from_numpy(s) for s in stack], p,
                                 torch.from_numpy(ctrl), (2, 4096, 4096))
        statics = (method, n_ns, (h, w), step, True, 0, fp.key)
        return sched.render_expr(tpool, tables, p16, ctrl, sp,
                                 fp.const_array(), statics, bl,
                                 serials=(id(lane),))

    try:
        got = _run_threads([lambda ln=ln: one(ln) for ln in lanes])
        st = sched.stats()
    finally:
        sched.shutdown()
    assert st["requests"] == 3 and st["failed"] == 0
    assert st["dispatches"] == 2 and st["occupancy"] == {1: 1, 2: 1}
    assert tpool.stats()["pinned"] == 0
    assert tpaged.expr_fused_stats()["programs"] == 2
    for i, (lane, g) in enumerate(zip(lanes, got)):
        src, stack, ctrl, params = lane[0], *_tile(10 + i)[:3]
        j, per = _fused_both(src, _tile(10 + i), method, sp)
        np.testing.assert_array_equal(g, per)
        _same_bytes(method, j, g)


def test_expr_wave_bucketed_route_runs_b2_per_lane(monkeypatch):
    """Lanes whose scenes are smaller than their padded tables take the
    planner's bucketed route: B2 once a lane and the same epilogue,
    bytes equal to the paged per-call tile."""
    src = "(a - b) / (a + b)"
    sp = np.zeros(3, np.float32)
    jpool = JPagePool(capacity=64, page_rows=PR, page_cols=PC)
    b2 = []
    real = trender.warp_render_scored
    monkeypatch.setattr(trender, "warp_render_scored",
                        lambda *a: b2.append(1) or real(*a))
    lanes = []
    for i in range(3):
        stack, ctrl, params, h, w, step = _tile(20 + i, S=48, h=32, w=32)
        params[:, 6:8] = 40.0
        fp, stack, p, n_ns = _lane(src, stack, params)
        tables, p16 = _stage_full(jpool, stack, p, serial0=300 + 10 * i)
        lanes.append((fp, stack, p, ctrl, tables, p16, n_ns, h, w, step))
    tpool = pool_from_reference(np.asarray(jpool._pool), jpool._slots,
                                device="cpu")
    sched = twaves.WaveScheduler("cpu", tick_ms=1000.0)

    def one(lane):
        fp, stack, p, ctrl, tables, p16, n_ns, h, w, step = lane
        with tpool.lock:
            for s in tables.reshape(-1).tolist():
                tpool._pins[s] = tpool._pins.get(s, 0) + 1
        bl = twaves.BucketedLane([torch.from_numpy(s) for s in stack], p,
                                 torch.from_numpy(ctrl), (2, 8, 8))
        return sched.render_expr(
            tpool, tables, p16, ctrl, sp, fp.const_array(),
            ("near", n_ns, (h, w), step, True, 0, fp.key), bl,
            serials=(id(lane),))

    try:
        got = _run_threads([lambda ln=ln: one(ln) for ln in lanes])
        st = sched.stats()
    finally:
        sched.shutdown()
    assert st["bucketed_lanes"] == 3 and len(b2) == 3
    assert tplan.plan_stats()["routes"]["bucketed"] == 1
    for lane, g in zip(lanes, got):
        fp, stack, p, ctrl, tables, p16, n_ns, h, w, step = lane
        with tpool.locked_pool() as parr:
            per = tpaged.render_expr_paged(
                parr, torch.from_numpy(tables[None]), torch.from_numpy(p16),
                torch.from_numpy(ctrl)[None], sp[None],
                torch.from_numpy(fp.const_array()[None]), "near", n_ns,
                (h, w), step, True, 0, fp.key)
        np.testing.assert_array_equal(g, per[0].numpy())


def test_pipeline_in_waves_equals_per_call(archive, monkeypatch):
    src = "ndvi = (nir - red) / (nir + red)"
    monkeypatch.setenv("GSKY_WAVES", "0")
    _, per, _, _, _ = _render(archive, src, "bilinear", T_BOTH)
    monkeypatch.setenv("GSKY_WAVES", "1")
    j, t, _, tf, _ = _render(archive, src, "bilinear", T_BOTH)
    assert tf is not None
    np.testing.assert_array_equal(t, per)
    _same_bytes("bilinear", j, t)
    assert tpaged.expr_fused_stats()["paths"] == {"percall": 1, "wave": 1}
    assert twaves.wave_stats()["cpu"]["requests"] == 1
