"""Port parity, kernel tier: the plain PyTorch versions of the two
warp-render kernels (B1 paged, B2 bucketed), of the drill's masked
stats kernel (B3) and of the first-valid mosaic kernel (B4) against the
JAX package's Pallas kernels in interpret mode, plus the plain ops
around them (`_bilerp_grid`, `_cubic_weights`, `composite_scale`,
`scale_to_byte`, the argmax-form and weighted mosaics).

Every input is built once with numpy (float32/int32 explicitly: the
suite runs JAX with x64 on) and handed to both packages.  Tolerances:
nearest is bit-exact; bilinear and cubic canvases are within 2 ulp
(the port fuses the multiply-adds XLA's CPU lowering of the reference
contracts, so they agree to the bit on these inputs, but the stated
bound is the contract); the winning-priority planes (`best`) are exact;
byte tiles are identical.  B3: counts exact, means within rtol 1e-5 of
the Pallas kernel's (its final lane sum is XLA's `jnp.sum`, whose order
XLA picks: the bound the JAX package holds itself to); the plain
version's own summation order is pinned bit for bit.  B4: out and ok
bit-exact, the 0.0 fill and NaN / -0.0 / inf values included."""

import importlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsky_tpu.ops import mosaic as jmosaic
from gsky_tpu.ops import paged as jpaged
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.pipeline.pages import PagePool as JPagePool

# gsky_tpu.ops re-exports functions named `warp` and `scale_to_byte`
# over its submodules, so the modules are fetched by name
jwarp = importlib.import_module("gsky_tpu.ops.warp")
jscale = importlib.import_module("gsky_tpu.ops.scale")

from gsky_tpu_torch.carry import pool_from_reference
from gsky_tpu_torch.ops import first_valid as tfv
from gsky_tpu_torch.ops import mosaic as tmosaic
from gsky_tpu_torch.ops import paged as tpaged
from gsky_tpu_torch.ops import scale as tscale
from gsky_tpu_torch.ops import stats as tstats
from gsky_tpu_torch.ops import warp as twarp
from gsky_tpu_torch.ops import warp_render as trender

PR, PC = 64, 128


@pytest.fixture(autouse=True)
def _tmp_ledger(tmp_path, monkeypatch):
    """Hermetic race ledger for the JAX kernels."""
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))


def _inputs(seed=0, B=4, S=96, h=64, w=64, step=16, n_ns=2, lo=1.0,
            hi=4000.0, c_lo=4.0, c_hi=None):
    """tests/test_paged.py::_inputs as numpy: NaN patches, an
    all-nodata granule, two namespaces, unique priorities."""
    rng = np.random.default_rng(seed)
    stack = rng.uniform(lo, hi, (B, S, S)).astype(np.float32)
    stack[0, 10:20, 10:20] = np.nan
    if B > 1:
        stack[1, :, :] = -999.0
    gh = (h - 1 + step - 1) // step + 1
    gw = (w - 1 + step - 1) // step + 1
    if c_hi is None:
        c_hi = S - 12.0
    ctrl = np.stack([
        np.linspace(c_lo, c_hi, gw, dtype=np.float32)[None, :].repeat(gh, 0),
        np.linspace(c_lo, c_hi, gh, dtype=np.float32)[:, None].repeat(gw, 1)])
    params = np.zeros((B, 11), np.float32)
    for k in range(B):
        params[k] = [0.4 * k - 0.2, 1.01, 0.02, 0.3 * k, -0.01, 0.99,
                     S, S, -999.0, 100.0 - k, k % n_ns]
    return stack, ctrl.astype(np.float32), params, h, w, step, n_ns


def _stage_full(pool, stack, params, serial0=100, T=None):
    """Stage every granule's whole scene into the JAX pool; (T, S)
    tables and (T, 16) params (rows past the stack are padding)."""
    B = stack.shape[0]
    T = T or B
    tabs, grids = [], []
    for k in range(B):
        sh, sw = stack[k].shape
        ni, nj = -(-sh // pool.page_rows), -(-sw // pool.page_cols)
        tabs.append(pool.table_for(jnp.asarray(stack[k]), serial0 + k,
                                   0, ni - 1, 0, nj - 1))
        grids.append((ni, nj))
    S = 1
    while S < max(t.size for t in tabs):
        S *= 2
    tables = np.zeros((T, S), np.int32)
    p16 = np.zeros((T, 16), np.float32)
    p16[:, 10] = -1.0
    p16[:B, :11] = params[:, :11]
    for k, (t, (ni, nj)) in enumerate(zip(tabs, grids)):
        tables[k, :t.size] = t
        p16[k, 13] = ni * pool.page_rows
        p16[k, 14] = nj * pool.page_cols
        p16[k, 15] = nj
    return tables, p16


def _ref_pool(stack, params, T=None):
    pool = JPagePool(capacity=64, page_rows=PR, page_cols=PC)
    tables, p16 = _stage_full(pool, stack, params, T=T)
    return pool, tables, p16


def _jax_paged(pool, tables, p16, ctrl, method, n_ns, hw, step):
    with pool.locked_pool() as parr:
        c, b = jpaged.warp_scored_paged(
            parr, jnp.asarray(tables[None]), jnp.asarray(p16),
            jnp.asarray(ctrl)[None], method, n_ns, hw, step,
            interpret=True)
    return np.asarray(c[0]), np.asarray(b[0])


def _torch_paged(jpool, tables, p16, ctrl, method, n_ns, hw, step):
    tpool = pool_from_reference(np.asarray(jpool._pool), jpool._slots,
                                device="cpu")
    with tpool.locked_pool() as parr:
        c, b = tpaged.warp_scored_paged(
            parr, torch.from_numpy(tables[None]), torch.from_numpy(p16),
            torch.from_numpy(ctrl)[None], method, n_ns, hw, step)
    return c[0].numpy(), b[0].numpy()


def _check(method, cj, bj, ct, bt):
    np.testing.assert_array_equal(bj, bt)
    if method == "near":
        np.testing.assert_array_equal(cj, ct)
    else:
        np.testing.assert_array_almost_equal_nulp(cj, ct, nulp=2)


METHODS = ["near", "bilinear", "cubic"]


class TestPagedB1:
    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("n_ns", [1, 2, 4])
    def test_plain_vs_pallas_interpret(self, method, n_ns):
        stack, ctrl, params, h, w, step, _ = _inputs(seed=1, n_ns=n_ns)
        pool, tables, p16 = _ref_pool(stack, params)
        cj, bj = _jax_paged(pool, tables, p16, ctrl, method, n_ns,
                            (h, w), step)
        ct, bt = _torch_paged(pool, tables, p16, ctrl, method, n_ns,
                              (h, w), step)
        _check(method, cj, bj, ct, bt)

    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("n_ns,slots", [(2, (0, 1, 1, 0)),
                                            (4, (2, 1, 0, 1))])
    def test_expression_lane_slots(self, method, n_ns, slots):
        """Slots as a fused band-algebra lane fills them: a slot per
        variable, several granules in one, and at n_ns 4 a padded slot
        (3 variables) that no granule fills."""
        stack, ctrl, params, h, w, step, _ = _inputs(seed=8, n_ns=n_ns)
        params[:, 10] = slots           # granule 1 is all nodata
        pool, tables, p16 = _ref_pool(stack, params)
        cj, bj = _jax_paged(pool, tables, p16, ctrl, method, n_ns,
                            (h, w), step)
        ct, bt = _torch_paged(pool, tables, p16, ctrl, method, n_ns,
                              (h, w), step)
        _check(method, cj, bj, ct, bt)
        used = sorted(set(slots))
        assert np.isfinite(bt[used]).any(axis=(1, 2)).all()
        if n_ns == 4:
            assert np.isneginf(bt[3]).all() and (ct[3] == 0).all()

    @pytest.mark.parametrize("method", METHODS)
    def test_ragged_padding_rows_and_page_crossings(self, method):
        # 3 granules padded to T=4 (padding row: ns -1, null table);
        # 96-px scenes over 64x128 pages: every tile crosses page rows
        stack, ctrl, params, h, w, step, n_ns = _inputs(seed=2, B=3)
        pool, tables, p16 = _ref_pool(stack, params, T=4)
        assert (tables[3] == 0).all() and p16[3, 10] == -1.0
        cj, bj = _jax_paged(pool, tables, p16, ctrl, method, n_ns,
                            (h, w), step)
        ct, bt = _torch_paged(pool, tables, p16, ctrl, method, n_ns,
                              (h, w), step)
        _check(method, cj, bj, ct, bt)
        assert np.isfinite(bt).any()

    def test_null_tables_all_invalid(self):
        stack, ctrl, params, h, w, step, n_ns = _inputs(seed=3)
        pool, tables, p16 = _ref_pool(stack, params)
        tables[:] = 0                   # every tap hits the NaN page
        cj, bj = _jax_paged(pool, tables, p16, ctrl, "bilinear", n_ns,
                            (h, w), step)
        ct, bt = _torch_paged(pool, tables, p16, ctrl, "bilinear", n_ns,
                              (h, w), step)
        _check("bilinear", cj, bj, ct, bt)
        assert np.isneginf(bt).all() and (ct == 0).all()

    def test_wrapper_takes_plain_version_on_cpu(self):
        launches = trender.paged_render_kernel.launches
        stack, ctrl, params, h, w, step, n_ns = _inputs(seed=4, B=2)
        pool, tables, p16 = _ref_pool(stack, params)
        _torch_paged(pool, tables, p16, ctrl, "near", n_ns, (h, w), step)
        assert trender.paged_render_kernel.launches == launches


def _superblock_inputs(seed, method_lanes=4):
    """Two superblock rows over one staged pool: row 0 every granule's
    whole scene, row 1 the same with granule 1's table nulled; four
    lanes (rows 0, 1, 0, 1), each its own ctrl grid and affine."""
    stack, ctrl, params, h, w, step, n_ns = _inputs(seed=seed, B=3)
    pool, tables, p16 = _ref_pool(stack, params)
    T, S = tables.shape
    sb_tables = np.stack([tables, tables])
    sb_tables[1, 1] = 0
    sb_of = np.array([0, 1, 0, 1][:method_lanes], np.int32)
    N = sb_of.size
    lanes_p16 = np.repeat(p16[None], N, 0)
    ctrls = np.repeat(ctrl[None], N, 0)
    for n in range(N):
        lanes_p16[n, :, 0] += 0.75 * n
        lanes_p16[n, :, 3] -= 0.5 * n
        ctrls[n] += np.float32(1.5 * n)
    return (pool, sb_tables, lanes_p16.reshape(N * T, 16), ctrls, sb_of,
            (h, w), step, n_ns)


class TestPagedB1Superblocks:
    """B1 with ``sb_of``: tables (G, T, S), lane n reading row sb_of[n]
    (the wave planner's superblocks), against the Pallas program's
    ``pool[tables][sb_of]`` gather in interpret mode."""

    @pytest.mark.parametrize("method", METHODS)
    def test_plain_vs_pallas_interpret(self, method):
        pool, tables, p16, ctrls, sb_of, hw, step, n_ns = \
            _superblock_inputs(seed=21)
        with pool.locked_pool() as parr:
            cj, bj = jpaged.warp_scored_paged(
                parr, jnp.asarray(tables), jnp.asarray(p16),
                jnp.asarray(ctrls), method, n_ns, hw, step, interpret=True,
                sb_of=jnp.asarray(sb_of))
        tpool = pool_from_reference(np.asarray(pool._pool), pool._slots,
                                    device="cpu")
        with tpool.locked_pool() as parr:
            ct, bt = tpaged.warp_scored_paged(
                parr, torch.from_numpy(tables), torch.from_numpy(p16),
                torch.from_numpy(ctrls), method, n_ns, hw, step,
                sb_of=torch.from_numpy(sb_of))
        for n in range(sb_of.size):
            _check(method, np.asarray(cj[n]), np.asarray(bj[n]),
                   ct[n].numpy(), bt[n].numpy())
        assert np.isfinite(bt.numpy()).any()

    def test_lane_equals_its_row_rendered_alone(self):
        pool, tables, p16, ctrls, sb_of, hw, step, n_ns = \
            _superblock_inputs(seed=22)
        tpool = pool_from_reference(np.asarray(pool._pool), pool._slots,
                                    device="cpu")
        T = tables.shape[1]
        with tpool.locked_pool() as parr:
            ct, bt = tpaged.warp_scored_paged(
                parr, torch.from_numpy(tables), torch.from_numpy(p16),
                torch.from_numpy(ctrls), "bilinear", n_ns, hw, step,
                sb_of=torch.from_numpy(sb_of))
            for n, g in enumerate(sb_of):
                c1, b1 = tpaged.warp_scored_paged(
                    parr, torch.from_numpy(tables[g][None]),
                    torch.from_numpy(p16[n * T:(n + 1) * T]),
                    torch.from_numpy(ctrls[n][None]), "bilinear", n_ns,
                    hw, step)
                assert torch.equal(c1[0], ct[n]) and torch.equal(b1[0], bt[n])


def _b1_grid(h, w, scale, angle, x0, y0):
    """sx/sy (h, w) f32: a dst grid rotated by ``angle`` degrees and
    zoomed out by ``scale`` source pixels a dst pixel, from (x0, y0)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) + 0.5
    a = np.radians(angle)
    sx = x0 + scale * (np.cos(a) * xx - np.sin(a) * yy)
    sy = y0 + scale * (np.sin(a) * xx + np.cos(a) * yy)
    return (torch.from_numpy(sx.astype(np.float32)),
            torch.from_numpy(sy.astype(np.float32)))


def _b1_params():
    """Four granules over one 300 x 300 scene: a whole-scene window, a
    window of page rows 1.. and page columns 1.. (64 x 128 pages), an
    offset affine with a narrow true extent, and a padding row."""
    p16 = np.zeros((4, 16), np.float32)
    for k in range(4):
        p16[k, [1, 5]] = 1.0
        p16[k, [6, 7]] = 300.0
        p16[k, 8] = -999.0
        p16[k, 9] = 10.0 - k
        p16[k, [13, 14]] = (320, 384)
        p16[k, 15] = 3
    p16[1, [11, 12, 13, 14, 15]] = (64, 128, 192, 128, 1)
    p16[2, [0, 3, 6, 7]] = (7.25, -3.5, 120.0, 260.0)
    p16[3, 10] = -1.0
    return torch.from_numpy(p16)


def _brute_boxes(sx, sy, p16, method, block):
    """Every in-bounds tap of every pixel, enumerated tap by tap, reduced
    per (block, granule): {(by, bx, t): (r_lo, r_hi, c_lo, c_hi)}."""
    offs = {"near": (0,), "bilinear": (0, 1), "cubic": (-1, 0, 1, 2)}
    bh, bw = block
    out = {}
    for t, p in enumerate(p16):
        if not float(p[10]) >= 0:
            continue
        rows, cols = (v.numpy() for v in twarp.granule_coords(sx, sy, p))
        finite = np.isfinite(rows) & np.isfinite(cols)
        if method == "near":
            r0 = np.floor(np.where(finite, rows, 0.0).astype(np.float32)
                          + np.float32(0.5))
            c0 = np.floor(np.where(finite, cols, 0.0).astype(np.float32)
                          + np.float32(0.5))
        else:
            r0 = np.floor(np.where(finite, rows, -10.0))
            c0 = np.floor(np.where(finite, cols, -10.0))
        wr, wc = int(p[13]), int(p[14])
        for y in range(sx.shape[0]):
            for x in range(sx.shape[1]):
                for dr in offs[method]:
                    for dc in offs[method]:
                        ri, ci = int(r0[y, x]) + dr, int(c0[y, x]) + dc
                        if not (0 <= ri < wr and 0 <= ci < wc):
                            continue
                        if method == "near" and not finite[y, x]:
                            continue
                        key = (y // bh, x // bw, t)
                        b = out.get(key, (ri, ri, ci, ci))
                        out[key] = (min(b[0], ri), max(b[1], ri),
                                    min(b[2], ci), max(b[3], ci))
    return out


# (scale, degrees, x0, y0): native, rotated across the window's edges,
# zoomed out and rotated so that boxes exceed the staging budget
B1_GRIDS = {"identity": (1.0, 0.0, 20.0, 30.0),
            "rotated": (1.0, 30.0, 40.0, -10.0),
            "zoomed_out": (3.5, 30.0, 150.0, -20.0)}


class TestB1StagedBoxes:
    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("grid", sorted(B1_GRIDS))
    def test_block_boxes_match_brute_force(self, method, grid):
        sx, sy = _b1_grid(20, 70, *B1_GRIDS[grid])
        p16 = _b1_params()
        boxes, fits = tpaged.block_boxes(sx, sy, p16, method)
        want = _brute_boxes(sx, sy, p16, method, tpaged.BLOCK)
        nby, nbx, T = fits.shape
        assert (nby, nbx, T) == (3, 3, 4)
        for by in range(nby):
            for bx in range(nbx):
                for t in range(T):
                    b = tuple(int(v) for v in boxes[by, bx, t])
                    w = want.get((by, bx, t))
                    if w is None:
                        assert b[0] > b[1] and b[2] > b[3]
                        assert bool(fits[by, bx, t])
                        continue
                    assert b == w, (by, bx, t)
                    # the staged box: whole 16-byte column quads
                    elems = (w[1] - w[0] + 1) \
                        * ((w[3] | 3) + 1 - (w[2] & ~3))
                    assert bool(fits[by, bx, t]) == \
                        (elems * 4 <= tpaged.STAGE_BUDGET)
        assert not any(t == 3 for _, _, t in want)   # the padding row
        if grid == "zoomed_out":
            assert not bool(fits.all())
        else:
            assert bool(fits.all())

    def test_direct_counter_is_not_touched_by_the_plain_version(self):
        tpaged.reset_direct_blocks("cpu")
        stack, ctrl, params, h, w, step, n_ns = _inputs(seed=5, B=2)
        pool, tables, p16 = _ref_pool(stack, params)
        _torch_paged(pool, tables, p16, ctrl, "cubic", n_ns, (h, w), step)
        assert tpaged.direct_blocks("cpu") == 0


class TestBucketedB2:
    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("n_ns", [1, 2])
    def test_plain_vs_pallas_interpret(self, method, n_ns):
        stack, ctrl, params, h, w, step, _ = _inputs(seed=5, n_ns=n_ns,
                                                     S=128)
        cj, bj = jpt.warp_scenes_scored_pallas(
            jnp.asarray(stack), jnp.asarray(ctrl), jnp.asarray(params),
            method, n_ns, (h, w), step, interpret=True)
        ct, bt = trender.warp_scenes_scored(
            torch.from_numpy(stack), torch.from_numpy(ctrl),
            torch.from_numpy(params), method, n_ns, (h, w), step)
        _check(method, np.asarray(cj), np.asarray(bj), ct.numpy(),
               bt.numpy())

    @pytest.mark.parametrize("method", METHODS)
    def test_kernel_plain_vs_argmax_reference(self, method):
        # the loop-form mosaic of B2's plain version against the JAX
        # package's argmax-form XLA reference (no Pallas)
        stack, ctrl, params, h, w, step, n_ns = _inputs(seed=6, S=128)
        cj, bj = jwarp.warp_scenes_ctrl_scored(
            jnp.asarray(stack), jnp.asarray(ctrl), jnp.asarray(params),
            method, n_ns, (h, w), step)
        ct, bt = trender.warp_scenes_scored(
            torch.from_numpy(stack), torch.from_numpy(ctrl),
            torch.from_numpy(params), method, n_ns, (h, w), step)
        _check(method, np.asarray(cj), np.asarray(bj), ct.numpy(),
               bt.numpy())

    @pytest.mark.parametrize("method", METHODS)
    def test_four_namespaces_vs_both_references(self, method):
        """n_ns 4 (an RGB style's three namespaces, one slot unused):
        against the Pallas kernel, and against the reference's XLA
        `_warp_scenes_scored`.  For cubic the reference's two programs
        differ from each other on these inputs (its own cubic parity
        test fails, ROADMAP C); the port equals the Pallas kernel, so
        its distance to the XLA program is the reference's own."""
        stack, ctrl, params, h, w, step, _ = _inputs(seed=9, B=6, S=128,
                                                     n_ns=3)
        args = (jnp.asarray(stack), jnp.asarray(ctrl), jnp.asarray(params),
                method, 4, (h, w), step)
        ct, bt = trender.warp_scenes_scored(
            torch.from_numpy(stack), torch.from_numpy(ctrl),
            torch.from_numpy(params), method, 4, (h, w), step)
        cp, bp = (np.asarray(a) for a in jpt.warp_scenes_scored_pallas(
            *args, interpret=True))
        cx, bx = (np.asarray(a) for a in jwarp.warp_scenes_ctrl_scored(
            *args))
        _check(method, cp, bp, ct.numpy(), bt.numpy())
        if method == "cubic":
            np.testing.assert_array_equal(bx, bt.numpy())
            assert (np.abs(ct.numpy() - cx) <= np.abs(cp - cx)).all()
        else:
            _check(method, cx, bx, ct.numpy(), bt.numpy())
        assert np.isneginf(bt[3].numpy()).all()
        assert np.isfinite(bt[:3].numpy()).any(axis=(1, 2)).all()

    @pytest.mark.parametrize("method", METHODS)
    def test_render_bytes_vs_xla_reference(self, method):
        stack, ctrl, params, h, w, step, n_ns = _inputs(seed=7, S=128)
        sp = np.array([0.0, 0.0, 0.0], np.float32)
        bj = np.asarray(jwarp.render_scenes_ctrl(
            jnp.asarray(stack), jnp.asarray(ctrl), jnp.asarray(params),
            jnp.asarray(sp), method, n_ns, (h, w), step))
        bt = trender.render_scenes(
            torch.from_numpy(stack), torch.from_numpy(ctrl),
            torch.from_numpy(params), torch.from_numpy(sp), method, n_ns,
            (h, w), step).numpy()
        diff = np.count_nonzero(bj != bt)
        if method == "near":
            assert diff == 0
        else:
            assert diff <= bj.size // 1000


    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("n_ns", [1, 2])
    def test_scene_sequence_zoomed_out_rotated(self, method, n_ns):
        # B2 as the decline leg calls it: three scenes handed over one by
        # one, the padding row dropped; against the stacked form with the
        # padding row and against the Pallas kernel, on a grid 3x zoomed
        # out and rotated 30 degrees
        rng = np.random.default_rng(21)
        B, S, h, w, step = 4, 256, 64, 64, 16
        stack = rng.uniform(1.0, 4000.0, (B, S, S)).astype(np.float32)
        stack[0, 40:70, 60:120] = np.nan
        stack[1, 100:180, :] = -999.0
        gh = gw = (h - 1 + step - 1) // step + 1
        cc, rr = np.meshgrid(np.arange(gw) * step + 0.5,
                             np.arange(gh) * step + 0.5)
        a = np.radians(30.0)
        ctrl = np.stack([110.0 + 3.0 * (np.cos(a) * cc - np.sin(a) * rr),
                         3.0 * (np.sin(a) * cc + np.cos(a) * rr)]) \
            .astype(np.float32)
        params = np.zeros((B, 11), np.float32)
        for k in range(B):
            params[k] = [0.4 * k - 0.2, 1.01, 0.02, 0.3 * k, -0.01, 0.99,
                         S, S, -999.0, 100.0 - k, k % n_ns]
        params[B - 1, 10] = -1.0                  # the padding row
        cj, bj = jpt.warp_scenes_scored_pallas(
            jnp.asarray(stack), jnp.asarray(ctrl), jnp.asarray(params),
            method, n_ns, (h, w), step, interpret=True)
        scenes = torch.from_numpy(stack)
        ct, bt = trender.warp_scenes_scored(
            scenes, torch.from_numpy(ctrl), torch.from_numpy(params),
            method, n_ns, (h, w), step)
        cs, bs = trender.warp_scenes_scored(
            [scenes[k] for k in range(B - 1)], torch.from_numpy(ctrl),
            torch.from_numpy(params[:B - 1]), method, n_ns, (h, w), step)
        assert torch.equal(cs, ct) and torch.equal(bs, bt)
        _check(method, np.asarray(cj), np.asarray(bj), cs.numpy(),
               bs.numpy())
        assert (bs > float("-inf")).any() and (bs == float("-inf")).any()

    def test_pointer_tables_are_keyed_by_their_content(self):
        t = trender._pointer_table("cpu", [16, 32, 48])
        assert t.dtype == torch.int64 and t.tolist() == [16, 32, 48]
        assert trender._pointer_table("cpu", [16, 32, 48]) is t
        assert trender._pointer_table("cpu", [16, 32]) is not t


class TestPlainOps:
    @pytest.mark.parametrize("hw,step", [((64, 64), 16), ((256, 256), 16),
                                         ((100, 70), 8)])
    def test_bilerp_grid_identical(self, hw, step):
        h, w = hw
        rng = np.random.default_rng(11)
        gh = (h - 1 + step - 1) // step + 1
        gw = (w - 1 + step - 1) // step + 1
        ctrl = rng.uniform(-3e4, 3e4, (gh, gw)).astype(np.float32)
        # the reference's programs run the upsample under jit, where
        # XLA fuses its multiply-adds; eager JAX rounds every op apart
        jgrid = jax.jit(jwarp._bilerp_grid, static_argnums=(1, 2, 3))
        gj = np.asarray(jgrid(jnp.asarray(ctrl), h, w, step))
        gt = twarp._bilerp_grid(torch.from_numpy(ctrl), h, w, step).numpy()
        np.testing.assert_array_equal(gj, gt)

    def test_cubic_weights(self):
        # w0, w2, w3 round exactly as the reference's op sequence; w1 is
        # the multiply-add the reference kernels fuse (the kernel parity
        # tests above pin that form), so against the unfused eager
        # sequence it may differ by the one rounding the fusion removes
        # (an ulp of the O(1) intermediate, not of w1, which nears 0)
        f = np.random.default_rng(12).uniform(0, 1, 4096).astype(np.float32)
        wj = [np.asarray(a) for a in jwarp._cubic_weights(jnp.asarray(f))]
        wt = [b.numpy() for b in twarp._cubic_weights(torch.from_numpy(f))]
        for k in (0, 2, 3):
            np.testing.assert_array_equal(wj[k], wt[k])
        np.testing.assert_allclose(wj[1], wt[1], rtol=0, atol=2.0 ** -23)

    def test_fma_single_rounding(self):
        rng = np.random.default_rng(15)
        x, y, z = (rng.standard_normal(20000).astype(np.float32)
                   for _ in range(3))
        got = twarp.fma(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(z)).numpy()
        for i in range(0, 20000, 97):
            e = Fraction(float(x[i])) * Fraction(float(y[i])) \
                + Fraction(float(z[i]))
            lo = np.float32(float(e))
            # correctly rounded: no float32 is closer to the exact value
            cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                     np.nextafter(lo, np.float32(np.inf))]
            best = min(cands, key=lambda c: abs(Fraction(float(c)) - e))
            assert got[i] == best

    @pytest.mark.parametrize("auto", [True, False])
    @pytest.mark.parametrize("colour_scale", [0, 1])
    def test_composite_scale_identical(self, auto, colour_scale):
        rng = np.random.default_rng(13)
        canv = rng.uniform(0.5, 3000.0, (2, 64, 64)).astype(np.float32)
        vals = rng.uniform(size=(2, 64, 64)) > 0.3
        sp = np.array([-10.0, 0.0, 2500.0], np.float32)
        bj = np.asarray(jwarp.composite_scale(
            jnp.asarray(canv), jnp.asarray(vals), jnp.asarray(sp), auto,
            colour_scale))
        bt = twarp.composite_scale(torch.from_numpy(canv),
                                   torch.from_numpy(vals),
                                   torch.from_numpy(sp), auto,
                                   colour_scale).numpy()
        np.testing.assert_array_equal(bj, bt)

    @pytest.mark.parametrize("auto", [True, False])
    @pytest.mark.parametrize("colour_scale", [0, 1])
    @pytest.mark.parametrize("osc", [(0.0, 0.0, 300.0), (5.0, 0.3, 0.0)])
    def test_scale_to_byte_identical(self, auto, colour_scale, osc):
        rng = np.random.default_rng(14)
        data = rng.uniform(0.01, 1000.0, (64, 64)).astype(np.float32)
        data[0, :8] = [1.0, 10.0, 100.0, 1000.0, 0.0, -1.0, np.nan, 2.5]
        valid = rng.uniform(size=(64, 64)) > 0.2
        bj = np.asarray(jscale.scale_to_byte(
            jnp.asarray(data), jnp.asarray(valid), *osc,
            colour_scale=colour_scale, auto=auto))
        bt = tscale.scale_to_byte(torch.from_numpy(data),
                                  torch.from_numpy(valid), *osc,
                                  colour_scale=colour_scale,
                                  auto=auto).numpy()
        np.testing.assert_array_equal(bj, bt)


def test_cuda_tensor_on_cpu_only_build_raises_not_falls_back():
    """The wrappers never fall back: a non-CPU, non-CUDA tensor raises."""
    t = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        trender.warp_render_scored(t, t[0], t[0], torch.zeros((1, 16)),
                                   "near", 1)


def test_kernel_launches_on_its_operands_device(monkeypatch):
    """A launch enters its operands' device and takes that device's
    current stream, whichever device is current."""
    from gsky_tpu_torch.ops import cuda_lib
    seen = []

    class Device:
        def __init__(self, device):
            seen.append(("device", device))

        def __enter__(self):
            seen.append("enter")

        def __exit__(self, *exc):
            seen.append("exit")

    class Stream:
        cuda_stream = 1234

    def current_stream(device=None):
        seen.append(("stream", device))
        return Stream()

    class Library:
        def load(self):
            return self

        def launch_x(self, *args):
            seen.append(("launch", args))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    kernel = cuda_lib.Kernel(Library(), "launch_x")
    dev = torch.device("cuda", 1)
    kernel(dev, 7, 8)
    assert seen == [("device", dev), "enter", ("stream", dev),
                    ("launch", (7, 8, 1234)), "exit"]
    assert kernel.launches == 1


def test_build_all_compiles_each_content_once(tmp_path, monkeypatch):
    """Two libraries of one content (a source and its copy in another
    checkout, as kernel_pair.py builds them) share a target and one nvcc;
    the others build beside it.  nvcc is a stand-in script here."""
    from gsky_tpu_torch.ops import cuda_lib
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    runs = tmp_path / "runs"
    nvcc.write_text("#!/bin/sh\necho x >> %s\n" % runs +
                    'while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; '
                    'shift; done\necho lib > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_lib, "BUILD", tmp_path / "build")
    srcs = []
    for name, text in (("a/k.cu", "one"), ("b/k.cu", "one"),
                       ("c/k.cu", "two")):
        src = tmp_path / name
        src.parent.mkdir()
        src.write_text(text)
        srcs.append(cuda_lib.CudaLibrary(str(src), {}))
    out = cuda_lib.build_all(srcs)
    assert out[0] == out[1] != out[2]
    assert all(p.read_text() == "lib\n" for p in out)
    assert runs.read_text().count("x") == 2
    assert cuda_lib.build_all(srcs) == out          # built: no nvcc
    assert runs.read_text().count("x") == 2


def test_kernel_pair_needs_a_card_and_imports_no_jax():
    """kernel_pair.py, which times kernels built from several checkouts,
    imports nothing of JAX and exits non-zero without CUDA."""
    import ast
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = ast.parse(open(os.path.join(repo, "kernel_pair.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "gsky_tpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "kernel_pair.py", "build/none"],
                       cwd=repo, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "is_available() is False" in r.stderr
    assert "{" not in r.stdout


def _b3_inputs(seed, B, N, edge=False):
    """data/valid as numpy; with ``edge``: an all-invalid row, values on
    the clip bounds, and NaN / +-inf where valid is False."""
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(B, N)) * 100).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.3
    if edge:
        valid[0] = False
        data[-1, ::7] = -80.0
        data[-1, 3::7] = 120.0
        valid[-1, ::7] = True
        valid[-1, 3::7] = True
        bad = ~valid
        bad[0] = True
        data[bad & (rng.uniform(size=(B, N)) < 0.3)] = np.nan
        data[bad & (rng.uniform(size=(B, N)) < 0.1)] = np.inf
        data[bad & (rng.uniform(size=(B, N)) < 0.1)] = -np.inf
    return data, valid


def _b3_means(s, c):
    s, c = np.asarray(s), np.asarray(c)
    return np.where(c > 0, s / np.maximum(c, 1), 0.0)


def _b3_order_reference(data, valid, lo, hi):
    """B3's documented order in numpy float32: each of 2048 lanes summed
    over the row's chunks in order (masked and tail lanes add 0.0), then
    the pairwise lane tree."""
    B, N = data.shape
    nch = -(-N // tstats.CHUNK)
    inclip = valid & (data >= np.float32(lo)) & (data <= np.float32(hi))
    vals = np.zeros((B, nch * tstats.CHUNK), np.float32)
    vals[:, :N] = np.where(inclip, data, np.float32(0.0))
    acc = np.zeros((B, tstats.CHUNK), np.float32)
    for c in range(nch):
        acc = acc + vals[:, c * tstats.CHUNK:(c + 1) * tstats.CHUNK]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0], inclip.sum(-1).astype(np.int32)


class TestMaskedStatsB3:
    """Shapes of tests/test_pallas.py::TestStatsKernel, then tails, empty
    rows and the edge values the card check also uses."""

    @pytest.mark.parametrize("B,N,lo,hi,edge", [
        (5, 7000, -80.0, 120.0, False),
        (3, 500, -3.0e38, 3.0e38, False),
        (1000, 4096, -2.0, 2.0, False),
        (1, 1, -80.0, 120.0, False),
        (7, 2047, -80.0, 120.0, True),
        (129, 2049, -80.0, 120.0, True),
        (4, 16384, -80.0, 120.0, True),
    ])
    def test_plain_vs_pallas_interpret(self, B, N, lo, hi, edge):
        data, valid = _b3_inputs(B * 31 + N, B, N, edge)
        if (B, N) == (3, 500):
            valid[:] = False                  # empty bands
        sj, cj = jpt.masked_stats_pallas(jnp.asarray(data),
                                         jnp.asarray(valid), lo, hi,
                                         interpret=True)
        st, ct = tstats.masked_stats(torch.from_numpy(data),
                                     torch.from_numpy(valid), lo, hi)
        assert st.dtype == torch.float32 and ct.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        np.testing.assert_allclose(_b3_means(st, ct), _b3_means(sj, cj),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("B,N", [(3, 1), (5, 2048), (6, 2049),
                                     (2, 10000)])
    def test_plain_summation_order_is_pinned(self, B, N):
        data, valid = _b3_inputs(N, B, N, edge=True)
        s, c = tstats.masked_stats_plain(torch.from_numpy(data),
                                         torch.from_numpy(valid),
                                         -80.0, 120.0)
        rs, rc = _b3_order_reference(data, valid, -80.0, 120.0)
        np.testing.assert_array_equal(s.numpy(), rs)
        np.testing.assert_array_equal(c.numpy(), rc)

    def test_uint8_valid_and_clip_rounded_to_f32(self):
        data, valid = _b3_inputs(3, 4, 3000)
        lo = 0.1                                   # not a float32
        a = tstats.masked_stats(torch.from_numpy(data),
                                torch.from_numpy(valid), lo, 50.0)
        b = tstats.masked_stats(torch.from_numpy(data),
                                torch.from_numpy(valid.astype(np.uint8)),
                                float(np.float32(lo)), 50.0)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_wrapper_takes_plain_version_on_cpu(self, monkeypatch):
        calls = []
        plain = tstats.masked_stats_plain
        monkeypatch.setattr(tstats, "masked_stats_plain",
                            lambda *a: calls.append(1) or plain(*a))
        launches = tstats.masked_stats_kernel.launches
        data, valid = _b3_inputs(1, 2, 100)
        tstats.masked_stats(torch.from_numpy(data), torch.from_numpy(valid))
        assert calls == [1]
        assert tstats.masked_stats_kernel.launches == launches

    def test_non_cpu_non_cuda_tensor_raises(self):
        t = torch.zeros((2, 8), device="meta")
        with pytest.raises(ValueError):
            tstats.masked_stats(t, t.bool())



class TestMaskedStatsB3Blocks:
    """B3's K-block form (the drill wave's reduction): its plain version
    against the JAX package's `wave_drill_stats` (counts equal, means
    within rtol 1e-5), and each block's rows bit for bit its per-call
    reduction's."""

    @pytest.mark.parametrize("K,B,N,edge", [(1, 3, 500, False),
                                            (4, 7, 2049, True),
                                            (3, 5, 7000, False)])
    @pytest.mark.parametrize("pixel_count", [False, True])
    def test_plain_vs_reference_wave_drill_stats(self, K, B, N, edge,
                                                 pixel_count):
        blocks = [_b3_inputs(100 * K + k, B, N, edge) for k in range(K)]
        vj, cj = jpaged.wave_drill_stats(
            jnp.asarray(np.stack([d for d, _ in blocks])),
            jnp.asarray(np.stack([v for _, v in blocks])), -80.0, 120.0,
            pixel_count=pixel_count)
        vt, ct = tpaged.wave_drill_stats(
            [torch.from_numpy(d) for d, _ in blocks],
            [torch.from_numpy(v) for _, v in blocks], -80.0, 120.0,
            pixel_count)
        assert vt.shape == (K, B) and vt.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                                   atol=1e-6)

    def test_blocks_equal_per_call_rows(self):
        blocks = [_b3_inputs(7 + k, 5, 4097, edge=True) for k in range(4)]
        s, c = tstats.masked_stats_many(
            [torch.from_numpy(d) for d, _ in blocks],
            [torch.from_numpy(v) for _, v in blocks], -80.0, 120.0)
        for k, (d, v) in enumerate(blocks):
            s1, c1 = tstats.masked_stats(torch.from_numpy(d),
                                         torch.from_numpy(v), -80.0, 120.0)
            assert torch.equal(s[k], s1) and torch.equal(c[k], c1)

    def test_wrapper_takes_plain_version_on_cpu(self):
        launches = tstats.masked_stats_many_kernel.launches
        d, v = _b3_inputs(1, 2, 100)
        tstats.masked_stats_many([torch.from_numpy(d)],
                                 [torch.from_numpy(v)])
        assert tstats.masked_stats_many_kernel.launches == launches


def _b4_inputs(seed, T, H, W, edge=False, p_valid=0.4):
    """stack (T, H, W) f32 x 50 and valid bool; with ``edge``: an
    all-invalid column band, NaN / +-inf / -0.0 in valid layers, and
    NaN / inf in invalid ones."""
    rng = np.random.default_rng(seed)
    stack = (rng.normal(size=(T, H, W)) * 50).astype(np.float32)
    valid = rng.uniform(size=(T, H, W)) < p_valid
    if edge:
        valid[:, :, : max(1, W // 5)] = False
        special = np.array([np.nan, np.inf, -np.inf, -0.0], np.float32)
        pick = rng.uniform(size=(T, H, W)) < 0.2
        stack[pick] = special[rng.integers(0, 4, int(pick.sum()))]
        # a NaN with a payload, to show the value moves as bits
        stack.view(np.uint32)[0, 0, -1] = 0x7fc12345
        valid[0, 0, -1] = True
        bad = ~valid & (rng.uniform(size=(T, H, W)) < 0.3)
        stack[bad] = np.where(rng.uniform(size=int(bad.sum())) < 0.5,
                              np.nan, np.inf).astype(np.float32)
    return stack, valid


def _b4_check(stack, valid, valid_dtype=np.bool_):
    oj, okj = jpt.mosaic_first_valid_pallas(
        jnp.asarray(stack), jnp.asarray(valid.astype(valid_dtype)),
        interpret=True)
    ot, okt = tfv.mosaic_first_valid_kernel(
        torch.from_numpy(stack),
        torch.from_numpy(valid.astype(valid_dtype)))
    assert ot.dtype == torch.float32 and okt.dtype == torch.bool
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(ot.numpy().view(np.int32),
                                  np.asarray(oj).view(np.int32))
    return ot.numpy(), okt.numpy()


class TestFirstValidB4:
    """Shapes of tests/test_pallas.py::TestMosaicKernel, then T in
    {1, 3, 8, 128}, ragged H/W and the special values."""

    def test_matches_pallas_on_the_reference_shape(self):
        stack, valid = _b4_inputs(7, 6, 200, 300)
        _b4_check(stack, valid)

    def test_all_invalid_fills_positive_zero(self):
        stack = np.ones((3, 64, 64), np.float32)
        out, ok = _b4_check(stack, np.zeros((3, 64, 64), bool))
        assert not ok.any() and (out.view(np.int32) == 0).all()

    def test_priority_order_wins(self):
        stack = np.stack([np.full((32, 32), 9.0, np.float32),
                          np.full((32, 32), 5.0, np.float32)])
        out, _ = _b4_check(stack, np.ones((2, 32, 32), bool))
        assert (out == 9.0).all()

    @pytest.mark.parametrize("T", [1, 3, 8, 128])
    @pytest.mark.parametrize("hw", [(1, 1), (37, 45), (130, 129)])
    def test_ragged_shapes_and_special_values(self, T, hw):
        if T == 128 and hw == (130, 129):
            hw = (20, 131)          # keep the interpreter quick
        stack, valid = _b4_inputs(T * 1000 + hw[1], T, *hw, edge=True,
                                  p_valid=0.15 if T > 8 else 0.4)
        _b4_check(stack, valid)

    def test_int8_valid_mask(self):
        stack, valid = _b4_inputs(21, 8, 40, 50, edge=True)
        _b4_check(stack, valid, np.int8)
        a = tfv.mosaic_first_valid_kernel(torch.from_numpy(stack),
                                          torch.from_numpy(valid))
        b = tfv.mosaic_first_valid_kernel(
            torch.from_numpy(stack),
            torch.from_numpy(valid.astype(np.uint8)))
        assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
        assert torch.equal(a[1], b[1])

    def test_wrapper_takes_plain_version_on_cpu(self, monkeypatch):
        calls = []
        plain = tfv.mosaic_first_valid_plain
        monkeypatch.setattr(tfv, "mosaic_first_valid_plain",
                            lambda *a: calls.append(1) or plain(*a))
        launches = tfv.first_valid_kernel.launches
        stack, valid = _b4_inputs(3, 2, 8, 8)
        tfv.mosaic_first_valid_kernel(torch.from_numpy(stack),
                                      torch.from_numpy(valid))
        assert calls == [1]
        assert tfv.first_valid_kernel.launches == launches

    def test_non_cpu_non_cuda_tensor_raises(self):
        t = torch.zeros((2, 8, 8), device="meta")
        with pytest.raises(ValueError):
            tfv.mosaic_first_valid_kernel(t, t.bool())


class TestMosaicForms:
    """The argmax form (padded T > 128) and the weighted blend against
    the JAX package's XLA functions, bit for bit."""

    @pytest.mark.parametrize("T", [1, 5, 129])
    def test_argmax_form_identical(self, T):
        stack, valid = _b4_inputs(T, T, 33, 47, edge=True, p_valid=0.05)
        oj, okj = jmosaic.mosaic_first_valid(jnp.asarray(stack),
                                             jnp.asarray(valid))
        ot, okt = tmosaic.mosaic_first_valid(torch.from_numpy(stack),
                                             torch.from_numpy(valid))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_array_equal(ot.numpy().view(np.int32),
                                      np.asarray(oj).view(np.int32))
        # the all-invalid fill is the top layer's value, not 0.0
        assert (~okt.numpy()).any()

    @pytest.mark.parametrize("T", [1, 2, 4, 8, 32])
    def test_weighted_identical(self, T):
        rng = np.random.default_rng(T)
        stack = rng.uniform(-1000, 1000, (T, 60, 70)).astype(np.float32)
        valid = rng.uniform(size=(T, 60, 70)) > 0.3
        w = rng.uniform(0.1, 3, T).astype(np.float32)
        oj, okj = jmosaic.mosaic_weighted(jnp.asarray(stack),
                                          jnp.asarray(valid), jnp.asarray(w))
        ot, okt = tmosaic.mosaic_weighted(torch.from_numpy(stack),
                                          torch.from_numpy(valid),
                                          torch.from_numpy(w))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_array_equal(ot.numpy().view(np.int32),
                                      np.asarray(oj).view(np.int32))
