"""Server-start prewarm: the kernels built, loaded and launched before
the server listens.

Counterpart of `gsky_tpu/server/prewarm.py`.  The reference compiles an
XLA program per point of its shape lattice at start, so that the first
request after a deploy meets no compile.  The port has no XLA compiles;
what its first request would pay for is building the CUDA libraries
with nvcc, loading them, and the first launch of each kernel symbol
(its module's code loads then, under CUDA's lazy loading).  `prewarm`
does that work, in order:

1. `ops.cuda_lib.build_all` over every library under ``csrc/`` (one
   nvcc each, in parallel, into ``build/``) and their loads;
2. the page pool's allocation (the serving executor's pool);
3. one launch of kernel B1 (`ops.paged.render_byte_paged`, or
   `render_expr_paged` for a fused expression) per (method, tile edge,
   power-of-two wave size) point of the reference's lattice over the
   configured layers and styles (`layer_specs`, `layer_expr_specs`,
   `wave_size_lattice`), and of kernel B2 (`ops.warp_render.
   render_scenes`) per (method, tile edge), each synchronised.  The
   reference's granule and page-slot axes are compile keys of XLA
   programs: one CUDA kernel serves every point of them.  Its block
   axis is kept: where `pipeline.autoplan.plan_block` plans a tile other
   than the default for a point (B1 with its wave size as the lane
   count, B2 over the bucket-sized scene), that tile is launched once
   too, so that the first planned launch after a start is not the
   first of its tile (``blocks``: the planned launches by tile);
4. with mesh serving on (``GSKY_MESH=1``), the mesh layouts' first
   launches on every member (`MeshDispatcher.prewarm_programs`),
   counted in ``mesh_programs``.

On a CPU executor there is nothing to build: the launches run the
kernels' plain versions and `compile_count` does not move.

`compile_count` is `ops.cuda_lib.compile_count` (nvcc builds, library
loads, first launches of a kernel symbol), published as
``gsky_compiles_total``.  The reference's `install_compile_probe` (a
`jax.monitoring` listener) and `configure_compilation_cache` (XLA's
persistent cache) have no CUDA counterpart: the count needs no probe,
and a built library stays in ``build/``, keyed by the hash of its
source and flags, across restarts.

Knobs, as the reference's: ``GSKY_PREWARM=0`` skips it;
``GSKY_PREWARM_SIZES`` (tile edges, default "256"),
``GSKY_PREWARM_BUCKET`` (the scene edge, default 512),
``GSKY_PREWARM_WAVE_SIZES`` (default the pow2 ladder up to
``GSKY_WAVE_MAX`` when waves are on, else "1").
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..ops import cuda_lib

log = logging.getLogger("gsky.prewarm")


def compile_count() -> int:
    """Builds, loads and first symbol launches in this process.  The
    reference's `install_compile_probe` and `configure_compilation_cache`
    have no CUDA meaning and no counterpart here (module docstring)."""
    return cuda_lib.compile_count()


def prewarm_enabled() -> bool:
    return os.environ.get("GSKY_PREWARM", "1") != "0"


def _env_list(name: str, default: str) -> List[int]:
    out = []
    for tok in os.environ.get(name, default).split(","):
        tok = tok.strip()
        if tok:
            try:
                out.append(int(tok))
            except ValueError:
                pass
    return out


def wave_size_lattice() -> List[int]:
    """Pow2 wave sizes the sweep covers.  GSKY_PREWARM_WAVE_SIZES
    overrides (comma list, clamped to [1, 64]); by default the pow2
    ladder up to `wave_max()` when waves are on, else just 1."""
    env = os.environ.get("GSKY_PREWARM_WAVE_SIZES", "")
    if env:
        sizes = sorted({max(1, min(64, v))
                        for v in _env_list("GSKY_PREWARM_WAVE_SIZES",
                                           "")})
        return sizes or [1]
    from ..pipeline.waves import wave_max, waves_enabled
    if not waves_enabled():
        return [1]
    out, w = [], 1
    while w <= wave_max():
        out.append(w)
        w *= 2
    return out


def layer_specs(configs: Dict) -> Set[Tuple[str, int, bool, int]]:
    """Distinct (method, n_exprs, auto, colour_scale) combinations the
    configured layers and styles can dispatch."""
    from ..ops.scale import scale_params_auto
    specs: Set[Tuple[str, int, bool, int]] = set()
    for cfg in configs.values():
        for lay in cfg.layers:
            for style in [lay] + list(lay.styles):
                exprs = style.rgb_products or lay.rgb_products
                n = len(exprs) or 1
                if n > 4:
                    continue          # beyond the fused fast path
                method = style.resample or lay.resample or "near"
                auto = scale_params_auto(style.offset_value,
                                         style.scale_value,
                                         style.clip_value)
                specs.add((method, n, auto, int(style.colour_scale)))
    return specs


def layer_expr_specs(configs: Dict):
    """Distinct (method, auto, colour_scale, fingerprint) combinations
    of the single-expression layers and styles whose band algebra can
    take the fused paged epilogue; structurally equal expressions share
    one point."""
    from ..ops.expr import fingerprint, parse_band_expressions
    from ..ops.scale import scale_params_auto
    specs = {}
    for cfg in configs.values():
        for lay in cfg.layers:
            for style in [lay] + list(lay.styles):
                exprs = style.rgb_products or lay.rgb_products
                if len(exprs) != 1:
                    continue
                try:
                    ce = parse_band_expressions(
                        list(exprs)).expressions[0]
                except Exception:
                    continue          # the request path reports it
                if ce._ast[0] == "var" or not ce.variables:
                    continue          # trivial: rides the byte path
                method = style.resample or lay.resample or "near"
                auto = scale_params_auto(style.offset_value,
                                         style.scale_value,
                                         style.clip_value)
                fp = fingerprint(ce)
                specs[(method, auto, int(style.colour_scale),
                       fp.hash)] = fp
    return [(m, a, cs, fp)
            for (m, a, cs, _h), fp in sorted(specs.items())]


def _ctrl_grid(height: int, width: int, bh: int, bw: int,
               step: int) -> np.ndarray:
    """(2, gh, gw) f32 control grid mapping the tile onto the scene, an
    identity-like affine, so that the launches gather real taps."""
    gh = (height - 1 + step - 1) // step + 1
    gw = (width - 1 + step - 1) // step + 1
    c = np.arange(gw, dtype=np.float32) * step + 0.5
    r = np.arange(gh, dtype=np.float32) * step + 0.5
    C, R = np.meshgrid(c * (bw / max(1, width)),
                       r * (bh / max(1, height)))
    return np.stack([C, R]).astype(np.float32)


def _params(n: int, bh: int, bw: int, pad: Optional[int] = None,
            per_ns: bool = False) -> np.ndarray:
    """(pad or n, 11) f32 kernel param rows: inverse-affine identity,
    scene dims, NaN nodata, descending priority, ns id 0 (or one
    namespace a row); rows past ``n`` carry ns id -1, the padding
    convention."""
    B = pad or n
    p = np.zeros((B, 11), np.float32)
    p[:, 10] = -1.0
    for i in range(n):
        p[i, :6] = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        p[i, 6] = bh
        p[i, 7] = bw
        p[i, 8] = np.nan
        p[i, 9] = float(n - i)
        p[i, 10] = float(i) if per_ns else 0.0
    return p


def _paged_inputs(pool, hw: int, bucket: int, step: int, W: int):
    """Operands of one B1 launch of W lanes, each one granule over one
    page of the null slot (real gather work over NaN)."""
    from ..ops.paged import PARAMS_W
    dev = pool.device
    p16 = np.zeros((W, PARAMS_W), np.float32)
    p16[:, :11] = _params(1, bucket, bucket)
    p16[:, 13] = pool.page_rows
    p16[:, 14] = pool.page_cols
    p16[:, 15] = 1.0
    ctrl = torch.from_numpy(_ctrl_grid(hw, hw, bucket, bucket, step))
    return (torch.zeros((W, 1, 1), dtype=torch.int32, device=dev),
            torch.from_numpy(p16).to(dev),
            ctrl.expand(W, *ctrl.shape).contiguous().to(dev),
            torch.zeros((W, 3), dtype=torch.float32))


def prewarm(configs: Dict, executor, sizes: Optional[List[int]] = None,
            bucket: Optional[int] = None) -> Dict:
    """Build, load and launch what the configured layers' requests will
    run, on ``executor``'s device and page pool.  Returns {"specs",
    "programs" (launches), "mesh_programs", "expr_programs", "blocks"
    (the planned tiles' launches, by tile), "failures", "compiles",
    "seconds"}; a failed launch is logged and counted, not raised."""
    from ..ops import first_valid, stats, warp_render
    from ..ops.paged import render_byte_paged, render_expr_paged
    from ..ops.warp_render import render_scenes
    from ..pipeline.autoplan import plan_block
    t0 = time.perf_counter()
    c0 = compile_count()
    sizes = sizes or _env_list("GSKY_PREWARM_SIZES", "256")
    bucket = bucket or int(os.environ.get("GSKY_PREWARM_BUCKET", 512))
    step = 16
    dev = executor.device
    pool = executor.pool
    if dev.type == "cuda":
        libs = [warp_render.LIBRARY, stats.LIBRARY, first_valid.LIBRARY]
        cuda_lib.build_all(libs)
        for lib in libs:
            lib.load()
    with pool.locked_pool():
        pass                        # allocates the pool tensor
    specs = layer_specs(configs)
    expr_specs = layer_expr_specs(configs)
    waves = wave_size_lattice()
    programs = failures = expr_programs = 0
    blocks: Dict[str, int] = {}
    pr, pc = pool.page_rows, pool.page_cols

    def run(fn, *args, blk=None):
        nonlocal programs, failures
        try:
            fn(*args, blk=blk)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            programs += 1
            if blk is not None:
                tile = f"{blk[0]}x{blk[1]}"
                blocks[tile] = blocks.get(tile, 0) + 1
        except Exception as e:   # noqa: BLE001 - counted and logged
            failures += 1
            log.warning("prewarm %s: %s", getattr(fn, "__name__", fn), e)

    def planned(fn, blk, *args):
        # the block axis: the point's planned tile, when it has one
        if blk is not None:
            run(fn, *args, blk=blk)

    scene = [torch.full((bucket, bucket), float("nan"),
                        dtype=torch.float32, device=dev)]
    params = torch.from_numpy(_params(1, bucket, bucket)).to(dev)
    for method, _n, auto, cs in sorted(specs):
        for hw in sizes:
            ctrl = torch.from_numpy(
                _ctrl_grid(hw, hw, bucket, bucket, step)).to(dev)
            b2 = (scene, ctrl, params, torch.zeros(3, dtype=torch.float32),
                  method, 1, (hw, hw), step, auto, cs)
            run(render_scenes, *b2)
            planned(render_scenes, plan_block(hw, hw, 1, method, T=1, S=0,
                                              win=(bucket, bucket)), *b2)
            for W in waves:
                blk = plan_block(hw, hw, 1, method, T=1, S=1, pr=pr, pc=pc,
                                 N=W)
                with pool.locked_pool() as parr:
                    b1 = (parr, *_paged_inputs(pool, hw, bucket, step, W),
                          method, 1, (hw, hw), step, auto, cs)
                    run(render_byte_paged, *b1)
                    planned(render_byte_paged, blk, *b1)
    for method, auto, cs, fp in expr_specs:
        n_ns = 1
        while n_ns < fp.n_slots:
            n_ns *= 2
        for hw in sizes:
            for W in waves:
                consts = torch.from_numpy(
                    np.tile(fp.const_array(), (W, 1))).to(dev)
                blk = plan_block(hw, hw, n_ns, method, T=1, S=1, pr=pr,
                                 pc=pc, N=W)
                before = programs
                with pool.locked_pool() as parr:
                    b1 = (parr, *_paged_inputs(pool, hw, bucket, step, W),
                          consts, method, n_ns, (hw, hw), step, auto, cs,
                          fp.key)
                    run(render_expr_paged, *b1)
                    planned(render_expr_paged, blk, *b1)
                expr_programs += programs - before
    mesh_programs = 0
    # the mesh layouts' axis: with mesh serving on (GSKY_MESH), the same
    # (method, tile edge, wave size) lattice launches the granule waves
    # and the time layout's drills on every member, so that the first
    # mesh wave after a start meets no first launch
    from ..mesh.dispatch import default_mesh
    md = default_mesh(dev)
    if md is not None:
        try:
            mesh_programs = md.prewarm_programs(pool, specs, sizes, waves,
                                                step, bucket)
            programs += mesh_programs
        except Exception as e:   # noqa: BLE001 - counted and logged
            failures += 1
            log.warning("prewarm mesh lattice: %s", e)
    out = {"specs": len(specs), "programs": programs,
           "mesh_programs": mesh_programs,
           "expr_programs": expr_programs, "blocks": blocks,
           "failures": failures,
           "compiles": compile_count() - c0,
           "seconds": round(time.perf_counter() - t0, 3)}
    log.info("prewarm: %s", out)
    return out


def prewarm_from_watcher(watcher, executor) -> Optional[Dict]:
    """The command line's hook: prewarm the configured layers on the
    serving executor before the server listens; None when
    ``GSKY_PREWARM=0``.  A build that fails raises: a server without
    its kernels must not come up."""
    if not prewarm_enabled():
        return None
    return prewarm(watcher.configs, executor)
