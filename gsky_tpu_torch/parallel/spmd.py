"""Sharded execution of the production fused render and drill kernels.

Counterpart of `gsky_tpu/parallel/spmd.py`.  `render.py` carries the
reference-shaped steps; this module shards the kernels the real
pipeline dispatches, so that the WCS export's wide blocks (the mesh's
``x`` layout, `mesh.dispatch`) and the ``GSKY_SPMD=1`` routes of the
executor and the drill run over every mesh member:

  * granule axis -> ``granule``: each member warps its shard of the
    priority-ordered granules through kernel B2
    (`ops.warp_render.warp_render_scored`, its plain version on CPU
    members), reading each scene where it lies after moving it to the
    member; the partial mosaics are gathered (`all_gather`) and the
    per-pixel priority winner taken (priorities are unique, so the
    winner is the single-member winner exactly);
  * output width -> ``x``: each member renders a column strip, its
    coordinates rebuilt from the control points
    (`ops.warp._bilerp_grid(x0=...)`, bit for bit the full grid's
    columns); the auto byte scale's extrema come from `pmin` / `pmax`
    over the strips (exact);
  * drill bands -> ``granule``, pixels -> ``x``: kernel B3
    (`ops.stats.masked_stats`) on each member's (bands, pixels) block,
    then a `psum` over x in member order (float32 reassociation: means
    within 1e-6 relative of the single-device sums, counts exact).

Padding, as the reference's: padded granules carry ns_id -1 (members
of no namespace; the first scene stands in as their pixels), pixels
past the true width get NaN coordinates, padded drill pixels are
invalid.  The sharded output equals the port's own single-member
output bit for bit, since the strip is the same emulated-FMA grid.

`spmd_enabled` is ``GSKY_SPMD=1`` with more than one mesh member;
`default_spmd` delegates to `mesh.dispatch.compat_spmd`, which owns the
one renderer.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.scale import _log10, _masked_extrema, auto_byte_scale, \
    scale_to_byte
from ..ops.stats import masked_stats as b3_masked_stats
from ..ops.warp import _bilerp_grid, params16
from ..ops.warp_render import scene_list, warp_render_scored
from .mesh import (AXIS_GRANULE, AXIS_X, Mesh, all_gather, make_mesh,
                   pmax, pmin, psum, run_members)


def spmd_enabled(device="cuda") -> bool:
    """GSKY_SPMD=1 and more than one mesh member for ``device``."""
    if os.environ.get("GSKY_SPMD", "0") != "1":
        return False
    from .mesh import mesh_devices
    return len(mesh_devices(device)) > 1


def _as_tensor(a, device):
    if torch.is_tensor(a):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class SpmdRenderer:
    """The sharded production entries over one mesh (see the module
    docstring)."""

    def __init__(self, mesh: Optional[Mesh] = None, device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.ng = self.mesh.shape[AXIS_GRANULE]
        self.nx = self.mesh.shape[AXIS_X]

    def _pad_inputs(self, scenes, params, out_w: int):
        """Pad the granules to a multiple of the granule axis (ns_id
        -1, true extent 1 x 1, the first scene as their pixels) and the
        width to a multiple of the x axis."""
        scenes = scene_list(scenes)
        p = params.detach().cpu().numpy() if torch.is_tensor(params) \
            else np.asarray(params)
        p = p[:len(scenes), :11].astype(np.float32)
        B = len(scenes)
        Bp = -(-B // self.ng) * self.ng
        if Bp != B:
            pad = np.zeros((Bp - B, 11), np.float32)
            pad[:, 10] = -1.0
            pad[:, 6:8] = 1.0
            p = np.concatenate([p, pad])
            scenes = scenes + [scenes[0]] * (Bp - B)
        wp = -(-out_w // self.nx) * self.nx
        return scenes, p, wp

    def _scored_strips(self, scenes, ctrl, params, method: str, n_ns: int,
                       out_hw: Tuple[int, int], step: int):
        """Each member's B2 over its granule shard and width strip, then
        the priority combine per strip: [(canv, best) (n_ns, h, wl)] in
        strip order, each on the strip's first member."""
        h, w_true = out_hw
        scenes, p, wp = self._pad_inputs(scenes, params, w_true)
        wl = wp // self.nx
        Bl = len(scenes) // self.ng
        nx = self.nx

        def local(i, dev):
            g, x = divmod(i, nx)
            x0 = x * wl
            c = _as_tensor(ctrl, dev)
            sx = _bilerp_grid(c[0], h, wl, step, x0=x0)
            sy = _bilerp_grid(c[1], h, wl, step, x0=x0)
            if x0 + wl > w_true:
                # pixels past the true width exist only as mesh padding
                xg = x0 + torch.arange(wl, device=dev)
                sx = torch.where(xg[None, :] < w_true, sx,
                                 torch.full_like(sx, float("nan")))
            shard = [s.to(dev).contiguous()
                     for s in scenes[g * Bl:(g + 1) * Bl]]
            prm = params16(torch.from_numpy(p[g * Bl:(g + 1) * Bl]).to(dev))
            return warp_render_scored(shard, sx.contiguous(),
                                      sy.contiguous(), prm, method, n_ns)

        parts, events = run_members(self.mesh, local)
        strips = []
        for x in range(nx):
            col = [g * nx + x for g in range(self.ng)]
            dev = self.mesh.members[col[0]]
            evs = [events[i] for i in col]
            canvs = all_gather([parts[i][0] for i in col], dev, evs)
            bests = all_gather([parts[i][1] for i in col], dev, evs)
            idx = torch.argmax(bests, dim=0)
            canv = torch.gather(canvs, 0, idx[None])[0]
            best = bests.amax(dim=0)
            strips.append((torch.where(best > float("-inf"), canv,
                                       torch.zeros_like(canv)), best))
        return strips, w_true

    def mosaic_scored(self, scenes, ctrl, params, method: str, n_ns: int,
                      out_hw: Tuple[int, int], step: int):
        """Sharded `ops.warp_render.warp_scenes_scored`: scenes (B
        tensors or a stack), ctrl (2, gh, gw), params (B, >= 11) ->
        (canvases (n_ns, h, w) f32, best (n_ns, h, w) f32, -inf where
        no granule is valid), on the mesh's first member."""
        strips, w = self._scored_strips(scenes, ctrl, params, method, n_ns,
                                        out_hw, step)
        out = self.mesh.out_device
        canv = torch.cat([c.to(out) for c, _ in strips], dim=-1)
        best = torch.cat([b.to(out) for _, b in strips], dim=-1)
        return canv[..., :w], best[..., :w]

    def render_composite(self, scenes, ctrl, params, scale_params,
                         method: str, n_ns: int, out_hw: Tuple[int, int],
                         step: int, auto: bool, colour_scale: int):
        """Sharded `ops.warp_render.render_scenes`: the PNG-ready uint8
        (h, w) tile, its auto extrema by `pmin` / `pmax` over the
        strips."""
        strips, w = self._scored_strips(scenes, ctrl, params, method, n_ns,
                                        out_hw, step)
        planes = []
        for canv, best in strips:
            vals = best > float("-inf")
            # first-valid composite across namespaces, as per call
            nidx = torch.argmax(vals.to(torch.uint8), dim=0)
            data = torch.gather(canv, 0, nidx[None])[0]
            ok = vals.any(dim=0)
            if auto and colour_scale == 1:
                logged = _log10(data)
                bad = ~torch.isfinite(logged)
                data = torch.where(bad, torch.zeros_like(logged), logged)
                ok = ok & ~bad
            planes.append((data, ok))
        out = self.mesh.out_device
        if auto:
            ext = [_masked_extrema(d, ok) for d, ok in planes]
            mn = pmin([e[0] for e in ext], out)
            mx = pmax([e[1] for e in ext], out)
            anyv = pmax([ok.any().to(torch.int32) for _, ok in planes],
                        out) > 0
            tiles = [auto_byte_scale(d.to(out), ok.to(out), mn, mx, anyv)
                     for d, ok in planes]
        else:
            sp = [float(v) for v in scale_params]
            tiles = [scale_to_byte(d.to(out), ok.to(out), sp[0], sp[1],
                                   sp[2], colour_scale=colour_scale,
                                   auto=False) for d, ok in planes]
        return torch.cat(tiles, dim=-1)[:, :w]

    def masked_stats(self, dataf, validf, clip_lower: float,
                     clip_upper: float, pixel_count: bool = False):
        """Sharded drill reductions over (B, N) window data: bands over
        ``granule``, pixels over ``x``; kernel B3 per member block, then
        a `psum` over x.  Returns (values (B,) f32, counts (B,) int32)
        on the mesh's first member, as the per-call reduction computes
        them (the mean or the pixel fraction in float64, rounded once)."""
        B, N = dataf.shape
        Bp = -(-B // self.ng) * self.ng
        Np = -(-N // self.nx) * self.nx
        if Bp != B or Np != N:
            # padded pixels are invalid: B3 and the count skip them
            dataf = torch.nn.functional.pad(dataf, (0, Np - N, 0, Bp - B))
            validf = torch.nn.functional.pad(validf.to(torch.uint8),
                                             (0, Np - N, 0, Bp - B))
        Bl, Nl = Bp // self.ng, Np // self.nx
        nx = self.nx

        def local(i, dev):
            g, x = divmod(i, nx)
            rs, cs = slice(g * Bl, (g + 1) * Bl), slice(x * Nl, (x + 1) * Nl)
            d = dataf[rs, cs].to(dev).contiguous()
            v = validf[rs, cs].to(dev).contiguous()
            s, c = b3_masked_stats(d, v, clip_lower, clip_upper)
            total = v.to(torch.bool).sum(dim=-1) if pixel_count else None
            return s, c, total

        parts, events = run_members(self.mesh, local)
        out = self.mesh.out_device
        vals, counts = [], []
        for g in range(self.ng):
            row = [g * nx + x for x in range(nx)]
            evs = [events[i] for i in row]
            c = psum([parts[i][1] for i in row], out, evs)
            if pixel_count:
                total = psum([parts[i][2] for i in row], out, evs)
                v = torch.where(total > 0, c.double()
                                / total.clamp_min(1).double(),
                                torch.zeros((), dtype=torch.float64,
                                            device=out))
                vals.append(v.to(torch.float32))
                counts.append(total.to(torch.int32))
            else:
                s = psum([parts[i][0] for i in row], out, evs)
                v = torch.where(c > 0, s.double()
                                / c.clamp_min(1).double(),
                                torch.zeros((), dtype=torch.float64,
                                            device=out))
                vals.append(v.to(torch.float32))
                counts.append(c.to(torch.int32))
        return torch.cat(vals)[:B], torch.cat(counts)[:B]


def default_spmd(device="cuda") -> Optional[SpmdRenderer]:
    """The process renderer when ``GSKY_SPMD`` routing is on, else None:
    an alias of `mesh.dispatch.compat_spmd`, whose dispatcher owns the
    one sharded code path."""
    from ..mesh.dispatch import compat_spmd
    return compat_spmd(device)
