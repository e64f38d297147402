"""Sharded render and drill steps over a (granule, x) device mesh.

Counterpart of `gsky_tpu/parallel/render.py`: the reference-shaped
steps over explicit source windows and dense coordinate grids.  Member
(g, x) takes granule shard g and width strip x; its body is plain torch,
as the reference's is XLA outside any Pallas kernel: the batched gather
warp (`ops.warp.warp_gather_batch`), a local newest-wins mosaic, then
the combine across the granule axis (`all_gather` and a priority pick,
or the ring: G - 1 peer hand-offs in ring order, each member keeping
the lower shard rank), the expression hook, and the auto min-max byte
scale with the extrema taken by `pmin` / `pmax` over the strips.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.scale import _masked_extrema, auto_byte_scale
from ..ops.warp import warp_gather_batch
from .mesh import (AXIS_GRANULE, AXIS_X, Mesh, all_gather, pmax, pmin,
                   psum, run_members)


def _combine_priority(partials, pvalids):
    """Combine per-shard mosaic partials (G, ..., H, W) in shard order:
    shard 0 holds the newest granules, so the first valid shard wins."""
    idx = torch.argmax(pvalids.to(torch.uint8), dim=0)
    out = torch.gather(partials, 0, idx[None])[0]
    return out, pvalids.any(dim=0)


def _combine_priority_ring(parts, poks, devices):
    """Ring-reduce G shard partials instead of gathering them: each
    member keeps one candidate and the shard rank of its contribution
    per pixel, and in G - 1 hand-offs (member g receives member g - 1's
    candidate, on member g's device) keeps the lower rank, the newer
    granule.  Returns each member's (data, ok), all alike."""
    G = len(parts)
    inf = float("inf")
    ranks = [torch.where(pok, torch.full_like(pok, g, dtype=torch.float32),
                         torch.full_like(pok, inf, dtype=torch.float32))
             for g, pok in enumerate(poks)]
    data, best = list(parts), list(ranks)
    cand_d, cand_r = list(parts), list(ranks)
    for _ in range(G - 1):
        cand_d = [cand_d[(g - 1) % G].to(devices[g]) for g in range(G)]
        cand_r = [cand_r[(g - 1) % G].to(devices[g]) for g in range(G)]
        for g in range(G):
            take = cand_r[g] < best[g]
            data[g] = torch.where(take, cand_d[g], data[g])
            best[g] = torch.where(take, cand_r[g], best[g])
    return [(d, b < inf) for d, b in zip(data, best)]


def _first_ns(bands, valids):
    return bands[0], valids[0]


def make_sharded_render(mesh: Mesh, method: str = "near",
                        expr: Optional[Callable] = None,
                        combine: str = "gather") -> Callable:
    """A sharded render step ``step(src, valid, rows, cols, lut) ->
    rgba`` over src (T, NS, H, W) f32 source windows in priority order,
    valid (T, NS, H, W) bool, rows / cols (T, h, w) f32 fractional
    source coordinates, lut (256, 4) uint8; rgba (h, w, 4) uint8 on the
    mesh's first member.  T must divide by the granule axis and w by
    the x axis.  ``expr(bands, valids) -> (data, ok)`` reduces the NS
    canvases (default: the first).  ``combine``: "gather" or "ring"."""
    if combine not in ("gather", "ring"):
        raise ValueError(f"combine must be 'gather' or 'ring': {combine}")
    expr = expr or _first_ns
    ng, nx = mesh.shape[AXIS_GRANULE], mesh.shape[AXIS_X]

    def step(src, valid, rows, cols, lut):
        src, valid, rows, cols, lut = (torch.as_tensor(np.asarray(a))
                                       if not torch.is_tensor(a) else a
                                       for a in (src, valid, rows, cols,
                                                 lut))
        T, NS = src.shape[:2]
        h, w = rows.shape[1:]
        if T % ng or w % nx:
            raise ValueError(f"T={T} and w={w} must divide the mesh "
                             f"{mesh.shape}")
        Tl, wl = T // ng, w // nx

        def local(i, dev):
            g, x = divmod(i, nx)
            sl = slice(g * Tl, (g + 1) * Tl)
            cs = slice(x * wl, (x + 1) * wl)
            s = src[sl].to(dev)
            v = valid[sl].to(dev)
            r = rows[sl, :, cs].to(dev)
            c = cols[sl, :, cs].to(dev)
            out, ok = warp_gather_batch(
                s.reshape(Tl * NS, *s.shape[2:]),
                v.reshape(Tl * NS, *v.shape[2:]),
                r.repeat_interleave(NS, 0), c.repeat_interleave(NS, 0),
                method)
            out = out.reshape(Tl, NS, h, wl)
            ok = ok.reshape(Tl, NS, h, wl)
            # the shard's own newest-wins mosaic
            idx = torch.argmax(ok.to(torch.uint8), dim=0)
            return torch.gather(out, 0, idx[None])[0], ok.any(dim=0)

        parts, events = run_members(mesh, local)
        canv = []
        for x in range(nx):
            col = [g * nx + x for g in range(ng)]
            dev = mesh.members[col[0]]
            if combine == "ring":
                ring = _combine_priority_ring(
                    [parts[i][0] for i in col], [parts[i][1] for i in col],
                    [mesh.members[i] for i in col])
                canv.append(ring[0])
            else:
                evs = [events[i] for i in col]
                canv.append(_combine_priority(
                    all_gather([parts[i][0] for i in col], dev, evs),
                    all_gather([parts[i][1] for i in col], dev, evs)))
        strips = [expr(c, ok) for c, ok in canv]
        out_dev = mesh.out_device
        ext = [_masked_extrema(d, ok) for d, ok in strips]
        mn = pmin([e[0] for e in ext], out_dev)
        mx = pmax([e[1] for e in ext], out_dev)
        anyv = pmax([ok.any().to(torch.int32) for _, ok in strips],
                    out_dev) > 0
        lut = lut.to(out_dev)
        rgba = [lut[auto_byte_scale(d.to(out_dev), ok.to(out_dev), mn, mx,
                                    anyv).long()]
                for d, ok in strips]
        return torch.cat(rgba, dim=1)

    return step


def make_sharded_render_padded(mesh: Mesh, method: str = "near",
                               expr: Optional[Callable] = None,
                               combine: str = "gather") -> Callable:
    """`make_sharded_render` for any granule count and width: the
    granule axis pads with invalid layers (their coordinates far
    outside, their validity False), the width pads with far-outside
    coordinates, and the output is cropped back."""
    step = make_sharded_render(mesh, method, expr, combine)
    ng, nx = mesh.shape[AXIS_GRANULE], mesh.shape[AXIS_X]

    def padded(src, valid, rows, cols, lut):
        src, valid, rows, cols = (torch.as_tensor(np.asarray(a))
                                  if not torch.is_tensor(a) else a
                                  for a in (src, valid, rows, cols))
        T, w = src.shape[0], rows.shape[-1]
        Tp, wp = -(-T // ng) * ng, -(-w // nx) * nx
        if Tp != T:
            src = torch.cat([src, src.new_zeros((Tp - T,) + src.shape[1:])])
            valid = torch.cat([valid, valid.new_zeros(
                (Tp - T,) + valid.shape[1:])])
            far = rows.new_full((Tp - T,) + rows.shape[1:], -1e6)
            rows, cols = torch.cat([rows, far]), torch.cat([cols, far])
        if wp != w:
            far = rows.new_full(rows.shape[:-1] + (wp - w,), -1e6)
            rows = torch.cat([rows, far], dim=-1)
            cols = torch.cat([cols, far], dim=-1)
        out = step(src, valid, rows, cols, lut)
        return out[:, :w] if wp != w else out

    return padded


def make_sharded_drill(mesh: Mesh) -> Callable:
    """A sharded drill step ``step(data, valid, mask) -> (means,
    counts)``: per-timestep masked means over a polygon mask, data (T,
    H, W) f32 and valid (T, H, W) bool sharded T over granule and W over
    x, mask (H, W) bool; the strips' pixel sums and counts reduced by
    `psum` over x.  means (T,) f32 (NaN where empty), counts (T,) f32."""
    ng, nx = mesh.shape[AXIS_GRANULE], mesh.shape[AXIS_X]

    def step(data, valid, mask):
        data, valid, mask = (torch.as_tensor(np.asarray(a))
                             if not torch.is_tensor(a) else a
                             for a in (data, valid, mask))
        T, _, W = data.shape
        if T % ng or W % nx:
            raise ValueError(f"T={T} and W={W} must divide the mesh "
                             f"{mesh.shape}")
        Tl, Wl = T // ng, W // nx

        def local(i, dev):
            g, x = divmod(i, nx)
            sl, cs = slice(g * Tl, (g + 1) * Tl), slice(x * Wl, (x + 1) * Wl)
            m = valid[sl, :, cs].to(dev) & mask[:, cs].to(dev)[None]
            d = data[sl, :, cs].to(dev)
            return (m.sum(dim=(1, 2)).to(torch.float32),
                    torch.where(m, d, 0.0).sum(dim=(1, 2)))

        parts, events = run_members(mesh, local)
        means, counts = [], []
        for g in range(ng):
            row = [g * nx + x for x in range(nx)]
            dev = mesh.members[row[0]]
            evs = [events[i] for i in row]
            cnt = psum([parts[i][0] for i in row], dev, evs)
            tot = psum([parts[i][1] for i in row], dev, evs)
            means.append(torch.where(cnt > 0, tot / cnt.clamp_min(1.0),
                                     torch.full_like(tot, float("nan"))))
            counts.append(cnt)
        out = mesh.out_device
        return (torch.cat([m.to(out) for m in means]),
                torch.cat([c.to(out) for c in counts]))

    return step
