"""Wave planner: shared-window superblocks, the ragged-vs-bucketed
route of a wave group, and the output tile of kernels B1 and B2.

Counterpart of `gsky_tpu/pipeline/autoplan.py`.  A wave group's lanes
whose granule lists match (same params[:11], same scene serials) and
whose page rects overlap, or lie within ``GSKY_PLAN_HALO_MAX`` pages of
each other, merge into superblocks: each superblock's union page rect
becomes one table row, so the per-lane tables (N, T, S) compact to (G,
T, S_u), G <= N, and ``sb_of`` gives each lane its row (kernel B1 reads
the row in place).  The planner consumes the footprints the lanes carry
(params slots 11-15 and their pinned tables from
`executor._paged_from_group`); it never re-indexes.  Widening a lane's
window to its union changes no tap: the true-extent test runs before
the window rebase, every in-extent tap of a lane lies in its own
window, the rebase subtracts a whole number of pages, and uncovered
union positions read the null page.

`union_lane_spans` widens an expression lane's granule windows (one
per band of the same bbox) to their union, so that every row of the
lane's table has one shape and lanes of one fingerprint match row for
row.

The same byte estimate routes a group whose padded page tables would
list more bytes than its lanes' bucketed stacks to the bucketed leg
(B2 per lane).  The estimate is the reference's, with its pow2 lane
count ``Np`` and, for the bucketed leg, each lane's dense stack as its
unwindowed program reads it (the port has no gather window, ROADMAP
A.4), so both packages route a group alike.

`plan_sharded` is the mesh's variant (`mesh.dispatch`, the ``granule``
layout): each member's slice of lanes is planned alone, so that no
superblock crosses a member, and ``sb_of`` indexes the member's own
rows.

`plan_block` is the card's cost model for a launch's output tile
(rows, cols) of B1 (``S > 0``) or B2 (``S == 0``), with the reference's
signature, key (plus the lane count ``N``: on the card a wave's lanes
are blocks that run at once, not steps of a TPU's sequential grid) and
contract.  It scores each tile of the ladder (`plan_blocks`,
``GSKY_PLAN_BLOCKS``, which names CUDA tiles here) by the time the
busiest SM takes (`_block_cost`; its constants fitted to a sweep on an
H100, PERF.md), returns None when the default 8 x 32 wins, memoises
each choice in the process (keyed with the ladder) and counts each
decision in ``gsky_plan_block_shape``.  The reference also persists its
choices in its kernel ledger and replays them into a later process
whatever that process's ladder (`_seed_from_ledger`); the port's model
is deterministic and keeps no ledger (ROADMAP C.20).

The merge gate keeps the reference's VMEM formula at the Pallas block
the reference's own cost model picks for the group (`_gate_block`, over
its default ladder), so that the port merges exactly the lanes the
reference merges; the launch takes the card's tile.

``GSKY_PLAN=0`` turns the planner off: no superblocks, no route
change, no planned tile.  A planner error raises: there is no
unplanned fallback to hide it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..obs.metrics import (PLAN_BLOCK_SHAPE, PLAN_BYTES_SAVED,
                           PLAN_ROUTE, PLAN_SUPERBLOCKS)
from ..ops.paged import (GATE_BLOCK, PARAMS_W, STAGE_BUDGET, page_slots,
                         paged_vmem_ok)
from ..ops.warp_render import DEFAULT_TILE, tile_ok
from .pages import union_table


def plan_enabled() -> bool:
    """GSKY_PLAN=0 turns the planner off (default on)."""
    return os.environ.get("GSKY_PLAN", "1") != "0"


def plan_halo_max() -> int:
    """Largest page gap two windows may leave between them and still
    merge (GSKY_PLAN_HALO_MAX, default 2, clamped to 0..16)."""
    try:
        v = int(os.environ.get("GSKY_PLAN_HALO_MAX", "2"))
    except ValueError:
        v = 2
    return max(0, min(16, v))


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# the output tile of B1 and B2: the card's cost model
# ---------------------------------------------------------------------------

# the default ladder, (rows, cols): 8 x 32 first, so that a tie keeps the
# default tile
_DEF_BLOCKS = ((8, 32), (4, 32), (2, 64), (4, 64), (1, 256))
_TAPS = {"near": 1, "nearest": 1, "bilinear": 4, "cubic": 16}
# source pixels a pixel's taps reach past its own, along each axis
_SPAN = {"near": 0, "nearest": 0, "bilinear": 1, "cubic": 3}

# the card, an H100 SXM: its SMs, and what one SM holds
SMS = 132
SM_THREADS = 2048
SM_BLOCKS = 32
SM_SMEM = 233472            # bytes of shared memory an SM gives blocks
BLOCK_SMEM_RESERVED = 1024  # the system's share of it, a block
SM_REGS = 65536
REG_UNIT = 256              # registers are given a warp in these units
# per kernel: its shared memory a block (csrc/warp_render.cu: B1's stage
# and its round of params rows, tables, per-warp boxes and plan; B2's
# params rows and scene pointers); its registers a thread by method
# (nvcc -Xptxas -v on sm_90a, one namespace; B1's instance for any
# tile); and the constants of `_block_cost` in us, a least-squares fit
# to an H100 sweep (`tools/tile_sweep.py --fit`; PERF.md): the
# launch, a round of blocks on an SM, a warp's tap work, a staged
# 16-byte quad, a block
_KERNEL = {
    "b1": {"smem": STAGE_BUDGET + 4044,
           "regs": {"near": 48, "nearest": 48, "bilinear": 48, "cubic": 64},
           "cost": (6.74331, 2.34236, 0.00173, 0.00115, 0.0)},
    "b2": {"smem": 2304,
           "regs": {"near": 31, "nearest": 31, "bilinear": 34, "cubic": 40},
           "cost": (5.44905, 1.91483, 0.00375, 0.0, 0.01253)},
}
# a tile other than the default is taken only where the model puts it
# at most this share of the default's time: the fit's error is 10% rms
# (B1) and 5% (B2) of a launch
_MARGIN = 0.9


def plan_blocks():
    """The ladder of (rows, cols) tiles from GSKY_PLAN_BLOCKS ("8x32,
    4x64,..."): CUDA output tiles, each kept when B1 and B2 take it
    (`ops.warp_render.tile_ok`: the columns a multiple of 32, at most
    256 threads, the kernels' launch bound); malformed entries are
    dropped, and an empty result is the default ladder."""
    out = []
    for part in os.environ.get("GSKY_PLAN_BLOCKS", "").lower().split(","):
        try:
            r_s, c_s = part.strip().split("x")
            r, c = int(r_s), int(c_s)
        except ValueError:
            continue
        if tile_ok(r, c) and (r, c) not in out:
            out.append((r, c))
    return tuple(out) if out else _DEF_BLOCKS


def _occupancy(kernel: str, method: str, threads: int) -> int:
    """Blocks of ``threads`` one SM holds at once, by its threads,
    blocks, shared memory and registers."""
    k = _KERNEL[kernel]
    regs = k["regs"].get(str(method), max(k["regs"].values()))
    warp_regs = -(-regs * 32 // REG_UNIT) * REG_UNIT
    return max(1, min(SM_THREADS // threads, SM_BLOCKS,
                      SM_SMEM // (k["smem"] + BLOCK_SMEM_RESERVED),
                      SM_REGS // warp_regs // (threads // 32)))


def _features(kernel: str, h: int, w: int, T: int, method: str,
              rows: int, cols: int, N: int = 1):
    """What `_block_cost` weighs, for one launch of ``kernel`` ("b1" or
    "b2") over N lanes of (h, w) pixels and T granules at a (rows, cols)
    tile, on the busiest SM (the grid's blocks spread over the SMs): 1;
    its rounds of blocks (what it holds at once); its warps' tap work
    (every thread of its blocks, padding included: a granule's taps, and
    for B1 its box too); B1's staged 16-byte quads (a granule's box at a
    source pixel a pixel: the tile widened by the taps' reach, its
    columns in whole quads, one more where it straddles); its blocks."""
    threads = rows * cols
    blocks = max(1, N) * -(-h // rows) * -(-w // cols)
    per_sm = -(-blocks // SMS)
    rounds = -(-per_sm // _occupancy(kernel, method, threads))
    T = max(1, T)
    taps = _TAPS.get(str(method), 4)
    span = _SPAN.get(str(method), 1)
    if kernel == "b1":
        quads = (rows + span) * (-(-(cols + span) // 4) + 1)
        work = taps + 2
    else:
        quads, work = 0, taps
    return (1.0, rounds, per_sm * threads / 32 * T * work,
            per_sm * T * quads, per_sm)


def _block_cost(kernel: str, h: int, w: int, T: int, method: str,
                rows: int, cols: int, N: int = 1) -> float:
    """Modelled device time (us) of one launch of ``kernel`` at a (rows,
    cols) tile: `_features` weighed by the kernel's fitted constants."""
    return sum(c * f for c, f in zip(
        _KERNEL[kernel]["cost"],
        _features(kernel, h, w, T, method, rows, cols, N)))


_LOCK = threading.Lock()
_COSTED: Dict[tuple, tuple] = {}    # (key, ladder) -> the tile chosen
_ROUTES0 = {"ragged": 0, "bucketed": 0}
_STATS = {"superblocks": 0, "merged_lanes": 0, "bytes_saved": 0,
          "routes": dict(_ROUTES0), "groups_planned": 0,
          "assembly_planned": 0}


class Plan:
    """One wave group's plan.  ``route`` is ``"superblock"`` (dispatch
    ``tables`` (Gp, T, S_u) int32, ``params`` (Np*T, 16) f32 with each
    lane's window slots rewritten to its superblock's union, ``sb_of``
    (Np,) int32), ``"bucketed"`` (the group's bucketed leg) or
    ``"ragged"`` (the lanes' own tables).  ``blk``: B1's output tile
    (rows, cols), None for the default."""

    __slots__ = ("route", "blk", "tables", "params", "sb_of",
                 "superblocks", "naive_bytes", "planned_bytes",
                 "bucketed_bytes", "merged_lanes")

    def __init__(self, route, blk=None, tables=None, params=None,
                 sb_of=None, superblocks=0, naive_bytes=0, planned_bytes=0,
                 bucketed_bytes=None, merged_lanes=0):
        self.route = route
        self.blk = blk
        self.tables = tables
        self.params = params
        self.sb_of = sb_of
        self.superblocks = superblocks
        self.naive_bytes = naive_bytes
        self.planned_bytes = planned_bytes
        self.bucketed_bytes = bucketed_bytes
        self.merged_lanes = merged_lanes


def plan_block(h: int, w: int, n_ns: int, method: str, T: int = 1,
               S: int = 0, pr: int = 0, pc: int = 0, win=None, N: int = 1):
    """The output tile (rows, cols) of a launch of B1 (``S > 0``: T
    granules over S-slot page tables of (pr, pc) pages) or B2 (``S ==
    0``: T scenes of extent ``win``) over N lanes of (h, w) pixels with
    ``n_ns`` namespaces: the ladder's cheapest by `_block_cost`, the
    default 8 x 32 unless another is at most `_MARGIN` of its time.
    None when the default wins or the planner is off.  Each choice is
    memoised in the process and each decision counted in
    ``gsky_plan_block_shape{shape}``."""
    if not plan_enabled():
        return None
    key = (int(h), int(w), int(n_ns), str(method), int(T), int(S),
           int(pr), int(pc),
           None if win is None else (int(win[0]), int(win[1])), int(N))
    ladder = plan_blocks()
    with _LOCK:
        got = _COSTED.get((key, ladder))
    if got is None:
        kernel = "b1" if S > 0 else "b2"
        costs = {b: _block_cost(kernel, int(h), int(w), int(T),
                                str(method), b[0], b[1], int(N))
                 for b in ladder}
        best = min(ladder, key=lambda b: costs[b])
        if DEFAULT_TILE in costs and \
                costs[best] > _MARGIN * costs[DEFAULT_TILE]:
            best = DEFAULT_TILE
        with _LOCK:
            got = _COSTED.setdefault((key, ladder), best)
    PLAN_BLOCK_SHAPE.labels(shape=f"{got[0]}x{got[1]}").inc()
    return None if got == DEFAULT_TILE else got


def scenes_block(scenes, method: str, n_ns: int, out_hw):
    """B2's output tile over ``scenes`` (B (WR, WC) tensors or a (B, WR,
    WC) stack) for an ``out_hw`` output: `plan_block` with ``S = 0`` and
    the scenes' extent as the window, as the reference's `_plan_blk`
    plans its bucketed leg."""
    wr, wc = scenes[0].shape[-2:]
    return plan_block(int(out_hw[0]), int(out_hw[1]), int(n_ns),
                      str(method), T=len(scenes), S=0,
                      win=(int(wr), int(wc)))


# the reference's Pallas block ladder and per-grid-step overhead (its
# `_DEF_BLOCKS`, `_STEP_OVERHEAD`), for the merge gate alone
_REF_BLOCKS = ((128, 128), (256, 128), (128, 256), (256, 256), (64, 128))
_REF_STEP_OVERHEAD = 4096


def _gate_block(h: int, w: int, n_ns: int, method: str, T: int, S: int,
                pr: int, pc: int):
    """The Pallas block (bh, bw) the reference's `plan_block` picks for a
    paged group over its default ladder (None: 128 x 128), the block its
    merge gate (`paged_vmem_ok`) is held at: each block that fits VMEM
    with S slots, scored by padded compute plus a per-step overhead,
    ties to the first."""
    taps = _TAPS.get(str(method), 4)
    best, best_cost = None, None
    for bh, bw in _REF_BLOCKS:
        if not paged_vmem_ok(S, n_ns, pr, pc, (bh, bw)):
            continue
        hp, wp = -(-h // bh) * bh, -(-w // bw) * bw
        steps = (hp // bh) * (wp // bw) * max(1, T)
        cost = hp * wp * max(1, T) * taps + steps * _REF_STEP_OVERHEAD
        if best_cost is None or cost < best_cost:
            best, best_cost = (bh, bw), cost
    return None if best in (None, (GATE_BLOCK, GATE_BLOCK)) else best


def _entry_rows(e, pr: int, pc: int):
    """Per granule of one lane: (page rect (i0, i1, j0, j1), slot row),
    the rect from params slots 11-14 (page-aligned by construction), the
    slots from the lane's pinned table."""
    p16 = np.asarray(e.payload["params16"], np.float32)
    tb = np.asarray(e.payload["tables"], np.int32)
    rows = []
    for t in range(p16.shape[0]):
        i0 = int(round(float(p16[t, 11]) / pr))
        j0 = int(round(float(p16[t, 12]) / pc))
        ni = max(1, int(round(float(p16[t, 13]) / pr)))
        nj = max(1, int(round(float(p16[t, 14]) / pc)))
        rows.append(((i0, i0 + ni - 1, j0, j0 + nj - 1),
                     tb[t, :ni * nj]))
    return rows


def _rect_union(u, r, halo: int):
    """The union of two page rects that overlap or lie within ``halo``
    pages of each other on both axes, else None."""
    gi = max(u[0], r[0]) - min(u[1], r[1]) - 1
    gj = max(u[2], r[2]) - min(u[3], r[3]) - 1
    if gi > halo or gj > halo:
        return None
    return (min(u[0], r[0]), max(u[1], r[1]),
            min(u[2], r[2]), max(u[3], r[3]))


def _merge_cluster(idxs: List[int], rows, halo: int, slot_cap: int,
                   vmem_ok):
    """Greedy superblocks in one cluster: lanes by origin, each into the
    first superblock whose per-granule unions stay within the halo, the
    page-slot cap and the gate.  [(member idxs, union rect a granule)]."""
    order = sorted(idxs, key=lambda i: (rows[i][0][0][0],
                                        rows[i][0][0][2]))
    sbs: List[list] = []
    for i in order:
        rects_i = [r for r, _s in rows[i]]
        placed = False
        for sb in sbs:
            if len(sb[1]) != len(rects_i):
                continue
            cand = []
            for u, r in zip(sb[1], rects_i):
                nu = _rect_union(u, r, halo)
                if nu is None or ((nu[1] - nu[0] + 1)
                                  * (nu[3] - nu[2] + 1)) > slot_cap:
                    cand = None
                    break
                cand.append(nu)
            if cand is None:
                continue
            if not vmem_ok(max((u[1] - u[0] + 1) * (u[3] - u[2] + 1)
                               for u in cand)):
                continue
            sb[0].append(i)
            sb[1] = cand
            placed = True
            break
        if not placed:
            sbs.append([[i], rects_i])
    return sbs


def _cluster_and_merge(es, rows, n_ns: int, pr: int, pc: int, gate):
    """Cluster lanes by granule signature (params[:11] and the lane's
    scene serials: two timesteps of one layer share every param but not
    their pixels) and merge each cluster; a merge must pass the
    reference's VMEM gate at its Pallas block ``gate`` (`_gate_block`)."""
    halo = plan_halo_max()
    slot_cap = page_slots()
    clusters: Dict[tuple, List[int]] = {}
    for i, e in enumerate(es):
        p16 = np.asarray(e.payload["params16"], np.float32)
        key = (p16.shape[0], p16[:, :11].tobytes(),
               e.payload.get("serials"))
        clusters.setdefault(key, []).append(i)
    sbs = []
    for idxs in clusters.values():
        sbs.extend(_merge_cluster(
            idxs, rows, halo, slot_cap,
            lambda npg: paged_vmem_ok(_pow2(npg), n_ns, pr, pc, gate)))
    return sbs


def _build_superblock_arrays(es, rows, sbs, T: int, Np: int, pr: int,
                             pc: int):
    """The compacted dispatch arrays: union tables (Gp, T, S_u), lane
    params with window slots 11-15 set to the lane's superblock union,
    and the lane -> superblock map."""
    G = len(sbs)
    Gp = _pow2(G)
    S_u = _pow2(max(
        (u[1] - u[0] + 1) * (u[3] - u[2] + 1)
        for _m, rects in sbs for u in rects))
    tables = np.zeros((Gp, T, S_u), np.int32)
    params = np.zeros((Np, T, PARAMS_W), np.float32)
    params[:, :, 10] = -1.0     # ns_id: padding rows gather nothing
    sb_of = np.zeros(Np, np.int32)
    for g, (members, rects) in enumerate(sbs):
        for t, u in enumerate(rects):
            mem = [(rows[i][t][1],) + rows[i][t][0] for i in members]
            u_slots = union_table(mem, *u)
            tables[g, t, :u_slots.shape[0]] = u_slots
        for i in members:
            sb_of[i] = g
            p16 = np.asarray(es[i].payload["params16"], np.float32)
            params[i, :p16.shape[0]] = p16
            for t, u in enumerate(rects):
                params[i, t, 11] = u[0] * pr
                params[i, t, 12] = u[2] * pc
                params[i, t, 13] = (u[1] - u[0] + 1) * pr
                params[i, t, 14] = (u[3] - u[2] + 1) * pc
                params[i, t, 15] = u[3] - u[2] + 1
    return tables, params, sb_of, G, Gp, S_u


def _bucketed_bytes(es) -> int:
    """Bytes the group's bucketed leg reads by the reference's estimate:
    each lane's dense (B, WR, WC) f32 stack (``payload["xla"].shape``:
    pow2 granules by the group's scene bucket)."""
    total = 0
    for e in es:
        B, WR, WC = e.payload["xla"].shape
        total += int(B) * int(WR) * int(WC) * 4
    return total


def _note_route(path: str):
    with _LOCK:
        _STATS["routes"][path] = _STATS["routes"].get(path, 0) + 1
        _STATS["groups_planned"] += 1
    PLAN_ROUTE.labels(path=path).inc()


def union_lane_spans(spans, cap: int, maxnpg: int):
    """One expression lane's per-granule page rects (i0, i1, j0, j1),
    None for padding or off-scene rows, merged to their union: (merged
    spans, its page count), or the spans unchanged when the union would
    exceed ``cap`` pages or the pow2 slot count of ``maxnpg``.  Every
    granule of a scene group has one bucket shape, so the union of
    clipped rects stays clipped."""
    live = [s for s in spans if s is not None]
    if len(live) < 2:
        return spans, maxnpg
    i0 = min(s[0] for s in live)
    i1 = max(s[1] for s in live)
    j0 = min(s[2] for s in live)
    j1 = max(s[3] for s in live)
    npg = (i1 - i0 + 1) * (j1 - j0 + 1)
    if npg > cap or _pow2(npg) != _pow2(maxnpg):
        return spans, maxnpg
    u = (i0, i1, j0, j1)
    return [u if s is not None else None for s in spans], npg


def plan_wave_group(kind: str, es, stage: str = "dispatch"
                    ) -> Optional[Plan]:
    """Plan one wave group of ``byte``, ``scored`` or ``expr`` lanes: a
    `Plan`, or None (planner off, another kind, or nothing to gain: the
    lanes' own tables go to B1 at the default tile).  ``stage=
    "assembly"`` counts plans made on the pipelined scheduler's assembly
    thread."""
    if not plan_enabled() or kind not in ("byte", "scored", "expr") \
            or not es:
        return None
    if stage == "assembly":
        with _LOCK:
            _STATS["assembly_planned"] += 1
    method, n_ns, out_hw = es[0].key[0][:3]
    n_ns = int(n_ns)
    pool = es[0].payload["pool"]
    pr, pc = int(pool.page_rows), int(pool.page_cols)
    N = len(es)
    Np = _pow2(N)
    T = max(e.payload["tables"].shape[0] for e in es)
    S_in = max(e.payload["tables"].shape[1] for e in es)
    naive = Np * T * S_in * pr * pc * 4
    h, w = int(out_hw[0]), int(out_hw[1])
    blk = plan_block(h, w, n_ns, str(method), T=T, S=S_in, pr=pr, pc=pc,
                     N=N)
    gate = _gate_block(h, w, n_ns, str(method), T, S_in, pr, pc)
    rows = [_entry_rows(e, pr, pc) for e in es]
    sbs = _cluster_and_merge(es, rows, n_ns, pr, pc, gate)
    planned = naive
    built = None
    if len(sbs) < N:
        tables, params, sb_of, G, Gp, S_u = \
            _build_superblock_arrays(es, rows, sbs, T, Np, pr, pc)
        planned = Gp * T * S_u * pr * pc * 4
        built = (tables, params, sb_of, G)
    bucketed = _bucketed_bytes(es)
    if bucketed < min(naive, planned):
        _note_route("bucketed")
        return Plan("bucketed", blk=blk, naive_bytes=naive,
                    planned_bytes=planned, bucketed_bytes=bucketed)
    _note_route("ragged")
    if built is None or planned >= naive:
        if blk is None:
            return None
        return Plan("ragged", blk=blk, naive_bytes=naive,
                    planned_bytes=naive, bucketed_bytes=bucketed)
    tables, params, sb_of, G = built
    with _LOCK:
        _STATS["superblocks"] += G
        _STATS["merged_lanes"] += N - G
        _STATS["bytes_saved"] += naive - planned
    PLAN_SUPERBLOCKS.inc(float(G))
    PLAN_BYTES_SAVED.inc(float(naive - planned))
    return Plan("superblock", blk=blk, tables=tables,
                params=params.reshape(Np * T, PARAMS_W), sb_of=sb_of,
                superblocks=G, naive_bytes=naive, planned_bytes=planned,
                bucketed_bytes=bucketed, merged_lanes=N - G)


def plan_sharded(kind: str, es, n_chips: int, Np: int) -> Optional[Plan]:
    """The mesh variant of `plan_wave_group`: member c owns lanes
    [c * rpc, (c + 1) * rpc), rpc = Np / n_chips, and its slice is
    planned alone, so that no superblock (and no halo) crosses a member.
    The members' superblock counts pad to one Gc, their tables
    concatenate to (n_chips * Gc, T, S_u), and ``sb_of`` (Np,) holds
    member-local rows; params are (Np, T, 16), lanes in order; ``blk``
    is B1's tile for a member's launch of rpc lanes.  None when the
    planner is off or no member merges anything (the unplanned split
    runs at the default tile, as the reference's does)."""
    if not plan_enabled() or kind not in ("byte", "scored", "expr") \
            or not es:
        return None
    method, n_ns, out_hw = es[0].key[0][:3]
    n_ns = int(n_ns)
    pool = es[0].payload["pool"]
    pr, pc = int(pool.page_rows), int(pool.page_cols)
    N = len(es)
    rpc = max(1, Np // max(1, n_chips))
    T = max(e.payload["tables"].shape[0] for e in es)
    S_in = max(e.payload["tables"].shape[1] for e in es)
    naive = Np * T * S_in * pr * pc * 4
    h, w = int(out_hw[0]), int(out_hw[1])
    blk = plan_block(h, w, n_ns, str(method), T=T, S=S_in, pr=pr, pc=pc,
                     N=rpc)
    gate = _gate_block(h, w, n_ns, str(method), T, S_in, pr, pc)
    rows = [_entry_rows(e, pr, pc) for e in es]
    chip_sbs = []
    merged_any = False
    for c in range(n_chips):
        sub = list(range(c * rpc, min(N, (c + 1) * rpc)))
        if not sub:
            chip_sbs.append([])
            continue
        sbs = _cluster_and_merge([es[i] for i in sub],
                                 [rows[i] for i in sub], n_ns, pr, pc,
                                 gate)
        # member indices back to the group's lane numbers
        sbs = [[[sub[m] for m in members], rects] for members, rects in sbs]
        merged_any |= len(sbs) < len(sub)
        chip_sbs.append(sbs)
    if not merged_any:
        return None
    Gc = _pow2(max(1, max(len(s) for s in chip_sbs)))
    S_u = _pow2(max((u[1] - u[0] + 1) * (u[3] - u[2] + 1)
                    for sbs in chip_sbs for _m, rects in sbs
                    for u in rects))
    tables = np.zeros((n_chips * Gc, T, S_u), np.int32)
    params = np.zeros((Np, T, PARAMS_W), np.float32)
    params[:, :, 10] = -1.0
    sb_of = np.zeros(Np, np.int32)
    total = 0
    for c, sbs in enumerate(chip_sbs):
        total += len(sbs)
        for g, (members, rects) in enumerate(sbs):
            for t, u in enumerate(rects):
                mem = [(rows[i][t][1],) + rows[i][t][0] for i in members]
                u_slots = union_table(mem, *u)
                tables[c * Gc + g, t, :u_slots.shape[0]] = u_slots
            for i in members:
                sb_of[i] = g                    # member-local row
                p16 = np.asarray(es[i].payload["params16"], np.float32)
                params[i, :p16.shape[0]] = p16
                for t, u in enumerate(rects):
                    params[i, t, 11] = u[0] * pr
                    params[i, t, 12] = u[2] * pc
                    params[i, t, 13] = (u[1] - u[0] + 1) * pr
                    params[i, t, 14] = (u[3] - u[2] + 1) * pc
                    params[i, t, 15] = u[3] - u[2] + 1
    planned = n_chips * Gc * T * S_u * pr * pc * 4
    if planned >= naive:
        return None
    with _LOCK:
        _STATS["superblocks"] += total
        _STATS["merged_lanes"] += N - total
        _STATS["bytes_saved"] += naive - planned
    PLAN_SUPERBLOCKS.inc(float(total))
    PLAN_BYTES_SAVED.inc(float(naive - planned))
    _note_route("ragged")
    return Plan("superblock", blk=blk, tables=tables, params=params,
                sb_of=sb_of, superblocks=total, naive_bytes=naive,
                planned_bytes=planned, merged_lanes=N - total)


def plan_stats() -> Dict:
    """Knobs, the tile ladder, the tiles costed, route split and savings
    since `reset_plan_state`."""
    with _LOCK:
        return {"enabled": plan_enabled(),
                "halo_max": plan_halo_max(),
                "blocks": [f"{r}x{c}" for r, c in plan_blocks()],
                "costed_shapes": len(_COSTED),
                "superblocks": _STATS["superblocks"],
                "merged_lanes": _STATS["merged_lanes"],
                "gather_bytes_saved": _STATS["bytes_saved"],
                "groups_planned": _STATS["groups_planned"],
                "assembly_planned": _STATS["assembly_planned"],
                "routes": dict(_STATS["routes"])}


def reset_plan_state():
    """Drop the tile memo and zero the planner's counters."""
    with _LOCK:
        _COSTED.clear()
        _STATS.update({"superblocks": 0, "merged_lanes": 0,
                       "bytes_saved": 0, "groups_planned": 0,
                       "assembly_planned": 0, "routes": dict(_ROUTES0)})
