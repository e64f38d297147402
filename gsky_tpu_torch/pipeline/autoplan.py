"""Wave planner: shared-window superblocks and the ragged-vs-bucketed
route of a wave group.

Counterpart of `gsky_tpu/pipeline/autoplan.py` (`plan_wave_group` and
what it calls).  A wave group's lanes whose granule lists match (same
params[:11], same scene serials) and whose page rects overlap, or lie
within ``GSKY_PLAN_HALO_MAX`` pages of each other, merge into
superblocks: each superblock's union page rect becomes one table row, so
the per-lane tables (N, T, S) compact to (G, T, S_u), G <= N, and
``sb_of`` gives each lane its row (kernel B1 reads the row in place).
The planner consumes the footprints the lanes carry (params slots 11-15
and their pinned tables from `executor._paged_from_group`); it never
re-indexes.  Widening a lane's window to its union changes no tap: the
true-extent test runs before the window rebase, every in-extent tap of a
lane lies in its own window, the rebase subtracts a whole number of
pages, and uncovered union positions read the null page.

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

``GSKY_PLAN=0`` turns the planner off: no superblocks, no route
change.  Not ported: `plan_block` (a Pallas output block chosen under
TPU VMEM; B1 has its own 8 x 32 block and staging budget, and the block
changes no output byte).  A planner error raises: there is no
unplanned fallback to hide it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..obs.metrics import PLAN_BYTES_SAVED, PLAN_ROUTE, PLAN_SUPERBLOCKS
from ..ops.paged import PARAMS_W, page_slots, paged_vmem_ok
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


_LOCK = threading.Lock()
_ROUTES0 = {"ragged": 0, "bucketed": 0}
_STATS = {"superblocks": 0, "merged_lanes": 0, "bytes_saved": 0,
          "routes": dict(_ROUTES0), "groups_planned": 0,
          "assembly_planned": 0}


class Plan:
    """One wave group's plan.  ``route`` is ``"superblock"`` (dispatch
    ``tables`` (Gp, T, S_u) int32, ``params`` (Np*T, 16) f32 with each
    lane's window slots rewritten to its superblock's union, ``sb_of``
    (Np,) int32) or ``"bucketed"`` (the group's bucketed leg)."""

    __slots__ = ("route", "tables", "params", "sb_of", "superblocks",
                 "naive_bytes", "planned_bytes", "bucketed_bytes",
                 "merged_lanes")

    def __init__(self, route, tables=None, params=None, sb_of=None,
                 superblocks=0, naive_bytes=0, planned_bytes=0,
                 bucketed_bytes=None, merged_lanes=0):
        self.route = route
        self.tables = tables
        self.params = params
        self.sb_of = sb_of
        self.superblocks = superblocks
        self.naive_bytes = naive_bytes
        self.planned_bytes = planned_bytes
        self.bucketed_bytes = bucketed_bytes
        self.merged_lanes = merged_lanes


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


def _cluster_and_merge(es, rows, n_ns: int, pr: int, pc: int):
    """Cluster lanes by granule signature (params[:11] and the lane's
    scene serials: two timesteps of one layer share every param but not
    their pixels) and merge each cluster."""
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
            lambda npg: paged_vmem_ok(_pow2(npg), n_ns, pr, pc)))
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
    lanes' own tables go to B1).  ``stage="assembly"`` counts plans made
    on the pipelined scheduler's assembly thread."""
    if not plan_enabled() or kind not in ("byte", "scored", "expr") \
            or not es:
        return None
    if stage == "assembly":
        with _LOCK:
            _STATS["assembly_planned"] += 1
    n_ns = int(es[0].key[0][1])
    pool = es[0].payload["pool"]
    pr, pc = int(pool.page_rows), int(pool.page_cols)
    N = len(es)
    Np = _pow2(N)
    T = max(e.payload["tables"].shape[0] for e in es)
    S_in = max(e.payload["tables"].shape[1] for e in es)
    naive = Np * T * S_in * pr * pc * 4
    rows = [_entry_rows(e, pr, pc) for e in es]
    sbs = _cluster_and_merge(es, rows, n_ns, pr, pc)
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
        return Plan("bucketed", naive_bytes=naive, planned_bytes=planned,
                    bucketed_bytes=bucketed)
    _note_route("ragged")
    if built is None or planned >= naive:
        return None
    tables, params, sb_of, G = built
    with _LOCK:
        _STATS["superblocks"] += G
        _STATS["merged_lanes"] += N - G
        _STATS["bytes_saved"] += naive - planned
    PLAN_SUPERBLOCKS.inc(float(G))
    PLAN_BYTES_SAVED.inc(float(naive - planned))
    return Plan("superblock", tables=tables,
                params=params.reshape(Np * T, PARAMS_W), sb_of=sb_of,
                superblocks=G, naive_bytes=naive, planned_bytes=planned,
                bucketed_bytes=bucketed, merged_lanes=N - G)


def plan_sharded(kind: str, es, n_chips: int, Np: int) -> Optional[Plan]:
    """The mesh variant of `plan_wave_group`: member c owns lanes
    [c * rpc, (c + 1) * rpc), rpc = Np / n_chips, and its slice is
    planned alone, so that no superblock (and no halo) crosses a member.
    The members' superblock counts pad to one Gc, their tables
    concatenate to (n_chips * Gc, T, S_u), and ``sb_of`` (Np,) holds
    member-local rows; params are (Np, T, 16), lanes in order.  None
    when the planner is off or no member merges anything (the
    unplanned split runs)."""
    if not plan_enabled() or kind not in ("byte", "scored", "expr") \
            or not es:
        return None
    n_ns = int(es[0].key[0][1])
    pool = es[0].payload["pool"]
    pr, pc = int(pool.page_rows), int(pool.page_cols)
    N = len(es)
    rpc = max(1, Np // max(1, n_chips))
    T = max(e.payload["tables"].shape[0] for e in es)
    S_in = max(e.payload["tables"].shape[1] for e in es)
    naive = Np * T * S_in * pr * pc * 4
    rows = [_entry_rows(e, pr, pc) for e in es]
    chip_sbs = []
    merged_any = False
    for c in range(n_chips):
        sub = list(range(c * rpc, min(N, (c + 1) * rpc)))
        if not sub:
            chip_sbs.append([])
            continue
        sbs = _cluster_and_merge([es[i] for i in sub],
                                 [rows[i] for i in sub], n_ns, pr, pc)
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
    return Plan("superblock", tables=tables, params=params, sb_of=sb_of,
                superblocks=total, naive_bytes=naive,
                planned_bytes=planned, merged_lanes=N - total)


def plan_stats() -> Dict:
    """Knobs, route split and savings since `reset_plan_state`."""
    with _LOCK:
        return {"enabled": plan_enabled(),
                "halo_max": plan_halo_max(),
                "superblocks": _STATS["superblocks"],
                "merged_lanes": _STATS["merged_lanes"],
                "gather_bytes_saved": _STATS["bytes_saved"],
                "groups_planned": _STATS["groups_planned"],
                "assembly_planned": _STATS["assembly_planned"],
                "routes": dict(_STATS["routes"])}


def reset_plan_state():
    """Zero the planner's counters."""
    with _LOCK:
        _STATS.update({"superblocks": 0, "merged_lanes": 0,
                       "bytes_saved": 0, "groups_planned": 0,
                       "assembly_planned": 0, "routes": dict(_ROUTES0)})
