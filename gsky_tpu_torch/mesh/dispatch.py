"""Mesh wave dispatch: a drained wave group spread over every member.

Counterpart of `gsky_tpu/mesh/dispatch.py`.  The wave scheduler
(`pipeline.waves`) coalesces a tick's requests into one group per
(kind, statics, pool); with ``GSKY_MESH=1`` and more than one mesh
member it hands each group here.  The group's descriptor walks the
partition rules (`mesh.rules`) and the layout decides how the group
spreads over the members (`parallel.mesh`):

- ``granule`` — the wave's stacked tables, params, ctrl grids, scale
  params, literals and ``sb_of`` are split by rows: the wave axis pads
  to a power of two and then to a multiple of the member count, and
  member i takes rows [i * rpc, (i + 1) * rpc).  The wave planner plans
  each member's slice alone (`autoplan.plan_sharded`), so no superblock
  crosses a member and ``sb_of`` is member-local; a superblock plan
  also carries B1's output tile for a member's launch (``blk``).  Each
  member launches kernel B1 (`ops.paged.render_byte_paged`,
  `render_expr_paged`, `warp_scored_paged`) on its rows, against its own
  view of the page pool: the pool tensor itself on the pool's device, a
  copy on any other (the reference replicates the pool every wave).  Lanes are
  independent, so the bytes equal the single-device wave's exactly.
- ``x`` — each entry renders through the dispatcher's `SpmdRenderer`:
  kernel B2 on every member over its granule shard and width strip.
- ``time`` — the K drills of a drill wave split across the members, and
  each member runs kernel B3's K-block form
  (`ops.paged.wave_drill_stats`) on its blocks: every row is reduced
  alone, so the result equals the single-device wave's.
- ``replicated`` — the scheduler's own dispatch, untouched.

Each member's launches run on the member's own stream (`run_members`);
the outputs are gathered to the first member's device in member order,
and come back with the members' completion events (`MeshOut`), which
`observe_shards` times per member before the wave's readback (the
straggler spread, ``gsky_mesh_shard_skew_ms``).  Virtual members share
a device and so its launch counters: the dispatcher keeps its own
counts per member and layout (`stats`).

Failure semantics are the scheduler's: every layout runs inside
``device_guard.run("dispatch.wave")`` and a failure fails the wave's
entries over one by one to their per-call legs.  There is no fallback
around the mesh itself: a mesh that cannot be built (CUDA members
without CUDA, a malformed ``GSKY_MESH_RULES``) raises where the
reference's scheduler would quietly serve single-device.

``GSKY_SPMD=1`` (`compat_spmd`) routes the executor's one-group mosaic
and byte tile and the drill's reductions through the same renderer.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs.metrics import (MESH_CHIP_OCCUPANCY, MESH_SHARD_SKEW_MS,
                           MESH_WAVES)
from ..parallel.mesh import (Mesh, all_gather, make_mesh, mesh_devices,
                             run_members)
from . import rules as rules_mod


def mesh_enabled(device="cuda") -> bool:
    """GSKY_MESH=1 and more than one mesh member for ``device``: wave
    groups route through the partition rules.  Unset or 0 keeps
    single-device waves exactly (the mesh is never consulted)."""
    if os.environ.get("GSKY_MESH", "0") != "1":
        return False
    return len(mesh_devices(device)) > 1


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class MeshOut(tuple):
    """A mesh wave's outputs, with ``events``: the members' completion
    events in member order (empty where none was recorded)."""

    def __new__(cls, items, events=()):
        out = super().__new__(cls, items)
        out.events = list(events)
        return out


def _upload(host: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    """Host arrays to one member's device (through pinned memory,
    asynchronously, on the current stream, for a CUDA member)."""
    out = {}
    for k, a in host.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


class MeshDispatcher:
    """Rule-driven mesh dispatch of wave groups, and the owner of the
    process's `SpmdRenderer`."""

    def __init__(self, mesh: Optional[Mesh] = None, device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.n_chips = self.mesh.size
        self.device = self.mesh.out_device
        # one sharded code path: the GSKY_SPMD routes and the x layout
        # share this renderer
        from ..parallel.spmd import SpmdRenderer
        self.spmd = SpmdRenderer(self.mesh)
        # parsed once: a malformed GSKY_MESH_RULES fails loudly here
        self.rules = rules_mod.active_rules()
        self._lock = threading.Lock()
        self.waves_by_layout: Dict[str, int] = {}
        self.entries_by_layout: Dict[str, int] = {}
        self.temporal_by_layout: Dict[str, int] = {}
        # kernel wrapper calls per member, by layout (virtual members
        # share their device's launch counters)
        self.launches_by_layout: Dict[str, List[int]] = {}
        self.programs: set = set()
        self.skew_ms_last = 0.0
        self.member_wait_ms_last: List[float] = []
        from ..obs import tsan
        if tsan.enabled():
            tsan.track(self, "MeshDispatcher")

    # -- rules ---------------------------------------------------------

    def layout_for(self, kind: str, key: tuple, wave: int) -> str:
        return rules_mod.match_rules(rules_mod.describe(kind, key, wave),
                                     self.rules)

    def _wave_pad(self, n: int) -> int:
        """The wave axis padded to a power of two, then to a multiple of
        the member count."""
        p = _pow2(n)
        return -(-p // self.n_chips) * self.n_chips

    def _chip_counts(self, n_real: int, n_padded: int) -> List[int]:
        """Real entries on each member (member i owns rows [i * rpc,
        (i + 1) * rpc))."""
        rpc = max(1, n_padded // self.n_chips)
        return [max(0, min(n_real - c * rpc, rpc))
                for c in range(self.n_chips)]

    # -- the granule layout --------------------------------------------

    @staticmethod
    def _stack_tables(es, Np: int):
        """The scheduler's ragged stacking over Np rows, kept (Np, T, S)
        so that the params rows split with their lanes."""
        from ..ops.paged import PARAMS_W
        T = max(e.payload["tables"].shape[0] for e in es)
        S = max(e.payload["tables"].shape[1] for e in es)
        tables = np.zeros((Np, T, S), np.int32)
        params = np.zeros((Np, T, PARAMS_W), np.float32)
        params[:, :, 10] = -1.0     # ns_id: padding rows gather nothing
        for i, e in enumerate(es):
            ti, si = e.payload["tables"].shape
            tables[i, :ti, :si] = e.payload["tables"]
            params[i, :ti] = e.payload["params16"]
        return tables, params

    def stage_wave(self, sched, kind: str, es: List):
        """The assembly half of the granule layout (`_stage_granule`),
        run ahead of dispatch under ``device_guard.run("mesh.stage")``;
        None for a group whose layout stages nothing."""
        if kind not in ("byte", "scored", "expr") or \
                self.layout_for(kind, es[0].key, len(es)) != "granule":
            return None
        return self._stage_granule(kind, es)

    def _stage_granule(self, kind: str, es: List) -> Dict:
        """Plan, stack and split the group by rows, and upload each
        member's slices to its device."""
        from ..ops.paged import PARAMS_W
        from ..pipeline import autoplan
        N = len(es)
        Np = self._wave_pad(N)
        n = self.n_chips
        rpc = Np // n
        try:
            plan = autoplan.plan_sharded(kind, es, n, Np)
        except Exception:   # noqa: BLE001 - planning is an optimisation
            plan = None
        if plan is not None:
            tables, params, sb_of = plan.tables, plan.params, plan.sb_of
            gc = tables.shape[0] // n
        else:
            tables, params = self._stack_tables(es, Np)
            sb_of, gc = None, rpc
        T = params.shape[1]
        pad = Np - N

        def stacked(name):
            return np.stack([np.asarray(e.payload[name]) for e in es]
                            + [np.asarray(es[0].payload[name])] * pad)

        ctrls = stacked("ctrl")
        sps = stacked("sp") if kind in ("byte", "expr") else None
        consts = stacked("consts") if kind == "expr" else None
        members = []
        for i, dev in enumerate(self.mesh.members):
            rows = slice(i * rpc, (i + 1) * rpc)
            host = {"tables": tables[i * gc:(i + 1) * gc],
                    "params": params[rows].reshape(rpc * T, PARAMS_W),
                    "ctrls": ctrls[rows]}
            if sb_of is not None:
                host["sb_of"] = sb_of[rows]
            if sps is not None:
                host["sps"] = sps[rows]
            if consts is not None:
                host["consts"] = consts[rows]
            members.append(_upload(host, dev))
        return {"layout": "granule", "N": N, "Np": Np, "members": members,
                "superblock": plan is not None,
                "blk": plan.blk if plan is not None else None}

    def _dispatch_wave_granule(self, kind: str, es: List, staged=None):
        from ..ops import paged
        from ..ops.expr import fingerprint_hash
        pool = es[0].payload["pool"]
        statics = es[0].key[0]
        method, n_ns, out_hw, step = statics[:4]
        try:
            if staged is None:
                staged = self._stage_granule(kind, es)
            N, Np = staged["N"], staged["Np"]
            self._chip_occupancy(self._chip_counts(N, Np))
            if kind == "expr":
                paged.note_expr_fused("mesh")
                paged.note_expr_program(fingerprint_hash(statics[6]))
            with pool.locked_pool() as parr:
                def body(i, dev):
                    m = staged["members"][i]
                    # the pool itself on its device, a copy elsewhere
                    p = parr if parr.device == dev \
                        else parr.to(dev, non_blocking=True)
                    sb, blk = m.get("sb_of"), staged["blk"]
                    if kind == "byte":
                        return (paged.render_byte_paged(
                            p, m["tables"], m["params"], m["ctrls"],
                            m["sps"], method, n_ns, out_hw, step,
                            statics[4], statics[5], sb_of=sb, blk=blk),)
                    if kind == "expr":
                        return (paged.render_expr_paged(
                            p, m["tables"], m["params"], m["ctrls"],
                            m["sps"], m["consts"], method, n_ns, out_hw,
                            step, statics[4], statics[5], statics[6],
                            sb_of=sb, blk=blk),)
                    canv, best = paged.warp_scored_paged(
                        p, m["tables"], m["params"], m["ctrls"], method,
                        n_ns, out_hw, step, sb_of=sb, blk=blk)
                    return canv, best > float("-inf")

                outs, events = run_members(self.mesh, body)
            self._launched("granule", ("granule", kind, statics))
            return self._gather(outs, events, N)
        finally:
            for e in es:
                e.cleanup_once()

    def _gather(self, outs, events, n_real: int) -> MeshOut:
        """Each output position's member blocks, in member order, as one
        (rows, ...) tensor on the first member's device, cut to the real
        rows."""
        dev = self.mesh.out_device
        cols = []
        for k in range(len(outs[0])):
            g = all_gather([o[k] for o in outs], dev, events)
            cols.append(g.reshape((-1,) + tuple(g.shape[2:]))[:n_real])
        return MeshOut(cols, events)

    # -- the x layout --------------------------------------------------

    def _dispatch_x(self, kind: str, es: List):
        """One sharded render per entry over its lane's cached scenes:
        every member on every entry (B2 on its granule shard and width
        strip)."""
        statics = es[0].key[0]
        method, n_ns, out_hw, step = statics[:4]
        try:
            self._chip_occupancy([len(es)] * self.n_chips)
            lanes = [e.payload.get("xla") for e in es]
            if any(lane is None for lane in lanes):
                raise ValueError("the x layout renders from a lane's "
                                 "scenes; an entry carries none")
            if kind == "byte":
                outs = [self.spmd.render_composite(
                    lane.scenes, lane.ctrl, lane.params, e.payload["sp"],
                    method, n_ns, out_hw, step, statics[4], statics[5])
                    for e, lane in zip(es, lanes)]
                res = (torch.stack(outs),)
            else:
                cs, vs = [], []
                for lane in lanes:
                    canv, best = self.spmd.mosaic_scored(
                        lane.scenes, lane.ctrl, lane.params, method, n_ns,
                        out_hw, step)
                    cs.append(canv)
                    vs.append(best > float("-inf"))
                res = (torch.stack(cs), torch.stack(vs))
            for _ in es:
                self._launched("x", ("x", kind, statics))
            return MeshOut(res)
        finally:
            for e in es:
                e.cleanup_once()

    # -- the time layout -----------------------------------------------

    def _dispatch_drill_time(self, es: List):
        from ..ops.paged import wave_drill_stats
        clip_lo, clip_hi, pix = es[0].key[1:]
        K = len(es)
        Kp = self._wave_pad(K)
        rpc = Kp // self.n_chips
        datas = [e.payload["data"] for e in es] \
            + [es[0].payload["data"]] * (Kp - K)
        valids = [e.payload["valid"] for e in es] \
            + [es[0].payload["valid"]] * (Kp - K)

        def body(i, dev):
            rows = slice(i * rpc, (i + 1) * rpc)
            return wave_drill_stats([d.to(dev) for d in datas[rows]],
                                    [v.to(dev) for v in valids[rows]],
                                    clip_lo, clip_hi, pixel_count=pix)

        outs, events = run_members(self.mesh, body)
        self._chip_occupancy(self._chip_counts(K, Kp))
        self._launched("time", ("time", es[0].key))
        return self._gather(outs, events, K)

    # -- the scheduler's entry -----------------------------------------

    def dispatch_wave(self, sched, kind: str, es: List, staged=None):
        """Pick the group's layout, dispatch it and count it.  Runs
        inside ``device_guard.run("dispatch.wave")``; an error reaches
        the scheduler's per-entry failover.  ``staged`` is
        `stage_wave`'s hand-off (the granule layout's only)."""
        layout = self.layout_for(kind, es[0].key, len(es))
        if layout == "granule" and kind in ("byte", "scored", "expr"):
            devs = self._dispatch_wave_granule(kind, es, staged)
        elif layout == "x" and kind in ("byte", "scored"):
            devs = self._dispatch_x(kind, es)
        elif layout == "time" and kind == "drill":
            devs = self._dispatch_drill_time(es)
        else:
            # the replicated fallback, or a rule pairing a kind with a
            # layout it cannot take: the scheduler's own dispatch
            layout = "replicated"
            from ..pipeline import autoplan
            try:
                plan = autoplan.plan_wave_group(kind, es)
            except Exception:   # noqa: BLE001 - planning is an optimisation
                plan = None
            devs = sched._dispatch_group(kind, es, plan, None)
        self._note(layout, es)
        return devs

    # -- prewarm -------------------------------------------------------

    def prewarm_programs(self, pool, specs, sizes, wave_sizes,
                         step: int = 16, bucket: int = 512) -> int:
        """The mesh layouts' first launches off the request path: per
        (method, tile edge, wave size) point of the prewarm lattice, a
        granule byte and a granule scored wave (B1 on every member over
        the null page), and per wave size the time layout's drill, mean
        and pixel count (B3's K-block form and the plain count on every
        member).  Returns the mesh dispatches run; a failure raises."""
        from ..ops import paged
        from ..ops.paged import wave_drill_stats
        from ..server.prewarm import _paged_inputs
        n = 0
        for method, n_exprs, auto, cs in sorted(specs):
            if n_exprs != 1:
                continue                # the paged path is single-band
            for hw in sizes:
                for W in wave_sizes:
                    Np = self._wave_pad(W)
                    rpc = Np // self.n_chips
                    tables, p16, ctrls, sps = _paged_inputs(
                        pool, hw, bucket, step, Np)
                    with pool.locked_pool() as parr:
                        def body(i, dev, kind):
                            rows = slice(i * rpc, (i + 1) * rpc)
                            p = parr if parr.device == dev \
                                else parr.to(dev)
                            args = (p, tables[rows].to(dev),
                                    p16[rows].to(dev), ctrls[rows].to(dev))
                            if kind == "byte":
                                return (paged.render_byte_paged(
                                    *args, sps[rows], method, 1, (hw, hw),
                                    step, auto, cs),)
                            return paged.warp_scored_paged(
                                *args, method, 1, (hw, hw), step)

                        for kind in ("byte", "scored"):
                            run_members(self.mesh,
                                        lambda i, d, k=kind: body(i, d, k))
                            self._sync()
                            with self._lock:
                                self.programs.add(
                                    ("granule", kind, method, hw, Np))
                            n += 1
        for W in wave_sizes:
            Kp = self._wave_pad(W)
            rpc = Kp // self.n_chips
            for pix in (False, True):
                def drill(i, dev, pix=pix):
                    zeros = torch.zeros((1, 64), dtype=torch.float32,
                                        device=dev)
                    ones = torch.ones((1, 64), dtype=torch.bool, device=dev)
                    return wave_drill_stats([zeros] * rpc, [ones] * rpc,
                                            -3e38, 3e38, pixel_count=pix)
                run_members(self.mesh, drill)
                self._sync()
                with self._lock:
                    self.programs.add(("time", pix, Kp))
                n += 1
        return n

    def _sync(self):
        for d in set(self.mesh.members):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- accounting ----------------------------------------------------

    def _launched(self, layout: str, program: tuple):
        with self._lock:
            row = self.launches_by_layout.setdefault(
                layout, [0] * self.n_chips)
            for i in range(self.n_chips):
                row[i] += 1
            self.programs.add(program)

    def _note(self, layout: str, es: List):
        n_temporal = sum(1 for e in es
                         if e.payload.get("serials") is not None)
        with self._lock:
            self.waves_by_layout[layout] = \
                self.waves_by_layout.get(layout, 0) + 1
            self.entries_by_layout[layout] = \
                self.entries_by_layout.get(layout, 0) + len(es)
            if n_temporal:
                self.temporal_by_layout[layout] = \
                    self.temporal_by_layout.get(layout, 0) + n_temporal
        MESH_WAVES.labels(layout=layout).inc()

    @staticmethod
    def _chip_occupancy(counts: List[int]):
        for c in counts:
            MESH_CHIP_OCCUPANCY.observe(float(c))

    def observe_shards(self, devs):
        """The drainer's probe before a mesh wave's readback: wait for
        each member's event in turn and record the spread of the waits
        (the first absorbs the wave's own wait, so the spread is a lower
        bound on the straggler's lag)."""
        events = [e for e in getattr(devs, "events", ()) if e is not None]
        if len(events) < 2:
            return
        times = []
        for ev in events:
            t0 = time.perf_counter()
            ev.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        skew = max(times) - min(times)
        with self._lock:
            self.skew_ms_last = skew
            self.member_wait_ms_last = times
        MESH_SHARD_SKEW_MS.observe(skew)

    def stats(self) -> Dict:
        with self._lock:
            return {"enabled": mesh_enabled(self.device),
                    "chips": self.n_chips,
                    "mesh": dict(self.mesh.shape),
                    "devices": [str(d) for d in self.mesh.members],
                    "virtual": self.mesh.virtual,
                    "rules": [(r.source, r.layout) for r in self.rules],
                    "waves_by_layout": dict(self.waves_by_layout),
                    "entries_by_layout": dict(self.entries_by_layout),
                    "temporal_lanes": dict(self.temporal_by_layout),
                    "launches_by_layout": {
                        k: list(v)
                        for k, v in self.launches_by_layout.items()},
                    "member_dispatches": self.mesh.member_stats(),
                    "skew_ms_last": round(self.skew_ms_last, 3),
                    "member_wait_ms_last": [
                        round(t, 3) for t in self.member_wait_ms_last],
                    "programs": len(self.programs)}


# -- the process's dispatcher --------------------------------------------

_default: Optional[MeshDispatcher] = None
_default_lock = threading.Lock()


def _dispatcher(device="cuda") -> MeshDispatcher:
    """The process dispatcher over `mesh_devices(device)`, made on first
    use and again when the member list changes."""
    global _default
    members = mesh_devices(device)
    with _default_lock:
        if _default is None or _default.mesh.members != members:
            _default = MeshDispatcher(make_mesh(devices=members))
        return _default


def default_mesh(device="cuda") -> Optional[MeshDispatcher]:
    """The dispatcher when mesh serving is on for ``device``, else None
    (the wave scheduler keeps its single-device path exactly)."""
    if not mesh_enabled(device):
        return None
    return _dispatcher(device)


def active_mesh() -> Optional[MeshDispatcher]:
    """The live dispatcher or None: a scrape builds no mesh."""
    return _default


def mesh_stats() -> Dict:
    """The live dispatcher's stats; {} before the first mesh consult."""
    md = _default
    return {} if md is None else md.stats()


def reset_mesh():
    """Drop the dispatcher (tests, reconfiguration)."""
    global _default
    with _default_lock:
        _default = None


def compat_spmd(device="cuda"):
    """The ``GSKY_SPMD=1`` routing: the dispatcher's `SpmdRenderer` when
    ``GSKY_SPMD=1`` and ``device`` has more than one mesh member, else
    None (one member: the single-device path serves, as the
    reference's does on a one-chip host)."""
    if os.environ.get("GSKY_SPMD", "0") != "1":
        return None
    if len(mesh_devices(device)) <= 1:
        return None
    return _dispatcher(device).spmd
