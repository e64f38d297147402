"""Paged gather-window pool: the device residency layer behind kernel B1.

Counterpart of `gsky_tpu/pipeline/pages.py`.  Scenes are cut into a
fixed grid of (page_rows, page_cols) f32 pages (page (pi, pj) covers
scene rows [pi*PR, (pi+1)*PR), cols [pj*PC, (pj+1)*PC); validity stays
NaN-encoded, the scene-cache convention).  Pages live in ONE
preallocated device tensor of shape (capacity, PR, PC) and are
content-keyed on (scene serial, pi, pj), so overlapping tiles share
staged pages.  Slot 0 is a reserved all-NaN null page that pads page
tables: a tap through it is always invalid, never garbage.

A stage is an in-place write of one page into ``pool[slot]`` on the
current stream (the JAX pool donates its buffer to a jitted update for
the same effect).  Staging and the kernel enqueue that reads the pool
both happen under ``self.lock`` (`locked_pool()`): stream order then
guarantees a later stage cannot overwrite a page before an enqueued
kernel has read it, because eviction never touches a PINNED slot —
`table_for` pins, the caller `unpin`s after its dispatch is enqueued.

Page geometry comes from GSKY_PAGE_SIZE, the pool size from
GSKY_PAGE_POOL_MB, exactly as the JAX package reads them, so both
pools build identical tables from the same scenes.

A pipelined wave (`pipeline.waves`) stages its tables one wave ahead of
its launch: `handoff` takes the pool's staging generation at assembly
and `handoff_ok` confirms it at dispatch.  `union_table` merges the
pinned tables of a superblock's lanes (`pipeline.autoplan`).

Under critical memory pressure (`resilience.pressure`), and while the
device guard holds the device anything but healthy (`device_guard`),
`table_for` declines to stage: the tile takes the bucketed leg (kernel
B2), as a tile the pool cannot hold does.  The monitor's relief, and
the guard's out-of-memory relief, `trim` the colder half of every live
pool's unpinned pages.

The device guard's lifecycle, as the reference's: a cold stage appends
a ``stage`` line to the residency journal (`device_guard.journal`) and,
under ``GSKY_POOL_AUDIT=1``, keeps the page's CRC32; `teardown` journals
the hot set with its hit counts and drops the pool tensor; `rehydrate`
re-stages the journal's hottest pages from the scenes still resident in
the pool's scene cache (``cache``, set by its executor), skipping stale
entries; `audit` convicts
pages holding inf (`ops.paged.pool_inf_counts`) or failing their CRC
and quarantines them (a pinned one recycles when its pin drops).

Under mesh serving with per-member placement (`mesh.pools`), a pool
lives on one member's device and its ``chip`` (None otherwise) tags the
journal's lines, so that `MeshPools.rehydrate_all` restores each
member's own pages.

The cache fabric (`fabric.pagerpc`): serials name a scene's content on
every node (`scene_cache.content_serial`), so a page staged anywhere is
the same page here.  `stage_page` writes a page a peer sent into a slot
(a plain copy, no kernel), `has_page` and `read_pages` look pages up
for a peer without touching the LRU order or the heat, and `rehydrate`
asks the fabric's page peers for the journal's hot set first
(``GSKY_FABRIC``).  Fills are counted by
source in ``gsky_fabric_page_fills_total`` (``peer`` or ``cold``) and
``peer_filled``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref
import zlib
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..device_guard import guard_enabled, journal, pool_audit_enabled, \
    staging_ok
from ..obs import tsan
from ..obs.metrics import FABRIC_PAGE_FILLS
from ..ops.paged import page_shape, pool_inf_counts
from ..resilience.pressure import staging_allowed

# every live pool, for the pressure monitor (occupancy and relief)
_live: "weakref.WeakSet[PagePool]" = weakref.WeakSet()


def live_pools():
    """The page pools alive now (each `WarpExecutor` has its own)."""
    return list(_live)


def _note_fill(source: str) -> None:
    """``gsky_fabric_page_fills_total{source=peer|cold}``."""
    FABRIC_PAGE_FILLS.labels(source=source).inc()


def _pool_capacity(pr: int, pc: int) -> int:
    """Pool page count from GSKY_PAGE_POOL_MB (default 64 MiB)."""
    try:
        mb = int(os.environ.get("GSKY_PAGE_POOL_MB", "64"))
    except ValueError:
        mb = 64
    page_bytes = pr * pc * 4
    return max(2, (max(1, mb) << 20) // page_bytes)


class PagePool:
    """Device-resident page pool + LRU page table.  Thread-safe."""

    def __init__(self, capacity: int | None = None,
                 page_rows: int | None = None,
                 page_cols: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        pr, pc = page_shape()
        self.page_rows = int(page_rows or pr)
        self.page_cols = int(page_cols or pc)
        if capacity is None:
            capacity = _pool_capacity(self.page_rows, self.page_cols)
        self.capacity = max(2, int(capacity))
        self.lock = threading.RLock()
        self._pool = None            # lazy: first use allocates
        self._slots = OrderedDict()  # (serial, pi, pj) -> slot, LRU
        self._free = list(range(self.capacity - 1, 0, -1))
        self._pins: Dict[int, int] = {}   # slot -> pin count
        self._heat: Dict[tuple, int] = {}  # key -> hits since staged
        # stage-time page CRCs, kept only under GSKY_POOL_AUDIT=1
        self._checksums: Dict[tuple, int] = {}
        # audited-poisoned slots still pinned by a dispatch: `unpin`
        # frees them once the pin drops
        self._quarantine_pins: set = set()
        # the scene cache whose scenes this pool pages (`rehydrate`)
        self.cache = None
        self.staged = 0
        self.hits = 0
        self.evictions = 0
        self.declined = 0
        self.trimmed = 0
        self.teardowns = 0
        self.rehydrated = 0
        self.quarantined = 0
        self.peer_filled = 0         # pages staged from fabric peers
        # the keys resident at the last teardown, until `rehydrate`
        self._torn = None
        # staging generation of the slot namespace (`handoff`), bumped
        # by `teardown`: a wave staged before a device incident refuses
        # to launch against the rebuilt pool
        self._handoff_gen = 0
        _live.add(self)
        if tsan.enabled():
            # lockset tracking across staging, dispatch and relief
            tsan.track(self, "PagePool")

    # the owning mesh member's index (`mesh.pools.ChipPagePool`), None
    # on an executor's own pool; the journal's lines carry it
    chip = None

    # -- internals (hold self.lock) -----------------------------------

    def _ensure_pool(self):  # gskylint: holds-lock
        if self._pool is None:
            # slot 0 (and every unstaged slot) is all-NaN
            self._pool = torch.full(
                (self.capacity, self.page_rows, self.page_cols),
                float("nan"), dtype=torch.float32, device=self.device)

    def _take_slot(self):  # gskylint: holds-lock
        if self._free:
            return self._free.pop()
        for key in self._slots:    # LRU order: oldest first
            slot = self._slots[key]
            if self._pins.get(slot):
                continue
            del self._slots[key]
            self._heat.pop(key, None)
            self._checksums.pop(key, None)
            self.evictions += 1
            return slot
        return None                 # everything pinned: caller declines

    def _stage(self, dev, slot: int, pi: int, pj: int) -> None:
        """pool[slot] = page (pi, pj) of ``dev``, NaN beyond the scene.
        The page origin clamps into the page-padded scene the way the
        reference's dynamic_slice clamps its start index."""
        pr, pc = self.page_rows, self.page_cols
        sh, sw = int(dev.shape[0]), int(dev.shape[1])
        r0 = min(pi * pr, -(-sh // pr) * pr - pr)
        c0 = min(pj * pc, -(-sw // pc) * pc - pc)
        page = self._pool[slot]
        page.fill_(float("nan"))
        rh = max(0, min(pr, sh - r0))
        cw = max(0, min(pc, sw - c0))
        if rh and cw:
            page[:rh, :cw].copy_(dev[r0:r0 + rh, c0:c0 + cw])

    def _stage_locked(self, dev, serial: int, pi: int, pj: int):
        key = (int(serial), int(pi), int(pj))
        slot = self._slots.get(key)
        if slot is not None:
            self._slots.move_to_end(key)
            self.hits += 1
            self._heat[key] = self._heat.get(key, 0) + 1
            return slot
        slot = self._take_slot()
        if slot is None:
            return None
        self._ensure_pool()
        self._stage(dev, slot, int(pi), int(pj))
        self._placed(key, slot)
        _note_fill("cold")
        return slot

    def _placed(self, key: tuple, slot: int) -> None:  # gskylint: holds-lock
        """Book a page just written into ``slot``: the table, the stage
        count, and under the device guard the journal's breadcrumb (a
        stage line: stages only, not hits) and, under
        ``GSKY_POOL_AUDIT=1``, the page's CRC (one page readback a
        stage)."""
        self._slots[key] = slot
        self.staged += 1
        if guard_enabled():
            journal.record_stage(*key, chip=self.chip)
            if pool_audit_enabled():
                self._checksums[key] = zlib.crc32(
                    self._pool[slot].cpu().numpy().tobytes())

    # -- public --------------------------------------------------------

    def table_for(self, dev, serial: int, i0: int, i1: int,
                  j0: int, j1: int):
        """Stage pages (i0..i1) x (j0..j1) of scene ``dev`` and return
        their slots row-major as (npages,) int32, PINNED — or None when
        the pool cannot hold the request's working set (partial pins
        are rolled back).  The caller must `unpin` the returned slots
        once its dispatch is enqueued (or abandoned).  Under critical
        memory pressure, or while the device guard holds the device
        anything but healthy, it declines at once."""
        if not staging_allowed() or not staging_ok():
            with self.lock:
                self.declined += 1
            return None
        slots = []
        with self.lock:
            for pi in range(int(i0), int(i1) + 1):
                for pj in range(int(j0), int(j1) + 1):
                    s = self._stage_locked(dev, serial, pi, pj)
                    if s is None:
                        self.declined += 1
                        for t in slots:   # roll back partial pins
                            self._pins[t] -= 1
                            if not self._pins[t]:
                                del self._pins[t]
                        return None
                    self._pins[s] = self._pins.get(s, 0) + 1
                    slots.append(s)
        return np.asarray(slots, np.int32)

    def stage_page(self, serial: int, pi: int, pj: int, page) -> bool:
        """Stage one page a fabric peer sent (`fabric.pagerpc`): the
        bytes are the page, no scene is involved; the reference's
        ``_stage_ready``, here a copy into ``pool[slot]``.  False when
        its shape is not the pool's page shape (content keys mean
        nothing between pools cut otherwise) or every slot is pinned; a
        resident key is left as it is (True)."""
        arr = np.array(page, np.float32)     # a writable copy
        if arr.shape != (self.page_rows, self.page_cols):
            return False
        key = (int(serial), int(pi), int(pj))
        with self.lock:
            if key in self._slots:
                return True
            slot = self._take_slot()
            if slot is None:
                self.declined += 1
                return False
            self._ensure_pool()
            self._pool[slot].copy_(torch.from_numpy(arr))
            self._placed(key, slot)
            self.peer_filled += 1
        _note_fill("peer")
        return True

    def has_page(self, serial: int, pi: int, pj: int) -> bool:
        """Whether a page is resident (no LRU touch, no heat)."""
        with self.lock:
            return (int(serial), int(pi), int(pj)) in self._slots

    def read_page(self, serial: int, pi: int, pj: int):
        """A resident page on the host, (PR, PC) f32, or None: one key
        of `read_pages`."""
        got = self.read_pages([(serial, pi, pj)], 1)
        return got[0][1] if got else None

    def read_pages(self, keys, limit: int):
        """The first ``limit`` of ``keys`` that are resident, in their
        order, each with its page on the host, (PR, PC) f32: a peer's
        ``page_fetch``.  The pages are gathered in one copy under the
        lock, so a slot evicted and restaged after it returns cannot
        change them.  Passive: no LRU touch and no heat, so a peer's
        warm-up leaves this pool's eviction order alone."""
        found, slots = [], []
        with self.lock:
            if self._pool is None:
                return []
            for k in keys:
                key = (int(k[0]), int(k[1]), int(k[2]))
                slot = self._slots.get(key)
                if slot is None:
                    continue
                found.append(key)
                slots.append(slot)
                if len(found) >= limit:
                    break
            if not found:
                return []
            idx = torch.tensor(slots, dtype=torch.long,
                               device=self._pool.device)
            pages = self._pool.index_select(0, idx).cpu().numpy()
        return list(zip(found, pages))

    def prewarm(self, dev, serial: int, i0: int, i1: int,
                j0: int, j1: int) -> bool:
        """Stage a page window and keep no pins (the prefetch planner's
        hook): the request's own `table_for` then hits.  A decline is
        fine; the request stages as usual."""
        slots = self.table_for(dev, serial, i0, i1, j0, j1)
        if slots is None:
            return False
        self.unpin(slots)
        return True

    def unpin(self, slots) -> None:
        """Release pins taken by `table_for` (once per returned table)."""
        with self.lock:
            for s in np.asarray(slots).reshape(-1).tolist():
                n = self._pins.get(int(s), 0) - 1
                if n > 0:
                    self._pins[int(s)] = n
                else:
                    self._pins.pop(int(s), None)
                    if int(s) in self._quarantine_pins:
                        # audited-poisoned while a dispatch held it
                        self._quarantine_pins.discard(int(s))
                        self._free.append(int(s))

    def trim(self, frac: float = 0.5) -> int:
        """Release the coldest ``frac`` of the unpinned resident pages
        (their slots go back on the free list); the count released."""
        with self.lock:
            victims = [k for k in self._slots
                       if not self._pins.get(self._slots[k])]
            victims = victims[:int(len(victims)
                                   * max(0.0, min(1.0, frac)))]
            for k in victims:
                self._free.append(self._slots.pop(k))
                self._heat.pop(k, None)
                self._checksums.pop(k, None)
            self.trimmed += len(victims)
            return len(victims)

    def drop_scene(self, serial: int) -> None:
        """Free every unpinned page of a scene and void its journal
        entries (its pages can no longer be re-staged); pinned pages
        stay until their dispatch is done and LRU retires them."""
        with self.lock:
            dead = [k for k, s in self._slots.items()
                    if k[0] == int(serial) and not self._pins.get(s)]
            for k in dead:
                self._free.append(self._slots.pop(k))
                self._heat.pop(k, None)
                self._checksums.pop(k, None)
        if guard_enabled():
            journal.record_drop(serial, chip=self.chip)

    # -- the device guard's lifecycle ----------------------------------

    def teardown(self) -> None:
        """Device-incident teardown: journal the hot set with its hit
        counts, then drop the pool tensor and every piece of residency
        bookkeeping.  Pins are cleared: every dispatch that held one has
        failed through the guard by the time a teardown runs."""
        with self.lock:
            self.flush_heat()
            self._torn = set(self._slots)
            self._pool = None
            self._slots.clear()
            self._pins.clear()
            self._heat.clear()
            self._checksums.clear()
            self._quarantine_pins.clear()
            self._free = list(range(self.capacity - 1, 0, -1))
            self.teardowns += 1
            self._handoff_gen += 1

    def flush_heat(self) -> None:
        """Journal every resident page with its hit count (``heat``
        lines, under the device guard) and keep the pool as it is: a
        preempted worker's exit, whose successor may still be reading
        its pages."""
        if not guard_enabled():
            return
        with self.lock:
            for key in self._slots:
                journal.record_heat(*key, hits=self._heat.get(key, 0),
                                    chip=self.chip)

    def rehydrate(self) -> int:
        """Warm recovery: the journal's hottest pages, hottest first,
        until the journal or the free slots run out.  After this pool's
        own teardown, only the pages it held: the journal is the
        process's, and other pools in the process journal theirs, of
        the same scenes (serials name content); a fresh pool (a warm
        boot) takes the whole journal.  With the fabric's page tier on,
        the page peers are asked first (`fabric.pagerpc.
        fill_from_peers`); what they do not hold is re-staged from the
        scenes still resident in the pool's scene cache.  An entry whose
        scene is gone, or whose page lies outside its scene's page grid,
        is skipped.  Returns the pages restored."""
        entries = journal.replay()
        with self.lock:
            torn, self._torn = self._torn, None
        if torn is not None:
            entries = [e for e in entries if e in torn]
        if not entries:
            return 0
        restored = 0
        from .. import fabric
        if fabric.fabric_enabled():
            from ..fabric import pagerpc
            restored += pagerpc.fill_from_peers(self, entries)
        if self.cache is None:
            with self.lock:
                self.rehydrated += restored
            return restored
        with self.cache._lock:
            scenes = {sc.serial: sc.dev
                      for sc in self.cache._scenes.values()}
        for serial, pi, pj in entries:
            with self.lock:
                if (serial, pi, pj) in self._slots:
                    continue        # a peer filled it
            dev = scenes.get(serial)
            if dev is None:
                continue            # stale: scene evicted since
            gh = -(-int(dev.shape[0]) // self.page_rows)
            gw = -(-int(dev.shape[1]) // self.page_cols)
            if pi >= gh or pj >= gw:
                continue            # stale: outside the scene's grid
            with self.lock:
                if not self._free and (serial, pi, pj) not in self._slots:
                    break   # full: never evict warmth just restored
                if self._stage_locked(dev, serial, pi, pj) is not None:
                    restored += 1
        with self.lock:
            self.rehydrated += restored
        return restored

    def audit(self) -> int:
        """Integrity audit: quarantine poisoned resident pages.  A slot
        is convicted by the on-device inf scan (`pool_inf_counts`) or,
        under ``GSKY_POOL_AUDIT=1``, by a CRC that differs from its
        stage-time one.  A quarantined page leaves the table at once (a
        later lookup misses and re-stages it); its slot is freed, or
        when pinned, freed by `unpin`.  Returns the pages
        quarantined."""
        with self.lock:
            if self._pool is None or not self._slots:
                return 0
            infs = pool_inf_counts(self._pool).cpu().numpy()
            host = self._pool.cpu().numpy() if self._checksums else None
            bad = []
            for key, slot in list(self._slots.items()):
                poisoned = bool(infs[slot] > 0)
                if not poisoned and host is not None:
                    want = self._checksums.get(key)
                    poisoned = want is not None and \
                        zlib.crc32(host[slot].tobytes()) != want
                if not poisoned:
                    continue
                bad.append(key)
                self._slots.pop(key)
                self._heat.pop(key, None)
                self._checksums.pop(key, None)
                if self._pins.get(slot):
                    self._quarantine_pins.add(slot)
                else:
                    self._free.append(slot)
            self.quarantined += len(bad)
            return len(bad)

    @property
    def allocated(self) -> bool:
        """Whether the pool's device tensor exists yet."""
        return self._pool is not None

    @contextlib.contextmanager
    def locked_pool(self):
        """The pool tensor to dispatch against, with staging locked out:
        enqueue the kernel call INSIDE the block."""
        with self.lock:
            self._ensure_pool()
            yield self._pool

    def handoff(self) -> int:
        """The staging generation, taken when a wave is assembled.  Read
        without the pool's lock, which a dispatch holds while it
        enqueues: assembly must not wait for the wave before it.  A
        teardown bumps the generation last, under the lock, so that
        `handoff_ok` sees any teardown after this read."""
        return self._handoff_gen

    def handoff_ok(self, gen: int) -> bool:
        """True while a `handoff` token is still dispatchable: the slot
        namespace is the one the wave's tables were built in (eviction
        cannot change it: the wave's slots stay pinned)."""
        with self.lock:
            return self._handoff_gen == int(gen)

    def stats(self):
        with self.lock:
            return {
                "capacity": self.capacity,
                "page_shape": [self.page_rows, self.page_cols],
                "resident": len(self._slots),
                "pinned": len(self._pins),
                "staged": self.staged,
                "hits": self.hits,
                "evictions": self.evictions,
                "declined": self.declined,
                "teardowns": self.teardowns,
                "trimmed": self.trimmed,
                "rehydrated": self.rehydrated,
                "quarantined": self.quarantined,
                "peer_filled": self.peer_filled,
                "pool_bytes": (self.capacity * self.page_rows
                               * self.page_cols * 4),
            }


def union_table(members, i0: int, i1: int, j0: int, j1: int):
    """One row-major table over the union page rect (i0..i1) x (j0..j1)
    from ``members``, each (slots, mi0, mi1, mj0, mj1): a lane's pinned
    table over its own rect.  Pages are content-keyed, so members that
    cover one page agree on its slot; positions no member covers keep
    slot 0, the null page.  No staging and no new pins."""
    nj = int(j1) - int(j0) + 1
    ni = int(i1) - int(i0) + 1
    out = np.zeros(ni * nj, np.int32)
    for slots, mi0, mi1, mj0, mj1 in members:
        row = np.asarray(slots, np.int32).reshape(-1)
        mnj = int(mj1) - int(mj0) + 1
        for pi in range(int(mi0), int(mi1) + 1):
            for pj in range(int(mj0), int(mj1) + 1):
                out[(pi - int(i0)) * nj + (pj - int(j0))] = \
                    row[(pi - int(mi0)) * mnj + (pj - int(mj0))]
    return out
