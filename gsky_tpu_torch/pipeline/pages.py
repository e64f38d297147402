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
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.paged import page_shape


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
        self.staged = 0
        self.hits = 0
        self.evictions = 0
        self.declined = 0
        # staging generation of the slot namespace (`handoff`): the
        # reference bumps it when a device incident tears the pool down;
        # the port has no teardown yet (ROADMAP A.10), so it stays 0
        self._handoff_gen = 0

    # -- internals (hold self.lock) -----------------------------------

    def _ensure_pool(self):
        if self._pool is None:
            # slot 0 (and every unstaged slot) is all-NaN
            self._pool = torch.full(
                (self.capacity, self.page_rows, self.page_cols),
                float("nan"), dtype=torch.float32, device=self.device)

    def _take_slot(self):
        if self._free:
            return self._free.pop()
        for key in self._slots:    # LRU order: oldest first
            slot = self._slots[key]
            if self._pins.get(slot):
                continue
            del self._slots[key]
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
            return slot
        slot = self._take_slot()
        if slot is None:
            return None
        self._ensure_pool()
        self._stage(dev, slot, int(pi), int(pj))
        self._slots[key] = slot
        self.staged += 1
        return slot

    # -- public --------------------------------------------------------

    def table_for(self, dev, serial: int, i0: int, i1: int,
                  j0: int, j1: int):
        """Stage pages (i0..i1) x (j0..j1) of scene ``dev`` and return
        their slots row-major as (npages,) int32, PINNED — or None when
        the pool cannot hold the request's working set (partial pins
        are rolled back).  The caller must `unpin` the returned slots
        once its dispatch is enqueued (or abandoned)."""
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

    def unpin(self, slots) -> None:
        """Release pins taken by `table_for` (once per returned table)."""
        with self.lock:
            for s in np.asarray(slots).reshape(-1).tolist():
                n = self._pins.get(int(s), 0) - 1
                if n > 0:
                    self._pins[int(s)] = n
                else:
                    self._pins.pop(int(s), None)

    @contextlib.contextmanager
    def locked_pool(self):
        """The pool tensor to dispatch against, with staging locked out:
        enqueue the kernel call INSIDE the block."""
        with self.lock:
            self._ensure_pool()
            yield self._pool

    def handoff(self) -> int:
        """The staging generation, taken when a wave is assembled."""
        with self.lock:
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
