"""Per-member page pools and shard-aware scene staging.

Counterpart of `gsky_tpu/mesh/pools.py`.  Single-device serving uploads
every scene to the executor's device and stages pages into its one
`PagePool`.  Under per-member placement each mesh member owns a
`ChipPagePool` whose tensor lives on the member's device, and a scene
hashes by its serial to an owning member: the scene cache uploads it
there (`staging_device`) and the executor stages its pages into that
member's pool (`staging_pool`).  Wave groups key on the pool, so a
drained wave splits into per-member groups.  Each pool's journal lines
carry its member index (``chip``), so that warm recovery after an
incident on one member re-stages that member's own hot set
(`MeshPools.rehydrate_all`).

Placement is ``GSKY_MESH_PLACE=1`` on top of an enabled mesh
(`mesh.dispatch.mesh_enabled`).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from ..pipeline.pages import PagePool
from .dispatch import mesh_enabled


def place_enabled(device="cuda") -> bool:
    """GSKY_MESH_PLACE=1 on an enabled mesh for ``device``."""
    return os.environ.get("GSKY_MESH_PLACE", "0") == "1" \
        and mesh_enabled(device)


class ChipPagePool(PagePool):
    """A `PagePool` on one member's device, its journal lines tagged
    with the member index."""

    def __init__(self, device, chip: int, **kw):
        super().__init__(device=device, **kw)
        self.chip = int(chip)

    def stats(self):
        st = super().stats()
        st["chip"] = self.chip
        st["device"] = str(self.device)
        return st


class MeshPools:
    """One `ChipPagePool` per mesh member and the serial -> member
    hash.  The device guard tears down and rehydrates per member, so
    that one poisoned pool leaves its neighbours warm."""

    def __init__(self, devices: Optional[List] = None,
                 capacity: Optional[int] = None, device="cuda"):
        if devices is None:
            from ..parallel.mesh import make_mesh
            devices = make_mesh(device=device).members
        self.devices = list(devices)
        self.pools = [ChipPagePool(d, i, capacity=capacity)
                      for i, d in enumerate(self.devices)]
        from ..obs import tsan
        if tsan.enabled():
            tsan.track(self, "MeshPools")

    @property
    def n_chips(self) -> int:
        return len(self.pools)

    def chip_for(self, serial: int) -> int:
        """A scene's owning member: a pure function of its serial (which
        the journal records), so the assignment survives restarts."""
        return int(serial) % len(self.pools)

    def pool_for(self, serial: int) -> ChipPagePool:
        return self.pools[self.chip_for(serial)]

    def device_for(self, serial: int):
        return self.devices[self.chip_for(serial)]

    def pinned_total(self) -> int:
        return sum(p.stats()["pinned"] for p in self.pools)

    def teardown_chip(self, chip: int) -> None:
        """One member's incident response: journal its heat and drop
        only its pool; the other members keep serving warm."""
        self.pools[int(chip)].teardown()

    def rehydrate_all(self) -> Dict[int, int]:
        """Warm recovery across the mesh: replay the journal once and
        stage each page into the pool of the member that owned it (the
        hash owner for lines journaled without a tag), from the scenes
        resident in the live scene caches.  Returns {member: pages
        restored}."""
        from ..device_guard import journal
        from ..pipeline.scene_cache import live_caches
        entries, chips = journal.replay_chips()
        if not entries:
            return {}
        scenes = {}
        for cache in live_caches():
            with cache._lock:
                scenes.update((s.serial, s.dev)
                              for s in cache._scenes.values())
        restored: Dict[int, int] = {}
        for serial, pi, pj in entries:
            dev = scenes.get(serial)
            if dev is None:
                continue            # stale: the scene is gone
            chip = chips.get((serial, pi, pj), self.chip_for(serial))
            if not 0 <= chip < len(self.pools):
                continue
            pool = self.pools[chip]
            gh = -(-int(dev.shape[0]) // pool.page_rows)
            gw = -(-int(dev.shape[1]) // pool.page_cols)
            if pi >= gh or pj >= gw:
                continue            # stale: outside the scene's grid
            with pool.lock:
                if (serial, pi, pj) in pool._slots:
                    continue
                if not pool._free:
                    continue        # full: never evict restored warmth
                if pool._stage_locked(dev, serial, pi, pj) is not None:
                    restored[chip] = restored.get(chip, 0) + 1
        for chip, n in restored.items():
            with self.pools[chip].lock:
                self.pools[chip].rehydrated += n
        return restored

    def stats(self) -> Dict:
        return {"chips": len(self.pools),
                "placement": place_enabled(self.devices[0]),
                "pinned": self.pinned_total(),
                "pools": [p.stats() for p in self.pools]}


_default: Optional[MeshPools] = None
_default_lock = threading.Lock()


def default_mesh_pools(device="cuda") -> MeshPools:
    """The process's per-member pools over `mesh_devices(device)`."""
    global _default
    from ..parallel.mesh import mesh_devices
    members = mesh_devices(device)
    with _default_lock:
        if _default is None or _default.devices != members:
            _default = MeshPools(members)
        return _default


def active_mesh_pools() -> Optional[MeshPools]:
    """The live pools or None: a scrape allocates none."""
    return _default


def reset_mesh_pools():
    global _default
    with _default_lock:
        _default = None


def staging_pool(serial: int, device="cuda") -> Optional[PagePool]:
    """The owning member's pool for scene ``serial`` under placement,
    else None (the caller's own pool serves)."""
    if not place_enabled(device):
        return None
    return default_mesh_pools(device).pool_for(serial)


def staging_device(serial: int, device="cuda"):
    """The owning member's device for scene ``serial``'s upload under
    placement, else None (the cache's own device)."""
    if not place_enabled(device):
        return None
    return default_mesh_pools(device).device_for(serial)
