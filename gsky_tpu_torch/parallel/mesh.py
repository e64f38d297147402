"""The device mesh: a 2-D grid of `torch.device` members, and the
collectives its sharded steps combine with.

Counterpart of `gsky_tpu/parallel/mesh.py`.  Axes, as the reference's:

  * ``granule`` — data parallel over the time/granule stack;
  * ``x`` — spatial sharding over the output width.

The reference's mesh is single-controller: one process drives every
local chip through `shard_map`, with XLA collectives inside one
program.  The port keeps that shape: one process drives a list of
`torch.device` members.  `run_members` runs a body once per member,
each CUDA member on its own `torch.cuda.Stream` (which first waits for
the work already queued on its device's current stream), records an
event per member, and makes every member device's current stream wait
for all of them before it returns, so that an operand or a page the
bodies read cannot be reused or restaged under a running kernel.  The
collectives (`all_gather`, `pmin`, `pmax`, `psum`) are explicit: each
brings the members' partials to the output member's device
(``.to(device, non_blocking=True)`` after the producing stream's
event) and reduces them in member order.

Members come from `mesh_devices`: every visible CUDA device; N CPU
members under ``GSKY_CPU_DEVICES=N`` when the caller asks for the CPU
(the reference's virtual CPU mesh); or the explicit list of
``GSKY_MESH_DEVICES`` (``cuda:0,cuda:0,cuda:0,cuda:0``: four members
on one card, each on its own stream), the one-card counterpart of
``GSKY_CPU_DEVICES``.  A mesh whose members repeat a device is
*virtual*: it shows that every layout launches the kernels once per
member and combines them right, not what several cards would gain.
There is no fallback: CUDA members on a host without CUDA raise.
"""

from __future__ import annotations

import logging
import math
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

AXIS_GRANULE = "granule"
AXIS_X = "x"

log = logging.getLogger("gsky.mesh")
_logged: set = set()
_logged_lock = threading.Lock()


def _factor2(n: int) -> Tuple[int, int]:
    """Near-square factorisation n = a * b with a <= b."""
    a = int(math.isqrt(n))
    while a > 1 and n % a:
        a -= 1
    return a, n // a


def _cpu_count() -> int:
    try:
        return max(1, int(os.environ.get("GSKY_CPU_DEVICES", "1")))
    except ValueError:
        return 1


def mesh_devices(device="cuda") -> List[torch.device]:
    """The default mesh members for a caller on ``device``: the list of
    ``GSKY_MESH_DEVICES`` when set (its devices must be of the caller's
    type), else ``GSKY_CPU_DEVICES`` CPU members (default 1) for a CPU
    caller, else every visible CUDA device.  Raises where CUDA is asked
    for and absent."""
    want = resolve_device(device)
    spec = os.environ.get("GSKY_MESH_DEVICES", "").strip()
    if spec:
        devs = [resolve_device(s.strip()) for s in spec.split(",")
                if s.strip()]
        if any(d.type != want.type for d in devs):
            raise ValueError(f"GSKY_MESH_DEVICES={spec!r} does not match "
                             f"the caller's device {want}")
        devs = [torch.device("cuda", 0) if d.type == "cuda"
                and d.index is None else d for d in devs]
        with _logged_lock:
            if spec not in _logged:
                _logged.add(spec)
                log.info("mesh members from GSKY_MESH_DEVICES: %s%s",
                         ", ".join(map(str, devs)),
                         " (virtual: members share a device)"
                         if len(set(devs)) < len(devs) else "")
        return devs
    if want.type == "cpu":
        return [torch.device("cpu")] * _cpu_count()
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Mesh:
    """A 2-D (granule, x) grid of `torch.device` members.  ``devices``
    is the grid (an object array), ``shape`` maps each axis name to its
    size, ``members`` the flat member list, member (g, x) at g * nx +
    x.  ``dispatches`` counts, per member, the bodies `run_members` ran
    on it (each one kernel wrapper call)."""

    def __init__(self, grid: np.ndarray,
                 axis_names: Sequence[str] = (AXIS_GRANULE, AXIS_X)):
        if grid.ndim != 2:
            raise ValueError(f"a mesh is 2-D, got shape {grid.shape}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.members: List[torch.device] = list(grid.flat)
        self._streams: dict = {}
        self._lock = threading.Lock()
        self.dispatches = [0] * len(self.members)

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def virtual(self) -> bool:
        """Whether members share a device."""
        return len(set(self.members)) < len(self.members)

    @property
    def out_device(self) -> torch.device:
        """Where combined results land: the first member's device."""
        return self.members[0]

    def stream(self, i: int):
        """Member ``i``'s own CUDA stream (made on first use)."""
        with self._lock:
            s = self._streams.get(i)
            if s is None:
                s = self._streams[i] = torch.cuda.Stream(
                    device=self.members[i])
            return s

    def member_stats(self) -> List[int]:
        with self._lock:
            return list(self.dispatches)


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None,
              axis_names: Sequence[str] = (AXIS_GRANULE, AXIS_X),
              device="cuda") -> Mesh:
    """A 2-D (granule, x) mesh over the first ``n_devices`` of
    ``devices`` (default `mesh_devices(device)`).  ``shape`` overrides
    the near-square factorisation."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else mesh_devices(device)
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(
            f"need {n} mesh members, have {len(devs)} (set "
            f"GSKY_MESH_DEVICES, or GSKY_CPU_DEVICES={n} with CPU "
            f"members, for a virtual mesh)")
    if shape is None:
        shape = _factor2(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axis_names)


def _cuda_tensors(obj):
    if torch.is_tensor(obj):
        if obj.is_cuda:
            yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _cuda_tensors(o)


def run_members(mesh: Mesh, body: Callable):
    """Run ``body(i, device)`` for each member ``i``: returns (results,
    events), the member order kept.  A CUDA member's
    body runs on its own stream after that stream has waited for its
    device's current stream; its event marks the end of its work.  When
    every body is enqueued, every CUDA member device's current stream
    waits for every event, and the results are recorded as used on those
    streams."""
    results, events = [], []
    for i in range(mesh.size):
        dev = mesh.members[i]
        if dev.type == "cuda":
            s = mesh.stream(i)
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                r = body(i, dev)
            ev = torch.cuda.Event()
            ev.record(s)
        else:
            r, ev = body(i, dev), None
        results.append(r)
        events.append(ev)
        with mesh._lock:
            mesh.dispatches[i] += 1
    cuda_devs = {d for d in mesh.members if d.type == "cuda"}
    for d in cuda_devs:
        cur = torch.cuda.current_stream(d)
        for ev in events:
            if ev is not None:
                cur.wait_event(ev)
        for t in _cuda_tensors(results):
            if t.device == d:
                t.record_stream(cur)
    return results, events


def _arrive(t, device, event=None):
    """One partial on ``device``: after its producer's event, copied
    there (a no-op when it lies there already)."""
    if event is not None and device.type == "cuda":
        torch.cuda.current_stream(device).wait_event(event)
    return t.to(device, non_blocking=True)


def _arrivals(parts, device, events):
    events = events if events is not None else [None] * len(parts)
    return [_arrive(p, device, e) for p, e in zip(parts, events)]


def all_gather(parts, device, events=None) -> torch.Tensor:
    """The members' partials stacked on ``device`` in member order."""
    return torch.stack(_arrivals(parts, device, events))


def _fold(op, parts, device, events):
    got = _arrivals(parts, device, events)
    acc = got[0]
    for p in got[1:]:
        acc = op(acc, p)
    return acc


def pmin(parts, device, events=None) -> torch.Tensor:
    """Element-wise minimum of the partials, folded in member order."""
    return _fold(torch.minimum, parts, device, events)


def pmax(parts, device, events=None) -> torch.Tensor:
    """Element-wise maximum of the partials, folded in member order."""
    return _fold(torch.maximum, parts, device, events)


def psum(parts, device, events=None) -> torch.Tensor:
    """The partials' sum, added in member order: ((p0 + p1) + p2) ..."""
    return _fold(torch.add, parts, device, events)
