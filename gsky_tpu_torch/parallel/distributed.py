"""Multi-host runtime glue: one mesh over every process's devices.

Counterpart of `gsky_tpu/parallel/distributed.py`.  The reference brings
up `jax.distributed` and lays a global mesh over every process's
devices, process-major, so that the ``x`` axis (whose `pmin` / `pmax`
run every step) stays within a host and only the granule combine
crosses hosts.  Here the processes join one `torch.distributed` group
(``nccl`` for CUDA members, ``gloo`` for CPU ones), `global_mesh` lays
the same process-major grid over every rank's members, and
`gather_granules` is the granule combine across ranks: each rank's
partial (data, validity) gathered with `torch.distributed.all_gather`
and the first valid rank taken per pixel (rank order is priority
order).  Within a rank the mesh runs as `parallel.mesh` does.

Usage on each of N hosts::

    init_multihost("tcp://host0:29500", num_processes=N, process_id=i)
    mesh = global_mesh()
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import AXIS_GRANULE, AXIS_X, Mesh, mesh_devices


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device="cuda") -> None:
    """Join the process group: ``coordinator`` an init method
    (``tcp://host:port``), the world size and this rank; ``nccl`` for
    CUDA members, ``gloo`` for CPU ones.  Once per process."""
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def _ranks() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(shape: Optional[Tuple[int, int]] = None,
                device="cuda") -> Mesh:
    """The (granule, x) mesh over every rank's members, process-major:
    by default rank r is granule row r and its own members are the x
    axis.  Each entry is (rank, device); the members of this rank are
    the ones `run_members` may drive here.  Every rank has the same
    number of members (`mesh_devices(device)`)."""
    world, _ = _ranks()
    local = mesh_devices(device)
    per_host = max(1, len(local))
    n = world * per_host
    if shape is None:
        shape = (world, per_host)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    for r in range(world):
        for j, d in enumerate(local):
            grid[r * per_host + j] = (r, d)
    return Mesh(grid.reshape(shape), (AXIS_GRANULE, AXIS_X))


def local_members(mesh: Mesh) -> List[int]:
    """Indices of the mesh members this rank drives."""
    _, rank = _ranks()
    return [i for i, m in enumerate(mesh.members) if m[0] == rank]


def gather_granules(part: torch.Tensor, ok: torch.Tensor):
    """The granule combine across ranks: every rank's partial canvas
    ``part`` and its validity ``ok`` (one shape on every rank),
    gathered with `torch.distributed.all_gather`, and per pixel the
    first rank's valid value (rank order is priority order).  Returns
    (data, ok) on every rank."""
    world, _ = _ranks()
    if world == 1:
        return part, ok
    parts = [torch.empty_like(part) for _ in range(world)]
    oks = [torch.empty_like(ok, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(parts, part.contiguous())
    dist.all_gather(oks, ok.to(torch.uint8).contiguous())
    from .render import _combine_priority
    return _combine_priority(torch.stack(parts), torch.stack(oks) != 0)
