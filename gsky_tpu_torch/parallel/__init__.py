"""Multi-device parallelism: the device mesh and the sharded render and
drill steps over it.

Counterpart of `gsky_tpu/parallel/`.  The granule/time axis is data
parallel and the output width is sharded, the members' partials
combined by explicit collectives (`all_gather`, `pmin` / `pmax`,
`psum`) in member order; one process drives every member
(`parallel.mesh`), and `parallel.distributed` joins several processes
into one mesh over `torch.distributed`.
"""

from .mesh import Mesh, make_mesh, mesh_devices
from .render import (make_sharded_drill, make_sharded_render,
                     make_sharded_render_padded)
from .spmd import SpmdRenderer, default_spmd, spmd_enabled

__all__ = ["Mesh", "make_mesh", "mesh_devices", "make_sharded_render",
           "make_sharded_render_padded", "make_sharded_drill",
           "SpmdRenderer", "default_spmd", "spmd_enabled"]
