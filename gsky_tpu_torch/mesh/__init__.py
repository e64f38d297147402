"""Multi-device mesh serving: the `parallel` package's sharded steps in
the request path.

Counterpart of `gsky_tpu/mesh/`:

- `rules` — the partition rules: a regex table from a wave group's
  descriptor (kind, statics, output shape) to a mesh layout, with a
  replicated (single-device) fallback;
- `pools` — per-member page pools and shard-aware scene staging;
- `dispatch` — the wave integration: a drained wave group spread over
  the members by its layout, and the ``GSKY_SPMD`` routes.

``GSKY_MESH=1`` turns mesh dispatch on inside the wave scheduler;
unset or 0 keeps single-device waves exactly.
"""

from .dispatch import (MeshDispatcher, active_mesh, compat_spmd,
                       default_mesh, mesh_enabled, mesh_stats, reset_mesh)
from .rules import Rule, RuleError, describe, match_rules, parse_rules

__all__ = [
    "MeshDispatcher", "Rule", "RuleError", "active_mesh", "compat_spmd",
    "default_mesh", "describe", "match_rules", "mesh_enabled",
    "mesh_stats", "parse_rules", "reset_mesh",
]
