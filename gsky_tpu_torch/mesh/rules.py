"""Declarative partition rules: wave workload descriptor -> mesh layout.

Counterpart of `gsky_tpu/mesh/rules.py`, kept as it is: pure Python,
the same table, grammar and errors.

The wave scheduler groups a drained tick by (kind, statics, pool); the
mesh dispatcher renders each group as one line — the *descriptor* —
and walks an ordered regex table, first match wins (the
`match_partition_rules` shape from the LM sharding literature, applied
to serving workloads instead of parameter names).  No rule matching
means the replicated fallback: the group dispatches single-chip,
exactly as with the mesh disabled.

Descriptor grammar (stable, observable at `/debug` mesh block)::

    kind=byte   method=near n_ns=1 h=256  w=256  step=16 wave=12
    kind=scored method=near n_ns=2 h=96   w=96   step=16 wave=3
    kind=drill  bands=5 pixels=4096 pixel_count=0 wave=8

Layouts (semantics in mesh/dispatch.py):

- ``granule``    — the wave's granule-stacked page tables shard across
  every chip (one program spans the mesh; each chip mosaics its rows
  with the on-device priority reduction);
- ``x``          — output width shards across the mesh per entry (the
  4K+ WCS export-block layout: intra-tile parallelism over strips);
- ``time``       — the stacked drill reduction shards its wave/time
  axis across every chip;
- ``replicated`` — single-chip dispatch, byte-identical to GSKY_MESH=0.

Operators override the table with ``GSKY_MESH_RULES`` — semicolon-
separated ``regex=>layout`` pairs, evaluated before the built-ins.  A
malformed regex or an unknown layout raises `RuleError` at parse time
(startup / first wave), never silently at dispatch time.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence, Tuple

LAYOUTS = ("granule", "x", "time", "replicated")

# built-in table, least-specific last: drills ride the time layout,
# 4000px-or-wider byte/scored outputs (WCS export blocks) split the
# width, every other tile wave shards its stacked granule tables
_BUILTIN = (
    (r"kind=drill\b", "time"),
    (r"kind=(?:byte|scored|expr)\b.*\bw=(?:[4-9]\d{3}|\d{5,})\b", "x"),
    (r"kind=(?:byte|scored|expr)\b", "granule"),
)


class RuleError(ValueError):
    """A partition rule that cannot be honoured: bad regex, unknown
    layout, or a malformed ``GSKY_MESH_RULES`` entry."""


class Rule:
    """One compiled partition rule: `pattern` searched against the
    descriptor, `layout` the mesh layout it selects."""

    __slots__ = ("pattern", "layout", "source")

    def __init__(self, pattern: str, layout: str):
        try:
            self.pattern = re.compile(pattern)
        except re.error as exc:
            raise RuleError(
                f"invalid partition-rule regex {pattern!r}: {exc}") \
                from exc
        if layout not in LAYOUTS:
            raise RuleError(
                f"unknown mesh layout {layout!r} for rule {pattern!r} "
                f"(expected one of {LAYOUTS})")
        self.layout = layout
        self.source = pattern

    def __repr__(self):   # pragma: no cover - debugging aid
        return f"Rule({self.source!r} -> {self.layout})"


def builtin_rules() -> Tuple[Rule, ...]:
    return tuple(Rule(p, l) for p, l in _BUILTIN)


def parse_rules(spec: str) -> Tuple[Rule, ...]:
    """Parse a ``GSKY_MESH_RULES`` override: ``regex=>layout`` pairs
    joined by ``;``.  Empty entries are skipped; anything else
    malformed raises `RuleError`."""
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        head, sep, layout = part.rpartition("=>")
        if not sep:
            raise RuleError(
                f"malformed GSKY_MESH_RULES entry {part!r} "
                "(expected 'regex=>layout')")
        rules.append(Rule(head.strip(), layout.strip()))
    return tuple(rules)


def active_rules() -> Tuple[Rule, ...]:
    """The effective ordered table: operator overrides from
    ``GSKY_MESH_RULES`` first, then the built-ins (so an override can
    shadow, not just replace)."""
    return parse_rules(os.environ.get("GSKY_MESH_RULES", "")) \
        + builtin_rules()


def describe(kind: str, key: tuple, wave: int) -> str:
    """Render one wave group's identity as a descriptor line.  `key` is
    the scheduler's group key for `kind` (waves.py enqueue contract)."""
    if kind == "drill":
        # key = ((B, N), clip_lo, clip_hi, pixel_count)
        shape = key[0]
        return (f"kind=drill bands={int(shape[0])} "
                f"pixels={int(shape[1])} "
                f"pixel_count={int(bool(key[3]))} wave={int(wave)}")
    # byte / scored / expr: key = ((method, n_ns, (h, w), step[, auto,
    # colour_scale[, fp_key]]), id(pool))
    statics = key[0]
    method, n_ns, (h, w), step = statics[:4]
    line = (f"kind={kind} method={method} n_ns={int(n_ns)} "
            f"h={int(h)} w={int(w)} step={int(step)}")
    if kind == "expr":
        # the fingerprint keeps structurally distinct expressions in
        # distinct descriptors (and rule-targetable) without leaking
        # the source text
        from ..ops.expr import fingerprint_hash
        line += f" fp={fingerprint_hash(statics[6])}"
    return line + f" wave={int(wave)}"


def match_rules(descriptor: str,
                rules: Optional[Sequence[Rule]] = None) -> str:
    """First-match-wins walk of the rule table; unmatched descriptors
    get the ``replicated`` (single-chip) fallback."""
    for rule in (active_rules() if rules is None else rules):
        if rule.pattern.search(descriptor):
            return rule.layout
    return "replicated"
