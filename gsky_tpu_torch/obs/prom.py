"""Dependency-free Prometheus instrumentation.

Counterpart of `gsky_tpu/obs/prom.py`: the same exposition text, byte
for byte, for the same operations.

Counters, gauges, and log-bucketed histograms with the 0.0.4 text
exposition format, plus scrape-time collector callbacks that lift the
codebase's existing stats objects (caches, fleet, resilience, encode
pool, compile probe) into gauge families — the live counters stay the
single source of truth, so ``/debug`` and ``/metrics`` cannot drift.

A strict ``parse_exposition`` lives here too: the tier-1 tests and the
parity tests round-trip ``/metrics`` through it, so a formatting
regression fails fast instead of silently breaking a real scraper.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float,
                per_decade: int = 3) -> Tuple[float, ...]:
    """Log-spaced bucket boundaries from ``lo`` to at least ``hi``.
    ``per_decade=3`` gives the classic 1-2-5 ladder."""
    if lo <= 0 or hi <= lo:
        raise ValueError("need 0 < lo < hi")
    steps = {3: (1.0, 2.0, 5.0), 2: (1.0, 3.0), 1: (1.0,)}.get(per_decade)
    if steps is None:
        steps = tuple(10 ** (i / per_decade) for i in range(per_decade))
    out: List[float] = []
    decade = 10.0 ** math.floor(math.log10(lo))
    while True:
        for s in steps:
            v = decade * s
            if v < lo * (1 - 1e-9):
                continue
            out.append(float(f"{v:.6g}"))
            if v >= hi * (1 - 1e-9):
                return tuple(out)
        decade *= 10.0


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels_text(labels: Sequence[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels)
    return "{" + body + "}"


class _Metric:
    mtype = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):  # noqa: A002
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _key(self, kwargs: Dict[str, str]) -> Tuple[str, ...]:
        if set(kwargs) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kwargs)}")
        return tuple(str(kwargs[ln]) for ln in self.labelnames)

    def labels(self, **kwargs):
        key = self._key(kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._child()
                self._children[key] = child
        return child

    def _child(self):
        raise NotImplementedError

    def _default_child(self):
        """The unlabelled child, for label-less metrics."""
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels")
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._child()
                self._children[()] = child
        return child

    def samples(self) -> List[Tuple[str, List[Tuple[str, str]], float]]:
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    mtype = "counter"

    def _child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def samples(self):
        with self._lock:
            items = list(self._children.items())
        return [(self.name, list(zip(self.labelnames, key)), c.value)
                for key, c in items]


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class Gauge(_Metric):
    mtype = "gauge"

    def _child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def samples(self):
        with self._lock:
            items = list(self._children.items())
        return [(self.name, list(zip(self.labelnames, key)), g.value)
                for key, g in items]


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * len(buckets)       # per-bucket, not cumulative
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    break


DEFAULT_BUCKETS = log_buckets(0.001, 60.0)


class Histogram(_Metric):
    mtype = "histogram"

    def __init__(self, name: str, help: str,  # noqa: A002
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bk = tuple(sorted(float(b) for b in buckets))
        if not bk or any(b <= 0 for b in bk if b != float("inf")):
            raise ValueError("buckets must be positive and non-empty")
        if bk and bk[-1] != float("inf"):
            bk = bk + (float("inf"),)
        self.buckets = bk

    def _child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def samples(self):
        with self._lock:
            items = list(self._children.items())
        out = []
        for key, h in items:
            base = list(zip(self.labelnames, key))
            with h._lock:
                counts = list(h.counts)
                total, ssum = h.count, h.sum
            cum = 0
            for b, n in zip(h.buckets, counts):
                cum += n
                out.append((self.name + "_bucket",
                            base + [("le", _fmt(b))], float(cum)))
            out.append((self.name + "_sum", list(base), ssum))
            out.append((self.name + "_count", list(base), float(total)))
        return out


# ---------------------------------------------------------------------------
# registry

# A collector callback returns families:
#   (name, type, help, [(labels_dict, value), ...])
CollectorFn = Callable[[], Iterable[
    Tuple[str, str, str, Iterable[Tuple[Dict[str, str], float]]]]]


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[CollectorFn] = []

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is not None:
                return have
            self._metrics[metric.name] = metric
        return metric

    def register_collector(self, fn: CollectorFn) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def counter(self, name, help, labelnames=()):  # noqa: A002
        return self.register(Counter(name, help, labelnames))

    def gauge(self, name, help, labelnames=()):  # noqa: A002
        return self.register(Gauge(name, help, labelnames))

    def histogram(self, name, help, labelnames=(),  # noqa: A002
                  buckets=DEFAULT_BUCKETS):
        return self.register(Histogram(name, help, labelnames, buckets))

    def render(self) -> str:
        """Text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        lines: List[str] = []
        seen: set = set()
        for m in sorted(metrics, key=lambda m: m.name):
            lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.mtype}")
            for name, labels, value in m.samples():
                lines.append(f"{name}{_labels_text(labels)} {_fmt(value)}")
            seen.add(m.name)
        for fn in collectors:
            try:
                families = list(fn())
            except Exception:  # one bad collector must not break the scrape
                continue
            for name, mtype, help_, samples in families:
                if name in seen or not _NAME_RE.match(name):
                    continue
                seen.add(name)
                lines.append(f"# HELP {name} {_escape(help_)}")
                lines.append(f"# TYPE {name} {mtype}")
                for labels, value in samples:
                    lt = _labels_text(sorted(labels.items()))
                    try:
                        lines.append(f"{name}{lt} {_fmt(float(value))}")
                    except (TypeError, ValueError):
                        continue
        return "\n".join(lines) + "\n"


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


def reset_registry() -> Registry:
    """Test hook: fresh default registry (module metric families keep
    pointing at the old one; tests build their own metrics)."""
    global _DEFAULT
    _DEFAULT = Registry()
    return _DEFAULT


# ---------------------------------------------------------------------------
# strict parser (shared by the tests and the chip smoke)

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                        # label body
    r"\s+(-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|\+?Inf|NaN))"
    r"(?:\s+-?[0-9]+)?$")                   # optional timestamp
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _base_name(name: str) -> str:
    for suf in ("_bucket", "_sum", "_count", "_total"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse Prometheus text exposition, strictly.

    Returns ``{family: {"type", "help", "samples": {(name, labels): v}}}``
    where ``labels`` is a sorted tuple of (k, v) pairs.  Raises
    ``ValueError`` on any malformed line, samples without a preceding
    TYPE, duplicate series, or histograms whose cumulative buckets are
    non-monotonic or whose ``+Inf`` bucket disagrees with ``_count``.
    """
    families: Dict[str, Dict[str, Any]] = {}
    typed: Dict[str, str] = {}
    for ln, raw in enumerate(text.split("\n"), 1):
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {ln}: malformed HELP: {line!r}")
            families.setdefault(parts[2], {"type": None, "help": None,
                                           "samples": {}})
            families[parts[2]]["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {ln}: malformed TYPE: {line!r}")
            if parts[3] not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                raise ValueError(f"line {ln}: unknown type {parts[3]!r}")
            if parts[2] in typed:
                raise ValueError(f"line {ln}: duplicate TYPE for {parts[2]}")
            typed[parts[2]] = parts[3]
            families.setdefault(parts[2], {"type": None, "help": None,
                                           "samples": {}})
            families[parts[2]]["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue                        # free comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        name, labelbody, value = m.group(1), m.group(2), m.group(3)
        base = _base_name(name)
        fam = base if base in typed else name
        if fam not in typed:
            raise ValueError(f"line {ln}: sample {name} without TYPE")
        labels: List[Tuple[str, str]] = []
        if labelbody:
            consumed = 0
            for lm in _LABEL_PAIR_RE.finditer(labelbody):
                labels.append((lm.group(1), lm.group(2)))
                consumed = lm.end()
                if consumed < len(labelbody):
                    if labelbody[consumed] != ",":
                        raise ValueError(
                            f"line {ln}: bad label separator: {line!r}")
                    consumed += 1
            if consumed < len(labelbody):
                raise ValueError(f"line {ln}: trailing label junk: {line!r}")
        key = (name, tuple(sorted(labels)))
        fam_d = families[fam]
        if key in fam_d["samples"]:
            raise ValueError(f"line {ln}: duplicate series {key}")
        if value in ("Inf", "+Inf"):
            v = float("inf")
        elif value == "NaN":
            v = float("nan")
        else:
            v = float(value)
        fam_d["samples"][key] = v

    # histogram invariants
    for fam, d in families.items():
        if d["type"] != "histogram":
            continue
        series: Dict[Tuple[Tuple[str, str], ...],
                     List[Tuple[float, float]]] = {}
        counts: Dict[Tuple[Tuple[str, str], ...], float] = {}
        for (name, labels), v in d["samples"].items():
            if name == fam + "_bucket":
                le = dict(labels).get("le")
                if le is None:
                    raise ValueError(f"{fam}: bucket without le")
                rest = tuple(kv for kv in labels if kv[0] != "le")
                bound = float("inf") if le in ("+Inf", "Inf") else float(le)
                series.setdefault(rest, []).append((bound, v))
            elif name == fam + "_count":
                counts[tuple(labels)] = v
        for rest, buckets in series.items():
            buckets.sort()
            cum = [n for _, n in buckets]
            if any(b > a for b, a in zip(cum, cum[1:])):
                raise ValueError(f"{fam}{dict(rest)}: non-monotonic buckets")
            if not buckets or buckets[-1][0] != float("inf"):
                raise ValueError(f"{fam}{dict(rest)}: missing +Inf bucket")
            if rest in counts and buckets[-1][1] != counts[rest]:
                raise ValueError(
                    f"{fam}{dict(rest)}: +Inf bucket != _count")
    return families
