"""Page-residency journal: the durable half of warm pool recovery.

Counterpart of `gsky_tpu/device_guard/journal.py`, copied (it is pure
Python; the port imports nothing of the JAX package).  The device page
pool (`pipeline/pages.py`) is the state every serving optimisation
leans on, and a device incident throws it away.  This journal records
which pages were resident and how hot they were, so that a rebuilt
pool re-stages its working set from scenes still in the scene cache
instead of cold-starting into a miss storm.

One JSONL file (``GSKY_POOL_JOURNAL``; by default under the metrics
log directory when the server is given one, else the system temporary
directory), records appended atomically (O_APPEND, one line per event,
kept under PIPE_BUF), corrupt or newer-schema lines skipped on replay;
delete the file to forget everything.  ``GSKY_POOL_JOURNAL=0`` turns
journaling, and with it warm recovery, off.

Event schema (one JSON object per line)::

    {"v": 1, "op": "stage", "serial": 12, "pi": 0, "pj": 3,
     "ts": 1754000000.0, "pid": 42}
    {"v": 1, "op": "heat",  "serial": 12, "pi": 0, "pj": 3, "hits": 17, ...}
    {"v": 1, "op": "drop",  "serial": 12, ...}

``stage`` is appended when a page is first staged (the cold path only,
so the write rate follows decode churn, not the hit rate).  ``heat``
lines are written by ``PagePool.teardown()``: the supervisor tears the
pool down with the host process alive, so the exact hot set with its
in-memory hit counts is at hand.  ``drop`` voids every earlier event
of a scene serial (its pages can no longer be re-staged).

``replay()`` merges the log into a hottest-first page list; staleness
(a serial no longer resident in a scene cache) is the caller's check.
``replay_scored``, ``export_hot`` and ``merge_scored`` serve the elastic
fleet's hand-off (`fleet.elastic`) and the fabric's replication plan;
``replay_chips`` the mesh (ROADMAP A.11), as the reference has them.
Serials name a scene's content (`pipeline.scene_cache.content_serial`),
so a journal replays into any process that loads the same files.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

_ENV = "GSKY_POOL_JOURNAL"
_DEFAULT_NAME = "gsky_pool_journal.jsonl"

SCHEMA_VERSION = 1

_OPS = ("stage", "heat", "drop")

_lock = threading.Lock()
# set by the server from its metrics -log_dir; env always wins
_default_dir: Optional[str] = None


def set_default_dir(path: str) -> None:
    """Point the default journal location at the metrics log dir
    (called by server startup; GSKY_POOL_JOURNAL still overrides)."""
    global _default_dir
    _default_dir = path or None


def journal_enabled() -> bool:
    """``GSKY_POOL_JOURNAL=0`` disables journaling (and therefore warm
    recovery) without touching the rest of the device guard."""
    return os.environ.get(_ENV, "") != "0"


def journal_path() -> str:
    p = os.environ.get(_ENV)
    if p and p != "0":
        return p
    if _default_dir:
        return os.path.join(_default_dir, _DEFAULT_NAME)
    return os.path.join(tempfile.gettempdir(), _DEFAULT_NAME)


def _append(doc: Dict) -> None:
    """Append one event atomically.  Never raises — the journal is an
    optimisation; a lost line only costs one page of warmth."""
    try:
        doc = {"v": SCHEMA_VERSION, **doc,
               "ts": round(time.time(), 3), "pid": os.getpid()}
        data = (json.dumps(doc, separators=(",", ":")) + "\n").encode()
        if len(data) > 4096:    # PIPE_BUF floor: stay atomic or stay out
            return
        path = journal_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with _lock:
            fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                         0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
    except Exception:   # noqa: BLE001 - never fail staging over IO
        pass


def _chip_doc(doc: Dict, chip) -> Dict:
    """Mesh serving annotates events with the owning chip index; the
    field is additive — schema v1 `replay()` reads only the keys it
    knows, so journals mixing chip-tagged and untagged lines replay on
    either side of an upgrade."""
    if chip is not None:
        doc["chip"] = int(chip)
    return doc


def record_stage(serial: int, pi: int, pj: int, chip=None) -> None:
    if journal_enabled():
        _append(_chip_doc({"op": "stage", "serial": int(serial),
                           "pi": int(pi), "pj": int(pj)}, chip))


def record_heat(serial: int, pi: int, pj: int, hits: int,
                chip=None) -> None:
    if journal_enabled():
        _append(_chip_doc({"op": "heat", "serial": int(serial),
                           "pi": int(pi), "pj": int(pj),
                           "hits": int(hits)}, chip))


def record_drop(serial: int, chip=None) -> None:
    if journal_enabled():
        _append(_chip_doc({"op": "drop", "serial": int(serial)}, chip))


def replay(chip_map: Optional[Dict] = None,
           score_map: Optional[Dict] = None
           ) -> List[Tuple[int, int, int]]:
    """Merge the journal into a hottest-first ``[(serial, pi, pj)]``.
    ``chip_map`` (optional out-param) collects the per-chip ownership
    tags mesh serving appends — see :func:`replay_chips`.
    ``score_map`` (optional out-param) collects each page's merged
    heat score — see :func:`replay_scored`.

    Priority is (accumulated heat + stage count, recency): a page the
    pool dumped with 17 hits outranks a page staged once and never
    shared.  Corrupt lines, unknown ops, newer-schema lines, and events
    voided by a later ``drop`` are all skipped — a torn write or a
    stale file must never poison a rebuild.
    """
    if not journal_enabled():
        return []
    score: Dict[Tuple[int, int, int], float] = {}
    last: Dict[Tuple[int, int, int], int] = {}
    chips: Dict[Tuple[int, int, int], int] = {}
    try:
        with open(journal_path(), "r", encoding="utf-8",
                  errors="replace") as fp:
            for idx, line in enumerate(fp):
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(doc, dict):
                    continue
                v = doc.get("v", 1)
                if not isinstance(v, int) or v > SCHEMA_VERSION:
                    continue
                op = doc.get("op")
                if op not in _OPS:
                    continue
                try:
                    serial = int(doc["serial"])
                except (KeyError, TypeError, ValueError):
                    continue
                if op == "drop":
                    for k in [k for k in score if k[0] == serial]:
                        score.pop(k, None)
                        last.pop(k, None)
                    continue
                try:
                    key = (serial, int(doc["pi"]), int(doc["pj"]))
                except (KeyError, TypeError, ValueError):
                    continue
                if key[1] < 0 or key[2] < 0:
                    continue
                w = 1.0
                if op == "heat":
                    try:
                        w += max(0, int(doc.get("hits", 0)))
                    except (TypeError, ValueError):
                        pass
                score[key] = score.get(key, 0.0) + w
                last[key] = idx
                try:
                    chips[key] = int(doc["chip"])
                except (KeyError, TypeError, ValueError):
                    pass
    except OSError:
        return []
    if chip_map is not None:
        chip_map.update(chips)
    if score_map is not None:
        score_map.update(score)
    return sorted(score, key=lambda k: (-score[k], -last[k]))


def replay_scored() -> List[Tuple[int, int, int, float]]:
    """Heat export for the cache fabric (`fabric/replicate.py`):
    hottest-first ``[(serial, pi, pj, score)]`` where score is the
    merged heat+stage weight `replay()` orders by.  The absolute value
    only matters relative to the other pages in the same journal —
    popularity-weighted replication keys off the ranking and ratio."""
    scores: Dict[Tuple[int, int, int], float] = {}
    order = replay(score_map=scores)
    return [(s, pi, pj, scores[(s, pi, pj)]) for s, pi, pj in order]


def replay_chips() -> Tuple[List[Tuple[int, int, int]],
                            Dict[Tuple[int, int, int], int]]:
    """`replay()` plus the chip-ownership tags mesh serving journals:
    (hottest-first page list, {(serial, pi, pj): chip}).  Pages
    journaled without a chip tag are absent from the map —
    `MeshPools.rehydrate_all` hashes those to their owner."""
    chips: Dict[Tuple[int, int, int], int] = {}
    return replay(chip_map=chips), chips


def export_hot(limit: int = 2048) -> List[Tuple[int, int, int, float]]:
    """The handoff payload a preempted node ships to its ring successor
    (fleet/elastic): the hottest-first scored page list, capped so the
    notice fits one bounded RPC even after a long serving run."""
    return replay_scored()[:max(int(limit), 0)]


def merge_scored(entries, cap: int = 2048) -> int:
    """Fold a peer's exported heat (``[(serial, pi, pj, score)]``, the
    :func:`export_hot` shape) into THIS node's journal as ``heat``
    lines, so the inherited hot set survives a local restart and ranks
    against locally-observed heat on the next replay.  Malformed
    entries are skipped — the sender may be mid-crash.  Returns the
    number of entries merged."""
    n = 0
    for e in entries:
        if n >= cap:
            break
        try:
            s, pi, pj = int(e[0]), int(e[1]), int(e[2])
            score = float(e[3]) if len(e) > 3 else 1.0
        except (TypeError, ValueError, IndexError):
            continue
        if pi < 0 or pj < 0:
            continue
        # score already folds the peer's stage+heat weight; -1 undoes
        # the +1 replay() adds per line so replayed rank is preserved
        record_heat(s, pi, pj, max(int(score) - 1, 0))
        n += 1
    return n


def clear() -> None:
    """Forget the recorded residency (test hook / operator reset) —
    the delete-the-file knob, same as the kernel ledger."""
    try:
        os.remove(journal_path())
    except OSError:
        pass


def stats() -> Dict:
    path = journal_path()
    doc: Dict = {"path": path, "enabled": journal_enabled(),
                 "present": os.path.exists(path)}
    doc["entries"] = len(replay())
    return doc
