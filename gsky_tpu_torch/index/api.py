"""Loading crawler output into a MAS store.

Counterpart of `gsky_tpu/index/api.py::ingest_file` (the in-process MAS
of ``server.main -local_mas``); the HTTP MAS API is not ported.
"""

from __future__ import annotations

import gzip
import json

from .store import MASStore

_BATCH = 10_000       # records per ingest transaction


def ingest_file(store: MASStore, path: str) -> int:
    """Ingest a crawler output file, JSON lines or TSV
    (``path\\tgdal\\tjson``), gzipped when its name ends in ``.gz``.
    Returns the number of datasets indexed."""
    opener = gzip.open if path.endswith(".gz") else open
    n = 0
    batch = []
    with opener(path, "rt") as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if "\t" in line:
                parts = line.split("\t")
                rec = json.loads(parts[-1])
                rec.setdefault("filename", parts[0])
            else:
                rec = json.loads(line)
            batch.append(rec)
            if len(batch) >= _BATCH:
                n += store.ingest_many(batch)
                batch = []
    if batch:
        n += store.ingest_many(batch)
    return n
