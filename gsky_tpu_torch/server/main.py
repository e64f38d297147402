"""The port's OWS server on the command line.

    python -m gsky_tpu_torch.server.main -port 8080 -conf DIR \\
        [-local_mas FILE] [-device cpu] [-log_dir DIR] [-verbose] \\
        [-check_conf]

``-conf`` is the root of a config.json tree.  Without ``-local_mas``
each namespace reaches the masapi at its ``mas_address`` over HTTP
(``python -m gsky_tpu_torch.index.api``, or the reference's); with
``-local_mas FILE`` every namespace queries one in-process MAS over a
crawler output file (JSON lines or TSV) instead.  The server renders
on the CUDA card unless ``-device cpu`` is given, and raises without
one, behind the process-wide serving gateway (response cache and
single-flight), as the reference's.  Each request is one JSON record of
the metrics log: on stdout with ``-verbose``, in size-rotated gzip
files under ``-log_dir`` (`server.metrics.MetricsLogger`), else only
folded into ``/debug`` and ``/metrics``; the page-residency journal of
the device guard (`device_guard.journal`) lives under ``-log_dir`` too
(``GSKY_POOL_JOURNAL`` overrides).  Before the server listens, the
kernels its layers run are built, loaded and launched once
(`server.prewarm`; ``GSKY_PREWARM=0`` skips it).  ``GSKY_TSAN=1``
installs the lockset race sanitizer before any server lock exists.
Blocks of 1 MiB or more are mmapped, so that freed buffers leave the
process (`fix_mmap_threshold`).

SIGTERM or SIGINT drains the server before its listener closes
(`OWSServer.shutdown`): a new ``/ows`` request gets 503 ``ServerBusy``
with ``Retry-After``, the requests in flight finish (at most
``GSKY_DRAIN_TIMEOUT_S``, 30), the metrics log is flushed and the worker
clients closed; then the process exits 0.  A namespace with
``worker_nodes`` reaches its worker nodes (``python -m
gsky_tpu_torch.worker.server``) over gRPC.  The cache fabric's peer
replay comes from the environment as in the reference (no flag):
``GSKY_FABRIC=1`` with ``GSKY_FABRIC_SELF`` (this server's base URL)
and ``GSKY_FABRIC_PEERS`` (the other gateways') puts the server on the
replay ring (`fabric.replay`).  Counterpart of
`gsky_tpu/server/main.py`, without its static files.
"""

from __future__ import annotations

import argparse
import ctypes
import signal
import sys
import threading
import time

from ..device_guard import journal
from ..index.api import ingest_file
from ..index.client import MASClient
from ..index.store import MASStore
from ..obs import tsan
from .config import ConfigWatcher
from .metrics import MetricsLogger
from .ows import OWSServer
from .prewarm import prewarm_from_watcher


# glibc's mallopt parameter: blocks of at least this many bytes are
# mmapped (malloc.h)
_M_MMAP_THRESHOLD = -3


def fix_mmap_threshold(nbytes: int = 1 << 20) -> bool:
    """Have glibc's malloc serve every block of ``nbytes`` or more with
    mmap, so that it goes back to the OS when freed.  Left to itself,
    glibc raises that threshold to the largest block freed (up to 32
    MiB), and the tiles' and exports' buffers of a few MiB then come
    from per-thread arenas that keep what is freed: under the soak
    (`tools/soak_torch.py --scenario wcs`) the server's RSS grew by up
    to 355 MB a minute of exports on an H100 host, memory freed but
    held.  A process-wide setting, for the process that runs the
    server.  False where the C library has no ``mallopt`` (not
    glibc)."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    return bool(mallopt(_M_MMAP_THRESHOLD, int(nbytes)))


def main(argv=None) -> int:
    # GSKY_TSAN=1: patch threading.Lock/RLock before any server lock
    # exists, so that every lock takes part in the lockset tracking
    tsan.maybe_install()
    fix_mmap_threshold()
    ap = argparse.ArgumentParser(prog="gsky-ows-torch",
                                 description="GSKY OGC web server, "
                                             "PyTorch/CUDA port")
    ap.add_argument("-port", type=int, default=8080)
    ap.add_argument("-host", default="0.0.0.0")
    ap.add_argument("-conf", "-c", dest="conf", default=".",
                    help="config.json tree root")
    ap.add_argument("-local_mas", default="",
                    help="run an in-process MAS over this crawl TSV/JSON "
                         "file (without it, each namespace's mas_address "
                         "is reached over HTTP)")
    ap.add_argument("-device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("-log_dir", default="",
                    help="metrics log directory (default stdout with "
                         "-verbose, else none)")
    ap.add_argument("-verbose", "-v", action="store_true",
                    help="write the metrics log to stdout")
    ap.add_argument("-check_conf", action="store_true",
                    help="validate configuration and exit")
    args = ap.parse_args(argv)

    mas_factory = None
    if args.local_mas:
        store = MASStore()
        n = ingest_file(store, args.local_mas)
        print(f"in-process MAS: ingested {n} datasets from "
              f"{args.local_mas}")
        client = MASClient(store)

        def mas_factory(addr):
            return client

    try:
        watcher = ConfigWatcher(args.conf, mas_factory)
    except (ValueError, OSError) as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 1
    if args.check_conf:
        n = sum(len(c.layers) for c in watcher.configs.values())
        print(f"OK: {len(watcher.configs)} namespace(s), {n} layer(s)")
        return 0

    if args.log_dir:
        # the page-residency journal (warm pool recovery) lives beside
        # the metrics log; GSKY_POOL_JOURNAL still overrides
        journal.set_default_dir(args.log_dir)
    server = OWSServer(watcher, mas_factory, device=args.device,
                       metrics=MetricsLogger(args.log_dir,
                                             verbose=args.verbose))
    # every kernel the configured layers run, built, loaded and launched
    # before the listen socket opens (GSKY_PREWARM=0 skips)
    warm = prewarm_from_watcher(watcher, server.executor)
    if warm is not None:
        print(f"prewarm: {warm['programs']} program(s) for "
              f"{warm['specs']} layer spec(s) in {warm['seconds']}s "
              f"({warm['compiles']} fresh compile(s))", flush=True)
    httpd = server.serve(args.host, args.port)
    print(f"gsky-ows-torch listening on {args.host}:"
          f"{httpd.server_address[1]} ({server.device})", flush=True)

    # the drain on SIGTERM/SIGINT, with the listener still open: new
    # /ows requests get the draining 503 while those in flight finish
    drained = threading.Event()
    started = threading.Event()

    def _drain():
        t0 = time.monotonic()
        ok = server.shutdown()
        print(f"gsky-ows-torch drain {'complete' if ok else 'TIMED OUT'} "
              f"in {time.monotonic() - t0:.3f}s: {server.drain.stats()}",
              file=sys.stderr if not ok else sys.stdout, flush=True)
        drained.set()

    def _on_term(signum, frame):
        if not started.is_set():
            started.set()
            threading.Thread(target=_drain, daemon=True,
                             name="gsky-drain").start()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    try:
        while not drained.wait(0.5):
            pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.metrics.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
