"""The port's OWS server on the command line.

    python -m gsky_tpu_torch.server.main -port 8080 -conf DIR \\
        [-local_mas FILE] [-device cpu] [-check_conf]

``-conf`` is the root of a config.json tree; ``-local_mas`` runs an
in-process MAS over a crawler output file (JSON lines or TSV), the
port's only MAS (there is no HTTP MAS client yet).  The server renders
on the CUDA card unless ``-device cpu`` is given, and raises without
one, behind the process-wide serving gateway (response cache and
single-flight), as the reference's.  Counterpart of
`gsky_tpu/server/main.py`, without its metrics log, prewarm and drain.
"""

from __future__ import annotations

import argparse
import sys

from ..index.api import ingest_file
from ..index.client import MASClient
from ..index.store import MASStore
from .config import ConfigWatcher
from .ows import OWSServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gsky-ows-torch",
                                 description="GSKY OGC web server, "
                                             "PyTorch/CUDA port")
    ap.add_argument("-port", type=int, default=8080)
    ap.add_argument("-host", default="0.0.0.0")
    ap.add_argument("-conf", "-c", dest="conf", default=".",
                    help="config.json tree root")
    ap.add_argument("-local_mas", default="",
                    help="run an in-process MAS over this crawl TSV/JSON "
                         "file")
    ap.add_argument("-device", default="cuda",
                    help="cuda (the default) or cpu")
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

    server = OWSServer(watcher, mas_factory, device=args.device)
    httpd = server.serve(args.host, args.port)
    print(f"gsky-ows-torch listening on {args.host}:"
          f"{httpd.server_address[1]} ({server.device})", flush=True)
    try:
        httpd.thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
