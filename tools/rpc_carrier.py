#!/usr/bin/env python3
"""The worker RPC's carrier, timed: a checkout's own client against a
worker node started from that checkout, one tile warp an RPC.

    python3 tools/rpc_carrier.py [--parent DIR] [--rpcs 64]
        [--threads 1,16] [--device cuda] [--out FILE]

Writes one Landsat-size GeoTIFF (int16, 4096 x 4096 at 30 m,
EPSG:32755) under ``build/rpc_carrier/``.  For each checkout, in the
order parent, this one, this one, parent (this one alone without
``--parent``), a child process started from that checkout's root:

- starts ``python -m gsky_tpu_torch.worker.server -p 0 -n 2`` there
  (``GSKY_PREWARM=0``: a regular granule's warp is the executor's plain
  gather, no kernel) and waits for its "listening on" line;
- sends ``--rpcs`` warps of 256 x 256 native windows of the GeoTIFF
  (each answer 256 x 256 x 5 bytes: f32 data and a validity byte) from
  each of ``--threads`` client threads at once through
  `worker.client.WorkerClient.warp`, under a trace, after 8 warm-up
  RPCs;
- reads each RPC's spans: ``rpc.worker`` (the client's call),
  ``worker.warp`` (the node's whole op, adopted from the answer), and
  the carrier, their difference (the codec, the framing, the threads
  and the socket).

Prints one JSON line per run (medians and means in ms, RPCs/s) and
writes them all to ``--out`` (``build/rpc_carrier.json``).  The
parent's carrier is whatever that checkout carries the RPC over: put
a checkout of the commit before the worker RPC moved to gRPC under a
directory ``.gitignore`` lists (``git archive <commit> | tar -x -C
build/parent``) to time HTTP/1.1 against gRPC on one machine.  Host
clocks; the worker's device is ``--device``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 4096
TILE = 256
ORIGIN = (500000.0, 6200000.0)


def write_tif(path: str) -> None:
    import numpy as np
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.geotiff import write_geotiff
    rng = np.random.default_rng(21)
    data = rng.integers(0, 10000, (SIZE, SIZE)).astype(np.int16)
    data[:64, :64] = -999
    gt = GeoTransform(ORIGIN[0], 30.0, 0.0, ORIGIN[1], 0.0, -30.0)
    write_geotiff(path, data, gt, parse_crs("EPSG:32755"), nodata=-999,
                  compress=False)


def child(a) -> dict:
    """One run, in a process started from the checkout under test."""
    import numpy as np
    from gsky_tpu_torch import obs
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.pipeline.types import Granule
    from gsky_tpu_torch.worker.client import WorkerClient

    env = dict(os.environ, GSKY_PREWARM="0", PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsky_tpu_torch.worker.server", "-p", "0",
         "-host", "127.0.0.1", "-n", "2", "-oom_threshold", "0",
         "-device", a.device], cwd=a.root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = None
    seen = []
    for ln in proc.stdout:
        seen.append(ln)
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", ln)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        raise SystemExit("the worker did not start:\n" + "".join(seen))
    threading.Thread(target=lambda: [None for _ in proc.stdout],
                     daemon=True).start()
    g = Granule(path=a.tif, ds_name=a.tif, namespace="b1",
                base_namespace="b1", band=1, time_index=None,
                timestamp=0.0, srs="EPSG:32755",
                geo_transform=[ORIGIN[0], 30.0, 0.0, ORIGIN[1], 0.0, -30.0],
                nodata=-999.0, array_type="Int16")
    crs = parse_crs("EPSG:32755")
    n_side = SIZE // TILE

    def job(i):
        r, c = divmod(i % (n_side * n_side), n_side)
        return GeoTransform(ORIGIN[0] + c * TILE * 30.0, 30.0, 0.0,
                            ORIGIN[1] - r * TILE * 30.0, 0.0, -30.0)

    client = WorkerClient([f"127.0.0.1:{port}"])
    out = {"root": a.label, "threads": a.threads, "rpcs": a.rpcs,
           "answer_bytes": TILE * TILE * 5}
    try:
        for i in range(8):
            client.warp(g, job(i), crs, TILE, TILE, "near")
        spans = []
        lock = threading.Lock()
        go = threading.Event()

        def worker(k):
            go.wait(60)
            for i in range(k, a.rpcs, a.threads):
                with obs.start_trace("rpc_carrier") as tr:
                    got = client.warp(g, job(8 + i), crs, TILE, TILE,
                                      "near")
                if got is None or not np.asarray(got[1]).any():
                    raise AssertionError(f"an empty warp, RPC {i}")
                with lock:
                    spans.append(tr.span_dicts())

        with cf.ThreadPoolExecutor(a.threads) as ex:
            futs = [ex.submit(worker, k) for k in range(a.threads)]
            t0 = time.perf_counter()
            go.set()
            for f in futs:
                f.result()
            wall = time.perf_counter() - t0
    finally:
        client.close()
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
    rpc, warp = [], []
    for ss in spans:
        d = {s["name"]: s["dur_s"] * 1e3 for s in ss}
        if "rpc.worker" not in d or "worker.warp" not in d:
            raise AssertionError(f"a trace without the RPC's spans: {d}")
        rpc.append(d["rpc.worker"])
        warp.append(d["worker.warp"])
    rpc, warp = np.asarray(rpc), np.asarray(warp)
    carrier = rpc - warp
    out.update(rpc_ms_p50=float(np.median(rpc)),
               rpc_ms_mean=float(rpc.mean()),
               warp_ms_p50=float(np.median(warp)),
               carrier_ms_p50=float(np.median(carrier)),
               carrier_ms_mean=float(carrier.mean()),
               carrier_ms_p90=float(np.percentile(carrier, 90)),
               rpcs_per_s=a.rpcs / wall)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a parent checkout's root")
    ap.add_argument("--rpcs", type=int, default=64)
    ap.add_argument("--threads", default="1,16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "rpc_carrier.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=HERE, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="change", help=argparse.SUPPRESS)
    ap.add_argument("--tif", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    if a.child:
        a.threads = int(a.threads)
        print(json.dumps(child(a)), flush=True)
        return 0
    d = os.path.join(HERE, "build", "rpc_carrier")
    os.makedirs(d, exist_ok=True)
    tif = os.path.join(d, "landsat.tif")
    if not os.path.exists(tif):
        write_tif(tif)
    roots = [("change", HERE)]
    if a.parent:
        p = ("parent", os.path.abspath(a.parent))
        roots = [p, roots[0], roots[0], p]
    runs = []
    for label, root in roots:
        for th in a.threads.split(","):
            env = dict(os.environ, PYTHONPATH=root)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 "--root", root, "--label", label, "--tif", tif,
                 "--rpcs", str(a.rpcs), "--threads", th,
                 "--device", a.device], cwd=root, env=env,
                capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
                return 1
            runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
