#!/usr/bin/env python3
"""Phase 23b's masked remote burst, end to end, in two checkouts on one
card: parent, this one, this one, parent.

    python3 tools/fleet_burst.py [--parent DIR] [--bursts 4]
        [--out FILE]

For each checkout, a child process started from that checkout's root
imports that checkout's own ``chip_smoke`` and, as its phase 23b does:

- builds the kernels (one ``nvcc`` per source, at once) and starts two
  worker nodes (``chip_smoke.Fleet``) with the environment phase 23
  runs under (``GSKY_WAVES=0``, ``GSKY_TILE_PIPELINE=0``,
  ``GSKY_PREFETCH=0``);
- writes and crawls phase 10's archive (``chip_smoke.mosaic_store``)
  under the checkout's ``build/fleet_burst/``, removed afterwards;
- serves the masked LC08_B4 layer from an OWS server whose ``fleet``
  namespace names the two workers, and takes the same server's local
  modular route's bytes for the first ``FLEET_TILES`` boxes;
- sends one warm-up burst, then ``--bursts`` bursts of those tiles from
  ``FLEET_THREADS`` threads through the ``fleet`` namespace, every
  answer equal to the local route's bytes (``chip_smoke.fleet_burst``),
  and logs the last burst's RPC split (``chip_smoke.rpc_split``).

Prints each child's log and one JSON line per run (tiles/s, tile p50
and p90 in ms, RPCs a tile and their mean in ms, by burst) and writes
them all to ``--out`` (``build/fleet_burst.json``).  The parent's worker
RPC is whatever that checkout carries it over: put a checkout of the
commit before the worker RPC moved to gRPC under a directory
``.gitignore`` lists (``git archive <commit> | tar -x -C build/parent``)
to time HTTP/1.1 against gRPC end to end.  Host clocks; needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, label: str, bursts: int) -> dict:
    """One run, in a process started from the checkout under test."""
    import numpy as np
    os.environ.update(GSKY_WAVES="0", GSKY_TILE_PIPELINE="0",
                      GSKY_PREFETCH="0")
    import chip_smoke as cs
    from gsky_tpu_torch.ops import cuda_lib, first_valid, stats, warp_render
    libs = [warp_render.LIBRARY, stats.LIBRARY, first_valid.LIBRARY]
    cuda_lib.build_all(libs)
    for lib in libs:
        lib.load()
    card = cs.card_facts()
    fleet = cs.Fleet()
    ready = fleet.start(2)
    work = os.path.join(root, "build", "fleet_burst")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"root": label, "card": card, "bursts": []}
    try:
        store = cs.mosaic_store(work)
        workers = ready()
        layer = {"name": "masked_b4", "data_source": work,
                 "rgb_products": ["LC08_B4"], "resample": "bilinear",
                 "mask": {"id": "pixel_qa", "bit_tests": cs.CLOUD_SHADOW},
                 "clip_value": 2000}
        dates = cs.mosaic_dates()
        t_range = (dates[0][1] - 86400.0, dates[-1][1] + 86400.0)
        boxes = cs.mosaic_boxes()[:cs.FLEET_TILES]
        server, httpd, base = cs.fleet_server(
            os.path.join(work, "conf"),
            {"": ([layer], []), "fleet": ([layer], workers)}, store)
        try:
            local = [cs.getmap_url(base, "masked_b4", b, "", t_range)
                     for b in boxes]
            remote = [u.replace("/ows?", "/ows/fleet?") for u in local]
            want = [cs.http_status(u)[2] for u in local]
            cs.fleet_burst(base, remote, cs.FLEET_THREADS, want, "warm-up")
            for i in range(bursts):
                r0 = cs.rpc_calls(base)
                secs, wall = cs.fleet_burst(base, remote, cs.FLEET_THREADS,
                                            want, f"burst {i}")
                n, s = (x - y for x, y in zip(cs.rpc_calls(base), r0))
                out["bursts"].append({
                    "tiles_per_s": len(secs) / wall,
                    "p50_ms": float(np.median(secs)) * 1e3,
                    "p90_ms": float(np.percentile(secs, 90)) * 1e3,
                    "rpcs_a_tile": n / len(secs),
                    "rpc_ms_mean": s / max(n, 1) * 1e3})
            cs.rpc_split(base, len(boxes), f"{label} masked", card)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
    finally:
        fleet.close()
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a parent checkout's root")
    ap.add_argument("--bursts", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "fleet_burst.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=HERE, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="change", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        sys.path.insert(0, a.root)
        print(json.dumps(child(a.root, a.label, a.bursts)), flush=True)
        return 0
    roots = [("change", HERE)]
    if a.parent:
        p = ("parent", os.path.abspath(a.parent))
        roots = [p, roots[0], roots[0], p]
    runs = []
    for label, root in roots:
        env = dict(os.environ, PYTHONPATH=root, PYTHONUNBUFFERED="1")
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--root", root, "--label", label, "--bursts", str(a.bursts)],
            cwd=root, env=env, capture_output=True, text=True, timeout=900)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-6000:])
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
