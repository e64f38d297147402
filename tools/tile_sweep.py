#!/usr/bin/env python3
"""Sweep the output tiles of kernels B1 and B2 on one NVIDIA card, and
fit the wave planner's tile model to the sweep.

    python3 tools/tile_sweep.py [--parent OLD.cu] [--out SWEEP.json]
    python3 tools/tile_sweep.py --fit SWEEP.json

The sweep builds `gsky_tpu_torch/csrc/warp_render.cu` once per launch
bound (``GSKY_TILE_THREADS_MAX``: 256, the kernels' own, and 1024, the
card's limit) with ``nvcc -Xptxas -v`` and prints each kernel instance's
registers and spills; ``--parent`` builds another copy of the file with
the C interface it had before tiles were planned (no tile arguments:
8 x 32).  Over phase 3's archive it then runs `chip_smoke.py`'s phase 26a
(`chip_smoke.phase_tile_sweep`: outputs bit-identical across tiles and
to the plain versions, each tile's median device ms at 26a's points)
with each library in turn: the default tile alone in the order parent,
256, 1024, 1024, 256, parent, then every tile of a wide ladder the
bound admits at 256 and at 1024.  The rows (one per pass, point and
tile) go to ``--out`` as JSON.  Needs one card.

``--fit`` reads such a file and fits the constants of
`gsky_tpu_torch/pipeline/autoplan.py`'s `_block_cost` to its full-ladder
rows at bound 256 (non-negative least squares on relative error), then
prints them, the fit's error and, per point, the tile the fitted model
picks against the measured times; it runs on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LADDER = ("8x32,1x32,2x32,4x32,16x32,32x32,2x64,4x64,8x64,16x64,1x128,"
          "2x128,4x128,8x128,1x256,2x256,4x256,1x512,2x512,1x1024")
# the passes: (library, ladder); "parent" takes the default tile alone
PASSES = (("parent", "8x32"), ("256", "8x32"), ("1024", "8x32"),
          ("1024", "8x32"), ("256", "8x32"), ("parent", "8x32"),
          ("256", LADDER), ("1024", LADDER))


class NoTile:
    """A launch entry point of a library whose kernels take no tile: a
    call drops the trailing (rows, cols)."""

    def __init__(self, library, symbol):
        from gsky_tpu_torch.ops import cuda_lib
        self.kernel = cuda_lib.Kernel(library, symbol)
        self.launches = 0

    def __call__(self, device, *args):
        self.kernel(device, *args[:-2])


def build(src, flags, signatures):
    """``src`` built with ``flags`` and -Xptxas -v: its CudaLibrary,
    loaded, the registers and spills of each kernel instance, and nvcc's
    seconds."""
    from gsky_tpu_torch.ops import cuda_lib
    saved = list(cuda_lib.NVCC_FLAGS)
    cuda_lib.NVCC_FLAGS[:] = saved + flags
    try:
        lib = cuda_lib.CudaLibrary(src, signatures)
        out = lib.target()
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                            "-Xptxas", "-v", "-o", str(out), str(lib.src)],
                           capture_output=True, text=True, check=False)
        if r.returncode:
            raise RuntimeError(f"nvcc failed:\n{r.stderr[-4000:]}")
        secs = time.perf_counter() - t0
        lib.load()
    finally:
        cuda_lib.NVCC_FLAGS[:] = saved
    info, name = [], None
    for line in r.stderr.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"(paged_render|warp_render)ILi(\d)ELi(\d)E",
                          m.group(1))
            name = f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k \
                else None
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            info.append(f"{name} {m.group(1)} regs")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and m.group(1) != "0":
            info.append(f"{name} spills {m.group(1)}/{m.group(2)} B")
    return lib, info, secs


def sweep(args) -> int:
    import ctypes

    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA card", file=sys.stderr)
        return 2
    from gsky_tpu_torch.ops import cuda_lib, paged, warp_render
    from gsky_tpu_torch.pipeline import autoplan
    card = cs.card_facts()
    cs.log(f"card: {card}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    cuda_lib.build_all([warp_render.LIBRARY])
    sigs = warp_render.LIBRARY.signatures
    kernels = {}
    for bound in (256, 1024):
        lib, info, secs = build("warp_render.cu",
                                [f"-DGSKY_TILE_THREADS_MAX={bound}"], sigs)
        cs.log(f"bound {bound}: nvcc {secs:.1f} s; " + "; ".join(info))
        kernels[str(bound)] = (
            cuda_lib.Kernel(lib, "launch_paged_render"),
            cuda_lib.Kernel(lib, "launch_warp_render"))
    if args.parent:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        old = {"launch_paged_render": [ci, ci] + [vp] * 7 + [ci] * 8
               + [vp] * 2,
               "launch_warp_render": [ci, ci] + [vp] * 7 + [ci] * 5,
               "launch_empty": []}
        lib, info, secs = build(os.path.abspath(args.parent), [], old)
        cs.log(f"parent: nvcc {secs:.1f} s; " + "; ".join(info))
        kernels["parent"] = (NoTile(lib, "launch_paged_render"),
                             NoTile(lib, "launch_warp_render"))
    os.environ.update(GSKY_WAVES="0", GSKY_TILE_PIPELINE="0",
                      GSKY_PLAN="0")    # no tile held to the plan's slack
    root = os.path.join(ROOT, "build", "sweep_archive")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rows = []
    try:
        paths = cs.write_archive(root)
        store = cs.crawl((p, cs.NS) for p in paths)
        pipe = cs.make_pipeline(store, "cuda")
        cs.render(pipe, root, cs.tile_boxes()[:1], "near")
        points = cs.sweep_points(pipe, root)
        for k, (label, ladder) in enumerate(PASSES):
            if label not in kernels:
                continue
            paged.paged_render_kernel, warp_render.warp_render_kernel = \
                kernels[label]
            bound = 256 if label == "parent" else int(label)
            os.environ["GSKY_PLAN_BLOCKS"] = ",".join(
                t for t in ladder.split(",")
                if int(t.split("x")[0]) * int(t.split("x")[1]) <= bound)
            warp_render.MAX_TILE_THREADS = bound
            autoplan.reset_plan_state()
            t0 = time.perf_counter()
            for r in cs.phase_tile_sweep(pipe, root, card, points):
                rows.append(dict(r, lib=label, bound=bound, run=k))
            cs.log(f"pass {k} ({label}, {ladder[:20]}): "
                   f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump({"card": card, "rows": rows}, fp)
    cs.log(f"{len(rows)} rows -> {args.out}")
    return 0


def fit(path) -> int:
    import numpy as np
    from scipy.optimize import nnls
    from gsky_tpu_torch.pipeline import autoplan as ap
    with open(path) as fp:
        doc = json.load(fp)
    # the full-ladder pass at bound 256: its points swept at many tiles
    tiles = defaultdict(set)
    for r in doc["rows"]:
        tiles[(r.get("run"), r["bound"])].add(tuple(r["tile"]))
    rows = [r for r in doc["rows"] if r["bound"] == 256
            and r.get("lib", "256") == "256"
            and len(tiles[(r.get("run"), r["bound"])]) > 1
            and "sb_of" not in r["point"]]
    print(f"card: {doc['card']}; {len(rows)} rows")
    for kernel, keep in (("b1", [0, 1, 2, 3]), ("b2", [0, 1, 2, 4])):
        rs = [r for r in rows if r["kernel"].lower() == kernel]
        X = np.array([ap._features(kernel, r["h"], r["w"], r["T"],
                                   r["method"], *r["tile"], r["N"])
                      for r in rs])
        y = np.array([r["ms"] * 1e3 for r in rs])
        c, _ = nnls(X[:, keep] / y[:, None], np.ones(len(y)))
        coef = np.zeros(X.shape[1])
        coef[keep] = c
        err = (X @ coef - y) / y
        print(f"{kernel}: cost {tuple(round(float(v), 5) for v in coef)}; "
              f"relative error rms {float(np.sqrt(np.mean(err ** 2))):.4f},"
              f" max {float(np.abs(err).max()):.4f}")
        pts = defaultdict(list)
        for r, p in zip(rs, X @ coef):
            pts[(r["point"], r["method"])].append((tuple(r["tile"]), p,
                                                   r["ms"]))
        for (point, method), lst in pts.items():
            d = next(x for x in lst if x[0] == (8, 32))
            b = min(lst, key=lambda x: x[1])
            f = min(lst, key=lambda x: x[2])
            print(f"  {point} {method}: model's cheapest {b[0][0]}x"
                  f"{b[0][1]} at {b[1] / d[1]:.3f} of 8x32 (measured "
                  f"{b[2] / d[2]:.3f}); measured fastest {f[0][0]}x"
                  f"{f[0][1]} at {f[2] / d[2]:.3f}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "tile_sweep.json"))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--fit", default=None)
    args = ap.parse_args()
    return fit(args.fit) if args.fit else sweep(args)


if __name__ == "__main__":
    sys.exit(main())
