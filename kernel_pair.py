#!/usr/bin/env python3
"""Device times of kernels B1, B2 and B4 as built from several checkouts
of the port, in one process on one card, at the inputs the main paths of
``chip_smoke.py`` give them.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 kernel_pair.py build/parent [another checkout ...]

Each checkout's ``gsky_tpu_torch/csrc/warp_render.cu`` (B1, B2) and
``first_valid.cu`` (B4) is built with this checkout's nvcc flags, one
nvcc per source, all started together.  The inputs:

- B1: the operands of phase 3's first tile (four Landsat-size granules
  through the fused route), near, bilinear and cubic;
- B2: chip_smoke's `B2_INPUTS`, (a) that tile, (b) and (c) the first
  tiles at 2x and 4x the native ground resolution (what the decline leg
  gets), near, bilinear and cubic.  A checkout whose B2 reads a dense
  (B, WR, WC) stack (before the scene pointers) gets the four scenes
  stacked; the others get the cached scenes;
- B4: every (stack, valid) of the masked mosaic's main path (phase 10:
  32 tiles x 4 requests, 160 calls at T = 8), captured; the first and
  every 16th after it are timed, as chip_smoke.py times them.

The checkouts are timed in rounds, this one first and then the others,
and again in reverse order (A B C, C B A), each launch by
torch.profiler's kernel records (``chip_smoke.kernel_device_ms``, warm
L2).  B4's outputs are compared bit for bit with this checkout's; a
difference fails the run.  Prints the card's name and power limit, a
line per timing, and a JSON summary as the last line.  B1's and B2's
outputs are held to chip_smoke's tolerance instead (best equal, near
bit-exact, bilinear and cubic within 2 ulp).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
import time

import numpy as np

import chip_smoke as cs

ROUNDS = 2          # A B C then C B A


def kernels(root):
    """The B1/B2 and B4 libraries from checkout ``root``, whether its B1
    is the staged design and whether its B2 takes scene pointers."""
    from gsky_tpu_torch.ops import cuda_lib
    VP, CI, CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    csrc = os.path.join(os.path.abspath(root), "gsky_tpu_torch", "csrc")
    b1_src = os.path.join(csrc, "warp_render.cu")
    text = open(b1_src).read()
    staged = "stage_bytes" in text
    pointers = "ScenePtrs" in text
    # B1 takes a superblock row map (null here) after its counter
    sb = "sb_of" in text
    # the staged B1 takes (h, w, staging bytes, counter), the one-row
    # design before it took h * w; B2 takes a host array of scene
    # pointers and a device table where it took one dense stack
    b1_sig = [CI, CI] + [VP] * 7 + ([CI] * 8 + [VP] if staged else [CI] * 6) \
        + ([VP] if sb else [])
    b2_sig = [CI, CI] + [VP] * (7 if pointers else 6) + [CI] * 5
    b1 = cuda_lib.CudaLibrary(b1_src, {"launch_paged_render": b1_sig,
                                       "launch_warp_render": b2_sig})
    b4 = cuda_lib.CudaLibrary(os.path.join(csrc, "first_valid.cu"), {
        "launch_first_valid": [VP, VP, CI, CLL, VP, VP]})
    return b1, b4, staged, pointers, sb


def time_b2(pipe, root, native_box, libs, names, order, card):
    """B2 from every checkout at chip_smoke's `B2_INPUTS`, near, bilinear
    and cubic: outputs checked against this checkout's, then device times
    in rounds.  Returns {input: {method: {checkout: [ms per round]}}}."""
    import torch
    from gsky_tpu_torch.ops.paged import method_code
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    out_ms = {}
    for name, zoom in cs.B2_INPUTS:
        box = native_box if zoom is None else cs.zoom_boxes(zoom)[0]
        scenes, p16, sx, sy = cs.b2_operands(pipe, root, box)
        B = len(scenes)
        WR, WC = scenes[0].shape
        h, w = sx.shape
        ptrs = (ctypes.c_void_p * B)(*[s.data_ptr() for s in scenes])
        stack = torch.stack(scenes) if not all(l[3] for l in libs) else None
        for method in cs.METHODS:
            def launch(i, out):
                lib, _, _, pointers, _ = libs[i]
                scene_args = [ptrs, None] if pointers else [stack.data_ptr()]
                rc = lib.load().launch_warp_render(
                    method_code(method), 1, *scene_args, p16.data_ptr(),
                    sx.data_ptr(), sy.data_ptr(), out[0].data_ptr(),
                    out[1].data_ptr(), B, WR, WC, h, w, stream())
                if rc:
                    raise RuntimeError(f"B2 {names[i]}: CUDA error {rc}")
            outs = [[torch.empty((1, h, w), device=dev) for _ in range(2)]
                    for _ in libs]
            for i, out in enumerate(outs):
                launch(i, out)
            torch.cuda.synchronize()
            for i, out in enumerate(outs[1:], 1):
                cs.check_pair(method, *out, *outs[0],
                              f"B2 ({name}) {method} {names[i]} vs this")
            for i in order:
                ms = cs.kernel_device_ms(lambda: launch(i, outs[i]),
                                         "warp_render")
                out_ms.setdefault(name, {}).setdefault(method, {}) \
                    .setdefault(names[i], []).append(ms)
                cs.log(f"B2 ({name}) {method} {names[i]}: {ms:.5f} ms "
                       f"({card})")
        del stack
    return out_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_pair: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gsky_tpu_torch.ops import cuda_lib, paged
    from gsky_tpu_torch.ops.paged import method_code
    roots = [cs.ROOT] + sys.argv[1:]
    names = ["this"] + [os.path.relpath(r) for r in sys.argv[1:]]
    card = cs.card_facts()
    cs.log(f"card: {card}")
    t0 = time.perf_counter()
    libs = [kernels(r) for r in roots]
    cuda_lib.build_all([lib for b1, b4, _, _ in libs for lib in (b1, b4)])
    cs.log(f"built {len(libs)} checkouts in {time.perf_counter() - t0:.1f} s")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    order = [i for r in range(ROUNDS)
             for i in (range(len(roots)) if r % 2 == 0
                       else reversed(range(len(roots))))]
    summary = {"card": card, "checkouts": names}

    # -- B1 at phase 3's first tile --------------------------------------
    data_root = os.path.join(cs.ROOT, "build", "pair_archive")
    shutil.rmtree(data_root, ignore_errors=True)
    os.makedirs(data_root)
    try:
        store = cs.crawl((p, cs.NS) for p in cs.write_archive(data_root))
        pipe = cs.make_pipeline(store, "cuda")
        boxes = cs.tile_boxes()
        cs.render(pipe, data_root, boxes[:1], "near")   # scene cache warm
        _, tab, prm, sx, sy = cs.main_operands(pipe, data_root, boxes[0])
        direct = torch.zeros(1, dtype=torch.int32, device=dev)
        N, T, S = tab.shape
        h, w = sx.shape[1:]
        b1_ms = {}
        with pipe.executor.pool.locked_pool() as parr:
            _, pr, pc = parr.shape
            for method in cs.METHODS:
                def launch(i, out):
                    b1, _, staged, _, sb = libs[i]
                    head = [method_code(method), 1] + [
                        x.data_ptr() for x in (parr, tab, prm, sx, sy, *out)]
                    tail = [N, T, S, pr, pc] + (
                        [h, w, paged.STAGE_BUDGET, direct.data_ptr()]
                        if staged else [h * w]) + ([None] if sb else [])
                    rc = b1.load().launch_paged_render(*head, *tail, stream())
                    if rc:
                        raise RuntimeError(f"B1 {names[i]}: CUDA error {rc}")
                outs = [[torch.empty((N, 1, h, w), device=dev)
                         for _ in range(2)] for _ in roots]
                for i, out in enumerate(outs):
                    launch(i, out)
                torch.cuda.synchronize()
                for i, out in enumerate(outs[1:], 1):
                    cs.check_pair(method, *out, *outs[0],
                                  f"B1 {method} {names[i]} vs this")
                for i in order:
                    ms = cs.kernel_device_ms(
                        lambda: launch(i, outs[i]), "paged_render")
                    b1_ms.setdefault(method, {}).setdefault(
                        names[i], []).append(ms)
                    cs.log(f"B1 {method} {names[i]}: {ms:.5f} ms ({card})")
        summary["b1_ms"] = b1_ms
        summary["b2_ms"] = time_b2(pipe, data_root, boxes[0], libs, names,
                                   order, card)
        del pipe, store
    finally:
        shutil.rmtree(data_root, ignore_errors=True)

    # -- B4 at the masked mosaic's main-path inputs ------------------------
    mosaic_root = os.path.join(cs.ROOT, "build", "pair_mosaic")
    shutil.rmtree(mosaic_root, ignore_errors=True)
    os.makedirs(mosaic_root)
    try:
        from gsky_tpu_torch.pipeline.types import MaskSpec
        pipe = cs.make_pipeline(cs.mosaic_store(mosaic_root), "cuda")
        boxes = cs.mosaic_boxes()
        mask = MaskSpec(id="pixel_qa", bit_tests=list(cs.CLOUD_SHADOW))
        cap = cs.CaptureB4()
        try:
            for bands, method, style in cs.MOSAIC_REQS:
                cs.render_masked(pipe, mosaic_root, boxes, bands, method,
                                 mask, style)
        finally:
            cap.remove()
        inputs = cap.args[::cs.B4_TIMED_EVERY]
        cs.log(f"B4: {len(cap.args)} main-path calls captured, "
               f"{len(inputs)} timed, shapes "
               f"{sorted({tuple(s.shape) for s, _ in cap.args})}")
        b4_ms = {}
        for k, (stack, valid) in enumerate(inputs):
            Tn, H, W = stack.shape
            v8 = valid.view(torch.uint8)
            outs = [(torch.empty((H, W), device=dev),
                     torch.empty((H, W), dtype=torch.bool, device=dev))
                    for _ in roots]

            def launch(i):
                out, ok = outs[i]
                rc = libs[i][1].load().launch_first_valid(
                    stack.data_ptr(), v8.data_ptr(), Tn, H * W,
                    out.data_ptr(), ok.data_ptr(), stream())
                if rc:
                    raise RuntimeError(f"B4 {names[i]}: CUDA error {rc}")
            for i in range(len(roots)):
                launch(i)
            torch.cuda.synchronize()
            for i in range(1, len(roots)):
                cs.b4_same(outs[i], outs[0], f"B4 input {k} {names[i]}")
            for i in order:
                ms = cs.kernel_device_ms(lambda: launch(i),
                                         "first_valid_kernel")
                b4_ms.setdefault(names[i], []).append(ms)
            cs.log(f"B4 input {k} (call {k * cs.B4_TIMED_EVERY}): "
                   + ", ".join(f"{n} {np.mean(b4_ms[n][-ROUNDS:]):.5f}"
                               for n in names) + f" ms ({card})")
        summary["b4_inputs"] = len(inputs)
        summary["b4_ms"] = {n: v for n, v in b4_ms.items()}
        summary["b4_mean_ms"] = {n: float(np.mean(v))
                                 for n, v in b4_ms.items()}
        cs.log("B4 mean over inputs and rounds: " + ", ".join(
            f"{n} {summary['b4_mean_ms'][n]:.5f} ms" for n in names))
        del cap, inputs, pipe
    finally:
        shutil.rmtree(mosaic_root, ignore_errors=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
