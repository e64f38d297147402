"""The decode subprocess: crash-isolated file IO for the worker node.

Counterpart of `gsky_tpu/worker/subproc.py`, in the role of GSKY's
`gsky-gdal-process` (`gdal-process/main.go`): a single-threaded accept
loop over a unix socket, one task per connection, with

- a per-task wall-clock timeout that hard-exits the process (`os.Exit(2)`
  after 120 s, `gdal-process/main.go:57-68`) so a wedged read can't hold
  a pool slot, and
- a planned exit after ``max_tasks`` tasks so codec/file-handle leaks are
  bounded (`worker/gdalprocess/process.go:154-159`).

Ops handled here are the IO-bound, crash-prone ones: ``decode`` (granule
window read), ``extent`` (open + suggested warp output size) and ``info``
(metadata extraction).  Device compute (warp, mosaic, drill reductions)
stays in the worker node's process, which owns the card.

The subprocess is host code only and never touches CUDA: its decode
runs with ``device="cpu"`` and nothing here asks ``torch.cuda`` for
anything, so a child holds no CUDA context (one per child would cost
each its share of card memory).  It is started with ``subprocess.Popen``
of ``python -m gsky_tpu_torch.worker.subproc``, never forked from a
process that may hold one.  It asks the kernel to SIGKILL it when its
parent dies (``prctl(PR_SET_PDEATHSIG)``, `process.go:63`), and exits
at once when the parent named by ``-parent`` is already gone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import signal
import socket
import sys
import traceback

from . import gskyrpc as pb
from .ipc import recv_task, send_msg
from .serialize import granule_from_pb, pack_raster

EXIT_TIMEOUT = 2
EXIT_RECYCLED = 3
EXIT_ORPHANED = 4
_PR_SET_PDEATHSIG = 1


def _do_decode(task: pb.Task) -> pb.Result:
    from ..geo.crs import parse_crs
    from ..geo.transform import GeoTransform
    from ..pipeline.decode import decode_window

    g = granule_from_pb(task.granule)
    d = task.dst
    dst_gt = GeoTransform.from_gdal(list(d.geo_transform))
    dst_bbox = dst_gt.bbox(d.width, d.height)
    dst_crs = parse_crs(d.srs)
    res = pb.Result()
    w = decode_window(g, dst_bbox, dst_crs, d.resample or "near",
                      dst_hw=(d.height, d.width), device="cpu")
    if w is None:
        return res
    data = w.data.numpy()
    pack_raster(res, data, w.valid.numpy())
    res.window_gt.extend(w.window_gt.to_gdal())
    res.src_srs = w.src_crs.name()
    res.metrics.bytes_read = data.nbytes
    return res


def _do_extent(task: pb.Task) -> pb.Result:
    from ..geo.crs import parse_crs
    from ..geo.transform import GeoTransform, suggest_output_size
    from ..io.geotiff import GeoTIFF
    from ..io.netcdf import NetCDF

    g = granule_from_pb(task.granule)
    res = pb.Result()
    if g.is_netcdf:
        h = NetCDF(g.path)
        try:
            v = h.variables.get(g.var_name)
            if v is None:
                res.error = f"no variable {g.var_name}"
                return res
            H, W = v.shape[-2], v.shape[-1]
        finally:
            h.close()
    else:
        h = GeoTIFF(g.path)
        try:
            H, W = h.height, h.width
        finally:
            h.close()
    src_gt = GeoTransform.from_gdal(g.geo_transform)
    src_crs = parse_crs(g.srs)
    dst_crs = parse_crs(task.dst.srs)
    _, sw, sh = suggest_output_size(src_gt, W, H, src_crs, dst_crs)
    res.extent_width = sw
    res.extent_height = sh
    return res


def _do_info(task: pb.Task) -> pb.Result:
    from ..index.crawler import extract

    res = pb.Result()
    res.info_json = json.dumps(extract(task.path, approx_stats=False))
    return res


_OPS = {"decode": _do_decode, "extent": _do_extent, "info": _do_info}


def handle(task: pb.Task) -> pb.Result:
    fn = _OPS.get(task.operation)
    if fn is None:
        return pb.Result(error=f"unknown operation {task.operation!r}")
    try:
        return fn(task)
    except Exception as e:  # failure -> error result, not a crash
        return pb.Result(error=f"{type(e).__name__}: {e}")


def serve(sock_path: str, max_tasks: int = 20000,
          task_timeout: float = 120.0) -> None:
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)

    def on_alarm(signum, frame):
        sys.stderr.write("task timeout, exiting\n")
        os._exit(EXIT_TIMEOUT)

    signal.signal(signal.SIGALRM, on_alarm)

    done = 0
    while True:
        conn, _ = srv.accept()
        try:
            task = recv_task(conn)
            timeout = task.timeout_s or task_timeout
            signal.setitimer(signal.ITIMER_REAL, timeout)
            try:
                res = handle(task)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
            send_msg(conn, res)
        except ConnectionError:
            pass
        except Exception:
            traceback.print_exc()
        finally:
            conn.close()
        done += 1
        if max_tasks and done >= max_tasks:
            os._exit(EXIT_RECYCLED)


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent dies; exit now when the
    parent is already gone (it died before the request took hold)."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:  # non-glibc platform: pdeathsig is a linux nicety
        pass
    if parent and os.getppid() != parent:
        os._exit(EXIT_ORPHANED)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gsky-decode-process")
    ap.add_argument("-sock", required=True)
    ap.add_argument("-max_tasks", type=int, default=20000)
    ap.add_argument("-timeout", type=float, default=120.0)
    ap.add_argument("-parent", type=int, default=0,
                    help="the worker node's pid: exit when it is gone")
    a = ap.parse_args(argv)
    _die_with_parent(a.parent)
    serve(a.sock, a.max_tasks, a.timeout)


if __name__ == "__main__":
    main()
