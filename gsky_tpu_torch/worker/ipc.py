"""Length-prefixed RPC messages over a unix socket, between the worker
node and its decode subprocesses.

Counterpart of `gsky_tpu/worker/ipc.py` (the shape of GSKY's
`worker/gdalprocess/process.go:109-159` / `gdal-process/main.go:35-88`):
a 4-byte big-endian length prefix, one message each way, one connection
per task.  The messages are the port's codec's (`gskyrpc`).
"""

from __future__ import annotations

import socket
import struct

from . import gskyrpc as pb

_LEN = struct.Struct(">I")
MAX_MSG = 1 << 30


def send_msg(sock: socket.socket, msg) -> None:
    payload = msg.SerializeToString()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket, cls):
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_MSG:
        raise ConnectionError(f"oversized message ({n} bytes)")
    m = cls()
    m.ParseFromString(_recv_exact(sock, n))
    return m


def recv_task(sock: socket.socket) -> pb.Task:
    return _recv(sock, pb.Task)


def recv_result(sock: socket.socket) -> pb.Result:
    return _recv(sock, pb.Result)


def call_subprocess(sock_path: str, task: pb.Task,
                    timeout: float = 130.0) -> pb.Result:
    """One task round-trip: connect, send, receive, close."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(sock_path)
        send_msg(s, task)
        return recv_result(s)
    finally:
        s.close()
