"""The worker RPC's carrier: HTTP/1.1 from the standard library.

The reference serves its worker over gRPC (`gsky_tpu/worker/server.py`'s
``make_grpc_server``, its client's channels and stubs).  The port keeps
the schema and the one method and changes only the carrier, because
neither ``grpc`` nor ``protobuf`` is a dependency of the port: the
messages are `gskyrpc`'s, byte for byte protobuf's, and one call is one
HTTP/1.1 request,

    POST /gskyrpc.GDAL/Process      (the reference's ``METHOD``)
    body: the Task's bytes          answer: 200, the Result's bytes

with keep-alive on both sides: the server keeps a connection open
between requests (an idle one closes after ``IDLE_S``), the client
keeps a small pool of them per node (`Channel`).  So a port's OWS node
cannot call a reference worker, nor the other way round.

gRPC's semantics map onto it so:

- ``UNAVAILABLE``: a refused, reset or closed connection (`RpcError`
  with ``code() == UNAVAILABLE``).  A request on a pooled connection
  that the server had closed while it sat idle is sent again once on a
  fresh one: that is not a failure of the node.
- ``DEADLINE_EXCEEDED``: the socket timeout, set from the call's
  timeout, lapsed.
- Cancellation: `RpcFuture.cancel` (a hedge's loser, the request's
  cancel token) shuts that call's connection down.  The server's
  ``ctx.is_active()`` (`CallContext`) is a non-blocking peek for EOF on
  the request's socket, so a handler polling it stops working for a
  client that has gone, as a gRPC handler does.
- ``max_msg``: a body over the cap is refused on both sides, as gRPC's
  ``RESOURCE_EXHAUSTED`` is: the client does not send a request over
  it, the server answers 413 to one and to an answer over it, and the
  client refuses an answer whose length is over it.
- ``max_workers``: one thread per connection reads requests (the
  standard library's threaded server), and at most `HANDLER_SLOTS` (32,
  the reference's gRPC executor size) of them run the service at once;
  the rest wait for a slot.
- The trace hop: a ``traceparent`` header carries `obs.traceparent`'s
  ``trace_id-span_id``, where the reference sends the same value as
  gRPC metadata.  The worker's spans come back in ``Result.info_json``,
  as in the reference.
"""

from __future__ import annotations

import contextlib
import http.client
import logging
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence, Tuple

from . import gskyrpc as pb

log = logging.getLogger("gsky.worker.transport")

SERVICE = "gskyrpc.GDAL"
METHOD = f"/{SERVICE}/Process"
CONTENT_TYPE = "application/x-protobuf"
TRACE_HEADER = "traceparent"
# seconds a server keeps an idle keep-alive connection
IDLE_S = 120.0
# idle connections a client keeps per node
POOL_SIZE = 8
# requests a server runs at once (the reference's ``max_workers``)
HANDLER_SLOTS = 32

# status codes, named as gRPC names them
UNAVAILABLE = "UNAVAILABLE"
DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"
CANCELLED = "CANCELLED"
UNIMPLEMENTED = "UNIMPLEMENTED"
INVALID_ARGUMENT = "INVALID_ARGUMENT"
INTERNAL = "INTERNAL"

_HTTP_CODE = {413: RESOURCE_EXHAUSTED, 404: UNIMPLEMENTED,
              400: INVALID_ARGUMENT}


class RpcError(Exception):
    """A failed call, with gRPC's status name (`code`)."""

    def __init__(self, code: str, details: str = ""):
        super().__init__(f"{code}: {details}" if details else code)
        self._code = code

    def code(self) -> str:
        return self._code


class FutureCancelledError(Exception):
    """The result of a call that was cancelled."""


def split_address(address: str) -> Tuple[str, int]:
    """("host", port) of ``host:port``, ``[v6]:port`` or an
    ``http://`` URL of one."""
    a = address.split("://", 1)[-1].rstrip("/")
    host, _, port = a.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"not a host:port address: {address!r}")
    return host.strip("[]"), int(port)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class CallContext:
    """What a handler knows of its call: the propagated trace context
    and whether its client is still there."""

    def __init__(self, sock: Optional[socket.socket] = None,
                 traceparent: Optional[str] = None):
        self._sock = sock
        self.traceparent = traceparent or None

    def is_active(self) -> bool:
        """False once the client has closed its connection: a peek of a
        readable socket reads ``b""`` (or fails).  Readability is polled
        first: a socket with a timeout waits in ``recv`` whatever its
        flags."""
        if self._sock is None:
            return True
        try:
            readable, _, _ = select.select([self._sock], [], [], 0)
            if not readable:
                return True
            data = self._sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
        except (BlockingIOError, InterruptedError):
            return True
        except (OSError, ValueError):
            return False
        return data != b""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    timeout = IDLE_S
    server: "RpcServer"

    def do_POST(self):
        if self.path.split("?", 1)[0] != METHOD:
            self._reply(404, f"no method {self.path}".encode(),
                        "text/plain")
            return
        try:
            n = int(self.headers.get("Content-Length", "-1"))
        except ValueError:
            n = -1
        cap = self.server.max_msg
        if n < 0:
            self.close_connection = True
            self._reply(411, b"Content-Length required", "text/plain")
            return
        if n > cap:
            # the body stays unread: the connection cannot be reused
            self.close_connection = True
            self._reply(413, (f"request of {n} bytes over the {cap}-byte "
                              f"cap").encode(), "text/plain")
            return
        with self.server.tracking():
            body = self.rfile.read(n)
            if len(body) != n:
                self.close_connection = True
                return
            try:
                task = pb.Task.FromString(body)
            except pb.DecodeError as e:
                self._reply(400, f"malformed Task: {e}".encode(),
                            "text/plain")
                return
            ctx = CallContext(self.connection,
                              self.headers.get(TRACE_HEADER))
            with self.server.slots:
                res = self.server.service.process(task, ctx)
            data = res.SerializeToString()
            if len(data) > cap:
                self._reply(413, (f"answer of {len(data)} bytes over the "
                                  f"{cap}-byte cap").encode(), "text/plain")
                return
            self._reply(200, data, CONTENT_TYPE)

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            # the client went away before its answer
            self.close_connection = True

    def log_message(self, fmt, *args):
        pass


class RpcServer(ThreadingHTTPServer):
    """The worker node's listener: `_Handler` over `service.process`."""

    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    def __init__(self, address: str, service, max_msg: int = 64 << 20):
        host, port = split_address(address)
        if ":" in host:
            self.address_family = socket.AF_INET6
        self.service = service
        self.max_msg = int(max_msg)
        self.slots = threading.BoundedSemaphore(HANDLER_SLOTS)
        self._thread: Optional[threading.Thread] = None
        self._active = 0
        self._idle = threading.Condition()
        super().__init__((host, port), _Handler)

    @contextlib.contextmanager
    def tracking(self):
        """One request from its body's read to its answer's write."""
        with self._idle:
            self._active += 1
        try:
            yield
        finally:
            with self._idle:
                self._active -= 1
                if self._active == 0:
                    self._idle.notify_all()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "RpcServer":
        self._thread = threading.Thread(
            target=self.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="gsky-worker-rpc")
        self._thread.start()
        return self

    def stop(self, grace: Optional[float] = 5.0) -> bool:
        """Stop accepting, wait up to ``grace`` seconds for the requests
        in flight to write their answers, then close the listener
        (idempotent).  False when a request outlived the grace."""
        if self._thread is not None:
            self.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        deadline = time.monotonic() + (grace or 0.0)
        with self._idle:
            while self._active > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._idle.wait(left)
            quiet = self._active == 0
        self.server_close()
        return quiet


def make_server(service, address: str = "0.0.0.0:11429",
                max_msg: int = 64 << 20) -> RpcServer:
    """The counterpart of the reference's ``make_grpc_server``: bound,
    not started (`RpcServer.start`).  Port 0 binds a free port
    (`RpcServer.port`)."""
    return RpcServer(address, service, max_msg=max_msg)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class _Call:
    """One call's connection, so that another thread can cancel it."""

    __slots__ = ("conn", "cancelled", "lock")

    def __init__(self):
        self.conn: Optional[http.client.HTTPConnection] = None
        self.cancelled = False
        self.lock = threading.Lock()

    def attach(self, conn) -> bool:
        with self.lock:
            if self.cancelled:
                return False
            self.conn = conn
            return True

    def abort(self) -> None:
        with self.lock:
            self.cancelled = True
            conn = self.conn
        if conn is not None:
            _shutdown(conn)


def _shutdown(conn: http.client.HTTPConnection) -> None:
    """Close a connection from any thread: a read blocked on it
    returns at once."""
    sock = conn.sock
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    try:
        conn.close()
    except Exception:  # closed twice from two threads
        pass


class Channel:
    """The connections to one node: an idle pool of at most `POOL_SIZE`
    keep-alive HTTP/1.1 connections, and the live ones."""

    def __init__(self, target: str, max_msg: int = 64 << 20):
        self.target = target
        self.host, self.port = split_address(target)
        self.max_msg = int(max_msg)
        self._idle: List[http.client.HTTPConnection] = []
        self._live: set = set()
        self._lock = threading.Lock()
        self._closed = False

    def _take(self, timeout: Optional[float]):
        with self._lock:
            if self._closed:
                raise RpcError(UNAVAILABLE, "channel closed")
            conn = self._idle.pop() if self._idle else None
            reused = conn is not None
            if conn is None:
                conn = http.client.HTTPConnection(self.host, self.port,
                                                  timeout=timeout)
            self._live.add(conn)
        if reused and conn.sock is not None:
            conn.sock.settimeout(timeout)
        conn.timeout = timeout
        return conn, reused

    def _give(self, conn, keep: bool) -> None:
        with self._lock:
            self._live.discard(conn)
            if keep and not self._closed \
                    and len(self._idle) < POOL_SIZE:
                self._idle.append(conn)
                return
        conn.close()

    def unary(self, data: bytes, timeout: Optional[float] = None,
              headers: Sequence[Tuple[str, str]] = (),
              call: Optional[_Call] = None) -> bytes:
        """One request: the answer's bytes, or `RpcError`."""
        if len(data) > self.max_msg:
            raise RpcError(RESOURCE_EXHAUSTED,
                           f"request of {len(data)} bytes over the "
                           f"{self.max_msg}-byte cap")
        hdrs = {"Content-Type": CONTENT_TYPE,
                "Content-Length": str(len(data))}
        for k, v in headers:
            hdrs[k] = v
        for attempt in (0, 1):
            conn, reused = self._take(timeout)
            if call is not None and not call.attach(conn):
                self._give(conn, False)
                raise RpcError(CANCELLED, "call cancelled")
            try:
                conn.request("POST", METHOD, body=data, headers=hdrs)
                resp = conn.getresponse()
                length = resp.getheader("Content-Length")
                if length is not None and int(length) > self.max_msg:
                    raise RpcError(RESOURCE_EXHAUSTED,
                                   f"answer of {length} bytes over the "
                                   f"{self.max_msg}-byte cap")
                body = resp.read()
            except RpcError:
                self._give(conn, False)
                raise
            except TimeoutError as e:
                self._give(conn, False)
                raise RpcError(DEADLINE_EXCEEDED, str(e) or "timed out")
            except (http.client.HTTPException, OSError) as e:
                self._give(conn, False)
                if call is not None and call.cancelled:
                    raise RpcError(CANCELLED, "call cancelled")
                stale = isinstance(e, (http.client.RemoteDisconnected,
                                       ConnectionResetError,
                                       BrokenPipeError))
                if reused and stale and attempt == 0:
                    continue       # the server closed it while idle
                raise RpcError(UNAVAILABLE,
                               f"{self.target}: {type(e).__name__}: {e}")
            self._give(conn, not resp.will_close)
            if resp.status == 200:
                return body
            raise RpcError(_HTTP_CODE.get(resp.status, INTERNAL),
                           f"{self.target}: HTTP {resp.status}: "
                           f"{body[:200].decode('utf-8', 'replace')}")
        raise RpcError(UNAVAILABLE, f"{self.target}: connection lost")

    def close(self) -> None:
        """Close every connection; calls in flight fail as
        ``UNAVAILABLE``, later ones at once."""
        with self._lock:
            self._closed = True
            conns = self._idle + list(self._live)
            self._idle = []
            self._live = set()
        for c in conns:
            _shutdown(c)


class RpcFuture:
    """A call running on its own thread: ``done``, ``cancel``,
    ``result`` and ``add_done_callback``, as `fleet.hedged_call` needs
    them.  A cancelled future is done at once and its `result` raises
    `FutureCancelledError`; its connection is shut down, which the
    server sees."""

    def __init__(self, channel: Channel, data: bytes,
                 timeout: Optional[float], headers, parse: Callable):
        self._channel = channel
        self._data = data
        self._timeout = timeout
        self._headers = headers
        self._parse = parse
        self._call = _Call()
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._callbacks: List[Callable] = []
        self._result = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False
        threading.Thread(target=self._run, daemon=True,
                         name="gsky-rpc-call").start()

    def _run(self) -> None:
        try:
            body = self._channel.unary(self._data, self._timeout,
                                       self._headers, self._call)
            res, exc = self._parse(body), None
        except BaseException as e:  # noqa: BLE001 - handed to result()
            res, exc = None, e
        with self._lock:
            if self._done.is_set():
                return             # cancelled meanwhile
            self._result, self._exc = res, exc
        self._finish()

    def _finish(self) -> None:
        with self._lock:
            self._done.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:
                log.exception("rpc future callback failed")

    def cancel(self) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._cancelled = True
        self._call.abort()
        self._finish()
        return True

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("rpc future not done")
        if self._cancelled:
            raise FutureCancelledError()
        if self._exc is not None:
            raise self._exc
        return self._result

    def add_done_callback(self, fn: Callable) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)


class Stub:
    """The method of one node: ``stub(task, timeout=, metadata=)`` and
    ``stub.future(...)``, as the reference's gRPC stubs are called; the
    answer a `gskyrpc.Result`.  ``metadata``: (key, value) pairs sent
    as request headers."""

    def __init__(self, channel: Channel):
        self.channel = channel

    def __call__(self, request, timeout: Optional[float] = None,
                 metadata=None) -> pb.Result:
        body = self.channel.unary(request.SerializeToString(), timeout,
                                  tuple(metadata or ()))
        return pb.Result.FromString(body)

    def future(self, request, timeout: Optional[float] = None,
               metadata=None) -> "RpcFuture":
        return RpcFuture(self.channel, request.SerializeToString(),
                         timeout, tuple(metadata or ()),
                         pb.Result.FromString)
