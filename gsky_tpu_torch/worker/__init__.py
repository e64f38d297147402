"""The distributed worker boundary.

Counterpart of `gsky_tpu/worker/`: the worker node's RPC service
(`server.WorkerService`, ``python -m gsky_tpu_torch.worker.server``), a
supervised decode-subprocess pool, an OOM monitor and the client-side
fleet fan-out (`client.WorkerClient`).  The compute inside the boundary
is the node's executor on its card; the pool isolates codec IO crashes
as GSKY isolates GDAL (`worker/gdalprocess/`).  The RPC keeps the
reference's schema (`gskyrpc.proto`, encoded by the port's own codec,
`gskyrpc`, whose bytes are protobuf's) and carries it over gRPC as the
reference does: the service ``gskyrpc.GDAL``, method ``Process``
(`server.make_server`, `client.dial`), so that a port's OWS node can
call a reference worker and the other way round.
"""

from .client import ConcLimiter, NodeBusy, WorkerClient  # noqa: F401
from .oom import OOMMonitor  # noqa: F401
from .pool import PoolFullError, ProcessPool  # noqa: F401
from .server import WorkerService, make_server  # noqa: F401
