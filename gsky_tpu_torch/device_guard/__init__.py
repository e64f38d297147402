"""The device guard: supervised dispatch and warm recovery.

Counterpart of `gsky_tpu/device_guard/`.  `supervisor` holds the state
machine, the watchdog and the classification of CUDA errors; `journal`
the page-residency log a rebuilt pool rehydrates from.
"""

from .supervisor import (  # noqa: F401
    DEAD,
    HEALTHY,
    REINITIALIZING,
    SUSPECT,
    STATE_NAMES,
    DeviceCorruption,
    DeviceDead,
    DeviceGuardError,
    DeviceHang,
    DeviceReinitializing,
    DeviceSupervisor,
    classify,
    default_supervisor,
    guard_enabled,
    guarded_readback,
    hang_deadline_s,
    integrity_check,
    pool_audit_enabled,
    register_oom_hook,
    reset,
    run,
    staging_ok,
    supervised_sync,
)
from . import journal  # noqa: F401
