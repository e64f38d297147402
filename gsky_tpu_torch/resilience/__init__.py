"""The resilience layer: retries, circuit breakers, deadline budgets,
cancellation, memory pressure, graceful degradation and deterministic
fault injection.  Counterpart of `gsky_tpu/resilience/`."""

from . import faults
from .breaker import BackendUnavailable, BreakerOpen, CircuitBreaker, \
    get_breaker, reset_breakers
from .cancel import CancelToken, RequestCancelled, cancel_scope, \
    cancel_stats, check_cancel, current_token, reset_cancel_stats
from .deadline import Deadline, DeadlineExceeded, clamp_timeout, \
    current_deadline, deadline_scope
from .degrade import RequestState, TooManyFailures, check_partial, \
    degraded_reasons, mark_degraded, max_failure_fraction, request_scope
from .faults import InjectedFault
from .pressure import PressureMonitor, brownout_level, default_monitor, \
    pressure_state, staging_allowed
from .registry import registry
from .retry import RetryPolicy, call_with_retry, is_retryable

__all__ = [
    "BackendUnavailable", "BreakerOpen", "CancelToken", "CircuitBreaker",
    "Deadline", "DeadlineExceeded", "InjectedFault", "PressureMonitor",
    "RequestCancelled", "RequestState", "RetryPolicy", "TooManyFailures",
    "brownout_level", "call_with_retry", "cancel_scope", "cancel_stats",
    "check_cancel", "check_partial", "clamp_timeout", "current_deadline",
    "current_token", "deadline_scope", "default_monitor",
    "degraded_reasons", "faults", "get_breaker", "is_retryable",
    "mark_degraded", "max_failure_fraction", "pressure_state", "registry",
    "request_scope", "reset", "reset_breakers", "reset_cancel_stats",
    "staging_allowed",
]


def reset() -> None:
    """Test hook: clear the counters, the shared breakers, the fault
    plan, the cancellation ledger, the pressure monitor and the device
    supervisor."""
    from .. import device_guard     # it imports this package
    registry.reset()
    reset_breakers()
    faults.reset()
    reset_cancel_stats()
    default_monitor().reset()
    device_guard.reset()
