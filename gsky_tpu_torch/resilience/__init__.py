from .breaker import BackendUnavailable, BreakerOpen, CircuitBreaker, \
    get_breaker, reset_breakers
from .deadline import Deadline, DeadlineExceeded, clamp_timeout, \
    current_deadline, deadline_scope
from .degrade import TooManyFailures, check_partial, degraded_reasons, \
    mark_degraded, max_failure_fraction, request_scope
from .retry import RetryPolicy, call_with_retry, is_retryable

__all__ = ["BackendUnavailable", "BreakerOpen", "CircuitBreaker",
           "Deadline", "DeadlineExceeded", "RetryPolicy",
           "TooManyFailures", "call_with_retry", "check_partial",
           "clamp_timeout", "current_deadline", "deadline_scope",
           "degraded_reasons", "get_breaker", "is_retryable",
           "mark_degraded", "max_failure_fraction", "request_scope",
           "reset_breakers"]
