from .degrade import TooManyFailures, check_partial, degraded_reasons, \
    mark_degraded, max_failure_fraction, request_scope

__all__ = ["TooManyFailures", "check_partial", "degraded_reasons",
           "mark_degraded", "max_failure_fraction", "request_scope"]
