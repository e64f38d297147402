from .degrade import TooManyFailures, check_partial, max_failure_fraction

__all__ = ["TooManyFailures", "check_partial", "max_failure_fraction"]
