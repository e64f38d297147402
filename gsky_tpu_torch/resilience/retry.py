"""Bounded retries with jittered exponential backoff.

Counterpart of `gsky_tpu/resilience/retry.py`.  Only retryable
failures are retried: transport errors (``ConnectionError``,
``TimeoutError``, ``OSError``) or an exception whose ``retryable``
attribute is true (an HTTP 5xx).  A backend that answered with a
semantic error (a 4xx) is not retried and counts as alive for its
breaker.  The delays are a pure function of the policy and an
injectable RNG.  Each retry and each exhaustion is counted in
`registry`.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from .breaker import BackendUnavailable, CircuitBreaker
from .deadline import Deadline, current_deadline
from .registry import registry

RETRYABLE_TYPES = (ConnectionError, TimeoutError, OSError)


def is_retryable(exc: BaseException) -> bool:
    flag = getattr(exc, "retryable", None)
    if flag is not None:
        return bool(flag)
    return isinstance(exc, RETRYABLE_TYPES)


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5        # +/- fraction of the nominal delay

    def delays(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """The sleeps between attempts (``max_attempts - 1`` of them):
        ``min(base * multiplier**k, max_delay) * (1 + jitter * u)``
        with ``u`` uniform in [-1, 1)."""
        r = rng if rng is not None else random
        for k in range(max(self.max_attempts - 1, 0)):
            d = min(self.base_delay * self.multiplier ** k, self.max_delay)
            if self.jitter > 0.0:
                d *= 1.0 + self.jitter * (2.0 * r.random() - 1.0)
            yield max(d, 0.0)


def call_with_retry(fn: Callable, policy: Optional[RetryPolicy] = None, *,
                    site: str = "backend",
                    breaker: Optional[CircuitBreaker] = None,
                    deadline: Optional[Deadline] = None,
                    retryable: Callable[[BaseException], bool] = is_retryable,
                    sleep: Callable[[float], None] = time.sleep,
                    rng: Optional[random.Random] = None):
    """Call ``fn()`` under the retry policy, breaker and deadline.

    Raises `BreakerOpen` without calling ``fn`` when the breaker
    rejects, re-raises a non-retryable error as it is, and wraps
    retryable exhaustion in `BackendUnavailable` (chained from the last
    failure)."""
    policy = policy or RetryPolicy()
    dl = deadline if deadline is not None else current_deadline()
    delays = list(policy.delays(rng))
    last: Optional[BaseException] = None
    attempts = 0
    for attempt in range(policy.max_attempts):
        if breaker is not None and not breaker.allow():
            raise breaker.open_error()
        attempts += 1
        try:
            result = fn()
        except Exception as e:
            if not retryable(e):
                # the backend answered: a semantic error must not count
                # toward opening its breaker
                if breaker is not None:
                    breaker.record_success()
                raise
            if breaker is not None:
                breaker.record_failure()
            last = e
            if attempt >= policy.max_attempts - 1:
                break
            delay = delays[attempt]
            if dl is not None and dl.remaining() <= delay:
                break
            registry.count_retry(site)
            sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            return result
    registry.count_exhausted(site)
    raise BackendUnavailable(
        f"{site} unavailable after {attempts} attempt(s): {last}",
        site=site) from last
