"""Retry policy + failure classification for the serving layer.

The server distinguishes three failure classes when a dispatched request
raises:

  * **fatal** — already a ``ServeError`` (known tenant-visible surface:
    geometry mismatch, metric errors).  Fail the request as-is.
  * **transient** — flaky infrastructure: injected ``FaultError`` with
    ``transient=True``, OS/connection/timeout errors.  Worth a bounded
    exponential-backoff retry while the deadline allows.
  * **poison** — everything else at singleton granularity: the request
    deterministically breaks the step.  Quarantine its trace digest and
    reject with ``TRACE_REJECTED``.

``RetryPolicy`` is the bounded-backoff schedule; classification lives
here so the server, sweeper, and tests agree on it.

The port's own copy of ``repro/resilience/retry.py`` (standard library
only), kept verbatim so that both packages' servers classify a failure
alike.
"""
from __future__ import annotations

import dataclasses

from .faults import FaultError

__all__ = ["RetryPolicy", "is_transient"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff.

    ``max_attempts`` counts total tries (1 = no retry).  The delay before
    retry ``k`` (k = 1 for the first retry) is
    ``min(base_delay_s * multiplier**(k-1), max_delay_s)``.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.02
    multiplier: float = 2.0
    max_delay_s: float = 1.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return min(
            self.base_delay_s * self.multiplier ** max(attempt - 1, 0),
            self.max_delay_s,
        )


def is_transient(exc: BaseException) -> bool:
    """Whether a dispatch failure is worth retrying (vs poison)."""
    if isinstance(exc, FaultError):
        return exc.transient
    # OSError covers ConnectionError; TimeoutError is separate on 3.10
    return isinstance(exc, (OSError, TimeoutError))
