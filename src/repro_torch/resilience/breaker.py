"""Per-key circuit breaker: shed doomed load instead of queueing it.

Classic three-state breaker, deliberately small:

  * **closed** — requests flow; ``failure_threshold`` *consecutive*
    hard failures trip it open.
  * **open** — ``allow()`` is False for ``cooldown_s``; callers shed with
    ``CIRCUIT_OPEN`` + ``retry_after_s`` instead of admitting work that
    will fail anyway.
  * **half-open** — after the cooldown one probe request is let through;
    its success closes the breaker, its failure re-opens it for another
    cooldown.

The clock is injectable so tests step time instead of sleeping.  The
server keys breakers by ``model/geometry`` — the unit that shares an
executable, and therefore a failure domain.

The port's own copy of ``repro/resilience/breaker.py`` (standard library
only), kept verbatim.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    __slots__ = ("failure_threshold", "cooldown_s", "_clock", "state",
                 "failures", "trips", "_open_until", "_probing")

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        cooldown_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.state = "closed"
        self.failures = 0           # consecutive hard failures
        self.trips = 0              # times the breaker opened
        self._open_until = 0.0
        self._probing = False

    def allow(self) -> bool:
        """Whether a new request may proceed (claims the half-open probe
        slot when the cooldown has elapsed)."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self._clock() < self._open_until:
                return False
            self.state = "half-open"
            self._probing = False
        # half-open: exactly one probe in flight at a time
        if self._probing:
            return False
        self._probing = True
        return True

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self._probing = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half-open" or self.failures >= self.failure_threshold:
            self.state = "open"
            self.trips += 1
            self._open_until = self._clock() + self.cooldown_s
            self._probing = False

    @property
    def retry_after_s(self) -> float:
        """Backoff hint while open (0 once the cooldown elapsed)."""
        return max(0.0, self._open_until - self._clock())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-clean state for ``ServerStats.breakers``."""
        return {
            "state": self.state,
            "failures": self.failures,
            "trips": self.trips,
            "retry_after_s": round(self.retry_after_s, 6),
        }
