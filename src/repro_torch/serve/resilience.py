"""Service-level resilience primitives: admission control and failure
isolation for :class:`~repro_torch.serve.service.CoresetService` (port of
:mod:`repro.serve.resilience`, the same messages and state transitions).

The fault seam makes individual *builds* survive faults (retry-billed
transport, checkpointed resume, integrity quarantine); this module
protects the SERVICE from its tenants.  Three small, clock-driven state machines:

- :class:`TokenBucket` — per-tenant rate limiting.  A greedy tenant runs
  its bucket dry and gets shed; everyone else's buckets are untouched.
- :class:`CircuitBreaker` — per-tenant failure isolation.  Consecutive
  party-side failures (``PartyUnavailable`` exhaustion, ``IntegrityError``)
  open the breaker: subsequent requests shed instantly instead of burning
  a full retry ladder per call, and a half-open probe admits one trial
  request after a cooldown to detect recovery.
- :class:`ShedReceipt` — the refusal artifact.  The overload benchmark's
  invariant is *zero requests lost without a receipt*: every admitted
  request returns an Insert/Query receipt, every refused one returns a
  ShedReceipt naming the reason.

All time comes from the caller's :class:`~repro_torch.core.faults.Clock` seam
(the same seam ``Transport`` accrues simulated delay through), so every
state machine here is deterministic under ``SimClock`` — the tests drive
whole breaker lifecycles without sleeping.  Everything here is host
code: nothing touches the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: The closed set of refusal reasons a ShedReceipt may carry.
SHED_REASONS = (
    "deadline",       # expired at admission, or breached mid-op (rolled back)
    "rate_limit",     # tenant token bucket empty
    "queue_full",     # tenant pending-submit queue at max_pending
    "overloaded",     # global in-flight cap reached
    "breaker_open",   # tenant circuit breaker open
)


@dataclasses.dataclass(frozen=True)
class ShedReceipt:
    """A refused request.  ``reason`` is one of :data:`SHED_REASONS`;
    ``retry_after_s`` is the earliest useful retry (bucket refill time,
    breaker cooldown remainder) or 0.0 when unknowable."""

    tenant: str
    op: str                      # "insert" | "query" | "submit" | "flush"
    reason: str
    retry_after_s: float = 0.0
    latency_s: float = 0.0

    def __post_init__(self) -> None:
        if self.reason not in SHED_REASONS:
            raise ValueError(
                f"reason must be one of {SHED_REASONS}, got {self.reason!r}"
            )


class TokenBucket:
    """Standard token bucket on an injected clock: ``burst`` capacity,
    ``rate_per_s`` refill.  ``try_take`` is the admission check; on refusal
    it reports how long until a token exists."""

    def __init__(self, rate_per_s: float, burst: float) -> None:
        if not (isinstance(rate_per_s, (int, float)) and rate_per_s > 0):
            raise ValueError(
                f"rate_per_s must be a positive number, got {rate_per_s!r}"
            )
        if not (isinstance(burst, (int, float)) and burst >= 1):
            raise ValueError(f"burst must be >= 1, got {burst!r}")
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate_per_s
            )
        self._last = now

    def try_take(self, now: float) -> tuple[bool, float]:
        """``(admitted, retry_after_s)`` — consumes one token on success."""
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True, 0.0
        return False, (1.0 - self._tokens) / self.rate_per_s

    @property
    def tokens(self) -> float:
        return self._tokens


class CircuitBreaker:
    """closed -> open -> half-open, per tenant.

    ``record_failure`` counts CONSECUTIVE party-side failures; at
    ``threshold`` the breaker opens for ``cooldown_s`` (on the injected
    clock).  After cooldown, ``allow`` admits exactly one half-open probe:
    its success closes the breaker, its failure reopens it (and bumps
    ``trips`` again).  ``record_success`` in the closed state resets the
    consecutive count — intermittent failures never open a healthy tenant's
    breaker.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0) -> None:
        if not (isinstance(threshold, int) and threshold >= 1):
            raise ValueError(f"threshold must be an int >= 1, got {threshold!r}")
        if not (isinstance(cooldown_s, (int, float)) and cooldown_s > 0):
            raise ValueError(
                f"cooldown_s must be a positive number, got {cooldown_s!r}"
            )
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"            # "closed" | "open" | "half_open"
        self.failures = 0                # consecutive, in the closed state
        self.trips = 0
        self.last_error: Optional[str] = None
        self._opened_at: Optional[float] = None

    def allow(self, now: float) -> tuple[bool, float]:
        """``(admitted, retry_after_s)``.  Transitions open -> half_open
        when the cooldown has elapsed (the admitted request IS the probe)."""
        if self.state == "closed":
            return True, 0.0
        if self.state == "half_open":
            # one probe is already in flight; hold the line until it reports
            return False, self.cooldown_s
        elapsed = now - self._opened_at
        if elapsed >= self.cooldown_s:
            self.state = "half_open"
            return True, 0.0
        return False, self.cooldown_s - elapsed

    def record_success(self) -> None:
        if self.state == "half_open":
            self.state = "closed"
            self._opened_at = None
        self.failures = 0

    def record_neutral(self, now: float) -> None:
        """The admitted request aborted for a reason unrelated to party
        health (a deadline shed): a half-open probe returns to open —
        restarting the cooldown, but NOT counting a trip — so the next
        probe still fires.  No-op in other states."""
        if self.state == "half_open":
            self.state = "open"
            self._opened_at = now

    def record_failure(self, now: float, error: str) -> None:
        self.last_error = error
        if self.state == "half_open":
            # the probe failed: reopen immediately, restart the cooldown
            self.state = "open"
            self._opened_at = now
            self.trips += 1
            return
        self.failures += 1
        if self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self._opened_at = now
            self.trips += 1

    def stats(self) -> dict:
        return {
            "state": self.state,
            "failures": self.failures,
            "trips": self.trips,
            "last_error": self.last_error,
        }
