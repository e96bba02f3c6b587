"""Token-bucket rate limiting for the ingest edges (HTTP API, gossip).

The reference rate-limits its Req/Resp server per protocol
(lighthouse_network/src/rpc/rate_limiter.rs: one token bucket per protocol,
requests over quota answered with a busy error instead of queued) and
rate-limits backfill sync as a batch-per-epoch-fraction budget. Here the
same primitive guards the two unbounded producers feeding the beacon
processor: HTTP submission routes answer 429 with Retry-After, and gossip
ingest drops over-quota messages as IGNOREs before they reach the queues.

Buckets are continuous-refill (classic token bucket: `rate` tokens/sec up
to `burst`), with an injectable time source so tests — and the loadgen
fault injector — drive them deterministically.
"""

from __future__ import annotations

import math
import threading
import time

from ..utils.metrics import REGISTRY

RATE_LIMITED = REGISTRY.counter_vec(
    "qos_rate_limited_total",
    "requests or gossip messages refused by a QoS token bucket, by scope",
    ("scope",),
)


class TokenBucket:
    """`rate` tokens/second, capacity `burst`; starts full."""

    def __init__(self, rate: float, burst: float | None = None,
                 time_fn=time.monotonic):
        if rate < 0:
            raise ValueError("rate must be >= 0")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self._time = time_fn
        self._tokens = self.burst
        self._last = self._time()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        elapsed = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)

    def allow(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked(self._time())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if they already
        are). With rate 0 the deficit never refills; report a long hold."""
        with self._lock:
            self._refill_locked(self._time())
            deficit = n - self._tokens
            if deficit <= 0:
                return 0.0
            if self.rate <= 0:
                return 3600.0
            return deficit / self.rate


class RateLimiter:
    """Named token buckets. An unconfigured scope always allows — callers
    wire scopes explicitly (`--http-rate-limit`, `--gossip-ingest-rate`)
    and everything else stays untouched."""

    def __init__(self, time_fn=time.monotonic):
        self._time = time_fn
        self._buckets: dict[str, TokenBucket] = {}
        self._denied: dict[str, int] = {}
        self._lock = threading.Lock()

    def configure(self, scope: str, rate: float,
                  burst: float | None = None) -> "RateLimiter":
        with self._lock:
            self._buckets[scope] = TokenBucket(rate, burst, self._time)
        return self

    def allow(self, scope: str, n: float = 1.0) -> bool:
        bucket = self._buckets.get(scope)
        if bucket is None:
            return True
        if bucket.allow(n):
            return True
        with self._lock:
            self._denied[scope] = self._denied.get(scope, 0) + 1
        RATE_LIMITED.labels(scope).inc()
        return False

    def retry_after(self, scope: str, n: float = 1.0) -> float:
        bucket = self._buckets.get(scope)
        return 0.0 if bucket is None else bucket.retry_after(n)

    def retry_after_secs(self, scope: str) -> int:
        """Retry-After header value: whole seconds, at least 1."""
        return max(1, math.ceil(self.retry_after(scope)))

    def denied(self, scope: str) -> int:
        with self._lock:
            return self._denied.get(scope, 0)
