"""Quality of service (the port's copy of the JAX package's qos/):

  - `admission`: per-WorkKind priority classes consulted by
    `BeaconProcessor.submit`, slot-deadline stamping so an attestation that
    can no longer be attested is shed at pop time (counted `expired`, not
    `dropped`), and the `qos_shed_total{kind,reason}` family that accounts
    for every lost work item.
  - `ratelimit`: deterministic token buckets for the HTTP API and gossip
    ingest.
  - `breaker`: the closed/open/half-open circuit breaker that guards the
    device paths (the hybrid BLS router's, the tree-hash router's and the
    epoch vectors').

Importing this package imports every submodule, so the metrics registry
holds every family.
"""

from .admission import (  # noqa: F401
    ATTESTATION_PROPAGATION_SLOT_RANGE,
    AdmissionController,
    PriorityClass,
    SHED_TOTAL,
    count_shed,
)
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker  # noqa: F401
from .ratelimit import RateLimiter, TokenBucket  # noqa: F401
