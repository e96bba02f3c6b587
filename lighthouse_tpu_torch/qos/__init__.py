"""Quality of service: the circuit breaker that guards the device paths
(the hybrid BLS router's, the tree-hash router's and the epoch vectors').
The reference's admission control and rate limits come with the host-only
layers."""
