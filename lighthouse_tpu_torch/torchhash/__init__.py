"""Device tree hashing and the epoch vectors on the card: the port of
lighthouse_tpu/jaxhash/.

  kernels.py        the hand-written CUDA kernels (csrc/sha256.cu: the
                    merkle ladder and multi-block digests; csrc/epoch.cu:
                    the epoch deltas), their wrappers, launch counters and
                    plain PyTorch versions
  engine.py         the ladder behind device_build_levels, in power-of-two
                    leaf buckets, dispatched through a PipelinedDispatcher
  epoch_vectors.py  vectorized epoch processing (flag/inactivity deltas on
                    the card, effective-balance hysteresis in numpy),
                    bit-exact vs the pure-Python spec path
  router.py         the hybrid route policy: hashlib below a size
                    threshold, the card above, breaker-guarded, counted in
                    `tree_hash_route_total{path,reason}`

Selection: set_hash_backend > LIGHTHOUSE_TPU_HASH_BACKEND > "device" (the
reference defaults to "host"; the port's entry points run on the card
unless the caller asks for the CPU: "host" asks for hashlib, and
engine.set_device("cpu") runs the kernels' plain versions).
"""

from .router import (  # noqa: F401
    ROUTER,
    hash_backend,
    set_hash_backend,
    start_warmup,
)

__all__ = ["ROUTER", "hash_backend", "set_hash_backend", "start_warmup"]
