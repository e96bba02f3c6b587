"""Autotune: device profile + plan for the port's BLS pipeline (copies of
the JAX package's autotune modules, without its calibrator).

  - `profiler`  — per-bucket timing hooks around the torch dispatch
    (first-use time, dispatch latency, achieved sets/sec), exported
    through the process metrics registry AND kept in memory;
  - `profile`   — a versioned JSON device profile (keyed by device kind +
    torch version + the port's backend revision) under build/autotune;
  - `planner`   — pure, deterministic derivation of the serving knobs and
    a startup warmup plan from a profile;
  - `runtime`   — process-global installed profile/plan, disk autoload,
    plan listeners (the hybrid router's budgets, the dispatcher's depth),
    and the background warmup thread.

Import cost: this package and its submodules import only the stdlib and
`utils`; torch is imported inside the functions that need it, so
consulting the planner from constructors is cheap and never initializes
CUDA.
"""

from . import planner, profile, profiler, runtime  # noqa: F401

__all__ = ["planner", "profile", "profiler", "runtime"]
