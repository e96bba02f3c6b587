"""The device profile: what autotune learned about one device, on disk
(the port's copy of the JAX package's autotune/profile.py).

A profile is a versioned JSON document keyed by the device identity
(platform + device kind + device count), the torch version, and the
port's backend revision — any of those changing invalidates the learned
numbers, so a restarted process on the same device skips re-learning and
a profile the JAX package measured is refused (its revision is not this
build's).

Schema (version 1):

    {
      "schema_version": 1,
      "key": {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
              "num_devices": 1, "torch_version": "2.11.0+cu128",
              "backend_revision": "t1", "bls_backend": "torch",
              "mesh_shape": "single"},
      "source": "calibrate" | "bench" | "runtime",
      "created_unix": 1700000000.0,
      "host": {"single_set_ms": 577.0},            # optional host reference
      "msm_window": 4, "pipeline_depth": 4,        # optional tuned knobs
      "warmup_small_buckets": [[4, 1]],
      "tree_hash_buckets": [16384],
      "buckets": [
        {"n_sets": 64, "n_pks": 128, "samples": 8,
         "compile_secs": 30.2,                      # null when unmeasured
         "p50_ms": 14.0, "p99_ms": 19.0, "sets_per_sec": 4500.0}
      ]
    }

Everything here is stdlib-only except `current_device_key`, which reads
torch.cuda and is called only where initializing CUDA is acceptable (the
warm-up and detection threads).
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field

SCHEMA_VERSION = 1

# Bump when the port's kernel structure changes enough that measured
# compile/dispatch numbers stop transferring. Profiles keyed to another
# revision — an older one of the port, or any of the JAX package's
# ("r1".."r9") — are STALE: runtime.install_profile refuses them.
BACKEND_REVISION = "t1"

#: varying-base MSM window widths a profile may persist
#: (crypto/torchbls/msm.py ALLOWED_WINDOWS, duplicated here so the schema
#: module imports no torch)
ALLOWED_MSM_WINDOWS = (2, 4, 5, 6)


@dataclass
class BucketProfile:
    """Measured behavior of one (n_sets, n_pks) padding bucket."""

    n_sets: int
    n_pks: int
    samples: int = 0
    compile_secs: float | None = None
    p50_ms: float | None = None
    p99_ms: float | None = None
    sets_per_sec: float | None = None
    # per-stage program analytics (flops / bytes accessed) — optional,
    # absent on profiles measured without them
    programs: dict | None = None

    def to_json(self) -> dict:
        out = {
            "n_sets": int(self.n_sets),
            "n_pks": int(self.n_pks),
            "samples": int(self.samples),
            "compile_secs": self.compile_secs,
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "sets_per_sec": self.sets_per_sec,
        }
        if self.programs:
            out["programs"] = {
                str(stage): dict(stats)
                for stage, stats in self.programs.items()
            }
        return out

    @classmethod
    def from_json(cls, d: dict) -> "BucketProfile":
        programs = d.get("programs")
        if programs is not None and not isinstance(programs, dict):
            raise ValueError("bucket 'programs' must be an object")
        return cls(
            n_sets=int(d["n_sets"]),
            n_pks=int(d["n_pks"]),
            samples=int(d.get("samples", 0)),
            compile_secs=_opt_float(d.get("compile_secs")),
            p50_ms=_opt_float(d.get("p50_ms")),
            p99_ms=_opt_float(d.get("p99_ms")),
            sets_per_sec=_opt_float(d.get("sets_per_sec")),
            programs=dict(programs) if programs else None,
        )


@dataclass
class DeviceProfile:
    key: dict
    buckets: dict = field(default_factory=dict)  # (n_sets, n_pks) -> BucketProfile
    host: dict | None = None
    source: str = "unknown"
    created_unix: float | None = None
    # tuning fields: the calibrated varying-base MSM window width
    # (ALLOWED_MSM_WINDOWS; None = unmeasured, consumers fall back to the
    # default), the measured dispatch pipeline depth (None = planner
    # default), and the small/urgent (n_sets, n_pks) buckets bring-up
    # should warm IN ADDITION to the throughput-ordered warmup list
    msm_window: int | None = None
    pipeline_depth: int | None = None
    warmup_small_buckets: tuple | None = None
    # leaf-count buckets of the tree-hash ladder worth warming at
    # bring-up (the validator-registry scale this node's state roots
    # actually hit); None = unmeasured, the planner falls back to the
    # default registry-scale bucket
    tree_hash_buckets: tuple | None = None

    def key_string(self) -> str:
        """Stable, filesystem-safe identity string for file naming. The
        measured bls backend is part of the identity: a pure-python
        calibration must never land on (and clobber) the device profile
        autoload reads."""
        parts = [
            str(self.key.get("platform", "unknown")),
            str(self.key.get("device_kind", "unknown")),
            f"x{self.key.get('num_devices', 1)}",
            f"torch{self.key.get('torch_version', 'unknown')}",
            str(self.key.get("backend_revision", BACKEND_REVISION)),
            str(self.key.get("bls_backend", "torch")),
            # topology segment: a profile measured on a mesh must never
            # be autoloaded on one card — padding buckets and budgets
            # differ
            str(self.key.get("mesh_shape", "single")),
        ]
        return re.sub(r"[^A-Za-z0-9_.-]+", "-", "_".join(parts))

    @property
    def mesh_shape(self) -> str | None:
        """Canonical topology string the profile was measured on
        ("single", "sets8", "sets4-pks2"); None on profiles that never
        recorded one."""
        v = self.key.get("mesh_shape")
        return None if v is None else str(v)

    def mesh_mismatch(self, live_mesh_shape: str | None) -> bool:
        """True when this profile was calibrated on a DIFFERENT topology
        than `live_mesh_shape` — its buckets/budgets would misroute the
        live mesh (runtime.install_profile refuses such profiles, the
        same contract as the stale-revision check). Unknowable sides
        (no recorded topology, undetected live topology) never flag."""
        if self.mesh_shape is None or live_mesh_shape is None:
            return False
        return self.mesh_shape != str(live_mesh_shape)

    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "key": dict(self.key),
            "source": self.source,
            "created_unix": self.created_unix,
            "host": dict(self.host) if self.host else None,
            "msm_window": self.msm_window,
            "pipeline_depth": self.pipeline_depth,
            "warmup_small_buckets": (
                [[int(n), int(m)] for n, m in self.warmup_small_buckets]
                if self.warmup_small_buckets else None
            ),
            "tree_hash_buckets": (
                [int(n) for n in self.tree_hash_buckets]
                if self.tree_hash_buckets else None
            ),
            "buckets": [
                self.buckets[k].to_json() for k in sorted(self.buckets)
            ],
        }

    @classmethod
    def from_json(cls, d: dict) -> "DeviceProfile":
        version = d.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported autotune profile schema_version {version!r} "
                f"(this build reads {SCHEMA_VERSION})"
            )
        key = d.get("key")
        if not isinstance(key, dict):
            raise ValueError("autotune profile missing 'key' object")
        buckets = {}
        for b in d.get("buckets", []):
            try:
                bp = BucketProfile.from_json(b)
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                raise ValueError(
                    f"malformed autotune profile bucket entry {b!r}: "
                    f"{type(e).__name__}: {e}"
                ) from e
            buckets[(bp.n_sets, bp.n_pks)] = bp
        host = d.get("host")
        if host is not None and not isinstance(host, dict):
            raise ValueError("autotune profile 'host' must be an object")
        msm_window = d.get("msm_window")
        if msm_window is not None:
            msm_window = int(msm_window)
            # 0 is a valid MEASURED verdict ("the bit form won the sweep
            # on this device"), distinct from None ("unmeasured")
            if msm_window != 0 and msm_window not in ALLOWED_MSM_WINDOWS:
                raise ValueError(
                    f"autotune profile msm_window {msm_window!r} not 0 or "
                    f"in {ALLOWED_MSM_WINDOWS}"
                )
        pipeline_depth = d.get("pipeline_depth")
        if pipeline_depth is not None:
            pipeline_depth = int(pipeline_depth)
            if pipeline_depth < 1:
                raise ValueError(
                    f"autotune profile pipeline_depth {pipeline_depth!r} "
                    "must be >= 1"
                )
        small = d.get("warmup_small_buckets")
        if small is not None:
            try:
                small = tuple((int(n), int(m)) for n, m in small)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"malformed autotune profile warmup_small_buckets "
                    f"{small!r}: {type(e).__name__}: {e}"
                ) from e
        tree_hash = d.get("tree_hash_buckets")
        if tree_hash is not None:
            try:
                tree_hash = tuple(int(n) for n in tree_hash)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"malformed autotune profile tree_hash_buckets "
                    f"{tree_hash!r}: {type(e).__name__}: {e}"
                ) from e
            if any(n < 1 for n in tree_hash):
                raise ValueError(
                    f"autotune profile tree_hash_buckets {tree_hash!r} "
                    "must be positive leaf counts"
                )
        return cls(
            key=dict(key),
            buckets=buckets,
            host=dict(host) if host else None,
            source=str(d.get("source", "unknown")),
            created_unix=_opt_float(d.get("created_unix")),
            msm_window=msm_window,
            pipeline_depth=pipeline_depth,
            warmup_small_buckets=small,
            tree_hash_buckets=tree_hash,
        )

    def is_stale(self) -> bool:
        """True when the profile's measured backend revision is not THIS
        build's: the kernel structure its numbers were measured on no
        longer exists, so budgets/caps derived from it would misroute
        (runtime.install_profile refuses stale profiles)."""
        return str(self.key.get("backend_revision")) != BACKEND_REVISION


def _opt_float(v):
    return None if v is None else float(v)


# ------------------------------------------------------------- persistence


def profile_dir() -> str:
    """Directory the per-device profiles live in: build/autotune in the
    checkout (beside the built kernels), overridable via
    LIGHTHOUSE_TPU_AUTOTUNE_DIR."""
    env = os.environ.get("LIGHTHOUSE_TPU_AUTOTUNE_DIR")
    if env:
        return env
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "build", "autotune",
    )


def default_path(profile_or_key) -> str:
    """Canonical on-disk location for a profile (or a key dict)."""
    if isinstance(profile_or_key, DeviceProfile):
        key_string = profile_or_key.key_string()
    else:
        key_string = DeviceProfile(key=dict(profile_or_key)).key_string()
    return os.path.join(profile_dir(), f"{key_string}.json")


def save(profile: DeviceProfile, path: str | None = None) -> str:
    if profile.created_unix is None:
        profile.created_unix = time.time()
    path = path or default_path(profile)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(profile.to_json(), f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)  # atomic: a concurrent reader never sees a torn file
    return path


def load(path: str) -> DeviceProfile:
    with open(path) as f:
        return DeviceProfile.from_json(json.load(f))


# ------------------------------------------------------------- device key


def current_device_key(bls_backend: str = "torch") -> dict:
    """Identity of the attached card. Initializes CUDA — only call where
    that is acceptable (the warm-up and detection threads), never from an
    import or a constructor."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "platform": "gpu" if n else "none",
        "device_kind": torch.cuda.get_device_name(0) if n else "none",
        "num_devices": n,
        "torch_version": torch.__version__,
        "backend_revision": BACKEND_REVISION,
        "bls_backend": bls_backend,
        # the port serves one card: no mesh
        "mesh_shape": "single",
    }
