"""Flight recorder — the always-on black box + incident dumper (the
port's copy of the JAX package's observability/flight_recorder.py).

Keeps a bounded ring of STRUCTURED events (breaker transitions, route
flips, deadline misses, shed bursts, every WARN+ log record via the
utils/logging observer sink), each stamped with wall time, a monotonic
timestamp (so it aligns with pipeline spans in the Perfetto export), the
current slot when a clock is bound, and the current trace id when one is
in flight.

Incident triggers — breaker open, SLO burn-rate over threshold, a
deadline-miss streak, cross-tenant device contention (observability/
slo.py drives the last three) — dump a snapshot to
`<incident_dir>/incident-NNNN-<reason>.json`: the recent event ring,
recent trace summaries, the SLO windows, the full metrics exposition, and
a config fingerprint. Triggers have HYSTERESIS: a reason that fired stays
disarmed until it is explicitly cleared (breaker closed, burn rate back
under threshold), so a breaker that stays open for an hour produces one
dump, not a dump storm. Dumps are additionally capped per process.

Recording an event is a lock + deque append; the snapshot work only runs
when an armed trigger fires.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from collections import deque
from time import perf_counter

from ..utils import logging as ltlog
from ..utils.metrics import REGISTRY
from .trace import TRACER, current_trace

#: incident dump schema identifier; validate_incident() checks against it
INCIDENT_SCHEMA = "lighthouse_tpu/incident/v1"

#: hard backstop on dumps per process — hysteresis is the real guard, this
#: bounds the blast radius of a trigger bug
MAX_INCIDENTS = 64

EVENTS_TOTAL = REGISTRY.counter_vec(
    "flight_recorder_events_total",
    "structured events recorded by the flight recorder, by event kind",
    ("kind",),
)
INCIDENTS_TOTAL = REGISTRY.counter_vec(
    "flight_recorder_incidents_total",
    "incident snapshots triggered, by trigger reason (counted even when "
    "no incident directory is configured to receive the dump)",
    ("reason",),
)


def config_fingerprint() -> dict:
    """Stable description of the running configuration: the LIGHTHOUSE_TPU_*
    environment, interpreter + argv, the active BLS and hash backends of
    the port, its topology ("single": one card), and the installed
    autotune profile key —
    plus a sha256 over the canonical JSON so two dumps can be compared at
    a glance. Best-effort by design (an incident dump must never fail on
    a half-initialized process)."""
    env = {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith("LIGHTHOUSE_TPU_")
    }
    out = {
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "env": env,
    }
    try:
        from ..crypto.bls import api as bls_api

        backend = bls_api._active_backend
        out["bls_backend"] = type(backend).__name__ if backend else None
    except Exception:
        out["bls_backend"] = None
    try:
        from ..autotune import runtime as at_runtime

        prof = at_runtime.active_profile()
        out["autotune_profile"] = None if prof is None else prof.key_string()
    except Exception:
        out["autotune_profile"] = None
    try:
        from ..torchhash.router import hash_backend

        out["hash_backend"] = hash_backend()
    except Exception:
        out["hash_backend"] = None
    # the port serves one card: the reference's mesh topology string
    out["mesh_topology"] = "single"
    out["sha256"] = hashlib.sha256(
        json.dumps(out, sort_keys=True).encode()
    ).hexdigest()
    return out


def validate_incident(doc: dict) -> list[str]:
    """Schema check for one incident dump; returns violations (empty =
    valid), so the dump format cannot silently drift."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["incident dump must be a JSON object"]
    if doc.get("schema") != INCIDENT_SCHEMA:
        errors.append(f"schema must be {INCIDENT_SCHEMA!r}")
    for key, typ in (
        ("reason", str), ("seq", int), ("ts", (int, float)),
        ("context", dict), ("events", list), ("recent_traces", list),
        ("slo", dict), ("metrics", str), ("config_fingerprint", dict),
    ):
        if key not in doc:
            errors.append(f"missing key {key!r}")
        elif not isinstance(doc[key], typ):
            errors.append(f"{key!r} must be {typ}")
    for i, ev in enumerate(doc.get("events", [])):
        if not isinstance(ev, dict) or "kind" not in ev or "ts" not in ev:
            errors.append(f"events[{i}] needs 'kind' and 'ts'")
            break
    fp = doc.get("config_fingerprint")
    if isinstance(fp, dict) and "sha256" not in fp:
        errors.append("config_fingerprint needs 'sha256'")
    return errors


_UNSET = object()


class FlightRecorder:
    """Bounded structured-event ring + armed incident triggers."""

    def __init__(self, ring_size: int = 512):
        self._lock = threading.Lock()
        self.ring: deque = deque(maxlen=ring_size)
        self.incident_dir: str | None = None
        self.clock = None                 # optional SlotClock for slot stamps
        self.slo_provider = None          # () -> slo snapshot dict for dumps
        self.events_recorded = 0
        # trigger hysteresis: reason -> armed. A missing key means armed.
        self._armed: dict[str, bool] = {}
        self._incident_seq = 0
        self.incidents_written: list[str] = []     # paths, bounded
        # last observed state per breaker name (health endpoint + events)
        self.breaker_states: dict[str, str] = {}
        # last observed route per scope (flip detection)
        self._last_route: dict[str, str] = {}

    # ------------------------------------------------------------ lifecycle

    def configure(self, incident_dir=_UNSET, clock=_UNSET,
                  slo_provider=_UNSET) -> None:
        """Point the recorder at a dump directory, a slot clock, and/or an
        SLO snapshot provider (the accountant whose windows belong in this
        run's dumps). Only explicitly passed fields change — a later
        `configure(clock=...)` must not detach the dump sink — and an
        explicit None DETACHES that field (a finished run must not
        leave its dead manual clock or private accountant wired in)."""
        with self._lock:
            if incident_dir is not _UNSET:
                self.incident_dir = incident_dir
            if clock is not _UNSET:
                self.clock = clock
            if slo_provider is not _UNSET:
                self.slo_provider = slo_provider

    def reset(self) -> None:
        """Drop all state (deterministic runs, tests). Counters on
        the global registry are cumulative by design and are not reset."""
        with self._lock:
            self.ring.clear()
            self.events_recorded = 0
            self._armed.clear()
            self._incident_seq = 0
            self.incidents_written.clear()
            self.breaker_states.clear()
            self._last_route.clear()
            self.incident_dir = None
            self.clock = None
            self.slo_provider = None

    # --------------------------------------------------------------- events

    def record(self, kind: str, severity: str = "info", **fields) -> dict:
        """Append one structured event; returns it. Cheap: no IO."""
        tr = current_trace()
        clock = self.clock
        slot = None
        if clock is not None:
            try:
                slot = clock.now()
            except Exception:
                slot = None
        ev = {
            "ts": time.time(),
            "t_mono": perf_counter(),
            "kind": kind,
            "severity": severity,
            "slot": slot,
            "trace_id": tr.trace_id if tr is not None else None,
            **fields,
        }
        with self._lock:
            self.ring.append(ev)
            self.events_recorded += 1
        EVENTS_TOTAL.labels(kind).inc()
        return ev

    def events(self, last: int = 128) -> list[dict]:
        with self._lock:
            return list(self.ring)[-last:]

    def perfetto_instants(self) -> list[tuple]:
        """(t_mono, name, args) markers for the Chrome-trace export — one
        instant per recorded event, on the dedicated flight-recorder lane."""
        out = []
        for ev in self.events(last=256):
            args = {
                k: v for k, v in ev.items()
                if k not in ("t_mono", "kind") and v is not None
            }
            out.append((ev["t_mono"], f"fr:{ev['kind']}", args))
        return out

    # ------------------------------------------------------------- triggers

    def trigger(self, reason: str, key: str | None = None, **context):
        """Fire an incident if `reason` (or the finer-grained `key`) is
        armed: record the event, count it, and — when an incident_dir is
        configured — dump the snapshot. Returns the dump path, or None
        (disarmed / no sink / cap reached). The trigger disarms itself;
        `clear()` re-arms when the triggering condition ends."""
        arm_key = key or reason
        with self._lock:
            if not self._armed.get(arm_key, True):
                return None
            self._armed[arm_key] = False
            self._incident_seq += 1
            seq = self._incident_seq
            out_dir = self.incident_dir
            capped = len(self.incidents_written) >= MAX_INCIDENTS
        INCIDENTS_TOTAL.labels(reason).inc()
        self.record("incident", severity="error", reason=reason, seq=seq,
                    **{k: str(v) for k, v in context.items() if k != "slo"})
        if out_dir is None or capped:
            return None
        doc = self.build_incident(reason, seq, context)
        path = os.path.join(out_dir, f"incident-{seq:04d}-{reason}.json")
        try:
            # crash-safe write: the process may die mid-episode, and a
            # torn dump would break the one artifact meant to explain it
            os.makedirs(out_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            return None     # a full disk must not take the node down too
        with self._lock:
            self.incidents_written.append(path)
        return path

    def clear(self, reason: str, key: str | None = None) -> None:
        """Re-arm a trigger: the condition that fired it has ended."""
        with self._lock:
            self._armed[key or reason] = True

    def build_incident(self, reason: str, seq: int, context: dict) -> dict:
        """The snapshot an operator diagnoses from: recent events + traces
        + SLO windows + metrics exposition + config fingerprint."""
        from . import slo as _slo             # lazy: slo imports this module

        # the triggering accountant may hand its own windows in via
        # context["slo"] (a private accountant's) — as a dict,
        # or as a CALLABLE evaluated only here, i.e. only when the trigger
        # actually fired (a held-down trigger must not build a snapshot
        # per slot just to discard it). It lands in the dedicated "slo"
        # key, not duplicated inside "context". A configured slo_provider
        # covers triggers that carry no snapshot (breaker transitions).
        context = dict(context)
        slo_snap = context.pop("slo", None)
        if slo_snap is None and self.slo_provider is not None:
            slo_snap = self.slo_provider
        if callable(slo_snap):
            try:
                slo_snap = slo_snap()
            except Exception:
                slo_snap = None
        recent_traces = []
        for tr in TRACER.snapshot_ring()[-16:]:
            recent_traces.append(
                {
                    "trace_id": tr.trace_id,
                    "kind": tr.kind,
                    "items": tr.n_items,
                    "duration_seconds": round(tr.duration(), 6),
                    "spans": [
                        {"stage": name, "seconds": round(t1 - t0, 6)}
                        for name, t0, t1, _ in tr.spans
                    ],
                }
            )
        return {
            "schema": INCIDENT_SCHEMA,
            "reason": reason,
            "seq": seq,
            "ts": time.time(),
            "context": {k: _jsonable(v) for k, v in context.items()},
            "events": self.events(last=128),
            "recent_traces": recent_traces,
            "slo": slo_snap if slo_snap is not None
            else _slo.ACCOUNTANT.snapshot(),
            "metrics": REGISTRY.expose_text(),
            "config_fingerprint": config_fingerprint(),
        }

    # ---------------------------------------------------------------- hooks

    def note_breaker(self, name: str, to: str, failures: int = 0) -> None:
        """Circuit-breaker transition (qos/breaker.py calls this AFTER
        releasing its lock). `to == "open"` fires the breaker incident;
        only a transition back to `closed` re-arms it — an
        open→half_open→open flap while degraded never re-dumps."""
        with self._lock:
            self.breaker_states[name] = to
        self.record("breaker_transition",
                    severity="warn" if to != "closed" else "info",
                    breaker=name, to=to, failures=failures)
        if to == "open":
            self.trigger("breaker_open", key=f"breaker_open:{name}",
                         breaker=name, failures=failures)
        elif to == "closed":
            self.clear("breaker_open", key=f"breaker_open:{name}")

    def open_breakers(self, prefix: str = "") -> list[str]:
        """Breakers currently OPEN (optionally filtered by name prefix) —
        the health endpoint's degraded-signal read."""
        with self._lock:
            return [
                n for n, st in self.breaker_states.items()
                if st == "open" and n.startswith(prefix)
            ]

    def note_route(self, scope: str, path: str, reason: str = "") -> None:
        """Routing decision for `scope` (e.g. "bls_device"): records an
        event only when the path FLIPS from the last observed one, so the
        ring holds transitions, not every verify."""
        with self._lock:
            last = self._last_route.get(scope)
            if last == path:
                return
            self._last_route[scope] = path
        if last is not None:          # the first observation is not a flip
            self.record("route_flip", severity="warn",
                        scope=scope, path=path, reason=reason, was=last)

    #: event keys log fields must not shadow (a `log.warn(..., kind=...)`
    #: field would otherwise collide with record()'s own kwargs)
    _RESERVED_EVENT_KEYS = frozenset(
        {"ts", "t_mono", "kind", "severity", "slot", "trace_id",
         "component", "msg"}
    )

    def note_supervisor_restart(self, service: str, attempt: int,
                                error: str) -> None:
        self.record("supervisor_restart", severity="warn",
                    service=service, attempt=attempt, error=error)

    #: event keys log fields must not shadow (a `log.warn(..., kind=...)`
    #: field would otherwise collide with record()'s own kwargs)
    _RESERVED_EVENT_KEYS = frozenset(
        {"ts", "t_mono", "kind", "severity", "slot", "trace_id",
         "component", "msg"}
    )

    def _on_log_record(self, ts, level, component, msg, fields) -> None:
        """utils/logging observer: every WARN+ record becomes an event."""
        safe = {
            (k if k not in self._RESERVED_EVENT_KEYS else f"field_{k}"): str(v)
            for k, v in fields.items()
        }
        self.record("log", severity=level.lower(), component=component,
                    msg=msg, **safe)

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "events_recorded": self.events_recorded,
                "ring": list(self.ring),
                "incident_dir": self.incident_dir,
                "incidents_written": list(self.incidents_written),
                "breaker_states": dict(self.breaker_states),
                "disarmed": sorted(
                    k for k, armed in self._armed.items() if not armed
                ),
            }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool, type(None), list, dict)):
        return v
    return str(v)


RECORDER = FlightRecorder()

# the WARN+ log sink is wired at import: the recorder exists for the life
# of the process, so there is nothing to unhook
ltlog.add_observer(RECORDER._on_log_record)

# the global tracer's chrome-trace export gets the black box's events as
# instant markers; test-local Tracer instances stay unaffected
TRACER.instants_source = RECORDER.perfetto_instants
