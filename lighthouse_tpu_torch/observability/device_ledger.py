"""Process-wide device-occupancy ledger (the port's copy of the JAX
package's observability/device_ledger.py): one owner of "who holds the
card, who is waiting, and which tenant's SLO paid for it".

Every batched workload that reaches the card registers here under a
workload name: `bls` (the torch backend's dispatcher), `tree_hash` (the
tree-hash engine's dispatcher) and `epoch` (the epoch-vector leg, which
opens its intervals directly). Each submission opens a ledger *interval*
at admit (workload, lane, bucket, est-cost), marks it busy when the
device dispatch begins, and closes it at device resolve. The ledger turns
those events into:

  - `device_ledger_busy_seconds_total{workload,lane}` — per-tenant
    device time
  - `device_ledger_admit_wait_seconds{workload}` — per-tenant admit
    latency (time between admit and device dispatch)
  - `device_ledger_utilization{chip}` / `device_ledger_overlap{chip}` —
    busy fraction since reset and current interval overlap per chip
  - `pipeline_inflight{workload}` — the per-tenant view of the
    depth-bounded dispatch windows
  - **cross-tenant contention time** — wall time where workload A has
    admitted work pending while the card is occupied by workload B,
    counted `device_ledger_contention_seconds_total{victim,occupant}`

Accounting is incremental and event-driven: at every interval
transition the elapsed time since the previous event lands in exactly
one of {busy, contended, idle} per chip, so per-chip conservation

    busy + contended (contention-wait) + idle == wall

holds *exactly* by construction. The port serves one H100: `LEDGER` has
one chip, and an interval's `chips=None` means that card. The clock is
injectable (`configure(clock=...)`) so tests drive the ledger on a
logical clock; the default is `time.perf_counter`, the clock the tracer
stamps spans with, which lets `trace.py` merge the ledger's timeline
into the Perfetto export as its own process group.

Host-only by construction: imports nothing that initializes a device.
"""

from __future__ import annotations

import threading
from collections import deque
from time import perf_counter

from ..utils.metrics import REGISTRY

# ------------------------------------------------------------------ metrics
# all device_ledger_* series are labeled families: an unlabeled aggregate
# cannot answer "which tenant held the device and which tenant paid for
# the wait"

_BUSY = REGISTRY.counter_vec(
    "device_ledger_busy_seconds_total",
    "device-occupancy seconds attributed per tenant, by workload and lane",
    ("workload", "lane"),
)
_ADMIT_WAIT = REGISTRY.histogram_vec(
    "device_ledger_admit_wait_seconds",
    "time between a submission's admit and its device dispatch, by "
    "workload — the per-tenant view of the dispatch windows' admit wait",
    ("workload",),
    buckets=(0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0),
)
_CONTENTION = REGISTRY.counter_vec(
    "device_ledger_contention_seconds_total",
    "cross-tenant contention: wall seconds the victim workload had "
    "admitted work pending while the device was occupied by the "
    "occupant workload",
    ("victim", "occupant"),
)
_UTILIZATION = REGISTRY.gauge_vec(
    "device_ledger_utilization",
    "fraction of wall time the chip was occupied (busy + contended) "
    "since the ledger was last reset, by chip",
    ("chip",),
)
_OVERLAP = REGISTRY.gauge_vec(
    "device_ledger_overlap",
    "number of ledger intervals currently occupying the chip, by chip "
    "— >1 means batches from more than one submission share the slot",
    ("chip",),
)
_PIPELINE_INFLIGHT = REGISTRY.gauge_vec(
    "pipeline_inflight",
    "ledger intervals currently in the busy state (device dispatch "
    "begun, not yet resolved), by workload — the per-tenant view of "
    "torchbls_pipeline_inflight{lane}",
    ("workload",),
)

#: bounded timeline ring — a run's recent device history without
#: unbounded growth on a long-lived node
TIMELINE_CAP = 2048


class LedgerInterval:
    """One submission's life on the device: admit -> dispatch -> resolve.

    States: "waiting" (admitted, not yet dispatched), "busy" (device
    dispatch begun), closed (removed from the ledger). All transitions
    go through the owning ledger so the incremental per-chip accounting
    sees every edge. Safe to close after a ledger reset — the close
    becomes a no-op instead of corrupting the new epoch's books."""

    __slots__ = ("workload", "lane", "bucket", "est_cost", "chips",
                 "t_open", "t_start", "state", "seq", "_ledger")

    def __init__(self, ledger, seq, workload, lane, bucket, est_cost, chips):
        self._ledger = ledger
        self.seq = seq
        self.workload = workload
        self.lane = lane
        self.bucket = bucket
        self.est_cost = est_cost
        self.chips = chips            # None = every chip (sharded batch)
        self.t_open = None            # stamped by the ledger under lock
        self.t_start = None
        self.state = "waiting"

    def start(self):
        """Device dispatch begins: waiting -> busy."""
        self._ledger._start(self)
        return self

    def close(self, outcome="ok"):
        """Device resolve: the interval leaves the ledger."""
        self._ledger._close(self, outcome)

    def occupies(self, chip):
        return self.chips is None or chip in self.chips


class DeviceLedger:
    """Process-wide owner of device occupancy across every workload.

    Thread-safe; one instance (`LEDGER`) per process, reset per
    deterministic run the way `RECORDER` is."""

    def __init__(self, n_chips=1, clock=perf_counter):
        self._lock = threading.RLock()
        self._default_clock = clock
        self._registry = {}           # workload -> {"dispatcher": ..., "seq": n}
        self._reset_locked(n_chips=n_chips, clock=clock)

    # -- configuration ---------------------------------------------------

    def _reset_locked(self, n_chips, clock):
        self._clock = clock
        self._n_chips = max(1, int(n_chips))
        now = self._clock()
        self._t0 = now
        self._last = now
        self._seq = 0
        self._open = {}               # seq -> LedgerInterval
        self._busy = [0.0] * self._n_chips
        self._contended = [0.0] * self._n_chips
        self._idle = [0.0] * self._n_chips
        self._matrix = {}             # (victim, occupant) -> seconds
        self._last_bucket = {}        # workload -> bucket of last busy iv
        self._timeline = deque(maxlen=TIMELINE_CAP)
        self._inflight = {}           # workload -> busy interval count

    def reset(self):
        """Forget every interval and all accounting; restore the default
        wall clock and single-chip shape. Intervals opened before the
        reset close as no-ops (their seq is gone from the books)."""
        with self._lock:
            self._reset_locked(n_chips=1, clock=self._default_clock)

    def configure(self, n_chips=None, clock=None):
        """Rebind the chip universe and/or the clock (deterministic
        harnesses install a logical clock). Implies a fresh accounting
        epoch — mixing clocks inside one epoch would break conservation."""
        with self._lock:
            self._reset_locked(
                n_chips=self._n_chips if n_chips is None else n_chips,
                clock=self._clock if clock is None else clock,
            )

    @property
    def n_chips(self):
        return self._n_chips

    # -- workload registry -----------------------------------------------

    def register(self, workload, dispatcher=None):
        """Register a tenant. Dispatchers call this from their
        constructor; direct-dispatch paths (epoch vectors) call it with
        dispatcher=None. Re-registration replaces the dispatcher ref
        (latest wins — a rebuilt backend replaces its predecessor)."""
        workload = str(workload)
        with self._lock:
            ent = self._registry.setdefault(
                workload, {"dispatcher": None, "registrations": 0}
            )
            ent["registrations"] += 1
            if dispatcher is not None:
                ent["dispatcher"] = dispatcher
        _PIPELINE_INFLIGHT.labels(workload).set(
            self._inflight.get(workload, 0)
        )
        return workload

    def workloads(self):
        with self._lock:
            return sorted(self._registry)

    # -- interval lifecycle ----------------------------------------------

    def open(self, workload, lane="batch", bucket=None, est_cost=None,
             chips=None):
        """Admit one submission: the interval starts life waiting."""
        with self._lock:
            now = self._advance_locked()
            if workload not in self._registry:
                self._registry[workload] = {
                    "dispatcher": None, "registrations": 0,
                }
            self._seq += 1
            iv = LedgerInterval(
                self, self._seq, str(workload), str(lane), bucket,
                est_cost, None if chips is None else tuple(chips),
            )
            iv.t_open = now
            self._open[iv.seq] = iv
            return iv

    def _start(self, iv):
        with self._lock:
            if iv.seq not in self._open or iv.state != "waiting":
                return                # closed, or a pre-reset straggler
            now = self._advance_locked()
            iv.t_start = now
            iv.state = "busy"
            self._last_bucket[iv.workload] = iv.bucket
            self._inflight[iv.workload] = self._inflight.get(iv.workload, 0) + 1
            wait = max(0.0, now - iv.t_open)
        _ADMIT_WAIT.labels(iv.workload).observe(wait)
        _PIPELINE_INFLIGHT.labels(iv.workload).set(self._inflight[iv.workload])

    def _close(self, iv, outcome):
        with self._lock:
            if iv.seq not in self._open:
                return                # already closed or reset away
            # attribute the elapsed time while the interval is still on
            # the books, THEN remove it — the reverse order would lose
            # the final busy/contention segment of every interval
            now = self._advance_locked()
            del self._open[iv.seq]
            busy_secs = 0.0
            if iv.state == "busy":
                busy_secs = max(0.0, now - iv.t_start)
                n = self._inflight.get(iv.workload, 0)
                self._inflight[iv.workload] = max(0, n - 1)
                self._timeline.append((
                    iv.workload, "wait", iv.t_open, iv.t_start,
                    iv.lane, iv.bucket, iv.est_cost, None,
                ))
                self._timeline.append((
                    iv.workload, "busy", iv.t_start, now,
                    iv.lane, iv.bucket, iv.est_cost, str(outcome),
                ))
            else:
                # abandoned before dispatch: the wait is still history
                self._timeline.append((
                    iv.workload, "wait", iv.t_open, now,
                    iv.lane, iv.bucket, iv.est_cost, str(outcome),
                ))
            iv.state = "closed"
            inflight = self._inflight.get(iv.workload, 0)
        if busy_secs:
            _BUSY.labels(iv.workload, iv.lane).inc(busy_secs)
        _PIPELINE_INFLIGHT.labels(iv.workload).set(inflight)

    # -- incremental accounting ------------------------------------------

    def _advance_locked(self):
        """Attribute the time since the last event: per chip into exactly
        one of busy/contended/idle, and contended time additionally into
        the (victim, occupant) matrix. Returns the current clock reading
        (never behind the last event — a clock regression is clamped so
        conservation survives it)."""
        now = self._clock()
        if now < self._last:
            return self._last
        dt = now - self._last
        self._last = now
        busy_ivs = [iv for iv in self._open.values() if iv.state == "busy"]
        waiting = [iv for iv in self._open.values() if iv.state == "waiting"]
        if dt > 0.0:
            # the device-level occupant: the earliest-started busy
            # interval (FIFO — the batch actually holding the queue head)
            occupant = None
            if busy_ivs:
                occupant = min(
                    busy_ivs, key=lambda iv: (iv.t_start, iv.seq)
                ).workload
            victims = set()
            for iv in waiting:
                if occupant is not None and iv.workload != occupant:
                    victims.add(iv.workload)
            for c in range(self._n_chips):
                chip_busy = [iv for iv in busy_ivs if iv.occupies(c)]
                if not chip_busy:
                    self._idle[c] += dt
                    continue
                chip_occ = min(
                    chip_busy, key=lambda iv: (iv.t_start, iv.seq)
                ).workload
                chip_victims = [
                    iv for iv in waiting
                    if iv.occupies(c) and iv.workload != chip_occ
                ]
                if chip_victims:
                    self._contended[c] += dt
                else:
                    self._busy[c] += dt
            for v in sorted(victims):
                key = (v, occupant)
                self._matrix[key] = self._matrix.get(key, 0.0) + dt
                _CONTENTION.labels(v, occupant).inc(dt)
        wall = max(now - self._t0, 1e-12)
        for c in range(self._n_chips):
            _UTILIZATION.labels(str(c)).set(
                (self._busy[c] + self._contended[c]) / wall
            )
            _OVERLAP.labels(str(c)).set(
                sum(1 for iv in busy_ivs if iv.occupies(c))
            )
        return now

    # -- read side --------------------------------------------------------

    def tick(self):
        """Bring the books up to the current clock (slot boundaries,
        report time) without an interval event."""
        with self._lock:
            self._advance_locked()

    def conservation(self):
        """Per-chip busy + contended + idle vs wall; exact by
        construction (chip_smoke.py's hybrid phase asserts it)."""
        with self._lock:
            now = self._advance_locked()
            wall = now - self._t0
            per_chip = []
            ok = True
            for c in range(self._n_chips):
                total = self._busy[c] + self._contended[c] + self._idle[c]
                chip_ok = abs(total - wall) <= 1e-6 + 1e-9 * abs(wall)
                ok = ok and chip_ok
                per_chip.append({
                    "chip": c,
                    "busy": self._busy[c],
                    "contention_wait": self._contended[c],
                    "idle": self._idle[c],
                    "wall": wall,
                    "ok": chip_ok,
                })
            return {"ok": ok, "wall": wall, "per_chip": per_chip}

    def contention_total(self):
        with self._lock:
            self._advance_locked()
            return sum(self._matrix.values())

    def contention_matrix(self):
        """{(victim, occupant): seconds} — copy, safe to diff against."""
        with self._lock:
            self._advance_locked()
            return dict(self._matrix)

    def last_bucket(self, workload):
        """Padding bucket of the workload's most recent busy interval —
        what a device_contention incident names as the occupying batch."""
        with self._lock:
            return self._last_bucket.get(workload)

    def busy_seconds(self):
        """{workload: seconds} summed over closed busy intervals."""
        out = {}
        with self._lock:
            for w, kind, t0, t1, *_ in self._timeline:
                if kind == "busy":
                    out[w] = out.get(w, 0.0) + (t1 - t0)
        return out

    def snapshot(self):
        """JSON-safe dump of the books."""
        cons = self.conservation()
        with self._lock:
            return {
                "n_chips": self._n_chips,
                "registry": {
                    w: {
                        "registrations": ent["registrations"],
                        "has_dispatcher": ent["dispatcher"] is not None,
                    }
                    for w, ent in sorted(self._registry.items())
                },
                "open_intervals": [
                    {
                        "workload": iv.workload, "lane": iv.lane,
                        "state": iv.state, "bucket": iv.bucket,
                        "est_cost": iv.est_cost,
                    }
                    for _, iv in sorted(self._open.items())
                ],
                "inflight": {
                    w: n for w, n in sorted(self._inflight.items()) if n
                },
                "contention": {
                    f"{v}|{o}": secs
                    for (v, o), secs in sorted(self._matrix.items())
                },
                "last_bucket": dict(self._last_bucket),
                "conservation": cons,
                "timeline_len": len(self._timeline),
            }

    # -- trace export ------------------------------------------------------

    def perfetto_device_timeline(self):
        """Closed-interval spans for the Chrome-trace export, in
        deterministic order: (track, name, t0, t1, args). Busy spans land
        on the workload's occupancy track, waits on its `:wait` marker
        track — trace.py renders each track as its own thread inside one
        `device_ledger` process group."""
        with self._lock:
            rows = list(self._timeline)
        spans = []
        for workload, kind, t0, t1, lane, bucket, est_cost, outcome in rows:
            if t1 <= t0:
                continue              # zero-width: nothing to render
            track = workload if kind == "busy" else f"{workload}:wait"
            name = f"{workload}:{lane}" if kind == "busy" else "waiting"
            args = {"lane": lane}
            if bucket is not None:
                args["bucket"] = bucket
            if est_cost is not None:
                args["est_cost"] = est_cost
            if outcome is not None:
                args["outcome"] = outcome
            spans.append((track, name, t0, t1, args))
        spans.sort(key=lambda s: (s[2], s[3], s[0], s[1]))
        return spans


#: the process-wide ledger every dispatcher registers with
LEDGER = DeviceLedger()


def _wire_tracer():
    # the global tracer pulls the ledger's timeline into every
    # chrome-trace export, same pattern as the flight recorder's instants
    from .trace import TRACER

    TRACER.device_timeline_source = LEDGER.perfetto_device_timeline


_wire_tracer()
