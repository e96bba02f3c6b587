"""Slot-level SLO engine — the per-slot service-level accountant (the
port's copy of the JAX package's observability/slo.py).

It closes one `SlotReport` per slot-clock boundary: per-WorkKind admitted
/ processed / shed / expired counts, the deadline-hit ratio for TIMELY
work, device-vs-host route share, and queue-wait / verify-latency
quantiles against the slot budget. Closed reports roll into a 5-slot
window (the fast alerting signal) and a 32-slot epoch window (the
capacity-planning signal), each with SRE-style burn-rate computation:

    burn_rate = (1 - hit_ratio) / (1 - target)

so burn 1.0 means "spending error budget exactly at the sustainable rate"
and burn 10 means "the budget for this window is gone in a tenth of it".

Feeding it is push-based and hot-path cheap (a lock + integer adds): the
hybrid router records routes and late batches; other producers record
admits, sheds, processed items and queue waits. Slots close ONLY via
`close_slot()` — closing is watermark-guarded so a report is emitted
exactly once per slot no matter how many threads race, and a clock jump
emits empty reports for the skipped slots (bounded) so the windows never
silently compress time.

Closing a slot also runs the incident triggers: burn-rate over threshold,
deadline-miss streaks and cross-tenant device contention (read from the
device ledger) hand off to the flight recorder, which applies hysteresis
and dumps.

`ACCOUNTANT` is the process's accountant (`health()` reads it); a caller
that wants reports that are a pure function of its own inputs runs a
private instance.
"""

from __future__ import annotations

import threading
from collections import deque

from ..utils.metrics import REGISTRY
from . import flight_recorder

#: work kinds with a slot deadline (the JAX package's qos.admission
#: TIMELY class, kept as names)
TIMELY_KINDS = frozenset(
    {
        "gossip_attestation",
        "gossip_aggregate",
        "gossip_sync_contribution",
        "gossip_sync_signature",
        # validator-client duties are slot-deadlined by definition
        "vc_duty",
    }
)

#: rolling window shapes: 5 slots = fast page-the-operator signal,
#: 32 slots = one epoch, the capacity-planning horizon
SHORT_WINDOW = 5
EPOCH_WINDOW = 32

#: cap on empty reports emitted for one clock jump — a node resumed after
#: an hour must not spin emitting thousands of empties; the gap is
#: recorded on the first report after it instead
MAX_GAP_REPORTS = 64

#: per-slot sample bound for the wait/latency quantile lists
MAX_SAMPLES = 2048

SLOT_REPORTS = REGISTRY.counter_vec(
    "slo_slot_reports_total",
    "slot reports closed, by result (ok / degraded / empty)",
    ("result",),
)
DEADLINE_TOTAL = REGISTRY.counter_vec(
    "slo_deadline_total",
    "TIMELY work items against their slot deadline, by outcome "
    "(hit = processed in time; miss = shed, expired, or verified late)",
    ("result",),
)
HIT_RATIO = REGISTRY.gauge_vec(
    "slo_deadline_hit_ratio",
    "rolling deadline-hit ratio of TIMELY work, by window",
    ("window",),
)
BURN_RATE = REGISTRY.gauge_vec(
    "slo_burn_rate",
    "error-budget burn rate ((1 - hit_ratio) / (1 - target)), by window",
    ("window",),
)
ROUTE_TOTAL = REGISTRY.counter_vec(
    "slo_route_total",
    "verification work by the path that served it (device / host fallback)",
    ("path",),
)
DEGRADED = REGISTRY.gauge_vec(
    "slo_degraded",
    "1 while the named degradation signal is active, else 0",
    ("reason",),
)


def _quantile(sorted_samples: list, q: float) -> float:
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1, int(q * len(sorted_samples)))
    return sorted_samples[idx]


class _SlotCounters:
    """Mutable accumulator for one open slot (accountant-lock guarded)."""

    __slots__ = ("admitted", "processed", "shed", "late", "routes",
                 "queue_wait", "verify_lat", "wait_overflow",
                 "verify_overflow", "validator_hits", "validator_misses",
                 "workloads")

    def __init__(self):
        self.admitted: dict[str, int] = {}
        self.processed: dict[str, int] = {}
        self.shed: dict[tuple[str, str], int] = {}   # (kind, reason) -> n
        self.late = 0
        self.routes: dict[str, int] = {}
        self.queue_wait: list[float] = []
        self.verify_lat: list[float] = []
        self.wait_overflow = 0
        self.verify_overflow = 0
        self.validator_hits = 0
        self.validator_misses = 0
        # per-tenant deadline verdicts: workload -> [hits, misses] (the
        # device ledger's workload names — bls / tree_hash / epoch / ...)
        self.workloads: dict[str, list] = {}

    def merge(self, other: "_SlotCounters") -> None:
        """Fold another slot's counters into this one (clock-rebase path)."""
        for k, n in other.admitted.items():
            self.admitted[k] = self.admitted.get(k, 0) + n
        for k, n in other.processed.items():
            self.processed[k] = self.processed.get(k, 0) + n
        for k, n in other.shed.items():
            self.shed[k] = self.shed.get(k, 0) + n
        self.late += other.late
        for p, n in other.routes.items():
            self.routes[p] = self.routes.get(p, 0) + n
        room = MAX_SAMPLES - len(self.queue_wait)
        self.queue_wait.extend(other.queue_wait[:room])
        self.wait_overflow += other.wait_overflow + max(
            0, len(other.queue_wait) - room
        )
        room = MAX_SAMPLES - len(self.verify_lat)
        self.verify_lat.extend(other.verify_lat[:room])
        self.verify_overflow += other.verify_overflow + max(
            0, len(other.verify_lat) - room
        )
        self.validator_hits += other.validator_hits
        self.validator_misses += other.validator_misses
        for w, (h, m) in other.workloads.items():
            ent = self.workloads.setdefault(w, [0, 0])
            ent[0] += h
            ent[1] += m


class SlotReport:
    """One closed slot's accounting; immutable once built."""

    __slots__ = ("slot", "empty", "admitted", "processed", "shed", "late",
                 "routes", "hits", "misses", "queue_wait", "verify_lat",
                 "validator_hits", "validator_misses", "workloads",
                 "gap_before")

    def __init__(self, slot: int, c: _SlotCounters | None,
                 gap_before: int = 0):
        self.slot = slot
        self.gap_before = gap_before
        if c is None:
            c = _SlotCounters()
        self.empty = not (c.admitted or c.processed or c.shed or c.late
                          or c.validator_hits or c.validator_misses
                          or c.workloads)
        self.admitted = dict(c.admitted)
        self.processed = dict(c.processed)
        self.shed = {f"{k}:{r}": n for (k, r), n in c.shed.items()}
        self.late = c.late
        self.routes = dict(c.routes)
        self.validator_hits = c.validator_hits
        self.validator_misses = c.validator_misses
        self.workloads = {w: (hm[0], hm[1]) for w, hm in c.workloads.items()}
        # deadline accounting over TIMELY kinds: everything processed met
        # its deadline (expired work is shed at pop, never executed) except
        # the batches the verifier marked late; every TIMELY loss — full
        # queue, admission refusal, pop-time expiry — is a miss. Late is
        # NOT clamped to this slot's processed count: a straggling device
        # resolve can land its late marker one slot after its items were
        # counted processed, and a clamp would silently erase exactly the
        # stalled-device misses the SLI exists to catch (the hits
        # subtraction floors at zero instead).
        timely_processed = sum(
            n for k, n in self.processed.items() if k in TIMELY_KINDS
        )
        timely_lost = sum(
            n for (k, _r), n in c.shed.items() if k in TIMELY_KINDS
        )
        self.hits = max(0, timely_processed - self.late)
        self.misses = timely_lost + self.late
        qs = sorted(c.queue_wait)
        vs = sorted(c.verify_lat)
        self.queue_wait = {
            "p50": round(_quantile(qs, 0.50), 6),
            "p99": round(_quantile(qs, 0.99), 6),
            "max": round(qs[-1], 6) if qs else 0.0,
            "n": len(qs) + c.wait_overflow,
        }
        self.verify_lat = {
            "p50": round(_quantile(vs, 0.50), 6),
            "p99": round(_quantile(vs, 0.99), 6),
            "max": round(vs[-1], 6) if vs else 0.0,
            "n": len(vs) + c.verify_overflow,
        }

    def hit_ratio(self) -> float | None:
        total = self.hits + self.misses
        return None if total == 0 else self.hits / total

    def as_dict(self) -> dict:
        ratio = self.hit_ratio()
        out = {
            "slot": self.slot,
            "empty": self.empty,
            "admitted": self.admitted,
            "processed": self.processed,
            "shed": self.shed,
            "deadline": {
                "hits": self.hits,
                "misses": self.misses,
                "late": self.late,
                "hit_ratio": None if ratio is None else round(ratio, 4),
            },
            "routes": self.routes,
            "queue_wait_seconds": self.queue_wait,
            "verify_latency_seconds": self.verify_lat,
        }
        if self.validator_hits or self.validator_misses:
            out["validator_monitor"] = {
                "hits": self.validator_hits,
                "misses": self.validator_misses,
            }
        if self.workloads:
            out["workloads"] = {
                w: {
                    "hits": h,
                    "misses": m,
                    "hit_ratio": None if h + m == 0
                    else round(h / (h + m), 4),
                }
                for w, (h, m) in sorted(self.workloads.items())
            }
        if self.gap_before:
            out["gap_before"] = self.gap_before
        return out


class SlotAccountant:
    """Push-fed per-slot accountant with rolling SLI windows."""

    def __init__(self, *, target: float = 0.99, burn_threshold: float = 10.0,
                 miss_streak: int = 2, streak_ratio: float = 0.9,
                 shed_burst_threshold: int = 50,
                 contention_threshold: float = 0.25,
                 recorder: flight_recorder.FlightRecorder | None = None,
                 export_metrics: bool = True):
        self.target = float(target)
        self.burn_threshold = float(burn_threshold)
        self.miss_streak = int(miss_streak)
        self.streak_ratio = float(streak_ratio)
        self.shed_burst_threshold = int(shed_burst_threshold)
        #: cross-tenant contention seconds accrued since the last
        #: evaluated slot that arm the device_contention trigger
        self.contention_threshold = float(contention_threshold)
        self.recorder = recorder if recorder is not None else (
            flight_recorder.RECORDER
        )
        # a private accountant must not fight the process accountant
        # over the shared slo_* gauge children
        self._export = export_metrics
        self._lock = threading.Lock()
        self._clock = None
        self._closed_through: int | None = None
        self._pending: dict[int, _SlotCounters] = {}
        self.windows = {
            "slot_5": deque(maxlen=SHORT_WINDOW),
            "epoch_32": deque(maxlen=EPOCH_WINDOW),
        }
        self.recent: deque = deque(maxlen=64)      # closed reports, newest last
        self.closed_count = 0
        self._streak = 0                           # consecutive degraded slots
        self._burning = False
        self._contending = False                   # device_contention latch
        self._contention_baseline: dict = {}       # last-read ledger matrix
        # serializes _post_close across the concurrent close_slot callers
        # this class supports: trigger/clear state transitions must not
        # interleave (a stale clear re-arming a trigger mid-episode would
        # break the one-dump-per-episode hysteresis guarantee)
        self._post_lock = threading.Lock()
        self._post_through = -1                    # newest slot evaluated
        # close listeners (weak refs, the autotune plan-listener pattern),
        # called for every closed report OUTSIDE the accountant lock,
        # after _post_close, so a listener may read window summaries or
        # take its own locks. A garbage-collected owner silently
        # unsubscribes.
        self._close_listeners: list = []

    def add_close_listener(self, fn) -> None:
        """Register `fn(report)` to run for every newly closed SlotReport."""
        import weakref

        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            ref = weakref.ref(fn)
        with self._lock:
            self._close_listeners.append(ref)

    def remove_close_listener(self, fn) -> None:
        """Unsubscribe `fn` (registered via add_close_listener). A
        consumer re-binding to another accountant must drop its old
        subscription explicitly — the
        weakref only dies with the OWNER, and a live owner subscribed to
        two accountants would tick on both."""
        with self._lock:
            self._close_listeners = [
                ref for ref in self._close_listeners
                if ref() is not None and ref() != fn
            ]

    def _notify_close(self, rep: "SlotReport") -> None:
        with self._lock:
            refs = list(self._close_listeners)
        for ref in refs:
            fn = ref()
            if fn is None:
                with self._lock:
                    try:
                        self._close_listeners.remove(ref)
                    except ValueError:
                        pass
                continue
            try:
                fn(rep)
            except Exception as e:  # a listener must never break a close
                flight_recorder.RECORDER.record(
                    "slo_close_listener_error", severity="warn",
                    slot=rep.slot, error=f"{type(e).__name__}: {e}",
                )

    # ----------------------------------------------------------- plumbing

    def clock_bound(self) -> bool:
        with self._lock:
            return self._clock is not None

    def bind_clock(self, clock) -> None:
        """Attach the slot clock records attribute against. Also hands the
        clock to the flight recorder so events carry slot stamps."""
        with self._lock:
            self._clock = clock
        self.recorder.configure(clock=clock)

    def reset(self) -> None:
        with self._lock:
            self._clock = None
            self._closed_through = None
            self._pending.clear()
            for w in self.windows.values():
                w.clear()
            self.recent.clear()
            self.closed_count = 0
            self._streak = 0
            self._burning = False
            self._contending = False
            self._contention_baseline = {}
            self._post_through = -1

    def _slot_locked(self) -> int:
        """Slot to attribute the current event to (lock held)."""
        slot = 0
        if self._clock is not None:
            try:
                slot = self._clock.now() or 0
            except Exception:
                slot = 0
        if self._closed_through is not None and slot <= self._closed_through:
            # straggler landing after its slot closed (an in-flight device
            # resolve): attribute forward, never mutate a closed report
            slot = self._closed_through + 1
        return slot

    def _counters_locked(self) -> _SlotCounters:
        slot = self._slot_locked()
        c = self._pending.get(slot)
        if c is None:
            c = self._pending[slot] = _SlotCounters()
            # bound the pending map: with nothing calling close_slot only
            # the default slot accumulates, but a bound here makes that
            # case safe by construction
            if len(self._pending) > 2 * EPOCH_WINDOW:
                self._pending.pop(min(self._pending))
        return c

    # -------------------------------------------------------- event feeds

    def record_admitted(self, kind: str, n: int = 1) -> None:
        with self._lock:
            c = self._counters_locked()
            c.admitted[kind] = c.admitted.get(kind, 0) + n

    def record_processed(self, kind: str, n: int = 1) -> None:
        with self._lock:
            c = self._counters_locked()
            c.processed[kind] = c.processed.get(kind, 0) + n

    def record_shed(self, kind: str, reason: str, n: int = 1) -> None:
        with self._lock:
            c = self._counters_locked()
            key = (kind, reason)
            c.shed[key] = c.shed.get(key, 0) + n

    def record_late(self, n: int = 1, kind: str | None = None) -> None:
        """`n` items were verified but PAST their usefulness budget (a
        stalled device batch): they count as processed for conservation
        but as deadline misses for the SLI. `kind` guards attribution —
        a late NON-deadlined batch (block signature sets on the sync
        verify path) must not debit the TIMELY hit ratio; None means the
        caller knows the work is deadlined (attestation batches)."""
        if kind is not None and kind not in TIMELY_KINDS:
            return
        with self._lock:
            self._counters_locked().late += n

    def record_queue_wait(self, kind: str, seconds: float) -> None:
        with self._lock:
            c = self._counters_locked()
            if len(c.queue_wait) < MAX_SAMPLES:
                c.queue_wait.append(seconds)
            else:
                c.wait_overflow += 1     # "n" stays the TRUE event count

    def record_verify_latency(self, seconds: float) -> None:
        with self._lock:
            c = self._counters_locked()
            if len(c.verify_lat) < MAX_SAMPLES:
                c.verify_lat.append(seconds)
            else:
                c.verify_overflow += 1   # "n" stays the TRUE event count

    def record_route(self, path: str, n: int = 1) -> None:
        with self._lock:
            c = self._counters_locked()
            c.routes[path] = c.routes.get(path, 0) + n
        if self._export:
            ROUTE_TOTAL.labels(path).inc(n)

    def record_validator_epoch(self, hits: int, misses: int) -> None:
        """Per-validator duty verdicts of one epoch, so they appear in the
        epoch window."""
        with self._lock:
            c = self._counters_locked()
            c.validator_hits += hits
            c.validator_misses += misses

    def record_workload_deadline(self, workload: str, hits: int = 0,
                                 misses: int = 0) -> None:
        """Per-tenant deadline verdicts under the device ledger's
        workload names (bls / tree_hash / epoch): every
        SlotReport and window summary then carries a per-workload
        deadline-hit ratio and burn rate beside the aggregate — the
        tenant-aware view the "one device, many tenants" arbiter needs."""
        with self._lock:
            ent = self._counters_locked().workloads.setdefault(
                str(workload), [0, 0]
            )
            ent[0] += int(hits)
            ent[1] += int(misses)

    # ------------------------------------------------------ slot boundary

    def close_slot(self, upto: int | None) -> list[SlotReport]:
        """Close every not-yet-closed slot <= `upto`; returns the newly
        closed reports (oldest first). Idempotent per slot: the watermark
        guarantees exactly one report per slot under concurrent callers.
        A clock jump emits empty reports for the skipped slots, bounded at
        MAX_GAP_REPORTS — a larger gap is recorded on the first report
        after it instead of flooding the windows."""
        if upto is None or upto < 0:
            return []
        reports: list[SlotReport] = []
        rebased_from = None
        with self._lock:
            clock_now = None
            if self._clock is not None:
                try:
                    clock_now = self._clock.now()
                except Exception:
                    clock_now = None
            if (
                self._closed_through is not None
                and self._closed_through - upto > EPOCH_WINDOW
                # only when the bound clock AGREES time regressed: a stale
                # caller replaying old slot numbers while the clock reads
                # high must stay an idempotent no-op
                and clock_now is not None
                and upto >= clock_now - 1
            ):
                # forward clock anomaly recovery: a spurious future clock
                # reading (NTP step, post-suspend RTC drift) ran the
                # watermark ahead; without a backward rebase every later
                # close would no-op and the SLI would freeze until wall
                # time caught up — rebase, folding any stranded pending
                # counters into `upto`.
                rebased_from = self._closed_through
                stranded = _SlotCounters()
                for s in [s for s in self._pending if s > upto]:
                    stranded.merge(self._pending.pop(s))
                existing = self._pending.get(upto)
                if existing is not None:
                    stranded.merge(existing)
                self._pending[upto] = stranded
                self._closed_through = upto - 1
            if self._closed_through is None:
                start = min(self._pending.keys(), default=upto)
            else:
                start = self._closed_through + 1
            if upto < start:
                return []
            gap = 0
            if upto - start + 1 > MAX_GAP_REPORTS:
                gap = (upto - start + 1) - MAX_GAP_REPORTS
                start = upto - MAX_GAP_REPORTS + 1
                # drop pending counters swallowed by the gap
                for s in [s for s in self._pending if s < start]:
                    self._pending.pop(s)
            for slot in range(start, upto + 1):
                rep = SlotReport(slot, self._pending.pop(slot, None),
                                 gap_before=gap if slot == start else 0)
                self._closed_through = slot
                for w in self.windows.values():
                    w.append(rep)
                self.recent.append(rep)
                self.closed_count += 1
                reports.append(rep)
        if rebased_from is not None:
            self.recorder.record(
                "slo_clock_rebase", severity="warn",
                from_slot=rebased_from, to_slot=upto,
            )
            # the trigger watermark must follow or every post-rebase slot
            # would read as stale and trigger state would freeze too
            with self._post_lock:
                self._post_through = min(self._post_through, upto - 1)
        for rep in reports:
            self._post_close(rep)
            self._notify_close(rep)
        return reports

    # ----------------------------------------------------------- analysis

    def _window_summary_locked(self, name: str) -> dict:
        reps = list(self.windows[name])
        hits = sum(r.hits for r in reps)
        misses = sum(r.misses for r in reps)
        total = hits + misses
        ratio = 1.0 if total == 0 else hits / total
        budget = max(1e-9, 1.0 - self.target)
        routes: dict[str, int] = {}
        for r in reps:
            for p, n in r.routes.items():
                routes[p] = routes.get(p, 0) + n
        route_total = sum(routes.values())
        vhits = sum(r.validator_hits for r in reps)
        vmiss = sum(r.validator_misses for r in reps)
        out = {
            "slots": len(reps),
            "hits": hits,
            "misses": misses,
            "deadline_hit_ratio": round(ratio, 4),
            "burn_rate": round((1.0 - ratio) / budget, 2),
            "route_share": {
                p: round(n / route_total, 4) for p, n in sorted(routes.items())
            } if route_total else {},
        }
        if vhits or vmiss:
            out["validator_monitor"] = {"hits": vhits, "misses": vmiss}
        per_workload: dict[str, list] = {}
        for r in reps:
            for w, (h, m) in r.workloads.items():
                ent = per_workload.setdefault(w, [0, 0])
                ent[0] += h
                ent[1] += m
        if per_workload:
            out["workloads"] = {}
            for w, (h, m) in sorted(per_workload.items()):
                wr = 1.0 if h + m == 0 else h / (h + m)
                out["workloads"][w] = {
                    "hits": h,
                    "misses": m,
                    "deadline_hit_ratio": round(wr, 4),
                    "burn_rate": round((1.0 - wr) / budget, 2),
                }
        return out

    def window_summary(self, name: str) -> dict:
        with self._lock:
            return self._window_summary_locked(name)

    def deadline_totals(self) -> tuple[int, int]:
        """(hits, misses) summed over every retained closed report,
        bounded by the `recent` ring (64 slots); integer counts only."""
        with self._lock:
            reps = list(self.recent)
        return (sum(r.hits for r in reps), sum(r.misses for r in reps))

    def burn_rate(self, window: str = "slot_5") -> float:
        return self.window_summary(window)["burn_rate"]

    def _post_close(self, rep: SlotReport) -> None:
        """Outside the accountant lock (but serialized by _post_lock):
        export gauges, emit flight-recorder events, and run the incident
        triggers for one closed report. Trigger state only advances for
        slots NEWER than any already evaluated — a racing closer's stale
        batch must not clear (re-arm) a trigger a newer slot just fired."""
        with self._post_lock:
            self._post_close_serialized(rep)

    def _post_close_serialized(self, rep: SlotReport) -> None:
        ratio = rep.hit_ratio()
        degraded = ratio is not None and ratio < self.streak_ratio
        if self._export:
            SLOT_REPORTS.labels(
                "empty" if rep.empty else ("degraded" if degraded else "ok")
            ).inc()
        stale = rep.slot <= self._post_through
        if not stale:
            self._post_through = rep.slot
        with self._lock:
            short = self._window_summary_locked("slot_5")
            epoch = self._window_summary_locked("epoch_32")
            if not stale:
                if degraded:
                    self._streak += 1
                elif not rep.empty:
                    self._streak = 0
            streak = self._streak
        if self._export:
            # deadline counters are exported at CLOSE, not at record time:
            # a processed item that a verifier later marks late would
            # otherwise count once as hit and once as miss
            DEADLINE_TOTAL.labels("hit").inc(rep.hits)
            DEADLINE_TOTAL.labels("miss").inc(rep.misses)
            HIT_RATIO.labels("slot_5").set(short["deadline_hit_ratio"])
            HIT_RATIO.labels("epoch_32").set(epoch["deadline_hit_ratio"])
            BURN_RATE.labels("slot_5").set(short["burn_rate"])
            BURN_RATE.labels("epoch_32").set(epoch["burn_rate"])
        rec = self.recorder
        if rep.misses:
            rec.record("deadline_miss", severity="warn", slot=rep.slot,
                       misses=rep.misses, late=rep.late,
                       hit_ratio=None if ratio is None else round(ratio, 4))
        shed_total = sum(
            n for k, n in rep.shed.items() if not k.endswith(":expired")
        )
        if shed_total >= self.shed_burst_threshold:
            rec.record("shed_burst", severity="warn", slot=rep.slot,
                       shed=shed_total, detail=dict(rep.shed))
        if stale:
            return   # per-report events above still emit; trigger state
                     # is owned by the newest evaluated slot
        # trigger 1: burn rate over threshold (cleared when it falls back)
        burning = short["burn_rate"] >= self.burn_threshold
        if self._export:
            DEGRADED.labels("slo_burn_rate").set(1.0 if burning else 0.0)
        # `slo=self.snapshot` (the METHOD): the recorder evaluates it only
        # when the trigger actually fires — a trigger held down through a
        # long degradation must not build a snapshot per slot to discard
        if burning and not self._burning:
            rec.trigger("slo_burn_rate", slot=rep.slot,
                        burn_rate=short["burn_rate"],
                        window="slot_5", slo=self.snapshot)
        elif not burning and self._burning:
            rec.clear("slo_burn_rate")
        self._burning = burning
        # trigger 2: deadline-miss streak (cleared by one clean slot)
        if streak >= self.miss_streak:
            rec.trigger("deadline_miss_streak", slot=rep.slot,
                        streak=streak, slo=self.snapshot)
        elif streak == 0:
            rec.clear("deadline_miss_streak")
        # trigger 3: cross-tenant device contention — the device ledger's
        # (victim, occupant) matrix accrued over threshold since the last
        # evaluated slot. Same hysteresis contract as the burn trigger: a
        # latch arms on the first over-threshold slot and a sustained
        # episode dumps once; the latch re-arms only after a slot whose
        # contention delta is back under threshold.
        self._run_contention_trigger(rep, rec)

    def _run_contention_trigger(self, rep: SlotReport, rec) -> None:
        try:
            from .device_ledger import LEDGER

            matrix = LEDGER.contention_matrix()
        except Exception:
            return   # the books must never break a slot close
        delta = {
            key: secs - self._contention_baseline.get(key, 0.0)
            for key, secs in matrix.items()
            if secs - self._contention_baseline.get(key, 0.0) > 0.0
        }
        self._contention_baseline = matrix
        total = sum(delta.values())
        contending = total >= self.contention_threshold
        if self._export:
            DEGRADED.labels("device_contention").set(
                1.0 if contending else 0.0
            )
        if contending and not self._contending:
            # the dump names who paid (victim), who held the device
            # (occupant), and the occupying batch's padding bucket
            (victim, occupant), secs = max(
                delta.items(), key=lambda kv: (kv[1], kv[0])
            )
            try:
                from .device_ledger import LEDGER

                bucket = LEDGER.last_bucket(occupant)
            except Exception:
                bucket = None
            rec.trigger("device_contention", slot=rep.slot,
                        victim=victim, occupant=occupant,
                        occupant_bucket=bucket,
                        contention_seconds=round(secs, 6),
                        contention_total_seconds=round(total, 6),
                        slo=self.snapshot)
        elif not contending and self._contending:
            rec.clear("device_contention")
        self._contending = contending

    def health(self) -> dict:
        """The degraded signal a health endpoint consumes:
        short-window burn over threshold, or the device breaker open."""
        reasons = []
        if self.burn_rate("slot_5") >= self.burn_threshold:
            reasons.append("slo_burn_rate")
        for name in self.recorder.open_breakers(prefix="bls_device"):
            reasons.append(f"breaker_open:{name}")
        return {"degraded": bool(reasons), "reasons": reasons}

    # ----------------------------------------------------------- snapshot

    def snapshot(self, recent: int = 8) -> dict:
        with self._lock:
            reps = list(self.recent)[-recent:]
            out = {
                "target": self.target,
                "burn_threshold": self.burn_threshold,
                # the denominator the wait/latency quantiles are read
                # against: work must clear the pipeline well inside this
                "slot_budget_seconds": getattr(
                    self._clock, "seconds_per_slot", None
                ),
                "closed_through": self._closed_through,
                "slots_closed": self.closed_count,
                "open_slots": sorted(self._pending.keys()),
                "windows": {
                    name: self._window_summary_locked(name)
                    for name in self.windows
                },
                "recent_reports": [r.as_dict() for r in reps],
            }
        last = next((r for r in reversed(reps) if not r.empty), None)
        if last is not None:
            out["last_active_report"] = last.as_dict()
        return out


#: the node's accountant — /lighthouse_tpu/slo, health, debug-bundle
ACCOUNTANT = SlotAccountant()


def health() -> dict:
    return ACCOUNTANT.health()
