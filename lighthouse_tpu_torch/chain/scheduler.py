"""CapacityScheduler — closed-loop, deadline-aware continuous batching.

The port's copy of the JAX package's chain/scheduler.py, on the port's
flight recorder, autotune runtime and planner. Its padding model is the
port's: the torch backend pads a batch's set axis to a pow2 bucket with a
floor of MIN_SETS = 4 (crypto/torchbls/backend.py `padding_bucket`).
`pow2ceil` keeps the JAX package's model without that floor, so both
packages fit the same costs; only batches of 1 to 3 sets differ (the card
pads them to 4), and the cap ladder below starts at 64.

Before this scheduler, batch formation was a fixed-cap `while q and len(items) < cap`
loop inside `BeaconProcessor._pop_locked` and every serving knob was
static: autotune planned once at startup, admission shed at fixed
watermarks, and the hybrid router's urgent threshold never moved. Yet the
feedback signals for a real control loop all exist — queue-wait and
verify-latency quantiles per slot (observability/slo.py), breaker state
(qos/breaker.py), deadline-hit ratios and burn rates over the 5/32-slot
windows, and the plan-listener actuator (autotune/runtime.py) that lets
knobs retune mid-run. This module closes the loop:

  decision   Every pop of a batchable queue asks `decide()`: dispatch a
             batch NOW, or hold and let it coalesce wider. Dispatch when
             the queue has a full batch (`cap_full`), when the slot budget
             says waiting would finish the batch too late (`deadline` —
             estimated verify time vs the seconds left in the slot), or
             when the device window is idle (`idle` — serving immediately
             is free). Hold (`coalesce`) only while the device is busy and
             there is budget slack: exactly vLLM-style continuous
             batching, "dispatch when the slot budget says so, not when a
             fixed window fills". A harness-installed budget gate
             (`budget` — loadgen/capacity.py's device-time ledger) can
             hold work across slot boundaries deterministically.

  model      The scheduler learns the device's batch cost online: every
             resolved batch feeds `observe_verify(kind, n, secs)` and a
             least-squares fit over PADDED batch sizes (the torchbls
             padding-bucket discipline: a batch of n sets pays for
             pow2ceil(n) lanes) yields `secs(n) = a + b * pow2ceil(n)`.
             Padding-aware cost is what makes cap choice non-trivial: a
             1100-set batch pays 2048 lanes, two 512+128 batches pay 640.

  retune     Each closed SLO slot report (SlotAccountant close listener)
             re-derives the knobs: batch caps pick the cheapest cap on a
             pow2 ladder for the EWMA'd demand under the fitted cost
             model; admission watermarks tighten while the 5-slot burn
             rate is over 1x (bulk yields earlier so timely work keeps
             the pipeline) and relax back when it recovers; the urgent
             threshold becomes the largest batch the model serves within
             the urgent latency budget. Explicit pins always win
             (`BeaconProcessorConfig(max_attestation_batch=N)` /
             `bn --max-attestation-batch` set the `_explicit` flags, the
             "explicitness is self-describing" rule), and a breaker
             that is not closed freezes cap retuning — host-fallback
             latencies must not steer device batch sizing.

  actuation  Per-instance knobs (caps, watermarks) apply directly. The
             process-global knobs (urgent threshold, and the caps as seen
             by other plan consumers) are published through the EXISTING
             autotune plan-listener contract: `publish_plan=True` (the
             live bn node path) installs a `scheduler:`-sourced Plan via
             `runtime.install_runtime_plan`, so `HybridBackend._apply_plan`,
             the torchbls dispatcher and `BeaconProcessor._on_plan_installed`
             all pick the change up live — and env/CLI pins keep winning
             inside each consumer's own precedence resolution. A plan
             installed by someone ELSE (a real `autotune calibrate`
             profile) re-bases this controller instead of being fought.

Observability: current caps in `scheduler_batch_cap{kind}`, every
decision in `scheduler_decisions_total{kind,reason}`, every knob move in
`scheduler_retunes_total{knob,direction}` plus a `scheduler_retune`
flight-recorder event, live watermarks in
`scheduler_admission_watermark{klass}`. `stats()` returns the
deterministic mirror loadgen reports embed.
"""

from __future__ import annotations

import threading
from collections import deque

from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

log = get_logger("capacity_scheduler")

# ------------------------------------------------------------------ metrics
# labeled families (scripts/lint_metrics.py enforces it): an unlabeled
# scheduler_* aggregate could not answer "which kind's cap moved, which
# decision held the queue, which knob retuned"

_BATCH_CAP = REGISTRY.gauge_vec(
    "scheduler_batch_cap",
    "live batch cap chosen by the capacity scheduler, by work kind",
    ("kind",),
)
_DECISIONS = REGISTRY.counter_vec(
    "scheduler_decisions_total",
    "batch-formation decisions, by work kind and reason (cap_full / "
    "deadline / idle / drain / coalesce / budget)",
    ("kind", "reason"),
)
_RETUNES = REGISTRY.counter_vec(
    "scheduler_retunes_total",
    "control-loop knob moves, by knob (att_cap / agg_cap / bulk_watermark "
    "/ backfill_watermark / urgent_max_sets) and direction (up / down)",
    ("knob", "direction"),
)
_WATERMARK = REGISTRY.gauge_vec(
    "scheduler_admission_watermark",
    "live admission watermark fraction, by priority class",
    ("klass",),
)

# the pow2 ladder cap retuning chooses from (64 to the planner's
# MAX_BATCH_CAP ceiling — the same clamp autotune plans under)
CAP_LADDER = (64, 128, 256, 512, 1024, 2048, 4096)
MIN_CAP, MAX_CAP = CAP_LADDER[0], CAP_LADDER[-1]
# observation window for the cost fit; old shapes age out as traffic moves
MODEL_WINDOW = 64
# the fit needs this many observations over >= 2 distinct padded sizes
MODEL_MIN_SAMPLES = 4
# demand EWMA smoothing (per closed slot)
DEMAND_ALPHA = 0.5
# dispatch when the estimated batch time exceeds this fraction of the
# seconds remaining in the current slot — waiting longer would finish the
# batch too late to matter for this slot's deadline-hit ratio
DEADLINE_SLACK = 0.8
# a cap's own batch duration must fit inside this fraction of the slot or
# a mid-slot dispatch finishes past the boundary — the latency half of the
# continuous-batching tradeoff (throughput wants wide batches, the slot
# deadline wants short ones); caps whose single-batch cost exceeds it are
# excluded from the ladder choice while any cap qualifies
CAP_LATENCY_FRACTION = 0.5
# a cap move needs at least this relative predicted-cost improvement over
# the incumbent: demand jitter around a cost-tie boundary (where two caps
# serve within a few percent of each other) must not flap the knob
CAP_IMPROVEMENT_MIN = 0.05
# watermark control: tighten while short-window burn >= 1x (error budget
# spending faster than sustainable), relax when it falls back under
WATERMARK_TIGHTEN_BURN = 1.0
WATERMARK_RELAX_BURN = 0.5
WATERMARK_STEP = 0.1
WATERMARK_FLOOR = 0.25
# urgent threshold: largest batch the fitted model serves within this
# budget rides the urgent lane (clamped to the hybrid router's sane range)
URGENT_BUDGET_MS = 25.0
URGENT_CLAMP = (1, 64)


def pow2ceil(n: int) -> int:
    """Padded lane count of an n-set batch (the torch backend's
    padding-bucket discipline: the kernels run at pow2 set buckets; the
    card's MIN_SETS = 4 floor is left out, as in the JAX package)."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


class Decision:
    """One batch-formation verdict."""

    __slots__ = ("dispatch", "cap", "reason")

    def __init__(self, dispatch: bool, cap: int, reason: str):
        self.dispatch = dispatch
        self.cap = cap
        self.reason = reason


class CapacityScheduler:
    """Owns batch formation + the closed-loop knob retuning for one
    BeaconProcessor. Construction is cheap and import-light; the autotune
    and flight-recorder hookups degrade silently-but-loudly (structured
    warns) when those subsystems are broken."""

    def __init__(self, config, admission=None, *, publish_plan: bool = False,
                 retune_enabled: bool = True):
        self.config = config
        self.admission = admission
        self.publish_plan = publish_plan
        self.retune_enabled = retune_enabled
        self._lock = threading.Lock()
        # live caps start from the config's resolution (installed plan or
        # defaults); explicit ctor/CLI caps are PINNED — the controller
        # never moves them (explicitness is self-describing)
        self.caps = {
            "gossip_attestation": int(config.max_attestation_batch),
            "gossip_aggregate": int(config.max_aggregate_batch),
        }
        self.pinned = {
            "gossip_attestation": bool(
                getattr(config, "max_attestation_batch_explicit", False)
            ),
            "gossip_aggregate": bool(
                getattr(config, "max_aggregate_batch_explicit", False)
            ),
        }
        # watermark bases come from the admission controller's configured
        # values; the live values move between [floor, base]
        self._wm_base = (
            (admission.bulk_watermark, admission.backfill_watermark)
            if admission is not None else (0.75, 0.5)
        )
        self.urgent_max_sets = None      # None until the model justifies one
        # cost model: (padded_n, secs) ring + the current (a, b) fit
        self._obs: deque = deque(maxlen=MODEL_WINDOW)
        self._fit: tuple | None = None   # (a, b) or None while cold
        # per-kind demand EWMA (admitted per slot), fed at slot close
        self._demand: dict[str, float] = {}
        # per-kind queue high-water observed by decide() since the last
        # retune tick: the BACKLOG signal. Cap choice targets
        # max(arrival EWMA, high-water) — a draining queue must be served
        # at backlog-sized batches, not at the (already falling) arrival
        # rate, or the controller shrinks caps exactly when the queue
        # most needs wide ones
        self._depth_hw: dict[str, int] = {}
        # deterministic mirrors of the Prometheus families (loadgen
        # reports embed these; seeds, not scrapes, must explain them)
        self.decisions: dict[tuple, int] = {}
        self.retunes: list[dict] = []
        self._retunes_bound = 256
        self.slots_seen = 0
        self.last_retune_slot: int | None = None
        # optional harness hook (loadgen/capacity.py): a callable
        # (kind_name, n) -> bool consulted FIRST; False holds the batch
        # even under force — the deterministic device-time ledger
        self._budget_gate = None
        self._slo_ref = None
        self._m_caps = {
            k: _BATCH_CAP.labels(k) for k in self.caps
        }
        for k, v in self.caps.items():
            self._m_caps[k].set(v)
        _WATERMARK.labels("bulk").set(self._wm_base[0])
        _WATERMARK.labels("backfill").set(self._wm_base[1])

    # ------------------------------------------------------------- wiring

    def bind_slo(self, accountant) -> None:
        """Subscribe to the accountant's slot closes (the control-loop
        tick). Re-binding (loadgen swaps the processor's accountant after
        construction) UNSUBSCRIBES from the old one first: the scheduler
        outlives the swap, so its weakref on the old accountant stays
        live — without the explicit removal a node-hosted processor
        rebound to a private accountant would tick on BOTH, feeding the
        demand EWMA another workload's admitted counts. Re-binding the
        SAME accountant is a no-op (a duplicate subscription would tick
        the loop twice per slot)."""
        if accountant is self._slo_ref:
            return
        old = self._slo_ref
        if old is not None:
            try:
                old.remove_close_listener(self.on_slot_close)
            except Exception:
                pass  # old accountant gone/ancient: nothing to drop
        self._slo_ref = accountant
        try:
            accountant.add_close_listener(self.on_slot_close)
        except Exception as e:  # pragma: no cover - accountant too old
            log.warn("slo close-listener hookup failed; retunes disabled",
                     error=f"{type(e).__name__}: {e}")

    def set_budget_gate(self, gate) -> None:
        self._budget_gate = gate

    def on_plan_installed(self, plan) -> None:
        """Autotune plan listener: a profile installed by someone else
        re-bases the unpinned caps; our own scheduler-sourced installs
        are ignored (no feedback loop)."""
        if plan is not None and str(getattr(plan, "source", "")).startswith(
            "scheduler:"
        ):
            return
        with self._lock:
            for kind, attr in (
                ("gossip_attestation", "max_attestation_batch"),
                ("gossip_aggregate", "max_aggregate_batch"),
            ):
                if self.pinned[kind]:
                    continue
                base = getattr(plan, attr, None) if plan is not None else None
                if base is None:
                    base = getattr(self.config, attr)
                self.caps[kind] = int(base)
                self._m_caps[kind].set(self.caps[kind])

    # ------------------------------------------------------------ decision

    def _count(self, kind: str, reason: str) -> None:
        # the mirror dict is read under the lock by stats() (the pipeline
        # ops endpoint): a first-ever key inserted lock-free would grow
        # the dict mid-iteration there
        with self._lock:
            self.decisions[(kind, reason)] = self.decisions.get(
                (kind, reason), 0
            ) + 1
        _DECISIONS.labels(kind, reason).inc()

    def _slot_slack(self) -> float | None:
        """Seconds left in the current slot, or None without a clock —
        read through the admission controller's slot clock, so loadgen's
        ManualSlotClock makes the deadline decision fully deterministic."""
        adm = self.admission
        clock = getattr(adm, "slot_clock", None) if adm is not None else None
        if clock is None:
            return None
        try:
            if clock.now() is None:
                return None
            return float(clock.duration_to_next_slot())
        except Exception:
            return None

    def est_secs(self, n: int) -> float | None:
        """Fitted batch verify time for n sets (padded), or None cold."""
        fit = self._fit
        if fit is None:
            return None
        a, b = fit
        return a + b * pow2ceil(n)

    def decide(self, kind, depth: int, *, inflight: int = 0,
               max_inflight: int = 1, force: bool = False) -> Decision:
        """The per-pop dispatch verdict for one batchable queue. Called
        under the processor lock: O(1), no blocking, no re-entry."""
        name = getattr(kind, "name", str(kind))
        with self._lock:
            cap = self.caps.get(name, MAX_CAP)
            gate = self._budget_gate
            if depth > self._depth_hw.get(name, 0):
                self._depth_hw[name] = depth
        n = min(depth, cap)
        if gate is not None and not gate(name, n):
            # the harness ledger says this batch does not fit the slot's
            # device budget: hold even under force — the epilogue clears
            # the gate when the run truly drains
            self._count(name, "budget")
            return Decision(False, cap, "budget")
        if depth >= cap:
            self._count(name, "cap_full")
            return Decision(True, cap, "cap_full")
        if force:
            self._count(name, "drain")
            return Decision(True, cap, "drain")
        slack = self._slot_slack()
        if slack is not None:
            est = self.est_secs(n)
            if est is not None and est >= slack * DEADLINE_SLACK:
                # waiting any longer finishes this batch past the slot
                # budget: go now with what we have
                self._count(name, "deadline")
                return Decision(True, cap, "deadline")
        if inflight < max_inflight:
            # a free device window slot: dispatching now is free, holding
            # would only add latency
            self._count(name, "idle")
            return Decision(True, cap, "idle")
        # device busy and budget slack remains: let the batch widen
        self._count(name, "coalesce")
        return Decision(False, cap, "coalesce")

    # --------------------------------------------------------------- model

    def observe_verify(self, kind, n_sets: int, secs: float) -> None:
        """One resolved batch's measured verify time feeds the cost fit."""
        if n_sets <= 0 or secs < 0:
            return
        with self._lock:
            self._obs.append((pow2ceil(n_sets), float(secs)))
            self._refit_locked()

    def _refit_locked(self) -> None:
        obs = self._obs
        if len(obs) < MODEL_MIN_SAMPLES:
            return
        xs = [o[0] for o in obs]
        if len(set(xs)) < 2:
            return                       # one padded size fits no line
        ys = [o[1] for o in obs]
        n = float(len(obs))
        mx = sum(xs) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        if sxx <= 0:
            return
        b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
        a = my - b * mx
        if b <= 0:
            return                       # nonsensical fit: keep the old one
        self._fit = (max(0.0, a), b)

    def _model_locked(self) -> dict:
        fit = self._fit
        return {
            "samples": len(self._obs),
            "base_secs": None if fit is None else round(fit[0], 6),
            "per_lane_secs": None if fit is None else round(fit[1], 9),
        }

    def model(self) -> dict:
        with self._lock:
            return self._model_locked()

    # -------------------------------------------------------------- retune

    def _best_cap_locked(self, demand: float,
                         latency_budget: float | None) -> int | None:
        """Cheapest ladder cap for one slot's demand under the fitted
        padded-cost model: minimize sum of per-batch base + padded-lane
        time over the batches a cap of C forms for D sets — subject to
        the LATENCY constraint that one full batch completes within
        `latency_budget` seconds (a cap whose own duration overruns the
        slot marks everything it carries late no matter how efficient
        its lanes are). Ties break DOWN (the ladder is walked ascending
        and only a strictly cheaper cap wins): when demand fits one batch
        under several caps the costs tie exactly, and the smallest tying
        cap is the stable choice — a jittering demand curve must not flap
        the cap between equivalent values."""
        fit = self._fit
        if fit is None or demand <= 0:
            return None
        a, b = fit
        best, best_cost = None, None
        d = max(1, int(round(demand)))
        for cap in CAP_LADDER:
            if (
                latency_budget is not None
                and best is not None
                and a + b * pow2ceil(cap) > latency_budget
            ):
                break    # over the latency budget; a qualifying cap exists
            cost = self._cap_cost_locked(cap, d)
            if best_cost is None or cost < best_cost - 1e-12:
                best, best_cost = cap, cost
        return best

    def _cap_cost_locked(self, cap: int, d: int) -> float:
        """Predicted device time to serve d sets at cap (padded lanes +
        per-batch base), under the current fit (caller checked it)."""
        a, b = self._fit
        full, rem = divmod(d, cap)
        batches = full + (1 if rem else 0)
        lanes = full * pow2ceil(cap) + (pow2ceil(rem) if rem else 0)
        return batches * a + lanes * b

    def _latency_budget(self) -> float | None:
        """CAP_LATENCY_FRACTION of the slot length, or None clockless."""
        adm = self.admission
        clock = getattr(adm, "slot_clock", None) if adm is not None else None
        sps = getattr(clock, "seconds_per_slot", None)
        if not sps:
            return None
        return float(sps) * CAP_LATENCY_FRACTION

    def _record_retune_locked(self, slot, knob, old, new, reason) -> None:
        direction = "up" if new > old else "down"
        _RETUNES.labels(knob, direction).inc()
        event = {"slot": slot, "knob": knob, "from": old, "to": new,
                 "reason": reason}
        self.retunes.append(event)
        if len(self.retunes) > self._retunes_bound:
            del self.retunes[: len(self.retunes) - self._retunes_bound]
        self.last_retune_slot = slot
        try:
            from ..observability.flight_recorder import RECORDER

            RECORDER.record("scheduler_retune", **event)
        except Exception:
            pass  # diagnostics must never break the control loop
        log.info("scheduler retune", **{k: str(v) for k, v in event.items()})

    def _breaker_closed(self) -> bool:
        """True unless the BLS device breaker is open: cap retuning must
        not learn from host-fallback latencies, and a wedged device is
        the breaker's problem, not a batch-sizing one. Scoped to the
        `bls_device` breaker — the path these caps feed; an open
        tree-hash or harness breaker says nothing about BLS batch
        sizing (the health endpoint scopes the same way, slo.health)."""
        try:
            from ..observability.flight_recorder import RECORDER

            return not RECORDER.open_breakers(prefix="bls_device")
        except Exception:
            return True

    def on_slot_close(self, report) -> None:
        """The control-loop tick: one closed SlotReport re-derives every
        unpinned knob. Deterministic — everything it reads (report
        counters, demand EWMA, the cost fit) is a pure function of the
        fed observations."""
        acct = self._slo_ref
        self.slots_seen += 1
        if not self.retune_enabled:
            return
        slot = getattr(report, "slot", 0)
        admitted = getattr(report, "admitted", {}) or {}
        retunes = []
        with self._lock:
            for kind in self.caps:
                d = float(admitted.get(kind, 0))
                if d <= 0:
                    # a traffic-free slot is no demand EVIDENCE, just an
                    # idle tick: decaying the estimate toward zero would
                    # shrink caps exactly when a quiet node should keep
                    # its learned sizing for the next burst
                    continue
                prev = self._demand.get(kind)
                self._demand[kind] = (
                    d if prev is None
                    else DEMAND_ALPHA * d + (1 - DEMAND_ALPHA) * prev
                )
        # ---- batch caps: model-predictive choice over the pow2 ladder
        if self._breaker_closed():
            budget = self._latency_budget()
            with self._lock:
                for kind, knob in (
                    ("gossip_attestation", "att_cap"),
                    ("gossip_aggregate", "agg_cap"),
                ):
                    hw = self._depth_hw.pop(kind, 0)
                    if self.pinned[kind]:
                        continue
                    if float(admitted.get(kind, 0)) <= 0 and hw <= 0:
                        continue     # no evidence this slot: hold the cap
                    target = max(self._demand.get(kind, 0.0), float(hw))
                    best = self._best_cap_locked(target, budget)
                    if best is None or best == self.caps[kind]:
                        continue
                    # hysteresis: only move for a real predicted win — a
                    # few-percent tie must not flap the knob with jitter
                    d_int = max(1, int(round(target)))
                    cur_cost = self._cap_cost_locked(self.caps[kind], d_int)
                    new_cost = self._cap_cost_locked(best, d_int)
                    lat_ok = budget is None or (
                        self._fit[0]
                        + self._fit[1] * pow2ceil(self.caps[kind])
                    ) <= budget
                    if lat_ok and new_cost > cur_cost * (
                        1.0 - CAP_IMPROVEMENT_MIN
                    ):
                        continue
                    retunes.append(
                        (slot, knob, self.caps[kind], best, "demand_model")
                    )
                    self.caps[kind] = best
                    self._m_caps[kind].set(best)
        # ---- admission watermarks: burn-driven tighten/relax
        adm = self.admission
        if adm is not None and acct is not None:
            try:
                burn = acct.window_summary("slot_5")["burn_rate"]
            except Exception:
                burn = 0.0
            bulk_base, backfill_base = self._wm_base
            bulk, backfill = adm.bulk_watermark, adm.backfill_watermark
            if burn >= WATERMARK_TIGHTEN_BURN:
                new_bulk = max(WATERMARK_FLOOR, bulk - WATERMARK_STEP)
                new_backfill = max(
                    WATERMARK_FLOOR, backfill - WATERMARK_STEP
                )
            elif burn < WATERMARK_RELAX_BURN:
                new_bulk = min(bulk_base, bulk + WATERMARK_STEP / 2)
                new_backfill = min(
                    backfill_base, backfill + WATERMARK_STEP / 2
                )
            else:
                new_bulk, new_backfill = bulk, backfill
            if abs(new_bulk - bulk) > 1e-9:
                retunes.append(
                    (slot, "bulk_watermark", round(bulk, 3),
                     round(new_bulk, 3), f"burn_{burn}")
                )
                adm.bulk_watermark = new_bulk
                _WATERMARK.labels("bulk").set(new_bulk)
            if abs(new_backfill - backfill) > 1e-9:
                retunes.append(
                    (slot, "backfill_watermark", round(backfill, 3),
                     round(new_backfill, 3), f"burn_{burn}")
                )
                adm.backfill_watermark = new_backfill
                _WATERMARK.labels("backfill").set(new_backfill)
        # ---- urgent threshold: largest batch inside the urgent budget
        with self._lock:
            fit = self._fit
            if fit is not None:
                a, b = fit
                budget = URGENT_BUDGET_MS / 1e3
                lo, hi = URGENT_CLAMP
                n = lo
                while n < hi and a + b * pow2ceil(n * 2) <= budget:
                    n *= 2
                if a + b * pow2ceil(lo) > budget:
                    n = lo
                if self.urgent_max_sets != n:
                    retunes.append(
                        (slot, "urgent_max_sets",
                         self.urgent_max_sets or 0, n, "latency_model")
                    )
                    self.urgent_max_sets = n
        with self._lock:
            for r in retunes:
                self._record_retune_locked(*r)
        if retunes and self.publish_plan:
            self._publish_plan()

    def _publish_plan(self) -> None:
        """Actuate the global knobs through the autotune plan-listener
        contract: consumers (hybrid router, torchbls dispatcher, the
        processor's own max_inflight listener) re-resolve with their env/
        CLI layers still winning. Never raises into the control loop."""
        try:
            from dataclasses import replace

            from ..autotune import runtime
            from ..autotune.planner import DEFAULT_PLAN

            base = runtime.active_plan() or DEFAULT_PLAN
            with self._lock:
                plan = replace(
                    base,
                    max_attestation_batch=self.caps["gossip_attestation"],
                    max_aggregate_batch=self.caps["gossip_aggregate"],
                    urgent_max_sets=(
                        self.urgent_max_sets
                        if self.urgent_max_sets is not None
                        else base.urgent_max_sets
                    ),
                    source=f"scheduler:{len(self.retunes)}",
                )
            runtime.install_runtime_plan(plan)
        except Exception as e:
            log.warn("scheduler plan publish failed",
                     error=f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------ snapshot

    def stats(self) -> dict:
        """Deterministic control-loop state for reports and the pipeline
        ops endpoint."""
        with self._lock:
            return {
                "caps": dict(self.caps),
                "pinned": {k: v for k, v in self.pinned.items() if v},
                "urgent_max_sets": self.urgent_max_sets,
                "watermarks": (
                    {
                        "bulk": round(self.admission.bulk_watermark, 3),
                        "backfill": round(
                            self.admission.backfill_watermark, 3
                        ),
                    }
                    if self.admission is not None else None
                ),
                "demand_ewma": {
                    k: round(v, 2) for k, v in self._demand.items()
                },
                "model": self._model_locked(),
                "decisions": {
                    f"{k}:{r}": n
                    for (k, r), n in sorted(self.decisions.items())
                },
                "retunes": list(self.retunes),
                "retune_count": len(self.retunes),
                "last_retune_slot": self.last_retune_slot,
                "slots_seen": self.slots_seen,
            }
