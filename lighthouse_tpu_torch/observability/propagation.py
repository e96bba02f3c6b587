"""Cross-node causal observability: wire trace context + propagation SLIs.

The span tracer ends at the node boundary — `Trace.trace_id` is a node-local
counter, so a block's producer-side publish and its consumer-side
validate/import spans on another node share nothing. This module makes
message causality a first-class observable:

  - `WireTraceContext`: the compact origin context every gossip publish
    (and Req/Resp request, transport frame CREQ) carries on the wire —
    origin node id, the origin's trace id, the slot, a logical publish
    offset (`seq`, the origin's per-process publish counter) and the
    origin clock reading at publish (`sent_at`). The receiving node adopts
    it into its local `Trace` (`Trace.adopt`), so the publish span and
    every remote validate/import span share one causal id — and the merged
    Perfetto export (`trace.merge_chrome_traces`) links them with flow
    events.
  - `PropagationTracker`: one per node. First-delivery latencies feed the
    labeled `net_propagation_seconds{topic}` histogram and a bounded
    per-topic sample list; block time-to-head (publish -> this node's
    fork-choice head update) feeds `net_time_to_head_seconds{role}`.
    Latency = receiver clock minus `sent_at` on the SAME clock surface
    (`SlotClock._time()`): wall seconds on a live node (cross-node NTP
    skew is the usual caveat), LOGICAL slot-time under the deterministic
    multinode harness's ManualSlotClocks — so harness distributions are a
    pure function of the seed.
  - Propagation-stall trigger: `close_slot()` (driven per slot by the
    harness / the bn slot timer) counts consecutive slots in which the
    node had >= 1 connected peer but received NOTHING over gossip; at
    `stall_slots` it fires the flight recorder's `propagation_stall`
    incident (hysteresis: re-armed by the first delivery, like the
    breaker/burn triggers) — the partitioned minority's view of a
    partition window becomes a durable, schema-valid dump.
  - `build_cluster_report`: the deterministic cluster rollup the multinode
    and fleet scenario reports embed — cluster deadline-hit ratio over
    every node's SLO accountant, per-node outliers, per-topic propagation
    p50/p95 merged across nodes, stall counts. Everything in it derives
    from logical clocks and integer counters, so it is bit-identical
    across reruns of one seed.
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
from dataclasses import dataclass

from ..utils.metrics import REGISTRY

#: propagation spans link ranges: sub-ms localhost hops to multi-slot
#: delayed links (logical seconds under the harness clamp to slot grid)
_PROP_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0,
    16.0, 32.0,
)

NET_PROPAGATION = REGISTRY.histogram_vec(
    "net_propagation_seconds",
    "gossip first-delivery latency (origin publish to this node's first "
    "receipt, sender/receiver clock surfaces), by topic",
    ("topic",),
    buckets=_PROP_BUCKETS,
)
NET_TIME_TO_HEAD = REGISTRY.histogram_vec(
    "net_time_to_head_seconds",
    "block publish to this node's fork-choice head update, by role "
    "(remote = a propagated block became our head)",
    ("role",),
    buckets=_PROP_BUCKETS,
)
NET_CTX = REGISTRY.counter_vec(
    "net_trace_context_total",
    "wire trace-context lifecycle events, by event (sent / delivered / "
    "missing = a gossip first delivery carried no context / req_sent / "
    "req_adopted)",
    ("event",),
)

#: consecutive delivery-free slots (with peers connected) before the
#: propagation_stall incident fires
DEFAULT_STALL_SLOTS = 2

#: bound on retained latency samples per topic (the quantile source for
#: the cluster rollup; the histogram familiy keeps the full distribution)
MAX_SAMPLES = 4096

#: a node whose deadline-hit ratio sits this far under the cluster-wide
#: ratio is an outlier in the cluster rollup
OUTLIER_MARGIN = 0.05

CTX_VERSION = 1
_CTX_TAIL = struct.Struct(">QIId")     # trace_id, slot, seq, sent_at


@dataclass(frozen=True)
class WireTraceContext:
    """Compact origin context carried in gossip/Req-Resp frame envelopes."""

    origin: str          # publishing node id
    trace_id: int        # origin-local Trace id (the causal key)
    slot: int            # slot at publish time
    seq: int             # origin's logical publish offset (per process)
    sent_at: float       # origin SlotClock._time() reading at publish

    def causal_id(self) -> str:
        return f"{self.origin}:{self.trace_id}"


def encode_ctx(ctx: WireTraceContext) -> bytes:
    origin = ctx.origin.encode()[:255]
    return (
        struct.pack(">BB", CTX_VERSION, len(origin))
        + origin
        + _CTX_TAIL.pack(
            ctx.trace_id & 0xFFFFFFFFFFFFFFFF,
            max(0, int(ctx.slot)) & 0xFFFFFFFF,
            max(0, int(ctx.seq)) & 0xFFFFFFFF,
            float(ctx.sent_at),
        )
    )


def decode_ctx(buf: bytes | None) -> WireTraceContext | None:
    """Tolerant decode: None on garbage/unknown versions — a malformed
    context must never fail the message it rode in on (observability can
    degrade; delivery cannot)."""
    if not buf:
        return None
    try:
        ver, ln = buf[0], buf[1]
        if ver != CTX_VERSION:
            return None
        origin = buf[2 : 2 + ln].decode()
        trace_id, slot, seq, sent_at = _CTX_TAIL.unpack_from(buf, 2 + ln)
    except (IndexError, struct.error, UnicodeDecodeError):
        return None
    return WireTraceContext(origin, trace_id, slot, seq, sent_at)


def flow_id(ctx: WireTraceContext) -> int:
    """Stable Perfetto flow id for one causal chain: a 48-bit digest of
    (origin, trace_id) — JSON-safe, identical on every node that saw the
    message."""
    h = hashlib.sha256(ctx.causal_id().encode()).digest()
    return int.from_bytes(h[:6], "big")


def short_topic(topic: str) -> str:
    """Label-cardinality-safe topic name: '/eth2/<fd>/<name>/ssz_snappy'
    -> '<name>' with the subnet index collapsed (beacon_attestation_5 ->
    beacon_attestation), so SLIs aggregate per topic FAMILY and survive
    fork-digest changes."""
    parts = topic.split("/")
    name = parts[3] if len(parts) >= 5 else topic
    stem, _, tail = name.rpartition("_")
    if stem and tail.isdigit():
        return stem
    return name


# ------------------------------------------------ thread-local wire context

# ONE owner: the thread-local lives in trace.py so `Tracer.begin` can
# auto-adopt it without a propagation import on the begin hot path;
# re-exported here because this module is the wire-context API surface
from .trace import current_wire_ctx, set_current_wire_ctx  # noqa: E402,F401


# ------------------------------------------------------------------ tracker

# ONE quantile owner for the whole observability package: the SLO
# engine's nearest-rank helper — a second copy here could silently
# diverge from the window quantiles operators compare these against
from .slo import _quantile as quantile  # noqa: E402


class PropagationTracker:
    """Per-node propagation SLI accountant + stall trigger."""

    def __init__(self, node_id: str, clock=None, recorder=None,
                 stall_slots: int = DEFAULT_STALL_SLOTS):
        self.node_id = node_id
        self.clock = clock                 # SlotClock; None = wall time
        self._recorder = recorder          # None = the global RECORDER
        self.slo_provider = None           # optional () -> slo snapshot
        self.stall_slots = int(stall_slots)
        self._lock = threading.Lock()
        self._samples: dict[str, list[float]] = {}   # topic -> latencies
        self._overflow: dict[str, int] = {}
        self.publishes: dict[str, int] = {}
        self.deliveries: dict[str, int] = {}
        self.ctx_missing = 0
        self._tth: list[float] = []        # remote block time-to-head
        self._tth_overflow = 0
        self._delivered_since_close = False
        self.stall_streak = 0
        self.stalls_fired = 0
        # True while a fired stall episode is still disarmed on the
        # recorder; whatever ends the episode (a delivery OR the streak
        # resetting at close, e.g. every peer disconnected) must clear —
        # a key left disarmed would silence every later stall for the
        # life of the process
        self._stall_active = False
        # close watermark (the SlotAccountant discipline): the bn slot
        # timer can tick twice inside one slot (a wakeup ~1ms early), and
        # a double close must not count one quiet slot as two
        self._closed_through: int | None = None

    # ----------------------------------------------------------- plumbing

    def _rec(self):
        if self._recorder is None:
            from . import flight_recorder

            self._recorder = flight_recorder.RECORDER
        return self._recorder

    def now(self) -> float:
        """The clock surface `sent_at` is compared against: the slot
        clock's raw time (logical under ManualSlotClock — the harness's
        determinism), wall time without one."""
        if self.clock is not None:
            try:
                return float(self.clock._time())
            except Exception:
                pass
        return time.time()

    def current_slot(self) -> int:
        if self.clock is not None:
            try:
                return int(self.clock.now() or 0)
            except Exception:
                return 0
        return 0

    # -------------------------------------------------------------- feeds

    def note_publish(self, topic: str) -> None:
        st = short_topic(topic)
        with self._lock:
            self.publishes[st] = self.publishes.get(st, 0) + 1
        NET_CTX.labels("sent").inc()

    def note_delivery(self, topic: str, ctx: WireTraceContext | None) -> None:
        """One gossip FIRST delivery arrived (duplicates never re-feed).
        With a context, the origin-to-here latency lands in the histogram
        and the bounded sample list; without one it is counted missing.
        Either way the delivery re-arms the stall trigger."""
        st = short_topic(topic)
        fire_clear = False
        # one clock read per delivery: the histogram and the retained
        # sample must agree on the SAME latency value
        lat = None if ctx is None else round(
            max(0.0, self.now() - ctx.sent_at), 6
        )
        with self._lock:
            self.deliveries[st] = self.deliveries.get(st, 0) + 1
            if self._stall_active:
                fire_clear = True
                self._stall_active = False
            self.stall_streak = 0
            self._delivered_since_close = True
            if lat is None:
                self.ctx_missing += 1
            else:
                bucket = self._samples.setdefault(st, [])
                if len(bucket) < MAX_SAMPLES:
                    bucket.append(lat)
                else:
                    self._overflow[st] = self._overflow.get(st, 0) + 1
        if lat is None:
            NET_CTX.labels("missing").inc()
        else:
            NET_CTX.labels("delivered").inc()
            NET_PROPAGATION.labels(st).observe(lat)
        if fire_clear:
            self._rec().clear(
                "propagation_stall", key=f"propagation_stall:{self.node_id}"
            )

    def note_time_to_head(self, ctx: WireTraceContext) -> None:
        """A propagated block just became this node's fork-choice head."""
        dt = round(max(0.0, self.now() - ctx.sent_at), 6)
        with self._lock:
            if len(self._tth) < MAX_SAMPLES:
                self._tth.append(dt)
            else:
                self._tth_overflow += 1
        NET_TIME_TO_HEAD.labels("remote").observe(dt)

    # ------------------------------------------------------ slot boundary

    def close_slot(self, slot: int, peers: int) -> bool:
        """Per-slot stall bookkeeping (the harness slot loop / bn slot
        timer drives it): a slot with connected peers and zero gossip
        deliveries extends the stall streak; `stall_slots` consecutive
        ones fire ONE propagation_stall incident (flight-recorder
        hysteresis keys on this node; the next delivery re-arms).
        Watermarked per slot (the SlotAccountant discipline): a repeat
        close of an already-closed slot is a no-op. Returns True when the
        trigger fired this close."""
        clear = False
        with self._lock:
            if self._closed_through is not None and slot <= self._closed_through:
                return False
            self._closed_through = slot
            delivered = self._delivered_since_close
            self._delivered_since_close = False
            if peers > 0 and not delivered:
                self.stall_streak += 1
            else:
                # the episode ended without a delivery (peers gone, or a
                # delivery raced the close): re-arm here too, or the
                # trigger key would stay disarmed forever
                if self.stall_streak and self._stall_active:
                    clear = True
                    self._stall_active = False
                self.stall_streak = 0
            streak = self.stall_streak
            fire = streak == self.stall_slots
            if fire:
                self.stalls_fired += 1
        if clear:
            self._rec().clear(
                "propagation_stall", key=f"propagation_stall:{self.node_id}"
            )
        if fire:
            self._rec().trigger(
                "propagation_stall",
                key=f"propagation_stall:{self.node_id}",
                node=self.node_id, slot=slot, streak=streak, peers=peers,
                slo=self.slo_provider,
            )
            # publish the active episode AFTER the trigger disarmed the
            # key, then re-check: a delivery racing this close (streak
            # already reset) means the episode is over — re-arm NOW, or
            # the delivery-side clear (which checks _stall_active) could
            # have run before our trigger and the key would stay disarmed
            # for every later stall
            raced = False
            with self._lock:
                if self.stall_streak >= self.stall_slots:
                    self._stall_active = True
                else:
                    raced = True
            if raced:
                self._rec().clear(
                    "propagation_stall",
                    key=f"propagation_stall:{self.node_id}",
                )
        return fire

    # ----------------------------------------------------------- snapshot

    def topic_quantiles(self) -> dict:
        """Deterministic per-topic first-delivery distribution (rounded
        logical/wall seconds; sample ORDER cannot matter — quantiles read
        a sorted copy)."""
        with self._lock:
            out = {}
            for st in sorted(set(self._samples) | set(self.deliveries)):
                vals = sorted(self._samples.get(st, ()))
                out[st] = {
                    "deliveries": self.deliveries.get(st, 0),
                    "publishes": self.publishes.get(st, 0),
                    "n": len(vals) + self._overflow.get(st, 0),
                    "p50": round(quantile(vals, 0.50), 6),
                    "p95": round(quantile(vals, 0.95), 6),
                    "max": round(vals[-1], 6) if vals else 0.0,
                }
            return out

    def samples(self) -> dict[str, list[float]]:
        with self._lock:
            return {t: list(v) for t, v in self._samples.items()}

    def time_to_head_samples(self) -> list[float]:
        with self._lock:
            return list(self._tth)

    def snapshot(self) -> dict:
        snap = {
            "node": self.node_id,
            "topics": self.topic_quantiles(),
            "ctx_missing": self.ctx_missing,
            "stall_streak": self.stall_streak,
            "stalls_fired": self.stalls_fired,
        }
        tth = sorted(self.time_to_head_samples())
        snap["time_to_head"] = {
            "n": len(tth) + self._tth_overflow,
            "p50": round(quantile(tth, 0.50), 6),
            "p95": round(quantile(tth, 0.95), 6),
        }
        return snap


# ------------------------------------------------------------ cluster rollup


def build_cluster_report(nodes, http_api=None) -> dict:
    """The deterministic cluster block for multinode/fleet scenario
    reports. `nodes` is an iterable of (index, SlotAccountant,
    PropagationTracker) triples in index order. Everything here derives
    from integer counters and logical-clock samples, so a rerun of the
    same seed reproduces it bit-for-bit.

    `http_api` (optional) is the fleet HTTP leg's per-route series block —
    scheduled request counts per `http_api_request_seconds` route, which
    are a pure function of the scenario seed. It lands under the
    `"http_api"` key verbatim; wall-clock latency quantiles stay OUT of
    this block (they live in the report's observations)."""
    hits = misses = 0
    per_node_ratio: dict[str, float | None] = {}
    merged: dict[str, list[float]] = {}
    merged_n: dict[str, int] = {}
    deliveries: dict[str, int] = {}
    publishes: dict[str, int] = {}
    tth: list[float] = []
    stalls: dict[str, int] = {}
    for idx, acct, tracker in nodes:
        h, m = acct.deadline_totals()
        hits += h
        misses += m
        total = h + m
        per_node_ratio[str(idx)] = (
            None if total == 0 else round(h / total, 4)
        )
        for st, vals in sorted(tracker.samples().items()):
            merged.setdefault(st, []).extend(vals)
        for st, q in tracker.topic_quantiles().items():
            merged_n[st] = merged_n.get(st, 0) + q["n"]
            deliveries[st] = deliveries.get(st, 0) + q["deliveries"]
            publishes[st] = publishes.get(st, 0) + q["publishes"]
        tth.extend(tracker.time_to_head_samples())
        if tracker.stalls_fired:
            stalls[str(idx)] = tracker.stalls_fired
    total = hits + misses
    ratio = None if total == 0 else round(hits / total, 4)
    outliers = sorted(
        (idx for idx, r in per_node_ratio.items()
         if r is not None and ratio is not None
         and r < ratio - OUTLIER_MARGIN),
        key=int,
    )
    propagation = {}
    # union with the delivery-counted topics: a topic whose deliveries all
    # arrived context-less still belongs in the rollup (with empty
    # quantiles) — the degraded-observability case must stay visible
    for st in sorted(set(merged) | set(deliveries)):
        vals = sorted(merged.get(st, ()))
        propagation[st] = {
            "n": merged_n.get(st, len(vals)),
            "deliveries": deliveries.get(st, 0),
            "publishes": publishes.get(st, 0),
            "p50": round(quantile(vals, 0.50), 6),
            "p95": round(quantile(vals, 0.95), 6),
            "max": round(vals[-1], 6) if vals else 0.0,
        }
    tth_sorted = sorted(tth)
    report = {
        "deadline_hits": hits,
        "deadline_misses": misses,
        "deadline_hit_ratio": ratio,
        "per_node_hit_ratio": per_node_ratio,
        "outlier_nodes": outliers,
        "propagation": propagation,
        "time_to_head": {
            "n": len(tth_sorted),
            "p50": round(quantile(tth_sorted, 0.50), 6),
            "p95": round(quantile(tth_sorted, 0.95), 6),
        },
        "propagation_stalls": stalls,
    }
    if http_api is not None:
        report["http_api"] = http_api
    return report
