"""Admission control: priority classes, slot deadlines, shed accounting.

Parity surface: the reference's Work taxonomy orders every work kind
explicitly (beacon_processor/src/lib.rs:955-1090) and bounds each queue;
what it does NOT do is refuse work early — a flooded queue sheds on push.
Here the `AdmissionController` sits in front of `BeaconProcessor.submit`
and adds two things the reference gets from tokio back-pressure:

  - priority classes: bulk work (chain segments, P1 API requests) is
    refused once its queue crosses a watermark, and backfill earlier still,
    so a gossip flood cannot starve block import by filling the executor
    with low-value work first;
  - slot deadlines: batchable gossip work is stamped with the last slot at
    which processing it still matters (an attestation is only propagatable
    within ATTESTATION_PROPAGATION_SLOT_RANGE slots of its own slot, spec
    p2p-interface). Expiry is checked at POP time — the item already spent
    its queue residency, so it is counted `expired`, not `dropped`.

Every lost work item lands in `qos_shed_total{kind,reason}` exactly once:
reason="queue_full" (bounded-queue shed, oldest-first for batchable kinds),
reason="expired" (deadline passed at pop), reason="admission" (refused at
submit by class watermark). Deadlines are in SLOT units and read through
the chain's slot clock, so a ManualSlotClock makes every decision
deterministic under test.
"""

from __future__ import annotations

from enum import IntEnum

from ..utils.metrics import REGISTRY

# spec p2p-interface: beacon_attestation_{subnet_id} messages are only
# propagated while attestation.data.slot + ATTESTATION_PROPAGATION_SLOT_RANGE
# >= current_slot — past that the work is unactionable
ATTESTATION_PROPAGATION_SLOT_RANGE = 32

SHED_TOTAL = REGISTRY.counter_vec(
    "qos_shed_total",
    "work items lost to QoS decisions, by work kind and reason "
    "(queue_full / expired / admission)",
    ("kind", "reason"),
)


def count_shed(kind_name: str, reason: str) -> None:
    """One lost work item. The shed path is never hot (losing work is the
    exceptional outcome), so the family lookup per event is fine."""
    SHED_TOTAL.labels(kind_name, reason).inc()


class PriorityClass(IntEnum):
    """Coarse admission classes over the WorkKind priority order."""

    CRITICAL = 0   # block import, reprocess, proposal-path API
    TIMELY = 1     # slot-deadlined gossip (attestations, aggregates, sync)
    BULK = 2       # rpc blocks, chain segments, P1 API, pool ops
    BACKFILL = 3   # historical backfill — always the first to yield


# keyed by WorkKind.name (string) so this module never imports the
# processor (which imports this module)
_CLASS_BY_KIND = {
    "chain_reprocess": PriorityClass.CRITICAL,
    "gossip_block": PriorityClass.CRITICAL,
    "api_request_p0": PriorityClass.CRITICAL,
    "gossip_aggregate": PriorityClass.TIMELY,
    "gossip_attestation": PriorityClass.TIMELY,
    "gossip_sync_contribution": PriorityClass.TIMELY,
    "gossip_sync_signature": PriorityClass.TIMELY,
    "rpc_block": PriorityClass.BULK,
    "chain_segment": PriorityClass.BULK,
    "api_request_p1": PriorityClass.BULK,
    "gossip_voluntary_exit": PriorityClass.BULK,
    "gossip_proposer_slashing": PriorityClass.BULK,
    "gossip_attester_slashing": PriorityClass.BULK,
    "gossip_bls_change": PriorityClass.BULK,
    "backfill_segment": PriorityClass.BACKFILL,
}


class AdmissionController:
    """Submit-time admission + pop-time expiry decisions.

    Stateless apart from the slot clock reference: all queue state lives in
    the processor, which passes (depth, cap) in. Watermarks are fractions
    of each kind's own queue bound — bulk work yields at 75% of ITS queue,
    backfill at 50%, so the thresholds track whatever bounds the autotune
    plan or CLI configured.

    Reach note: today's live submit() producers are the gossip handlers
    (CRITICAL/TIMELY kinds only — sync still imports chain segments
    directly), so the BULK/BACKFILL watermarks currently engage only for
    loadgen/tests and for whatever future work routes rpc/backfill
    segments through the processor. The classes exist so that routing
    change is a one-liner, not a redesign."""

    def __init__(self, slot_clock=None, *, bulk_watermark: float = 0.75,
                 backfill_watermark: float = 0.5):
        self.slot_clock = slot_clock
        # LIVE watermarks: the capacity scheduler (chain/scheduler.py)
        # retunes these between [0.25, configured base] from the rolling
        # burn rate — tightened while timely work is burning error budget
        # (bulk yields earlier), relaxed back as it recovers. The
        # constructor values are the bases it relaxes toward; the live
        # values are exported as scheduler_admission_watermark{klass}.
        self.bulk_watermark = bulk_watermark
        self.backfill_watermark = backfill_watermark

    # ------------------------------------------------------------- clocks

    def current_slot(self):
        """Current slot via the chain's clock, or None (no clock / before
        genesis) — with no time source nothing ever expires."""
        if self.slot_clock is None:
            return None
        return self.slot_clock.now()

    # ---------------------------------------------------------- decisions

    @staticmethod
    def classify(kind) -> PriorityClass:
        name = getattr(kind, "name", str(kind))
        return _CLASS_BY_KIND.get(name, PriorityClass.TIMELY)

    def admit(self, kind, depth: int, cap: int) -> bool:
        """Submit-time decision for one work item given its queue's current
        depth and bound. CRITICAL/TIMELY are always admitted here — their
        bounded queues (and oldest-first shedding) do the protecting."""
        cls = self.classify(kind)
        if cls <= PriorityClass.TIMELY:
            return True
        watermark = (
            self.backfill_watermark
            if cls == PriorityClass.BACKFILL
            else self.bulk_watermark
        )
        return depth < cap * watermark

    def is_expired(self, item) -> bool:
        """Pop-time deadline check: True once the current slot is PAST the
        item's deadline slot (the deadline slot itself still processes)."""
        deadline = getattr(item, "deadline_slot", None)
        if deadline is None:
            return False
        now = self.current_slot()
        return now is not None and now > deadline

    @staticmethod
    def attestation_deadline_slot(att_slot: int) -> int:
        """Last slot at which gossip attestation/aggregate work for
        `att_slot` is still propagatable (spec propagation window)."""
        return int(att_slot) + ATTESTATION_PROPAGATION_SLOT_RANGE
