"""SlasherService — evidence assembly + broadcast.

Parity surface: lighthouse/slasher/service/src/lib.rs — owns the
detector, runs its epoch batch, and turns found evidence into
ProposerSlashing / AttesterSlashing containers pushed into the operation
pool (whence they reach blocks and gossip). The detector itself stores only
compact records (roots, source/target epochs); this service retains the
signed messages needed to ASSEMBLE on-chain evidence."""

from __future__ import annotations

from .slasher import AttestationRecord, ProposalRecord, Slasher


class SlasherService:
    """Duck-types the chain's `slasher` feed (accept_proposal /
    accept_attestation) and drives detection + broadcast."""

    def __init__(self, op_pool=None, types=None, slasher: Slasher | None = None):
        self.slasher = slasher or Slasher()
        self.op_pool = op_pool
        self.types = types
        # evidence side-tables: compact key -> signed message
        self._headers: dict[tuple[int, int, bytes], object] = {}
        self._atts: dict[tuple[int, int, bytes], object] = {}
        self.broadcast: list = []        # assembled slashing containers

    # ------------------------------------------------------------- feeds

    def accept_proposal(self, rec: ProposalRecord) -> None:
        if rec.signed_header is not None:
            self._headers[(rec.proposer_index, rec.slot, rec.block_root)] = rec.signed_header
        self.slasher.accept_proposal(rec)

    def accept_attestation(self, rec: AttestationRecord) -> None:
        if rec.indexed is not None:
            self._atts[(rec.validator_index, rec.target, rec.data_root)] = rec.indexed
        self.slasher.accept_attestation(rec)

    # ------------------------------------------------------------- batch

    def process(self) -> int:
        """Run the detector batch and assemble/broadcast what it found.
        Returns the number of slashings broadcast."""
        found = self.slasher.process_queued()
        n = 0
        for ev in found:
            built = None
            if ev.kind == "double_proposal":
                built = self._build_proposer_slashing(ev)
            elif ev.kind in ("double_vote", "surround"):
                built = self._build_attester_slashing(ev)
            if built is not None:
                self.broadcast.append(built)
                n += 1
                if self.op_pool is not None:
                    if ev.kind == "double_proposal":
                        self.op_pool.insert_proposer_slashing(built)
                    else:
                        self.op_pool.insert_attester_slashing(built)
        return n

    def prune(self, finalized_epoch: int, slots_per_epoch: int,
              history_epochs: int = 4096) -> int:
        """Drop detector + side-table history below the retention horizon
        (finalized - history). The node calls this as finalization
        advances (service/src/lib.rs prune cadence)."""
        horizon = max(0, finalized_epoch - history_epochs)
        if horizon == 0:
            return 0
        n = self.slasher.prune(horizon, before_slot=horizon * slots_per_epoch)
        self._atts = {
            k: v for k, v in self._atts.items() if k[1] >= horizon
        }
        self._headers = {
            k: v for k, v in self._headers.items()
            if k[1] >= horizon * slots_per_epoch
        }
        return n

    def _build_proposer_slashing(self, ev):
        if self.types is None:
            return None
        rec = ev.new
        prior_root = ev.prior if isinstance(ev.prior, bytes) else None
        h1 = self._headers.get((rec.proposer_index, rec.slot, prior_root)) if prior_root else None
        h2 = rec.signed_header or self._headers.get(
            (rec.proposer_index, rec.slot, rec.block_root)
        )
        if h1 is None or h2 is None:
            return None
        return self.types.ProposerSlashing.make(
            signed_header_1=h1, signed_header_2=h2
        )

    def _build_attester_slashing(self, ev):
        if self.types is None:
            return None
        rec = ev.new
        att2 = rec.indexed or self._atts.get(
            (rec.validator_index, rec.target, rec.data_root)
        )
        att1 = None
        if ev.kind == "double_vote" and isinstance(ev.prior, bytes):
            # detector's prior record is source(8) + target(8) + data_root(32)
            prior_root = ev.prior[16:48]
            att1 = self._atts.get((rec.validator_index, rec.target, prior_root))
        elif ev.kind == "surround" and isinstance(ev.prior, tuple):
            _why, other_target = ev.prior
            for (v, t, _root), indexed in self._atts.items():
                if v == rec.validator_index and t == other_target:
                    att1 = indexed
                    break
        if att1 is None or att2 is None:
            return None
        return self.types.AttesterSlashing.make(
            attestation_1=att1, attestation_2=att2
        )
