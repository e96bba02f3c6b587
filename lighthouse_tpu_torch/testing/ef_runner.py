"""EF consensus-spec-tests vector runner.

Parity surface: lighthouse/testing/ef_tests/src/handler.rs:10-32 — a
Handler walks `tests/{config}/{fork}/{runner}/{handler}/{suite}/{case}/`
directories and dispatches each case directory to a typed runner; every
file in a consumed case must be read (check_all_files_accessed.py analog:
`run_case` records accesses and `assert_all_files_accessed` fails on
leftovers).

Vector format is the official one (pre/post.ssz_snappy, meta.yaml,
blocks_N.ssz_snappy, data.yaml ...), so official tarballs dropped under the
vector root run unchanged. The committed vectors under tests/ef/vectors
are regression vectors generated by scripts/gen_ef_vectors.py from the JAX
package; the port's copy of its runner holds the port to them.

Case runners implemented: ssz_static, shuffling, sanity/slots,
sanity/blocks, operations/*, epoch_processing/*, rewards, finality,
transition, fork, fork_choice, bls/*, kzg/*. The signatures go through
whatever BLS backend is active ("torch", the default, verifies each
block's batch on the card). The YAML files are read by `read_yaml`, not
PyYAML.
"""

from __future__ import annotations

from pathlib import Path

from ..crypto import bls
from ..network import snappy
from ..state_transition import accessors as acc
from ..state_transition import block as blk
from ..state_transition import epoch as ep
from ..state_transition.block import BlockProcessingError, SignatureStrategy, per_block_processing
from ..state_transition.slot import process_slots, types_for_slot, upgrade_state
from ..types.containers import spec_types
from ..types.helpers import compute_shuffled_index
from ..types.spec import ForkName, mainnet_spec, minimal_spec
from ..utils.yaml_lite import read_yaml


class EfTestError(AssertionError):
    pass


class VectorAccess:
    """Tracks file reads so unconsumed vector files fail the run."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.accessed: set[Path] = set()

    def read(self, case_dir: Path, name: str) -> bytes | None:
        p = case_dir / name
        if not p.exists():
            return None
        self.accessed.add(p)
        return p.read_bytes()

    def read_ssz(self, case_dir: Path, name: str) -> bytes | None:
        raw = self.read(case_dir, name)
        if raw is None:
            return None
        return snappy.decompress(raw)

    def read_yaml(self, case_dir: Path, name: str):
        raw = self.read(case_dir, name)
        if raw is None:
            return None
        return read_yaml(raw.decode())

    def assert_all_files_accessed(self) -> None:
        all_files = {p for p in self.root.rglob("*") if p.is_file()}
        left = all_files - self.accessed
        if left:
            raise EfTestError(
                f"{len(left)} vector files never consumed, e.g. "
                f"{sorted(left)[:5]}"
            )


_FORK_ORDER = ["phase0", "altair", "bellatrix", "capella", "deneb", "electra"]


def spec_at_fork(config: str, fork: str, fork_epoch_overrides: dict | None = None):
    """A spec with `fork` active from genesis and LATER forks disabled —
    vectors under {config}/{fork}/ must run with that fork's rules (the
    reference monomorphizes per fork; we pin the runtime spec instead)."""
    overrides: dict = {}
    for i, f in enumerate(_FORK_ORDER[1:], start=1):
        overrides[f + "_fork_epoch"] = 0 if i <= _FORK_ORDER.index(fork) else None
    if fork_epoch_overrides:
        overrides.update(fork_epoch_overrides)
    if config == "minimal":
        return minimal_spec(**overrides)
    import dataclasses

    return dataclasses.replace(mainnet_spec(), **overrides)


def _spec_for(config: str, fork: str = "deneb"):
    return spec_at_fork(config, fork)


def _fork_types(spec, fork: str):
    return spec_types(spec.preset, ForkName[fork])


def _verify_now(batch_sets: list) -> None:
    if batch_sets and not bls.verify_signature_sets(batch_sets):
        raise BlockProcessingError("signature invalid")


def _op_attestation(st, sp, t, op, f):
    sets: list = []
    blk.process_attestation(st, sp, t, op, f, sets.append, _pkg(st), {})
    _verify_now(sets)


def _op_attester_slashing(st, sp, t, op, f):
    sets: list = []
    blk.process_attester_slashing(st, sp, t, op, f, sets.append, _pkg(st))
    _verify_now(sets)


def _op_proposer_slashing(st, sp, t, op, f):
    sets: list = []
    blk.process_proposer_slashing(st, sp, t, op, f, sets.append, _pkg(st))
    _verify_now(sets)


def _op_voluntary_exit(st, sp, t, op, f):
    sets: list = []
    blk.process_voluntary_exit(st, sp, t, op, sets.append, _pkg(st))
    _verify_now(sets)


def _op_bls_change(st, sp, t, op, f):
    sets: list = []
    blk.process_bls_to_execution_change(st, sp, t, op, sets.append)
    _verify_now(sets)


def _op_sync_aggregate(st, sp, t, op, f):
    import types as _pytypes

    shim = _pytypes.SimpleNamespace(
        slot=st.slot, body=_pytypes.SimpleNamespace(sync_aggregate=op)
    )
    sets: list = []
    blk.process_sync_aggregate(st, sp, t, shim, sets.append, _pkg(st))
    _verify_now(sets)


def _electra_op(fn):
    def run(st, sp, t, op, f):
        from ..state_transition import electra as el

        getattr(el, fn)(st, sp, t, op)

    return run


OPERATION_RUNNERS = {
    # handler name -> (input file stem, apply(state, spec, types, op, fork))
    "attestation": ("attestation", _op_attestation),
    "attester_slashing": ("attester_slashing", _op_attester_slashing),
    "proposer_slashing": ("proposer_slashing", _op_proposer_slashing),
    "deposit": ("deposit", lambda st, sp, t, op, f: blk.process_deposit(st, sp, t, op, f)),
    "voluntary_exit": ("voluntary_exit", _op_voluntary_exit),
    "bls_to_execution_change": ("address_change", _op_bls_change),
    "sync_aggregate": ("sync_aggregate", _op_sync_aggregate),
    # electra execution requests (EIP-6110/7002/7251)
    "deposit_request": ("deposit_request", _electra_op("process_deposit_request")),
    "withdrawal_request": (
        "withdrawal_request", _electra_op("process_withdrawal_request"),
    ),
    "consolidation_request": (
        "consolidation_request", _electra_op("process_consolidation_request"),
    ),
}

def _rewards_and_penalties(st, sp, t, f):
    if f == ForkName.phase0:
        ep._process_rewards_and_penalties_phase0(st, sp, t)
    else:
        ep.process_rewards_and_penalties_altair(st, sp, f)


def _registry_updates(st, sp, t, f):
    if f >= ForkName.electra:
        from ..state_transition import electra as el

        el.process_registry_updates_electra(st, sp)
    else:
        ep.process_registry_updates(st, sp)


def _slashings(st, sp, t, f):
    if f >= ForkName.electra:
        from ..state_transition import electra as el

        el.process_slashings_electra(st, sp)
    else:
        ep.process_slashings(st, sp, f)


def _effective_balances(st, sp, t, f):
    if f >= ForkName.electra:
        from ..state_transition import electra as el

        el.process_effective_balance_updates_electra(st, sp)
    else:
        ep.process_effective_balance_updates(st, sp)


def _participation_records(st, sp, t, f):
    # phase0: rotate the pending-attestation records
    st.previous_epoch_attestations = st.current_epoch_attestations
    st.current_epoch_attestations = []


def _pending_deposits(st, sp, t, f):
    from ..state_transition import electra as el

    el.process_pending_deposits(st, sp, t)


def _pending_consolidations(st, sp, t, f):
    from ..state_transition import electra as el

    el.process_pending_consolidations(st, sp)


EPOCH_RUNNERS = {
    # handler -> fn(state, spec, types, fork); fork-dispatching where the
    # spec's transition differs per fork
    "justification_and_finalization": lambda st, sp, t, f: ep.process_justification_and_finalization(st, sp, t, f),
    "inactivity_updates": lambda st, sp, t, f: ep.process_inactivity_updates(st, sp),
    "rewards_and_penalties": _rewards_and_penalties,
    "registry_updates": _registry_updates,
    "slashings": _slashings,
    "effective_balance_updates": _effective_balances,
    "eth1_data_reset": lambda st, sp, t, f: ep.process_eth1_data_reset(st, sp),
    "slashings_reset": lambda st, sp, t, f: ep.process_slashings_reset(st, sp),
    "randao_mixes_reset": lambda st, sp, t, f: ep.process_randao_mixes_reset(st, sp),
    "historical_roots_update": lambda st, sp, t, f: ep.process_historical_roots_update(st, sp, t),
    "historical_summaries_update": lambda st, sp, t, f: ep.process_historical_summaries_update(st, sp, t),
    "participation_flag_updates": lambda st, sp, t, f: ep.process_participation_flag_updates(st),
    "participation_record_updates": _participation_records,
    "sync_committee_updates": lambda st, sp, t, f: ep.process_sync_committee_updates(st, sp, t),
    "pending_deposits": _pending_deposits,
    "pending_consolidations": _pending_consolidations,
}


def _pkg(state):
    """Pubkey getter over the state registry (EF vectors carry no cache)."""
    cache: dict[int, object] = {}

    def get(i: int):
        if i not in cache:
            cache[i] = bls.PublicKey.deserialize(bytes(state.validators[i].pubkey))
        return cache[i]

    return get


def run_case(va: VectorAccess, config: str, fork: str, runner: str,
             handler: str, case_dir: Path) -> None:
    """Dispatch one case directory. Raises EfTestError on mismatch."""
    spec = _spec_for(config, fork)
    types = _fork_types(spec, fork)

    if runner == "ssz_static":
        _run_ssz_static(va, types, handler, case_dir)
    elif runner == "shuffling":
        _run_shuffling(va, spec, case_dir)
    elif runner == "sanity" and handler == "slots":
        _run_sanity_slots(va, spec, types, case_dir)
    elif runner == "sanity" and handler == "blocks":
        _run_sanity_blocks(va, spec, types, fork, case_dir)
    elif runner == "finality":
        _run_sanity_blocks(va, spec, types, fork, case_dir)
    elif runner == "operations":
        _run_operation(va, spec, types, fork, handler, case_dir)
    elif runner == "epoch_processing":
        _run_epoch(va, spec, types, fork, handler, case_dir)
    elif runner == "rewards":
        _run_rewards(va, spec, types, fork, case_dir)
    elif runner == "fork":
        _run_fork_upgrade(va, spec, fork, case_dir)
    elif runner == "transition":
        _run_transition(va, config, fork, case_dir)
    elif runner == "fork_choice":
        _run_fork_choice(va, spec, fork, case_dir)
    elif runner == "bls":
        _run_bls(va, handler, case_dir)
    elif runner == "kzg":
        _run_kzg(va, handler, case_dir)
    else:
        raise EfTestError(f"no runner for {runner}/{handler}")


# ------------------------------------------------------------ case runners


def _state_pair(va, types, case_dir):
    pre = types.BeaconState.deserialize(va.read_ssz(case_dir, "pre.ssz_snappy"))
    post_raw = va.read_ssz(case_dir, "post.ssz_snappy")
    post = (
        types.BeaconState.deserialize(post_raw) if post_raw is not None else None
    )
    return pre, post


def _check_post(types, got_state, post, changed: bool) -> None:
    if post is None:
        if changed:
            raise EfTestError("expected failure but processing succeeded")
        return
    got = types.BeaconState.hash_tree_root(got_state)
    want = types.BeaconState.hash_tree_root(post)
    if got != want:
        raise EfTestError(f"post-state root mismatch: {got.hex()} != {want.hex()}")


def _run_ssz_static(va, types, handler, case_dir):
    roots = va.read_yaml(case_dir, "roots.yaml")
    ssz = va.read_ssz(case_dir, "serialized.ssz_snappy")
    ctype = getattr(types, handler, None)
    if ctype is None:
        raise EfTestError(f"unknown container {handler}")
    value = ctype.deserialize(ssz)
    if ctype.serialize(value) != ssz:
        raise EfTestError("non-roundtripping serialization")
    got = "0x" + ctype.hash_tree_root(value).hex()
    if got != roots["root"]:
        raise EfTestError(f"root mismatch {got} != {roots['root']}")


def _run_shuffling(va, spec, case_dir):
    meta = va.read_yaml(case_dir, "mapping.yaml")
    seed = bytes.fromhex(meta["seed"][2:])
    count = int(meta["count"])
    mapping = [int(x) for x in meta["mapping"]]
    rounds = spec.preset.SHUFFLE_ROUND_COUNT
    got = [compute_shuffled_index(i, count, seed, rounds) for i in range(count)]
    if got != mapping:
        raise EfTestError("shuffling mismatch")


def _run_sanity_slots(va, spec, types, case_dir):
    pre, post = _state_pair(va, types, case_dir)
    n = int(va.read_yaml(case_dir, "slots.yaml"))
    process_slots(pre, spec, pre.slot + n)
    _check_post(types, pre, post, True)


def _run_sanity_blocks(va, spec, types, fork, case_dir):
    meta = va.read_yaml(case_dir, "meta.yaml") or {}
    n_blocks = int(meta.get("blocks_count", 0))
    pre, post = _state_pair(va, types, case_dir)
    try:
        for i in range(n_blocks):
            raw = va.read_ssz(case_dir, f"blocks_{i}.ssz_snappy")
            sb = types.SignedBeaconBlock.deserialize(raw)
            bt = types_for_slot(spec, sb.message.slot)
            if pre.slot < sb.message.slot:
                process_slots(pre, spec, sb.message.slot)
            per_block_processing(
                pre, sb, spec, bt,
                strategy=SignatureStrategy.VERIFY_BULK, verify_block_root=True,
            )
    except Exception as e:  # noqa: BLE001 — any rejection counts for invalid cases
        if post is None:
            return
        raise EfTestError(f"valid block rejected: {e}") from e
    _check_post(types, pre, post, True)


def _run_operation(va, spec, types, fork, handler, case_dir):
    if handler not in OPERATION_RUNNERS:
        raise EfTestError(f"unknown operation {handler}")
    stem, apply = OPERATION_RUNNERS[handler]
    pre, post = _state_pair(va, types, case_dir)
    op_ssz = va.read_ssz(case_dir, f"{stem}.ssz_snappy")
    op_type = {
        "attestation": "Attestation",
        "attester_slashing": "AttesterSlashing",
        "proposer_slashing": "ProposerSlashing",
        "deposit": "Deposit",
        "voluntary_exit": "SignedVoluntaryExit",
        "bls_to_execution_change": "SignedBLSToExecutionChange",
        "sync_aggregate": "SyncAggregate",
        "deposit_request": "DepositRequest",
        "withdrawal_request": "WithdrawalRequest",
        "consolidation_request": "ConsolidationRequest",
    }[handler]
    op = getattr(types, op_type).deserialize(op_ssz)
    try:
        apply(pre, spec, types, op, ForkName[fork])
    except Exception as e:  # noqa: BLE001 — invalid-op cases expect failure
        if post is None:
            return
        raise EfTestError(f"valid op rejected: {e}") from e
    _check_post(types, pre, post, True)


def _run_epoch(va, spec, types, fork, handler, case_dir):
    if handler not in EPOCH_RUNNERS:
        raise EfTestError(f"unknown epoch transition {handler}")
    pre, post = _state_pair(va, types, case_dir)
    try:
        EPOCH_RUNNERS[handler](pre, spec, types, ForkName[fork])
    except Exception as e:  # noqa: BLE001
        if post is None:
            return
        raise EfTestError(f"epoch transition failed: {e}") from e
    _check_post(types, pre, post, True)


def _deltas_type(spec):
    from ..ssz.core import Container, List as SSZList, uint64

    limit = spec.preset.VALIDATOR_REGISTRY_LIMIT
    return Container(
        "Deltas",
        [("rewards", SSZList(uint64, limit)), ("penalties", SSZList(uint64, limit))],
    )


def _run_rewards(va, spec, types, fork, case_dir):
    """Official rewards vectors: per-component (rewards, penalties) lists
    (ef_tests/src/cases/rewards.rs). Altair+ flags map to
    source/target/head deltas plus the inactivity penalty deltas."""
    if ForkName[fork] == ForkName.phase0:
        raise EfTestError("phase0 rewards runner not implemented")
    pre = types.BeaconState.deserialize(va.read_ssz(case_dir, "pre.ssz_snappy"))
    D = _deltas_type(spec)
    names = ["source_deltas", "target_deltas", "head_deltas"]
    for flag_index, name in enumerate(names):
        want = D.deserialize(va.read_ssz(case_dir, f"{name}.ssz_snappy"))
        rewards, penalties = ep.get_flag_index_deltas(
            pre, spec, flag_index, ForkName[fork]
        )
        if list(want.rewards) != rewards or list(want.penalties) != penalties:
            raise EfTestError(f"{name} mismatch")
    want = D.deserialize(
        va.read_ssz(case_dir, "inactivity_penalty_deltas.ssz_snappy")
    )
    rewards, penalties = ep.get_inactivity_penalty_deltas(pre, spec, ForkName[fork])
    if list(want.rewards) != rewards or list(want.penalties) != penalties:
        raise EfTestError("inactivity_penalty_deltas mismatch")


def _run_transition(va, config, fork, case_dir):
    """Official transition vectors: blocks crossing a fork boundary
    (ef_tests/src/cases/transition.rs). `fork` is the POST fork; meta gives
    the activation epoch; pre is a PRE-fork state."""
    meta = va.read_yaml(case_dir, "meta.yaml")
    post_fork = meta.get("post_fork", fork)
    fork_epoch = int(meta["fork_epoch"])
    n_blocks = int(meta["blocks_count"])
    pre_fork = _FORK_ORDER[_FORK_ORDER.index(post_fork) - 1]
    spec = spec_at_fork(config, pre_fork, {post_fork + "_fork_epoch": fork_epoch})
    pre_types = spec_types(spec.preset, ForkName[pre_fork])
    post_types = spec_types(spec.preset, ForkName[post_fork])
    state = pre_types.BeaconState.deserialize(va.read_ssz(case_dir, "pre.ssz_snappy"))
    for i in range(n_blocks):
        raw = va.read_ssz(case_dir, f"blocks_{i}.ssz_snappy")
        bt = types_for_slot(spec, fork_epoch * spec.preset.SLOTS_PER_EPOCH)
        # block fork is decided by its slot (the transition block itself is
        # a post-fork block)
        # peek slot: first 8 bytes of the message after the 100-byte
        # envelope is fork-agnostic; simpler: try post types then pre
        try:
            sb = post_types.SignedBeaconBlock.deserialize(raw)
            bt = types_for_slot(spec, sb.message.slot)
            sb = bt.SignedBeaconBlock.deserialize(raw)
        except Exception:
            sb = pre_types.SignedBeaconBlock.deserialize(raw)
            bt = pre_types
        if state.slot < sb.message.slot:
            process_slots(state, spec, sb.message.slot)
        per_block_processing(
            state, sb, spec, bt,
            strategy=SignatureStrategy.VERIFY_BULK, verify_block_root=True,
        )
    post = post_types.BeaconState.deserialize(va.read_ssz(case_dir, "post.ssz_snappy"))
    _check_post(post_types, state, post, True)


def _run_fork_choice(va, spec, fork, case_dir):
    """Official fork-choice vectors: a step script driving an anchored
    store (ef_tests/src/cases/fork_choice.rs). Supported steps: tick,
    block (+ optional `valid: false`), attestation, checks {head,
    justified_checkpoint, finalized_checkpoint, proposer_boost_root}."""
    from ..fork_choice.fork_choice import ForkChoice
    from ..types.state_util import clone_state

    types = _fork_types(spec, fork)
    anchor_state = types.BeaconState.deserialize(
        va.read_ssz(case_dir, "anchor_state.ssz_snappy")
    )
    anchor_block = types.BeaconBlock.deserialize(
        va.read_ssz(case_dir, "anchor_block.ssz_snappy")
    )
    anchor_root = types.BeaconBlock.hash_tree_root(anchor_block)
    fc = ForkChoice(spec, anchor_root, anchor_block.slot, anchor_state)
    states = {anchor_root: anchor_state}
    genesis_time = int(anchor_state.genesis_time)
    steps = va.read_yaml(case_dir, "steps.yaml")

    def current_head():
        return fc.get_head()

    for step in steps:
        if "tick" in step:
            slot = (int(step["tick"]) - genesis_time) // spec.seconds_per_slot
            fc.on_tick(slot)
        elif "block" in step:
            raw = va.read_ssz(case_dir, f"{step['block']}.ssz_snappy")
            bt = types_for_slot(spec, 0)
            sb = bt.SignedBeaconBlock.deserialize(raw)
            bt = types_for_slot(spec, sb.message.slot)
            sb = bt.SignedBeaconBlock.deserialize(raw)
            root = bt.BeaconBlock.hash_tree_root(sb.message)
            parent = bytes(sb.message.parent_root)
            try:
                if parent not in states:
                    raise EfTestError("unknown parent")
                st = clone_state(states[parent], spec)
                if st.slot < sb.message.slot:
                    process_slots(st, spec, sb.message.slot)
                per_block_processing(
                    st, sb, spec, bt,
                    strategy=SignatureStrategy.VERIFY_BULK, verify_block_root=True,
                )
                fc.on_block(sb, root, st)
                states[root] = st
            except Exception as e:  # noqa: BLE001
                if step.get("valid", True):
                    raise EfTestError(f"valid block rejected: {e}") from e
                continue
            if not step.get("valid", True):
                raise EfTestError("invalid block accepted")
        elif "attestation" in step:
            raw = va.read_ssz(case_dir, f"{step['attestation']}.ssz_snappy")
            att = types.Attestation.deserialize(raw)
            target_root = bytes(att.data.target.root)
            st = states.get(target_root) or states.get(
                bytes(att.data.beacon_block_root)
            )
            if st is None:
                raise EfTestError("attestation references unknown state")
            indices = acc.get_attesting_indices(
                st, spec, att.data, att.aggregation_bits, None
            )
            fc.on_attestation(
                att.data.slot, indices, bytes(att.data.beacon_block_root),
                att.data.target.epoch,
            )
        elif "checks" in step:
            checks = step["checks"]
            if "head" in checks:
                head = current_head()
                want = checks["head"]
                if "0x" + head.hex() != want["root"]:
                    raise EfTestError(
                        f"head mismatch: 0x{head.hex()} != {want['root']}"
                    )
                got_slot = int(states[head].latest_block_header.slot)
                if got_slot != int(want["slot"]):
                    raise EfTestError(f"head slot {got_slot} != {want['slot']}")
            if "justified_checkpoint" in checks:
                je, jr = fc.store.justified_checkpoint
                want = checks["justified_checkpoint"]
                if int(want["epoch"]) != je or want["root"] != "0x" + jr.hex():
                    raise EfTestError("justified checkpoint mismatch")
            if "finalized_checkpoint" in checks:
                fe, fr = fc.store.finalized_checkpoint
                want = checks["finalized_checkpoint"]
                if int(want["epoch"]) != fe or want["root"] != "0x" + fr.hex():
                    raise EfTestError("finalized checkpoint mismatch")
            if "proposer_boost_root" in checks:
                got = fc.proto.proposer_boost_root
                if checks["proposer_boost_root"] != "0x" + got.hex():
                    raise EfTestError("proposer boost root mismatch")
        else:
            raise EfTestError(f"unknown fork-choice step {sorted(step)}")


def _run_fork_upgrade(va, spec, fork, case_dir):
    meta = va.read_yaml(case_dir, "meta.yaml")
    post_fork = meta["fork"]
    pre_fork_name = {
        "altair": ForkName.phase0, "bellatrix": ForkName.altair,
        "capella": ForkName.bellatrix, "deneb": ForkName.capella,
        "electra": ForkName.deneb,
    }[post_fork]
    pre_types = spec_types(spec.preset, pre_fork_name)
    post_types = spec_types(spec.preset, ForkName[post_fork])
    pre = pre_types.BeaconState.deserialize(va.read_ssz(case_dir, "pre.ssz_snappy"))
    post = post_types.BeaconState.deserialize(va.read_ssz(case_dir, "post.ssz_snappy"))
    upgrade_state(pre, spec, pre_fork_name, ForkName[post_fork])
    _check_post(post_types, pre, post, True)


def _run_bls(va, handler, case_dir):
    data = va.read_yaml(case_dir, "data.yaml")
    inp, expect = data["input"], data["output"]

    def sig(hexstr):
        return bls.Signature.deserialize(bytes.fromhex(hexstr[2:]))

    def pk(hexstr):
        return bls.PublicKey.deserialize(bytes.fromhex(hexstr[2:]))

    if handler == "sign":
        sk = bls.SecretKey(int(inp["privkey"], 16))
        got = "0x" + bls.sign(sk, bytes.fromhex(inp["message"][2:])).serialize().hex()
        ok = got == expect
    elif handler == "verify":
        try:
            got = bls.verify(pk(inp["pubkey"]), bytes.fromhex(inp["message"][2:]), sig(inp["signature"]))
        except Exception:  # noqa: BLE001 — malformed points fail verification
            got = False
        ok = got == expect
    elif handler == "aggregate":
        try:
            agg = bls.AggregateSignature.empty()
            for s in inp:
                agg.add_assign(sig(s))
            got = "0x" + agg.serialize().hex()
            ok = got == expect
        except Exception:  # noqa: BLE001
            ok = expect is None
    elif handler == "fast_aggregate_verify":
        try:
            got = bls.fast_aggregate_verify(
                [pk(p) for p in inp["pubkeys"]],
                bytes.fromhex(inp["message"][2:]),
                sig(inp["signature"]),
            )
        except Exception:  # noqa: BLE001
            got = False
        ok = got == expect
    elif handler == "aggregate_verify":
        try:
            got = bls.aggregate_verify(
                [pk(p) for p in inp["pubkeys"]],
                [bytes.fromhex(m[2:]) for m in inp["messages"]],
                sig(inp["signature"]),
            )
        except Exception:  # noqa: BLE001
            got = False
        ok = got == expect
    elif handler == "eth_fast_aggregate_verify":
        try:
            got = bls.eth_fast_aggregate_verify(
                [pk(p) for p in inp["pubkeys"]],
                bytes.fromhex(inp["message"][2:]),
                sig(inp["signature"]),
            )
        except Exception:  # noqa: BLE001
            got = False
        ok = got == expect
    elif handler == "batch_verify":
        try:
            sets = [
                bls.SignatureSet(sig(s), (pk(p),), bytes.fromhex(m[2:]))
                for p, m, s in zip(inp["pubkeys"], inp["messages"], inp["signatures"])
            ]
            got = bls.verify_signature_sets(sets)
        except Exception:  # noqa: BLE001
            got = False
        ok = got == expect
    else:
        raise EfTestError(f"unknown bls handler {handler}")
    if not ok:
        raise EfTestError(f"bls/{handler} mismatch in {case_dir.name}")


def _run_kzg(va, handler, case_dir):
    from ..crypto import kzg as ckzg
    from ..crypto.bls381 import serde

    data = va.read_yaml(case_dir, "data.yaml")
    inp, expect = data["input"], data["output"]
    setup = ckzg.TrustedSetup.insecure_dev_setup(
        len(bytes.fromhex(inp["blob"][2:])) // 32 if "blob" in inp else 4096
    )

    def run():
        if handler == "blob_to_kzg_commitment":
            c = ckzg.blob_to_kzg_commitment(bytes.fromhex(inp["blob"][2:]), setup)
            return "0x" + serde.g1_compress(c).hex()
        if handler == "compute_blob_kzg_proof":
            p = ckzg.compute_blob_kzg_proof(
                bytes.fromhex(inp["blob"][2:]),
                bytes.fromhex(inp["commitment"][2:]), setup,
            )
            return "0x" + serde.g1_compress(p).hex()
        if handler == "verify_blob_kzg_proof":
            return ckzg.verify_blob_kzg_proof(
                bytes.fromhex(inp["blob"][2:]),
                bytes.fromhex(inp["commitment"][2:]),
                bytes.fromhex(inp["proof"][2:]), setup,
            )
        if handler == "verify_blob_kzg_proof_batch":
            return ckzg.verify_blob_kzg_proof_batch(
                [bytes.fromhex(b[2:]) for b in inp["blobs"]],
                [bytes.fromhex(c[2:]) for c in inp["commitments"]],
                [bytes.fromhex(p[2:]) for p in inp["proofs"]], setup,
            )
        raise EfTestError(f"unknown kzg handler {handler}")

    try:
        got = run()
    except Exception:  # noqa: BLE001 — invalid inputs expect null output
        got = None
    if got != expect:
        raise EfTestError(f"kzg/{handler} mismatch: {got} != {expect}")


def discover_cases(vector_root: str):
    """Yield (config, fork, runner, handler, case_dir) for every case under
    the root (layout: {config}/{fork}/{runner}/{handler}/{suite}/{case})."""
    root = Path(vector_root)
    if not root.exists():
        return
    for config_dir in sorted(root.iterdir()):
        if not config_dir.is_dir():
            continue
        for fork_dir in sorted(config_dir.iterdir()):
            for runner_dir in sorted(p for p in fork_dir.iterdir() if p.is_dir()):
                for handler_dir in sorted(p for p in runner_dir.iterdir() if p.is_dir()):
                    for suite_dir in sorted(p for p in handler_dir.iterdir() if p.is_dir()):
                        for case_dir in sorted(p for p in suite_dir.iterdir() if p.is_dir()):
                            yield (
                                config_dir.name, fork_dir.name, runner_dir.name,
                                handler_dir.name, case_dir,
                            )


def _kernel_launches() -> dict:
    """The launch counts of the port's kernels loaded in this process."""
    import sys

    out = {}
    for name in ("lighthouse_tpu_torch.crypto.torchbls.kernels",
                 "lighthouse_tpu_torch.torchhash.kernels"):
        mod = sys.modules.get(name)
        if mod is not None:
            out.update({k: w[0].launches for k, w in mod.KERNELS.items()})
    return out


def _run_shard(vector_root: str, cases: list, backend: str | None) -> dict:
    """Run (config, fork, runner, handler, case_dir) cases in order: the
    passes by runner, the failures, each case's seconds, the launches."""
    import time

    if backend is not None:
        bls.set_backend(backend)
    va = VectorAccess(Path(vector_root))
    out = {"passed": {}, "failed": [], "seconds": {}, "launches": {}}
    before = _kernel_launches()
    for config, fork, runner, handler, case_dir in cases:
        name = f"{config}/{fork}/{runner}/{handler}/{Path(case_dir).name}"
        t = time.perf_counter()
        try:
            run_case(va, config, fork, runner, handler, Path(case_dir))
            out["passed"][runner] = out["passed"].get(runner, 0) + 1
        except Exception as e:  # noqa: BLE001 — every failure is reported
            out["failed"].append((name, f"{type(e).__name__}: {e}"))
        out["seconds"][name] = time.perf_counter() - t
    after = _kernel_launches()
    out["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    return out


def run_vectors(vector_root, select=None, backend: str | None = None, workers: int = 1) -> dict:
    """Every case under `vector_root` that `select(config, fork, runner,
    handler, case_dir)` keeps, on `backend` (the active one when None), in
    `workers` processes (spawned: each resolves its own device). Returns
    {"passed": {runner: n}, "failed": [(case, error)], "seconds": {case:
    s}, "launches": {kernel: n}, "wall_seconds": s}."""
    import time

    t = time.perf_counter()
    cases = [(c, f, r, h, str(d)) for c, f, r, h, d in discover_cases(vector_root)
             if select is None or select(c, f, r, h, d)]
    if workers <= 1:
        shards = [_run_shard(str(vector_root), cases, backend)]
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # the long cases first, one per worker in turn
        order = sorted(cases, key=lambda c: (c[2] not in ("finality", "transition"), c[4]))
        parts = [order[i::workers] for i in range(workers)]
        with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
            shards = list(pool.map(_run_shard, [str(vector_root)] * workers, parts,
                                   [backend] * workers))
    out = {"passed": {}, "failed": [], "seconds": {}, "launches": {}}
    for shard in shards:
        for k, v in shard["passed"].items():
            out["passed"][k] = out["passed"].get(k, 0) + v
        for k, v in shard["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out["failed"] += shard["failed"]
        out["seconds"].update(shard["seconds"])
    out["wall_seconds"] = time.perf_counter() - t
    return out
