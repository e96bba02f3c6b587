"""A full-width, signed mainnet block over a 2^14-validator deneb state.

The port's tool for importing a block at the width of mainnet (it has no
counterpart in the JAX package, as submission_timing.py has none):
`spec_at_fork("mainnet", "deneb")` (the mainnet preset, deneb from
genesis), an interop genesis of 2^14 validators (4 committees of 128 a
slot), advanced with empty slots to PRE_SLOT, and a signed block at
BLOCK_SLOT = PRE_SLOT + 1 carrying

  - 128 attestations, one for each (slot, committee) of the 32 slots of
    epoch 1, every bit set;
  - a full 512-member sync aggregate over the block root at PRE_SLOT;
  - the proposer signature and the RANDAO reveal:

131 signature sets, which `padding_bucket` puts in bucket (256, 512). The
block's slot is the first of epoch 2, so its import runs epoch 1's
transition, the first with rewards and penalties (epoch 0's skips them).

Two shortcuts keep the build within a chip run, and neither changes what
the import computes:

  - Validator i's secret key is base + i (mod r), base from the seed, so
    its public key is the one before it plus the generator: 2^14 point
    additions instead of 2^14 scalar multiplications (~0.17 s each in pure
    Python). The keys are distinct, and building them interns each
    compressed key in the process-wide pubkey cache, as a node's
    ValidatorPubkeyCache holds its registry decompressed; a cold registry
    would pay 2^14 decompressions (~0.18 s each, ~49 min in pure Python).
  - Each aggregate is signed once, by the sum mod r of its members' secret
    keys: (sum sk_i) * H(m) is the sum of the members' signatures.

The build is seeded and deterministic. Its output (the genesis state, the
pre-state and the block as SSZ, the public keys' affine points and the key base) is cached
under build/block_fixtures/, so a second run skips the signing. Run `python -m lighthouse_tpu_torch.testing.block_fixtures`
to build the cache (it touches no card: the hash backend is "host").
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass

N_VALIDATORS = 1 << 14
PRE_SLOT = 63
BLOCK_SLOT = PRE_SLOT + 1
SEED = 20261018
GENESIS_TIME = 1_606_824_023

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(_ROOT, "build", "block_fixtures")


@dataclass
class BlockFixture:
    spec: object
    types: object
    keypairs: list            # bls.Keypair of every validator
    genesis_state: object     # the interop genesis state (slot 0)
    pre_state: object         # the state at PRE_SLOT
    block: object             # the signed block at BLOCK_SLOT
    swapped: object           # the same block, two attestations' signatures swapped
    seconds: dict             # the build's parts


def key_base(seed: int) -> int:
    from ..crypto.bls381.constants import R

    return int.from_bytes(hashlib.sha256(b"block_fixtures" + seed.to_bytes(8, "little")).digest(),
                          "little") % (R - (1 << 16)) + 1


def registry_keys(n: int, base: int) -> list:
    """Keypairs with sk_i = base + i: pk_i = pk_{i-1} + G. Serializing each
    public key interns it in the pubkey cache."""
    from ..crypto import bls
    from ..crypto.bls381 import curve as cv

    point = cv.g1_mul(cv.G1_GEN, base)
    out = []
    for i in range(n):
        pk = bls.PublicKey(point)
        pk.serialize()
        out.append(bls.Keypair(bls.SecretKey(base + i), pk))
        point = cv.g1_add(point, cv.G1_GEN)
    return out


def sign_root(sk: int, root: bytes) -> bytes:
    """The compressed signature sk * H(root), on the host, with no backend."""
    from ..crypto.bls.api import hash_to_g2_point
    from ..crypto.bls381 import curve as cv, serde

    return serde.g2_compress(cv.g2_mul(hash_to_g2_point(root), sk))


def _sign_many(jobs, workers: int) -> list[bytes]:
    if workers <= 1:
        return [sign_root(sk, root) for sk, root in jobs]
    import multiprocessing as mp

    with mp.get_context("fork").Pool(workers) as pool:
        return pool.starmap(sign_root, jobs, chunksize=1)


def _spec():
    from .ef_runner import spec_at_fork

    return spec_at_fork("mainnet", "deneb")


def build_block(spec, keypairs, pre, workers: int | None = None, last_slots: int | None = None):
    """A signed block at pre.slot + 1, the first slot of an epoch e >= 1:
    one attestation of every bit for each (slot, committee) of epoch e - 1
    (of its last `last_slots` slots only, when given), a full sync
    aggregate over the block root at pre.slot, the RANDAO reveal and the
    proposer signature, each aggregate signed by its members' summed
    secret keys. Returns (signed block, seconds)."""
    from ..crypto.bls381.constants import R
    from ..state_transition import accessors as acc
    from ..state_transition.block import SignatureStrategy
    from ..state_transition.slot import process_slots, state_transition, types_for_slot
    from ..types import helpers as h
    from ..types.spec import (DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO,
                              DOMAIN_SYNC_COMMITTEE)
    from ..types.state_util import clone_state
    from ..ssz.core import uint64

    seconds = {}
    block_slot = pre.slot + 1
    types = types_for_slot(spec, block_slot)
    epoch = h.compute_epoch_at_slot(block_slot, spec)
    if block_slot != h.compute_start_slot_at_epoch(epoch, spec) or epoch == 0:
        raise ValueError("the block's slot must start an epoch after the first")
    t = time.perf_counter()
    state = clone_state(pre, spec)
    process_slots(state, spec, block_slot)
    att_epoch = epoch - 1
    cache = acc.build_committee_cache(state, spec, att_epoch)
    att_domain = h.get_domain(state, spec, DOMAIN_BEACON_ATTESTER, att_epoch)
    target = types.Checkpoint.make(epoch=att_epoch, root=acc.get_block_root(state, spec, att_epoch))
    datas, jobs, committees = [], [], []
    first = h.compute_start_slot_at_epoch(att_epoch, spec)
    for slot in range(first if last_slots is None else block_slot - last_slots, block_slot):
        for index in range(cache.committees_per_slot):
            committee = cache.committee(slot, index)
            data = types.AttestationData.make(
                slot=slot, index=index,
                beacon_block_root=acc.get_block_root_at_slot(state, spec, slot),
                source=state.previous_justified_checkpoint, target=target)
            datas.append(data)
            committees.append(committee)
            jobs.append((sum(keypairs[v].sk.scalar for v in committee) % R,
                         h.compute_signing_root(types.AttestationData, data, att_domain)))

    sync_slot = block_slot - 1
    sync_domain = h.get_domain(state, spec, DOMAIN_SYNC_COMMITTEE,
                               h.compute_epoch_at_slot(sync_slot, spec))
    sk_by_pk = {kp.pk.serialize(): kp.sk.scalar for kp in keypairs}
    members = [sk_by_pk[bytes(pk)] for pk in state.current_sync_committee.pubkeys]
    jobs.append((sum(members) % R, h.compute_signing_root_from_root(
        acc.get_block_root_at_slot(state, spec, sync_slot), sync_domain)))
    proposer = acc.get_beacon_proposer_index(state, spec)
    proposer_sk = keypairs[proposer].sk.scalar
    jobs.append((proposer_sk, h.compute_signing_root(
        uint64, epoch, h.get_domain(state, spec, DOMAIN_RANDAO, epoch))))
    seconds["duties"] = time.perf_counter() - t

    t = time.perf_counter()
    sigs = _sign_many(jobs, workers if workers is not None else min(8, os.cpu_count() or 1))
    seconds["sign_aggregates"] = time.perf_counter() - t

    t = time.perf_counter()
    attestations = [
        types.Attestation.make(aggregation_bits=[True] * len(c), data=d, signature=s)
        for d, c, s in zip(datas, committees, sigs)]
    body = types.BeaconBlockBody.make(
        randao_reveal=sigs[-1], eth1_data=state.eth1_data, graffiti=b"\x00" * 32,
        proposer_slashings=[], attester_slashings=[], attestations=attestations,
        deposits=[], voluntary_exits=[],
        sync_aggregate=types.SyncAggregate.make(
            sync_committee_bits=[True] * spec.preset.SYNC_COMMITTEE_SIZE,
            sync_committee_signature=sigs[-2]),
        execution_payload=types.ExecutionPayload.default(),
        bls_to_execution_changes=[], blob_kzg_commitments=[])
    block = types.BeaconBlock.make(
        slot=block_slot, proposer_index=proposer,
        parent_root=types.BeaconBlockHeader.hash_tree_root(state.latest_block_header),
        state_root=b"\x00" * 32, body=body)
    post = clone_state(pre, spec)
    state_transition(post, types.SignedBeaconBlock.make(message=block, signature=b"\x00" * 96),
                     spec, strategy=SignatureStrategy.NO_VERIFICATION, verify_state_root=False)
    block = block.copy_with(state_root=types.BeaconState.hash_tree_root(post))
    domain = h.get_domain(state, spec, DOMAIN_BEACON_PROPOSER, epoch)
    signed = types.SignedBeaconBlock.make(
        message=block, signature=sign_root(proposer_sk, h.compute_signing_root(
            types.BeaconBlock, block, domain)))
    seconds["block"] = time.perf_counter() - t
    return signed, seconds


def build(n: int = N_VALIDATORS, seed: int = SEED, workers: int | None = None) -> BlockFixture:
    """Build the fixture from scratch (the hash backend as the caller set it)."""
    from ..state_transition.genesis import interop_genesis_state
    from ..state_transition.slot import process_slots, types_for_slot
    from ..types.state_util import clone_state

    spec = _spec()
    types = types_for_slot(spec, BLOCK_SLOT)
    t = time.perf_counter()
    keypairs = registry_keys(n, key_base(seed))
    seconds = {"keys": time.perf_counter() - t}
    t = time.perf_counter()
    genesis = interop_genesis_state(keypairs, GENESIS_TIME, spec)
    pre = clone_state(genesis, spec)
    process_slots(pre, spec, PRE_SLOT)
    seconds["pre_state"] = time.perf_counter() - t
    signed, block_seconds = build_block(spec, keypairs, pre, workers)
    return BlockFixture(spec, types, keypairs, genesis, pre, signed,
                        swap_signatures(signed, types), {**seconds, **block_seconds})


def swap_signatures(signed, types, i: int = 0, j: int = 1):
    """The block with attestations i and j trading signatures (the proposer
    signature then fails too: the body changed)."""
    atts = list(signed.message.body.attestations)
    atts[i], atts[j] = (atts[i].copy_with(signature=atts[j].signature),
                        atts[j].copy_with(signature=atts[i].signature))
    body = signed.message.body.copy_with(attestations=atts)
    return signed.copy_with(message=signed.message.copy_with(body=body))


def _cache_paths(n: int, seed: int) -> dict:
    stem = os.path.join(CACHE_DIR, f"n{n}_s{seed}_slot{BLOCK_SLOT}")
    return {k: f"{stem}_{k}" for k in ("genesis.ssz", "pre.ssz", "block.ssz", "points.bin",
                                        "meta.json")}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _load_keys(path: str, base: int) -> list:
    """The keypairs from the cached affine points (x || y, 48 bytes each,
    big-endian), each public key interned by its compression."""
    from ..crypto import bls

    with open(path, "rb") as f:
        raw = f.read()
    out = []
    for i in range(len(raw) // 96):
        rec = raw[96 * i: 96 * i + 96]
        pk = bls.PublicKey((int.from_bytes(rec[:48], "big"), int.from_bytes(rec[48:], "big")))
        pk.serialize()
        out.append(bls.Keypair(bls.SecretKey(base + i), pk))
    return out


def load_or_build(n: int = N_VALIDATORS, seed: int = SEED,
                  workers: int | None = None) -> BlockFixture:
    """The cached fixture, or a fresh build that is then cached. A loaded
    fixture's public keys come from the cached points, interned again."""
    paths = _cache_paths(n, seed)
    if all(os.path.exists(p) for p in paths.values()):
        spec = _spec()
        from ..state_transition.slot import types_for_slot

        types = types_for_slot(spec, BLOCK_SLOT)
        t = time.perf_counter()
        with open(paths["meta.json"]) as f:
            meta = json.load(f)
        keypairs = _load_keys(paths["points.bin"], meta["base"])
        keys_s = time.perf_counter() - t
        t = time.perf_counter()
        genesis, pre = (types.BeaconState.deserialize(_read(paths[k]))
                        for k in ("genesis.ssz", "pre.ssz"))
        block = types.SignedBeaconBlock.deserialize(_read(paths["block.ssz"]))
        return BlockFixture(spec, types, keypairs, genesis, pre, block,
                            swap_signatures(block, types),
                            {"keys": keys_s, "load": time.perf_counter() - t, "cached": True})
    fx = build(n, seed, workers)
    os.makedirs(CACHE_DIR, exist_ok=True)
    meta = json.dumps({"base": key_base(seed), "n": n, "seed": seed, "seconds": fx.seconds})
    points = (kp.pk.point for kp in fx.keypairs)
    for key, data in (("genesis.ssz", fx.types.BeaconState.serialize(fx.genesis_state)),
                      ("pre.ssz", fx.types.BeaconState.serialize(fx.pre_state)),
                      ("block.ssz", fx.types.SignedBeaconBlock.serialize(fx.block)),
                      ("points.bin", b"".join(x.to_bytes(48, "big") + y.to_bytes(48, "big")
                                              for x, y in points)),
                      ("meta.json", meta.encode())):      # last: its presence marks a whole cache
        tmp = paths[key] + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, paths[key])
    return fx


def main() -> int:
    """Build (or load) the cached fixture on the host; print its JSON line."""
    from ..torchhash import router

    router.set_hash_backend("host")
    t = time.perf_counter()
    fx = load_or_build()
    print(json.dumps({"phase": "block_fixture", "validators": len(fx.keypairs),
                      "attestations": len(fx.block.message.body.attestations),
                      "seconds": fx.seconds, "total_seconds": time.perf_counter() - t}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
