"""The port's Beacon HTTP API (api/{http_api,rewards,client}.py,
validator/beacon_node.py) on the CPU against the JAX package's.

Both packages' `serve` run over a chain of their own, built from one
StateHarness seed: the reference's harness makes 2 epochs and 2 slots of
blocks with full attestation participation on the minimal spec (16
validators, "fake" BLS), each chain imports them (the port's from their
SSZ bytes), and each server has an empty op pool.

- the same GET routes (states, validators, committees, blocks, headers,
  config, node, pools, duties, attestation data, rewards, debug state,
  light client) give the same status and JSON body; the one listed
  difference is the version string's name (`lighthouse-tpu` against
  `lighthouse-tpu-torch`);
- the POST duties (attester, sync), liveness and rewards (attestations,
  sync committee) routes give the same bodies;
- the block that GET /eth/v3/validator/blocks/{slot} produces is
  SSZ-equal, and the harness's next block published to both by POST
  /eth/v2/beacon/blocks gives the same head; the port's typed client
  reads it from both servers alike.

Tolerance: exact (JSON bodies, roots, bytes). No JAX compile.
"""

import json
import urllib.error
import urllib.request

import pytest

from lighthouse_tpu.crypto import bls as jbls

VALIDATORS = 16
SLOTS = 18                       # 2 epochs of the minimal preset and 2 slots
VERSION_NAMES = ("lighthouse-tpu/", "lighthouse-tpu-torch/")


def call(port: int, method: str, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            return e.code, json.loads(raw)
        except ValueError:
            return e.code, raw.decode(errors="replace")


@pytest.fixture(scope="module")
def apis():
    from lighthouse_tpu.api.http_api import serve as jserve
    from lighthouse_tpu.chain.beacon_chain import BeaconChain as JChain
    from lighthouse_tpu.chain.op_pool import OperationPool as JPool
    from lighthouse_tpu.state_transition.slot import types_for_slot as j_types
    from lighthouse_tpu.testing.harness import StateHarness, clone_state
    from lighthouse_tpu.types.spec import minimal_spec as j_minimal

    from lighthouse_tpu_torch.api.http_api import serve
    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.chain.op_pool import OperationPool
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_transition.slot import types_for_slot
    from lighthouse_tpu_torch.torchhash import router
    from lighthouse_tpu_torch.types.spec import minimal_spec

    jbls.set_backend("fake")
    bls.set_backend("fake")
    hash_backend = router.hash_backend()
    router.set_hash_backend("host")
    jspec, spec = j_minimal(), minimal_spec()
    harness = StateHarness.new(jspec, VALIDATORS)
    genesis = clone_state(harness.state, jspec)
    blocks = harness.extend_chain(SLOTS)
    jchain = JChain(jspec, clone_state(genesis, jspec))
    chain = BeaconChain(spec, types_for_slot(spec, 0).BeaconState.deserialize(
        j_types(jspec, 0).BeaconState.serialize(genesis)))
    for signed in blocks:
        slot = int(signed.message.slot)
        raw = j_types(jspec, slot).SignedBeaconBlock.serialize(signed)
        for c, blk in ((jchain, signed),
                       (chain, types_for_slot(spec, slot).SignedBeaconBlock.deserialize(raw))):
            c.slot_clock.set_slot(slot)
            c.per_slot_task()
            c.process_block(blk)
    assert chain.head_root == jchain.head_root
    servers = (jserve(jchain, op_pool=JPool(jspec)), serve(chain, op_pool=OperationPool(spec)))
    try:
        yield harness, jchain, chain, tuple(port for _s, _t, port in servers)
    finally:
        for server, _t, _p in servers:
            server.shutdown()
        router.set_hash_backend(hash_backend)


def same(ports, method: str, path: str, body=None):
    """The route's status and body from both servers; equal, but for the
    version string's name."""
    want, got = (call(p, method, path, body) for p in ports)
    if path == "/eth/v1/node/version":
        assert want[1]["data"]["version"].startswith(VERSION_NAMES[0])
        assert got[1]["data"]["version"].startswith(VERSION_NAMES[1])
        got = (got[0], json.loads(json.dumps(got).replace(*VERSION_NAMES[::-1]))[1])
    assert got == want, path
    return want


def get_routes(chain, harness):
    pk = "0x" + harness.keypairs[3].pk.serialize().hex()
    head = "0x" + chain.head_root.hex()
    state_root = "0x" + bytes(chain.head_state().latest_block_header.state_root).hex()
    routes = ["/eth/v1/beacon/genesis", "/eth/v1/node/version", "/eth/v1/node/syncing",
              "/eth/v1/node/health", "/eth/v1/node/peer_count", "/eth/v1/node/peers",
              "/eth/v1/config/spec", "/eth/v1/config/fork_schedule",
              "/eth/v1/config/deposit_contract", "/eth/v1/beacon/deposit_snapshot"]
    for sid in ("head", "genesis", "finalized", "justified", "7", "16"):
        routes += [f"/eth/v1/beacon/states/{sid}/root",
                   f"/eth/v1/beacon/states/{sid}/finality_checkpoints"]
    for sid in ("head", "9"):
        routes += [f"/eth/v1/beacon/states/{sid}/validators",
                   f"/eth/v1/beacon/states/{sid}/validators/3",
                   f"/eth/v1/beacon/states/{sid}/validators/{pk}",
                   f"/eth/v1/beacon/states/{sid}/validator_balances",
                   f"/eth/v1/beacon/states/{sid}/committees",
                   f"/eth/v1/beacon/states/{sid}/sync_committees",
                   f"/eth/v1/beacon/states/{sid}/randao"]
    for bid in ("head", "genesis", "1", "12", head):
        routes += [f"/eth/v1/beacon/blocks/{bid}/root", f"/eth/v2/beacon/blocks/{bid}",
                   f"/eth/v1/beacon/headers/{bid}", f"/lighthouse_tpu/blocks/{bid}/ssz",
                   f"/eth/v1/beacon/blob_sidecars/{bid}"]
    routes += [f"/eth/v1/beacon/states/{state_root}/root", "/eth/v1/beacon/headers/99",
               "/eth/v1/beacon/blocks/0x" + "ee" * 32 + "/root"]
    routes += ["/eth/v1/beacon/pool/bls_to_execution_changes",
               "/eth/v1/beacon/pool/attester_slashings",
               "/eth/v1/beacon/pool/proposer_slashings",
               "/eth/v1/beacon/pool/voluntary_exits"]
    routes += [f"/eth/v1/validator/duties/proposer/{e}" for e in (0, 1, 2)]
    routes += [f"/eth/v1/validator/attestation_data?slot={SLOTS}&committee_index=0",
               f"/eth/v1/validator/aggregate_attestation?slot={SLOTS}&attestation_data_root="
               + "0x" + "11" * 32]
    routes += ["/eth/v1/beacon/rewards/blocks/head", "/eth/v1/beacon/rewards/blocks/10",
               "/eth/v1/beacon/rewards/blocks/0x" + "ee" * 32]
    routes += ["/eth/v2/debug/beacon/states/head", "/eth/v2/debug/beacon/states/finalized"]
    routes += ["/eth/v1/beacon/light_client/optimistic_update",
               "/eth/v1/beacon/light_client/finality_update",
               f"/eth/v1/beacon/light_client/bootstrap/{head}",
               "/eth/v1/beacon/light_client/updates?start_period=0&count=1"]
    return routes


def test_get_routes_give_the_same_bodies(apis):
    harness, jchain, _chain, ports = apis
    statuses = [same(ports, "GET", path)[0] for path in get_routes(jchain, harness)]
    assert statuses.count(200) > len(statuses) // 2 and set(statuses) - {200}


def test_duties_rewards_and_liveness_routes(apis):
    harness, _jchain, _chain, ports = apis
    everyone = [str(i) for i in range(VALIDATORS)]
    for epoch in (1, 2, 3):
        body = same(ports, "POST", f"/eth/v1/validator/duties/attester/{epoch}", everyone)[1]
        assert len(body["data"]) == VALIDATORS
    # outside the head state's shuffling range: the same error
    assert same(ports, "POST", "/eth/v1/validator/duties/attester/0", everyone)[0] != 200
    same(ports, "POST", "/eth/v1/validator/duties/sync/0", ["0", "1", "5"])
    same(ports, "POST", "/eth/v1/validator/liveness/1", ["0", "1", "5"])
    got = same(ports, "POST", "/eth/v1/beacon/rewards/attestations/0", [])[1]
    assert got["data"]["total_rewards"]
    same(ports, "POST", "/eth/v1/beacon/rewards/attestations/0", ["1", "7"])
    for epoch in (1, 999):                   # not yet judgeable, unknown: the same errors
        assert same(ports, "POST", f"/eth/v1/beacon/rewards/attestations/{epoch}", [])[0] != 200
    for bid in ("head", "10"):
        same(ports, "POST", f"/eth/v1/beacon/rewards/sync_committee/{bid}", [])
        same(ports, "POST", f"/eth/v1/beacon/rewards/sync_committee/{bid}", ["2"])


def test_produced_and_published_block_give_the_same_head(apis):
    from lighthouse_tpu.state_transition import accessors as jacc
    from lighthouse_tpu.state_transition.slot import process_slots as j_process_slots
    from lighthouse_tpu.state_transition.slot import types_for_slot as j_types
    from lighthouse_tpu.testing.harness import clone_state

    from lighthouse_tpu_torch.api.client import BeaconNodeHttpClient

    harness, jchain, chain, ports = apis
    slot = SLOTS + 1
    for c in (jchain, chain):
        c.slot_clock.set_slot(slot)
        c.per_slot_task()
    st = clone_state(harness.state, harness.spec)
    j_process_slots(st, harness.spec, slot)
    proposer = jacc.get_beacon_proposer_index(st, harness.spec)
    reveal = harness.randao_reveal(st, proposer, slot // harness.spec.preset.SLOTS_PER_EPOCH)
    produced = same(ports, "GET", f"/eth/v3/validator/blocks/{slot}?randao_reveal=0x{reveal.hex()}")
    assert produced[0] == 200 and produced[1]["data"]

    signed, _post = harness.produce_block(slot, attestations=[], full_sync=False)
    clients = [BeaconNodeHttpClient(f"http://127.0.0.1:{p}", timeout=30.0) for p in ports]
    ssz = "0x" + j_types(harness.spec, slot).SignedBeaconBlock.serialize(signed).hex()
    assert same(ports, "POST", "/eth/v2/beacon/blocks", {"ssz": ssz}) == (200, {})
    assert chain.head_root == jchain.head_root
    assert chain.head_state().slot == slot
    heads = [(c.block_root("head"), c.state_root("head"), c.header("head")) for c in clients]
    assert heads[0] == heads[1] and heads[0][0] == chain.head_root
    same(ports, "GET", "/eth/v1/beacon/headers/head")
    same(ports, "GET", f"/eth/v1/beacon/rewards/blocks/{slot}")
    for c in clients:
        c.close()
