"""The port's batched verifier (torchbls.backend.TorchBackend on the CPU,
i.e. the kernels' plain versions) against the JAX package: every stage
output at bucket (4, 2) bit for bit against jaxbls.backend's stages, and
the verdicts against the JAX backend. Also the library boundary: importing
the port loads neither jax nor lighthouse_tpu, and its entry points want
a CUDA device unless device="cpu" is given.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import api as bls_api
from lighthouse_tpu_torch.crypto.bls381 import curve as cv
from lighthouse_tpu_torch.crypto.bls381.constants import R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
torch = TB = ix = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, TB, ix
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import backend as TB
    from lighthouse_tpu_torch.crypto.torchbls import interchange as ix

    # many small int64 ops: intra-op threads would only contend with the
    # other test workers
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_set(rng, msg: bytes, n_keys: int = 1):
    sks = [rng.randrange(1, R) for _ in range(n_keys)]
    pks = [bls.PublicKey(cv.g1_mul(cv.G1_GEN, sk)) for sk in sks]
    sig = bls.Signature(cv.g2_mul(bls_api.hash_to_g2_point(msg), sum(sks) % R))
    return bls.SignatureSet(sig, pks, msg)


def same(t, j) -> bool:
    return all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(ix.to_numpy(list(t)), [np.asarray(x) for x in j])
    )


def _warm_jax_stages(n, m):
    """Compile the four JAX stage programs at bucket (n, m) in parallel
    threads on dummy inputs (XLA releases the GIL while compiling)."""
    import threading

    import jax

    from lighthouse_tpu.crypto.jaxbls import backend as jbe

    stages = jbe._get_stages()
    prepare, h2c_stage, pairs_stage, pairing_stage = stages
    z = np.zeros

    def fq(*shape):
        return z(shape + (24,), np.uint32)

    jobs = [
        lambda: prepare(fq(n, m), fq(n, m), z((n, m), np.uint32), fq(n, 2), fq(n, 2),
                        z((n, 64), np.uint32), z((n,), np.uint32)),
        lambda: h2c_stage(fq(n, 2, 2)),
        lambda: pairs_stage((fq(n), fq(n), fq(n)), (fq(n, 2), fq(n, 2), fq(n, 2)),
                            (fq(2), fq(2), fq(2)), z((n,), np.uint32)),
        lambda: pairing_stage(fq(n + 1), fq(n + 1), fq(n + 1, 2), fq(n + 1, 2),
                              z((n + 1,), bool)),
    ]
    threads = [threading.Thread(target=lambda f=f: jax.block_until_ready(f())) for f in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return stages


# each bucket's sets' key counts: (4, 2) has a pubkey tree add and a masked
# pubkey lane; (8, 4), whose JAX compile takes minutes, a 4-key tree and
# three padding sets
STAGE_BUCKETS = {(4, 2): (2, 1, 2), (8, 4): (2, 1, 2, 4, 3)}


@pytest.mark.parametrize("bucket", [(4, 2), pytest.param((8, 4), marks=pytest.mark.slow)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_stages_and_verdicts_match_jax(bucket):
    """One test per bucket, so one worker compiles the four JAX stage
    programs and the JAX backend's verdicts (its single-device lane) reuse
    them."""
    import jax

    from lighthouse_tpu.crypto.jaxbls import backend as jbe

    rng = random.Random(0xBAC)
    keys = STAGE_BUCKETS[bucket]
    sets = [make_set(rng, bytes([i + 1]) * 32, n_keys=k) for i, k in enumerate(keys)]
    rands = [1, 0xDEADBEEF12345677, 0x42, 0x1234567890ABCDEF, 0x77][:len(sets)]
    torch_be = TB.TorchBackend(device="cpu")
    prepare_in, us = torch_be.marshal(sets, rands)
    assert tuple(prepare_in[0].shape[:2]) == bucket
    np_prepare_in = ix.to_numpy(list(prepare_in))

    prepare, h2c_stage, pairs_stage, pairing_stage = _warm_jax_stages(*bucket)
    j_zpk, j_sig, j_bad = jax.block_until_ready(prepare(*np_prepare_in))
    j_h2c = jax.block_until_ready(h2c_stage(ix.to_numpy(us)))
    j_pairs = jax.block_until_ready(pairs_stage(j_zpk, j_h2c, j_sig, np_prepare_in[-1]))
    j_ok = bool(np.asarray(pairing_stage(*j_pairs)))

    z_pk, sig_acc, bad = TB.stage_prepare(*prepare_in)
    assert same(z_pk, j_zpk) and same(sig_acc, j_sig)
    assert bool(bad) == bool(np.asarray(j_bad)) is False
    h_jac = TB.stage_h2c(us)
    assert same(h_jac, j_h2c)
    # hash_to_g2's lanes here: the padding lane u = 0 (SWU's xd == 0 case)
    # and, among the messages' u-values, both is_qr classes
    from lighthouse_tpu.crypto.bls381 import hash_to_curve as ref_h2c
    from lighthouse_tpu.crypto.bls381.constants import DST_POP
    from test_torch_h2c import is_qr

    qr = [is_qr(u) for s in sets for u in ref_h2c.hash_to_field_fq2(s.message, 2, DST_POP)]
    assert any(qr) and not all(qr) and not bool(us[len(sets):].any())
    pairs = TB.stage_pairs(z_pk, h_jac, sig_acc, prepare_in[-1])
    assert same(pairs, j_pairs)
    assert bool(TB.stage_pairing(*pairs)) == j_ok is True

    # verdicts against the JAX backend at the same bucket
    jax_be = jbe.JaxBackend()
    other = make_set(rng, b"\x77" * 32, n_keys=2)
    s0 = sets[0]
    batches = {
        "valid": (sets, True),
        "tampered_message": ([bls.SignatureSet(s0.signature, s0.signing_keys, b"\x55" * 32)]
                             + sets[1:], False),
        "tampered_signature": ([bls.SignatureSet(other.signature, s0.signing_keys, s0.message)]
                               + sets[1:], False),
        "tampered_key": ([bls.SignatureSet(s0.signature, other.signing_keys, s0.message)]
                         + sets[1:], False),
        "infinity_signature": ([bls.SignatureSet(bls.Signature.infinity(), s0.signing_keys,
                                                 s0.message)] + sets[1:], False),
    }
    for name, (batch, expected) in batches.items():
        got = torch_be.verify_signature_sets(batch, rands)
        want = jax_be.verify_signature_sets_urgent(batch, rands)
        assert got == want == expected, name


_P1 = cv.g1_mul(cv.G1_GEN, 5)
_Q1 = cv.g2_mul(cv.G2_GEN, 7)

# host affine pairs (None = identity) and the expected product check
PAIRING_CASES = {
    "balanced_with_identity": ([(_P1, _Q1), (None, _Q1), (cv.g1_neg(_P1), _Q1)], True),
    "unbalanced_with_identity": ([(_P1, _Q1), (_P1, None), (cv.g1_neg(_P1), cv.g2_mul(_Q1, 2))],
                                 False),
    "identities_only": ([(None, _Q1), (_P1, None)], True),
}


@pytest.mark.parametrize("name", sorted(PAIRING_CASES))
def test_pairing_product_is_one_matches_the_reference(name):
    """TorchBackend.pairing_product_is_one on host pairs: its padded stage
    inputs equal the JAX backend's packing of the same pairs
    (jaxbls.backend.JaxBackend.pairing_product_is_one), and its verdict
    equals the pure-Python pairing product of the JAX package."""
    from lighthouse_tpu.crypto.bls381 import pairing as ref
    from lighthouse_tpu.crypto.jaxbls import tower as JT

    pairs, expected = PAIRING_CASES[name]
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    torch_be = TB.TorchBackend(device="cpu")
    assert torch_be.pairing_product_is_one(pairs) is expected
    if not live:
        return
    assert ref.multi_pairing_is_one(live) is expected
    pad = TB.MIN_SETS - len(live)
    want = (
        JT.fq_batch_to_device([p[0] for p, _ in live] + [0] * pad),
        JT.fq_batch_to_device([p[1] for p, _ in live] + [0] * pad),
        JT.fq2_batch_to_device([q[0] for _, q in live] + [(0, 0)] * pad),
        JT.fq2_batch_to_device([q[1] for _, q in live] + [(0, 0)] * pad),
        np.arange(TB.MIN_SETS) < len(live),
    )
    got = ix.to_numpy(list(torch_be.pairing_inputs(live)))
    assert all(np.array_equal(g, np.asarray(w)) for g, w in zip(got, want, strict=True))


def test_import_and_cpu_verify_load_no_jax():
    code = (
        "import sys, random, lighthouse_tpu_torch\n"
        "from lighthouse_tpu_torch.crypto import bls\n"
        "from lighthouse_tpu_torch.crypto.bls381 import curve as cv\n"
        "from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend\n"
        "sk = 12345\n"
        "pk = bls.PublicKey(cv.g1_mul(cv.G1_GEN, sk))\n"
        "msg = b'\\x01' * 32\n"
        "from lighthouse_tpu_torch.crypto.bls.api import hash_to_g2_point\n"
        "sig = bls.Signature(cv.g2_mul(hash_to_g2_point(msg), sk))\n"
        "be = TorchBackend(device='cpu')\n"
        "assert be.verify_single(pk, msg, sig)\n"
        "assert be.aggregate_verify([pk], [msg], sig)\n"
        "assert be.verify_signature_sets_async([bls.SignatureSet(sig, [pk], msg)], [1]).result()\n"
        "from lighthouse_tpu_torch.crypto import kzg\n"
        "from lighthouse_tpu_torch.crypto.bls381 import pairing\n"
        "from lighthouse_tpu_torch.crypto.torchbls import msm\n"
        "from lighthouse_tpu_torch.utils import fixtures\n"
        "from lighthouse_tpu_torch.crypto.bls import api\n"
        "assert api._BACKENDS['python'].verify_single(pk, msg, sig)\n"
        "assert be.g1_msm([cv.G1_GEN, None], [3, 5]) == cv.g1_mul(cv.G1_GEN, 3)\n"
        "assert msm.FixedBaseMSM([cv.G1_GEN], 'cpu').msm([2]) == cv.g1_mul(cv.G1_GEN, 2)\n"
        "import os\n"
        "os.environ['LIGHTHOUSE_TPU_EPOCH_VEC_MIN'] = '1'\n"
        "from lighthouse_tpu_torch.torchhash import engine, epoch_vectors, router\n"
        "from lighthouse_tpu_torch.testing import state_fixtures as fx\n"
        "from lighthouse_tpu_torch.state_transition import epoch as ep\n"
        "engine.set_device('cpu')\n"
        "router.ROUTER.min_leaves = 64\n"
        "spec, types, st = fx.build_synthetic_state(300, participation_seed=1, slot=23)\n"
        "assert types.BeaconState.hash_tree_root(st) == fx.uncached_state_root(types, st)\n"
        "assert router.route_totals().get('device/ok') and not router.route_totals().get('host/device_error')\n"
        "ep.process_epoch(st, spec, types, spec.fork_name_at_slot(st.slot))\n"
        "assert epoch_vectors.epoch_totals() == {'ok': 1.0}\n"
        "from lighthouse_tpu_torch import autotune, observability\n"
        "assert 'hybrid' in bls.available_backends()\n"
        "h = bls.set_backend('hybrid')\n"
        "assert bls.get_backend() is h and h.name == 'hybrid'\n"
        "assert bls.verify(pk, msg, sig)\n"
        "assert __import__('torch').cuda.is_available() or h._state == 'down'\n"
        "assert observability.LEDGER.workloads() == ['bls', 'epoch', 'tree_hash']\n"
        "assert autotune.runtime.active_plan() is None\n"
        "from lighthouse_tpu_torch import cli\n"
        "from lighthouse_tpu_torch.autotune import calibrate\n"
        "from lighthouse_tpu_torch.observability import device, perf\n"
        "assert cli.build_parser().parse_args(['autotune', 'show']).fn is cli.cmd_autotune\n"
        "assert not device.enabled() and not perf.analytics_enabled()\n"
        "from lighthouse_tpu_torch.state_transition import (block, block_replayer, electra,\n"
        "    genesis, signature_sets, slot)\n"
        "from lighthouse_tpu_torch.chain import eth1\n"
        "from lighthouse_tpu_torch.network import snappy\n"
        "from lighthouse_tpu_torch.fork_choice import fork_choice, proto_array\n"
        "from lighthouse_tpu_torch.testing import (block_fixtures, carry, compare_fields,\n"
        "    ef_runner, harness)\n"
        "bls.set_backend('fake')\n"
        "router.set_hash_backend('host')\n"
        "out = ef_runner.run_vectors('tests/ef/vectors', select=lambda c, f, r, h, d:\n"
        "    f in ('deneb', 'electra') and (r in ('epoch_processing', 'fork') or h == 'slots'))\n"
        "assert not out['failed'] and sum(out['passed'].values()) == 32, out\n"
        "hs = harness.StateHarness.new(ef_runner.spec_at_fork('minimal', 'electra'), 8)\n"
        "blocks = hs.extend_chain(2)\n"
        "replayed = block_replayer.BlockReplayer(spec=hs.spec, state=genesis.interop_genesis_state(\n"
        "    hs.keypairs, hs.genesis_time, hs.spec), verify_state_roots=True).apply_blocks(blocks)\n"
        "assert replayed.slot == 2\n"
        "from lighthouse_tpu_torch.chain import (beacon_chain, caches, data_availability,\n"
        "    naive_aggregation, pubkey_cache, validator_monitor)\n"
        "from lighthouse_tpu_torch.store import hot_cold, kv, metadata\n"
        "from lighthouse_tpu_torch.utils import slot_clock\n"
        "from lighthouse_tpu_torch.ssz import proof\n"
        "from lighthouse_tpu_torch.execution import engine_api\n"
        "from lighthouse_tpu_torch.slasher import slasher\n"
        "from lighthouse_tpu_torch import loadgen\n"
        "from lighthouse_tpu_torch.loadgen import scenarios, state_root\n"
        "assert loadgen.get_scenario is scenarios.get_scenario\n"
        "from lighthouse_tpu_torch.utils import task_executor\n"
        "from lighthouse_tpu_torch.store import doctor, native_kv\n"
        "from lighthouse_tpu_torch.execution import block_hash\n"
        "from lighthouse_tpu_torch.chain import (beacon_processor, execution_layer, op_pool,\n"
        "    scheduler)\n"
        "from lighthouse_tpu_torch.qos import admission, ratelimit\n"
        "from lighthouse_tpu_torch.observability import pipeline\n"
        "from lighthouse_tpu_torch.network import gossip\n"
        "from lighthouse_tpu_torch.loadgen import faults, runner, storefaults\n"
        "from lighthouse_tpu_torch import qos\n"
        "assert loadgen.run_scenario is runner.run_scenario and qos.RateLimiter\n"
        "assert observability.register_processor is pipeline.register_processor\n"
        "rep = loadgen.run_scenario(loadgen.smoke_variant(loadgen.get_scenario('steady')))\n"
        "assert rep['dropped'] == {} and rep['processed']['gossip_attestation'], rep\n"
        "chain = beacon_chain.BeaconChain(hs.spec, genesis.interop_genesis_state(\n"
        "    hs.keypairs, hs.genesis_time, hs.spec))\n"
        "chain.slot_clock.set_slot(2)\n"
        "assert chain.process_chain_segment(blocks)[-1] == chain.head_root\n"
        "assert chain.head_state().slot == 2 and len(chain.pubkey_cache) == 8\n"
        "assert chain.pubkey_cache.mont_coords(7)[1].shape == (24,)\n"
        "rep = state_root.run_state_root_scenario(scenarios.get_state_root_scenario(\n"
        "    'state_root', n_validators=64, slots=2))\n"
        "assert rep['conservation']['ok'] and rep['roots'] == 3, rep\n"
        "from lighthouse_tpu_torch.types import network_config\n"
        "from lighthouse_tpu_torch.utils import monitoring, supervisor, yaml_lite\n"
        "from lighthouse_tpu_torch.observability import propagation\n"
        "from lighthouse_tpu_torch.network import (discovery, gossipsub, node, peer_manager,\n"
        "    peer_score, rpc, sync, transport)\n"
        "from lighthouse_tpu_torch.validator import beacon_node\n"
        "from lighthouse_tpu_torch.api import client, http_api, rewards\n"
        "from lighthouse_tpu_torch.chain import light_client\n"
        "from lighthouse_tpu_torch.slasher import service\n"
        "main = network_config.get_network_config('mainnet')\n"
        "assert network_config.config_from_yaml(network_config.config_to_yaml(main)).preset == main.preset\n"
        "assert cli.build_parser().parse_args(['bn']).fn is cli.cmd_bn\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'lighthouse_tpu.'))"
        " or m == 'lighthouse_tpu']\n"
        "assert not bad, bad\n"
        "assert not __import__('torch').cuda.is_initialized()\n"
        "print('clean')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


def test_entry_points_default_to_cuda():
    """Without a card the default device raises: no silent CPU run."""
    if torch.cuda.is_available():
        assert TB.TorchBackend().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.TorchBackend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bls_api._load_torch_backend()


@pytest.mark.parametrize(
    "n_sets, n_pks, bucket",
    [(1, 1, (4, 1)), (3, 2, (4, 2)), (4, 3, (4, 4)), (5, 128, (8, 128)),
     (64, 128, (64, 128)), (1, 512, (4, 512)), (65, 1, (128, 1))],
)
def test_padding_bucket(n_sets, n_pks, bucket):
    assert TB.padding_bucket(n_sets, n_pks) == bucket


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_ints_vec_matches_reference(seed):
    from lighthouse_tpu.crypto.jaxbls import backend as jbe

    r = random.Random(seed)
    xs = [r.randrange(1 << 381) for _ in range(17)] + [0, (1 << 384) - 1]
    assert np.array_equal(TB.pack_ints_vec(xs), jbe.pack_ints_vec(xs))


def test_fixture_groups_decode_the_smoke_archive():
    from lighthouse_tpu_torch.utils import fixtures

    g = fixtures.load_groups(os.path.join(REPO, "bench_fixtures_smoke.npz"))
    assert len(g["att"]) == g["meta"]["n_att"] == 4
    assert all(len(s.signing_keys) == g["meta"]["n_pks"] for s in g["att"])
    assert len(g["sync"][0].signing_keys) == g["meta"]["sync_pks"]
    for s in g["att"]:
        assert cv.is_on_curve(s.signing_keys[0].point, cv.FQ_OPS)


def test_api_rejects_bad_batches():
    bls.set_backend("fake")
    try:
        assert bls.verify_signature_sets([]) is False
        s = bls.SignatureSet(bls.Signature.infinity(), [bls.interop_keypair(0).pk], b"\x01" * 32)
        assert bls.verify_signature_sets([s]) is False
        ok = bls.SignatureSet(bls.Signature(cv.G2_GEN), [bls.interop_keypair(0).pk], b"\x01" * 32)
        with pytest.raises(ValueError):
            bls.verify_signature_sets([ok], lambda n: [R] * n)
        with pytest.raises(ValueError):
            bls.verify_signature_sets([ok], lambda n: [1, 2])
        assert bls.verify_signature_sets([ok]) is True
        with pytest.raises(ValueError):
            bls.set_backend("nope")
    finally:
        bls_api._active_backend = None
