"""The port's KZG (lighthouse_tpu_torch.crypto.kzg) on the torch backend's
plain versions on the CPU against the JAX package's KZG on its pure-Python
"python" backend, on the same N = 8 dev setup and seeded blobs: the
commitments and proofs (compressed bytes), y at a domain point, and the
single and batch verdicts, the tampered blob and the swapped proofs of
tests/test_kzg.py among them. Also the committed smoke fixture's KZG
setup, blobs, commitments and proofs through utils/fixtures.load_kzg.

Tolerance: exact equality (group elements as compressed bytes, field
elements as ints, verdicts as bools). The JAX side compiles nothing: its
KZG runs on the host under the "python" backend.
"""

from pathlib import Path

import numpy as np
import pytest

from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.crypto.bls import api as jax_api
from lighthouse_tpu.crypto.bls381 import serde as jserde
from lighthouse_tpu.crypto.bls381.constants import R

REPO = Path(__file__).resolve().parents[1]
N = 8

# the port loads when this file's first test runs, not at collection
kzg = api = serde = TB = fixtures = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global kzg, api, serde, TB, fixtures
    import torch
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls381 import serde
    from lighthouse_tpu_torch.crypto.torchbls import backend as TB
    from lighthouse_tpu_torch.utils import fixtures

    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = api._active_backend
    api.register_backend("torch-cpu", TB.TorchBackend(device="cpu"))
    api.set_backend("torch-cpu")
    yield
    api._active_backend = prev
    api._BACKENDS.pop("torch-cpu", None)
    torch.set_num_threads(prev_threads)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0x4B5A)
    out = []
    for _ in range(2):
        fes = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(N)]
        out.append(b"".join(fe.to_bytes(32, "big") for fe in fes))
    return out


@pytest.fixture(scope="module")
def setups():
    return kzg.TrustedSetup.insecure_dev_setup(N), jkzg.TrustedSetup.insecure_dev_setup(N)


@pytest.fixture(scope="module")
def ref(setups, blobs):
    """The JAX package's KZG on its "python" backend: the commitments and
    proofs, a proof and y at the domain point 3, and the verdicts."""
    _, js = setups
    prev = jax_api._active_backend
    jax_api.set_backend("python")
    try:
        cbs = [jserde.g1_compress(jkzg.blob_to_kzg_commitment(b, js)) for b in blobs]
        pbs = [jserde.g1_compress(jkzg.compute_blob_kzg_proof(b, c, js)) for b, c in zip(blobs, cbs)]
        z = js.roots[3]
        proof, y = jkzg.compute_kzg_proof(blobs[0], z, js)
        commitment = jserde.g1_decompress(cbs[0])
        bad = bytearray(blobs[0])
        bad[5] ^= 1
        return {
            "cbs": cbs, "pbs": pbs, "z": z, "y": y, "proof": jserde.g1_compress(proof),
            "domain_ok": jkzg.verify_kzg_proof(commitment, z, y, proof, js),
            "single": jkzg.verify_blob_kzg_proof(blobs[0], cbs[0], pbs[0], js),
            "tampered_blob": bytes(bad),
            "tampered": jkzg.verify_blob_kzg_proof(bytes(bad), cbs[0], pbs[0], js),
            "batch": jkzg.verify_blob_kzg_proof_batch(blobs, cbs, pbs, js),
            "swapped": jkzg.verify_blob_kzg_proof_batch(blobs, cbs, pbs[::-1], js),
        }
    finally:
        jax_api._active_backend = prev


def test_dev_setup_matches_jax(setups):
    port, js = setups
    assert port.g1_lagrange == js.g1_lagrange
    assert port.g2_monomial == js.g2_monomial
    assert port.roots == js.roots


def test_kzg_resolves_to_the_torch_backend():
    """Under a torch backend, KZG's group work goes to TorchBackend's
    g1_msm, g1_msm_fixed and pairing_product_is_one (kzg looks them up by
    name on the active backend)."""
    backend = api.get_backend()
    assert isinstance(backend, TB.TorchBackend)
    for name in ("g1_msm", "g1_msm_fixed", "pairing_product_is_one"):
        assert getattr(backend, name).__func__ is getattr(TB.TorchBackend, name)


def test_commitments_and_proofs_match_jax(setups, blobs, ref):
    port, _ = setups
    cbs = [serde.g1_compress(kzg.blob_to_kzg_commitment(b, port)) for b in blobs]
    assert cbs == ref["cbs"]
    pbs = [serde.g1_compress(kzg.compute_blob_kzg_proof(b, c, port)) for b, c in zip(blobs, cbs)]
    assert pbs == ref["pbs"]


def test_proof_at_a_domain_point_matches_jax(setups, blobs, ref):
    port, _ = setups
    proof, y = kzg.compute_kzg_proof(blobs[0], ref["z"], port)
    assert y == ref["y"] == kzg.blob_to_polynomial(blobs[0], port)[3]
    assert serde.g1_compress(proof) == ref["proof"]
    commitment = serde.g1_decompress(ref["cbs"][0])
    assert kzg.verify_kzg_proof(commitment, ref["z"], y, proof, port) is ref["domain_ok"] is True


@pytest.mark.parametrize("case", ["valid", "tampered"])
def test_single_verify_matches_jax(setups, blobs, ref, case):
    port, _ = setups
    blob = blobs[0] if case == "valid" else ref["tampered_blob"]
    got = kzg.verify_blob_kzg_proof(blob, ref["cbs"][0], ref["pbs"][0], port)
    assert got is ref["single" if case == "valid" else "tampered"] is (case == "valid")


@pytest.mark.parametrize("case", ["valid", "swapped", "empty"])
def test_batch_verify_matches_jax(setups, blobs, ref, case):
    port, _ = setups
    if case == "empty":
        assert kzg.verify_blob_kzg_proof_batch([], [], [], port) is True
        return
    pbs = ref["pbs"] if case == "valid" else ref["pbs"][::-1]
    got = kzg.verify_blob_kzg_proof_batch(blobs, ref["cbs"], pbs, port)
    assert got is ref["batch" if case == "valid" else "swapped"] is (case == "valid")


def test_smoke_fixture_commitments_through_the_port():
    """bench_fixtures_smoke.npz's KZG fixture (an 8-point dev setup, 2
    blobs) as load_kzg decodes it equals the JAX package's decoding, and
    the port's commitment of each blob is its fixture commitment."""
    from lighthouse_tpu.autotune.calibrate import load_fixture_groups

    path = REPO / "bench_fixtures_smoke.npz"
    got = fixtures.load_kzg(path)
    assert got == load_fixture_groups(str(path), include_kzg=True)["kzg"]
    setup = kzg.TrustedSetup(got["g1_lagrange"], got["g2_monomial"],
                             kzg._fr_roots_of_unity(len(got["g1_lagrange"])))
    for blob, cb in zip(got["blobs"], got["commitments"]):
        assert serde.g1_compress(kzg.blob_to_kzg_commitment(blob, setup)) == cb


def test_python_backend_is_registered_and_verifies():
    """The port's "python" backend: the host ground truth, KZG's fallback."""
    from lighthouse_tpu_torch.crypto.bls381 import curve as cv

    backend = api._BACKENDS["python"]
    assert backend.name == "python" and "python" in api.available_backends()
    sk = 0x1234
    msg = b"\x02" * 32
    sig = api.Signature(cv.g2_mul(api.hash_to_g2_point(msg), sk))
    pk = api.PublicKey(cv.g1_mul(cv.G1_GEN, sk))
    assert backend.verify_single(pk, msg, sig)
    assert not backend.verify_single(pk, b"\x03" * 32, sig)
