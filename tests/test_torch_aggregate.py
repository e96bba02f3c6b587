"""Distinct-message AggregateVerify and the EF BLS vectors on the port's CPU
backend: `backend.aggregate_pairs` against the JAX backend's
`_aggregate_kernel` bit for bit at n = 4 (a hashed message at the identity
among the lanes), three EF vectors (av_ok, verify_wrong_msg, bv_one_bad)
through `testing/ef_bls.py` with TorchBackend(device="cpu") active, the
vector reader against PyYAML on all 15 vectors, and the API's
AggregateVerify guards. The other vectors run on the card (chip_smoke.py).
Tolerance: exact equality.
"""

from pathlib import Path

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import api as bls_api
from lighthouse_tpu_torch.testing import ef_bls

EF_BLS = Path(__file__).resolve().parent / "ef" / "vectors" / "general" / "phase0" / "bls"

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


def test_aggregate_pairs_matches_jax():
    import jax

    from lighthouse_tpu.crypto.jaxbls import backend as jbe
    from lighthouse_tpu_torch.crypto.bls381 import curve as cv

    rng = np.random.default_rng(31)
    pks = [cv.g1_mul(cv.G1_GEN, int(k)) for k in rng.integers(2, 1 << 62, size=3)]
    sig = cv.g2_mul(cv.G2_GEN, int(rng.integers(2, 1 << 62)))
    pk_x = np.zeros((4, 24), np.uint32)
    pk_y = np.zeros((4, 24), np.uint32)
    pk_x[:3] = TB.pack_ints_vec([p[0] for p in pks])
    pk_y[:3] = TB.pack_ints_vec([p[1] for p in pks])
    mask = np.array([1, 1, 1, 0], np.uint32)
    sig_xy = TB.pack_ints_vec([sig[0][0], sig[0][1], sig[1][0], sig[1][1]]).reshape(2, 2, 24)
    # hashed messages, the padding lane's u = 0 among them, and lane 1 made
    # the identity (Z = 0): its pair is masked and keeps its X and Y
    us = np.zeros((4, 2, 2, 24), np.uint32)
    us[:3] = TB.h2.hash_to_field_batch([b"\x01" * 32, b"\x02" * 32, b"\x03" * 32], TB.DST_POP)
    h_jac = TB.stage_h2c(ix.to_torch(us))
    h_jac = (h_jac[0], h_jac[1], h_jac[2].clone())
    h_jac[2][1] = 0

    got = TB.aggregate_pairs(*ix.to_torch([pk_x, pk_y, mask, sig_xy]), h_jac)
    jbe._init_consts()
    want = jax.jit(jbe._aggregate_kernel)(pk_x, pk_y, mask, sig_xy, tuple(ix.to_numpy(list(h_jac))))
    for g, w in zip(ix.to_numpy(list(got)), want, strict=True):
        assert np.array_equal(g, np.asarray(w))


@pytest.fixture
def cpu_backend():
    be = TB.TorchBackend(device="cpu")
    bls_api.register_backend("torch-cpu", be)
    bls.set_backend("torch-cpu")
    yield be
    bls_api._active_backend = None
    bls_api._BACKENDS.pop("torch-cpu", None)


@pytest.mark.parametrize("handler, case", [("aggregate_verify", "av_ok"),
                                           ("verify", "verify_wrong_msg"),
                                           ("batch_verify", "bv_one_bad")])
def test_ef_vector_on_the_cpu_backend(handler, case, cpu_backend):
    assert ef_bls.run_vector(EF_BLS / handler / "bls_tests" / case / "data.yaml")


def test_vector_reader_matches_pyyaml():
    import yaml

    cases = ef_bls.vector_cases(EF_BLS)
    assert len(cases) == 15
    assert {h for h, _c, _p in cases} <= set(ef_bls.HANDLERS)
    for _h, _c, path in cases:
        text = path.read_text()
        assert ef_bls.read_data_yaml(text) == yaml.safe_load(text), path


def test_api_aggregate_verify_guards():
    from lighthouse_tpu_torch.crypto.bls381 import curve as cv

    pk = bls.interop_keypair(0).pk
    sig = bls.Signature(cv.G2_GEN)
    bls.set_backend("fake")
    try:
        assert bls.aggregate_verify([pk], [b"\x01" * 32], sig) is True
        assert bls.aggregate_verify([pk], [], sig) is False            # lengths differ
        assert bls.aggregate_verify([], [], sig) is False              # empty
        assert bls.aggregate_verify([pk], [b"\x01" * 32], bls.Signature.infinity()) is False
        # the fake backend's async submission resolves at once
        s = bls.SignatureSet(sig, [pk], b"\x01" * 32)
        assert bls.verify_signature_sets_async([s]).result() is True
        assert bls.verify_signature_sets_async([]).result() is False
    finally:
        bls_api._active_backend = None
