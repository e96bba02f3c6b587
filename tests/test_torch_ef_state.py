"""The EF consensus vectors under tests/ef/vectors through the port's runner
(lighthouse_tpu_torch/testing/ef_runner.py): every case, one test each.

The cases whose verdict does not depend on a signature run on the port's
"fake" BLS backend (it still decodes every signature and pubkey); those
whose expected rejection is a signature (sanity/blocks/invalid_state_root:
the block was changed after it was signed, so its proposer signature
fails) and the BLS handlers run on "python", the pure-Python ground truth.
The hash backend is "host". Tolerance: exact (post-state roots, deltas,
roots and bytes, as the vectors give them). The same cases run on the H100
under "torch" in chip_smoke.py's `ef_state` phase.
"""

from pathlib import Path

import pytest

from lighthouse_tpu.testing.ef_runner import discover_cases

VECTOR_ROOT = Path(__file__).parent / "ef" / "vectors"
CASES = list(discover_cases(VECTOR_ROOT))
SIGNATURE_CASES = ("invalid_state_root",)

# the port loads when this file's first test runs, not at collection
runner = bls = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global runner, bls
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.testing import ef_runner as runner
    from lighthouse_tpu_torch.torchhash import router

    prev_hash, prev = router._state["backend"], bls.api._active_backend
    router.set_hash_backend("host")
    yield
    router.set_hash_backend(prev_hash)
    bls.api._active_backend = prev


def backend_for(runner_name: str, case_dir: Path) -> str:
    return "python" if runner_name == "bls" or case_dir.name in SIGNATURE_CASES else "fake"


@pytest.mark.parametrize(
    "config,fork,runner_name,handler,case_dir", CASES,
    ids=[f"{c}/{f}/{r}/{h}/{d.name}" for c, f, r, h, d in CASES])
def test_ef_case(config, fork, runner_name, handler, case_dir):
    bls.set_backend(backend_for(runner_name, case_dir))
    va = runner.VectorAccess(VECTOR_ROOT)
    runner.run_case(va, config, fork, runner_name, handler, case_dir)
    # every file of the case was read
    assert va.accessed == {p for p in case_dir.rglob("*") if p.is_file()}


def test_signature_cases_depend_on_the_signature():
    """The cases run on "python" are accepted by "fake": their rejection
    is the signature's."""
    cases = [c for c in CASES if c[4].name in SIGNATURE_CASES]
    assert len(cases) == 6
    bls.set_backend("fake")
    for config, fork, runner_name, handler, case_dir in cases[:1]:
        with pytest.raises(runner.EfTestError, match="expected failure"):
            runner.run_case(runner.VectorAccess(VECTOR_ROOT), config, fork, runner_name,
                            handler, case_dir)


def test_read_yaml_matches_the_vectors():
    """read_yaml, the runner's PyYAML-free reader, against yaml.safe_load on
    every YAML file of the vectors."""
    import yaml

    files = sorted(VECTOR_ROOT.rglob("*.yaml"))
    assert len(files) > 100
    for p in files:
        text = p.read_text()
        assert runner.read_yaml(text) == yaml.safe_load(text), p
